"""Dispatch and glue for the persistent whole-traversal megakernel.

``traverse_whole`` is the single entry point of ``mode=
"wavefront_persistent"``: the whole multi-level traversal in one call.  It
packs the kernel's inputs as ``repro.kernels.persist.ops._kernel_whole``
does and calls :func:`persist_tiles`, which launches the CUDA kernel
(``csrc/persist.cu``: one thread-block cluster per tile, the tile's OBBs
in shared memory) on CUDA tensors and runs the plain PyTorch version
(:func:`repro_torch.kernels.persist.ref.persist_tiles_ref`) on CPU tensors.
Both follow the same per-tile contract, so verdicts and every counter are
the same on either device.

This slice serves single-scene identity pools with resident fp32 rows.
Owner and payload lanes, the streamed layout, compressed rows and ragged
multi-scene batches raise ``NotImplementedError`` naming the ROADMAP item
that adds them.

**Residency.**  The chooser keeps the reference's rules (fp32 while the
resident table fits, compressed rows only to buy residency, narrowest
eligible rows when streaming) with the budget as a parameter.  On the
H100 "resident" means the whole table in device memory read through L2,
so the default budget is the card's 50 MB L2 (NVIDIA H100 data sheet),
not the 8 MiB TPU VMEM figure of the reference.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.counters import (BYTES_META_STREAM,
                                       BYTES_META_STREAM_BF16,
                                       BYTES_META_STREAM_U8, NUM_EXIT_CODES)
from repro_torch.core.octree import MAX_DEPTH, DeviceOctree, align_rows
from repro_torch.core.quantize import META_FORMATS, format_eligible
from repro_torch.core.sact import PAYLOAD_INF
from repro_torch.kernels import _build
from repro_torch.kernels.persist.ref import persist_tiles_ref
from repro_torch.kernels.sact.ops import pack_obbs

#: Node-metadata layouts of the persistent megakernel.
META_LAYOUTS = ("resident", "streamed")

#: Bytes per packed row by format (traffic-model constants).
META_FORMAT_BYTES = {"fp32": BYTES_META_STREAM,
                     "bf16": BYTES_META_STREAM_BF16,
                     "u8": BYTES_META_STREAM_U8}

#: H100 L2 cache, 50 MB (data sheet): the default budget for the resident
#: node-metadata table, which the kernel reads from device memory through
#: L2.  ``EngineConfig.vmem_budget`` overrides it per engine.
H100_L2_BYTES = 50 * 1000 * 1000

#: Query slots per tile (one thread-block cluster each), as in the
#: reference's default.
DEFAULT_BQ = 128
#: Spill-ring pairs per tile, as in the reference's default.
DEFAULT_RING_CAP = 256


def meta_table_bytes(depth: int, n_max: int, fmt: str = "fp32") -> int:
    """Bytes of the RESIDENT node-metadata table (aligned rows)."""
    return (depth + 1) * align_rows(n_max) * META_FORMAT_BYTES[fmt]


class MetaChoice(NamedTuple):
    """A point in the {resident, streamed} x {fp32, bf16, u8} plan space."""
    layout: str
    fmt: str


def choose_meta_layout(depth: int, n_max: int,
                       budget: int = H100_L2_BYTES,
                       fmt: Optional[str] = None,
                       layout: Optional[str] = None) -> MetaChoice:
    """Layout/format chooser, the reference's rules with ``budget`` given.

    Residency prefers the widest format that fits (fp32 > bf16 > u8);
    streamed rows prefer the narrowest eligible one.  ``fmt`` / ``layout``
    pin one or both axes; pinning an ineligible format raises.
    """
    if fmt is not None and fmt not in META_FORMATS:
        raise ValueError(f"unknown meta_format {fmt!r}; "
                         f"allowed: {META_FORMATS}")
    if layout is not None and layout not in META_LAYOUTS:
        raise ValueError(f"unknown meta layout {layout!r}; "
                         f"allowed: {META_LAYOUTS}")
    if fmt is not None and not format_eligible(fmt, n_max):
        raise ValueError(
            f"meta_format {fmt!r} cannot index {n_max} rows per level "
            "(CSR child_start field overflow)")
    widest = [f for f in META_FORMATS if format_eligible(f, n_max)]
    narrowest = widest[::-1]
    if fmt is not None:
        if layout is None:
            layout = ("resident"
                      if meta_table_bytes(depth, n_max, fmt) <= budget
                      else "streamed")
        return MetaChoice(layout, fmt)
    if layout == "resident":
        for f in widest:
            if meta_table_bytes(depth, n_max, f) <= budget:
                return MetaChoice("resident", f)
        return MetaChoice("resident", "fp32")
    if layout == "streamed":
        return MetaChoice("streamed", narrowest[0])
    for f in widest:
        if meta_table_bytes(depth, n_max, f) <= budget:
            return MetaChoice("resident", f)
    return MetaChoice("streamed", narrowest[0])


def require_ported_layout(choice: MetaChoice) -> None:
    """Raise unless ``choice`` is what this slice's kernel runs."""
    if choice.layout != "resident":
        raise NotImplementedError(
            "the streamed metadata layout lands with ROADMAP A.5.4")
    if choice.fmt != "fp32":
        raise NotImplementedError(
            f"meta_format {choice.fmt!r}: bf16 and u8 rows land with "
            "ROADMAP A.5.5")


_PERSIST_ARGTYPES = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 7
                     + [ctypes.c_void_p])


def persist_tiles(scal, sot, nvalid, obb, meta, payload, owner, *, bq: int,
                  fcap: int, depth: int, ring_cap: int, use_spheres: bool,
                  meta_format: str = "fp32"):
    """One megakernel launch over ``T = len(sot)`` tiles (the inputs and
    outputs of :func:`persist_tiles_ref`).  CPU tensors run the plain
    version; CUDA tensors launch ``csrc/persist.cu``."""
    if meta_format != "fp32":
        raise NotImplementedError(
            f"meta_format {meta_format!r}: bf16 and u8 rows land with "
            "ROADMAP A.5.5")
    dev = obb.device
    T, L = sot.shape[0], depth + 1
    n_max = meta.shape[1]
    want = {"scal": (scal, torch.float32), "sot": (sot, torch.int32),
            "nvalid": (nvalid, torch.int32), "obb": (obb, torch.float32),
            "meta": (meta, torch.int32), "payload": (payload, torch.int32),
            "owner": (owner, torch.int32)}
    for name, (x, dtype) in want.items():
        if x.device != dev or x.dtype != dtype:
            raise ValueError(f"{name}: want {dtype} on {dev}, got "
                             f"{x.dtype} on {x.device}")
    if obb.shape != (T * bq, 15) or payload.shape != (T * bq,) \
            or owner.shape != (T * bq,) or meta.shape != (L, n_max, 4):
        raise ValueError("persist_tiles: inconsistent input shapes")
    if not (bq >= 1 and 1 <= fcap < 2**28 and ring_cap >= 1):
        raise ValueError(f"persist_tiles: need bq >= 1, 1 <= fcap < 2**28 "
                         f"and ring_cap >= 1, got {bq}, {fcap}, {ring_cap}")
    if dev.type == "cpu":
        return persist_tiles_ref(scal, sot, nvalid, obb, meta, payload,
                                 owner, bq=bq, fcap=fcap, depth=depth,
                                 ring_cap=ring_cap, use_spheres=use_spheres)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    ins = [x.contiguous() for x in (scal, sot, nvalid, obb, meta, payload,
                                    owner)]
    i32 = dict(dtype=torch.int32, device=dev)
    best = torch.empty((T, bq), **i32)
    per_level = torch.empty((T, L), **i32)
    hist = torch.empty((T, NUM_EXIT_CODES), **i32)
    scalars = torch.empty((T, 8), **i32)
    ring = torch.empty((T, ring_cap, 2), **i32)
    work = torch.empty((T, 6, fcap), **i32)   # frontier slots + stash
    fn = _build.load("persist").persist_launch
    if fn.argtypes is None:
        fn.argtypes = _PERSIST_ARGTYPES
        fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(*(x.data_ptr() for x in ins),
                    *(x.data_ptr() for x in (best, per_level, hist, scalars,
                                             ring, work)),
                    T, bq, fcap, depth, n_max, ring_cap, int(use_spheres),
                    stream)
    _build.check(status, "persist")
    _build.count_launch("persist")
    return best, per_level, hist, scalars, ring


def kernel_shape(bq: int = DEFAULT_BQ) -> dict:
    """The CUDA kernel's launch shape (needs the card): CTAs a cluster,
    threads a CTA, dynamic shared memory a CTA for ``bq`` slots, and how
    many such clusters the card holds at once
    (``cudaOccupancyMaxActiveClusters``)."""
    fn = _build.load("persist").persist_shape
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    out = (ctypes.c_int * 4)()
    _build.check(fn(bq, ctypes.addressof(out)), "persist")
    return dict(zip(("cluster", "threads", "smem_bytes", "max_clusters"),
                    out))


def pack_kernel_inputs(obb_c, obb_h, obb_r, dev: DeviceOctree, bq: int,
                       num_valid=None):
    """The megakernel's inputs for an identity boolean pool, packed as the
    reference's ``_kernel_whole`` packs them: ``scal`` = [scene_lo,
    cell sizes], the OBB table zero-padded to whole tiles, a zero payload
    lane, identity owners (every slot its own group), scene 0 for every
    tile and the live-prefix count.  The per-scene level extents (``off`` /
    ``cnt``) are left out: only the streamed layout (ROADMAP A.5.4) reads
    them."""
    device = dev.device
    M = obb_c.shape[0]
    num_tiles = max(math.ceil(M / bq), 1)
    pad = num_tiles * bq - M
    obb = torch.nn.functional.pad(pack_obbs(obb_c, obb_h, obb_r),
                                  (0, 0, 0, pad))
    pay = torch.zeros(num_tiles * bq, dtype=torch.int32, device=device)
    own = torch.arange(bq, dtype=torch.int32, device=device).repeat(num_tiles)
    sot = torch.zeros(num_tiles, dtype=torch.int32, device=device)
    scal = torch.cat([dev.scene_lo.to(torch.float32),
                      dev.cell_sizes.to(torch.float32)])
    nvalid = torch.tensor([M if num_valid is None else int(num_valid)],
                          dtype=torch.int32, device=device)
    return dict(scal=scal, sot=sot, nvalid=nvalid, obb=obb.contiguous(),
                meta=dev.node_meta, payload=pay, owner=own)


def _kernel_whole(obb_c, obb_h, obb_r, dev: DeviceOctree, capacity: int,
                  use_spheres: bool, bq: int, ring_cap: int
                  ) -> Tuple[torch.Tensor, dict]:
    """Run the megakernel; returns the raw (num_tiles * bq,) per-slot
    ``best`` words (PAYLOAD_INF = that slot never hit) + the stats dict."""
    ins = pack_kernel_inputs(obb_c, obb_h, obb_r, dev, bq)
    best, per_level, hist, scalars, _ring = persist_tiles(
        **ins, bq=bq, fcap=capacity, depth=dev.depth, ring_cap=ring_cap,
        use_spheres=use_spheres, meta_format=dev.meta_format)
    L = dev.depth + 1
    tot = scalars.to(torch.int64).sum(0)
    per = torch.zeros(MAX_DEPTH + 1, dtype=torch.int64, device=best.device)
    per[:L] = per_level.to(torch.int64).sum(0)
    st = dict(nodes=tot[0], leaf=tot[1], axis_exec=tot[2], axis_dec=tot[3],
              sphere=tot[4], overflow=tot[5], per_level=per,
              exit_hist=hist.to(torch.int64).sum(0), meta_rows=tot[7])
    return best.reshape(-1), st


def traverse_whole(obb_c, obb_h, obb_r, dev: DeviceOctree, capacity: int, *,
                   use_spheres: bool, scene_of_query=None,
                   owner_of_query=None, payload=None,
                   streamed: Optional[bool] = None, bq: int = DEFAULT_BQ,
                   ring_cap: int = DEFAULT_RING_CAP,
                   tiles=None) -> Tuple[torch.Tensor, dict]:
    """Whole multi-level traversal for one flat query set against one
    scene; returns ``(collide (Q,) bool, stats dict)``.

    Runs on the device of ``dev`` (the OBB tensors are moved there).
    """
    if scene_of_query is not None:
        raise NotImplementedError(
            "ragged multi-scene pools land with ROADMAP A.5.6")
    if owner_of_query is not None or payload is not None or tiles is not None:
        raise NotImplementedError(
            "owner and payload lanes (owner-group tiling) land with "
            "ROADMAP A.5.3")
    if streamed is None:
        streamed = choose_meta_layout(
            dev.depth, dev.node_meta.shape[-2],
            fmt=dev.meta_format).layout == "streamed"
    require_ported_layout(MetaChoice("streamed" if streamed else "resident",
                                     dev.meta_format))
    d = dev.device
    obb_c, obb_h, obb_r = (torch.as_tensor(x, dtype=torch.float32).to(d)
                           for x in (obb_c, obb_h, obb_r))
    M = obb_c.shape[0]
    best, st = _kernel_whole(obb_c, obb_h, obb_r, dev, capacity, use_spheres,
                             bq, ring_cap)
    return best[:M] != PAYLOAD_INF, st
