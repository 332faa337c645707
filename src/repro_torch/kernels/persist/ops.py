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

Every plan shape runs on the kernel.  A plan with an owner lane
(swept-edge CCD) or a scene lane (a ragged multi-scene batch, over the
flat table of :func:`repro_torch.core.octree.concat_device_octrees`) is
lowered to a **tiled pool** first (:func:`build_tile_map`, the
reference's host numpy): pool slots are permuted so that every tile holds
one scene and every verdict group lands whole in one ``bq``-slot tile,
pads sit at each tile's tail, and each slot names its group by the
group's first tile-local slot (``owner_local``).  The kernel reads each
tile's scene (``scene_of_tile``): its origin and cell sizes, its level
extents, and its root, flat node ``s`` of level 0.  The per-slot ``best``
words are mapped back to query space by ``slot_of_query`` (boolean
plans) or to group space by ``group_slot``.  A one-scene plan with a
payload lane and no owner lane stays on the identity route with its
payloads.  An owner group too large for the largest tile
(:data:`MAX_TILE_BQ`) or in more than one scene
(:func:`persist_kernel_unsupported`) raises ``NotImplementedError``
(ROADMAP B.2.5): the reference serves it on its plain arm, and this port
falls back to no plain version on the card.

**Layouts x row formats.**  Rows come in the three formats of
:mod:`repro_torch.core.quantize` (fp32 16 B, bf16 8 B, u8 4 B; the
kernel decodes them in registers), in one of two layouts
(:data:`META_LAYOUTS`): ``resident``, or ``streamed``, where each tile
reads a level through fixed windows of :func:`sub_window_rows` rows over
its scene's sub-extent and counts the rows of every window it touches
into ``meta_rows`` (``Counters.meta_rows_streamed``), as the reference's
TPU kernel fetches them.  On the H100 both layouts read the rows from
device memory through L2; the layout changes ``meta_rows`` and nothing
else.  The chooser keeps the reference's rules (fp32 while the resident
table fits, compressed rows only to buy residency, narrowest eligible
rows when streaming) with the budget as a parameter.  On the H100
"resident" means the whole table read through L2, so the default budget
is the card's 50 MB L2 (NVIDIA H100 data sheet), not the 8 MiB TPU VMEM
figure of the reference.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.counters import (BYTES_META_STREAM,
                                       BYTES_META_STREAM_BF16,
                                       BYTES_META_STREAM_U8, NUM_EXIT_CODES)
from repro_torch.core.octree import (MAX_DEPTH, META_ROW_ALIGN,
                                     MultiSceneOctree, align_rows)
from repro_torch.core.quantize import (META_FORMAT_WORDS, META_FORMATS,
                                       format_eligible)
from repro_torch.core.sact import PAYLOAD_INF
from repro_torch.kernels import _build
from repro_torch.kernels.persist.ref import (persist_tiles_ref,
                                             sub_window_rows)
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

#: Largest owner-group tile (the reference's): a verdict group must fit in
#: one tile, whose fold cell is tile-local.
MAX_TILE_BQ = 1024


def meta_table_bytes(depth: int, n_max: int, fmt: str = "fp32") -> int:
    """Bytes of the RESIDENT node-metadata table (aligned rows)."""
    return (depth + 1) * align_rows(n_max) * META_FORMAT_BYTES[fmt]


def meta_stream_bytes(n_max: int, fmt: str = "fp32") -> int:
    """Bytes of the reference TPU kernel's window pair under the streamed
    layout (two windows, each with one 8-row chunk of slack), constant in
    ``n_max`` past the window size.  The CUDA kernel stages no
    window: it reads the rows through L2 in both layouts."""
    return 2 * (sub_window_rows(n_max) + 8) * META_FORMAT_BYTES[fmt]


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


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


class Tiling(NamedTuple):
    """A tiled pool's lanes (numpy in a :class:`TileMap`, tensors on the
    engine's device in a call).  The pool has ``num_tiles * bq`` slots."""
    owner_local: object    # (Q',) slot's verdict group as the group's
    #                        first tile-local slot; -1 = pad slot
    scene_of_tile: object  # (T,) scene id per tile (0: one scene)
    slot_of_query: object  # (Q,) original query -> pool slot
    group_slot: object     # (Q,) global group id -> the group's fold
    #                        slot; -1 past the group count


class TileMap(NamedTuple):
    """Host-side owner-group tiling of a plan's pair pool.

    ``perm[slot]`` is the original query index occupying the slot (-1 =
    pad); callers permute their per-query arrays with ``np.maximum(perm,
    0)`` (pad slots carry garbage rows, masked by ``owner_local < 0``).
    """
    tiles: Tiling             # numpy-backed Tiling arrays
    perm: np.ndarray          # (Q',) int64
    bq: int
    num_tiles: int


def build_tile_map(num_queries: int, bq: int,
                   scene_of_query: Optional[np.ndarray] = None,
                   owner_of_query: Optional[np.ndarray] = None) -> TileMap:
    """Pack a plan's pairs into scene-exclusive, owner-group-exclusive
    tiles (host numpy, the reference's steps in its order).

    Pairs are ordered scene-major, owner-minor (stable, so pools the front
    ends already sorted keep their order), and each (scene, owner) run is
    placed whole into the current tile if it has room and holds the same
    scene, else into a new one.  An owner group in more than one scene
    raises ``ValueError`` (its fold cell could not be tile-local).  ``bq``
    grows to the next power of two that fits the largest group (capped at
    :data:`MAX_TILE_BQ`: a larger group raises; screen with
    :func:`persist_kernel_unsupported` first).  Pads sit at each tile's
    tail, so live slots form every tile's prefix.
    """
    Q = int(num_queries)
    soq = (np.zeros(Q, np.int64) if scene_of_query is None
           else np.asarray(scene_of_query, np.int64))
    own = (np.arange(Q, dtype=np.int64) if owner_of_query is None
           else np.asarray(owner_of_query, np.int64))
    assert soq.shape == (Q,) and own.shape == (Q,)
    order = np.lexsort((own, soq))
    so, oo = soq[order], own[order]
    new_run = np.ones(Q, bool)
    if Q > 1:
        new_run[1:] = (so[1:] != so[:-1]) | (oo[1:] != oo[:-1])
    run_id = np.cumsum(new_run) - 1
    run_starts = np.flatnonzero(new_run)
    run_sizes = np.diff(np.append(run_starts, Q))
    run_owner = oo[run_starts]
    if owner_of_query is not None and \
            len(np.unique(run_owner)) != len(run_owner):
        raise ValueError("an owner group spans multiple scenes; "
                         "its fold cell cannot be tile-local")
    max_run = int(run_sizes.max()) if Q else 1
    bq_eff = max(int(bq), _next_pow2(max_run))
    if bq_eff > MAX_TILE_BQ:
        raise ValueError(
            f"owner group of {max_run} pairs needs a {bq_eff}-slot tile "
            f"(cap {MAX_TILE_BQ}); screen with persist_kernel_unsupported")

    nrun = len(run_starts)
    # the greedy placement, on Python ints: numpy scalars make this loop,
    # one trip a run, several times slower
    tiles_r, firsts_r, scene_of_tile = [], [], []
    tile, used, cur_scene = -1, bq_eff, None
    for n, s in zip(run_sizes.tolist(), so[run_starts].tolist()):
        if s != cur_scene or used + n > bq_eff:
            tile += 1
            used = 0
            cur_scene = s
            scene_of_tile.append(s)
        tiles_r.append(tile)
        firsts_r.append(used)
        used += n
    tile_of_run = np.asarray(tiles_r, np.int64)
    first_slot_of_run = np.asarray(firsts_r, np.int64)
    num_tiles = max(tile + 1, 1)
    if not scene_of_tile:
        scene_of_tile = [0]

    rank_in_run = np.arange(Q) - run_starts[run_id] if Q else np.zeros(0)
    slot_sorted = (tile_of_run[run_id] * bq_eff + first_slot_of_run[run_id]
                   + rank_in_run).astype(np.int64)
    slot_of_query = np.zeros(Q, np.int64)
    slot_of_query[order] = slot_sorted
    Qs = num_tiles * bq_eff
    perm = np.full(Qs, -1, np.int64)
    perm[slot_sorted] = order
    owner_local = np.full(Qs, -1, np.int32)
    owner_local[slot_sorted] = first_slot_of_run[run_id].astype(np.int32)
    group_slot = np.full(Q, -1, np.int32)
    if nrun:
        group_slot[run_owner] = (tile_of_run * bq_eff
                                 + first_slot_of_run).astype(np.int32)
    tiles = Tiling(owner_local=owner_local,
                   scene_of_tile=np.asarray(scene_of_tile, np.int32),
                   slot_of_query=slot_of_query.astype(np.int32),
                   group_slot=group_slot)
    return TileMap(tiles=tiles, perm=perm, bq=bq_eff, num_tiles=num_tiles)


def persist_kernel_unsupported(owner_of_query=None,
                               scene_of_query=None) -> Optional[str]:
    """Name the reason a persistent-mode plan cannot run on the kernel, or
    ``None`` if it can (the reference's two reasons, in its order): an
    owner group too large for the largest tile, or an owner group in more
    than one scene.  No front end emits either."""
    if owner_of_query is None:
        return None
    own = np.asarray(owner_of_query)
    if own.size == 0:
        return None
    sizes = np.bincount(own.astype(np.int64))
    mx = int(sizes.max())
    if _next_pow2(mx) > MAX_TILE_BQ:
        return (f"owner group of {mx} pairs needs a {_next_pow2(mx)}-slot "
                f"tile (cap {MAX_TILE_BQ})")
    if scene_of_query is not None:
        soq = np.asarray(scene_of_query)
        pairs = {(int(o), int(s)) for o, s in zip(own, soq)}
        if len(pairs) != len(np.unique(own)):
            return "an owner group spans multiple scenes"
    return None


_PERSIST_ARGTYPES = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 10
                     + [ctypes.c_void_p])


def _lib_fn(name: str, argtypes, restype=ctypes.c_int):
    """The built library's C function ``name``, its types declared."""
    fn = getattr(_build.load("persist"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = restype
    return fn


def persist_tiles(scal, sot, nvalid, obb, meta, payload, owner, off=None,
                  cnt=None, *, bq: int, fcap: int, depth: int, ring_cap: int,
                  use_spheres: bool, meta_format: str = "fp32",
                  streamed: bool = False, wsub: Optional[int] = None):
    """One megakernel launch over ``T = len(sot)`` tiles (the inputs and
    outputs of :func:`persist_tiles_ref`).  ``meta`` holds rows in
    ``meta_format``; ``streamed`` counts the windows of ``wsub`` rows
    (default :func:`sub_window_rows`) over each scene's level extents
    ``off`` / ``cnt`` into ``meta_rows``.  CPU tensors run the plain
    version; CUDA tensors launch ``csrc/persist.cu``."""
    if meta_format not in META_FORMATS:
        raise ValueError(f"unknown meta_format {meta_format!r}; "
                         f"allowed: {META_FORMATS}")
    dev = obb.device
    T, L = sot.shape[0], depth + 1
    n_max = meta.shape[1]
    want = {"scal": (scal, torch.float32), "sot": (sot, torch.int32),
            "nvalid": (nvalid, torch.int32), "obb": (obb, torch.float32),
            "meta": (meta, torch.int32), "payload": (payload, torch.int32),
            "owner": (owner, torch.int32)}
    if streamed:
        if off is None or cnt is None:
            raise ValueError("persist_tiles: the streamed layout reads the "
                             "scenes' level extents (off, cnt)")
        wsub = sub_window_rows(n_max) if wsub is None else int(wsub)
        if wsub < 1:
            raise ValueError(f"persist_tiles: need wsub >= 1, got {wsub}")
        want.update(off=(off, torch.int32), cnt=(cnt, torch.int32))
    else:
        wsub = 0
    for name, (x, dtype) in want.items():
        if x.device != dev or x.dtype != dtype:
            raise ValueError(f"{name}: want {dtype} on {dev}, got "
                             f"{x.dtype} on {x.device}")
    words = META_FORMAT_WORDS[meta_format]
    if obb.shape != (T * bq, 15) or payload.shape != (T * bq,) \
            or owner.shape != (T * bq,) or meta.shape != (L, n_max, words):
        raise ValueError("persist_tiles: inconsistent input shapes")
    if not (bq >= 1 and 1 <= fcap < 2**28 and ring_cap >= 1):
        raise ValueError(f"persist_tiles: need bq >= 1, 1 <= fcap < 2**28 "
                         f"and ring_cap >= 1, got {bq}, {fcap}, {ring_cap}")
    if dev.type == "cpu":
        return persist_tiles_ref(scal, sot, nvalid, obb, meta, payload,
                                 owner, off, cnt, bq=bq, fcap=fcap,
                                 depth=depth, ring_cap=ring_cap,
                                 use_spheres=use_spheres,
                                 meta_format=meta_format, streamed=streamed,
                                 wsub=wsub or None)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    fmt = META_FORMATS.index(meta_format)
    nwin = -(-n_max // wsub) if streamed else 0
    ins = [x.contiguous() for x in (scal, sot, nvalid, obb, meta, payload,
                                    owner)]
    # the extents, which only the streamed instances read
    ext = [x.contiguous() for x in (off, cnt)] if streamed else []
    i32 = dict(dtype=torch.int32, device=dev)
    best = torch.empty((T, bq), **i32)
    per_level = torch.empty((T, L), **i32)
    hist = torch.empty((T, NUM_EXIT_CODES), **i32)
    scalars = torch.empty((T, 8), **i32)
    ring = torch.empty((T, ring_cap, 2), **i32)
    # frontier slots and stash (and u8's code lanes, and the streamed
    # layout's window bitmaps), one slice a tile
    tile_words = _lib_fn("persist_work_words", [ctypes.c_int] * 3,
                         ctypes.c_longlong)(fcap, fmt, nwin)
    work = torch.empty((T, tile_words), **i32)
    fn = _lib_fn("persist_launch", _PERSIST_ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(*(x.data_ptr() for x in ins),
                    *((x.data_ptr() for x in ext) if ext else (None, None)),
                    *(x.data_ptr() for x in (best, per_level, hist, scalars,
                                             ring, work)),
                    T, bq, fcap, depth, n_max, ring_cap, int(use_spheres),
                    fmt, int(streamed), wsub, stream)
    _build.check(status, "persist")
    _build.count_launch("persist")
    return best, per_level, hist, scalars, ring


def kernel_shape(bq: int = DEFAULT_BQ, meta_format: str = "fp32",
                 nwin: int = 0) -> dict:
    """The CUDA kernel's launch shape (needs the card): CTAs a cluster,
    threads a CTA, dynamic shared memory a CTA for ``bq`` slots with rows
    in ``meta_format``, and how many such clusters of the instance for
    ``nwin`` windows a level (0: resident) the card holds at once
    (``cudaOccupancyMaxActiveClusters``)."""
    fn = _lib_fn("persist_shape", [ctypes.c_int] * 3 + [ctypes.c_void_p])
    out = (ctypes.c_int * 4)()
    _build.check(fn(bq, META_FORMATS.index(meta_format), nwin,
                    ctypes.addressof(out)), "persist")
    return dict(zip(("cluster", "threads", "smem_bytes", "max_clusters"),
                    out))


def _scene_extents(dev) -> Tuple[torch.Tensor, torch.Tensor]:
    """(S * L,) int32 per-scene flat level sub-extents (offset, count): a
    :class:`MultiSceneOctree`'s ``scene_off`` / ``scene_counts``, or for
    one scene offsets 0 and its level counts."""
    if isinstance(dev, MultiSceneOctree):
        return (dev.scene_off.to(torch.int32).reshape(-1),
                dev.scene_counts.to(torch.int32).reshape(-1))
    cnt = dev.counts.to(torch.int32)
    return torch.zeros_like(cnt), cnt


def pack_kernel_inputs(obb_c, obb_h, obb_r, dev, bq: int, num_valid=None,
                       payload=None, owner_local=None, scene_of_tile=None):
    """The megakernel's inputs, packed as the reference's ``_kernel_whole``
    packs them: ``scal`` = [scene_lo, cell sizes] a scene, the OBB table,
    the payload lane (zeros when ``payload`` is None), the owner lane, the
    scene of each tile and the live-prefix count.

    ``dev`` is a :class:`DeviceOctree` (one scene) or a
    :class:`MultiSceneOctree` (the flat table of a ragged batch, whose
    pools come tiled).  An identity pool (``owner_local`` None) is cut
    into ``ceil(M / bq)`` tiles, zero-padded at the end, every slot its
    own verdict group, and ``num_valid`` (default M) is its live prefix:
    slots past it seed nothing.  A tiled pool (:func:`build_tile_map`,
    already permuted into slot space) passes ``owner_local`` and
    ``scene_of_tile``; its ``bq`` is the pool's width over its tile
    count.  ``off`` / ``cnt`` are the scenes' level extents, which the
    streamed layout reads."""
    device = dev.device
    M = obb_c.shape[0]
    obb = pack_obbs(obb_c, obb_h, obb_r)
    pay = (torch.zeros(M, dtype=torch.int32, device=device)
           if payload is None else payload.to(torch.int32))
    if owner_local is not None:
        num_tiles = scene_of_tile.shape[0]
        bq = M // num_tiles
        assert num_tiles * bq == M, "tiled pools are exact tile multiples"
        own = owner_local.to(torch.int32)
        sot = scene_of_tile.to(torch.int32)
    else:
        if isinstance(dev, MultiSceneOctree):
            raise ValueError("a MultiSceneOctree takes a tiled pool "
                             "(owner_local, scene_of_tile)")
        num_tiles = max(math.ceil(M / bq), 1)
        pad = num_tiles * bq - M
        obb = torch.nn.functional.pad(obb, (0, 0, 0, pad))
        pay = torch.nn.functional.pad(pay, (0, pad))
        own = torch.arange(bq, dtype=torch.int32,
                           device=device).repeat(num_tiles)
        sot = torch.zeros(num_tiles, dtype=torch.int32, device=device)
    if isinstance(dev, MultiSceneOctree):
        scal = torch.cat([dev.scene_lo, dev.cell_sizes],
                         dim=1).to(torch.float32).reshape(-1)
    else:
        scal = torch.cat([dev.scene_lo.to(torch.float32),
                          dev.cell_sizes.to(torch.float32)])
    nvalid = torch.tensor([M if num_valid is None else int(num_valid)],
                          dtype=torch.int32, device=device)
    off, cnt = _scene_extents(dev)
    return dict(scal=scal, sot=sot, nvalid=nvalid, obb=obb.contiguous(),
                meta=dev.node_meta, payload=pay.contiguous(),
                owner=own.contiguous(), off=off, cnt=cnt)


def _kernel_whole(obb_c, obb_h, obb_r, dev, capacity: int,
                  use_spheres: bool, bq: int, ring_cap: int, streamed: bool,
                  payload=None, num_valid=None, owner_local=None,
                  scene_of_tile=None) -> Tuple[torch.Tensor, dict]:
    """Run the megakernel; returns the raw (num_tiles * bq,) per-slot
    ``best`` words (PAYLOAD_INF = that slot never hit) + the stats dict."""
    ins = pack_kernel_inputs(obb_c, obb_h, obb_r, dev, bq,
                             num_valid=num_valid, payload=payload,
                             owner_local=owner_local,
                             scene_of_tile=scene_of_tile)
    bq = ins["obb"].shape[0] // ins["sot"].shape[0]
    n_max = ins["meta"].shape[1]
    if streamed and n_max % META_ROW_ALIGN:   # hand-built unaligned tables
        ins["meta"] = torch.nn.functional.pad(
            ins["meta"], (0, 0, 0, align_rows(n_max) - n_max))
    best, per_level, hist, scalars, _ring = persist_tiles(
        **ins, bq=bq, fcap=capacity, depth=dev.depth, ring_cap=ring_cap,
        use_spheres=use_spheres, meta_format=dev.meta_format,
        streamed=streamed)
    L = dev.depth + 1
    tot = scalars.to(torch.int64).sum(0)
    per = torch.zeros(MAX_DEPTH + 1, dtype=torch.int64, device=best.device)
    per[:L] = per_level.to(torch.int64).sum(0)
    st = dict(nodes=tot[0], leaf=tot[1], axis_exec=tot[2], axis_dec=tot[3],
              sphere=tot[4], overflow=tot[5], per_level=per,
              exit_hist=hist.to(torch.int64).sum(0), meta_rows=tot[7])
    return best.reshape(-1), st


def _host_ids(x) -> Optional[np.ndarray]:
    if x is None:
        return None
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def tile_pool(obb_c, obb_h, obb_r, owner_of_query=None, payload=None,
              bq: int = DEFAULT_BQ, scene_of_query=None) -> dict:
    """Lower a pool with an owner lane, a scene lane or both to its tiled
    pool, on the device of ``obb_c``: the tile map is built on the host
    from the ids (:func:`build_tile_map`; scene-exclusive tiles, whole
    owner groups), the rows, owners and payloads are permuted into slot
    space (pad slots repeat slot 0's query).  A plan the kernel cannot
    tile (:func:`persist_kernel_unsupported`: an owner group past
    :data:`MAX_TILE_BQ` slots, or in more than one scene) raises
    ``NotImplementedError``: the reference serves it on its plain arm, and
    the port falls back to no plain version.  Returns the keyword
    arguments of :func:`traverse_whole` for that pool (``obb_c``,
    ``obb_h``, ``obb_r``, ``owner_of_query``, ``payload``, ``tiles``,
    ``bq``)."""
    own_np, soq_np = _host_ids(owner_of_query), _host_ids(scene_of_query)
    reason = persist_kernel_unsupported(own_np, soq_np)
    if reason is not None:
        raise NotImplementedError(
            f"{reason}: such owner groups are not ported yet (ROADMAP "
            f"B.2.5; the kernel's fold cell is tile-local, and the "
            f"largest tile holds MAX_TILE_BQ = {MAX_TILE_BQ} slots)")
    tm = build_tile_map(obb_c.shape[0], bq, soq_np, own_np)
    d = obb_c.device
    perm = torch.from_numpy(np.maximum(tm.perm, 0)).to(d)

    def permuted(x):
        return None if x is None else torch.as_tensor(x).to(d)[perm]
    return dict(obb_c=obb_c[perm], obb_h=obb_h[perm], obb_r=obb_r[perm],
                owner_of_query=permuted(owner_of_query),
                payload=permuted(payload),
                tiles=Tiling(*(torch.from_numpy(x).to(d) for x in tm.tiles)),
                bq=tm.bq)


def traverse_whole(obb_c, obb_h, obb_r, dev, capacity: int, *,
                   use_spheres: bool, scene_of_query=None,
                   owner_of_query=None, payload=None,
                   streamed: Optional[bool] = None, bq: int = DEFAULT_BQ,
                   ring_cap: int = DEFAULT_RING_CAP, num_valid=None,
                   tiles: Optional[Tiling] = None
                   ) -> Tuple[torch.Tensor, dict]:
    """Whole multi-level traversal for one flat query set; returns
    ``(verdict, stats dict)``.

    ``dev`` is a one-scene :class:`DeviceOctree`, or the flat table of a
    ragged batch, a :class:`MultiSceneOctree`, with ``scene_of_query``
    (Q,) naming each query's scene.  A pool with a scene or owner lane
    runs tiled (:func:`tile_pool`: scene-exclusive tiles, each seeded at
    its scene's root, flat node ``s`` of level 0); the caller may pass it
    tiled already (rows, owners and payloads in slot space, ``tiles`` and
    its ``bq``), as the engine does before its escalation ladder.  The
    verdict is the (Q,) bool collide flags, mapped back from the slots by
    ``slot_of_query``, or with an owner or payload lane the (Q,) int32
    ``best`` payload per verdict group (compact owner ids; cells past the
    group count are ``PAYLOAD_INF``), read at each group's fold slot
    (``group_slot``).  An identity pool (one scene, no owner lane) runs
    untiled, every query its own verdict group, and ``num_valid`` (default
    Q) is its live prefix: slots past it seed nothing and add 0 to every
    counter.  Runs on the device of ``dev`` (the OBB tensors are moved
    there).  ``streamed`` picks the layout (``None``: the chooser's pick
    for the table's own format and width); it changes ``meta_rows`` and
    nothing else.
    """
    ragged = isinstance(dev, MultiSceneOctree)
    if scene_of_query is not None and not ragged:
        raise ValueError("scene_of_query needs a MultiSceneOctree flat "
                         "table (concat_device_octrees)")
    tiled = tiles is not None or ragged or owner_of_query is not None
    if num_valid is not None and tiled:
        raise ValueError("num_valid marks the live prefix of an identity "
                         "pool; a tiled pool marks its pads")
    if streamed is None:
        streamed = choose_meta_layout(
            dev.depth, dev.node_meta.shape[-2],
            fmt=dev.meta_format).layout == "streamed"
    d = dev.device
    obb_c, obb_h, obb_r = (torch.as_tensor(x, dtype=torch.float32).to(d)
                           for x in (obb_c, obb_h, obb_r))
    if payload is not None:
        payload = torch.as_tensor(payload, dtype=torch.int32).to(d)
    grouped = owner_of_query is not None or payload is not None

    if tiled and tiles is None:
        if ragged and scene_of_query is None:
            raise ValueError("a MultiSceneOctree needs scene_of_query (Q,) "
                             "or a tiled pool")
        return traverse_whole(dev=dev, capacity=capacity,
                              use_spheres=use_spheres, streamed=streamed,
                              ring_cap=ring_cap,
                              **tile_pool(obb_c, obb_h, obb_r,
                                          owner_of_query, payload, bq,
                                          scene_of_query))

    if tiled:
        tiles = Tiling(*(torch.as_tensor(x).to(d) for x in tiles))
        Qs = obb_c.shape[0]
        best, st = _kernel_whole(obb_c, obb_h, obb_r, dev, capacity,
                                 use_spheres, bq, ring_cap, streamed,
                                 payload=payload,
                                 owner_local=tiles.owner_local,
                                 scene_of_tile=tiles.scene_of_tile)
        if not grouped:
            return (best != PAYLOAD_INF)[tiles.slot_of_query.to(
                torch.int64)], st
        # Each group's best lies at its fold slot; cells past the group
        # count are PAYLOAD_INF.
        gs = tiles.group_slot.to(torch.int64)
        return torch.where(gs >= 0, best[gs.clamp(0, Qs - 1)],
                           PAYLOAD_INF), st

    # ---- identity (per-query groups) pools ----------------------------
    M = obb_c.shape[0]
    best, st = _kernel_whole(obb_c, obb_h, obb_r, dev, capacity, use_spheres,
                             bq, ring_cap, streamed, payload=payload,
                             num_valid=num_valid)
    best = best[:M]
    return (best if payload is not None else best != PAYLOAD_INF), st
