"""Fused wavefront traversal step: one level, frontier in / frontier out.

``traverse_step`` is the loop body of ``mode="wavefront_fused"``, the
counterpart of ``repro.kernels.traverse.ops.traverse_step``.  The frontier
carries (query, CSR node index) pairs.  Per level it gathers each lane's
packed node-metadata row and decodes it (fp32, bf16 or u8 rows), runs
:func:`traverse_test` -- the CUDA kernel ``csrc/traverse.cu`` on CUDA
tensors, its plain version :func:`repro_torch.kernels.traverse.ref.
traverse_test_ref` on CPU tensors -- folds terminal hits into the
verdicts, and expands the overlapping internal nodes through the CSR child
table (occupancy bit ``j`` of the node's mask, child index ``child_start
+ popcount(mask & ((1 << j) - 1))``) into the stream compaction of
:func:`repro_torch.kernels.compact.ops.compact_pairs`.

Nothing here waits for the device: ``n_live`` stays a device tensor, the
kernel reads it from device memory, and there is no boolean-mask
indexing.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from repro_torch.core.octree import DeviceOctree
from repro_torch.core.quantize import BF16_START_BITS, U8_START_BITS
from repro_torch.core.sact import (SactResult, axis_tests_from_exit,
                                   fold_verdicts, mask_frontier_result)
from repro_torch.kernels import _build
from repro_torch.kernels.compact.ops import compact_pairs
from repro_torch.kernels.persist.ref import csr_child_slots
from repro_torch.kernels.traverse.ref import (traverse_test_ref,
                                              unpack_verdicts)

_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
             + [ctypes.c_float] * 4 + [ctypes.c_int] * 2
             + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
_launch = None
#: The raw current stream of a device, without building a Stream object
#: (a level's call is paced by the host: a few microseconds matter here).
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _lib():
    global _launch
    if _launch is None:
        fn = _build.load("traverse").traverse_launch
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _launch = fn
    return _launch


def _refuse(obb, q_idx, codes, full, n_live, lo) -> None:
    """Raise for what neither version takes (the checks, spelled out);
    returns for inputs the kernel takes once made contiguous, and for CPU
    tensors."""
    cap = q_idx.shape[0] if q_idx.ndim == 1 else -1
    if obb.ndim != 2 or obb.shape[1] != 15:
        raise ValueError(f"want obb (m, 15), got {tuple(obb.shape)}")
    if q_idx.ndim != 1 or codes.shape != (cap,) or full.shape != (cap,) \
            or len(lo) != 3 or n_live.numel() != 1:
        raise ValueError("traverse_test: inconsistent input shapes")
    dev = obb.device
    if any(x.device != dev for x in (q_idx, codes, full, n_live)):
        raise ValueError("traverse_test: inputs must share a device")
    if dev.type == "cpu":
        return
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if obb.dtype != torch.float32 or any(
            x.dtype != torch.int32 for x in (q_idx, codes, full, n_live)):
        raise ValueError("traverse_test takes a float32 OBB table and int32 "
                         "lanes")


def traverse_test(obb: torch.Tensor, q_idx: torch.Tensor, codes: torch.Tensor,
                  full: torch.Tensor, n_live: torch.Tensor, *, cell: float,
                  lo: Sequence[float], is_leaf: bool,
                  use_spheres: bool) -> torch.Tensor:
    """Packed (capacity,) verdict words of one frontier level (the inputs
    of :func:`traverse_test_ref`).  ``cell`` and ``lo`` are host floats
    (the level's float32 values), ``n_live`` stays on the device."""
    cap = q_idx.shape[0]
    i32 = torch.int32
    # The checks of _refuse in as few host operations as the happy path
    # allows: a level's call is paced by the host.
    idx = obb.get_device()
    ok = (idx >= 0 and obb.dtype is torch.float32 and q_idx.dtype is i32
          and codes.dtype is i32 and full.dtype is i32 and n_live.dtype is i32
          and obb.ndim == 2 and obb.shape[1] == 15 and q_idx.ndim == 1
          and codes.shape == q_idx.shape and full.shape == q_idx.shape
          and n_live.numel() == 1 and len(lo) == 3
          and q_idx.get_device() == idx and codes.get_device() == idx
          and full.get_device() == idx and n_live.get_device() == idx
          and obb.is_contiguous() and q_idx.is_contiguous()
          and codes.is_contiguous() and full.is_contiguous())
    if not ok:
        _refuse(obb, q_idx, codes, full, n_live, lo)
        if obb.device.type == "cpu":
            return traverse_test_ref(obb, q_idx, codes, full, n_live,
                                     cell=cell, lo=lo, is_leaf=is_leaf,
                                     use_spheres=use_spheres)
        obb, q_idx, codes, full = (x.contiguous() for x in (obb, q_idx,
                                                            codes, full))
    packed = torch.empty(cap, dtype=i32, device=obb.device)
    launch = _lib()
    stream = (_raw_stream(idx) if _raw_stream is not None
              else torch.cuda.current_stream(obb.device).cuda_stream)
    args = (obb.data_ptr(), obb.shape[0], q_idx.data_ptr(), codes.data_ptr(),
            full.data_ptr(), n_live.data_ptr(), cell, lo[0], lo[1], lo[2],
            int(is_leaf), cap, packed.data_ptr(), int(use_spheres), stream)
    if idx == torch.cuda.current_device():
        err = launch(*args)
    else:
        with torch.cuda.device(idx):
            err = launch(*args)
    _build.check(err, "traverse")
    _build.count_launch("traverse")
    return packed


def decode_rows(dev: DeviceOctree, level: int, idx: torch.Tensor):
    """Gather and decode the packed rows of ``idx`` (in range) at
    ``level`` -> (codes int32, full bool, child_start int32, child_mask
    int32).  The compressed formats keep topology in word 0; their codes
    come from the level's code plane."""
    meta = dev.node_meta[level][idx]
    if dev.meta_format == "fp32":
        return (meta[:, 0].contiguous(), meta[:, 1] != 0, meta[:, 2],
                meta[:, 3])
    w0 = meta[:, 0]
    bits = BF16_START_BITS if dev.meta_format == "bf16" else U8_START_BITS
    return (dev.codes[level][idx], w0 < 0, (w0 >> 8) & ((1 << bits) - 1),
            w0 & 0xFF)


def traverse_step(obb: torch.Tensor, dev: DeviceOctree, level: int,
                  n_live: torch.Tensor, q_idx: torch.Tensor,
                  node_idx: torch.Tensor, verdict: torch.Tensor, *,
                  use_spheres: bool, owner=None, payload=None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor, dict]:
    """One fused wavefront level for a single scene / query set.

    ``obb`` is the packed (M, 15) OBB table
    (:func:`repro_torch.kernels.sact.ops.pack_obbs`), ``verdict`` the (M,)
    int32 boolean verdicts, updated in place, or with ``owner`` /
    ``payload`` lanes ((M,) int32 tensors) the int32 ``best`` cells of the
    verdict groups: a terminal hit folds its payload into its owner's cell
    (:func:`repro_torch.core.sact.fold_verdicts`, in this glue as in the
    reference; the kernel is the same), and a lane expands only while its
    payload can still beat that cell.  Returns ``(n_next, q_next,
    idx_next, verdict, info)``, ``info`` carrying the per-lane quantities
    the work model counts (``valid``, ``is_term``, ``res``, ``codes``,
    ``n_new``).  Lanes past ``n_next`` hold query 0 and node 0.
    """
    capacity = q_idx.shape[0]
    valid = torch.arange(capacity, device=q_idx.device) < n_live
    is_leaf = level == dev.depth
    idx_c = node_idx.clamp(0, dev.codes.shape[-1] - 1)
    codes, full_l, child_start, child_mask = decode_rows(dev, level, idx_c)
    packed = traverse_test(obb, q_idx, codes, full_l.to(torch.int32), n_live,
                           cell=dev.host_cells[level], lo=dev.host_lo,
                           is_leaf=is_leaf, use_spheres=use_spheres)
    collide_raw, is_term, exit_code = unpack_verdicts(packed)
    n_sphere = torch.full((capacity,), 2 if use_spheres else 0,
                          dtype=torch.int32, device=q_idx.device)
    res = mask_frontier_result(
        SactResult(collide=collide_raw, exit_code=exit_code,
                   axis_tests=axis_tests_from_exit(exit_code),
                   sphere_tests=n_sphere), valid)
    if is_leaf:
        is_term = torch.ones_like(is_term)

    overlap = res.collide & valid
    verdict, undecided = fold_verdicts(verdict, q_idx.to(torch.int64),
                                       overlap & is_term, owner, payload)

    # O(1) CSR expansion + stream compaction.
    occupied, offs = csr_child_slots(child_mask)                   # (cap, 8)
    cand_idx = child_start[:, None] + offs
    # Early exit: decided queries retire their whole wavefront share.
    expand = overlap & ~is_term & undecided
    child_live = (expand[:, None] & occupied).reshape(-1)          # (cap*8,)
    n_new = child_live.sum(dtype=torch.int32)
    cnt, q_next, idx_next = compact_pairs(
        child_live, q_idx.repeat_interleave(8), cand_idx.reshape(-1),
        capacity)
    info = dict(valid=valid, is_term=is_term, res=res, codes=codes,
                n_new=n_new)
    return cnt, q_next, idx_next, verdict, info
