"""Dispatch for the ball-query kernel.

:func:`ball_query` runs the CUDA kernel (``csrc/ballquery.cu``: a CTA
stages one cloud in shared memory and walks a block of its queries over
it, a warp a query, ascending 32-point chunks placed by ballot ranks, exit
at ``k`` hits) on CUDA tensors and its plain PyTorch version
(:func:`repro_torch.kernels.ballquery.ref.ball_query_ref`) on CPU
tensors; a build or launch failure raises.  Its argument order is the
reference kernel wrapper's, ``ball_query_tiled(queries, points, radius,
k)``.  :func:`query_block` sizes the kernel's query blocks.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.core.ballquery import radius_sq
from repro_torch.kernels import _build
from repro_torch.kernels.ballquery.ref import ball_query_ref


#: Queries a CTA at most: the block the rule picks at the batched encode's
#: sa1 (B = 32, M = 256), the fastest there (PERF.md section 6); the
#: kernel takes up to 64 (``kMaxBlock`` in ``csrc/ballquery.cu``).
MAX_QUERY_BLOCK = 16


def query_block(batch: int, m: int, sms: int) -> int:
    """Queries a CTA of the kernel: the largest power of two up to
    :data:`MAX_QUERY_BLOCK` whose grid, ``batch * ceil(m / qb)`` CTAs, still
    covers all ``sms`` SMs, or 1 where no block can (``batch * m < sms``).
    CTA ``i`` takes cloud ``i // ceil(m / qb)`` and its queries from
    ``(i % ceil(m / qb)) * qb``, at most ``qb`` of them."""
    qb = MAX_QUERY_BLOCK
    while qb > 1 and batch * -(-m // qb) < sms:
        qb //= 2
    return qb


@functools.lru_cache(maxsize=256)
def _block(batch: int, m: int, index: int) -> int:
    """:func:`query_block` on device ``index``."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return query_block(batch, m, sms)


_r2 = functools.lru_cache(maxsize=64)(radius_sq)
_launch = None
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _lib():
    global _launch
    if _launch is None:
        fn = _build.load("ballquery").ballquery_launch
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                       + [ctypes.c_float] + [ctypes.c_int] * 2
                       + [ctypes.c_void_p] * 3)
        fn.restype = ctypes.c_int
        _launch = fn
    return _launch


def ball_query(queries: torch.Tensor, points: torch.Tensor, radius: float,
               k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """First ``k`` neighbours within ``radius``: ``queries (M, 3)``,
    ``points (N, 3)`` -> ``(idx (M, k) int32 [-1 padded], count (M,)
    int32)``; or batched, ``(B, M, 3)`` and ``(B, N, 3)`` -> ``(B, M, k)``
    and ``(B, M)``.  On the inputs' device."""
    batched = queries.ndim == 3
    if (queries.ndim not in (2, 3) or points.ndim != queries.ndim
            or queries.shape[-1] != 3 or points.shape[-1] != 3
            or (batched and queries.shape[0] != points.shape[0])):
        raise ValueError(f"want queries (M, 3) and points (N, 3), or (B, M, "
                         f"3) and (B, N, 3); got {tuple(queries.shape)} and "
                         f"{tuple(points.shape)}")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    index = queries.get_device() if queries.is_cuda else -1
    if index < 0 or not points.is_cuda or points.get_device() != index:
        if queries.device != points.device:
            raise ValueError("queries and points must share a device")
        if queries.device.type == "cpu":
            return ball_query_ref(points, queries, radius, k)
        raise ValueError(f"unsupported device {queries.device}")
    if queries.dtype != torch.float32 or points.dtype != torch.float32:
        raise ValueError(f"ball_query takes float32 inputs, got "
                         f"{queries.dtype} and {points.dtype}")
    qs = (queries if batched else queries[None]).contiguous()
    pts = (points if batched else points[None]).contiguous()
    B, M, _ = qs.shape
    N = pts.shape[1]
    if B * M >= 2**31 or B * M * k >= 2**31:
        raise ValueError(f"ball_query takes fewer than 2**31 queries and "
                         f"output slots, got {B * M} and {B * M * k}")
    # one allocation: the indices, then the counts
    out = torch.empty(B * M * (k + 1), dtype=torch.int32, device=index)
    idx, count = out[:B * M * k].view(B, M, k), out[B * M * k:].view(B, M)
    args = (qs.data_ptr(), pts.data_ptr(), B, M, N, _r2(radius), k,
            _block(B, M, index), idx.data_ptr(), count.data_ptr())
    launch = _lib()
    if index == torch.cuda.current_device() and _raw_stream is not None:
        status = launch(*args, _raw_stream(index))
    else:
        with torch.cuda.device(index):
            status = launch(*args, torch.cuda.current_stream().cuda_stream)
    _build.check(status, "ballquery")
    _build.count_launch("ballquery")
    return (idx, count) if batched else (idx[0], count[0])
