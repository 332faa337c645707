"""Dispatch for the ball-query kernel.

:func:`ball_query` runs the CUDA kernel (``csrc/ballquery.cu``: one warp
per query, ascending 32-point chunks placed by ballot ranks, exit at
``k`` hits) on CUDA tensors and its plain PyTorch version
(:func:`repro_torch.kernels.ballquery.ref.ball_query_ref`) on CPU
tensors; a build or launch failure raises.  Its argument order is the
reference kernel wrapper's, ``ball_query_tiled(queries, points, radius,
k)``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.core.ballquery import radius_sq
from repro_torch.kernels import _build
from repro_torch.kernels.ballquery.ref import ball_query_ref


def _lib():
    fn = _build.load("ballquery").ballquery_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                       + [ctypes.c_float, ctypes.c_int]
                       + [ctypes.c_void_p] * 3)
        fn.restype = ctypes.c_int
    return fn


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
    if queries.device != points.device:
        raise ValueError("queries and points must share a device")
    dev = queries.device
    if dev.type == "cpu":
        return ball_query_ref(points, queries, radius, k)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
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
    idx = torch.empty((B, M, k), dtype=torch.int32, device=dev)
    count = torch.empty((B, M), dtype=torch.int32, device=dev)
    launch = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        status = launch(qs.data_ptr(), pts.data_ptr(), B, M, N,
                        radius_sq(radius), k, idx.data_ptr(),
                        count.data_ptr(), stream)
    _build.check(status, "ballquery")
    _build.count_launch("ballquery")
    return (idx, count) if batched else (idx[0], count[0])
