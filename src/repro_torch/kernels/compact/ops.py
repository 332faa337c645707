"""Dispatch for the stream-compaction kernel.

:func:`compact_channels` runs the CUDA kernel (``csrc/compact.cu``) on CUDA
tensors and its plain PyTorch version (:func:`repro_torch.kernels.compact.
ref.compact_ref`) on CPU tensors; a build or launch failure raises.  The
kernel takes its channels channel-major, ``(C, N)``, so each compacted
channel comes out as one contiguous row: :func:`compact_pairs`, the
frontier compaction of both per-level arms, hands its two columns
straight to the next level.  :func:`stream_compact` keeps the reference's
row-major ``(N, C)`` interface.

Both versions zero-fill the output past ``count``, so a retired frontier
lane holds query 0 and node 0, in range for every later gather.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.compact.ref import compact_ref

#: Lanes per block of the count and scatter passes (``kBlock`` in the
#: source, the reference's ``bn``).
BLOCK = 256


def _lib():
    fn = _build.load("compact").compact_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p] * 4)
        fn.restype = ctypes.c_int
    return fn


def compact_channels(mask: torch.Tensor, chans: torch.Tensor, n_out: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compact ``chans (C, N)`` int32 by ``mask (N,)`` bool into ``(C,
    n_out)``; returns ``(count () int32, out (C, n_out) int32)``, both on
    the input's device."""
    if mask.ndim != 1 or chans.ndim != 2 or chans.shape[1] != mask.shape[0]:
        raise ValueError(f"want mask (N,) and chans (C, N), got "
                         f"{tuple(mask.shape)} and {tuple(chans.shape)}")
    if mask.device != chans.device:
        raise ValueError("mask and chans must share a device")
    if n_out < 0:
        raise ValueError(f"n_out must be >= 0, got {n_out}")
    dev = chans.device
    if dev.type == "cpu":
        count, out = compact_ref(mask, chans.t(), n_out)
        return count, out.t().contiguous()
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if mask.dtype != torch.bool or chans.dtype != torch.int32:
        raise ValueError(f"compact takes a bool mask and int32 channels, got "
                         f"{mask.dtype} and {chans.dtype}")
    C, N = chans.shape
    if max(N, n_out) >= 2**31 - BLOCK:
        raise ValueError(f"compact takes fewer than 2**31 lanes and slots, "
                         f"got {N} and {n_out}")
    mask, chans = mask.contiguous(), chans.contiguous()
    out = torch.zeros((C, n_out), dtype=torch.int32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    blk = torch.empty(max(-(-N // BLOCK), 1), dtype=torch.int32, device=dev)
    launch = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        status = launch(mask.data_ptr(), chans.data_ptr(), N, C, n_out,
                        blk.data_ptr(), out.data_ptr(), count.data_ptr(),
                        stream)
    _build.check(status, "compact")
    _build.count_launch("compact")
    return count, out


def stream_compact(mask: torch.Tensor, vals: torch.Tensor, n_out: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack rows of ``vals (N, C)`` where ``mask`` holds into an ``(n_out,
    C)`` buffer; returns ``(count () int32, packed (n_out, C))``.  Rows past
    ``count`` are zero; survivors that would land past ``n_out`` are
    dropped."""
    if vals.device.type == "cpu":
        return compact_ref(mask, vals.to(torch.int32), n_out)
    count, out = compact_channels(mask, vals.to(torch.int32).t(), n_out)
    return count, out.t()


def compact_pairs(mask: torch.Tensor, q_idx: torch.Tensor,
                  codes: torch.Tensor, n_out: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Frontier compaction of (query, node) int32 pairs in one pass: node
    Morton codes (as int32 bit patterns) for ``mode="wavefront"``, CSR node
    indices for ``mode="wavefront_fused"``.  Returns ``(count, q_idx
    (n_out,), codes (n_out,))``."""
    chans = torch.stack([q_idx.to(torch.int32), codes.to(torch.int32)])
    count, out = compact_channels(mask, chans, n_out)
    return count, out[0], out[1]
