"""Dispatch for the furthest-point-sampling kernel.

:func:`fps` runs the CUDA kernel (``csrc/fps.cu``: one CTA per cloud, the
whole sampling loop inside the kernel, each thread's points and their
distances in registers, one barrier a step) on CUDA tensors and its plain
PyTorch version (:func:`repro_torch.kernels.fps.ref.fps_ref`) on CPU
tensors; a build or launch failure raises.  A cloud holds at most
:data:`MAX_POINTS` points (1,024 threads of 16 points; the coordinates
also sit in the block's shared memory, 12 B a point); a larger one raises
rather than taking another path.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fps.ref import fps_ref

#: Shared memory one block may use on the H100 (227 KB).
MAX_SMEM_BYTES = 232448
#: Threads a block and points a thread, at most (the source's instances).
MAX_THREADS = 1024
MAX_POINTS_A_THREAD = 16
#: Largest cloud the kernel takes.
MAX_POINTS = MAX_THREADS * MAX_POINTS_A_THREAD
#: The kernel's shared memory besides the planes (the source's
#: ``kSlotBytes``): per-warp (bits, index) slots for two step parities.
_SMEM_FIXED = 2 * 32 * 8


def smem_bytes(n: int) -> int:
    """The kernel's shared memory for a cloud of ``n`` points (the
    source's ``fps_smem_bytes``): three coordinate planes and the slots."""
    return 12 * n + _SMEM_FIXED


def threads_for(n: int) -> int:
    """Threads per block: about eight points a thread, 32 to 1024."""
    return min(MAX_THREADS, max(32, 32 * -(-n // 256)))


def _lib():
    fn = _build.load("fps").fps_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 5
                       + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
    return fn


def fps(points: torch.Tensor, m: int, first: int = 0) -> torch.Tensor:
    """Furthest point sampling: ``points (N, 3)`` -> ``(m,)`` int32, or a
    batch ``(B, N, 3)`` -> ``(B, m)``, on the input's device."""
    if points.ndim not in (2, 3) or points.shape[-1] != 3:
        raise ValueError(f"want points (N, 3) or (B, N, 3), got "
                         f"{tuple(points.shape)}")
    dev = points.device
    if dev.type == "cpu":
        return fps_ref(points, m, first)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if points.dtype != torch.float32:
        raise ValueError(f"fps takes float32 points, got {points.dtype}")
    batched = points.ndim == 3
    pts = (points if batched else points[None]).contiguous()
    B, N, _ = pts.shape
    if not 0 <= first < N or m < 1:
        raise ValueError(f"need 0 <= first < N = {N} and m >= 1, got "
                         f"first={first}, m={m}")
    if N > MAX_POINTS:
        raise ValueError(
            f"fps keeps a cloud in one block's registers and shared memory: "
            f"at most {MAX_POINTS} points ({MAX_THREADS} threads of "
            f"{MAX_POINTS_A_THREAD}), got {N}")
    out = torch.empty((B, m), dtype=torch.int32, device=dev)
    launch = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        status = launch(pts.data_ptr(), B, N, m, first, threads_for(N),
                        out.data_ptr(), stream)
    _build.check(status, "fps")
    _build.count_launch("fps")
    return out if batched else out[0]
