"""Packing and dispatch for the dense SACT kernel.

``sact_dense`` runs the CUDA kernel (``csrc/sact_dense.cu``: tiles of OBBs
x AABBs, the OBBs' own terms staged once in shared memory, vector
streaming stores) on CUDA tensors and its plain PyTorch version
(:func:`repro_torch.kernels.sact.ref.sact_ref`) on CPU tensors; a build or
launch failure raises.  The kernel runs the stages of ``csrc/sact_tile.cuh``
in the mode :data:`STAGE_MODE`; :func:`sact_dense_in_mode` runs any mode of
:data:`STAGE_MODES`, which the card checks hold to the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.sact.ref import sact_ref

#: ``sact_tile.cuh``'s stage modes (``SactMode``), by the kernel's number:
#: ``straight`` runs every stage (``persist.cu`` and ``traverse.cu`` ship
#: it), ``warp_vote`` skips the edge stage for a warp whose lanes are all
#: decided after the faces.
STAGE_MODES = {"straight": 0, "warp_vote": 1}
#: The mode ``sact_dense`` ships, chosen by timing (PERF.md section 6).
STAGE_MODE = "warp_vote"


def pack_obbs(center, half, rot) -> torch.Tensor:
    """(M,3),(M,3),(M,3,3) -> (M,15) [center half rot-row-major] float32."""
    return torch.cat([center, half, rot.reshape(rot.shape[0], 9)],
                     dim=-1).to(torch.float32).contiguous()


def pack_aabbs(center, half) -> torch.Tensor:
    """(N,3),(N,3) -> (N,6) [center half] float32."""
    return torch.cat([center, half], dim=-1).to(torch.float32).contiguous()


def _lib():
    lib = _build.load("sact_dense")
    fn = lib.sact_dense_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def sact_dense(obb: torch.Tensor, aabb: torch.Tensor,
               use_spheres: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Staged SACT over all pairs of packed OBBs (M, 15) x AABBs (N, 6).

    Returns (collide (M, N) bool, exit_code (M, N) int32).
    """
    return sact_dense_in_mode(obb, aabb, use_spheres, STAGE_MODE)


def sact_dense_in_mode(obb: torch.Tensor, aabb: torch.Tensor,
                       use_spheres: bool, mode: str
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`sact_dense` with the kernel's stages run in ``mode`` (a key
    of :data:`STAGE_MODES`); every mode gives the same outputs."""
    if mode not in STAGE_MODES:
        raise ValueError(f"mode must be one of {sorted(STAGE_MODES)}, got "
                         f"{mode!r}")
    if obb.ndim != 2 or obb.shape[1] != 15 or aabb.ndim != 2 \
            or aabb.shape[1] != 6:
        raise ValueError(f"want obb (M, 15) and aabb (N, 6), got "
                         f"{tuple(obb.shape)} and {tuple(aabb.shape)}")
    if obb.device != aabb.device:
        raise ValueError("obb and aabb must share a device")
    if obb.device.type == "cpu":
        return sact_ref(obb.to(torch.float32), aabb.to(torch.float32),
                        use_spheres)
    if obb.device.type != "cuda":
        raise ValueError(f"unsupported device {obb.device}")
    if obb.dtype != torch.float32 or aabb.dtype != torch.float32:
        raise ValueError("sact_dense takes float32 tensors")
    obb, aabb = obb.contiguous(), aabb.contiguous()
    M, N = obb.shape[0], aabb.shape[0]
    collide = torch.empty((M, N), dtype=torch.bool, device=obb.device)
    exit_code = torch.empty((M, N), dtype=torch.int32, device=obb.device)
    launch = _lib()
    with torch.cuda.device(obb.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = launch(obb.data_ptr(), aabb.data_ptr(), collide.data_ptr(),
                        exit_code.data_ptr(), M, N, int(use_spheres),
                        STAGE_MODES[mode], stream)
    _build.check(status, "sact_dense")
    _build.count_launch("sact_dense")
    return collide, exit_code
