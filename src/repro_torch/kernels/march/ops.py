"""Dispatch for the occupancy-grid ray-march kernel.

:func:`march` runs the CUDA kernel on CUDA tensors and its plain PyTorch
version (:func:`repro_torch.kernels.march.ref.march_ref`) on CPU tensors;
a build or launch failure raises.  Both update ``pos``, ``dist`` and
``active`` in place.  The kernel (``csrc/march.cu``) spreads each ray over
16 lanes of a warp and marches it in rounds of 16 steps, one a lane:
every lane runs the ray's serial sums itself and keeps its own step's
position, the round's divides and grid loads go out with no dependence
between them, and a ballot finds the first step that hits, whose lane
writes the outputs (``ref.py::march_grouped_ref`` is that schedule in
PyTorch).  A grid of up to 48 KB is copied into shared memory first; a
larger one, or one whose storage is not 16-byte aligned, is read through
L1.  A ray inactive on entry costs no divide and no load.

The reference has no Pallas kernel here: its march is a
``jax.lax.fori_loop`` over ``repro/core/mcl.py::_march_step``, one
compiled device loop a cast.  A dense cast is one launch, as that loop
is; the compacted cast launches once a chunk of steps.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.march.ref import march_ref

_launch = None
#: The raw current stream of a device, without building a Stream object
#: (a call is paced by the host: a few microseconds matter here).
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)
_F32 = torch.float32


def _lib():
    global _launch
    if _launch is None:
        fn = _build.load("march").march_launch
        fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 2
                       + [ctypes.c_float] * 4 + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _launch = fn
    return _launch


def _check(occ, pos, dirv, dist, active) -> None:
    """Raise for what the kernel does not take."""
    R = pos.shape[0] if pos.ndim == 2 else -1
    want = ((occ, 2, (torch.bool, torch.uint8)), (pos, 2, (torch.float32,)),
            (dirv, 2, (torch.float32,)), (dist, 1, (torch.float32,)),
            (active, 1, (torch.bool,)))
    for t, ndim, dtypes in want:
        if t.ndim != ndim or t.dtype not in dtypes:
            raise ValueError(f"march takes occ (H, W) bool/uint8, pos and "
                             f"dirv (R, 2) float32, dist (R,) float32 and "
                             f"active (R,) bool; got a {tuple(t.shape)} "
                             f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError("march updates its tensors in place: they "
                             "must be contiguous")
        if t.device != pos.device:
            raise ValueError("march: every tensor on one device")
    if (pos.shape != (R, 2) or dirv.shape != (R, 2) or dist.shape != (R,)
            or active.shape != (R,)):
        raise ValueError(f"march: ray shapes differ: pos {tuple(pos.shape)}"
                         f", dirv {tuple(dirv.shape)}, dist "
                         f"{tuple(dist.shape)}, active {tuple(active.shape)}")


def march(occ: torch.Tensor, origin: Sequence[float], cell: float,
          pos: torch.Tensor, dirv: torch.Tensor, dist: torch.Tensor,
          active: torch.Tensor, max_range: float, n_steps: int) -> None:
    """March every active ray ``n_steps`` cells, in place (see
    :mod:`repro_torch.kernels.march.ref` for the step)."""
    # What the kernel takes, in as few host operations as the happy path
    # allows; anything else goes through the checks spelled out.
    idx = pos.get_device()
    R = pos.shape[0]
    ok = (idx >= 0 and pos.dtype is _F32 and dirv.dtype is _F32
          and dist.dtype is _F32 and active.dtype is torch.bool
          and (occ.dtype is torch.bool or occ.dtype is torch.uint8)
          and occ.ndim == 2 and pos.ndim == 2 and pos.shape[1] == 2
          and dirv.shape == pos.shape and dist.shape == (R,)
          and active.shape == (R,) and occ.get_device() == idx
          and dirv.get_device() == idx and dist.get_device() == idx
          and active.get_device() == idx and occ.is_contiguous()
          and pos.is_contiguous() and dirv.is_contiguous()
          and dist.is_contiguous() and active.is_contiguous()
          and pos.data_ptr() % 8 == 0 and dirv.data_ptr() % 8 == 0)
    if not ok:
        _check(occ, pos, dirv, dist, active)
        dev = pos.device
        if dev.type == "cpu":
            march_ref(occ, origin, cell, pos, dirv, dist, active, max_range,
                      n_steps)
            return
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        if pos.data_ptr() % 8 or dirv.data_ptr() % 8:
            raise ValueError("march reads pos and dirv as float2: 8-byte "
                             "aligned storage")
    if R == 0 or n_steps <= 0:
        return
    H, W = occ.shape
    launch = _lib()
    stream = (_raw_stream(idx) if _raw_stream is not None
              else torch.cuda.current_stream(pos.device).cuda_stream)
    args = (occ.data_ptr(), H, W, float(origin[0]), float(origin[1]),
            float(cell), float(max_range), pos.data_ptr(), dirv.data_ptr(),
            dist.data_ptr(), active.data_ptr(), R, int(n_steps), stream)
    if idx == torch.cuda.current_device():
        status = launch(*args)
    else:
        with torch.cuda.device(idx):
            status = launch(*args)
    _build.check(status, "march")
    _build.count_launch("march")
