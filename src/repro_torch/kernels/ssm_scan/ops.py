"""Dispatch for the selective-scan kernel.

:func:`ssm_scan` runs the CUDA kernel (``csrc/ssm_scan.cu``: a thread a
state element, the state in a register, a serial loop over the steps, y's
sum over a channel's lanes by shuffles; one launch a call) on CUDA tensors
and the plain version (:func:`repro_torch.kernels.ssm_scan.ref.
ssm_scan_ref`, a loop over S) on CPU tensors; a build or launch failure
raises, and so does what the kernel cannot run.

The kernel replaces no Pallas kernel: the reference's
``models/ssm.py::ssm_scan`` (:47-73) is a ``lax.scan``.  It has no
backward yet: in grad mode, with an input that needs a gradient on the
card, the call raises ``NotImplementedError`` (ROADMAP A.11 step 2b, Hymba
training).

``xi`` (B, S, di), ``Bm`` and ``Cm`` (B, S, n) and ``dt`` (B, S) share one
dtype, fp32 or bf16 (the model's gates in its compute dtype; the kernel
widens them in registers, the plain version casts them first: the same
values), each read through its strides with a unit stride on the last
axis (``dt`` at any strides), so the two halves of the model's (B, S, 2 n)
``bc`` go in as they lie.  ``A`` (di, n) and ``h0`` (B, di, n) are fp32;
``n`` is 8 or 16, the state widths of the configs (``hymba_smoke``'s and
Hymba 1.5B's; a channel's lanes lie in one warp).
Returns ``(y (B, S, di), final state (B, di, n))``, both fp32.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

#: State widths the kernel is built for: those of the configs.
WIDTHS = (8, 16)


def _lib():
    fn = _build.load("ssm_scan").ssm_scan_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                       + [ctypes.c_longlong] * 8 + [ctypes.c_int]
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(xi, Bm, Cm, dt, A, h0) -> None:
    if xi.ndim != 3:
        raise ValueError(f"ssm_scan wants xi (B, S, di), got "
                         f"{tuple(xi.shape)}")
    Bb, S, di = xi.shape
    if Bm.ndim != 3 or Bm.shape[:2] != (Bb, S) or Cm.shape != Bm.shape:
        raise ValueError(f"ssm_scan: Bm {tuple(Bm.shape)} and Cm "
                         f"{tuple(Cm.shape)} do not fit xi "
                         f"{tuple(xi.shape)}")
    n = Bm.shape[2]
    if tuple(dt.shape) != (Bb, S):
        raise ValueError(f"ssm_scan: dt {tuple(dt.shape)}, want {(Bb, S)}")
    if tuple(A.shape) != (di, n):
        raise ValueError(f"ssm_scan: A {tuple(A.shape)}, want {(di, n)}")
    if h0 is not None and tuple(h0.shape) != (Bb, di, n):
        raise ValueError(f"ssm_scan: h0 {tuple(h0.shape)}, want "
                         f"{(Bb, di, n)}")
    ins = [xi, Bm, Cm, dt, A] + ([] if h0 is None else [h0])
    devs = {x.device for x in ins}
    if len(devs) != 1:
        raise ValueError(f"ssm_scan: inputs on several devices {devs}")
    if devs.pop().type not in ("cpu", "cuda"):
        raise ValueError(f"ssm_scan: unsupported device {xi.device}")
    if xi.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"ssm_scan takes fp32 or bf16 gates, got "
                         f"{xi.dtype}")
    if any(x.dtype != xi.dtype for x in (Bm, Cm, dt)):
        raise ValueError(f"ssm_scan: xi, Bm, Cm, dt must share a dtype, got "
                         f"{xi.dtype}, {Bm.dtype}, {Cm.dtype}, {dt.dtype}")
    if A.dtype != torch.float32 or (h0 is not None
                                    and h0.dtype != torch.float32):
        raise ValueError("ssm_scan takes fp32 A and h0")
    if n not in WIDTHS:
        raise ValueError(f"ssm_scan kernel takes a state width n in "
                         f"{WIDTHS}, got {n}")
    for name, x in (("xi", xi), ("Bm", Bm), ("Cm", Cm)):
        if x.stride(2) != 1:
            raise ValueError(f"ssm_scan needs {name} with a unit stride on "
                             f"its last axis, got strides {x.stride()}")


def ssm_scan(xi: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
             dt: torch.Tensor, A: torch.Tensor,
             h0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The selective scan from ``h0`` (zero when None): ``(y, h)``."""
    _check(xi, Bm, Cm, dt, A, h0)
    if xi.device.type == "cpu":
        return ssm_scan_ref(xi, Bm, Cm, dt, A, h0)
    ins = (xi, Bm, Cm, dt, A) + (() if h0 is None else (h0,))
    if torch.is_grad_enabled() and any(x.requires_grad for x in ins):
        raise NotImplementedError(
            "ssm_scan has no backward kernel yet (ROADMAP A.11 step 2b, "
            "Hymba training): call it under torch.no_grad() or "
            "torch.inference_mode()")
    Bb, S, di = xi.shape
    n = Bm.shape[2]
    A = A.contiguous()
    h0 = None if h0 is None else h0.contiguous()
    y = torch.empty((Bb, S, di), dtype=torch.float32, device=xi.device)
    h = torch.empty((Bb, di, n), dtype=torch.float32, device=xi.device)
    launch = _lib()
    with torch.cuda.device(xi.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = launch(xi.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                        dt.data_ptr(), A.data_ptr(),
                        None if h0 is None else h0.data_ptr(), y.data_ptr(),
                        h.data_ptr(), Bb, S, di, n, xi.stride(0),
                        xi.stride(1), Bm.stride(0), Bm.stride(1),
                        Cm.stride(0), Cm.stride(1), dt.stride(0),
                        dt.stride(1), int(xi.dtype == torch.bfloat16),
                        stream)
    _build.check(status, "ssm_scan")
    _build.count_launch("ssm_scan")
    return y, h
