"""Dispatch for the WKV6 kernels: the forward and its backward.

:func:`wkv6` and :func:`wkv6_heads` run the CUDA kernel (``csrc/wkv6.cu``:
the chunked form, chunks of 32 steps with their products on the tensor
cores in 3xTF32, one CTA per batch·head row and 64 value columns) on CUDA
tensors and the plain version (:func:`repro_torch.kernels.wkv6.ref.
wkv6_ref`, the step-by-step recurrence) on CPU tensors; a build or launch
failure raises, and so does any other device, dtype or layout.

Both start from a zero state and return ``(o, final state)``.  ``r``,
``k``, ``v`` are fp32 or bf16 (one dtype), ``logw`` and ``u`` fp32; ``o``
comes back in r's dtype and layout, the state in fp32.  The four inputs
share one layout with a unit stride on the last axis, so the (B, H, T, D)
view of a model's (B, T, H, D) projections goes in as it lies.  The
kernel takes D <= 128.

When grad mode is on and an input needs a gradient, both go through
:class:`WKV6Function`: its forward is the same kernel (or plain version),
its backward the backward kernels (``csrc/wkv6_bwd.cu``: the chunked
backward, each chunk's terms of the state's and its gradient's carries at
once, an elementwise scan over the chunks, then every (row, chunk) at
once on the tensor cores in 3xTF32, and a fixed-order sum of ``du`` over
the chunks and the rows that share a bonus row, so two runs give the same
bits) on CUDA tensors and its plain version (:func:`repro_torch.kernels.
wkv6.ref.wkv6_bwd_ref`, the reverse recurrence) on CPU tensors.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.wkv6.ref import wkv6_bwd_ref, wkv6_ref

#: Widest key/value width the kernel takes.
MAX_D = 128


def _lib():
    fn = _build.load("wkv6").wkv6_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                       + [ctypes.c_longlong] * 5 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p] * 3)
        fn.restype = ctypes.c_int
    return fn


def _aligned(xs, strides, D: int) -> bool:
    """Whether every row of ``xs`` starts 16-byte aligned (the kernel then
    copies them with 16-byte ``cp.async``; else with plain loads)."""
    for x in xs:
        e = 16 // x.element_size()
        if x.data_ptr() % 16 or D % e or any(s % e for s in strides):
            return False
    return True


def _check(r, k, v, logw, u, u_shapes) -> torch.device:
    """Validate the common contract (``u`` of one of ``u_shapes``); returns
    the inputs' device."""
    shape = r.shape
    for name, x in (("k", k), ("v", v), ("logw", logw)):
        if x.shape != shape:
            raise ValueError(f"wkv6: {name} has shape {tuple(x.shape)}, r "
                             f"{tuple(shape)}")
    if u.shape not in u_shapes:
        raise ValueError(f"wkv6: u has shape {tuple(u.shape)}, want "
                         + " or ".join(str(tuple(x)) for x in u_shapes))
    devs = {x.device for x in (r, k, v, logw, u)}
    if len(devs) != 1:
        raise ValueError(f"wkv6: inputs on several devices {devs}")
    if r.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"wkv6 takes fp32 or bf16 r/k/v, got {r.dtype}")
    if k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError(f"wkv6: r, k, v must share a dtype, got {r.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if logw.dtype != torch.float32 or u.dtype != torch.float32:
        raise ValueError(f"wkv6 takes fp32 logw and u, got {logw.dtype}, "
                         f"{u.dtype}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"wkv6: unsupported device {dev}")
    return dev


def _launch(r, k, v, logw, u, B: int, H: int, sb: int, sh: int, st: int,
            sub: int, suh: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One kernel launch over B*H rows addressed by (sb, sh, st); row b*H +
    h's bonus is ``u``'s row at b*sub + h*suh elements (unit stride), read
    where it lies: a bonus shared by rows is not copied out to each."""
    T, D = r.shape[-2], r.shape[-1]
    if not 1 <= D <= MAX_D:
        raise ValueError(f"wkv6 kernel takes 1 <= D <= {MAX_D}, got {D}")
    strides = r.stride()
    for name, x in (("k", k), ("v", v), ("logw", logw)):
        if x.stride() != strides:
            raise ValueError(f"wkv6: {name} has strides {x.stride()}, r "
                             f"{strides}; pass one layout")
    if strides[-1] != 1:
        raise ValueError(f"wkv6 needs a unit stride on the last axis, got "
                         f"strides {strides}")
    if u.stride(-1) != 1:
        raise ValueError(f"wkv6 needs u with a unit stride on its last axis, "
                         f"got strides {u.stride()}")
    o = torch.empty_strided(r.shape, strides, dtype=r.dtype, device=r.device)
    state = torch.empty((B * H, D, D), dtype=torch.float32, device=r.device)
    vec = _aligned((r, k, v, logw, o), (sb, sh, st), D)
    launch = _lib()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = launch(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                        logw.data_ptr(), u.data_ptr(), B, H, T, D, sb, sh,
                        st, sub, suh, int(r.dtype == torch.bfloat16),
                        int(vec), o.data_ptr(), state.data_ptr(), stream)
    _build.check(status, "wkv6")
    _build.count_launch("wkv6")
    return o, state


def _bwd_lib():
    lib = _build.load("wkv6_bwd")
    fn = lib.wkv6_bwd_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                       + [ctypes.c_longlong] * 5 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
        lib.wkv6_bwd_workspace.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.wkv6_bwd_workspace.restype = ctypes.c_longlong
    return lib


def _launch_bwd(r, k, v, logw, u, do, dstate, B: int, H: int, sb: int,
                sh: int, st: int, sub: int, suh: int, du_groups: int,
                du_shape) -> Tuple[torch.Tensor, ...]:
    """One backward launch over the B*H rows of :func:`_launch`, and the
    fixed-order sum of each row's ``du`` into ``du_shape``: row b*H + h adds
    to group (b*H + h) % du_groups.  ``do`` and the gradients share r's
    layout; ``dstate`` is (B*H, D, D) fp32 or None."""
    T, D = r.shape[-2], r.shape[-1]
    strides = r.stride()
    if do.stride() != strides or do.dtype != r.dtype:
        do = torch.empty_strided(r.shape, strides, dtype=r.dtype,
                                 device=r.device).copy_(do)
    if dstate is not None:
        dstate = dstate.to(torch.float32).reshape(B * H, D, D).contiguous()
    grads = [torch.empty_strided(r.shape, strides, dtype=dt, device=r.device)
             for dt in (r.dtype, r.dtype, r.dtype, torch.float32)]
    du = torch.empty(du_shape, dtype=torch.float32, device=r.device)
    if T == 0 or B * H == 0:
        for g in grads:
            g.zero_()
        return (*grads, du.zero_())
    lib = _bwd_lib()
    # the chunk-start states, the state's gradient at each chunk's end,
    # each chunk's du and decay
    ws = torch.empty(B * H * lib.wkv6_bwd_workspace(T, D),
                     dtype=torch.float32, device=r.device)
    dr, dk, dv, dlogw = grads
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.wkv6_bwd_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
            u.data_ptr(), do.data_ptr(),
            None if dstate is None else dstate.data_ptr(), B, H, T, D, sb,
            sh, st, sub, suh, int(r.dtype == torch.bfloat16), dr.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), dlogw.data_ptr(), du.data_ptr(),
            B * H // du_groups, du_groups, ws.data_ptr(), stream)
    _build.check(status, "wkv6_bwd")
    _build.count_launch("wkv6_bwd")
    return dr, dk, dv, dlogw, du


def _fold(x: torch.Tensor) -> torch.Tensor:
    """(B, H, T, D) -> (B*H, T, D)."""
    return x.reshape(-1, *x.shape[-2:])


def _forward(r, k, v, logw, u, heads: bool):
    """The forward of :func:`wkv6` (``heads`` False) or :func:`wkv6_heads`
    on checked inputs: the kernel on the card, the plain version on the
    CPU."""
    if heads:
        B, H, T, D = r.shape
        if r.device.type == "cpu":
            o, s = wkv6_ref(_fold(r), _fold(k), _fold(v), _fold(logw),
                            u[None].expand(B, H, D).reshape(B * H, D))
            return o.reshape(B, H, T, D), s.reshape(B, H, D, D)
        u = u if u.stride(-1) == 1 else u.contiguous()
        sb, sh, st, _ = r.stride()
        o, s = _launch(r, k, v, logw, u, B, H, sb, sh, st, 0, u.stride(0))
        return o, s.reshape(B, H, D, D)
    if r.device.type == "cpu":
        return wkv6_ref(r, k, v, logw, u)
    BH = r.shape[0]
    u = u if u.stride(-1) == 1 else u.contiguous()
    sub = u.stride(0) if u.ndim == 2 else 0
    return _launch(r, k, v, logw, u, BH, 1, r.stride(0), 0, r.stride(1), sub,
                   0)


def _backward(r, k, v, logw, u, do, dstate, heads: bool):
    """The gradients of :func:`_forward` as ``(dr, dk, dv, dlogw, du)``, in
    the inputs' dtypes and shapes (``du`` fp32): the backward kernel on the
    card, its plain version on the CPU."""
    if heads:
        B, H, T, D = r.shape
        if r.device.type == "cpu":
            ds = None if dstate is None else dstate.reshape(B * H, D, D)
            dr, dk, dv, dlogw, du = wkv6_bwd_ref(
                _fold(r), _fold(k), _fold(v), _fold(logw),
                u[None].expand(B, H, D).reshape(B * H, D), _fold(do), ds)
            return (dr.reshape(r.shape), dk.reshape(r.shape),
                    dv.reshape(r.shape), dlogw.reshape(r.shape),
                    du.reshape(B, H, D).sum(0))
        u = u if u.stride(-1) == 1 else u.contiguous()
        sb, sh, st, _ = r.stride()
        return _launch_bwd(r, k, v, logw, u, do, dstate, B, H, sb, sh, st,
                           0, u.stride(0), H, (H, D))
    if r.device.type == "cpu":
        return wkv6_bwd_ref(r, k, v, logw, u, do, dstate)
    BH, _, D = r.shape
    u = u if u.stride(-1) == 1 else u.contiguous()
    sub = u.stride(0) if u.ndim == 2 else 0
    return _launch_bwd(r, k, v, logw, u, do, dstate, BH, 1, r.stride(0), 0,
                       r.stride(1), sub, 0, BH if u.ndim == 2 else 1,
                       tuple(u.shape))


class WKV6Function(torch.autograd.Function):
    """WKV6 with a gradient: forward :func:`_forward`, backward
    :func:`_backward` (the backward kernel on the card).  ``heads`` picks
    :func:`wkv6_heads`' form over :func:`wkv6`'s.  A gradient that no
    output received (the final state's, in training) is taken as 0."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, heads: bool):
        ctx.set_materialize_grads(False)
        ctx.heads = heads
        ctx.save_for_backward(r, k, v, logw, u)
        return _forward(r, k, v, logw, u, heads)

    @staticmethod
    def backward(ctx, do, dstate):
        r, k, v, logw, u = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(r)
        dr, dk, dv, dlogw, du = _backward(r, k, v, logw, u, do, dstate,
                                          ctx.heads)
        return dr, dk, dv, dlogw, du, None


def _needs_grad(*xs) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         logw: torch.Tensor, u: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """WKV6 over (BH, T, D) rows -> ``(o (BH, T, D), state (BH, D, D))``;
    ``u`` is one bonus row per row (BH, D) or one for all (D,)."""
    if r.ndim != 3:
        raise ValueError(f"wkv6 wants (BH, T, D), got {tuple(r.shape)}")
    BH, T, D = r.shape
    _check(r, k, v, logw, u, ((D,), (BH, D)))
    if _needs_grad(r, k, v, logw, u):
        return WKV6Function.apply(r, k, v, logw, u, False)
    return _forward(r, k, v, logw, u, False)


def wkv6_heads(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               logw: torch.Tensor, u: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """WKV6 over (B, H, T, D) with a bonus row per head ``u (H, D)`` ->
    ``(o (B, H, T, D), state (B, H, D, D))``, all heads in one launch."""
    if r.ndim != 4:
        raise ValueError(f"wkv6_heads wants (B, H, T, D), got "
                         f"{tuple(r.shape)}")
    B, H, T, D = r.shape
    if u.shape != (H, D):
        raise ValueError(f"wkv6_heads: u has shape {tuple(u.shape)}, want "
                         f"({H}, {D})")
    _check(r, k, v, logw, u, ((H, D),))
    if _needs_grad(r, k, v, logw, u):
        return WKV6Function.apply(r, k, v, logw, u, True)
    return _forward(r, k, v, logw, u, True)
