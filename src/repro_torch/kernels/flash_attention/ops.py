"""Dispatch for the flash-attention kernels: the forward and its backward.

:func:`flash_attention` runs the CUDA kernel (``csrc/flash_attn.cu``) on
CUDA tensors and the plain version
(:func:`repro_torch.kernels.flash_attention.ref.attention_ref`) on CPU
tensors; a build or launch failure raises, and so do what the kernel
cannot run: another head width than 16, 32, 64 or 128, mixed devices or
dtypes, and misaligned strides.  When grad mode is on and an input needs
a gradient, it goes through :class:`FlashAttentionFunction`: the forward
kernel then also writes each row's log-sum-exp, and the backward is the
backward kernels (``csrc/flash_attn_bwd.cu``, one call counted as
``flash_attention_bwd``; bf16: ``delta = rowsum(do * o)`` and the rows'
base-2 lse, a dk/dv kernel over chunks of each group's query heads, the
chunks' fp32 partials summed in chunk order, a dq kernel, all on ``wgmma``
and TMA; deterministic, no atomics), with the plain versions
(:func:`~repro_torch.kernels.flash_attention.ref.attention_lse_ref`,
:func:`~repro_torch.kernels.flash_attention.ref.flash_attention_bwd_ref`)
on CPU tensors.

The kernel replaces the reference's ``flash_attention/kernel.py::
flash_kernel``; the tensor cores bound it (4 d operations a causal pair:
68.8 GFLOP, 0.0696 ms on the H100, at the GLM-4 prefill).  bf16 inputs go
to a persistent, warp-specialised Hopper kernel, one CTA an SM walking
(b, h, 128-row query tile) items, largest causal tiles first: a producer
warp streams each item's Q and the K and V tiles of 128 keys by TMA
through an mbarrier ring that runs on across items, and two
consumer warpgroups of 64 query rows each run both products on ``wgmma``
(S = Q K^T from shared memory; O += P V with P in registers and V read
as it lies), the online softmax in base 2 between them, masks only on the
tiles that cross the diagonal or Tk, and a TMA store of o.  fp32 inputs
take a loop on the CUDA cores (the bf16 tensor cores would break the fp32
contract); fp32 training runs it.  Both take a sliding ``window`` with
``causal`` (Hymba's 4,096): a query tile visits only the key tiles its
rows' windows reach, and the tiles that cross a window's lower edge are
masked as the diagonal's; the backward has none yet, so a window in grad
mode raises (ROADMAP A.11 step 2b).

q (B, Hq, Tq, d), k and v (B, Hkv, Tk, d), fp32 or bf16, are read through
their strides (TMA tensor maps over (d, T, H, B)): the (B, H, T, d) views
of a model's (B, T, H, d) projections go in as they lie, with no copy.
Each needs a unit stride on d, its other strides in whole 16-byte steps
and a 16-byte aligned base (TMA's and the fp32 kernel's 16-byte loads).
The output is (B, Hq, Tq, d) in q's dtype, a view of a (B, Tq, Hq, d)
tensor, which a model's output projection reads as it lies; so are the
gradients of q, k and v.  The output's gradient is read through its
strides too, and copied once where they do not meet the same rules.  The
reference wrapper's ``bq``, ``bk`` and ``interpret`` are TPU tiling
choices and not part of this signature.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import (attention_lse_ref,
                                                     attention_ref,
                                                     flash_attention_bwd_ref)

#: Head widths the kernel is built for.
WIDTHS = (16, 32, 64, 128)


def _lib():
    fn = _build.load("flash_attention").flash_attn_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def kernel_config(d: int) -> dict:
    """The bf16 kernel's shape at head width ``d`` (for reports): dynamic
    shared memory, threads a CTA, producer and consumer registers a thread,
    query rows a CTA, keys a tile and ring stages.  Needs the built
    library."""
    fn = _build.load("flash_attention").flash_attn_config
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    info = (ctypes.c_int * 7)()
    _build.check(fn(d, info), "flash_attention")
    return dict(zip(("smem_bytes", "threads", "producer_regs",
                     "consumer_regs", "rows", "keys", "stages"), info))


def _check(q, k, v) -> None:
    if not (q.ndim == k.ndim == v.ndim == 4):
        raise ValueError(f"flash_attention wants (B, H, T, d) tensors, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Hq, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != d:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    Hkv, Tk = k.shape[1], k.shape[2]
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"flash_attention: {Hq} query heads are no "
                         f"multiple of {Hkv} KV heads")
    if Tk < 1:
        raise ValueError("flash_attention needs at least one key")
    if d not in WIDTHS:
        raise ValueError(f"flash_attention kernel takes head width d in "
                         f"{WIDTHS}, got {d}")
    devs = {x.device for x in (q, k, v)}
    if len(devs) != 1:
        raise ValueError(f"flash_attention: inputs on several devices "
                         f"{devs}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention takes fp32 or bf16, got "
                         f"{q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q, k, v must share a dtype, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if devs.pop().type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not _kernel_strides(x):
            raise ValueError(
                f"flash_attention: {name} has strides {x.stride()}; the "
                f"kernel needs a unit stride on d and the others in "
                f"multiples of {16 // x.element_size()} elements (16 bytes)")


def _kernel_strides(x: torch.Tensor) -> bool:
    """A unit stride on d and the others in whole 16-byte steps."""
    step = 16 // x.element_size()
    return x.stride(3) == 1 and not any(s % step for s in x.stride()[:3])


def _bthd(B: int, H: int, T: int, d: int, like: torch.Tensor
          ) -> torch.Tensor:
    """An uninitialised (B, H, T, d) view of a (B, T, H, d) tensor."""
    return torch.empty((B, T, H, d), dtype=like.dtype,
                       device=like.device).transpose(1, 2)


def _forward(q, k, v, causal: bool, with_lse: bool, window: int = 0
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(o, lse or None)`` on checked inputs: the kernel on the card, the
    plain version on the CPU."""
    if q.device.type == "cpu":
        if with_lse:
            return attention_lse_ref(q, k, v, causal, window)
        return attention_ref(q, k, v, causal, window), None
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} is not 16-byte "
                             f"aligned")
    B, Hq, Tq, d = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    o = _bthd(B, Hq, Tq, d, q)
    lse = (torch.empty((B, Hq, Tq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    launch = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        o.data_ptr(), None if lse is None else lse.data_ptr(),
                        B, Hq, Hkv, Tq, Tk, d,
                        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                        *o.stride()[:3], int(causal), window,
                        int(q.dtype == torch.bfloat16), stream)
    _build.check(status, "flash_attention")
    _build.count_launch("flash_attention")
    return o, lse


def _bwd_lib():
    lib = _build.load("flash_attention_bwd")
    fn = lib.flash_attn_bwd_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                       + [ctypes.POINTER(ctypes.c_longlong)]
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.flash_attn_bwd_workspace.argtypes = [ctypes.c_int] * 7
        lib.flash_attn_bwd_workspace.restype = ctypes.c_longlong
    return lib


def bwd_kernel_config(d: int) -> dict:
    """The bf16 backward kernels' shape at head width ``d`` (for reports):
    dynamic shared memory of the dk/dv and the dq kernel, threads a CTA,
    producer and consumer registers a thread, keys a dk/dv CTA, queries a
    dq CTA and ring stages.  Needs the built library."""
    fn = _build.load("flash_attention_bwd").flash_attn_bwd_config
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    info = (ctypes.c_int * 8)()
    _build.check(fn(d, info), "flash_attention_bwd")
    return dict(zip(("dkdv_smem_bytes", "dq_smem_bytes", "threads",
                     "producer_regs", "consumer_regs", "keys", "rows",
                     "stages"), info))


def _backward(q, k, v, o, lse, do, causal: bool
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` from the forward's ``o`` and ``lse`` and the
    output's gradient ``do``: the backward kernels on the card (one call),
    the plain version on the CPU."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, lse, do, causal)
    if (do.dtype != q.dtype or not _kernel_strides(do)
            or do.data_ptr() % 16):
        # the kernel reads do as it reads q; autograd may hand it over in
        # another layout (or dtype): one copy
        do = _bthd(*q.shape, q).copy_(do)
    B, Hq, Tq, d = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    dq, dk, dv = (_bthd(B, Hq, Tq, d, q), _bthd(B, Hkv, Tk, d, k),
                  _bthd(B, Hkv, Tk, d, v))
    lse = lse.contiguous()
    strides = (ctypes.c_longlong * 24)(*[
        s for x in (q, k, v, o, do, dq, dk, dv) for s in x.stride()[:3]])
    lib = _bwd_lib()
    bf16 = int(q.dtype == torch.bfloat16)
    with torch.cuda.device(q.device):
        # the workspace: delta and lse rows, and the dk/dv partials where
        # a group's query heads are split (by the card's SM count)
        nbytes = lib.flash_attn_bwd_workspace(B, Hq, Hkv, Tq, Tk, d, bf16)
        if nbytes < 0:
            raise ValueError("flash_attention_bwd: arguments out of range")
        ws = torch.empty(max(nbytes, 1), dtype=torch.uint8, device=q.device)
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.flash_attn_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), ws.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, Hq, Hkv, Tq, Tk, d, strides,
            int(causal), bf16, stream)
    _build.check(status, "flash_attention_bwd")
    _build.count_launch("flash_attention_bwd")
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention with a gradient: the forward kernel with the rows'
    log-sum-exp (saved with q, k, v and o), the backward kernel; their
    plain versions on CPU tensors.  Under non-reentrant checkpointing the
    forward runs again in the backward, and the recomputed ``o`` and
    ``lse`` are the ones the backward reads."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        o, lse = _forward(q, k, v, causal, True)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return (*_backward(q, k, v, o, lse, do, ctx.causal), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Softmax attention over (B, H, T, d); k and v may have fewer heads
    (GQA, KV head ``h // (Hq // Hkv)``).  ``window`` (causal only; 0: none)
    keeps the keys ``i - window < j <= i``.  Returns (B, Hq, Tq, d)."""
    _check(q, k, v)
    window = int(window)
    if window < 0:
        raise ValueError(f"flash_attention: window must be >= 0, got "
                         f"{window}")
    if window and not causal:
        raise ValueError("flash_attention: a sliding window needs causal")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        if window:
            raise NotImplementedError(
                "flash_attention: the backward kernel has no sliding window "
                "yet (ROADMAP A.11 step 2b, Hymba training)")
        return FlashAttentionFunction.apply(q, k, v, causal)
    return _forward(q, k, v, causal, False, window)[0]
