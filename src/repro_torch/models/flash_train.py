"""Memory-optimal training attention in plain tensor code: the chunked
online softmax with a hand-written backward.

Counterpart of ``repro.models.flash_jnp``: :func:`flash_mha` is a
``torch.autograd.Function`` over query and key chunks whose residuals are
only (q, k, v, o, lse), and whose backward recomputes ``P = exp(S -
lse)`` a pair of chunks at a time with
:func:`repro_torch.kernels.flash_attention.ref.attention_bwd_f32`, the
formulas of the flash-attention backward kernel's plain version, so the
two cannot drift apart.  GQA layout: q (B, K, g, S, hd), k and v (B, K, T,
hd); :func:`flash_attention_train` takes the model's (B, S, H, hd) x (B,
T, K, hd).  It is the CPU oracle that the tests hold against the
reference's ``jax.vjp``; no path of the port runs it on the card, where
:func:`repro_torch.kernels.flash_attention.ops.flash_attention` computes
the same function on the kernels.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ref import attention_bwd_f32

NEG_INF = -1e30


def _blk_mask(qi: int, ki: int, q_chunk: int, k_chunk: int, causal: bool,
              window: int, device=None) -> torch.Tensor:
    qpos = qi * q_chunk + torch.arange(q_chunk, device=device)[:, None]
    kpos = ki * k_chunk + torch.arange(k_chunk, device=device)[None, :]
    m = torch.ones((q_chunk, k_chunk), dtype=torch.bool, device=device)
    if causal:
        m &= qpos >= kpos
    if window:
        m &= (qpos - kpos) < window
    return m


def _flash_fwd_impl(q, k, v, causal: bool, window: int, q_chunk: int,
                    k_chunk: int):
    """``(o, lse)``: o (B, K, g, S, hd) in q's dtype, lse (B, K, g, S)
    fp32."""
    B, K, g, S, hd = q.shape
    T = k.shape[2]
    scale = 1.0 / (hd ** 0.5)
    o = torch.empty_like(q)
    lse = torch.empty((B, K, g, S), dtype=torch.float32, device=q.device)
    for qi in range(S // q_chunk):
        rows = slice(qi * q_chunk, (qi + 1) * q_chunk)
        qc = q[:, :, :, rows]
        m = torch.full((B, K, g, q_chunk), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, K, g, q_chunk, hd), dtype=torch.float32,
                          device=q.device)
        for ki in range(T // k_chunk):
            cols = slice(ki * k_chunk, (ki + 1) * k_chunk)
            kc, vc = k[:, :, cols], v[:, :, cols]
            s = torch.einsum("bkgqh,bkth->bkgqt", qc, kc).float() * scale
            msk = _blk_mask(qi, ki, q_chunk, k_chunk, causal, window,
                            q.device)
            s = torch.where(msk, s, NEG_INF)
            mn = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - mn[..., None])
            alpha = torch.exp(m - mn)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqt,bkth->bkgqh", p.to(vc.dtype), vc).float()
            m = mn
        lse[:, :, :, rows] = m + torch.log(l.clamp_min(1e-30))
        o[:, :, :, rows] = (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)
    return o, lse


def _flash_bwd(causal: bool, window: int, q_chunk: int, k_chunk: int,
               q, k, v, o, lse, do):
    B, K, g, S, hd = q.shape
    T = k.shape[2]
    H = K * g
    dq = torch.zeros((B, K, g, S, hd), dtype=torch.float32, device=q.device)
    dk = torch.zeros((B, K, T, hd), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)

    def heads(x):                      # (B, K, g, n, hd) -> (B, H, n, hd)
        return x.reshape(B, H, *x.shape[3:])
    for qi in range(S // q_chunk):
        rows = slice(qi * q_chunk, (qi + 1) * q_chunk)
        for ki in range(T // k_chunk):
            cols = slice(ki * k_chunk, (ki + 1) * k_chunk)
            msk = _blk_mask(qi, ki, q_chunk, k_chunk, causal, window,
                            q.device)
            dq_c, dk_c, dv_c = attention_bwd_f32(
                heads(q[:, :, :, rows]), k[:, :, cols], v[:, :, cols],
                heads(o[:, :, :, rows]), lse[:, :, :, rows].reshape(B, H, -1),
                heads(do[:, :, :, rows]), msk)
            dq[:, :, :, rows] += dq_c.view(B, K, g, q_chunk, hd)
            dk[:, :, cols] += dk_c
            dv[:, :, cols] += dv_c
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashMHA(torch.autograd.Function):
    """The reference's ``flash_mha`` custom VJP: forward
    :func:`_flash_fwd_impl`, backward :func:`_flash_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, q_chunk: int,
                k_chunk: int):
        o, lse = _flash_fwd_impl(q, k, v, causal, window, q_chunk, k_chunk)
        ctx.cfg = (causal, window, q_chunk, k_chunk)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        return (*_flash_bwd(*ctx.cfg, *ctx.saved_tensors, do),
                None, None, None, None)


def flash_mha(q, k, v, causal: bool, window: int, q_chunk: int,
              k_chunk: int) -> torch.Tensor:
    """q (B, K, g, S, hd), k and v (B, K, T, hd) -> o (B, K, g, S, hd);
    S and T multiples of their chunks."""
    return FlashMHA.apply(q, k, v, causal, window, q_chunk, k_chunk)


def flash_attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, window: int = 0,
                          q_chunk: int = 512, k_chunk: int = 1024
                          ) -> torch.Tensor:
    """(B, S, H, hd) x (B, T, K, hd) -> (B, S, H, hd), GQA as
    :func:`repro_torch.models.attention.dense_attention`."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    g = H // K
    q_chunk = min(q_chunk, S)
    k_chunk = min(k_chunk, T)
    if S % q_chunk or T % k_chunk:
        raise ValueError(f"flash_attention_train: chunks ({q_chunk}, "
                         f"{k_chunk}) do not divide (S, T) = ({S}, {T})")
    qr = q.reshape(B, S, K, g, hd).permute(0, 2, 3, 1, 4)
    o = flash_mha(qr, k.transpose(1, 2), v.transpose(1, 2), causal, window,
                  q_chunk, k_chunk)
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd)
