"""GQA attention: training and prefill through the flash-attention kernels,
cached decode.

Counterpart of ``repro.models.attention``.  Parameters keep the
reference's names, layouts and init (``wq (d, H, hd)``, ``wk``/``wv (d,
K, hd)``, ``wo (H, hd, d)`` times 1/sqrt(2L), zero ``bq``/``bk``/``bv``
under ``qkv_bias``).  The reference's three implementations of the same
function are here as plain tensor code: :func:`dense_attention` (the (S,
T) scores at once), :func:`chunked_attention` (the two-level online
softmax) and, in :mod:`repro_torch.models.flash_train`, ``flash_jnp``'s
custom VJP.  Where the reference's ``attention_ctx`` picks one of them by
size (dense up to S T = 2**22, else flash when power-of-two chunks divide
S and T, else chunked), the port's sends every size through
:func:`repro_torch.kernels.flash_attention.ops.flash_attention`: the CUDA
kernels on the card (the forward and, in grad mode, its hand-written
backward), their plain versions on the CPU; the function is the same, the
sums run in another order.  The sliding window (``cfg.sliding_window``,
Hymba's) goes to the forward kernel, which, unlike the reference's Pallas
kernel, has one (the reference runs windowed attention in jnp); the
backward kernel has none yet, so a window in grad mode raises (ROADMAP
A.11 step 2b).  Decode attends one token over the KV cache in tensor
code, as the reference's ``decode_attention`` (jnp there, no kernel);
under a window the cache is the reference's ring of ``min(max_len,
window)`` slots, position p at slot ``p % L``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.common import apply_rope, dense_init, draw_device

NEG_INF = -1e30


def init_attention(cfg, generator: Optional[torch.Generator], dtype,
                   device=None) -> nn.ParameterDict:
    d, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    dev = draw_device(generator, device)
    p = {"wq": dense_init(generator, (d, H, hd), 0, dtype, dev),
         "wk": dense_init(generator, (d, K, hd), 0, dtype, dev),
         "wv": dense_init(generator, (d, K, hd), 0, dtype, dev),
         "wo": dense_init(generator, (H, hd, d), 0, dtype, dev)
         / (2 * cfg.num_layers) ** 0.5}
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H, hd), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((K, hd), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((K, hd), dtype=dtype, device=dev)
    return nn.ParameterDict({k: nn.Parameter(v) for k, v in p.items()})


def compute_qkv(params, x: torch.Tensor, cfg, positions: torch.Tensor,
                parts: str = "qkv"
                ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor],
                           Optional[torch.Tensor]]:
    """x (B, S, d) -> q (B, S, H, hd), k, v (B, S, K, hd), RoPE applied at
    ``positions`` (S,) over the sequence axis.  ``parts`` ``"q"`` or
    ``"kv"`` projects only those (the others come back None): a
    cross-attention's q from the decoder and its k and v from the encoder,
    where the reference projects all three of each and drops the rest."""
    B, S, d = x.shape

    def proj(name):                   # einsum("bsd,dhk->bshk") as one GEMM
        if name not in parts:
            return None
        w = params["w" + name]
        y = (x @ w.reshape(d, -1)).view(B, S, w.shape[1], w.shape[2])
        if cfg.qkv_bias:
            y = y + params["b" + name]
        if cfg.use_rope and name != "v":
            y = apply_rope(y.transpose(1, 2), positions, cfg.rope_theta
                           ).transpose(1, 2)
        return y
    return proj("q"), proj("k"), proj("v")


def project_out(params, ctx: torch.Tensor) -> torch.Tensor:
    """ctx (B, S, H, hd) -> (B, S, d): einsum("bshk,hkd->bsd")."""
    B, S = ctx.shape[:2]
    wo = params["wo"]
    return ctx.reshape(B, S, -1) @ wo.reshape(-1, wo.shape[-1])


def _mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
          window: int) -> torch.Tensor:
    m = torch.ones(torch.broadcast_shapes(qpos.shape, kpos.shape),
                   dtype=torch.bool, device=qpos.device)
    if causal:
        m &= qpos >= kpos
    if window:
        m &= (qpos - kpos) < window
    return m


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg,
                    causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """(B, S, H, hd) x (B, T, K, hd) -> (B, S, H, hd), the (S, T) scores
    at once (the reference's small-S path)."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    g = H // K
    qr = q.reshape(B, S, K, g, hd)
    s = torch.einsum("bskgh,btkh->bkgst", qr, k) / (hd ** 0.5)
    qpos = torch.arange(S, device=q.device)[:, None] + q_offset
    kpos = torch.arange(T, device=q.device)[None, :]
    s = torch.where(_mask(qpos, kpos, causal, cfg.sliding_window), s,
                    NEG_INF)
    p = torch.softmax(s.float(), -1).to(q.dtype)
    ctx = torch.einsum("bkgst,btkh->bskgh", p, v)
    return ctx.reshape(B, S, H, hd)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      cfg, causal: bool = True, q_chunk: int = 512,
                      k_chunk: int = 1024) -> torch.Tensor:
    """The flash-style two-level loop: never the whole (S, T) scores."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    g = H // K
    q_chunk = min(q_chunk, S)
    k_chunk = min(k_chunk, T)
    if S % q_chunk or T % k_chunk:
        raise ValueError(f"chunked_attention: chunks ({q_chunk}, "
                         f"{k_chunk}) do not divide (S, T) = ({S}, {T})")
    scale = 1.0 / (hd ** 0.5)
    dev = q.device
    out = torch.empty_like(q)
    for qi in range(S // q_chunk):
        rows = slice(qi * q_chunk, (qi + 1) * q_chunk)
        qc = q[:, rows].reshape(B, q_chunk, K, g, hd).permute(0, 2, 3, 1, 4)
        m = torch.full((B, K, g, q_chunk), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, K, g, q_chunk, hd), dtype=torch.float32,
                          device=dev)
        qpos = qi * q_chunk + torch.arange(q_chunk, device=dev)[:, None]
        for ki in range(T // k_chunk):
            cols = slice(ki * k_chunk, (ki + 1) * k_chunk)
            kc, vc = k[:, cols].transpose(1, 2), v[:, cols].transpose(1, 2)
            s = torch.einsum("bkgqh,bkth->bkgqt", qc, kc).float() * scale
            kpos = ki * k_chunk + torch.arange(k_chunk, device=dev)[None, :]
            s = torch.where(_mask(qpos, kpos, causal, cfg.sliding_window), s,
                            NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqt,bkth->bkgqh", p.to(qc.dtype), vc).float()
            m = m_new
        o = (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)
        out[:, rows] = o.permute(0, 3, 1, 2, 4).reshape(B, q_chunk, H, hd)
    return out


def _pick_chunk(n: int, target: int, floor: int = 64) -> int:
    """Largest power-of-two divisor of n that is <= target (>= floor)."""
    c = target
    while c >= floor:
        if n % c == 0:
            return c
        c //= 2
    return 0


def attention_ctx(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg,
                  causal: bool = True) -> torch.Tensor:
    """(B, S, H, hd) x (B, T, K, hd) -> (B, S, H, hd), every size through
    the flash-attention kernels (their plain versions on the CPU), with
    ``cfg.sliding_window`` when causal (the one model with a window,
    Hymba, attends causally); in grad mode the backward is the
    hand-written one."""
    ctx = flash_ops.flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal,
        window=cfg.sliding_window if causal else 0)
    return ctx.transpose(1, 2)


# ---------------------------------------------------------------------------
# Decode with KV cache.
# ---------------------------------------------------------------------------

# Under ``cfg.sliding_window`` the caches are the reference's ring buffers:
# ``init_cache`` makes ``min(max_len, window)`` slots, ``cache_update``
# writes position p at slot ``p % L`` and ``decode_attention`` reads the
# slots ``< min(pos + 1, L)``; prefill caches are rolled to the same slots
# (``transformer._cache_from_prefill``).

def init_cache(cfg, batch: int, max_len: int, dtype, device=None) -> Dict:
    """Per-layer KV cache: k and v (B, L, K, hd), L = max_len, or
    ``min(max_len, window)`` under a sliding window (a ring)."""
    K, hd = cfg.num_kv_heads, cfg.hd
    L = (min(max_len, cfg.sliding_window) if cfg.sliding_window
         else max_len)
    return {"k": torch.zeros((batch, L, K, hd), dtype=dtype, device=device),
            "v": torch.zeros((batch, L, K, hd), dtype=dtype, device=device)}


def cache_update(cache: Dict, k_new: torch.Tensor, v_new: torch.Tensor,
                 pos: int, cfg=None) -> Dict:
    """Insert one step (B, 1, K, hd) at absolute position ``pos`` (RoPE
    already applied there): at slot ``pos``, or ``pos % L`` under
    ``cfg.sliding_window`` (the ring).  Unlike the reference's functional
    update, the port writes the slot **in place** and returns the same
    dict: a decode step then copies two rows a layer, not the whole
    cache."""
    slot = (pos % cache["k"].shape[1]
            if cfg is not None and cfg.sliding_window else pos)
    cache["k"][:, slot] = k_new[:, 0]
    cache["v"][:, slot] = v_new[:, 0]
    return cache


def decode_partial(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                   valid: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Partial attention for one decode step over a cache: q (B, 1, H, hd),
    kc/vc (B, L, K, hd), valid (B, L) or (1, L) bool -> (acc (B, H, hd)
    fp32, denom (B, H) fp32, m (B, H) fp32)."""
    B, _, H, hd = q.shape
    K = kc.shape[2]
    g = H // K
    qr = q.reshape(B, K, g, hd)
    s = torch.einsum("bkgh,btkh->bkgt", qr, kc).float()
    s = s / (hd ** 0.5)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    denom = p.sum(-1)
    acc = torch.einsum("bkgt,btkh->bkgh", p.to(vc.dtype), vc).float()
    return acc.reshape(B, H, hd), denom.reshape(B, H), m.reshape(B, H)


def decode_attention(q: torch.Tensor, cache: Dict, pos: int, cfg=None
                     ) -> torch.Tensor:
    """Single-step decode attention over the cache slots ``<= pos``, or
    under ``cfg.sliding_window`` the ring's slots ``< min(pos + 1, L)``:
    (B, 1, H, hd)."""
    L = cache["k"].shape[1]
    idx = torch.arange(L, device=q.device)[None, :]
    valid = (idx < min(pos + 1, L)
             if cfg is not None and cfg.sliding_window else idx <= pos)
    acc, denom, _ = decode_partial(q, cache["k"], cache["v"], valid)
    out = acc / denom.clamp_min(1e-30)[..., None]
    return out[:, None].to(q.dtype)
