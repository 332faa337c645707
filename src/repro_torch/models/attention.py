"""GQA attention: prefill through the flash-attention kernel, cached decode.

Counterpart of ``repro.models.attention``.  Parameters keep the
reference's names, layouts and init (``wq (d, H, hd)``, ``wk``/``wv (d,
K, hd)``, ``wo (H, hd, d)`` times 1/sqrt(2L), zero ``bq``/``bk``/``bv``
under ``qkv_bias``).  Every prefill's attention goes through
:func:`repro_torch.kernels.flash_attention.ops.flash_attention`: the CUDA
kernel on the card, its plain version on the CPU.  The reference picks
one of three implementations of the same function by size
(``dense_attention``, ``flash_jnp``'s custom VJP, ``chunked_attention``);
those, and the sliding window, which the kernel does not have, are not
ported (ROADMAP A.11).  Decode attends one token over the KV cache in
tensor code, as the reference's ``decode_attention`` (jnp there, no
kernel).
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


def compute_qkv(params, x: torch.Tensor, cfg, positions: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> q (B, S, H, hd), k, v (B, S, K, hd), RoPE applied at
    ``positions`` (S,) over the sequence axis."""
    B, S, d = x.shape

    def proj(w):                      # einsum("bsd,dhk->bshk") as one GEMM
        return (x @ w.reshape(d, -1)).view(B, S, w.shape[1], w.shape[2])
    q, k, v = proj(params["wq"]), proj(params["wk"]), proj(params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    if cfg.use_rope:
        q = apply_rope(q.transpose(1, 2), positions, cfg.rope_theta
                       ).transpose(1, 2)
        k = apply_rope(k.transpose(1, 2), positions, cfg.rope_theta
                       ).transpose(1, 2)
    return q, k, v


def project_out(params, ctx: torch.Tensor) -> torch.Tensor:
    """ctx (B, S, H, hd) -> (B, S, d): einsum("bshk,hkd->bsd")."""
    B, S = ctx.shape[:2]
    wo = params["wo"]
    return ctx.reshape(B, S, -1) @ wo.reshape(-1, wo.shape[-1])


def attention_ctx(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg,
                  causal: bool = True) -> torch.Tensor:
    """(B, S, H, hd) x (B, T, K, hd) -> (B, S, H, hd), every size through
    the flash-attention kernel (its plain version on the CPU)."""
    if cfg.sliding_window:
        raise NotImplementedError(
            f"{cfg.name}: sliding-window attention is not ported (ROADMAP "
            "A.11): the flash-attention kernel, like the reference's, has "
            "no window")
    ctx = flash_ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                    v.transpose(1, 2), causal)
    return ctx.transpose(1, 2)


# ---------------------------------------------------------------------------
# Decode with KV cache.
# ---------------------------------------------------------------------------

# The reference's sliding-window ring buffers (``init_cache``,
# ``cache_update`` and ``decode_attention`` under ``cfg.sliding_window``)
# wait with windowed prefill (ROADMAP A.11): ``transformer.require_ported``
# refuses windowed configs.

def init_cache(cfg, batch: int, max_len: int, dtype, device=None) -> Dict:
    """Per-layer KV cache: k and v (B, max_len, K, hd)."""
    K, hd = cfg.num_kv_heads, cfg.hd
    return {"k": torch.zeros((batch, max_len, K, hd), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, max_len, K, hd), dtype=dtype,
                             device=device)}


def cache_update(cache: Dict, k_new: torch.Tensor, v_new: torch.Tensor,
                 pos: int) -> Dict:
    """Insert one step (B, 1, K, hd) at absolute position ``pos`` (RoPE
    already applied there).  Unlike the reference's functional update, the
    port writes the slot **in place** and returns the same dict: a decode
    step then copies two rows a layer, not the whole cache."""
    cache["k"][:, pos] = k_new[:, 0]
    cache["v"][:, pos] = v_new[:, 0]
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


def decode_attention(q: torch.Tensor, cache: Dict, pos: int
                     ) -> torch.Tensor:
    """Single-step decode attention over the cache slots ``<= pos``:
    (B, 1, H, hd)."""
    L = cache["k"].shape[1]
    valid = torch.arange(L, device=q.device)[None, :] <= pos
    acc, denom, _ = decode_partial(q, cache["k"], cache["v"], valid)
    out = acc / denom.clamp_min(1e-30)[..., None]
    return out[:, None].to(q.dtype)
