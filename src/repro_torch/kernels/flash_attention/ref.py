"""Plain PyTorch versions of the flash-attention kernels: softmax
attention, its row log-sum-exp and its backward.

:func:`attention_ref` is the counterpart of ``repro.kernels.flash_attention.
ref.attention_ref``, with the contract of the reference's Pallas wrapper
(``repro.kernels.flash_attention.ops.flash_attention``) and of
``csrc/flash_attn.cu``:

- q (B, Hq, Tq, d); k and v (B, Hkv, Tk, d) with ``Hq % Hkv == 0``;
- GQA: query head h reads KV head ``h // (Hq // Hkv)``
  (``repeat_interleave``, as ``jnp.repeat``; ``repeat`` would give
  ``h % Hkv``);
- causal: key j is seen by query i when ``i >= j``, both counted from 0,
  also when Tq != Tk;
- ``window`` (with causal; 0: none): also only when ``i - j < window``, the
  reference's ``models/attention.py::_mask``; a row that sees no key (only
  where Tq > Tk + window - 1) gets o = 0 and lse ``NEG_INF``, the kernel's
  rule for such rows;
- scores, softmax and the weighted sum in fp32; the output in q's dtype.

:func:`attention_lse_ref` adds the fp32 row log-sum-exp of the scaled
scores, (B, Hq, Tq), in natural-log units: what the forward kernel writes
for the backward.  :func:`flash_attention_bwd_ref` is the backward of
``csrc/flash_attn_bwd.cu``: the reference's ``models/flash_jnp.py::
_flash_bwd`` formulas (``delta = rowsum(do * o)``, ``P = exp(S * scale -
lse)``, ``dS = P * (dP - delta) * scale``) over the whole sequence, in
fp32, ``dk`` and ``dv`` summed over the query heads of each KV head's
group.  A row whose ``lse`` is the finite ``NEG_INF`` of a row that saw no
key gets weights 0 (not ``exp`` of the rounding residual).
:func:`flash_attention_bwd_split_ref` sums dk and dv as the bf16 kernels
do: over chunks of each group's query heads, partials added in chunk
order.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

#: The reference's finite mask value (``flash_jnp.NEG_INF``).
NEG_INF = -1e30


def _causal_mask(Tq: int, Tk: int, device, window: int = 0
                 ) -> torch.Tensor:
    qi = torch.arange(Tq, device=device)[:, None]
    kj = torch.arange(Tk, device=device)[None, :]
    if window:
        return (qi >= kj) & (qi - kj < window)
    return qi >= kj


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool, window: int = 0
            ) -> torch.Tensor:
    """fp32 scaled scores (B, Hq, Tq, Tk), masked keys at -inf."""
    d, group = q.shape[3], q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(group, dim=1)
    s = torch.matmul(q.float(), kf.transpose(-1, -2)) / (d ** 0.5)
    if causal:
        s = s.masked_fill(~_causal_mask(q.shape[2], k.shape[2], q.device,
                                        window), float("-inf"))
    return s


def _unseen(q: torch.Tensor, k: torch.Tensor, window: int
            ) -> Optional[torch.Tensor]:
    """(Tq, 1) bool: the rows a window leaves without a key, or None."""
    if not window or q.shape[2] <= k.shape[2] + window - 1:
        return None
    return ~_causal_mask(q.shape[2], k.shape[2], q.device, window).any(
        -1, keepdim=True)


def _weighted(p: torch.Tensor, v: torch.Tensor, group: int) -> torch.Tensor:
    return torch.matmul(p, v.float().repeat_interleave(group, dim=1))


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            window: int):
    """(scores, rows a window leaves without a key or None, o)."""
    s = _scores(q, k, causal, window)
    p = torch.softmax(s, dim=-1)
    unseen = _unseen(q, k, window)
    if unseen is not None:        # softmax over no key: NaN -> weights 0
        p = p.masked_fill(unseen, 0.0)
    return s, unseen, _weighted(p, v, q.shape[1] // k.shape[1]).to(q.dtype)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    return _attend(q, k, v, causal, window)[2]


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, window: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)``: o as :func:`attention_ref`, lse (B, Hq, Tq) fp32."""
    s, unseen, o = _attend(q, k, v, causal, window)
    lse = torch.logsumexp(s, dim=-1)
    if unseen is not None:
        lse = lse.masked_fill(unseen[:, 0], NEG_INF)
    return o, lse


def attention_bwd_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                      mask: Optional[torch.Tensor]
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward's formulas in fp32 over one block of queries and keys:
    ``mask`` (Tq, Tk) bool (None: every key seen) in the block's own
    positions, ``lse`` the block's rows'.  Returns fp32 ``(dq, dk, dv)``,
    dk and dv summed over each KV head's group (B, Hkv, Tk, d)."""
    B, Hq, Tq, d = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale = 1.0 / (d ** 0.5)
    qf, dof = q.float(), do.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    delta = (dof * o.float()).sum(-1)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    lse = lse.float()[..., None]
    p = torch.exp(s - lse)
    seen = lse > NEG_INF / 2
    if mask is not None:
        seen = seen & mask
    p = torch.where(seen, p, torch.zeros((), device=p.device))
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    fold = (B, Hkv, group, Tk, d)
    return dq, dk.view(fold).sum(2), dv.view(fold).sum(2)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor,
                            causal: bool = True
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """``(dq, dk, dv)`` of softmax attention given the forward's ``o`` and
    ``lse`` and the output's gradient ``do`` (q's shape), each gradient in
    its input's dtype."""
    mask = (_causal_mask(q.shape[2], k.shape[2], q.device) if causal
            else None)
    dq, dk, dv = attention_bwd_f32(q, k, v, o, lse, do, mask)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_split_ref(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, o: torch.Tensor,
                                  lse: torch.Tensor, do: torch.Tensor,
                                  causal: bool = True, heads: int = 1
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """:func:`flash_attention_bwd_ref` as the bf16 kernels split it: each
    KV head's group of query heads in chunks of ``heads`` (the last one
    shorter), dk and dv the fp32 partials of the chunks added in chunk
    order, then rounded once to the inputs' dtype."""
    B, Hq, Tq, d = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    group = Hq // Hkv
    mask = _causal_mask(Tq, Tk, q.device) if causal else None
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    for h0 in range(0, group, heads):
        sel = [hk * group + h for hk in range(Hkv)
               for h in range(h0, min(group, h0 + heads))]
        dq_c, dk_c, dv_c = attention_bwd_f32(q[:, sel], k, v, o[:, sel],
                                             lse[:, sel], do[:, sel], mask)
        dq[:, sel] = dq_c
        dk += dk_c
        dv += dv_c
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
