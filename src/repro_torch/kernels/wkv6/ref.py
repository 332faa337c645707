"""Plain PyTorch version of the WKV6 kernel: the step-by-step recurrence.

Counterpart of ``repro.kernels.wkv6.ref.wkv6_ref``.  Per batch·head row,
with key/value width D and a data-dependent per-channel decay
``w_t = exp(logw_t)``:

    o_t = r_t S_{t-1} + (r_t · (u ⊙ k_t)) v_t
    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ

Contract (also of ``csrc/wkv6.cu``): ``r``, ``k``, ``v``, ``logw``
(BH, T, D); ``u`` one bonus row per batch·head row (BH, D), or (D,) shared
by all; fp32 inside; ``o`` in r's dtype, the final state (BH, D, D) fp32.
"""
from __future__ import annotations

from typing import Tuple

import torch


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             logw: torch.Tensor, u: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step-by-step recurrence over (BH, T, D) from a zero state:
    ``(o (BH, T, D), final state (BH, D, D))``."""
    BH, T, D = r.shape
    w = torch.exp(logw.float())
    u = u.float()
    if u.ndim == 1:
        u = u[None].expand(BH, D)
    S = torch.zeros((BH, D, D), dtype=torch.float32, device=r.device)
    rf, kf, vf = r.float(), k.float(), v.float()
    outs = []
    for t in range(T):
        rt, kt, vt, wt = rf[:, t], kf[:, t], vf[:, t], w[:, t]
        out = torch.einsum("bd,bde->be", rt, S)
        bonus = (rt * u * kt).sum(-1)
        out = out + bonus[:, None] * vt
        S = wt[:, :, None] * S + kt[:, :, None] * vt[:, None, :]
        outs.append(out)
    o = (torch.stack(outs, 1) if outs
         else torch.zeros((BH, 0, D), dtype=torch.float32, device=r.device))
    return o.to(r.dtype), S
