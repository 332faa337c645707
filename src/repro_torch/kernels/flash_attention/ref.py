"""Plain PyTorch version of the flash-attention kernel: softmax attention.

Counterpart of ``repro.kernels.flash_attention.ref.attention_ref``, with
the contract of the reference's Pallas wrapper
(``repro.kernels.flash_attention.ops.flash_attention``) and of
``csrc/flash_attn.cu``:

- q (B, Hq, Tq, d); k and v (B, Hkv, Tk, d) with ``Hq % Hkv == 0``;
- GQA: query head h reads KV head ``h // (Hq // Hkv)``
  (``repeat_interleave``, as ``jnp.repeat``; ``repeat`` would give
  ``h % Hkv``);
- causal: key j is seen by query i when ``i >= j``, both counted from 0,
  also when Tq != Tk;
- scores, softmax and the weighted sum in fp32; the output in q's dtype.
"""
from __future__ import annotations

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> torch.Tensor:
    B, Hq, Tq, d = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    group = Hq // Hkv
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = torch.matmul(q.float(), kf.transpose(-1, -2)) / (d ** 0.5)
    if causal:
        qi = torch.arange(Tq, device=q.device)[:, None]
        kj = torch.arange(Tk, device=q.device)[None, :]
        s = s.masked_fill(qi < kj, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, vf).to(q.dtype)
