"""Plain PyTorch version of the selective-scan kernel.

:func:`ssm_scan_ref` is the recurrence of the reference's
``repro.models.ssm.ssm_scan`` (its ``lax.scan`` step, :60-65) as a loop over
S, with the reference's order of operations: ``decay = exp(dt * A)``, then
``decay * h + (dt * x)[..., None] * B``, then ``y = einsum("ben,bn->be", h,
C)``; every input widened to fp32 first, as the reference casts the gates.
It is what ``csrc/ssm_scan.cu`` computes, on CPU tensors (and on the card,
the yardstick the kernel is held to).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def ssm_scan_ref(xi: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                 dt: torch.Tensor, A: torch.Tensor,
                 h0: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xi (B, S, di), Bm and Cm (B, S, n), dt (B, S), A (di, n), h0 (B, di,
    n) or None (zero) -> (y (B, S, di), final state (B, di, n)), both
    fp32."""
    xi, Bm, Cm, dt, A = (t.float() for t in (xi, Bm, Cm, dt, A))
    Bb, S, di = xi.shape
    n = Bm.shape[-1]
    h = (torch.zeros((Bb, di, n), dtype=torch.float32, device=xi.device)
         if h0 is None else h0.float())
    y = torch.empty((Bb, S, di), dtype=torch.float32, device=xi.device)
    for t in range(S):
        dtt = dt[:, t]
        decay = torch.exp(dtt[:, None, None] * A[None])
        h = decay * h + (dtt[:, None] * xi[:, t])[..., None] * Bm[:, t, None, :]
        y[:, t] = torch.einsum("ben,bn->be", h, Cm[:, t])
    return y, h
