"""Shared model building blocks (PyTorch): the reference's fan-in init.

Counterpart of ``repro.models.common.dense_init``; the norms, RoPE and the
dtype policy wait for the LM side (ROADMAP A.11).  The port's random
streams differ from ``jax.random``: weights that must agree with the
reference are carried across with :func:`repro_torch.convert.
planner_from_reference`.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn


def dense_init(generator: Optional[torch.Generator], shape: Sequence[int],
               in_axis: int = 0, dtype=torch.float32) -> torch.Tensor:
    """Truncated-normal fan-in init: N(0, 1/fan_in) cut at two standard
    deviations (``jax.random.truncated_normal(key, -2, 2) * std``; torch's
    bounds are absolute, hence ``a=-2*std, b=2*std``)."""
    fan_in = shape[in_axis]
    std = (1.0 / max(fan_in, 1)) ** 0.5
    out = torch.empty(tuple(shape), dtype=torch.float32)
    nn.init.trunc_normal_(out, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)
    return out.to(dtype)


def dense_linear(c_in: int, c_out: int, generator: Optional[torch.Generator],
                 scale: float = 1.0) -> nn.Linear:
    """An ``nn.Linear`` with :func:`dense_init` weights (drawn in the
    reference's ``(in, out)`` layout, stored transposed) times ``scale``
    and zero bias; it draws nothing from torch's global generator."""
    layer = nn.utils.skip_init(nn.Linear, c_in, c_out)
    with torch.no_grad():
        layer.weight.copy_(dense_init(generator, (c_in, c_out)).t() * scale)
        layer.bias.zero_()
    return layer
