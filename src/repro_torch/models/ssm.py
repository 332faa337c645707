"""Selective state-space (Mamba-style) branch of the hybrid (Hymba) layers.

Counterpart of ``repro.models.ssm``: per-channel input-dependent dt, B and
C, a diagonal A,

  h_t = exp(dt_t A) (.) h_{t-1} + dt_t (x_t (x) B_t)
  y_t = h_t . C_t + D (.) x_t

Parameters keep the reference's names, layouts and init: ``w_in`` and
``w_z`` (d, di), ``w_bc`` (di, 2 n), ``w_dt`` (di, 1), ``a_log`` (di, n)
(``log(1 .. n)`` along n, fp32 whatever ``param_dtype`` is, as the
reference's), ``d_skip`` (di,) ones and ``w_out`` (di, d) times
1/sqrt(2L), with ``di = ssm_expand * d // 2``.  :func:`ssm_scan`, the
sequence form (prefill), runs the recurrence through
:func:`repro_torch.kernels.ssm_scan.ops.ssm_scan`: the CUDA kernel on the
card, its plain version on the CPU; :func:`ssm_step`, the O(1)-state
decode form, is tensor code, as the reference's jnp.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.kernels.ssm_scan import ops as scan_ops
from repro_torch.models.common import dense_init, draw_device


def inner_width(cfg) -> int:
    """The reference's ``di = ssm_expand * d_model // 2``."""
    return cfg.ssm_expand * cfg.d_model // 2


def init_ssm(cfg, generator: Optional[torch.Generator], dtype,
             device=None) -> nn.ParameterDict:
    d, n, di = cfg.d_model, cfg.ssm_state, inner_width(cfg)
    dev = draw_device(generator, device)
    # log(1 .. n) in float64, rounded once to fp32 (the reference's fp32
    # log may differ from it by an ulp), the same row for every channel
    row = torch.log(torch.linspace(1.0, float(n), n, dtype=torch.float64))
    a_log = row.float().to(dev)[None, :] * torch.ones((di, 1), device=dev)
    p = {"w_in": dense_init(generator, (d, di), 0, dtype, dev),
         "w_z": dense_init(generator, (d, di), 0, dtype, dev),
         "w_bc": dense_init(generator, (di, 2 * n), 0, dtype, dev),
         "w_dt": dense_init(generator, (di, 1), 0, dtype, dev),
         "a_log": a_log,
         "d_skip": torch.ones((di,), dtype=dtype, device=dev),
         "w_out": dense_init(generator, (di, d), 0, dtype, dev)
         / (2 * cfg.num_layers) ** 0.5}
    return nn.ParameterDict({k: nn.Parameter(v) for k, v in p.items()})


def _gates(params, x: torch.Tensor):
    """(xi, z, B, C, dt) of x (..., d), in x's dtype: the projections as
    GEMMs, ``silu`` on z and ``softplus`` on dt, as the reference's."""
    xi = x @ params["w_in"]
    z = F.silu(x @ params["w_z"])
    bc = xi @ params["w_bc"]
    n = bc.shape[-1] // 2
    dt = F.softplus(xi @ params["w_dt"])
    return xi, z, bc[..., :n], bc[..., n:], dt


def _A(params) -> torch.Tensor:
    return -torch.exp(params["a_log"])


def ssm_scan(params, x: torch.Tensor, cfg,
             state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y (B, S, d), final state (B, di, n) fp32).  The
    gates go to the scan in x's dtype (the kernel widens them to fp32, the
    reference casts them); the scan's y comes back in x's dtype before the
    skip and the gate, as the reference's."""
    xi, z, Bm, Cm, dt = _gates(params, x)
    h0 = None if state is None else state.float()
    y, h = scan_ops.ssm_scan(xi, Bm, Cm, dt[..., 0], _A(params), h0)
    y = (y.to(x.dtype) + params["d_skip"] * xi) * z
    return y @ params["w_out"], h


def ssm_step(params, x: torch.Tensor, state: torch.Tensor, cfg
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step: x (B, 1, d), state (B, di, n) -> (y (B, 1, d), new
    state (B, di, n) fp32).  As the reference's, ``dt * xi`` is formed in
    the compute dtype before the fp32 cast (the scan casts first)."""
    xi, z, Bm, Cm, dt = _gates(params, x[:, 0])
    decay = torch.exp(dt[..., None].float() * _A(params)[None])
    h = decay * state + (dt * xi).float()[..., None] * Bm.float()[:, None, :]
    y = torch.einsum("ben,bn->be", h, Cm.float()).to(x.dtype)
    y = (y + params["d_skip"] * xi) * z
    return (y @ params["w_out"])[:, None], h
