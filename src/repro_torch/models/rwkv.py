"""RWKV-6 (Finch) blocks: data-dependent-decay time mix + channel mix.

Counterpart of ``repro.models.rwkv``.  Parameters keep the names, layouts
(``(in, out)`` projections) and init distributions of the reference's
``init_rwkv_block``.  The sequence form of the time mix (prefill, no
state) runs the WKV6 recurrence through
:func:`repro_torch.kernels.wkv6.ops.wkv6_heads`: the CUDA kernel on the
card, its plain version on the CPU; in training its gradient to r, k, v,
logw and ``u`` comes from the backward kernel
(:class:`repro_torch.kernels.wkv6.ops.WKV6Function`, its plain version
on the CPU).  Decode carries O(1) state per layer,
``{"wkv": (B, H, D, D) fp32, "tm_shift": (B, d), "cm_shift": (B, d)}``,
and takes one token at a time with :func:`wkv_step`, tensor code in fp32
(the reference runs that step as its scan, not a kernel).  The decay is
data-dependent: ``logw_t = -exp(w0 + x_t W_d)`` per channel.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.kernels.wkv6 import ops as wkv6_ops
from repro_torch.models.common import dense_init, draw_device, rmsnorm


def heads_of(cfg) -> Tuple[int, int]:
    """(H, D): the WKV heads and their width."""
    d = cfg.d_model
    H = cfg.num_heads if cfg.num_heads > 0 else d // 64
    return H, d // H


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """Shifted sequence: y_t = x_{t-1}; the first step takes ``prev`` (or
    zeros)."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    elif prev.ndim == 2:
        prev = prev[:, None]
    return torch.cat([prev, x[:, :-1]], 1)


def _time_mix_inputs(p: "RWKVBlock", x: torch.Tensor, shifted: torch.Tensor,
                     cfg):
    """r, k, v (x's dtype) and logw (fp32), each (B, H, S, D): views of the
    (B, S, d) projections, with a unit stride on D."""
    H, D = heads_of(cfg)

    def mix(m):
        return x * m + shifted * (1.0 - m)
    r = mix(p.mix_r) @ p.wr
    k = mix(p.mix_k) @ p.wk
    v = mix(p.mix_v) @ p.wv
    logw = -torch.exp(p.w0 + (mix(p.mix_w) @ p.wd).float())
    B, S = x.shape[:2]

    def shp(a):
        return a.reshape(B, S, H, D).transpose(1, 2)
    return shp(r), shp(k), shp(v), shp(logw), H, D


def wkv_step(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor, S: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step, fp32: r, k, v, w (B, H, D), u (H, D), S (B, H, D,
    D) -> (o = r·S + (r·(u⊙k)) v, S' = w ⊙ S + k vᵀ)."""
    o = torch.einsum("bhd,bhde->bhe", r, S)
    bonus = (r * u * k).sum(-1)
    o = o + bonus[..., None] * v
    S = w[..., None] * S + k[..., None] * v[..., None, :]
    return o, S


def init_rwkv_state(cfg, batch: int, dtype, device=None) -> Dict:
    H, D = heads_of(cfg)
    d = cfg.d_model
    return {"wkv": torch.zeros((batch, H, D, D), dtype=torch.float32,
                               device=device),
            "tm_shift": torch.zeros((batch, d), dtype=dtype, device=device),
            "cm_shift": torch.zeros((batch, d), dtype=dtype, device=device)}


class RWKVBlock(nn.Module):
    """Time mix + channel mix, each pre-normed and residual.

    Weights are drawn with ``generator`` on ``device`` (the generator's
    own device when None; ``meta`` makes shapes only), in the reference's
    order of distributions: fan-in truncated normals, ``wd`` x0.1, ``wo``
    and ``cv`` x 1/sqrt(2L), ``w0 = -1``, mixes 0.5, norms 1.
    """

    def __init__(self, cfg, generator: Optional[torch.Generator], dtype,
                 device=None):
        super().__init__()
        self.cfg = cfg
        d, f = cfg.d_model, cfg.d_ff
        H, D = heads_of(cfg)
        out_scale = 1.0 / (2 * cfg.num_layers) ** 0.5
        dev = draw_device(generator, device)

        def full(shape, value, dt=dtype):
            return nn.Parameter(torch.full(shape, value, dtype=dt,
                                           device=dev))

        def dense(shape, scale=None, dt=dtype):
            w = dense_init(generator, shape, 0, dt, dev)
            return nn.Parameter(w if scale is None else w * scale)

        def norm():
            return nn.ParameterDict({"scale": full((d,), 1.0)})

        self.tm_norm = norm()
        self.mix_r = full((d,), 0.5)
        self.mix_k = full((d,), 0.5)
        self.mix_v = full((d,), 0.5)
        self.mix_w = full((d,), 0.5)
        self.wr = dense((d, d))
        self.wk = dense((d, d))
        self.wv = dense((d, d))
        self.wd = dense((d, d), 0.1)
        self.w0 = full((d,), -1.0, torch.float32)
        self.u = dense((H, D), dt=torch.float32)
        self.wo = dense((d, d), out_scale)
        self.ln_x = norm()
        self.cm_norm = norm()
        self.cmix_k = full((d,), 0.5)
        self.ck = dense((d, f))
        self.cv = dense((f, d), out_scale)
        self.cr = dense((d, d))

    def time_mix(self, x: torch.Tensor, state: Optional[Dict] = None
                 ) -> Tuple[torch.Tensor, Dict]:
        """x (B, S, d) -> (y (B, S, d), {"wkv", "tm_shift"}).  Without a
        state, the sequence form through the WKV6 kernel; with one, a
        single decode step (S == 1)."""
        B, S, d = x.shape
        xn = rmsnorm(x, self.tm_norm["scale"])
        prev = None if state is None else state["tm_shift"]
        shifted = _token_shift(xn, prev)
        r, k, v, logw, H, D = _time_mix_inputs(self, xn, shifted, self.cfg)
        if state is None:
            o, s = wkv6_ops.wkv6_heads(r, k, v, logw, self.u)
        else:
            if S != 1:
                raise ValueError(f"a decode step takes one token, got S={S}")
            o, s = wkv_step(r[:, :, 0].float(), k[:, :, 0].float(),
                            v[:, :, 0].float(), torch.exp(logw[:, :, 0]),
                            self.u, state["wkv"].float())
            o = o[:, :, None].to(x.dtype)
        y = o.transpose(1, 2).reshape(B, S, d)
        y = rmsnorm(y, self.ln_x["scale"])
        y = y @ self.wo
        # a copy: a view of the last position would keep all of xn alive
        return y, {"wkv": s, "tm_shift": xn[:, -1].clone()}

    def channel_mix(self, x: torch.Tensor, state: Optional[Dict] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        xn = rmsnorm(x, self.cm_norm["scale"])
        prev = None if state is None else state["cm_shift"]
        shifted = _token_shift(xn, prev)
        mixed = xn * self.cmix_k + shifted * (1.0 - self.cmix_k)
        kk = torch.relu(mixed @ self.ck).square()
        rr = torch.sigmoid(mixed @ self.cr)
        return rr * (kk @ self.cv), xn[:, -1].clone()

    def forward(self, x: torch.Tensor, state: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, Dict]:
        tm, tm_state = self.time_mix(x, state)
        x = x + tm
        cm, cm_shift = self.channel_mix(x, state)
        x = x + cm
        return x, dict(tm_state, cm_shift=cm_shift)
