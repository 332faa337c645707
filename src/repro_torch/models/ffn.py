"""Feed-forward layers: the dense MLP variants and the capacity-factor MoE.

Counterpart of ``repro.models.ffn``: dense FFNs (SwiGLU, gelu and squared
ReLU) and the mixture of experts, with the reference's names, ``(in,
out)`` layouts and init (the output projections times 1/sqrt(2L); the
router in fp32 whatever ``param_dtype`` is).  The MoE dispatch is the
reference's scatter into per-expert buffers of ``moe_capacity`` rows, step
for step: the fp32 router and softmax, top-k, the Switch balance term, each
(token, slot)'s buffer position by a one-hot cumsum in (s, k) order, the
pairs past capacity dropped to a spare row, the experts as batched matrix
products (the reference computes them in jnp, outside any Pallas kernel),
the gather back and the gate-weighted sum.  The reference's sharding of the
expert axis has no counterpart: the port runs a model on one card.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.models.common import activation, dense_init, draw_device


def init_mlp(cfg, generator: Optional[torch.Generator], dtype, device=None,
             d_ff: Optional[int] = None) -> nn.ParameterDict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dev = draw_device(generator, device)
    out_scale = 1.0 / (2 * cfg.num_layers) ** 0.5

    def dense(shape):
        return dense_init(generator, shape, 0, dtype, dev)
    if cfg.mlp_act == "swiglu":
        p = {"w_gate": dense((d, f)), "w_up": dense((d, f)),
             "w_down": dense((f, d)) * out_scale}
    else:
        p = {"w_in": dense((d, f)), "w_out": dense((f, d)) * out_scale}
    return nn.ParameterDict({k: nn.Parameter(v) for k, v in p.items()})


def apply_mlp(params, x: torch.Tensor, cfg) -> torch.Tensor:
    if cfg.mlp_act == "swiglu":
        h = torch.nn.functional.silu(x @ params["w_gate"])
        return (h * (x @ params["w_up"])) @ params["w_down"]
    return activation(cfg.mlp_act)(x @ params["w_in"]) @ params["w_out"]


# ---------------------------------------------------------------------------
# Mixture of experts
# ---------------------------------------------------------------------------

def init_moe(cfg, generator: Optional[torch.Generator], dtype,
             device=None) -> nn.ParameterDict:
    """``router`` (d, E) fp32; ``w_gate`` / ``w_up`` (E, d, f) and
    ``w_down`` (E, f, d), or ``w_in`` / ``w_out`` for the other
    activations, fan-in d (f for the output); ``dense``, an
    :func:`init_mlp`, under ``cfg.dense_residual``."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    dev = draw_device(generator, device)
    out_scale = 1.0 / (2 * cfg.num_layers) ** 0.5

    def expert(shape):
        return dense_init(generator, shape, 1, dtype, dev)
    p = {"router": dense_init(generator, (d, E), 0, torch.float32, dev)}
    if cfg.mlp_act == "swiglu":
        p["w_gate"] = expert((E, d, f))
        p["w_up"] = expert((E, d, f))
        p["w_down"] = expert((E, f, d)) * out_scale
    else:
        p["w_in"] = expert((E, d, f))
        p["w_out"] = expert((E, f, d)) * out_scale
    out = nn.ParameterDict({k: nn.Parameter(v) for k, v in p.items()})
    if cfg.dense_residual:
        out["dense"] = init_mlp(cfg, generator, dtype, dev)
    return out


def moe_capacity(cfg, num_tokens: int) -> int:
    cap = int(math.ceil(cfg.moe_capacity_factor * num_tokens
                        * cfg.experts_per_token / cfg.num_experts))
    return max(8, min(cap, num_tokens))


def moe_route(params, x: torch.Tensor, cfg):
    """The router of one dispatch group per batch row: x (B, S, d) ->
    (probs (B, S, E) fp32, gate values (B, S, k) fp32 normalised, expert
    ids (B, S, k), buffer positions (B, S, k), kept (B, S, k) bool).

    Top-k is a stable descending sort: ties go to the lower expert id, as
    ``jax.lax.top_k``'s do (``torch.topk`` promises no order), and the slot
    order sets each pair's buffer position and so which pairs drop."""
    E, k = cfg.num_experts, cfg.experts_per_token
    B, S, _ = x.shape
    probs = torch.softmax(x.float() @ params["router"], -1)
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = srt.values[..., :k], srt.indices[..., :k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    # position of each (token, slot) in its expert's buffer: the count of
    # earlier pairs, in (s, k) order, routed to the same expert.  The
    # one-hot is laid out (B, E, S k), so the cumsum runs along the last
    # axis: a scan along an outer axis runs one thread a column on the
    # card (on an H100, 49 ms of a 127 ms Granite-MoE prefill)
    flat = gate_idx.reshape(B, 1, S * k)
    onehot = (flat == torch.arange(E, device=x.device)[:, None]).to(
        torch.int32)
    pos = (onehot.cumsum(-1, dtype=torch.int32).gather(1, flat) - 1
           ).reshape(B, S, k)
    return probs, gate_vals, gate_idx, pos, pos < moe_capacity(cfg, S)


def apply_moe(params, x: torch.Tensor, cfg
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y (B, S, d), aux fp32 scalar): one dispatch group a
    batch row; in decode (S == 1, B > 1) under
    ``cfg.moe_batch_group_decode`` the whole batch is one group."""
    if x.shape[1] == 1 and x.shape[0] > 1 and cfg.moe_batch_group_decode:
        B = x.shape[0]
        y, aux = apply_moe(params, x.reshape(1, B, -1),
                           cfg.replace(moe_batch_group_decode=False))
        return y.reshape(B, 1, -1), aux
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    C = moe_capacity(cfg, S)
    probs, gate_vals, gate_idx, pos, keep = moe_route(params, x, cfg)

    # Switch load-balancing term: the router's mean probability times the
    # share of tokens whose first choice each expert is
    me = probs.mean((0, 1))
    ce = torch.nn.functional.one_hot(gate_idx[..., 0], E).float().mean((0, 1))
    aux = E * (me * ce).sum()

    # scatter into (B, E C + 1, d): the spare last row takes the dropped
    # pairs and is sliced off
    dest = torch.where(keep, gate_idx * C + pos, E * C).reshape(B, S * k, 1)
    src = x[:, :, None, :].expand(B, S, k, d).reshape(B, S * k, d)
    buf = x.new_zeros((B, E * C + 1, d)).scatter(1, dest.expand(-1, -1, d),
                                                 src)
    xe = buf[:, :E * C].reshape(B, E, C, d).transpose(0, 1).reshape(
        E, B * C, d)
    if cfg.mlp_act == "swiglu":
        h = torch.nn.functional.silu(torch.bmm(xe, params["w_gate"]))
        out = torch.bmm(h * torch.bmm(xe, params["w_up"]), params["w_down"])
    else:
        h = activation(cfg.mlp_act)(torch.bmm(xe, params["w_in"]))
        out = torch.bmm(h, params["w_out"])
    out = out.reshape(E, B, C, d).transpose(0, 1).reshape(B, E * C, d)
    flat_out = torch.cat([out, out.new_zeros((B, 1, d))], 1)
    gathered = flat_out.gather(1, dest.expand(-1, -1, d)).reshape(B, S, k, d)
    y = (gathered * gate_vals[..., None].to(x.dtype)).sum(2)
    if cfg.dense_residual:
        y = y + apply_mlp(params["dense"], x, cfg)
    return y, aux


def init_ffn(cfg, generator: Optional[torch.Generator], dtype,
             device=None) -> nn.ParameterDict:
    if cfg.num_experts:
        return init_moe(cfg, generator, dtype, device)
    return init_mlp(cfg, generator, dtype, device)


def apply_ffn(params, x: torch.Tensor, cfg):
    """(y, aux loss): the MoE's balance term (an fp32 scalar tensor); a
    dense FFN has none, a Python 0.0 (no launch a layer on the card)."""
    if cfg.num_experts:
        return apply_moe(params, x, cfg)
    return apply_mlp(params, x, cfg), 0.0
