"""Feed-forward layers: the dense MLP variants.

Counterpart of ``repro.models.ffn`` for dense FFNs (SwiGLU, gelu and
squared ReLU), with the reference's names, ``(in, out)`` layouts and init
(the output projection times 1/sqrt(2L)).  The capacity-factor MoE
(``init_moe``, ``apply_moe``) is not ported (ROADMAP A.11).
"""
from __future__ import annotations

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


def init_ffn(cfg, generator: Optional[torch.Generator], dtype,
             device=None) -> nn.ParameterDict:
    if cfg.num_experts:
        raise NotImplementedError(f"{cfg.name}: mixture-of-experts FFNs are "
                                  "not ported yet (ROADMAP A.11)")
    return init_mlp(cfg, generator, dtype, device)


def apply_ffn(params, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, float]:
    """(y, aux loss): the dense FFN has no auxiliary loss."""
    return apply_mlp(params, x, cfg), 0.0
