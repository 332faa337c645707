"""Shared model building blocks (PyTorch): init, norms, RoPE, dtype policy.

Counterpart of ``repro.models.common`` (``dtype_of``, ``dense_init``,
``embed_init``, ``rmsnorm``, ``layernorm``, ``init_norm``, ``apply_norm``,
``rope_freqs``, ``apply_rope``, ``activation``, ``softmax_cross_entropy``).
The reference's sharding hints
(``shard_hint``, ``shard_hint_spec``, ``BATCH_AXES``) have no counterpart:
the port runs a model on one card.  The port's random streams differ from
``jax.random``: weights that must agree with the reference are carried
across with :mod:`repro_torch.convert`.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def draw_device(generator: Optional[torch.Generator], device):
    """Where a weight is drawn: ``device`` if given, else the generator's
    own device (a torch generator draws only on its device), else the CPU."""
    if device is not None:
        return torch.device(device)
    return generator.device if generator is not None else torch.device("cpu")


def dense_init(generator: Optional[torch.Generator], shape: Sequence[int],
               in_axis: int = 0, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """Truncated-normal fan-in init: N(0, 1/fan_in) cut at two standard
    deviations (``jax.random.truncated_normal(key, -2, 2) * std``; torch's
    bounds are absolute, hence ``a=-2*std, b=2*std``).  Drawn in fp32 on
    the generator's device; on the ``meta`` device only the shape is made."""
    fan_in = shape[in_axis]
    std = (1.0 / max(fan_in, 1)) ** 0.5
    dev = draw_device(generator, device)
    out = torch.empty(tuple(shape), dtype=torch.float32, device=dev)
    if dev.type != "meta":
        nn.init.trunc_normal_(out, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)
    return out.to(dtype)


def embed_init(generator: Optional[torch.Generator], shape: Sequence[int],
               dtype=torch.float32, device=None) -> torch.Tensor:
    """N(0, 0.02^2), drawn in fp32 on the generator's device, cast."""
    dev = draw_device(generator, device)
    out = torch.empty(tuple(shape), dtype=torch.float32, device=dev)
    if dev.type != "meta":
        out.normal_(0.0, 0.02, generator=generator)
    return out.to(dtype)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """RMS norm over the last axis, computed in fp32 and cast back."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)
    return (x * scale.float()).to(dt)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """Layer norm over the last axis, computed in fp32 and cast back."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def init_norm(cfg, dtype, device=None) -> nn.ParameterDict:
    """A norm's parameters, named as the reference's ``init_norm``:
    ``scale`` (ones) and, for ``layernorm``, ``bias`` (zeros)."""
    p = {"scale": torch.ones(cfg.d_model, dtype=dtype, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(cfg.d_model, dtype=dtype, device=device)
    return nn.ParameterDict({k: nn.Parameter(v) for k, v in p.items()})


def apply_norm(params, x: torch.Tensor, cfg) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layernorm(x, params["scale"], params["bias"])
    return rmsnorm(x, params["scale"])


def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotary embedding on interleaved pairs ``(x[..., 0::2], x[..., 1::2])``
    (not the rotate-half convention); x (..., S, hd), positions (..., S) or
    (S,).  Angles in fp32; the result is cast back to x's dtype."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # (hd/2,)
    ang = positions[..., :, None].float() * freqs           # (..., S, hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., ::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x1 * sin + x2 * cos
    return torch.stack([y1, y2], -1).reshape(x.shape).to(x.dtype)


def activation(name: str):
    if name == "gelu":              # jax.nn.gelu's default: the tanh form
        return lambda x: torch.nn.functional.gelu(x, approximate="tanh")
    if name == "relu2":             # nemotron squared-ReLU
        return lambda x: torch.relu(x).square()
    raise ValueError(name)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          z_loss: float = 0.0) -> torch.Tensor:
    """Stable token-mean cross entropy; logits (..., V) taken in fp32,
    labels (...) integer ids.  ``z_loss`` adds ``z_loss * logsumexp²`` a
    token, as the reference.  The label's logit is a gather (the
    reference's masked reduction picks the same one value; it avoids a
    gather only for a vocabulary sharded over devices)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels.long()[..., None])[..., 0]
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * lse.square()
    return loss.mean()


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
