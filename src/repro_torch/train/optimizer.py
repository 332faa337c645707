"""AdamW with optional bf16 moment states and a cosine schedule.

Counterpart of ``repro.train.optimizer`` (``OptConfig``, ``init_opt_state``,
``schedule``, ``global_norm``, ``clip_by_global_norm``, ``adamw_update``).
Where the reference maps pytrees, these functions take a name -> tensor
mapping (``dict(model.named_parameters())``) and ``adamw_update`` updates
the parameters and the moments in place, under ``torch.no_grad()``: a 1.6 B
model on one card cannot hold a second copy of them.  The arithmetic is the
reference's: the clip, then the moments in fp32 cast to ``state_dtype``,
the weight update in fp32 cast to the parameter's dtype, the schedule
taken at the step after its increment.  The step counter and the
schedule's scalars live on the CPU (fp32), so an update reads nothing back
from the card.

Weight decay falls on the tensors that the reference decays, ``p.ndim >=
2`` of its own tree.  The reference stacks an LM's blocks on a leading L
axis, and an encoder-decoder's two stacks each on its own, so every
per-layer vector there is (L, d) and decayed; the port holds them as (d,)
tensors named ``blocks.<l>.*``, ``enc_blocks.<l>.*`` and
``dec_blocks.<l>.*`` (:data:`STACKED_PREFIXES`).  ``decay`` says which
parameters are decayed: :func:`matrix_decay` (the planner, whose reference
tree is not stacked) or :func:`stacked_decay` (the LMs).  ``opt_state_pspecs``
is sharding and is not ported (ROADMAP A.11).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Mapping, Tuple

import torch

#: ``decay(name, tensor)``: whether ``adamw_update`` decays that parameter.
DecayRule = Callable[[str, torch.Tensor], bool]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    state_dtype: str = "float32"         # "bfloat16" for the giant archs


def matrix_decay(name: str, p: torch.Tensor) -> bool:
    """The reference's rule on an unstacked tree: matrices only."""
    return p.ndim >= 2


#: The names of the parameters that the reference stacks on a leading
#: layer axis: the LM's blocks and the encoder-decoder's two stacks.
STACKED_PREFIXES = ("blocks.", "enc_blocks.", "dec_blocks.")


def stacked_decay(name: str, p: torch.Tensor) -> bool:
    """The reference's rule on an LM, whose blocks it stacks on a leading L
    axis: a parameter of a stack (:data:`STACKED_PREFIXES`) counts that
    axis too."""
    return p.ndim + int(name.startswith(STACKED_PREFIXES)) >= 2


def init_opt_state(params: Mapping[str, torch.Tensor],
                   cfg: OptConfig) -> Dict:
    """Zero moments beside each parameter (in ``cfg.state_dtype``) and a
    step count of 0 (a CPU int32 scalar, as the reference's)."""
    dt = torch.bfloat16 if cfg.state_dtype == "bfloat16" else torch.float32

    def zeros():
        return {n: torch.zeros(p.shape, dtype=dt, device=p.device)
                for n, p in params.items()}
    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32)}


def schedule(step, cfg: OptConfig) -> torch.Tensor:
    """Linear warm-up to ``cfg.lr``, then cosine to ``min_lr_frac`` of it:
    a CPU fp32 scalar, computed as the reference computes it in fp32."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """The fp32 l2 norm of every tensor of ``tree`` together."""
    return torch.sqrt(sum(x.float().square().sum() for x in tree.values()))


def clip_by_global_norm(grads: Mapping[str, torch.Tensor], max_norm: float
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """``grads`` scaled so their global norm is at most ``max_norm`` (new
    tensors; the scale cast to each gradient's dtype), and the norm."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return {n: g * scale.to(g.dtype) for n, g in grads.items()}, norm


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


@torch.no_grad()
def adamw_update(params: Mapping[str, torch.Tensor],
                 grads: Mapping[str, torch.Tensor], state: Dict,
                 cfg: OptConfig, decay: DecayRule = matrix_decay
                 ) -> Tuple[Mapping[str, torch.Tensor], Dict, Dict]:
    """One AdamW step, in place: returns ``(params, state, metrics)``, the
    same mappings updated, and ``{"lr", "grad_norm"}``.  ``grads`` maps the
    same names (any dtype; the update reads it in fp32)."""
    if set(grads) != set(params):
        raise ValueError(f"grads name {sorted(set(grads) ^ set(params))} "
                         "unlike params")
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.clip_norm)
    step = state["step"] + 1
    lr = schedule(step, cfg)
    b1, b2 = cfg.beta1, cfg.beta2
    stepf = step.to(torch.float32)
    bc1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** stepf)
    bc2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** stepf)
    lr_f = float(lr)
    # The same operations in the same order as
    # m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2,
    # p -= lr ((m / bc1) / (sqrt(v / bc2) + eps) + wd p), each rounded alike,
    # written in place where a value is not read again: an fp32 moment or
    # parameter is its own fp32 copy, so it takes the update where it lies,
    # and a tensor of the 620 M-row embedding costs two temporaries, not a
    # dozen.
    for name, p in params.items():
        g = grads[name]
        g32 = (g * scale.to(device=g.device, dtype=g.dtype)).float()
        m, v = state["m"][name], state["v"][name]
        m32 = m.float().mul_(b1).add_(g32 * (1 - b1))
        v32 = v.float().mul_(b2).add_(g32.square_().mul_(1 - b2))
        del g32
        delta = m32.div(bc1).div_(v32.div(bc2).sqrt_().add_(cfg.eps))
        if decay(name, p):
            delta.add_(p.float() * cfg.weight_decay)
        delta.mul_(lr_f)
        if p.dtype == torch.float32:
            p.sub_(delta)
        else:
            p.copy_(p.float().sub_(delta))
        del delta
        if m32 is not m:
            m.copy_(m32)
        if v32 is not v:
            v.copy_(v32)
    state["step"] = step
    return params, state, {"lr": lr, "grad_norm": gnorm}
