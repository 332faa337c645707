"""The train step: loss, gradients (with microbatching), AdamW.

Counterpart of ``repro.train.train_loop.make_train_step``.  The step takes
the model (an :class:`repro_torch.models.transformer.LM` or an
:class:`repro_torch.models.encdec.EncDec`), the optimizer
state of :mod:`repro_torch.train.optimizer` and a batch of tensors on the
model's device, and updates the model's parameters in place.  With
``num_microbatches`` > 1 the batch is split along its leading axis and the
gradients are summed in fp32, then divided, as the reference's scan does;
the loss is the microbatches' mean, the other metrics the last
microbatch's.  The model decays its parameters by the reference's rank
(:func:`repro_torch.train.optimizer.stacked_decay`).  The sharded steps
(``make_sharded_train_step``, prefill, decode) are not ported (ROADMAP
A.11): the port trains on one card.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.models import api
from repro_torch.train import optimizer as opt_mod


def make_train_step(cfg, opt_cfg: opt_mod.OptConfig,
                    num_microbatches: int = 1) -> Callable:
    """``step(model, opt_state, batch)`` -> ``(model, opt_state,
    metrics)``; metrics are 0-d tensors: the loss's terms, ``loss``,
    ``lr`` and ``grad_norm``."""
    loss_fn = api.make_loss_fn(cfg)

    def grads_of(params: Dict[str, torch.Tensor], model, batch):
        with torch.enable_grad():
            loss, metrics = loss_fn(model, batch)
            grads = torch.autograd.grad(loss, list(params.values()))
        metrics = {key: val.detach() for key, val in metrics.items()}
        return loss.detach(), metrics, dict(zip(params, grads))

    def step(model, opt_state: Dict, batch: Dict):
        params = dict(model.named_parameters())
        if num_microbatches == 1:
            loss, metrics, grads = grads_of(params, model, batch)
        else:
            B = next(iter(batch.values())).shape[0]
            if B % num_microbatches:
                raise ValueError(f"batch {B} does not split into "
                                 f"{num_microbatches} microbatches")
            mb = B // num_microbatches
            grads = {n: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for n, p in params.items()}
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            for i in range(num_microbatches):
                part = {key: x[i * mb:(i + 1) * mb]
                        for key, x in batch.items()}
                l, metrics, g = grads_of(params, model, part)
                for n, gn in g.items():
                    grads[n].add_(gn.float())
                del g
                loss = loss + l
            for gn in grads.values():
                gn.div_(num_microbatches)
            loss = loss / num_microbatches
        _, opt_state, om = opt_mod.adamw_update(
            params, grads, opt_state, opt_cfg, opt_mod.stacked_decay)
        metrics = dict(metrics, loss=loss, **om)
        return model, opt_state, metrics

    return step
