"""Model API used by the server.

Counterpart of ``repro.models.api`` for the ``ssm`` family (RWKV-6):
``init_params`` builds the model, ``make_prefill_fn`` and
``make_decode_fn`` return the serving functions, which run under
``torch.inference_mode()`` (the WKV6 kernel has no backward).  Prefill
returns the caches as they are: the reference's ``_pad_caches`` grows
attention KV rings and is the identity for RWKV's O(1) state.  The other
families, training (``make_loss_fn``) and the abstract shapes of the
dry-run are not ported (ROADMAP A.11): each function raises for them.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.core.device import DEFAULT_DEVICE
from repro_torch.models import transformer as tfm


def init_params(cfg, generator: Optional[torch.Generator] = None,
                device=DEFAULT_DEVICE) -> tfm.LM:
    """The model with weights drawn from ``generator`` (see
    :class:`repro_torch.models.transformer.LM`)."""
    return tfm.LM(cfg, generator, device)


def make_prefill_fn(cfg) -> Callable:
    """``prefill_fn(model, batch)`` -> (last logits (B, V), caches).  The
    RWKV state needs no decode horizon (the reference's ``max_len``)."""
    tfm.require_ported(cfg)

    @torch.inference_mode()
    def prefill_fn(model: tfm.LM, batch: Dict):
        logits, caches = model.lm_forward(batch["tokens"], collect_cache=True,
                                          last_only=True)
        return logits[:, -1], caches
    return prefill_fn


def make_decode_fn(cfg) -> Callable:
    """``decode_fn(model, token (B,), pos, caches)`` -> (logits (B, V),
    new caches)."""
    tfm.require_ported(cfg)

    @torch.inference_mode()
    def decode_fn(model: tfm.LM, token: torch.Tensor, pos, caches):
        return model.lm_decode_step(token, pos, caches)
    return decode_fn
