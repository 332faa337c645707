"""Model API used by the server and the trainer.

Counterpart of ``repro.models.api`` for the ``dense``, ``moe`` and ``vlm``
(attention) and ``ssm`` (RWKV-6) families: ``init_params`` builds the
model, ``make_prefill_fn`` and ``make_decode_fn`` return the serving
functions, which run under ``torch.inference_mode()``, and
``make_loss_fn`` the training loss (cross entropy plus
:data:`AUX_LOSS_WEIGHT` times the MoE balance term), which runs in grad
mode where its caller asks for a gradient.  The gradients run on the card
through hand-written backward kernels: RWKV-6's through the WKV6 backward,
the attention families' through the flash-attention backward
(``kernels/flash_attention/csrc/flash_attn_bwd.cu``).  A ``vlm`` batch
carries ``patch_embeds`` (B, ``num_patches``, d), prepended to the tokens;
the loss drops their logits.  ``batch_spec``, ``abstract_params`` and
``abstract_caches`` give shapes and dtypes as ``meta`` tensors (the
reference's ShapeDtypeStructs and ``jax.eval_shape``).  Prefill pads the
attention KV caches to the decode horizon with the reference's
``_pad_caches`` (the identity for RWKV's O(1) state).  The other families
are not ported (ROADMAP A.11): each function raises for them.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.core.device import DEFAULT_DEVICE
from repro_torch.models import transformer as tfm
from repro_torch.models.common import dtype_of, softmax_cross_entropy

#: Weight of the MoE balance term in the loss, as the reference's.
AUX_LOSS_WEIGHT = 0.01


def init_params(cfg, generator: Optional[torch.Generator] = None,
                device=DEFAULT_DEVICE) -> tfm.LM:
    """The model with weights drawn from ``generator`` (see
    :class:`repro_torch.models.transformer.LM`)."""
    return tfm.LM(cfg, generator, device)


def abstract_params(cfg) -> tfm.LM:
    """The model built on the ``meta`` device: every parameter's shape and
    dtype (the reference's ``jax.eval_shape`` of ``init_params``), nothing
    allocated."""
    return tfm.LM(cfg, device="meta")


def abstract_caches(cfg, shape) -> Dict:
    """The decode caches of an (arch, decode shape) cell on the ``meta``
    device: ``shape.global_batch`` rows, a KV horizon of
    ``shape.seq_len``."""
    return tfm.init_decode_caches(cfg, shape.global_batch, shape.seq_len,
                                  device="meta")


def batch_spec(cfg, shape) -> Dict[str, torch.Tensor]:
    """One global batch of this (arch, shape) as ``meta`` tensors: int32
    ``tokens`` (B, S), for a ``train`` shape ``labels``, and for the
    ``vlm`` family ``patch_embeds`` (B, ``num_patches``, d) in the compute
    dtype."""
    tfm.require_ported(cfg)
    B, S = shape.global_batch, shape.seq_len
    spec = {"tokens": torch.empty((B, S), dtype=torch.int32, device="meta")}
    if shape.kind == "train":
        spec["labels"] = torch.empty((B, S), dtype=torch.int32,
                                     device="meta")
    if cfg.family == "vlm":
        spec["patch_embeds"] = torch.empty(
            (B, cfg.num_patches, cfg.d_model),
            dtype=dtype_of(cfg.compute_dtype), device="meta")
    return spec


def make_loss_fn(cfg) -> Callable:
    """``loss_fn(model, batch)`` -> ``(loss, {"xent", "moe_aux"})``: the
    token-mean cross entropy of ``batch["labels"]`` under the logits of
    ``batch["tokens"]`` (after ``batch["patch_embeds"]`` where given, whose
    logits are dropped), plus :data:`AUX_LOSS_WEIGHT` times the MoE
    balance term summed over the layers (0 without experts)."""
    tfm.require_ported(cfg)

    def loss_fn(model: tfm.LM, batch: Dict):
        prefix = batch.get("patch_embeds")
        logits, aux, _ = model.lm_forward(batch["tokens"], prefix,
                                          with_aux=True)
        if prefix is not None:
            logits = logits[:, prefix.shape[1]:]
        loss = softmax_cross_entropy(logits, batch["labels"])
        return loss + AUX_LOSS_WEIGHT * aux, {"xent": loss, "moe_aux": aux}
    return loss_fn


def make_prefill_fn(cfg, max_len: Optional[int] = None) -> Callable:
    """``prefill_fn(model, batch)`` -> (last logits (B, V), caches).
    ``batch["patch_embeds"]``, where given, goes before the tokens.
    ``max_len``: the KV-cache capacity to reserve for the decode steps
    that follow (default: the prefix and prompt length + 128)."""
    tfm.require_ported(cfg)

    @torch.inference_mode()
    def prefill_fn(model: tfm.LM, batch: Dict):
        logits, caches = model.lm_forward(batch["tokens"],
                                          batch.get("patch_embeds"),
                                          collect_cache=True, last_only=True)
        return logits[:, -1], _pad_caches(caches, cfg, max_len)
    return prefill_fn


def _pad_caches(caches: Dict, cfg, max_len: Optional[int]) -> Dict:
    """End-pad the (L, B, S, K, hd) KV caches to ``max_len`` so decode
    appends have room; RWKV's state passes through."""
    if cfg.block_type == "rwkv":
        return caches
    S = caches["kv"]["k"].shape[2]
    pad = max(0, (max_len or (S + 128)) - S)

    def padder(a):
        return torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad))
    return dict(caches, kv={key: padder(a)
                            for key, a in caches["kv"].items()})


def make_decode_fn(cfg) -> Callable:
    """``decode_fn(model, token (B,), pos, caches)`` -> (logits (B, V),
    new caches); ``pos`` a Python int."""
    tfm.require_ported(cfg)

    @torch.inference_mode()
    def decode_fn(model: tfm.LM, token: torch.Tensor, pos: int, caches):
        return model.lm_decode_step(token, int(pos), caches)
    return decode_fn
