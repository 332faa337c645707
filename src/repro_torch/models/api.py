"""Model API used by the server and the trainer.

Counterpart of ``repro.models.api`` for the ``dense``, ``moe`` and ``vlm``
(attention), ``hybrid`` (Hymba: attention with a sliding window beside a
selective-scan SSM) and ``ssm`` (RWKV-6) families, built as
:class:`repro_torch.models.transformer.LM`, and the ``encdec`` family
(Whisper), built as :class:`repro_torch.models.encdec.EncDec`:
``init_params`` builds the model, ``make_prefill_fn`` and
``make_decode_fn`` return the serving functions, which run under
``torch.inference_mode()``, and ``make_loss_fn`` the training loss (cross
entropy plus :data:`AUX_LOSS_WEIGHT` times the MoE balance term; an
``encdec`` model's has no balance term), which runs in grad mode where its
caller asks for a gradient.  The gradients run on the card through
hand-written backward kernels: RWKV-6's through the WKV6 backward, the
attention families' through the flash-attention backward
(``kernels/flash_attention/csrc/flash_attn_bwd.cu``).  A ``vlm`` batch
carries ``patch_embeds`` (B, ``num_patches``, d), prepended to the tokens;
the loss drops their logits.  An ``encdec`` batch carries ``frames`` (B,
S_enc, d), the stub front end's frame embeddings, which the encoder reads.
``batch_spec``, ``abstract_params`` and ``abstract_caches`` give shapes
and dtypes as ``meta`` tensors (the reference's ShapeDtypeStructs and
``jax.eval_shape``).  Prefill pads the attention KV caches to the decode
horizon with the reference's ``_pad_caches`` (to exactly the window under
a sliding window, the ring's size; the identity for RWKV's O(1) state; an
``encdec`` model's cross caches and a ``hybrid`` model's SSM state pass
through).  The ``hybrid`` family serves only: its loss raises (ROADMAP
A.11 step 2b: the selective scan and the windowed flash attention have
no backward kernel yet).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import torch

from repro_torch.core.device import DEFAULT_DEVICE
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.common import dtype_of, softmax_cross_entropy

#: Weight of the MoE balance term in the loss, as the reference's.
AUX_LOSS_WEIGHT = 0.01

Model = Union[tfm.LM, encdec_mod.EncDec]


def _require_ported(cfg) -> None:
    if cfg.family == "encdec":
        encdec_mod.require_encdec(cfg)
    else:
        tfm.require_ported(cfg)


def init_params(cfg, generator: Optional[torch.Generator] = None,
                device=DEFAULT_DEVICE) -> Model:
    """The model with weights drawn from ``generator`` (see
    :class:`repro_torch.models.transformer.LM`): an ``encdec`` config's
    :class:`repro_torch.models.encdec.EncDec`, any other's ``LM``."""
    if cfg.family == "encdec":
        return encdec_mod.EncDec(cfg, generator, device)
    return tfm.LM(cfg, generator, device)


def abstract_params(cfg) -> Model:
    """The model built on the ``meta`` device: every parameter's shape and
    dtype (the reference's ``jax.eval_shape`` of ``init_params``), nothing
    allocated."""
    return init_params(cfg, device="meta")


def abstract_caches(cfg, shape) -> Dict:
    """The decode caches of an (arch, decode shape) cell on the ``meta``
    device: ``shape.global_batch`` rows, a KV horizon of
    ``shape.seq_len`` (a ring of ``min(seq_len, window)`` slots under a
    sliding window, with a ``hybrid`` model's fp32 SSM state; as many
    frames for an ``encdec`` model's cross caches, as the reference's)."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "encdec":
        return encdec_mod.init_encdec_caches(cfg, B, S, S, device="meta")
    return tfm.init_decode_caches(cfg, B, S, device="meta")


def batch_spec(cfg, shape) -> Dict[str, torch.Tensor]:
    """One global batch of this (arch, shape) as ``meta`` tensors: int32
    ``tokens`` (B, S), for a ``train`` shape ``labels``, for the ``vlm``
    family ``patch_embeds`` (B, ``num_patches``, d) and for the ``encdec``
    family ``frames`` (B, S, d), both in the compute dtype."""
    _require_ported(cfg)
    B, S = shape.global_batch, shape.seq_len
    cdt = dtype_of(cfg.compute_dtype)
    spec = {"tokens": torch.empty((B, S), dtype=torch.int32, device="meta")}
    if shape.kind == "train":
        spec["labels"] = torch.empty((B, S), dtype=torch.int32,
                                     device="meta")
    if cfg.family == "vlm":
        spec["patch_embeds"] = torch.empty(
            (B, cfg.num_patches, cfg.d_model), dtype=cdt, device="meta")
    if cfg.family == "encdec":
        spec["frames"] = torch.empty((B, S, cfg.d_model), dtype=cdt,
                                     device="meta")
    return spec


def require_trainable(cfg) -> None:
    """Raise for a family the port serves but cannot train yet: ``hybrid``
    (ROADMAP A.11 step 2b)."""
    _require_ported(cfg)
    if cfg.family == "hybrid":
        raise NotImplementedError(
            f"{cfg.name}: hybrid training is not ported yet (ROADMAP A.11 "
            "step 2b): the selective scan and the windowed flash attention "
            "have no backward kernel")


def make_loss_fn(cfg) -> Callable:
    """``loss_fn(model, batch)`` -> ``(loss, metrics)``: the token-mean
    cross entropy of ``batch["labels"]`` under the logits of
    ``batch["tokens"]``.  An ``encdec`` model reads ``batch["frames"]``
    and returns ``{"xent"}``, as the reference's; the others take the
    tokens after ``batch["patch_embeds"]`` where given (whose logits are
    dropped), add :data:`AUX_LOSS_WEIGHT` times the MoE balance term
    summed over the layers (0 without experts) and return ``{"xent",
    "moe_aux"}``."""
    require_trainable(cfg)

    def loss_fn(model: Model, batch: Dict):
        if cfg.family == "encdec":
            logits, _ = model.encdec_forward(batch["frames"], batch["tokens"])
            loss = softmax_cross_entropy(logits, batch["labels"])
            return loss, {"xent": loss}
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
    ``batch["patch_embeds"]``, where given, goes before the tokens; an
    ``encdec`` model encodes ``batch["frames"]`` first.  ``max_len``: the
    KV-cache capacity to reserve for the decode steps that follow
    (default: the prefix and prompt length + 128)."""
    _require_ported(cfg)

    @torch.inference_mode()
    def prefill_fn(model: Model, batch: Dict):
        if cfg.family == "encdec":
            logits, caches = model.encdec_forward(
                batch["frames"], batch["tokens"], collect_cache=True,
                last_only=True)
        else:
            logits, caches = model.lm_forward(
                batch["tokens"], batch.get("patch_embeds"),
                collect_cache=True, last_only=True)
        return logits[:, -1], _pad_caches(caches, cfg, max_len)
    return prefill_fn


def _pad_caches(caches: Dict, cfg, max_len: Optional[int]) -> Dict:
    """End-pad the (L, B, S, K, hd) KV caches to ``max_len`` so decode
    appends have room, or under a sliding window to exactly the window
    (ring slot ``p % window``); RWKV's state, an ``encdec`` model's cross
    caches and a ``hybrid`` model's SSM state pass through."""
    if cfg.block_type == "rwkv":
        return caches
    S = caches["kv"]["k"].shape[2]
    target = cfg.sliding_window or max_len or (S + 128)
    pad = max(0, target - S)

    def padder(a):
        return torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad))
    return dict(caches, kv={key: padder(a)
                            for key, a in caches["kv"].items()})


def make_decode_fn(cfg) -> Callable:
    """``decode_fn(model, token (B,), pos, caches)`` -> (logits (B, V),
    new caches); ``pos`` a Python int."""
    _require_ported(cfg)

    @torch.inference_mode()
    def decode_fn(model: Model, token: torch.Tensor, pos: int, caches):
        if cfg.family == "encdec":
            return model.encdec_decode_step(token, int(pos), caches)
        return model.lm_decode_step(token, int(pos), caches)
    return decode_fn
