"""Decoder-only LM assembly: prefill and decode (the ``rwkv`` block type).

Counterpart of ``repro.models.transformer`` for the attention-free RWKV-6
stack: an embedding, ``num_layers`` blocks in an ``nn.ModuleList`` (the
reference stacks them on a leading L axis for ``lax.scan``; here a Python
loop runs them), the final norm and an untied ``lm_head``.  The ``attn``
and ``hybrid`` block types, tied embeddings, prefix embeddings, remat and
the sharding hints are not ported (ROADMAP A.11).

Decode caches keep the reference's layout, stacked L-leading:
``{"wkv": (L, B, H, D, D) fp32, "tm_shift": (L, B, d), "cm_shift":
(L, B, d)}``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.common import (apply_norm, draw_device, dtype_of,
                                       embed_init, init_norm)


def require_ported(cfg) -> None:
    """Raise for a config the port cannot build yet (ROADMAP A.11)."""
    if cfg.block_type != "rwkv":
        raise NotImplementedError(
            f"{cfg.name}: block type {cfg.block_type!r} is not ported yet "
            "(ROADMAP A.11); the port runs the 'rwkv' block type")
    if cfg.tie_embeddings:
        raise NotImplementedError(f"{cfg.name}: tied embeddings are not "
                                  "ported yet (ROADMAP A.11)")


class LM(nn.Module):
    """The reference's ``init_lm`` pytree as a module: ``embed`` (V, d),
    ``blocks``, ``ln_f`` and ``lm_head`` (d, V), in ``cfg.param_dtype``.

    Weights are drawn with ``generator`` (one seeded 0 on the CPU when
    None) on the generator's own device, then moved to ``device`` (the
    card unless the caller asks otherwise); on ``meta`` only shapes are
    made.  A CUDA generator draws the full-width model on the card.
    """

    def __init__(self, cfg, generator: Optional[torch.Generator] = None,
                 device=DEFAULT_DEVICE):
        super().__init__()
        require_ported(cfg)
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        draw = dev if dev.type == "meta" else draw_device(generator, None)
        dtype = dtype_of(cfg.param_dtype)
        self.cfg = cfg
        self.embed = nn.Parameter(embed_init(
            generator, (cfg.vocab_size, cfg.d_model), dtype, draw))
        self.blocks = nn.ModuleList(
            rwkv_mod.RWKVBlock(cfg, generator, dtype, draw)
            for _ in range(cfg.num_layers))
        self.ln_f = init_norm(cfg, dtype, draw)
        self.lm_head = nn.Parameter(embed_init(
            generator, (cfg.d_model, cfg.vocab_size), dtype, draw))
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embed[tokens].to(dtype_of(self.cfg.compute_dtype))

    def _unembed(self, x: torch.Tensor) -> torch.Tensor:
        return apply_norm(self.ln_f, x, self.cfg) @ self.lm_head

    def lm_forward(self, tokens: torch.Tensor, collect_cache: bool = False,
                   last_only: bool = False
                   ) -> Tuple[torch.Tensor, Optional[Dict]]:
        """tokens (B, S) -> (logits (B, S, V), caches or None).

        ``last_only`` unembeds only the last position (logits (B, 1, V)),
        all that prefill returns.  Every block's time mix runs the WKV6
        kernel once on the card.
        """
        x = self._embed(tokens)
        states = []
        for block in self.blocks:
            x, state = block(x)
            if collect_cache:
                states.append(state)
        if last_only:
            x = x[:, -1:]
        logits = self._unembed(x)
        return logits, (_stack(states) if collect_cache else None)

    forward = lm_forward

    def lm_decode_step(self, token: torch.Tensor, pos, caches: Dict
                       ) -> Tuple[torch.Tensor, Dict]:
        """token (B,) -> (logits (B, V), new caches).  ``pos`` is unused by
        the RWKV blocks (their state carries the position), as in the
        reference."""
        x = self._embed(token[:, None])
        states = []
        for layer, block in enumerate(self.blocks):
            x, state = block(x, {key: c[layer] for key, c in caches.items()})
            states.append(state)
        return self._unembed(x)[:, 0], _stack(states)


def _stack(states) -> Dict:
    return {key: torch.stack([s[key] for s in states])
            for key in ("wkv", "tm_shift", "cm_shift")}


def init_decode_caches(cfg, batch: int, device=DEFAULT_DEVICE) -> Dict:
    """Zero decode caches, stacked L-leading.  The O(1) RWKV state needs no
    decode horizon (the reference's ``max_len``)."""
    require_ported(cfg)
    one = rwkv_mod.init_rwkv_state(cfg, batch, dtype_of(cfg.compute_dtype),
                                   resolve_device(device))
    return {key: x[None].expand((cfg.num_layers,) + x.shape).contiguous()
            for key, x in one.items()}
