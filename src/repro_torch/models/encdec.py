"""Whisper-style encoder-decoder: the ``encdec`` family.

Counterpart of ``repro.models.encdec``.  The conv/mel front end is a stub,
as in the reference: callers hand over precomputed frame embeddings (B,
S_enc, d).  The encoder is ``encoder_layers`` pre-norm blocks of
bidirectional self-attention and an MLP, then ``ln_enc``; the decoder is
``num_layers`` blocks of causal self-attention, cross-attention (q from the
decoder, k and v projected from the encoder's states) and an MLP, then
``ln_f`` and an untied ``lm_head``.  Every attention over a sequence goes
through :func:`repro_torch.models.attention.attention_ctx`, so through the
flash-attention kernels on the card: the encoder's non-causal over S_enc
frames, the decoder's causal over its S tokens, and the cross-attention's
non-causal S x S_enc (Tq != Tk); in grad mode their backward is the
hand-written one.  The blocks are ``nn.ModuleList`` entries run by a
Python loop (the reference stacks them for ``lax.scan``), each through
``torch.utils.checkpoint`` under ``cfg.remat`` in grad mode, as
:class:`repro_torch.models.transformer.LM` runs its blocks.  The
reference's sharding hints (``shard_hint``, ``_use``) have no counterpart:
the port runs a model on one card (ROADMAP A.11).

Decode caches keep the reference's layout, stacked L-leading over the
decoder's layers: ``{"kv": {"k": (L, B, T, K, hd), "v": ...}, "xk": (L,
B, S_enc, K, hd), "xv": ...}``.  A decode step writes its self-attention
slot in place (:func:`repro_torch.models.attention.cache_update`) and
attends over the fixed cross cache, every slot valid, in tensor code
(:func:`repro_torch.models.attention.decode_partial`), as the reference
does in jnp.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod
from repro_torch.models.common import (apply_norm, draw_device, dtype_of,
                                       embed_init, init_norm)
from repro_torch.models.transformer import (broadcast_layers, cache_layer,
                                            require_options_ported,
                                            stack_caches)


def require_encdec(cfg) -> None:
    """Raise for a config :class:`EncDec` cannot build: another family, or
    an option the port lacks yet (ROADMAP A.11)."""
    if cfg.family != "encdec":
        raise ValueError(f"{cfg.name}: EncDec builds the 'encdec' family, "
                         f"not {cfg.family!r}")
    require_options_ported(cfg)
    if cfg.sliding_window:
        raise NotImplementedError(
            f"{cfg.name}: sliding windows are ported for the decoder-only "
            "LM (the hybrid family), not for the encoder-decoder (ROADMAP "
            "A.11)")


class EncBlock(nn.Module):
    """The reference's ``init_enc_block``: ``ln1``, ``attn``, ``ln2``,
    ``ffn``, drawn in that order."""

    def __init__(self, cfg, generator: Optional[torch.Generator], dtype,
                 device=None):
        super().__init__()
        dev = draw_device(generator, device)
        self.ln1 = init_norm(cfg, dtype, dev)
        self.attn = attn.init_attention(cfg, generator, dtype, dev)
        self.ln2 = init_norm(cfg, dtype, dev)
        self.ffn = ffn_mod.init_mlp(cfg, generator, dtype, dev)


class DecBlock(nn.Module):
    """The reference's ``init_dec_block``: ``ln1``, ``self_attn``,
    ``ln_x``, ``cross_attn``, ``ln2``, ``ffn``, drawn in that order."""

    def __init__(self, cfg, generator: Optional[torch.Generator], dtype,
                 device=None):
        super().__init__()
        dev = draw_device(generator, device)
        self.ln1 = init_norm(cfg, dtype, dev)
        self.self_attn = attn.init_attention(cfg, generator, dtype, dev)
        self.ln_x = init_norm(cfg, dtype, dev)
        self.cross_attn = attn.init_attention(cfg, generator, dtype, dev)
        self.ln2 = init_norm(cfg, dtype, dev)
        self.ffn = ffn_mod.init_mlp(cfg, generator, dtype, dev)


def enc_block(block: EncBlock, x: torch.Tensor, cfg,
              positions: torch.Tensor) -> torch.Tensor:
    """One encoder block over the frames: bidirectional self-attention,
    then the MLP, each pre-norm with a residual."""
    h = apply_norm(block.ln1, x, cfg)
    q, k, v = attn.compute_qkv(block.attn, h, cfg, positions)
    x = x + attn.project_out(block.attn,
                             attn.attention_ctx(q, k, v, cfg, causal=False))
    return x + ffn_mod.apply_mlp(block.ffn, apply_norm(block.ln2, x, cfg),
                                 cfg)


def dec_block_seq(block: DecBlock, x: torch.Tensor, enc: torch.Tensor, cfg,
                  positions: torch.Tensor, enc_positions: torch.Tensor,
                  collect_cache: bool
                  ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """One decoder block over the tokens ``x`` (B, S, d) against the
    encoder's states ``enc`` (B, S_enc, d): (x, its caches or None)."""
    h = apply_norm(block.ln1, x, cfg)
    q, k, v = attn.compute_qkv(block.self_attn, h, cfg, positions)
    x = x + attn.project_out(block.self_attn,
                             attn.attention_ctx(q, k, v, cfg, causal=True))
    h = apply_norm(block.ln_x, x, cfg)
    qx = attn.compute_qkv(block.cross_attn, h, cfg, positions, "q")[0]
    _, kx, vx = attn.compute_qkv(block.cross_attn, enc, cfg, enc_positions,
                                 "kv")
    x = x + attn.project_out(block.cross_attn,
                             attn.attention_ctx(qx, kx, vx, cfg,
                                                causal=False))
    x = x + ffn_mod.apply_mlp(block.ffn, apply_norm(block.ln2, x, cfg), cfg)
    cache = ({"kv": {"k": k, "v": v}, "xk": kx, "xv": vx} if collect_cache
             else None)
    return x, cache


def _dec_block_out(block: DecBlock, x: torch.Tensor, enc: torch.Tensor,
                   cfg, positions: torch.Tensor,
                   enc_positions: torch.Tensor) -> torch.Tensor:
    """One decoder block's output (the remat body)."""
    return dec_block_seq(block, x, enc, cfg, positions, enc_positions,
                         False)[0]


class EncDec(nn.Module):
    """The reference's ``init_encdec`` pytree as a module: ``embed`` (V,
    d), ``enc_blocks``, ``dec_blocks``, ``ln_enc``, ``ln_f`` and
    ``lm_head`` (d, V), in ``cfg.param_dtype``.

    Weights are drawn as :class:`repro_torch.models.transformer.LM` draws
    them: with ``generator`` (one seeded 0 on the CPU when None) on the
    generator's own device, then moved to ``device`` (the card unless the
    caller asks otherwise); on ``meta`` only shapes are made.  The draws
    follow the modules' order, not the reference's key splits (its
    ``ln_enc`` and ``ln_f`` share a key, which a norm's constant
    init does not read): parity with the reference comes through
    :func:`repro_torch.convert.encdec_from_reference`, not the draws.
    """

    def __init__(self, cfg, generator: Optional[torch.Generator] = None,
                 device=DEFAULT_DEVICE):
        super().__init__()
        require_encdec(cfg)
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        draw = dev if dev.type == "meta" else draw_device(generator, None)
        dtype = dtype_of(cfg.param_dtype)
        self.cfg = cfg
        self.embed = nn.Parameter(embed_init(
            generator, (cfg.vocab_size, cfg.d_model), dtype, draw))
        self.enc_blocks = nn.ModuleList(
            EncBlock(cfg, generator, dtype, draw)
            for _ in range(cfg.encoder_layers))
        self.dec_blocks = nn.ModuleList(
            DecBlock(cfg, generator, dtype, draw)
            for _ in range(cfg.num_layers))
        self.ln_enc = init_norm(cfg, dtype, draw)
        self.ln_f = init_norm(cfg, dtype, draw)
        self.lm_head = nn.Parameter(embed_init(
            generator, (cfg.d_model, cfg.vocab_size), dtype, draw))
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _remat(self) -> bool:
        return self.cfg.remat and torch.is_grad_enabled()

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """Stub-front-end encoder: frames (B, S_enc, d) -> states (B,
        S_enc, d) in the compute dtype, after ``ln_enc``.  On the card each
        block launches the flash attention once (twice in training under
        remat, and its backward once)."""
        x = frames.to(dtype_of(self.cfg.compute_dtype))
        positions = torch.arange(x.shape[1], device=x.device)
        remat = self._remat()
        for block in self.enc_blocks:
            if remat:
                x = checkpoint(enc_block, block, x, self.cfg, positions,
                               use_reentrant=False)
            else:
                x = enc_block(block, x, self.cfg, positions)
        return apply_norm(self.ln_enc, x, self.cfg)

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embed[tokens].to(dtype_of(self.cfg.compute_dtype))

    def _unembed(self, x: torch.Tensor) -> torch.Tensor:
        return apply_norm(self.ln_f, x, self.cfg) @ self.lm_head

    def encdec_forward(self, frames: torch.Tensor, tokens: torch.Tensor,
                       collect_cache: bool = False, last_only: bool = False
                       ) -> Tuple[torch.Tensor, Optional[Dict]]:
        """The teacher-forced forward: frames (B, S_enc, d), tokens (B, S)
        -> (logits (B, S, V), caches or None).  ``last_only`` unembeds
        only the last position (logits (B, 1, V)), all that prefill
        returns.  On the card it launches the flash attention
        ``encoder_layers + 2 num_layers`` times (twice that in training
        under remat, and its backward once a call)."""
        enc = self.encode(frames)
        x = self._embed(tokens)
        positions = torch.arange(x.shape[1], device=x.device)
        enc_positions = torch.arange(enc.shape[1], device=x.device)
        remat = self._remat() and not collect_cache
        caches = []
        for block in self.dec_blocks:
            if remat:
                x = checkpoint(_dec_block_out, block, x, enc, self.cfg,
                               positions, enc_positions, use_reentrant=False)
                cache = None
            else:
                x, cache = dec_block_seq(block, x, enc, self.cfg, positions,
                                         enc_positions, collect_cache)
            caches.append(cache)
        if last_only:
            x = x[:, -1:]
        logits = self._unembed(x)
        return logits, (stack_caches(caches) if collect_cache else None)

    forward = encdec_forward

    def encdec_decode_step(self, token: torch.Tensor, pos: int,
                           caches: Dict) -> Tuple[torch.Tensor, Dict]:
        """One decoder token (B,) at position ``pos`` -> (logits (B, V),
        caches): the self-attention slot ``pos`` is written in place, so
        the caches returned are the ones passed in; the cross caches are
        read whole.  No kernel launches (tensor code, as the reference's
        jnp)."""
        cfg = self.cfg
        x = self._embed(token[:, None])
        positions = torch.arange(pos, pos + 1, device=x.device)
        for layer, block in enumerate(self.dec_blocks):
            cache = cache_layer(caches, layer)
            h = apply_norm(block.ln1, x, cfg)
            q, k, v = attn.compute_qkv(block.self_attn, h, cfg, positions)
            kv = attn.cache_update(cache["kv"], k, v, pos)
            x = x + attn.project_out(block.self_attn,
                                     attn.decode_attention(q, kv, pos))
            h = apply_norm(block.ln_x, x, cfg)
            qx = attn.compute_qkv(block.cross_attn, h, cfg, positions,
                                  "q")[0]
            valid = torch.ones((1, cache["xk"].shape[1]), dtype=torch.bool,
                               device=x.device)
            acc, den, _ = attn.decode_partial(qx, cache["xk"], cache["xv"],
                                              valid)
            ctx = (acc / den.clamp_min(1e-30)[..., None])[:, None]
            x = x + attn.project_out(block.cross_attn, ctx.to(x.dtype))
            x = x + ffn_mod.apply_mlp(block.ffn,
                                      apply_norm(block.ln2, x, cfg), cfg)
        return self._unembed(x)[:, 0], caches


def init_encdec_caches(cfg, batch: int, max_len: int, enc_len: int,
                       device=DEFAULT_DEVICE) -> Dict:
    """Zero decode caches, stacked L-leading: the self-attention KV of
    horizon ``max_len`` and the cross k and v over ``enc_len`` frames."""
    require_encdec(cfg)
    dev = resolve_device(device)
    dtype = dtype_of(cfg.compute_dtype)
    shape = (batch, enc_len, cfg.num_kv_heads, cfg.hd)
    one = {"kv": attn.init_cache(cfg, batch, max_len, dtype, dev),
           "xk": torch.zeros(shape, dtype=dtype, device=dev),
           "xv": torch.zeros(shape, dtype=dtype, device=dev)}
    return broadcast_layers(one, cfg.num_layers)
