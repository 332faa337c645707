"""Decoder-only LM assembly: prefill and decode (``attn``, ``hybrid`` and
``rwkv`` blocks).

Counterpart of ``repro.models.transformer`` for the ``attn`` block type
(pre-norm GQA attention + an FFN: dense in the ``dense`` and ``vlm``
families, the capacity-factor MoE in ``moe``), the ``hybrid`` block
(Hymba: attention, with its sliding window, and the selective-scan SSM
branch of :mod:`repro_torch.models.ssm` side by side on the same normed
input, their mean in the compute dtype, then the FFN) and the
attention-free RWKV-6 stack (``rwkv``, the ``ssm`` family): an embedding, ``num_layers``
blocks in an ``nn.ModuleList`` (the reference stacks them on a leading L
axis for ``lax.scan``; here a Python loop runs them), the final norm and
an untied ``lm_head``.  The ``vlm`` family prepends precomputed patch
embeddings (``prefix_embeds``) to the token embeddings; positions run over
the whole sequence.  The MoE's balance term is summed over the layers, as
the reference's scan carries it.  Under ``cfg.remat`` and grad mode each
block runs through ``torch.utils.checkpoint`` (non-reentrant), as the
reference remats each scanned layer: its activations (and its balance
term) are recomputed in the backward, its kernel launched a second time
(the WKV6 recurrence, or the flash attention with its rows' log-sum-exp),
and then its backward kernel once.  The ``hybrid`` block serves only: its
scan and its windowed attention have no backward kernel yet (ROADMAP A.11
step 2b).  Tied embeddings and the sharding hints are not ported (ROADMAP
A.11); the ``encdec`` family is :mod:`repro_torch.models.encdec`'s, which
shares this module's cache helpers.

Decode caches keep the reference's layout, stacked L-leading:
``{"kv": {"k": (L, B, T, K, hd), "v": ...}}`` for ``attn`` (T the decode
horizon, or under a sliding window a ring of ``min(T, window)`` slots; a
step writes its slot in place, see
:func:`repro_torch.models.attention.cache_update`), the same plus ``"ssm":
(L, B, di, n)`` fp32 for ``hybrid`` (a step writes each layer's state in
place too) and ``{"wkv": (L, B,
H, D, D) fp32, "tm_shift": (L, B, d), "cm_shift": (L, B, d)}`` for
``rwkv``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (apply_norm, draw_device, dtype_of,
                                       embed_init, init_norm)

#: Model families the decoder-only :class:`LM` builds (``encdec`` is
#: :class:`repro_torch.models.encdec.EncDec`'s).
PORTED_FAMILIES = ("dense", "ssm", "moe", "vlm", "hybrid")


def require_ported(cfg) -> None:
    """Raise for a config the decoder-only :class:`LM` cannot build: the
    ``encdec`` family, which ``models/encdec.py::EncDec`` builds, and what
    the port lacks yet (ROADMAP A.11)."""
    if cfg.family == "encdec":
        raise NotImplementedError(
            f"{cfg.name}: family 'encdec' is no decoder-only LM; "
            "models/encdec.py::EncDec builds it (api.init_params picks it)")
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet (ROADMAP "
            f"A.11); the port runs {', '.join(PORTED_FAMILIES)} and encdec")
    require_options_ported(cfg)


def require_options_ported(cfg) -> None:
    """Raise for the option the port lacks yet (ROADMAP A.11): tied
    embeddings."""
    if cfg.tie_embeddings:
        raise NotImplementedError(f"{cfg.name}: tied embeddings are not "
                                  "ported yet (ROADMAP A.11)")


class AttnBlock(nn.Module):
    """The reference's ``init_block`` for ``block_type == "attn"``:
    ``ln1``, ``attn``, ``ln2``, ``ffn``, drawn in that order."""

    def __init__(self, cfg, generator: Optional[torch.Generator], dtype,
                 device=None):
        super().__init__()
        dev = draw_device(generator, device)
        self.ln1 = init_norm(cfg, dtype, dev)
        self.attn = attn.init_attention(cfg, generator, dtype, dev)
        self.ln2 = init_norm(cfg, dtype, dev)
        self.ffn = ffn_mod.init_ffn(cfg, generator, dtype, dev)


class HybridBlock(AttnBlock):
    """The reference's ``init_block`` for ``block_type == "hybrid"``: the
    attention block's ``ln1``, ``attn``, ``ln2``, ``ffn``, then ``ssm``."""

    def __init__(self, cfg, generator: Optional[torch.Generator], dtype,
                 device=None):
        super().__init__(cfg, generator, dtype, device)
        self.ssm = ssm_mod.init_ssm(cfg, generator, dtype,
                                    draw_device(generator, device))


def block_seq(block, x: torch.Tensor, cfg, positions: torch.Tensor,
              collect_cache: bool):
    """One block over a full sequence: (x, aux, cache or None); ``aux`` the
    MoE's balance term, a Python 0.0 for the other blocks."""
    if cfg.block_type == "rwkv":
        x, state = block(x)
        return x, 0.0, (state if collect_cache else None)
    h = apply_norm(block.ln1, x, cfg)
    q, k, v = attn.compute_qkv(block.attn, h, cfg, positions)
    ctx = attn.attention_ctx(q, k, v, cfg, causal=True)
    branch = attn.project_out(block.attn, ctx)
    cache = {"kv": _cache_from_prefill(k, v, cfg)} if collect_cache else None
    if cfg.block_type == "hybrid":
        ssm_out, state = ssm_mod.ssm_scan(block.ssm, h, cfg)
        branch = 0.5 * (branch + ssm_out)
        if collect_cache:
            cache["ssm"] = state
    x = x + branch
    y, aux = ffn_mod.apply_ffn(block.ffn, apply_norm(block.ln2, x, cfg), cfg)
    return x + y, aux, cache


def _cache_from_prefill(k: torch.Tensor, v: torch.Tensor, cfg) -> Dict:
    """(B, S, K, hd) prefill keys and values -> the decode cache layout:
    as they are, or under a sliding window w < S the last w rolled by ``S
    % w``, so position p sits at ring slot ``p % w`` (the slot rule of
    :func:`repro_torch.models.attention.cache_update`)."""
    S, w = k.shape[1], cfg.sliding_window
    if w and S > w:
        k = torch.roll(k[:, -w:], S % w, dims=1)
        v = torch.roll(v[:, -w:], S % w, dims=1)
    return {"k": k, "v": v}


def block_decode(block, x: torch.Tensor, cfg, pos: int,
                 positions: torch.Tensor, cache: Dict
                 ) -> Tuple[torch.Tensor, Dict]:
    """One block, one token: x (B, 1, d) at position ``pos`` (``positions``
    the same as a (1,) tensor on x's device) -> (x, new cache).  The MoE's
    balance term is dropped, as the reference's ``block_decode`` drops it:
    decode has no loss."""
    if cfg.block_type == "rwkv":
        return block(x, cache)
    h = apply_norm(block.ln1, x, cfg)
    q, k, v = attn.compute_qkv(block.attn, h, cfg, positions)
    kv = attn.cache_update(cache["kv"], k, v, pos, cfg)
    ctx = attn.decode_attention(q, kv, pos, cfg)
    branch = attn.project_out(block.attn, ctx)
    new = {"kv": kv}
    if cfg.block_type == "hybrid":
        ssm_out, new["ssm"] = ssm_mod.ssm_step(block.ssm, h, cache["ssm"],
                                               cfg)
        branch = 0.5 * (branch + ssm_out)
    x = x + branch
    y, _ = ffn_mod.apply_ffn(block.ffn, apply_norm(block.ln2, x, cfg), cfg)
    return x + y, new


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
        block = {"rwkv": rwkv_mod.RWKVBlock, "hybrid": HybridBlock,
                 "attn": AttnBlock}[cfg.block_type]
        self.cfg = cfg
        self.embed = nn.Parameter(embed_init(
            generator, (cfg.vocab_size, cfg.d_model), dtype, draw))
        self.blocks = nn.ModuleList(block(cfg, generator, dtype, draw)
                                    for _ in range(cfg.num_layers))
        self.ln_f = init_norm(cfg, dtype, draw)
        self.lm_head = nn.Parameter(embed_init(
            generator, (cfg.d_model, cfg.vocab_size), dtype, draw))
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _embed(self, tokens: torch.Tensor,
               prefix_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Token embeddings, after ``prefix_embeds`` (B, P, d) where given
        (cast to the embedding's dtype first, as the reference's
        ``_embed``), in the compute dtype."""
        x = self.embed[tokens]
        if prefix_embeds is not None:
            x = torch.cat([prefix_embeds.to(x.dtype), x], 1)
        return x.to(dtype_of(self.cfg.compute_dtype))

    def _unembed(self, x: torch.Tensor) -> torch.Tensor:
        return apply_norm(self.ln_f, x, self.cfg) @ self.lm_head

    def lm_forward(self, tokens: torch.Tensor,
                   prefix_embeds: Optional[torch.Tensor] = None,
                   collect_cache: bool = False, last_only: bool = False,
                   with_aux: bool = False):
        """tokens (B, S), after ``prefix_embeds`` (B, P, d) for the ``vlm``
        family -> (logits (B, P + S, V), caches or None), or with
        ``with_aux`` the reference's ``(logits, aux, caches)``: ``aux`` is
        the MoE balance term summed over the layers (fp32; 0 without
        experts).

        ``last_only`` unembeds only the last position (logits (B, 1, V)),
        all that prefill returns.  On the card every block runs one kernel
        launch: the WKV6 recurrence (``rwkv``) or the flash attention
        (``attn``); in training under ``cfg.remat``, two, and its backward
        kernel one.
        """
        x = self._embed(tokens, prefix_embeds)
        positions = torch.arange(x.shape[1], device=x.device)
        remat = (self.cfg.remat and torch.is_grad_enabled()
                 and not collect_cache)
        caches, aux = [], 0.0
        for block in self.blocks:
            if remat:
                x, a = checkpoint(_block_out, block, x, self.cfg, positions,
                                  use_reentrant=False)
                cache = None
            else:
                x, a, cache = block_seq(block, x, self.cfg, positions,
                                        collect_cache)
            aux = aux + a
            caches.append(cache)
        if last_only:
            x = x[:, -1:]
        logits = self._unembed(x)
        caches = stack_caches(caches) if collect_cache else None
        if with_aux:
            aux = torch.as_tensor(aux, dtype=torch.float32, device=x.device)
            return logits, aux, caches
        return logits, caches

    forward = lm_forward

    def lm_decode_step(self, token: torch.Tensor, pos: int, caches: Dict
                       ) -> Tuple[torch.Tensor, Dict]:
        """token (B,) at position ``pos`` -> (logits (B, V), new caches).
        The RWKV blocks ignore ``pos`` (their state carries the position),
        as in the reference; the attention blocks write their KV slot in
        place, and the hybrid blocks their SSM state too, so the caches
        returned are the ones passed in."""
        x = self._embed(token[:, None])
        positions = torch.arange(pos, pos + 1, device=x.device)
        new = []
        for layer, block in enumerate(self.blocks):
            x, cache = block_decode(block, x, self.cfg, pos, positions,
                                    cache_layer(caches, layer))
            if self.cfg.block_type == "hybrid":
                caches["ssm"][layer].copy_(cache["ssm"])
            new.append(cache)
        logits = self._unembed(x)[:, 0]
        return logits, (stack_caches(new) if self.cfg.block_type == "rwkv"
                        else caches)


def _block_out(block, x: torch.Tensor, cfg, positions: torch.Tensor):
    """One block's output and balance term over a full sequence (the remat
    body)."""
    return block_seq(block, x, cfg, positions, False)[:2]


def cache_layer(tree: Dict, layer: int) -> Dict:
    """Layer ``layer``'s caches: views of the stacked tensors."""
    return {key: (cache_layer(val, layer) if isinstance(val, dict)
                  else val[layer]) for key, val in tree.items()}


def stack_caches(caches) -> Dict:
    """Per-layer cache dicts -> one dict of L-leading stacked tensors."""
    first = caches[0]
    return {key: (stack_caches([c[key] for c in caches])
                  if isinstance(first[key], dict)
                  else torch.stack([c[key] for c in caches]))
            for key in first}


def init_decode_caches(cfg, batch: int, max_len: Optional[int] = None,
                       device=DEFAULT_DEVICE) -> Dict:
    """Zero decode caches, stacked L-leading.  ``max_len`` is the KV
    horizon of the attention caches (a ring of ``min(max_len, window)``
    slots under a sliding window); RWKV's O(1) state needs none; a hybrid
    model's adds its fp32 SSM state (B, di, n)."""
    require_ported(cfg)
    dev = resolve_device(device)
    dtype = dtype_of(cfg.compute_dtype)
    if cfg.block_type == "rwkv":
        one = rwkv_mod.init_rwkv_state(cfg, batch, dtype, dev)
    elif max_len is None:
        raise ValueError(f"{cfg.name}: attention caches need a max_len")
    else:
        one = {"kv": attn.init_cache(cfg, batch, max_len, dtype, dev)}
        if cfg.block_type == "hybrid":
            one["ssm"] = torch.zeros(
                (batch, ssm_mod.inner_width(cfg), cfg.ssm_state),
                dtype=torch.float32, device=dev)
    return broadcast_layers(one, cfg.num_layers)


def broadcast_layers(tree: Dict, L: int) -> Dict:
    return {key: (broadcast_layers(val, L) if isinstance(val, dict)
                  else val[None].expand((L,) + val.shape).contiguous())
            for key, val in tree.items()}
