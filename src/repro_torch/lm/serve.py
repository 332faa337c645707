"""Batched LM serving: prefill, then greedy decode on the caches.

The loop of the reference's ``examples/serve_lm.py::main`` on the card:
one prefill of the prompt batch (its last logits give the first token),
then ``num_tokens - 1`` greedy decode steps, each from the previous
step's argmax, over RWKV-6's O(1) state or the attention models' KV
caches (sized to the prefix, the prompt and the tokens decoded; under a
sliding window, Hymba's, a ring of the window's slots beside the SSM
state, whatever the horizon).  A
``vlm`` model takes its image as ``patch_embeds`` (B, ``num_patches``,
d), prepended to the prompt: its decode positions continue after both,
at ``num_patches + S + i``.  An ``encdec`` model (Whisper) takes its
audio as ``frames`` (B, S_enc, d), the stub front end's frame embeddings
of any length S_enc, which the prefill encodes once; its decoder's
positions run at ``S + i``.  The stage walls end in
``torch.cuda.synchronize()`` on the card, so they time the device's work
and not the enqueue.

    model = api.init_params(get_config("glm4_9b"),
                            torch.Generator("cuda").manual_seed(0))
    res = serve(model, prompts, num_tokens=32)      # device="cuda"
    res.tokens, res.prefill_s, res.decode_s
    serve(pixtral, prompts, 32, patch_embeds=patches)  # a vlm model
    serve(whisper, start_tokens, 32, frames=frames)    # an encdec model
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import torch

from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import api


@dataclasses.dataclass
class ServeResult:
    tokens: torch.Tensor          # (B, num_tokens) int64, greedy picks
    logits: torch.Tensor          # (B, V) logits of the last step
    caches: Dict                  # decode state after the last step
    prefill_s: float              # wall of the prefill
    decode_s: List[float]         # wall of each decode step


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(model, prompts, num_tokens: int, device=DEFAULT_DEVICE,
          patch_embeds: Optional[torch.Tensor] = None,
          frames: Optional[torch.Tensor] = None) -> ServeResult:
    """Prefill ``prompts`` (B, S) token ids, after ``patch_embeds`` (B, P,
    d) for a ``vlm`` model, or against ``frames`` (B, S_enc, d) for an
    ``encdec`` model (each required there and refused elsewhere), and
    decode ``num_tokens`` greedy tokens on ``device`` (the card unless the
    caller asks for the CPU; with no card it raises).  ``model`` must
    already lie on that device."""
    dev = resolve_device(device)
    if model.device.type != dev.type:
        raise ValueError(f"model is on {model.device}, serving on {dev}")
    if num_tokens < 1:
        raise ValueError(f"num_tokens must be >= 1, got {num_tokens}")
    cfg = model.cfg
    tokens = torch.as_tensor(prompts, dtype=torch.int64).to(model.device)
    B, S = tokens.shape
    batch = {"tokens": tokens}
    if cfg.family == "vlm":
        want = (B, cfg.num_patches, cfg.d_model)
        got = None if patch_embeds is None else tuple(patch_embeds.shape)
        if got != want:
            raise ValueError(f"{cfg.name} serves with patch_embeds of shape "
                             f"{want}, got {got}")
        batch["patch_embeds"] = torch.as_tensor(patch_embeds).to(
            model.device)
    elif patch_embeds is not None:
        raise ValueError(f"{cfg.name} (family {cfg.family!r}) takes no "
                         "patch_embeds")
    if cfg.family == "encdec":
        got = None if frames is None else tuple(frames.shape)
        if not (got and len(got) == 3 and got[0] == B and got[1] >= 1
                and got[2] == cfg.d_model):
            raise ValueError(f"{cfg.name} serves with frames of shape ({B}, "
                             f"S_enc, {cfg.d_model}), got {got}")
        batch["frames"] = torch.as_tensor(frames).to(model.device)
    elif frames is not None:
        raise ValueError(f"{cfg.name} (family {cfg.family!r}) takes no "
                         "frames")
    start = S + (cfg.num_patches if cfg.family == "vlm" else 0)
    prefill = api.make_prefill_fn(cfg, max_len=start + num_tokens)
    decode = api.make_decode_fn(cfg)

    _sync(dev)
    t0 = time.perf_counter()
    logits, caches = prefill(model, batch)
    tok = logits.argmax(-1)
    _sync(dev)
    prefill_s = time.perf_counter() - t0

    out, decode_s = [tok], []
    for i in range(num_tokens - 1):
        t0 = time.perf_counter()
        logits, caches = decode(model, tok, start + i, caches)
        tok = logits.argmax(-1)
        _sync(dev)
        decode_s.append(time.perf_counter() - t0)
        out.append(tok)
    return ServeResult(tokens=torch.stack(out, 1), logits=logits,
                       caches=caches, prefill_s=prefill_s, decode_s=decode_s)
