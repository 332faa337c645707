"""Synthetic LM data pipeline: host-sharded, deterministic, prefetchable.

Counterpart of ``repro.data.pipeline``, line for line in numpy, so the port
trains on the reference's batches: the same ``(step, host)`` gives the same
arrays.  Batches are numpy (int32 ``tokens`` and ``labels``, the dicts of
:func:`repro_torch.models.api.batch_spec`); the trainer moves them to the
device.  Zipf-ish marginals with short-range repeats, so losses fall.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np


def _zipf_tokens(rs: np.random.RandomState, shape, vocab: int) -> np.ndarray:
    """Zipf marginal + Markov-ish repetition for learnable structure."""
    u = rs.uniform(size=shape)
    toks = np.minimum((vocab * (u ** 2.5)).astype(np.int64), vocab - 1)
    # repeat previous token with p=0.3 to create local structure
    rep = rs.uniform(size=shape) < 0.3
    toks[..., 1:] = np.where(rep[..., 1:], toks[..., :-1], toks[..., 1:])
    return toks.astype(np.int32)


def synth_batch(cfg, shape, step: int, host_index: int = 0,
                host_count: int = 1, batch_override: Optional[int] = None,
                seq_override: Optional[int] = None) -> Dict[str, np.ndarray]:
    """One (host-local) batch for `step`; deterministic in (step, host)."""
    B = batch_override or shape.global_batch
    S = seq_override or shape.seq_len
    assert B % host_count == 0
    Bl = B // host_count
    rs = np.random.RandomState((step * 1000003 + host_index * 7919) %
                               (2 ** 31 - 1))
    toks = _zipf_tokens(rs, (Bl, S + 1), cfg.vocab_size)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rs.normal(
            size=(Bl, cfg.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rs.normal(size=(Bl, S, cfg.d_model)
                                    ).astype(np.float32)
    return batch


def batch_iterator(cfg, shape, start_step: int = 0,
                   **kw) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield synth_batch(cfg, shape, step, **kw)
        step += 1
