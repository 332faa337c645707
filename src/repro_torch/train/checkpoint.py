"""Fault-tolerant checkpointing: async, atomic, keep-k.

Counterpart of ``repro.train.checkpoint`` with its on-disk layout: one
directory a step, one ``.npy`` a leaf (the leaf's path of keys joined by
``::``) and ``meta.json``; the directory is written as
``step_XXXXXXXX.tmp``, renamed, then marked ``COMMITTED``, so a partial
checkpoint (a crash mid-save) is invisible to restore; ``keep_last_k``
removes older steps after each commit.  A tree here is nested dicts of
tensors (a model's ``state_dict()``, an optimizer state of
:mod:`repro_torch.train.optimizer`).  bf16 tensors are stored as their
16-bit patterns (numpy has no bfloat16, as ``convert._tensor`` reads
them), every other dtype as itself; restore casts each leaf to the
like-tree's dtype and places it on the caller's device.  The save copies
every leaf to the host first, so the train loop blocks only for that copy;
the files are written on a thread.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Dict, Mapping, Optional

import numpy as np
import torch

_SEP = "::"


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(_flatten(val, path + _SEP))
        else:
            out[path] = val
    return out


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = torch.as_tensor(t).detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _file(d: str, key: str) -> str:
    return os.path.join(d, key.replace("/", "_") + ".npy")


def save_checkpoint(ckpt_dir: str, step: int, tree: Mapping,
                    extra_meta: Optional[Dict] = None,
                    async_save: bool = True,
                    keep_last_k: int = 3) -> Optional[threading.Thread]:
    """Write checkpoint for `step`.  Returns the writer thread if async."""
    host = {k: _to_numpy(v) for k, v in _flatten(tree).items()}
    meta = {"step": int(step), "keys": sorted(host), "time": time.time(),
            **(extra_meta or {})}

    def write():
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        for k, v in host.items():
            np.save(_file(tmp, k), v)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        with open(os.path.join(final, "COMMITTED"), "w") as f:
            f.write(str(step))
        _gc(ckpt_dir, keep_last_k)

    if async_save:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        return t
    write()
    return None


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = latest_steps(ckpt_dir)
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def latest_steps(ckpt_dir: str):
    """The committed steps under ``ckpt_dir``, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        full = os.path.join(ckpt_dir, name)
        if (name.startswith("step_") and not name.endswith(".tmp")
                and os.path.exists(os.path.join(full, "COMMITTED"))):
            out.append(int(name[5:]))
    return sorted(out)


def _leaf(arr: np.ndarray, like: torch.Tensor, device) -> torch.Tensor:
    if like.dtype == torch.bfloat16:
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=like.device if device is None else device,
                dtype=like.dtype)


def restore_checkpoint(ckpt_dir: str, like_tree: Mapping,
                       step: Optional[int] = None, device=None):
    """Restore into the structure and dtypes of ``like_tree`` (its leaves'
    shapes are checked), each leaf on ``device`` (default: the like leaf's
    own device).  Returns ``(tree, step)``, or ``(None, -1)`` if no
    committed checkpoint exists."""
    steps = latest_steps(ckpt_dir)
    if not steps:
        return None, -1
    step = step if step is not None else steps[-1]
    d = os.path.join(ckpt_dir, f"step_{step:08d}")

    def build(tree: Mapping, prefix: str = ""):
        out = {}
        for key, like in tree.items():
            path = f"{prefix}{key}"
            if isinstance(like, Mapping):
                out[key] = build(like, path + _SEP)
                continue
            arr = np.load(_file(d, path))
            if tuple(arr.shape) != tuple(like.shape):
                raise ValueError(f"checkpoint {path}: shape {arr.shape}, "
                                 f"want {tuple(like.shape)}")
            out[key] = _leaf(arr, like, device)
        return out
    return build(like_tree), step
