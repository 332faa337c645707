"""LM training launcher: checkpointed, preemption-safe, straggler-tolerant.

Counterpart of ``repro.lm.train`` on one card (no mesh): the same flags
and loop, plus ``--device`` (the card unless the caller asks for the
CPU).  The default trains the architecture's smoke config, ``--full`` its
full config; the model is drawn from a generator seeded 0 on the device.
``--arch`` defaults to ``glm4_9b``, as the reference's; the attention
families' gradients (``dense``, ``moe``, ``vlm``, ``encdec``) run through the
flash-attention backward kernel, RWKV-6's through the WKV6 one.
Granite-MoE's loss adds its balance term (``moe_aux``, kept a step in
:class:`TrainResult`; 0 for a model without one); Pixtral's batches carry
their patch embeddings, Whisper-medium's (``--arch whisper_medium``, the
``encdec`` family) its frame embeddings, as long as its tokens; its full
config (0.81 B weights) trains at full width and depth on one card.
GLM-4 9B's full config (9.4 B weights, ~150 GB of weights, gradients and
moments) and Pixtral 12B's (~196 GB) do not fit one 80 GB card; a caller
trains them cut in depth, ``train(get_config("glm4_9b").replace(
num_layers=8), ...)``.

  python3 -m repro_torch.lm.train --device cuda --steps 20
  python3 -m repro_torch.lm.train --arch rwkv6_1_6b --full --device cuda \\
      --seq 1024 --microbatches 4
  python3 -m repro_torch.lm.train --arch granite_moe_1b_a400m --full \\
      --device cuda --seq 4096 --microbatches 4
  python3 -m repro_torch.lm.train --arch whisper_medium --full \\
      --device cuda --seq 1500 --microbatches 4
  ... --resume            # continue from the latest committed checkpoint

Checkpoints (``{"params": state dict, "opt": optimizer state}``) are
written every ``--ckpt-every`` steps and on preemption (SIGTERM), under
``--ckpt-dir/<config name>`` (default: a directory in the system's
temporary directory).  Batches come from :mod:`repro_torch.data.pipeline`
through a :class:`repro_torch.train.ft.PrefetchingLoader`.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Callable, List, Optional

import torch

from repro_torch.configs.base import ShapeSpec, get_config, get_smoke_config
from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.data.pipeline import batch_iterator
from repro_torch.models import api
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train import ft
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import train_loop

#: How long the end of a run waits for the last checkpoint's writer.
WRITER_TIMEOUT_S = 600.0


@dataclasses.dataclass
class TrainResult:
    model: object                 # the trained LM
    opt_state: dict
    start: int                    # first step run (after a resume)
    losses: List[float]           # a step's loss, per step run
    grad_norms: List[float]
    moe_aux: List[float]          # the last microbatch's balance term
    walls: List[float]            # a step's wall, ending in a sync
    skipped: int                  # batches the loader reused


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train(cfg, steps: int, batch: int = 8, seq: int = 64, lr: float = 3e-4,
          microbatches: int = 1, ckpt_dir: Optional[str] = None,
          ckpt_every: int = 10, resume: bool = False, log_every: int = 1,
          device=DEFAULT_DEVICE, seed: int = 0,
          log: Optional[Callable[[str], None]] = print) -> TrainResult:
    """Train ``cfg`` for steps ``[start, steps)`` (start 0, or the step
    after the latest committed checkpoint with ``resume``) on ``device``.
    A ``hybrid`` config (Hymba) raises: it serves, and trains only once
    its backward kernels land (ROADMAP A.11 step 2b)."""
    api.require_trainable(cfg)
    dev = resolve_device(device)
    shape = ShapeSpec("cli", seq, batch, "train")
    opt_cfg = opt_mod.OptConfig(lr=lr, total_steps=steps,
                                warmup_steps=max(1, steps // 10))
    step_fn = train_loop.make_train_step(cfg, opt_cfg,
                                         num_microbatches=microbatches)
    ckpt_dir = os.path.join(
        ckpt_dir or os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"),
        cfg.name)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = api.init_params(cfg, gen, device=dev)
    params = dict(model.named_parameters())
    opt_state = opt_mod.init_opt_state(params, opt_cfg)
    start = 0
    if resume:
        restored, step = ckpt_mod.restore_checkpoint(
            ckpt_dir, {"params": model.state_dict(), "opt": opt_state})
        if restored is not None:
            model.load_state_dict(restored["params"])
            opt_state = restored["opt"]
            start = step + 1
            if log:
                log(f"resumed from step {step}")

    guard = ft.PreemptionGuard().install()
    loader = ft.PrefetchingLoader(batch_iterator(cfg, shape,
                                                 start_step=start))
    writer = None
    losses, gnorms, auxes, walls = [], [], [], []
    try:
        for step in range(start, steps):
            host = loader.next_batch()
            b = {key: torch.from_numpy(x).to(dev) for key, x in host.items()}
            t0 = time.perf_counter()
            model, opt_state, metrics = step_fn(model, opt_state, b)
            loss = float(metrics["loss"])
            gnorm = float(metrics["grad_norm"])
            _sync(dev)
            walls.append(time.perf_counter() - t0)
            losses.append(loss)
            gnorms.append(gnorm)
            auxes.append(float(metrics.get("moe_aux", 0.0)))
            if log and step % log_every == 0:
                log(f"step {step} loss {loss:.4f} "
                    f"lr {float(metrics['lr']):.2e} gnorm {gnorm:.3f} "
                    f"{walls[-1] * 1e3:.0f}ms skipped={loader.skipped}")
            if (step % ckpt_every == ckpt_every - 1
                    or guard.should_checkpoint):
                writer = ckpt_mod.save_checkpoint(
                    ckpt_dir, step,
                    {"params": model.state_dict(), "opt": opt_state})
                if guard.should_checkpoint:
                    if log:
                        log("preemption: checkpointed, exiting")
                    break
    finally:
        loader.close()
        if writer is not None:
            writer.join(timeout=WRITER_TIMEOUT_S)
            if writer.is_alive():
                raise TimeoutError(f"checkpoint writer still running after "
                                   f"{WRITER_TIMEOUT_S} s")
    return TrainResult(model, opt_state, start, losses, gnorms, auxes, walls,
                       loader.skipped)


def main(argv=None) -> TrainResult:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="glm4_9b")
    ap.add_argument("--full", action="store_true",
                    help="full config (default: smoke config)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: repro_torch_ckpt in the temporary "
                         "directory")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)
    cfg = (get_config(args.arch) if args.full
           else get_smoke_config(args.arch))
    res = train(cfg, args.steps, args.batch, args.seq, args.lr,
                args.microbatches, args.ckpt_dir, args.ckpt_every,
                args.resume, args.log_every, args.device)
    print("done")
    return res


if __name__ == "__main__":
    main()
