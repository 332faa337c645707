#!/usr/bin/env python3
"""The LM serves' busy shares under both profiler settings, side by side,
on the card.

``chip_smoke.py``'s LM serves (phases 17, 20, 28 (d) and 29) trace the
card's activity alone.  Recording the host's operators as well (CPU and
CUDA activities) lengthens the traced wall, and so lowers the busy share
(device time over traced wall) that the serves report.  For RWKV-6 1.6B,
GLM-4 9B and StarCoder2 7B on 8 of its 32 layers (the sizes those phases
serve: full width, weights drawn on the card from seed 0, ``LM_BATCH``
prompts of ``LM_PROMPT`` tokens from ``RandomState(0)``, a traced serve
of ``LM_TRACED_TOKENS`` greedy tokens), this warms each serve up once,
then runs
``chip_smoke.traced_serves`` with the card's activity alone and with the
host's too, and prints each setting's prefill and decode busy shares and
traced walls.  Needs a CUDA device and ``nvcc``; run from the root of a
checkout:

    python3 tools/serve_trace_modes.py
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
#: (architecture, layers served; 0 for the config's own)
MODELS = [("rwkv6_1_6b", 0), ("glm4_9b", 0), ("starcoder2_7b", 8)]


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("FAIL: torch sees no CUDA device")
    from chip_smoke import (LM_BATCH, LM_PROMPT, LM_TRACED_TOKENS,
                            traced_serves)
    from repro_torch.configs.base import get_config
    from repro_torch.lm.serve import serve
    from repro_torch.models import api as lm_api
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cuda = torch.device("cuda")
    for arch, layers in MODELS:
        cfg = get_config(arch)
        if layers:
            cfg = cfg.replace(num_layers=layers)
        lm = lm_api.init_params(cfg,
                                torch.Generator(device=cuda).manual_seed(0),
                                device=cuda)
        prompts = np.random.RandomState(0).randint(
            0, cfg.vocab_size, (LM_BATCH, LM_PROMPT))

        def serve_n(n: int):
            return serve(lm, prompts, n)
        serve_n(2)                                           # warm-up
        for host in (False, True):
            t0 = time.perf_counter()
            (w_pre, d_pre, _, _), (w_all, d_all, _, _) = traced_serves(
                serve_n, host)
            print(f"{arch} ({cfg.num_layers} layers), "
                  f"{'CPU and CUDA' if host else 'CUDA alone'} traced: "
                  f"prefill wall {1e3 * w_pre:.3f} ms, device "
                  f"{1e3 * d_pre:.3f} ms (busy {100 * d_pre / w_pre:.1f} %)"
                  f" | {LM_TRACED_TOKENS - 1} decode steps wall "
                  f"{1e3 * (w_all - w_pre):.3f} ms, device "
                  f"{1e3 * (d_all - d_pre):.3f} ms (busy "
                  f"{100 * (d_all - d_pre) / (w_all - w_pre):.1f} %) | the "
                  f"two traced serves and their gathering "
                  f"{time.perf_counter() - t0:.1f} s | {card}", flush=True)
        del lm
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
