#!/usr/bin/env python3
"""Pixtral 12B trained at full width on one card, at each depth given:
the peak memory, or the out-of-memory error that stops it.

Each depth runs ``chip_smoke.lm_train_on_card`` at phase 29 (e)'s sizes
(``chip_smoke.MOE_VLM``: B 8 x S 4096 after 256 patch embeddings, 4
microbatches, 5 steps through ``lm/train.py``), which checks its launches,
losses and gradient norms and prints the step walls and the peak memory.
Needs a CUDA device and ``nvcc``; run from the root of a checkout:

    python3 tools/pixtral_train_depth.py 9 10
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("FAIL: torch sees no CUDA device")
    from chip_smoke import MOE_VLM, lm_train_on_card
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import _build
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    launches = {name: 0 for name in _build.SOURCES}
    for layers in (int(a) for a in sys.argv[1:] or ["9"]):
        torch.cuda.empty_cache()
        try:
            lm_train_on_card(get_config("pixtral_12b").replace(
                num_layers=layers), f"pixtral {layers} layers", dev, card,
                launches, _build.reset_launch_counts, MOE_VLM)
        except torch.cuda.OutOfMemoryError as e:
            print(f"[pixtral {layers} layers] out of memory: peak "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB "
                  f"allocated before the failed request; "
                  f"{str(e).splitlines()[0]} | {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
