#!/usr/bin/env python3
"""The ``persist`` kernel of this tree beside another tree's, in turns, on
``fig_bigscene``'s full-scale scenes, on the card.

The scenes are ``chip_smoke.py`` phase 23's: depth 8, 524,288 and
3,145,728 points uniform in [-1, 1]^3 from numpy ``RandomState(5)``,
1,500 OBBs from ``random_obbs`` (seed 11).  For each (scene, layout,
format) below, a ``wavefront_persistent`` engine with that pin gives the
device tree and the clean capacity; its query is packed as the engine
packs it, and each kernel's outputs must equal ``persist_tiles_ref``'s.
Then both kernels run in turns (this, other, other, this) ``--rounds``
times, CUDA events around one launch each, and the medians are printed.

``--other-src`` names another tree's ``src`` (e.g. the parent commit
unpacked under ``build/``): its ``persist.cu`` is built under
``build/tools`` and launched through this tree's wrapper, so its C
interface must be this tree's.  Needs a CUDA device and ``nvcc``; run
from the root of a checkout:

    python3 tools/persist_bigscene_ab.py --other-src build/parent/src
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
#: (scene, layout, row format) of the runs: the default engine's choices
#: (small resident bf16, big streamed bf16), the big scene's rows resident,
#: and u8 streamed on the small scene.
RUNS = [("small", "resident", "bf16"), ("small", "streamed", "u8"),
        ("big", "streamed", "bf16"), ("big", "resident", "bf16")]


def build_other(src: Path) -> ctypes.CDLL:
    from repro_torch.kernels import _build
    out = ROOT / "build" / "tools" / _build._source_hash() / "ab"
    out.mkdir(parents=True, exist_ok=True)
    cu = (src / "repro_torch" / _build.SOURCES["persist"]).resolve()
    lib = out / "libpersist_other.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)]
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if p.returncode:
        raise SystemExit(f"FAIL: nvcc {cu}:\n{p.stdout}{p.stderr}")
    return ctypes.CDLL(str(lib))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other-src", required=True)
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("FAIL: torch sees no CUDA device")
    from repro_torch.core.geometry import random_obbs
    from repro_torch.core.octree import build_octree
    from repro_torch.engine.executor import CollisionEngine, EngineConfig
    from repro_torch.kernels import _build
    from repro_torch.kernels.persist import ops as persist_ops
    from repro_torch.kernels.persist.ref import persist_tiles_ref

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    libs = {"this": _build.load("persist"),
            "other": build_other(Path(args.other_src).resolve())}
    cuda = torch.device("cuda", 0)
    rs = np.random.RandomState(5)
    trees = {}
    for tag, n_pts in (("small", 524288), ("big", 6 * 524288)):
        pts = rs.uniform(-1, 1, (n_pts, 3)).astype(np.float32)
        trees[tag] = build_octree(pts, depth=8,
                                  scene_lo=np.full(3, -1.0, np.float32),
                                  scene_size=2.0)
    obbs = random_obbs(torch.Generator().manual_seed(11), 1500)

    def timed(ins, kw):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        persist_ops.persist_tiles(**ins, **kw)
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b)

    for tag, layout, fmt in RUNS:
        tree = trees[tag]
        eng = CollisionEngine(tree, EngineConfig(
            mode="wavefront_persistent", max_frontier=1 << 24,
            stream_meta=layout == "streamed", meta_format=fmt), device="cuda")
        eng.query(obbs)
        dev = eng.device_tree
        ins = persist_ops.pack_kernel_inputs(
            obbs.center.to(cuda), obbs.half.to(cuda), obbs.rot.to(cuda), dev,
            persist_ops.DEFAULT_BQ)
        kw = dict(bq=persist_ops.DEFAULT_BQ, fcap=eng.last_capacity,
                  depth=tree.depth, ring_cap=persist_ops.DEFAULT_RING_CAP,
                  use_spheres=False, meta_format=fmt,
                  streamed=layout == "streamed")
        want = persist_tiles_ref(**ins, **kw)
        for name, lib in libs.items():
            _build._LIBS["persist"] = lib
            got = persist_ops.persist_tiles(**ins, **kw)
            if any(not torch.equal(g, w) for g, w in zip(got[:4], want[:4])):
                raise SystemExit(f"FAIL: {tag} {layout} {fmt}: the {name} "
                                 f"kernel differs from the plain version")
            timed(ins, kw)   # warm
        ms = {name: [] for name in libs}
        for _ in range(args.rounds):
            for name in ("this", "other", "other", "this"):
                _build._LIBS["persist"] = libs[name]
                ms[name].append(timed(ins, kw))
        _build._LIBS["persist"] = libs["this"]
        med = {n: statistics.median(v) for n, v in ms.items()}
        print(f"[ab] {tag} scene, {layout} {fmt} rows, capacity "
              f"{kw['fcap']}: == plain; kernel by events, median of "
              f"{2 * args.rounds}: this tree {med['this']:.4f} ms, other "
              f"{med['other']:.4f} ms ({100 * (med['this'] / med['other'] - 1):+.2f} %); "
              f"this {[round(x, 4) for x in ms['this']]}, other "
              f"{[round(x, 4) for x in ms['other']]} | {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
