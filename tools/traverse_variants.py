#!/usr/bin/env python3
"""The ``traverse`` kernel beside variants of its design, on the card.

Captures the widest ``wavefront_fused`` level of one paper-scale query
(``make_scene(env, 524288)``, depth 7, ``scene_trajectories(25, 60)``, as
``chip_smoke.py`` phases 8-9), then runs the shipped kernel
(``src/repro_torch/kernels/traverse/csrc/traverse.cu``) and the variants of
``tools/traverse_variants.cu`` on that level's inputs at three live
prefixes: the level's own ``n_live``, 0 and the whole capacity.  Every
variant's words must equal the shipped kernel's, and those
``traverse_test_ref``'s, bit for bit.  Then each kernel's own time on the
card (``torch.profiler``, a window of ``--reps`` launches; the mean is
over the records the profiler kept, at least 10: it drops some in windows
of short kernels, and a window that lost any says how many it kept) in
``--rounds`` rounds, the kernels in turn.  An empty kernel on the
whole-capacity grid and on each fixed grid (the shipped kernel runs two
CTAs an SM) shows what a launch of that grid costs before any work;
``full_late`` is the kernel of the port's first CUDA ``traverse``.  Needs
a CUDA device and ``nvcc``; run from the root of a checkout:

    python3 tools/traverse_variants.py --env cubby
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: (name, which, CTAs an SM) of variant_launch; which 0 and 4 do no work.
VARIANTS = [("full_late", 7, 0), ("full_direct", 6, 0), ("full_dedupe", 1, 0),
            ("empty/whole-capacity grid", 0, 0)] + [
    (f"{v}/{b} CTAs an SM", w, b)
    for b in (1, 2, 4, 8)
    for v, w in (("fixed_direct", 2), ("fixed_dedupe", 3), ("fixed_spec", 5),
                 ("empty", 4))]
#: The kernel name each ``which`` launches (the profiler's key).
KEYS = {0: "tv_empty", 1: "tv_full_dedupe", 2: "tv_fixed", 3: "tv_fixed",
        4: "tv_empty", 5: "tv_spec", 6: "tv_lane", 7: "tv_late"}


def build():
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    out = ROOT / "build" / "tools"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libtraverse_variants.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
           str(lib), str(ROOT / "tools" / "traverse_variants.cu")]
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if p.returncode:
        raise SystemExit(f"FAIL: nvcc:\n{p.stdout}{p.stderr}")
    for line in (p.stdout + p.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")
    fn = ctypes.CDLL(str(lib)).variant_launch
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_void_p] * 4 + [ctypes.c_float] * 4
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_int,
                                           ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def device_ms(fn, key: str, reps: int) -> float:
    """Mean own time on the card of the kernels named ``key`` over ``reps``
    calls of ``fn`` (one launch each), after a warm-up step of the
    profiler, over the records it kept."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if key in e.key]
    n = sum(e.count for e in ev)
    if not 10 <= n <= reps:
        raise SystemExit(f"FAIL: {reps} launches, the profiler saw {n} {key}")
    if n < reps:
        print(f"[profiler] kept {n} of {reps} {key} records")
    return sum(getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
               for e in ev) / 1e3 / n


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--env", default="cubby")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("FAIL: torch sees no CUDA device")
    launch = build()
    from repro_torch.core.octree import build_octree
    from repro_torch.data.robotics import make_scene, scene_trajectories
    from repro_torch.engine.executor import CollisionEngine, EngineConfig
    from repro_torch.kernels.traverse import ops as traverse_ops
    from repro_torch.kernels.traverse.ref import traverse_test_ref

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    scene = make_scene(args.env, num_points=524288)
    tree = build_octree(scene.points, depth=7)
    obbs = scene_trajectories(scene, num_trajectories=25, waypoints=60)
    eng = CollisionEngine(tree, EngineConfig(mode="wavefront_fused"),
                          device="cuda")
    eng.query(obbs)
    calls, shipped = [], traverse_ops.traverse_test

    def record(*a, **k):
        calls.append(([x.clone() for x in a], k))
        return shipped(*a, **k)
    traverse_ops.traverse_test = record
    try:
        eng.query(obbs)
    finally:
        traverse_ops.traverse_test = shipped
    torch.cuda.synchronize()
    (obb, q_idx, codes, full, n_live), kw = max(
        calls, key=lambda c: int(c[0][4]))
    cap = q_idx.shape[0]
    print(f"[level] {args.env} wavefront_fused widest level: {int(n_live)} "
          f"live of {cap} lanes, {obb.shape[0]} OBBs | {card}")

    results = {}
    for case, nl in (("level", int(n_live)), ("n_live 0", 0),
                     ("n_live capacity", cap)):
        n_dev = torch.tensor([nl], dtype=torch.int32, device="cuda")
        ins = (obb, q_idx, codes, full, n_dev)
        want = traverse_test_ref(*ins, **kw)
        got = shipped(*ins, **kw)
        if not torch.equal(got, want):
            raise SystemExit(f"FAIL: {case}: shipped kernel != plain")
        out = torch.empty_like(got)
        assert out.data_ptr() % 16 == 0

        def variant(which, ctas):
            err = launch(which, ctas, obb.data_ptr(), obb.shape[0],
                         q_idx.data_ptr(), codes.data_ptr(), full.data_ptr(),
                         n_dev.data_ptr(), kw["cell"], *kw["lo"],
                         int(kw["is_leaf"]), cap, out.data_ptr(),
                         int(kw["use_spheres"]),
                         torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit(f"FAIL: variant {which} launch error {err}")
        for name, which, ctas in VARIANTS:
            if which in (0, 4):
                continue
            out.fill_(-1)
            variant(which, ctas)
            if not torch.equal(out, want):
                raise SystemExit(f"FAIL: {case}: {name} != shipped words")
        timed = [("shipped", lambda: shipped(*ins, **kw), "traverse_kernel")]
        timed += [(name, (lambda w=which, c=ctas: variant(w, c)),
                   KEYS[which])
                  for name, which, ctas in VARIANTS]
        res = results[case] = {name: [] for name, _, _ in timed}
        for _ in range(args.rounds):
            for name, fn, key in timed:
                res[name].append(1e3 * device_ms(fn, key, args.reps))
        for name, us in res.items():
            print(f"[{case}] {name}: " + " / ".join(f"{x:.3f}" for x in us)
                  + f" us (median {statistics.median(us):.3f})")
    print(json.dumps({"card": card, "env": args.env,
                      "n_live": int(n_live), "capacity": cap,
                      "us": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
