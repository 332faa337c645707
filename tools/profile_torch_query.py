#!/usr/bin/env python3
"""Where a warm paper-scale collision query spends its time on the card.

Builds one Table III environment at paper scale (524,288 points, depth 7,
``scene_trajectories(25, 60)`` = 10,500 link OBBs), warms a CUDA
``CollisionEngine`` in ``--mode`` (``wavefront_persistent``, the default,
or one of the per-level arms ``wavefront`` and ``wavefront_fused``), then
traces ``--reps`` warm queries with ``torch.profiler`` and prints: the
wall time per query, the summed device time of every CUDA kernel and copy
(and so the card's busy and idle share of the wall time), and the ops with
the most host time.  Needs a CUDA device; run from the root of a checkout:

    python3 tools/profile_torch_query.py --env cubby --mode wavefront_fused
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--env", default="cubby")
    ap.add_argument("--mode", default="wavefront_persistent",
                    choices=("wavefront_persistent", "wavefront",
                             "wavefront_fused"))
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("FAIL: torch sees no CUDA device")
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.octree import build_octree
    from repro_torch.data.robotics import make_scene, scene_trajectories
    from repro_torch.engine.executor import CollisionEngine, EngineConfig

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    scene = make_scene(args.env, num_points=524288)
    tree = build_octree(scene.points, depth=7)
    obbs = scene_trajectories(scene, num_trajectories=25, waypoints=60)
    eng = CollisionEngine(tree, EngineConfig(mode=args.mode))
    for _ in range(3):
        eng.query(obbs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.reps):
            eng.query(obbs)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / args.reps
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    # Kernels and copies are the events that ran on the card; host ops
    # that launched them repeat their device time, so they are left out.
    on_card = [e for e in events if e.device_type == DeviceType.CUDA]
    device_us = sum(dev_us(e) for e in on_card) / args.reps
    print(f"{args.env} {args.mode}: {card} | traced wall per query "
          f"{1e3 * wall:.3f} ms "
          f"| device time per query {device_us / 1e3:.3f} ms | device busy "
          f"{100 * device_us / 1e6 / wall:.1f} % of wall | "
          f"{sum(e.count for e in on_card) // args.reps} kernels and copies "
          f"per query")
    print("device time per query by kernel/copy (ms):")
    for e in sorted(on_card, key=dev_us, reverse=True)[:12]:
        if dev_us(e) > 0:
            print(f"  {dev_us(e) / 1e3 / args.reps:9.4f}  "
                  f"x{e.count // args.reps:<4d} {e.key[:90]}")
    print("host time per query by op (self CPU, ms):")
    for e in sorted(events, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:12]:
        print(f"  {e.self_cpu_time_total / 1e3 / args.reps:9.4f}  "
              f"x{e.count // args.reps:<4d} {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
