#!/usr/bin/env python3
"""The ``persist`` and ``fps`` kernels at the main paths' shapes, and their
design's variants, timed on the card.

``persist``: for each environment, the paper-scale query of
``chip_smoke.py`` phase 8 (``make_scene(env, 524288)``, depth 7,
``scene_trajectories(25, 60)`` = 10,500 OBBs, the capacity a warm
``wavefront_persistent`` engine settles on), packed as the engine packs
it; the kernel's outputs must equal ``persist_tiles_ref``'s.  ``fps``: sa1
of the batched encode (32 tabletop clouds of 2048 points drawn as
``chip_smoke.py`` phase 13 draws them, m = 256); the indices must equal
``fps_ref``'s.  Each kernel is timed alone (``torch.profiler``, a window
of 20 launches, exactly one record a launch, as
``chip_smoke.py::kernel_device_ms``) and as a call (CUDA events around
back-to-back calls), and the heaviest and mean tile's nodes are printed.

With ``--variants``, copies of ``persist.cu`` with other cluster sizes
and threads a CTA (its ``kCluster`` and ``kThreads`` rewritten, written
under ``build/tools``; every variant's outputs must equal the shipped
kernel's) are also built, and ``fps`` run at other threads a block (the
wrapper's ``threads_for`` replaced; at 128 threads sa1's 2,048 points
take the instance of 16 points a thread), and each is timed alone in two
rounds, the kernels in turn.

With ``--trace``, ``tools/persist_trace.cu`` (the shipped kernel with its
phase marks defined) runs each query once more and the heaviest tile's
levels are broken down: the lanes of each level, then, in microseconds
on rank 0's thread 0, phase A (its run), the wait at the fold barrier,
the gate and the ranks' totals, the count and scan, the children's
stores and the wait at the level's last barrier; and the heaviest tile's
start and end within the launch.

``--src`` names another tree's ``src`` (e.g. the parent commit unpacked
under ``build/``), whose kernels are then timed instead: run both trees
in one call to compare them on one card.  Needs a CUDA device and
``nvcc``; run from the root of a checkout:

    PYTHONHASHSEED=0 python3 tools/persist_fps_variants.py --variants
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: (CTAs a cluster, threads a CTA) of the persist variants.
PERSIST_VARIANTS = [(1, 512), (2, 512), (4, 256), (4, 384), (4, 512),
                    (8, 256)]
FPS_THREADS = [128, 256, 512]
ENVS = ("cubby", "dresser", "merged_cubby", "tabletop")
#: Launches a profiled window, and rounds of all the kernels in turn.
REPS, ROUNDS = 20, 2


def build_persist_variants(src: Path):
    """Build a copy of ``persist.cu`` per variant, its ``kCluster`` and
    ``kThreads`` rewritten, all in parallel; returns
    {(cluster, threads): CDLL}."""
    import re
    from repro_torch.kernels import _build
    out = ROOT / "build" / "tools" / _build._source_hash()
    out.mkdir(parents=True, exist_ok=True)
    cu = src / "repro_torch" / _build.SOURCES["persist"]
    text = cu.read_text()

    def one(v):
        c, t = v
        body = text
        for name, val in (("kCluster", c), ("kThreads", t)):
            body, n = re.subn(rf"constexpr int {name} = \d+;",
                              f"constexpr int {name} = {val};", body)
            if n != 1:
                raise SystemExit(f"FAIL: {cu} has no one {name} constant")
        copy = out / f"persist_c{c}_t{t}.cu"
        copy.write_text(body)
        lib = out / f"libpersist_c{c}_t{t}.so"
        # -I: the copy's relative includes resolve from the source's folder
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
               "-I", str(cu.parent), "-o", str(lib), str(copy)]
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        if p.returncode:
            raise SystemExit(f"FAIL: nvcc {v}:\n{p.stdout}{p.stderr}")
        for line in (p.stdout + p.stderr).splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] persist C={c} T={t}: {line.strip()}")
        return ctypes.CDLL(str(lib))
    with ThreadPoolExecutor(len(PERSIST_VARIANTS)) as ex:
        libs = list(ex.map(one, PERSIST_VARIANTS))
    return dict(zip(PERSIST_VARIANTS, libs))


def build_trace():
    from repro_torch.kernels import _build
    out = ROOT / "build" / "tools" / _build._source_hash()
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libpersist_trace.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
           str(ROOT / "tools" / "persist_trace.cu")]
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if p.returncode:
        raise SystemExit(f"FAIL: nvcc trace:\n{p.stdout}{p.stderr}")
    return ctypes.CDLL(str(lib))


def print_trace(env, lib, run, want, cluster):
    """Run the traced kernel once and print the heaviest tile's levels."""
    import numpy as np
    import torch
    lib.persist_trace_clear()
    got = run(lib)
    for x, y in zip(got, want):
        if not torch.equal(x, y):
            raise SystemExit(f"FAIL: {env} traced persist != plain")
    torch.cuda.synchronize()
    T, L = want[1].shape
    n = T * cluster * 16 * 8
    clk = np.zeros(n, np.int64)
    tmr = np.zeros(n, np.uint64)
    err = lib.persist_trace_read(clk.ctypes.data, tmr.ctypes.data, n)
    if err:
        raise SystemExit(f"FAIL: trace read error {err}")
    clk = clk.reshape(T, cluster, 16, 8)
    tmr = tmr.reshape(T, cluster, 16, 8).astype(np.float64)
    t = int(want[3][:, 0].argmax())
    c0 = clk[t, 0]
    ghz = (c0[15, 7] - c0[0, 0]) / (tmr[t, 0, 15, 7] - tmr[t, 0, 0, 0])
    us = lambda cyc: cyc / ghz / 1e3  # noqa: E731
    t0 = tmr[:, :, 0, 0].min()
    print(f"[trace] {env}: heaviest tile {t} ({int(want[3][t, 0])} nodes), "
          f"SM clock {ghz:.3f} GHz; its start {1e-3 * (tmr[t, 0, 0, 0] - t0):.2f}"
          f" us and end {1e-3 * (tmr[t, 0, 15, 7] - t0):.2f} us after the "
          f"first CTA's start; the last end {1e-3 * (tmr[:, 0, 15, 7].max() - t0):.2f}"
          f" us; rank 0's whole walk {us(c0[15, 7] - c0[0, 0]):.2f} us", flush=True)
    prev = c0[0, 0]
    for lv in range(L):
        lanes = int(want[1][t, lv])
        m = c0[lv]
        if lanes == 0:
            continue
        if lv == L - 1 or m[2] == 0:
            print(f"[trace]   level {lv}: {lanes} lanes | A {us(m[1] - prev):.2f}"
                  f" (the leaf level: phase A only)")
            prev = m[1]
            continue
        parts = [m[1] - prev, m[2] - m[1], m[3] - m[2], m[4] - m[3],
                 m[5] - m[4], m[6] - m[5]]
        print(f"[trace]   level {lv}: {lanes} lanes | A {us(parts[0]):.2f}, "
              f"fold barrier {us(parts[1]):.2f}, gate and totals "
              f"{us(parts[2]):.2f}, count and scan {us(parts[3]):.2f}, "
              f"children {us(parts[4]):.2f}, end barrier "
              f"{us(parts[5]):.2f} us", flush=True)
        prev = m[6]
    print(f"[trace]   end: {us(c0[15, 7] - prev):.2f} us", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--trace", action="store_true")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("FAIL: torch sees no CUDA device")
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))
    import numpy as np
    from chip_smoke import cuda_time_ms, kernel_device_ms
    from repro_torch.core.octree import build_octree
    from repro_torch.data.robotics import make_scene, scene_trajectories
    from repro_torch.engine.executor import CollisionEngine, EngineConfig
    from repro_torch.kernels import _build
    from repro_torch.kernels.fps import ops as fps_ops
    from repro_torch.kernels.fps.ref import fps_ref
    from repro_torch.kernels.persist import ops as persist_ops
    from repro_torch.kernels.persist.ref import persist_tiles_ref

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"[card] {card} | {args.tag}: {src}", flush=True)
    _build.build_all()
    variants = build_persist_variants(src) if args.variants else {}
    trace_lib = build_trace() if args.trace else None
    shipped_lib = _build.load("persist")
    result = {"card": card, "tag": args.tag, "persist": {}, "fps": {}}

    def timed_alone(fns, key, name):
        """{label: [ms per round]}: each fn alone, in turns."""
        out = {label: [] for label in fns}
        for _ in range(ROUNDS):
            for label, fn in fns.items():
                out[label].append(kernel_device_ms(fn, key, REPS, name))
        return out

    cuda = torch.device("cuda", 0)
    tab_points = None
    for env in ENVS:
        scene = make_scene(env, num_points=524288)
        if env == "tabletop":
            tab_points = scene.points
        tree = build_octree(scene.points, depth=7)
        obbs = scene_trajectories(scene, num_trajectories=25, waypoints=60)
        cfg = EngineConfig(mode="wavefront_persistent")
        eng = CollisionEngine(tree, cfg, device="cuda")
        eng.query(obbs)
        ins = persist_ops.pack_kernel_inputs(
            obbs.center.to(cuda), obbs.half.to(cuda), obbs.rot.to(cuda),
            eng.device_tree, persist_ops.DEFAULT_BQ)
        kw = dict(bq=persist_ops.DEFAULT_BQ, fcap=eng.last_capacity,
                  depth=tree.depth, ring_cap=persist_ops.DEFAULT_RING_CAP,
                  use_spheres=cfg.use_spheres)
        want = persist_tiles_ref(**ins, **kw)

        def run(lib=shipped_lib):
            _build._LIBS["persist"] = lib
            return persist_ops.persist_tiles(**ins, **kw)
        for label, lib in [("shipped", shipped_lib)] + [
                (f"C={c} T={t}", lib) for (c, t), lib in variants.items()]:
            got = run(lib)
            for x, y in zip(got, want):
                if not torch.equal(x, y):
                    raise SystemExit(f"FAIL: {env} persist {label} != plain")
        _build._LIBS["persist"] = shipped_lib
        if trace_lib is not None:
            print_trace(env, trace_lib, run, want,
                        persist_ops.kernel_shape()["cluster"])
            _build._LIBS["persist"] = shipped_lib
        nodes = want[3][:, 0].to(torch.float64)
        call = cuda_time_ms(run, 20)
        fns = {"shipped": run}
        fns.update({f"C={c} T={t}": (lambda lib=lib: run(lib))
                    for (c, t), lib in variants.items()})
        alone = timed_alone(fns, "persist_kernel", "persist")
        _build._LIBS["persist"] = shipped_lib
        result["persist"][env] = dict(
            call_ms=call, kernel_ms=alone, fcap=kw["fcap"],
            tiles=int(nodes.numel()), heaviest_tile_nodes=int(nodes.max()),
            mean_tile_nodes=float(nodes.mean()))
        print(f"[persist] {env}: fcap {kw['fcap']}, {nodes.numel()} tiles, "
              f"heaviest tile {int(nodes.max())} nodes, mean "
              f"{float(nodes.mean()):.1f} | call {call:.4f} ms | kernel "
              f"alone: " + "; ".join(
                  f"{k} " + " / ".join(f"{x:.4f}" for x in v)
                  + f" (median {statistics.median(v):.4f})"
                  for k, v in alone.items()) + f" ms | {card}", flush=True)

    if tab_points is None:
        tab_points = make_scene("tabletop", num_points=524288).points
    rsb = np.random.RandomState(5)
    clouds = torch.from_numpy(np.stack([
        tab_points[rsb.choice(len(tab_points), 2048, replace=False)]
        for _ in range(32)])).to(cuda)
    m = 256
    want = fps_ref(clouds, m)
    shipped_threads = fps_ops.threads_for

    def fps_at(threads=None):
        fps_ops.threads_for = ((lambda n: threads) if threads
                               else shipped_threads)
        try:
            return fps_ops.fps(clouds, m)
        finally:
            fps_ops.threads_for = shipped_threads
    fns = {f"shipped ({shipped_threads(2048)} threads)": fps_at}
    if args.variants:
        fns.update({f"{t} threads": (lambda t=t: fps_at(t))
                    for t in FPS_THREADS})
    for label, fn in fns.items():
        if not torch.equal(fn(), want):
            raise SystemExit(f"FAIL: fps {label} != plain")
    call = cuda_time_ms(fps_at, 20)
    alone = timed_alone(fns, "fps_kernel", "fps")
    result["fps"] = dict(call_ms=call, kernel_ms=alone, B=32, N=2048, m=m)
    print(f"[fps] sa1 B=32 N=2048 m={m} | call {call:.4f} ms | kernel alone: "
          + "; ".join(f"{k} " + " / ".join(f"{x:.4f}" for x in v)
                      + f" (median {statistics.median(v):.4f})"
                      for k, v in alone.items()) + f" ms | {card}",
          flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
