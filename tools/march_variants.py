#!/usr/bin/env python3
"""The ``march`` kernel beside its first design and its variants, on the card.

Runs the shipped kernel (``src/repro_torch/kernels/march/csrc/march.cu``)
and the variants of ``tools/march_variants.cu`` (the first design, one
thread a ray; the shipped design at other lanes a ray, steps a lane a
round, grid routes and CTA sizes) on Fig. 19's grid (192 x 192) and its
4,608 scan rays, at three shapes: the dense cast (121 steps from the
rays' origins), the compacted cast's first chunk (16 steps from the
origins) and its third (16 steps from the state that 32 steps of the
plain march leave, rays partly ended).  The shipped kernel's ``pos``,
``dist`` and ``active`` must equal ``march_ref``'s, and every variant's
the shipped kernel's, bit for bit.  Then each kernel's own time on the
card (``torch.profiler``, a window of ``--reps`` launches, each on the
shape's state restored by copies, which match no kernel's key) in
``--rounds`` rounds, the kernels in turn; and the call (CUDA events
around ``--reps`` back-to-back ``march`` calls on fresh states) with the
shipped kernel and with the first design swapped into the same wrapper,
in turns: first, shipped, shipped, first.  Needs a CUDA device and
``nvcc``; run from the root of a checkout:

    python3 tools/march_variants.py [--reps 50] [--rounds 3]

The last line is a JSON object of every time.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: (lanes, steps) of ``launch_cfg`` in ``march_variants.cu``, by index.
CONFIGS = [(1, 4), (4, 4), (8, 1), (8, 2), (8, 4), (16, 1), (16, 2),
           (32, 1)]
ROUTES = ["l1", "bytes", "bits"]
#: (name, which, threads a CTA: 0 about one CTA an SM) of variant_launch.
VARIANTS = [("serial (first design)", 0, 128)] + [
    (f"{lanes}x{steps}/{route}", 1 + 8 * r + c, 0)
    for r, route in enumerate(ROUTES)
    for c, (lanes, steps) in enumerate(CONFIGS)] + [
    (f"{CONFIGS[c][0]}x{CONFIGS[c][1]}/{route}/{threads} threads",
     1 + 8 * r + c, threads)
    for c in (3, 5) for r, route in enumerate(ROUTES[:2])
    for threads in (128, 256, 512)]


def build():
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    out = ROOT / "build" / "tools"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libmarch_variants.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
           str(lib), str(ROOT / "tools" / "march_variants.cu")]
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if p.returncode:
        raise SystemExit(f"FAIL: nvcc:\n{p.stdout}{p.stderr}")
    for line in (p.stdout + p.stderr).splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"[build] {line.strip()}")
    cdll = ctypes.CDLL(str(lib))
    march_args = ([ctypes.c_void_p] + [ctypes.c_int] * 2
                  + [ctypes.c_float] * 4 + [ctypes.c_void_p] * 4
                  + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    cdll.variant_launch.argtypes = [ctypes.c_int] * 2 + march_args
    cdll.variant_launch.restype = ctypes.c_int
    cdll.serial_launch.argtypes = march_args
    cdll.serial_launch.restype = ctypes.c_int
    return cdll


def device_ms(fn, reps: int, tries: int = 3) -> float:
    """Mean own time on the card of the kernels whose name holds "march"
    over ``reps`` calls of ``fn`` (one launch each), after a warm-up step
    of the profiler, over the records it kept.  Each window opens with a
    few fills of a scratch word and idle time on either side of the
    calls; a window that kept fewer than half the records is taken again,
    up to ``tries`` windows."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    scratch = torch.empty(1, device="cuda")
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(4):
                scratch.fill_(0.0)
            torch.cuda.synchronize()
            time.sleep(0.02)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.02)
        ev = [e for e in prof.key_averages() if "march" in e.key]
        n = sum(e.count for e in ev)
        if max(10, reps // 2) <= n <= reps:
            if n < reps:
                print(f"[profiler] kept {n} of {reps} records")
            return sum(getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0))
                       for e in ev) / 1e3 / n
        print(f"[profiler] a window kept {n} of {reps} records: again")
    raise SystemExit(f"FAIL: {tries} windows of {reps} launches, none kept "
                     f"half the records")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("FAIL: torch sees no CUDA device")
    lib = build()
    from repro_torch.core import mcl as tmcl
    from repro_torch.kernels.march import ops as march_ops
    from repro_torch.kernels.march.cases import FIG19_GRID_SEED, ray_cases
    from repro_torch.kernels.march.ref import march_ref

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    grid = tmcl.make_corridor_world(FIG19_GRID_SEED, size=192, device=dev)
    org, ang = ray_cases(grid.shape, grid.cell)["scan"]
    R, max_range = len(ang), 6.0
    full = int(np.ceil(max_range / grid.cell)) + 1
    dirv = tmcl.ray_directions(torch.from_numpy(ang).to(dev)).contiguous()
    H, W = grid.shape

    def fresh():
        return (torch.from_numpy(org).to(dev),
                torch.zeros(R, device=dev),
                torch.ones(R, dtype=torch.bool, device=dev))
    chunk3 = fresh()
    march_ref(grid.occ, grid.origin, grid.cell, chunk3[0], dirv, chunk3[1],
              chunk3[2], max_range, 32)
    shapes = {"dense (121 steps)": (fresh(), full),
              "first chunk (16 steps)": (fresh(), 16),
              "third chunk (16 steps, from step 32)": (chunk3, 16)}
    print(f"[shape] Fig. 19: {R} rays, grid {H} x {W}; the third chunk "
          f"starts with {int(chunk3[2].sum())} of {R} rays active | {card}")

    def variant(which, threads, st, n):
        pos, dist, active = st
        err = lib.variant_launch(
            which, threads, grid.occ.data_ptr(), H, W,
            *map(float, grid.origin), float(grid.cell), max_range,
            pos.data_ptr(), dirv.data_ptr(), dist.data_ptr(),
            active.data_ptr(), R, n, torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"FAIL: variant {which} launch error {err}")

    def shipped(st, n):
        march_ops.march(grid.occ, grid.origin, grid.cell, st[0], dirv, st[1],
                        st[2], max_range, n)

    results, calls = {}, {}
    for shape, (start, n) in shapes.items():
        want = [x.clone() for x in start]
        march_ref(grid.occ, grid.origin, grid.cell, want[0], dirv, want[1],
                  want[2], max_range, n)
        got = [x.clone() for x in start]
        shipped(got, n)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise SystemExit(f"FAIL: {shape}: shipped kernel != march_ref")
        for name, which, threads in VARIANTS:
            out = [x.clone() for x in start]
            variant(which, threads, out, n)
            if not all(torch.equal(a, b) for a, b in zip(out, got)):
                raise SystemExit(f"FAIL: {shape}: {name} != shipped kernel")
        st = [x.clone() for x in start]

        def restored(launch, st=st, start=start):
            def fn():
                for a, b in zip(st, start):
                    a.copy_(b)
                launch(st)
            return fn
        timed = [("shipped", restored(lambda s, n=n: shipped(s, n)))]
        timed += [(name, restored(lambda s, w=which, t=threads, n=n:
                                  variant(w, t, s, n)))
                  for name, which, threads in VARIANTS]
        res = results[shape] = {name: [] for name, _ in timed}
        for _ in range(args.rounds):
            for name, fn in timed:
                res[name].append(1e3 * device_ms(fn, args.reps))
        for name, us in res.items():
            print(f"[{shape}] kernel {name}: "
                  + " / ".join(f"{x:.3f}" for x in us)
                  + f" us (median {statistics.median(us):.3f})")

        # the call: march_ops.march around each design, fresh states
        def call_ms(launch_fn):
            states = [[x.clone() for x in start]
                      for _ in range(args.reps + 1)]
            saved = march_ops._launch
            march_ops._launch = launch_fn
            try:
                shipped(states[0], n)
                torch.cuda.synchronize()
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                for s in states[1:]:
                    shipped(s, n)
                b.record()
                torch.cuda.synchronize()
            finally:
                march_ops._launch = saved
            return a.elapsed_time(b) / args.reps
        mine = march_ops._lib()
        c = calls[shape] = {"first design": [], "shipped": []}
        for who in ("first design", "shipped", "shipped", "first design"):
            c[who].append(1e3 * call_ms(
                lib.serial_launch if who == "first design" else mine))
        print(f"[{shape}] call (CUDA events, first / shipped / shipped / "
              f"first): {c['first design'][0]:.3f} / {c['shipped'][0]:.3f}"
              f" / {c['shipped'][1]:.3f} / {c['first design'][1]:.3f} us")
    line = {"card": card, "rays": R, "grid": [H, W], "kernel_us": results,
            "call_us": calls}
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
