#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each prints one line; any failure exits non-zero and prints no
result):

1. the card: ``nvidia-smi`` name and power limit, torch's device name/count;
2. build every CUDA kernel from ``src/repro_torch/**/csrc`` (nvcc, sm_90a);
3. ``sact_dense`` kernel vs its plain version on grazing planes (every exit
   code, both sphere settings), exactly equal;
4. ``persist`` kernel vs ``persist_tiles_ref`` on a small scene, with and
   without frontier overflow, exactly equal;
5. the main path at paper scale, per environment: ``make_scene(env,
   524288)``, ``build_octree(depth=7)``, ``scene_trajectories(25, 60)``
   (10,500 link OBBs), ``CollisionEngine(mode="wavefront_persistent",
   device="cuda").query`` twice, held against the same engine on the CPU
   (verdicts and every counter); launch counts are reset just before and
   read just after; then warm wall time, kernel time (CUDA events) and the
   plain version's time on the card;
6. ``sact_dense`` timed on the paper-scale queries against level-5 cells;
7. one JSON line listing every kernel with its launches on the main path
   (``launches``) and in the checks (``check_launches``), error, times and
   bound; the last line is ``{"ok": true, "device": {...}}``.

It imports nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and non-tensor fp32.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12

# fp32 operations the SACT runs per pair (adds, multiplies, compares,
# min/max; abs is a sign-bit op and not counted): setup t and |R| + eps,
# the sphere stage, and each axis test in stage order.
OPS_SETUP = 12
OPS_SPHERES = 22
OPS_AXIS = [7] * 3 + [12] * 3 + [11] * 9
OPS_NODE_BOX = 10        # megakernel: node centre and half from the code


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def exit_code_ops(use_spheres: bool):
    """fp32 ops of one pair by exit code (codes 0..17)."""
    base = OPS_SETUP + (OPS_SPHERES if use_spheres else 0)
    ops = [base, base]
    for k in range(15):
        ops.append(base + sum(OPS_AXIS[:k + 1]))
    ops.append(base + sum(OPS_AXIS))
    return ops


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_FP32_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def cuda_time_ms(fn, reps: int, warmup: int = 1) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--envs", default="cubby,dresser,merged_cubby,tabletop",
                    help="comma-separated environments for phase 5")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("FAIL: torch sees no CUDA device")
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        raise SystemExit(f"FAIL: no repro_torch package under {src}")
    sys.path.insert(0, str(src))
    import numpy as np
    from repro_torch.core.octree import build_octree, device_octree
    from repro_torch.data.robotics import make_scene, scene_trajectories
    from repro_torch.engine.executor import CollisionEngine, EngineConfig
    from repro_torch.kernels import _build
    from repro_torch.kernels.persist import ops as persist_ops
    from repro_torch.kernels.persist.ref import persist_tiles_ref
    from repro_torch.kernels.sact import ops as sact_ops
    from repro_torch.kernels.sact.cases import grazing_plane
    from repro_torch.kernels.sact.ref import sact_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = torch.device("cuda", 0)

    # ---- 1. the card ----------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        raise SystemExit(f"FAIL: nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(card, flush=True)
    log("1 card", f"{card} | torch: {kind} x{count} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    # ---- 2. build ---------------------------------------------------------
    secs = _build.build_all(verbose=True)
    usage = []
    for name, text in sorted(_build.last_build_log.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                usage.append(f"{name}: {line.strip()}")
    log("2 build", f"{len(_build.SOURCES)} kernels in {secs:.1f} s "
        f"-> {_build.build_dir()}")
    for line in usage:
        log("2 build", line)

    # ---- 3. sact_dense vs plain on grazing planes -----------------------
    # Launches made to compare a kernel with its plain version are counted
    # apart from the main path's.
    check_launches = {name: 0 for name in _build.SOURCES}

    def add_check_launches():
        for name, n in _build.launch_counts().items():
            check_launches[name] += n
        _build.reset_launch_counts()

    _build.reset_launch_counts()
    seen = set()
    mism = 0
    for sph in (False, True):
        obb, aabb = grazing_plane(1024, seed=17, use_spheres=sph)
        o, a = torch.from_numpy(obb).to(cuda), torch.from_numpy(aabb).to(cuda)
        c, e = sact_ops.sact_dense(o, a, use_spheres=sph)
        pc, pe = sact_ref(o, a, sph)
        torch.cuda.synchronize()
        mism += int((c != pc).sum()) + int((e != pe).sum())
        d = torch.diagonal(e)
        if not bool((d[0::2] != d[1::2]).all()):
            raise SystemExit("FAIL: grazing plane diagonal is not grazing")
        seen |= set(torch.unique(e).tolist())
    if mism or seen != set(range(18)):
        raise SystemExit(f"FAIL: sact_dense vs plain: {mism} mismatches, "
                         f"exit codes seen {sorted(seen)}")
    log("3 sact_dense", "kernel == plain on 2 x 2048x2048 grazing planes "
        "(all 18 exit codes, both sphere settings)")

    # ---- 4. persist vs persist_tiles_ref ----------------------------------
    small = make_scene("cubby", num_points=16384)
    stree = build_octree(small.points, depth=5)
    sobbs = scene_trajectories(small, num_trajectories=4, waypoints=20)
    sdev = device_octree(stree, device=cuda)
    spilled_compared = 0
    for bq, fcap, ring_cap, sph in ((16, 64, 4096, False),
                                    (16, 64, 32, True),
                                    (128, 8192, 256, False),
                                    (128, 8192, 256, True)):
        ins = persist_ops.pack_kernel_inputs(
            sobbs.center.to(cuda), sobbs.half.to(cuda), sobbs.rot.to(cuda),
            sdev, bq)
        kw = dict(bq=bq, fcap=fcap, depth=stree.depth, ring_cap=ring_cap,
                  use_spheres=sph)
        got = persist_ops.persist_tiles(**ins, **kw)
        want = persist_tiles_ref(**ins, **kw)
        torch.cuda.synchronize()
        for name, g, w in zip(("best", "per_level", "hist", "scalars"),
                              got, want):
            if not torch.equal(g, w):
                raise SystemExit(f"FAIL: persist {name} differs at "
                                 f"bq={bq} fcap={fcap} spheres={sph}")
        spill = got[3][:, 6]
        fits = spill <= ring_cap
        if not torch.equal(got[4][fits], want[4][fits]):
            raise SystemExit(f"FAIL: persist ring differs at bq={bq} "
                             f"fcap={fcap}")
        spilled_compared += int(((spill > 0) & fits).sum())
        log("4 persist", f"bq={bq} fcap={fcap} ring={ring_cap} spheres={sph}"
            f": kernel == plain, overflow {int(spill.sum())}, nodes "
            f"{int(got[3][:, 0].sum())}")
    if spilled_compared == 0:
        raise SystemExit("FAIL: no spilled ring was compared")
    add_check_launches()

    # ---- 5. main path at paper scale --------------------------------------
    cfg = EngineConfig(mode="wavefront_persistent")
    main_launches = {name: 0 for name in _build.SOURCES}
    persist_line = None
    first_obbs = first_tree = None
    for env in args.envs.split(","):
        t0 = time.perf_counter()
        scene = make_scene(env, num_points=524288)
        tree = build_octree(scene.points, depth=7)
        obbs = scene_trajectories(scene, num_trajectories=25, waypoints=60)
        t_setup = time.perf_counter() - t0
        levels = [len(lv.codes) for lv in tree.levels]
        eng = CollisionEngine(tree, cfg, device="cuda")
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        v1, c1 = eng.query(obbs)
        v2, c2 = eng.query(obbs)
        counts = _build.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        for name, n in counts.items():
            main_launches[name] += n
        if counts["persist"] <= 0:
            raise SystemExit(f"FAIL: {env}: the main path launched no "
                             f"persist kernel")
        t0 = time.perf_counter()
        vc, cc = CollisionEngine(tree, cfg, device="cpu").query(obbs)
        t_cpu = time.perf_counter() - t0
        if not (np.array_equal(v1, vc) and np.array_equal(v2, vc)):
            raise SystemExit(f"FAIL: {env}: CUDA verdicts differ from CPU")
        a, b, b2 = c1.as_dict(), cc.as_dict(), c2.as_dict()
        for k in a:
            if k == "wall_time_s":
                continue
            if a[k] != b[k] or (k != "escalations" and b2[k] != b[k]):
                raise SystemExit(f"FAIL: {env}: counter {k} differs: cuda "
                                 f"{a[k]} / {b2[k]} vs cpu {b[k]}")
        if not (v1.shape == (obbs.n,) and v1.dtype == bool
                and 0 < int(v1.sum()) < obbs.n):
            raise SystemExit(f"FAIL: {env}: implausible verdicts")
        walls = []
        for _ in range(10):
            _, cw = eng.query(obbs)
            walls.append(cw.wall_time_s)
        cap = eng.last_capacity
        dev = eng.device_tree
        ins = persist_ops.pack_kernel_inputs(
            obbs.center.to(cuda), obbs.half.to(cuda), obbs.rot.to(cuda), dev,
            persist_ops.DEFAULT_BQ)
        kw = dict(bq=persist_ops.DEFAULT_BQ, fcap=cap, depth=tree.depth,
                  ring_cap=persist_ops.DEFAULT_RING_CAP,
                  use_spheres=cfg.use_spheres)
        got = persist_ops.persist_tiles(**ins, **kw)
        add_check_launches()
        want = persist_tiles_ref(**ins, **kw)
        err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                  for g, w in zip(got, want))
        if err:
            raise SystemExit(f"FAIL: {env}: persist kernel differs from "
                             f"plain at paper scale (max abs err {err})")
        ms = cuda_time_ms(lambda: persist_ops.persist_tiles(**ins, **kw), 20)
        plain_ms = cuda_time_ms(lambda: persist_tiles_ref(**ins, **kw), 3)
        T = ins["sot"].shape[0]
        L = tree.depth + 1
        n_max = dev.node_meta.shape[1]
        nodes = c1.nodes_traversed
        in_bytes = (4 * (3 + L) + 4 * T + 4 + T * 128 * (60 + 4 + 4)
                    + min(L * n_max * 16, nodes * 16))
        out_bytes = 4 * T * (128 + L + 18 + 8) + 8 * T * kw["ring_cap"]
        ops = nodes * (OPS_SETUP + OPS_NODE_BOX) + 7 * c1.axis_tests_executed
        bms, by = bound_ms(in_bytes + out_bytes, ops)
        line = dict(name="persist", route="cuda",
                    source="src/repro_torch/kernels/persist/csrc/persist.cu",
                    replaces="src/repro/kernels/persist/kernel.py:137",
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                    bound_by=by, library_ms=None)
        if persist_line is None:
            persist_line = line
            first_obbs, first_tree = obbs, tree
        log("5 main", f"{env}: levels {levels} | Q={obbs.n} hits="
            f"{int(v1.sum())} nodes={nodes} axis_exec="
            f"{c1.axis_tests_executed} escalations={c1.escalations} "
            f"cap={cap} | launches {counts} | cuda==cpu verdicts+counters | "
            f"warm wall median {1e3 * statistics.median(walls):.3f} ms | "
            f"persist kernel {ms:.3f} ms, plain on card {plain_ms:.3f} ms, "
            f"bound {bms:.4f} ms ({by}) | peak mem {peak / 2**20:.1f} MiB | "
            f"setup {t_setup:.1f} s, cpu engine {t_cpu:.1f} s | {card}")
    persist_line.update(launches=main_launches["persist"],
                        check_launches=check_launches["persist"])

    # ---- 6. sact_dense timed at main-path widths -------------------------
    lvl = 5
    aabbs = first_tree.node_aabbs(lvl)
    N = min(aabbs.n, 4096)
    o = sact_ops.pack_obbs(first_obbs.center, first_obbs.half,
                           first_obbs.rot).to(cuda)
    a = sact_ops.pack_aabbs(aabbs.center[:N], aabbs.half[:N]).to(cuda)
    c, e = sact_ops.sact_dense(o, a)
    add_check_launches()
    pc, pe = sact_ref(o, a, False)
    err = max(int((c != pc).sum() > 0), int((e - pe).abs().max()))
    if err:
        raise SystemExit("FAIL: sact_dense differs from plain at main-path "
                         "widths")
    ms = cuda_time_ms(lambda: sact_ops.sact_dense(o, a), 20)
    plain_ms = cuda_time_ms(lambda: sact_ref(o, a, False), 3)
    M = o.shape[0]
    hist = torch.bincount(e.reshape(-1), minlength=18).cpu().numpy()
    ops = float(np.dot(hist, exit_code_ops(False)))
    bms, by = bound_ms(M * 60 + N * 24 + M * N * 5, ops)
    sact_line = dict(name="sact_dense", route="cuda",
                     source="src/repro_torch/kernels/sact/csrc/sact_dense.cu",
                     replaces="src/repro/kernels/sact/kernel.py:112",
                     launches=main_launches["sact_dense"],
                     check_launches=check_launches["sact_dense"],
                     max_abs_err=err,
                     ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                     library_ms=None)
    log("6 sact_dense", f"{M} x {N} plane (paper-scale OBBs x level-{lvl} "
        f"cells): kernel {ms:.3f} ms, plain on card {plain_ms:.3f} ms, bound "
        f"{bms:.4f} ms ({by}); not on the main path | {card}")

    # ---- 7. result --------------------------------------------------------
    print(json.dumps({"kernels": [persist_line, sact_line]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
