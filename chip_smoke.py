#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each prints lines tagged with its number; any failure exits
non-zero and prints no result):

1. the card: ``nvidia-smi`` name and power limit, torch's device name/count;
2. build every CUDA kernel from ``src/repro_torch/**/csrc`` (nvcc, sm_90a);
3. ``sact_dense`` kernel vs its plain version on grazing planes (every exit
   code, both sphere settings), exactly equal;
4. ``persist`` kernel vs ``persist_tiles_ref`` on a small scene, with and
   without frontier overflow, exactly equal;
5. the paper-scale scenes: ``make_scene(env, 524288)``,
   ``build_octree(depth=7)``, ``scene_trajectories(25, 60)`` (10,500 link
   OBBs) for each environment;
6. ``traverse`` kernel vs ``traverse_test_ref`` on the cubby scene: the
   10,500 OBBs against level-5 cells with a live prefix short of the
   capacity, and grazing frontiers (OBBs placed against real cells by
   bisection; all 18 exit codes), both sphere settings, words equal;
7. ``compact`` kernel vs ``compact_ref``: mask densities 0, 1e-3, 0.5 and
   1 over a lane count that is no multiple of the block, and an ``n_out``
   below the total; count and every output row equal;
8. the main paths at paper scale, per environment, in each of the modes
   ``wavefront_persistent``, ``wavefront`` and ``wavefront_fused`` (and
   ``wavefront_fused`` on u8 rows in the first environment): two CUDA
   queries through ``CollisionEngine(...).query``, held against the same
   engine on the CPU (verdicts and every counter), the per-level modes
   also against the persistent one (all but ``bytes_moved`` and
   ``escalations``); launch counts are set to 0 just before each path and
   read just after; then warm wall time (median of 10), the kernels' time
   per launch (CUDA events, replaying one warm query's launches) and the
   peak device memory;
9. ``traverse`` and ``compact`` timed at the widest level of the cubby
   ``wavefront_fused`` query against their bounds, plain versions and (for
   ``compact``) one PyTorch call computing the same function;
10. ``sact_dense`` timed on the paper-scale queries against level-5 cells;
11. one JSON line listing every kernel with its launches on the main paths
   (``launches``) and elsewhere (``check_launches``), error, times and
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


class Recorder:
    """Within its ``with`` block, record every call of the traversal-step
    and compaction kernels' wrappers (arguments kept, so each call can be
    replayed and timed); the calls still run."""

    def __init__(self, traverse_ops, compact_ops):
        self._mods = {"traverse": (traverse_ops, "traverse_test"),
                      "compact": (compact_ops, "compact_channels")}
        self.calls = {name: [] for name in self._mods}

    def __enter__(self):
        self._orig = {}
        for name, (mod, attr) in self._mods.items():
            fn = self._orig[name] = getattr(mod, attr)

            def rec(*a, _fn=fn, _name=name, **k):
                self.calls[_name].append((_fn, a, k))
                return _fn(*a, **k)
            setattr(mod, attr, rec)
        return self

    def __exit__(self, *exc):
        for name, (mod, attr) in self._mods.items():
            setattr(mod, attr, self._orig[name])
        return False


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--envs", default="cubby,dresser,merged_cubby,tabletop",
                    help="comma-separated environments for phases 5-8 "
                         "(the first one also serves phases 6, 9 and 10)")
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
    from repro_torch.kernels.compact import ops as compact_ops
    from repro_torch.kernels.compact.ref import compact_ref
    from repro_torch.kernels.persist import ops as persist_ops
    from repro_torch.kernels.persist.ref import persist_tiles_ref
    from repro_torch.kernels.sact import ops as sact_ops
    from repro_torch.kernels.sact.cases import grazing_plane
    from repro_torch.kernels.sact.ref import sact_ref
    from repro_torch.kernels.traverse import ops as traverse_ops
    from repro_torch.kernels.traverse.cases import grazing_frontier
    from repro_torch.kernels.traverse.ref import (traverse_test_ref,
                                                  unpack_verdicts)

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
    n_dev = torch.cuda.device_count()
    print(card, flush=True)
    log("1 card", f"{card} | torch: {kind} x{n_dev} | torch "
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

    # ---- 5. paper-scale scenes --------------------------------------------
    scenes = {}
    for env in args.envs.split(","):
        t0 = time.perf_counter()
        scene = make_scene(env, num_points=524288)
        tree = build_octree(scene.points, depth=7)
        obbs = scene_trajectories(scene, num_trajectories=25, waypoints=60)
        scenes[env] = (tree, obbs, time.perf_counter() - t0)
        log("5 scenes", f"{env}: levels {[len(lv.codes) for lv in tree.levels]}"
            f" | Q={obbs.n} | setup {scenes[env][2]:.1f} s")
    env0 = next(iter(scenes))
    tree0, obbs0, _ = scenes[env0]
    dev0 = device_octree(tree0, device=cuda)
    obb0 = sact_ops.pack_obbs(obbs0.center, obbs0.half, obbs0.rot).to(cuda)

    # ---- 6. traverse vs traverse_test_ref ----------------------------------
    errs = {"traverse": 0, "compact": 0}
    lvl = 5
    n_l = int(dev0.counts[lvl])
    g = torch.Generator().manual_seed(23)
    cap = 131072
    frontiers = [dict(obb=obb0,
                      q_idx=(torch.arange(cap) % obbs0.n).to(torch.int32),
                      codes=dev0.codes[lvl].cpu()[
                          torch.randint(0, n_l, (cap,), generator=g)],
                      n_live=cap - 1000, name="paper")]
    frontiers[0]["full"] = torch.zeros(cap, dtype=torch.int32)
    for sph in (False, True):
        f = grazing_frontier(dev0, lvl, 4096, seed=31 + sph, use_spheres=sph)
        frontiers.append(dict(f, n_live=f["q_idx"].shape[0] - 77,
                              name=f"grazing spheres={sph}", sph=sph))
    seen = set()
    for f in frontiers:
        ins = [f[k].to(cuda) for k in ("obb", "q_idx", "codes", "full")]
        n_live = torch.tensor(f["n_live"], dtype=torch.int32, device=cuda)
        for sph in ((False, True) if "sph" not in f else (f["sph"],)):
            kw = dict(cell=dev0.host_cells[lvl], lo=dev0.host_lo,
                      is_leaf=False, use_spheres=sph)
            got = traverse_ops.traverse_test(*ins, n_live, **kw)
            want = traverse_test_ref(*ins, n_live, **kw)
            torch.cuda.synchronize()
            err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
            codes = set(unpack_verdicts(got[:f["n_live"]])[2].tolist())
            seen |= codes
            if err or bool(got[f["n_live"]:].any()):
                raise SystemExit(f"FAIL: traverse differs from plain on the "
                                 f"{f['name']} frontier (spheres={sph})")
            errs["traverse"] = max(errs["traverse"], err)
            log("6 traverse", f"{f['name']} frontier, {got.shape[0]} lanes, "
                f"{f['n_live']} live, spheres={sph}: kernel == plain, exit "
                f"codes {sorted(codes)}")
    if seen != set(range(18)):
        raise SystemExit(f"FAIL: traverse checks saw exit codes {sorted(seen)}")

    # ---- 7. compact vs compact_ref -----------------------------------------
    n = 8 * 65536 + 77
    for density, n_out in ((0.0, n), (1e-3, n), (0.5, n), (1.0, n),
                           (0.5, 65536)):
        mask = torch.rand(n, generator=g) < density
        chans = torch.randint(-2**31, 2**31 - 1, (2, n), generator=g,
                              dtype=torch.int32)
        mask, chans = mask.to(cuda), chans.to(cuda)
        count, out = compact_ops.compact_channels(mask, chans, n_out)
        want_count, want = compact_ref(mask, chans.t(), n_out)
        torch.cuda.synchronize()
        err = max(abs(int(count) - int(want_count)),
                  int((out.t().to(torch.int64)
                       - want.to(torch.int64)).abs().max()))
        if err:
            raise SystemExit(f"FAIL: compact differs from plain at density "
                             f"{density}, n_out {n_out}")
        log("7 compact", f"{n} lanes, density {density}, n_out {n_out}: "
            f"count {int(count)} (total {int(mask.sum())}), kernel == plain "
            f"on every row")
    add_check_launches()

    # ---- 8. main paths at paper scale --------------------------------------
    main_launches = {name: 0 for name in _build.SOURCES}
    persist_line = timing_inputs = None
    paths = [("wavefront_persistent", None), ("wavefront", None),
             ("wavefront_fused", None), ("wavefront_fused", "u8")]
    for env, (tree, obbs, _) in scenes.items():
        ref_run = None
        for mode, fmt in paths:
            if fmt is not None and env != env0:
                continue
            cfg = EngineConfig(mode=mode, meta_format=fmt)
            tag = mode + (f"[{fmt}]" if fmt else "")
            eng = CollisionEngine(tree, cfg, device="cuda")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launch_counts()
            v1, c1 = eng.query(obbs)
            v2, c2 = eng.query(obbs)
            counts = _build.launch_counts()
            _build.reset_launch_counts()
            peak = torch.cuda.max_memory_allocated()
            for name, k in counts.items():
                main_launches[name] += k
            want_kernels = {"wavefront_persistent": ("persist",),
                            "wavefront": ("compact",),
                            "wavefront_fused": ("traverse", "compact")}[mode]
            for name, k in counts.items():
                if (k > 0) != (name in want_kernels):
                    raise SystemExit(f"FAIL: {env} {tag}: {name} launched "
                                     f"{k} times on the main path")
            t0 = time.perf_counter()
            vc, cc = CollisionEngine(tree, cfg, device="cpu").query(obbs)
            t_cpu = time.perf_counter() - t0
            if not (np.array_equal(v1, vc) and np.array_equal(v2, vc)):
                raise SystemExit(f"FAIL: {env} {tag}: CUDA verdicts differ "
                                 f"from CPU")
            a, b, b2 = c1.as_dict(), cc.as_dict(), c2.as_dict()
            for k in a:
                if k == "wall_time_s":
                    continue
                if a[k] != b[k] or (k != "escalations" and b2[k] != b[k]):
                    raise SystemExit(f"FAIL: {env} {tag}: counter {k} "
                                     f"differs: cuda {a[k]} / {b2[k]} vs "
                                     f"cpu {b[k]}")
            if not (v1.shape == (obbs.n,) and v1.dtype == bool
                    and 0 < int(v1.sum()) < obbs.n):
                raise SystemExit(f"FAIL: {env} {tag}: implausible verdicts")
            if ref_run is None:
                ref_run = (v1, a)
            else:
                if not np.array_equal(v1, ref_run[0]):
                    raise SystemExit(f"FAIL: {env} {tag}: verdicts differ "
                                     f"from wavefront_persistent")
                for k in a:
                    if k not in ("wall_time_s", "bytes_moved",
                                 "escalations") and a[k] != ref_run[1][k]:
                        raise SystemExit(
                            f"FAIL: {env} {tag}: counter {k} differs from "
                            f"wavefront_persistent: {a[k]} vs "
                            f"{ref_run[1][k]}")
            walls = []
            for _ in range(10):
                _, cw = eng.query(obbs)
                walls.append(cw.wall_time_s)
            kernel_note = ""
            if mode != "wavefront_persistent":
                with Recorder(traverse_ops, compact_ops) as rec:
                    eng.query(obbs)
                per_launch, per_query = {}, 0.0
                for name, calls in rec.calls.items():
                    if not calls:
                        continue
                    ms = [cuda_time_ms(lambda: fn(*ca, **ck), 5)
                          for fn, ca, ck in calls]
                    per_launch[name] = statistics.mean(ms)
                    per_query += sum(ms)
                kernel_note = (" | per launch " + ", ".join(
                    f"{k} {v:.4f} ms x{len(rec.calls[k])}"
                    for k, v in per_launch.items())
                    + f" per query, kernels {per_query:.3f} ms/query")
                if env == env0 and mode == "wavefront_fused" and fmt is None:
                    timing_inputs = rec.calls
            else:
                cap = eng.last_capacity
                dev = eng.device_tree
                ins = persist_ops.pack_kernel_inputs(
                    obbs.center.to(cuda), obbs.half.to(cuda),
                    obbs.rot.to(cuda), dev, persist_ops.DEFAULT_BQ)
                kw = dict(bq=persist_ops.DEFAULT_BQ, fcap=cap,
                          depth=tree.depth,
                          ring_cap=persist_ops.DEFAULT_RING_CAP,
                          use_spheres=cfg.use_spheres)
                got = persist_ops.persist_tiles(**ins, **kw)
                want = persist_tiles_ref(**ins, **kw)
                err = max(int((x.to(torch.int64) - y.to(torch.int64))
                              .abs().max()) for x, y in zip(got, want))
                if err:
                    raise SystemExit(f"FAIL: {env}: persist kernel differs "
                                     f"from plain at paper scale (max abs "
                                     f"err {err})")
                ms = cuda_time_ms(
                    lambda: persist_ops.persist_tiles(**ins, **kw), 20)
                plain_ms = cuda_time_ms(lambda: persist_tiles_ref(**ins, **kw),
                                        3)
                T = ins["sot"].shape[0]
                L = tree.depth + 1
                n_max = dev.node_meta.shape[1]
                nodes = c1.nodes_traversed
                in_bytes = (4 * (3 + L) + 4 * T + 4 + T * 128 * (60 + 4 + 4)
                            + min(L * n_max * 16, nodes * 16))
                out_bytes = 4 * T * (128 + L + 18 + 8) + 8 * T * kw["ring_cap"]
                ops = (nodes * (OPS_SETUP + OPS_NODE_BOX)
                       + 7 * c1.axis_tests_executed)
                bms, by = bound_ms(in_bytes + out_bytes, ops)
                if persist_line is None:
                    persist_line = dict(
                        name="persist", route="cuda",
                        source="src/repro_torch/kernels/persist/csrc/"
                               "persist.cu",
                        replaces="src/repro/kernels/persist/kernel.py:137",
                        max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bms, bound_by=by, library_ms=None)
                kernel_note = (f" | persist kernel {ms:.3f} ms, plain on card "
                               f"{plain_ms:.3f} ms, bound {bms:.4f} ms ({by})")
            add_check_launches()
            log("8 main", f"{env} {tag}: Q={obbs.n} hits={int(v1.sum())} "
                f"nodes={c1.nodes_traversed} per level {c1.nodes_per_level} "
                f"axis_exec={c1.axis_tests_executed} escalations="
                f"{c1.escalations} cap={eng.last_capacity} | main-path "
                f"launches {counts} | cuda==cpu verdicts+counters | warm wall "
                f"median {1e3 * statistics.median(walls):.3f} ms"
                f"{kernel_note} | peak mem {peak / 2**20:.1f} MiB | cpu "
                f"engine {t_cpu:.1f} s | {card}")
    persist_line["launches"] = main_launches["persist"]

    # ---- 9. traverse and compact at main-path shapes -----------------------
    lines = [persist_line]
    calls_t, calls_c = timing_inputs["traverse"], timing_inputs["compact"]
    widest = max(range(len(calls_t)),
                 key=lambda i: int(calls_t[i][1][4]))
    _, ta, tk = calls_t[widest]
    got = traverse_ops.traverse_test(*ta, **tk)
    want = traverse_test_ref(*ta, **tk)
    n_live = int(ta[4])
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    errs["traverse"] = max(errs["traverse"], err)
    ms = cuda_time_ms(lambda: traverse_ops.traverse_test(*ta, **tk), 50)
    plain_ms = cuda_time_ms(lambda: traverse_test_ref(*ta, **tk), 5)
    exits = unpack_verdicts(got[:n_live])[2]
    hist = torch.bincount(exits, minlength=18).cpu().numpy()
    ops = float(np.dot(hist, exit_code_ops(tk["use_spheres"]))
                + OPS_NODE_BOX * n_live)
    # Read once: each live lane's q_idx, code and full flag, and each OBB
    # that a live lane names; written once: every lane's word.
    n_obbs = int(torch.unique(ta[1][:n_live]).numel())
    bms, by = bound_ms(n_live * (4 + 4 + 4) + got.shape[0] * 4
                       + n_obbs * 60, ops)
    lines.append(dict(
        name="traverse", route="cuda",
        source="src/repro_torch/kernels/traverse/csrc/traverse.cu",
        replaces="src/repro/kernels/traverse/kernel.py:50",
        launches=main_launches["traverse"], max_abs_err=errs["traverse"],
        ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
        library_ms=None))
    log("9 traverse", f"{env0} wavefront_fused widest level ({n_live} live of "
        f"{got.shape[0]} lanes, {n_obbs} OBBs named): kernel {ms:.4f} ms, "
        f"plain on card "
        f"{plain_ms:.3f} ms, bound {bms:.5f} ms ({by}) | {card}")
    # compaction: the level that keeps the most pairs
    _, ca, ck = max(calls_c, key=lambda call: int(call[1][0].sum()))
    mask, chans, n_out = ca
    count, out = compact_ops.compact_channels(*ca, **ck)
    want_count, want = compact_ref(mask, chans.t(), n_out)
    err = max(abs(int(count) - int(want_count)),
              int((out.t().to(torch.int64) - want.to(torch.int64))
                  .abs().max()))
    errs["compact"] = max(errs["compact"], err)
    rows = chans.t().contiguous()
    ms = cuda_time_ms(lambda: compact_ops.compact_channels(*ca, **ck), 50)
    plain_ms = cuda_time_ms(lambda: compact_ref(mask, chans.t(), n_out), 5)
    library_ms = cuda_time_ms(lambda: rows[mask][:n_out], 50)
    # Read once: the mask and the rows of the kept survivors; written
    # once: all n_out output rows (zero past the count).
    lanes = mask.shape[0]
    bms, by = bound_ms(lanes * 1 + int(count) * 8 + n_out * 8, 0)
    lines.append(dict(
        name="compact", route="cuda",
        source="src/repro_torch/kernels/compact/csrc/compact.cu",
        replaces="src/repro/kernels/compact/kernel.py:32",
        launches=main_launches["compact"], max_abs_err=errs["compact"],
        ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
        library_ms=library_ms))
    log("9 compact", f"{env0} wavefront_fused fullest level ({lanes} lanes, "
        f"{int(count)} kept, n_out {n_out}): kernel {ms:.4f} ms, plain on "
        f"card {plain_ms:.3f} ms, vals[mask][:n_out] {library_ms:.4f} ms, "
        f"bound {bms:.5f} ms ({by}) | {card}")
    add_check_launches()

    # ---- 10. sact_dense timed at main-path widths -------------------------
    aabbs = tree0.node_aabbs(lvl)
    N = min(aabbs.n, 4096)
    o = obb0
    a = sact_ops.pack_aabbs(aabbs.center[:N], aabbs.half[:N]).to(cuda)
    c, e = sact_ops.sact_dense(o, a)
    pc, pe = sact_ref(o, a, False)
    err = max(int((c != pc).sum() > 0), int((e - pe).abs().max()))
    if err:
        raise SystemExit("FAIL: sact_dense differs from plain at main-path "
                         "widths")
    ms = cuda_time_ms(lambda: sact_ops.sact_dense(o, a), 20)
    plain_ms = cuda_time_ms(lambda: sact_ref(o, a, False), 3)
    add_check_launches()
    M = o.shape[0]
    hist = torch.bincount(e.reshape(-1), minlength=18).cpu().numpy()
    ops = float(np.dot(hist, exit_code_ops(False)))
    bms, by = bound_ms(M * 60 + N * 24 + M * N * 5, ops)
    lines.insert(1, dict(
        name="sact_dense", route="cuda",
        source="src/repro_torch/kernels/sact/csrc/sact_dense.cu",
        replaces="src/repro/kernels/sact/kernel.py:112",
        launches=main_launches["sact_dense"], max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None))
    log("10 sact_dense", f"{M} x {N} plane (paper-scale OBBs x level-{lvl} "
        f"cells): kernel {ms:.3f} ms, plain on card {plain_ms:.3f} ms, bound "
        f"{bms:.4f} ms ({by}); not on the main paths | {card}")

    # ---- 11. result -------------------------------------------------------
    for line in lines:
        line["check_launches"] = check_launches[line["name"]]
    print(json.dumps({"kernels": lines}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": n_dev}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
