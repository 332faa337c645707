#!/usr/bin/env python3
"""The ``ballquery`` and ``sact_dense`` kernels at the main paths' shapes,
beside their design's variants and the parent design's kernels, on the card.

``ballquery``: sa1 of the batched encode (32 tabletop clouds of 2048 points
drawn as ``chip_smoke.py`` phase 13 draws them, 256 centres each by the
``fps`` kernel, r = 0.1, k = 16) and the single plan's three layers (B = 1:
sa1 (M, N, r, k) = (256, 2048, 0.1, 16), sa2 (64, 256, 0.25, 16) on sa1's
centres, sa3 (16, 64, 0.6, 8) on sa2's).  Beside the shipped kernel at its
query block (``ops.query_block``): the shipped kernel at other query
blocks; copies of ``ballquery.cu`` with 2 and 8 chunks a trip (its
``kChunks`` rewritten, built under ``build/tools``) and one without the
split (``kSplit`` false: one warp walks a query's whole cloud where the
block has fewer queries than warps); the parent design's kernel
(``tools/ballquery_variants.cu``).

``sact_dense``: the plane of ``chip_smoke.py`` phase 10 (the cubby scene's
10,500 paper-scale OBBs against 4,096 of its level-5 cells).  Beside the
shipped kernel: the shipped kernel in each stage mode of ``sact_tile.cuh``;
copies of ``sact_dense.cu`` with other tiles (``kBM`` x ``kBN``), boxes a
thread (``kV``) and plain stores (``kStream`` false); the parent design's
kernel (``tools/sact_dense_variants.cu``: a thread a pair, the tests as a
chain of branches); and the shipped kernel on the plane one box short,
whose rows start off a vector's alignment.  The plane's exit-code
histogram and the share of warp slots that run each voted stage are
printed.

Every variant's outputs must equal the plain version's.  Each kernel is
timed alone (``torch.profiler``, a window of 20 launches, exactly one
record a launch, as ``chip_smoke.py::kernel_device_ms``) in two rounds,
the kernels in turn, and the shipped calls with CUDA events around
back-to-back calls.  Needs a CUDA device and ``nvcc``; run from the root of
a checkout:

    python3 tools/ballquery_sact_variants.py
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: kChunks of the ballquery copies (the shipped value is timed as shipped).
BQ_CHUNKS = [2, 8]
#: Query blocks timed beside the shipped rule's, by batch.
BQ_BLOCKS = {32: [8, 16, 32, 64], 1: [1, 2, 4, 8]}
#: (kBM, kBN, kV, kStream) of the sact_dense copies.
SACT_VARIANTS = [(8, 512, 4, True), (32, 512, 4, True), (16, 256, 4, True),
                 (16, 256, 2, True), (32, 256, 2, True), (16, 1024, 8, True),
                 (16, 512, 4, False)]
#: Launches a profiled window, and rounds of all the kernels in turn.
REPS, ROUNDS = 20, 2


def nvcc_build(name, src, defines):
    """Build ``src`` with its constants rewritten (``{name: value}``) into
    ``build/tools/<hash>/lib<name>.so``; returns the CDLL."""
    from repro_torch.kernels import _build
    out = ROOT / "build" / "tools" / _build._source_hash()
    out.mkdir(parents=True, exist_ok=True)
    body = src.read_text()
    for const, val in defines.items():
        body, n = re.subn(rf"constexpr (int|bool) {const} = [^;]+;",
                          rf"constexpr \g<1> {const} = {val};", body)
        if n != 1:
            raise SystemExit(f"FAIL: {src} has no one {const} constant")
    copy = out / f"{name}.cu"
    copy.write_text(body)
    lib = out / f"lib{name}.so"
    # -I: the copy's relative includes resolve from the source's folder
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
           "-I", str(src.parent), "-o", str(lib), str(copy)]
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if p.returncode:
        raise SystemExit(f"FAIL: nvcc {name}:\n{p.stdout}{p.stderr}")
    for line in (p.stdout + p.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {name}: {line.strip()}")
    return ctypes.CDLL(str(lib))


def fmt(times):
    return (" / ".join(f"{x:.5f}" for x in times)
            + f" (median {statistics.median(times):.5f})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--no-sact", action="store_true")
    ap.add_argument("--no-ballquery", action="store_true")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("FAIL: torch sees no CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import numpy as np
    from chip_smoke import cuda_time_ms, kernel_device_ms
    from repro_torch.core.ballquery import radius_sq
    from repro_torch.core.octree import build_octree
    from repro_torch.data.robotics import make_scene, scene_trajectories
    from repro_torch.kernels import _build
    from repro_torch.kernels.ballquery import ops as bq_ops
    from repro_torch.kernels.ballquery.ref import ball_query_ref
    from repro_torch.kernels.fps import ops as fps_ops
    from repro_torch.kernels.sact import ops as sact_ops
    from repro_torch.kernels.sact.ref import sact_ref

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"[card] {card}", flush=True)
    _build.build_all()
    pkg = ROOT / "src" / "repro_torch"
    jobs = {}
    with ThreadPoolExecutor(16) as ex:
        if not args.no_ballquery:
            for c in BQ_CHUNKS:
                jobs[("bq", c)] = ex.submit(
                    nvcc_build, f"ballquery_chunks{c}",
                    pkg / _build.SOURCES["ballquery"], {"kChunks": c})
            jobs[("bq", "no split")] = ex.submit(
                nvcc_build, "ballquery_nosplit",
                pkg / _build.SOURCES["ballquery"], {"kSplit": "false"})
            jobs["bq parent"] = ex.submit(
                nvcc_build, "ballquery_variants",
                ROOT / "tools" / "ballquery_variants.cu", {})
        if not args.no_sact:
            for v in SACT_VARIANTS:
                bm, bn, vv, st = v
                jobs[("sact", v)] = ex.submit(
                    nvcc_build, f"sact_dense_{bm}x{bn}_v{vv}_{int(st)}",
                    pkg / _build.SOURCES["sact_dense"],
                    {"kBM": bm, "kBN": bn, "kV": vv,
                     "kStream": "true" if st else "false"})
            jobs["sact parent"] = ex.submit(
                nvcc_build, "sact_dense_variants",
                ROOT / "tools" / "sact_dense_variants.cu", {})
        libs = {key: job.result() for key, job in jobs.items()}
    cuda = torch.device("cuda", 0)
    result = {"card": card, "ballquery": {}, "sact_dense": {}}

    def timed_alone(fns):
        """{label: [ms per round]}: each (fn, key) alone, in turns."""
        out = {label: [] for label in fns}
        for _ in range(ROUNDS):
            for label, (fn, key, name) in fns.items():
                out[label].append(kernel_device_ms(fn, key, REPS, name))
        return out

    if not args.no_ballquery:
        shipped = _build.load("ballquery")
        var = libs["bq parent"].bq_parent_launch
        var.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                        + [ctypes.c_float, ctypes.c_int]
                        + [ctypes.c_void_p] * 3)
        var.restype = ctypes.c_int
        tab = make_scene("tabletop", num_points=524288).points
        rsb = np.random.RandomState(5)
        clouds = torch.from_numpy(np.stack([
            tab[rsb.choice(len(tab), 2048, replace=False)]
            for _ in range(32)])).to(cuda)

        def layer(pts, m):
            c = fps_ops.fps(pts, m).to(torch.int64)
            return pts[torch.arange(pts.shape[0], device=cuda)[:, None], c]
        q1 = layer(clouds, 256)
        one = clouds[:1]
        s1 = layer(one, 256)
        s2 = layer(s1, 64)
        s3 = layer(s2, 16)
        shapes = [("sa1 B=32", q1, clouds, 0.1, 16),
                  ("sa1 B=1", s1, one, 0.1, 16),
                  ("sa2 B=1", s2, s1, 0.25, 16),
                  ("sa3 B=1", s3, s2, 0.6, 8)]
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        for name, qs, pts, r, k in shapes:
            B, M, _ = qs.shape
            N = pts.shape[1]
            want = ball_query_ref(pts, qs, r, k)
            qb0 = bq_ops.query_block(B, M, sms)

            def shipped_at(qb=None, lib=None, qs=qs, pts=pts, r=r, k=k):
                if qb is None and lib is None:
                    return bq_ops.ball_query(qs, pts, r, k)
                saved = bq_ops._launch, bq_ops._block
                if lib is not None:
                    _build._LIBS["ballquery"], bq_ops._launch = lib, None
                if qb is not None:
                    bq_ops._block = lambda *a: qb
                try:
                    return bq_ops.ball_query(qs, pts, r, k)
                finally:
                    _build._LIBS["ballquery"] = shipped
                    bq_ops._launch, bq_ops._block = saved

            def parent(qs=qs, pts=pts, r=r, k=k, B=B, M=M, N=N):
                idx = torch.empty((B, M, k), dtype=torch.int32, device=cuda)
                cnt = torch.empty((B, M), dtype=torch.int32, device=cuda)
                err = var(qs.data_ptr(), pts.data_ptr(), B, M, N,
                          radius_sq(r), k, idx.data_ptr(), cnt.data_ptr(),
                          torch.cuda.current_stream().cuda_stream)
                if err:
                    raise SystemExit(f"FAIL: parent ballquery: error {err}")
                _build.count_launch("ballquery")
                return idx, cnt
            fns = {f"shipped (qb {qb0})": (shipped_at, "ballquery_kernel",
                                           "ballquery")}
            for qb in BQ_BLOCKS.get(B, []):
                if qb != qb0:
                    fns[f"qb {qb}"] = ((lambda qb=qb: shipped_at(qb)),
                                       "ballquery_kernel", "ballquery")
            for c in BQ_CHUNKS:
                fns[f"{c} chunks a trip"] = (
                    (lambda lib=libs[("bq", c)]: shipped_at(None, lib)),
                    "ballquery_kernel", "ballquery")
            fns["no split"] = (
                (lambda lib=libs[("bq", "no split")]: shipped_at(None, lib)),
                "ballquery_kernel", "ballquery")
            fns["parent"] = (parent, "bq_parent", "ballquery")
            for label, (fn, _, _) in fns.items():
                got = fn()
                if not (torch.equal(got[0], want[0])
                        and torch.equal(got[1], want[1])):
                    raise SystemExit(f"FAIL: ballquery {name} {label} != "
                                     f"plain")
            full = float((want[1] == k).float().mean())
            call = cuda_time_ms(shipped_at, 50)
            alone = timed_alone(fns)
            result["ballquery"][name] = dict(
                B=B, M=M, N=N, r=r, k=k, qb=qb0, full=full, call_ms=call,
                kernel_ms=alone)
            print(f"[ballquery] {name} (M {M}, N {N}, r {r}, k {k}; "
                  f"{100 * full:.1f} % of balls full) | call {call:.5f} ms | "
                  f"kernel alone: " + "; ".join(
                      f"{lab} {fmt(v)}" for lab, v in alone.items())
                  + f" ms | {card}", flush=True)

    if not args.no_sact:
        scene = make_scene("cubby", num_points=524288)
        tree = build_octree(scene.points, depth=7)
        obbs = scene_trajectories(scene, num_trajectories=25, waypoints=60)
        o = sact_ops.pack_obbs(obbs.center, obbs.half, obbs.rot).to(cuda)
        aabbs = tree.node_aabbs(5)
        N = min(aabbs.n, 4096)
        a = sact_ops.pack_aabbs(aabbs.center[:N], aabbs.half[:N]).to(cuda)
        want = sact_ref(o, a, False)
        M = o.shape[0]
        shipped = _build.load("sact_dense")
        par = libs["sact parent"].sact_dense_parent_launch
        par.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        par.restype = ctypes.c_int

        def dense(mode=sact_ops.STAGE_MODE, lib=shipped):
            _build._LIBS["sact_dense"] = lib
            try:
                return sact_ops.sact_dense_in_mode(o, a, False, mode)
            finally:
                _build._LIBS["sact_dense"] = shipped

        def parent():
            c = torch.empty((M, N), dtype=torch.bool, device=cuda)
            e = torch.empty((M, N), dtype=torch.int32, device=cuda)
            err = par(o.data_ptr(), a.data_ptr(), c.data_ptr(), e.data_ptr(),
                      M, N, 0, torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit(f"FAIL: parent sact_dense: error {err}")
            _build.count_launch("sact_dense")
            return c, e
        key = "sact_dense_kernel"
        fns = {f"shipped ({sact_ops.STAGE_MODE})": (dense, key, "sact_dense")}
        for mode in sact_ops.STAGE_MODES:
            if mode != sact_ops.STAGE_MODE:
                fns[f"16x512 V4 stream, {mode}"] = (
                    (lambda mode=mode: dense(mode)), key, "sact_dense")
        for v in SACT_VARIANTS:
            bm, bn, vv, st = v
            for mode in sact_ops.STAGE_MODES:
                fns[f"{bm}x{bn} V{vv} {'stream' if st else 'plain'}, "
                    f"{mode}"] = (
                    (lambda mode=mode, lib=libs[("sact", v)]: dense(mode, lib)),
                    key, "sact_dense")
        fns["parent"] = (parent, "sact_dense_parent", "sact_dense")
        for label, (fn, _, _) in fns.items():
            got = fn()
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                raise SystemExit(f"FAIL: sact_dense {label} != plain")
        e = want[1]
        hist = torch.bincount(e.reshape(-1), minlength=18).tolist()
        # a warp's slot v holds boxes 4 * lane + v of a 128-box group: the
        # share of slots whose stage runs, where a pair is still undecided
        # before it (spheres off: the OBB's faces past code 4, the edges
        # past code 7)
        shares = {}
        if N % 128 == 0:
            for stage, first in (("obb faces", 5), ("edges", 8)):
                need = (e >= first).reshape(M, N // 128, 32, 4).any(dim=2)
                shares[stage] = float(need.float().mean())
        call = cuda_time_ms(dense, 20)
        alone = timed_alone(fns)
        # rows off a vector's alignment: the same plane one box short
        a_odd = a[:N - 1].contiguous()
        want_odd = sact_ref(o, a_odd, False)
        got = sact_ops.sact_dense(o, a_odd)
        if not (torch.equal(got[0], want_odd[0])
                and torch.equal(got[1], want_odd[1])):
            raise SystemExit("FAIL: sact_dense on N - 1 boxes != plain")
        odd = timed_alone({"shipped": (lambda: sact_ops.sact_dense(o, a_odd),
                                       key, "sact_dense")})
        result["sact_dense"] = dict(M=M, N=N, hist=hist,
                                    stage_slot_shares=shares, call_ms=call,
                                    kernel_ms=alone,
                                    kernel_ms_n_minus_1=odd["shipped"])
        print(f"[sact_dense] {M} x {N} plane: exit codes {hist}; share of "
              f"warp slots (4 boxes a thread) that run the OBB's faces and "
              f"the edges {shares} | call {call:.5f} ms | kernel alone: "
              + "; ".join(
                  f"{lab} {fmt(v)}" for lab, v in alone.items())
              + f" ms; on {N - 1} boxes (rows off alignment) "
              + fmt(odd["shipped"]) + f" ms | {card}", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
