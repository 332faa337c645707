#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each prints lines tagged with its number; any failure exits
non-zero and prints no result):

1. the card: ``nvidia-smi`` name and power limit, torch's device name/count;
2. build every CUDA kernel from ``src/repro_torch/**/csrc`` (nvcc, sm_90a)
   and print ``-Xptxas -v`` for each compiled function (registers, shared
   memory, spills), the Hopper flash kernel's shape at each width
   (registers a thread per role after ``setmaxnreg``, dynamic shared
   memory, rows, keys and ring stages), and ``persist``'s cluster shape
   with ``cudaOccupancyMaxActiveClusters`` at tiles of 128, 256, 512 and
   1024 slots (the owner-group tiles of swept-edge CCD grow to 1024), and
   at 128 and 1024 slots on bf16 and u8 rows, resident and with 2,802
   windows a level (phase 23's big scene);
3. ``sact_dense`` kernel vs its plain version on grazing planes (every exit
   code, both sphere settings), exactly equal, in every stage mode of
   ``sact_tile.cuh`` that a kernel ships (``sact_ops.STAGE_MODES``);
4. ``persist`` kernel vs ``persist_tiles_ref`` on a small scene, with and
   without frontier overflow, exactly equal: identity pools, owner-group
   pools (also at tiles of 256 and 1024 slots, with and without
   overflow), a skewed pool (``kernels/persist/cases.py``: one heavy tile
   whose widest level spills part way through its children), grazing
   pools (OBBs against level-4 cells, both sphere settings) and the
   owner-group tiled pool that ``build_tile_map`` packs from a real sweep
   round (owners and payloads of the widest width-1 round of 32 edges at
   R = 16 on the small scene; pads at each tile's tail); every pool on
   fp32, bf16 and u8 rows, resident and streamed (the default window and
   windows of 64 rows), every output but ``meta_rows`` also equal to fp32
   resident rows', ``meta_rows`` equal across formats; and ragged pools
   (``cases.ragged_pool``: three scenes of mixed sizes, each in a box of
   its own, over their flat table in scene-exclusive tiles; identity and
   owner groups, clean and spilling) in every format and layout;
5. the paper-scale scenes: ``make_scene(env, 524288)``,
   ``build_octree(depth=7)``, ``scene_trajectories(25, 60)`` (10,500 link
   OBBs) for each environment;
6. ``traverse`` kernel vs ``traverse_test_ref`` on the cubby scene: the
   10,500 OBBs against level-5 cells with a live prefix short of the
   capacity, of 0, 1 and the whole capacity, a capacity that is no
   multiple of 4 with queries out of range, and grazing frontiers (OBBs
   placed against real cells by bisection; all 18 exit codes), both
   sphere settings, words equal;
7. ``compact`` kernel vs ``compact_ref``: mask densities 0, 1e-3, 0.5 and
   1 over a lane count that is no multiple of the kernel's tile, and an
   ``n_out`` below the total; count and every output row equal;
8. the main paths at paper scale, per environment, in each of the modes
   ``wavefront_persistent``, ``wavefront`` and ``wavefront_fused`` (and
   ``wavefront_fused`` and ``wavefront_persistent`` on u8 rows in the
   first environment, the latter resident and streamed): two CUDA
   queries through ``CollisionEngine(...).query``, held against the same
   engine on the CPU (verdicts and every counter), the per-level modes
   also against the persistent one (all but ``bytes_moved`` and
   ``escalations``); launch counts are set to 0 just before each path and
   read just after; then warm wall time (median of 10), the kernels' time
   per launch (CUDA events, replaying one warm query's launches; for
   ``persist`` the call, with the heaviest and the mean tile's nodes) and
   the peak device memory;
9. ``traverse`` and ``compact`` timed at the widest level of the cubby
   ``wavefront_fused`` query against their bounds, plain versions and (for
   ``compact``) one PyTorch call computing the same function; both also
   by ``torch.profiler``, the kernel's own time on the card beside the
   call's (which the host paces); then ``persist`` alone by
   ``torch.profiler`` on each environment's phase-8 inputs (after every
   call is timed, as the profiler slows the calls timed after it);
10. ``sact_dense`` timed on the paper-scale queries against level-5 cells,
   the call and the kernel alone (``torch.profiler``), with the plane's
   exit-code histogram and the share of warp slots that run the edge stage;
11. ``fps`` kernel vs its plain version, indices exactly equal: B = 1 and
   32 clouds of 2048, 2047 and 5000 points, m = 256, lattice clouds with
   duplicates (ties, and zero distances once every distinct point is
   taken), ``first`` != 0; clouds of 1000, 33, 20 and 9000 points and the
   largest the wrapper takes (``MAX_POINTS``); one point with m = 1 and
   5; more picks than a lattice cloud's distinct points;
12. ``ballquery`` kernel vs its plain version, counts and every index
   exactly equal: the sa1 shapes (B = 32, M = 256, N = 2048, r = 0.1,
   k = 16) on a sparse cloud (most balls short of k) and a dense one
   (saturated), a ragged case, and points at and one ulp around the
   radius for r = 0.05 ... 0.6 (the threshold is float32(r * r) of the
   double product, not float32(r) ** 2); and ``kernels/ballquery/
   cases.py::cloud_cases``: clouds over one staged tile (2,049, 5,000 and
   16,384 points), of 1, 31 and 33 points, query counts that are no
   multiple of a query block, a block whose balls all fill within the
   first tile, a cloud in which no ball fills;
13. the neural-planner path of ``benchmarks/run.py::fig18_pipeline``: the
   tabletop scene at paper scale, a 2048-point cloud, a ``Planner`` at the
   default width (feature 256, hidden 512) with seeded weights, 20 steps,
   ``sampling`` fps and random, the gate in ``wavefront_fused`` and
   ``wavefront_persistent``, through ``plan_with_collision_gate`` on the
   card; held against the same planner on the CPU (sampling and grouping
   indices of every layer exact, features and waypoints to ``FEAT_TOL``
   and ``WAYPOINT_ATOL``, gate verdicts and every counter bitwise on the
   CUDA trajectory); launch counts set to 0 just before each path and read
   just after; warm stage walls (median of 10), kernel time per launch and
   peak memory; then one batched plan of 32 clouds for throughput;
14. ``fps`` and ``ballquery`` timed at the batched encode's sa1 shapes
   against their bounds and plain versions, each also alone by
   ``torch.profiler``; ``ballquery`` also at the single plan's three
   layers (B = 1: (M, N, r, k) = (256, 2048, 0.1, 16), (64, 256, 0.25,
   16), (16, 64, 0.6, 8)), the call and the kernel alone;
15. ``wkv6`` kernel vs its plain version on ``kernels/wkv6/cases.py``
   (T = 1, 33, 1024 at D = 16, 64; the chunk edges T = 31, 32, 33, 64,
   65 at D = 16, 32, 33, 64, 128; T = 1, 1024 at D = 32, 128; per-row
   and shared ``u``; ordinary, strong and weak decays), fp32 and bf16
   inputs, within ``cases.TOL``;
16. the RWKV-6 1.6B model at full width cut to 2 of its 24 layers, in fp32
   (TF32 off), on the card against the same weights on the CPU: B = 2, a
   64-token prompt and 4 teacher-forced decode steps, logits and every
   cache field within ``LM_FP32_TOL``;
17. the RWKV-6 serving path: ``lm.serve.serve`` on the full 24-layer bf16
   ``rwkv6_1_6b`` (weights drawn on the card from a seeded generator), 8
   prompts of 1024 tokens and 32 greedy tokens; launch counts set to 0
   just before it and read just after (24 ``wkv6`` a prefill, 0 in
   decode); ``wkv6`` against its plain version on the 24 prefill inputs a
   recorder captured; warm prefill and decode walls (median of 10 serves),
   tokens/s, peak memory, a profiled serve's busy share, the kernel's time
   per launch (the call, and the kernel alone by ``torch.profiler``)
   against its bound (bytes, or the
   chunked form's operations: products at the TF32 rate three times for
   the split, elementwise work at the fp32 rate; the step form's
   operations printed beside it) and its plain version, and the
   prefill/decode consistency of the logits (``LM_CONSIST_ATOL``);
18. ``flash_attention`` kernel vs its plain version on
   ``kernels/flash_attention/cases.py`` (d = 16, 32, 64, 128; causal with
   Tq = Tk = 1, 63, 64, 65, 127, 128, 129, 255, 257, 1024, 1025;
   non-causal Tq != Tk, Tk no multiple of 8 among them; 1, 4 and 16
   query heads a KV head; (B, H, T, d) tensors and (B, H, T, d) views of
   (B, T, H, d) ones; large-magnitude scores), fp32 and bf16, within
   ``cases.TOL``;
19. the GLM-4 9B model at full width cut to 2 of its 40 layers, in fp32
   (TF32 off), weights drawn on the card and copied to a CPU twin: B = 2,
   a 64-token prompt and 4 teacher-forced decode steps, logits and the k
   and v caches within ``LM_FP32_TOL``;
20. the GLM-4 9B serving path: ``lm.serve.serve`` on the full 40-layer
   bf16 ``glm4_9b`` (weights drawn on the card from a seeded generator), 8
   prompts of 1024 tokens and 32 greedy tokens; launch counts set to 0
   just before it and read just after (40 ``flash_attention`` a prefill,
   0 in decode, every other kernel 0); the kernel against its plain
   version on the 40 prefill inputs a recorder captured; warm prefill and
   decode walls (median of 10 serves), tokens/s, peak memory, a profiled
   serve's busy share, the kernel's time per launch against its bound, its
   plain version and ``scaled_dot_product_attention`` (the yardstick,
   never used by the port), its achieved TFLOP/s, share of the bound and
   ratio to the yardstick, and the prefill/decode consistency of the
   logits at 1025 tokens (``LM_CONSIST_ATOL``);
21. swept-edge CCD at ``benchmarks/run.py::fig_edges``' full scale: the
   cubby scene (524,288 points, depth 7), 64 PRM edges drawn as
   ``fig_edges`` draws them, R = 32, ``check_edges`` in each of
   ``wavefront_persistent``, ``wavefront`` and ``wavefront_fused`` on the
   card; launch counts set to 0 just before each path and read just after
   (``persist`` launches = the persistent sweep's engine calls plus their
   escalations); held against the same engine on the CPU (first hits,
   verdicts, every counter; the CPU sweep takes the card's FK arrays),
   the modes against each other, the swept verdicts against dense
   sampling of the 64 x 33 waypoints, and ``in_traversal_exit=False``
   against the exit arm (same verdicts, at least as many nodes); every
   ``persist`` call of a persistent sweep against ``persist_tiles_ref``;
   the rounds with their slots and tiles, warm walls (median of 10)
   beside the dense check's, a warm sweep's host time split into FK,
   swept fits and engine calls, a traced sweep's busy share, the
   ``persist`` calls timed and the largest alone by ``torch.profiler``,
   peak memory; then ``fig_edges``' no-exit baseline, ``check_edges`` on a
   ``staged_noexit`` engine (boolean rounds reduced on the host, only
   ``compact`` launched), held against the CPU sweep on the card's FK
   arrays and against the exit arm's first hits, with ``fig_edges``' node
   ratio, no exit over exit;
22. the Fig. 11 ablation arms at paper scale (``benchmarks/run.py::
   fig11``): ``naive``, ``rta_like``, ``staged_noexit``, ``predicated`` and
   ``wavefront_host`` on the card for each phase-5 scene, launch counts
   set to 0 just before each query and read just after (``naive``: one
   ``sact_dense`` a block of ``query_block`` OBBs; the host arms: one
   ``compact`` a level after the first; nothing else); every arm's
   verdicts equal to phase 8's card ``wavefront``, ``wavefront_host`` and
   ``predicated`` equal to it on every work counter, ``rta_like`` equal to
   ``staged_noexit`` but for its shader calls and their bytes,
   ``staged_noexit`` visiting at least ``wavefront``'s nodes, ``naive``'s
   counters in their closed form (its exit histogram sums to queries x
   leaves); on cubby the card against the CPU engine, every counter, for
   each host arm on the whole query and for ``naive`` on its first and
   last 128 OBBs; per arm the fields Fig. 11's cycle model reads, warm
   walls (median of 5) beside phase 8's, peak memory, and any frontier
   overflow; one traced warm ``wavefront_host`` and ``naive`` query each,
   the busy share and the largest device items; and
   ``sact_dense`` at ``naive``'s block shape (128 OBBs x the leaves), the
   call and the kernel alone, against its bound and plain version;
23. ``benchmarks/run.py::fig_bigscene``'s two scenes at full scale (depth
   8; 524,288 and 3,145,728 points uniform in [-1, 1]^3 from
   ``RandomState(5)``; 1,500 OBBs from ``random_obbs`` on a seeded
   generator; ``max_frontier`` raised so that no engine clamps): per scene
   the default ``wavefront_persistent`` engine (resident bf16 on the small
   scene, streamed bf16 on the big one), ``fig_bigscene``'s fp32 pins and
   ``fig_compress``'s streamed engines (fp32 and bf16 on the big scene, u8
   on the small one; u8 pinned on the big one raises ``ValueError``);
   each engine's launches (one ``persist`` a query plus its escalations),
   verdicts equal to the card's ``wavefront_fused``, every counter equal
   to the CPU engine's on the first 128 OBBs, ``meta_bytes_streamed`` =
   rows x the row's bytes; warm walls (median of 5) beside
   ``wavefront_fused``'s, ``persist``'s call and the kernel alone against
   the plain version and the bound (the rows and pairs it reads), the
   busy share of a traced warm query;
24. ragged multi-scene batches through ``query_batched_scenes`` and
   ``CollisionEngine(trees).execute(plan_scenes(obbs))``: (a)
   ``benchmarks/run.py::ragged_scenes`` at ``FULL_SCALE`` (depth 5; three
   scenes of 32,768 and one of 524,288 uniform points in [-1, 1]^3 from
   ``RandomState(0)`` in its order; 100 ``random_obbs`` a scene from
   seeded generators): padded ``wavefront``, ragged persistent (default
   and streamed) and ragged fused on the small-only and the mixed batch,
   verdicts equal across arms, card == CPU engine on every counter,
   warm walls (median of 10) and ``big_scene_cost``; (b) the four Table
   III scenes of phase 5 with phase 8's 10,500 OBBs each as one ragged
   batch (332 scene-exclusive tiles): persistent (the default choice and
   pinned streamed), fused and padded ``wavefront``, each scene's
   verdicts equal to phase 8's, the work counters equal to the sum of
   phase 8's four runs, the default persistent arm equal to the CPU
   engine on the first 1,500 OBBs of each scene; warm walls beside the
   sum of phase 8's four persistent walls, the ``persist`` launch of a
   warm query replayed against its plain version, timed (the call, the
   kernel alone) against its bound, its launch shape, and the busy share
   of a traced warm query;
25. the other workloads at their benchmark scale (``other_workloads``):
   (a) the ``march`` kernel against ``march_ref``, bit for bit (pos, dist,
   active, and both ray casts' ranges and cells with the plain march
   swapped in), on Fig. 19's grid and a 70 x 130 grid without walls, on
   Fig. 19's 4,608 scan rays, rays grazing cell corners and edges along
   the axes and diagonals, and rays leaving the grid, at 1, 16 and every
   step of a 6 m cast; (b) ``benchmarks/run.py::fig19_mcl``: the corridor
   grid of 192 cells, 24 scan angles, true pose (5, 5, 0.4), 192
   particles, 8 iterations, sigma 0.5, under the ``dense``, ``compacted``
   and ``dynamic`` (threshold 60) policies, each iteration's engine,
   cells per ray, ``time_s`` and launches, the mean ``time_s`` and the
   mean pose error, one compacted ``mcl_update`` card against CPU (the
   CPU on the card's directions; ranges and cells equal, weights within
   rtol 1e-5, resampling indices equal away from the cumulative
   weights), the dense and compacted casts against each other, and
   ``march`` timed at the scan's shape (the call, the kernel alone)
   against its plain version and bound; (c) the filter with its
   collision gate (the grid's walls 0.8 m tall as points, depth 7,
   ``wavefront_persistent``), every step's gate against the CPU engine
   on the card's footprint OBBs; (d) ``table4_pray_psphere`` at
   ``FULL_SCALE`` (cubby, 524,288 points, depth 7, 512 queries from
   ``RandomState(0)``, r 0.05, k 32; P-Sphere with and without the early
   exit, P-Ray on a depth-4 tree), counts equal to the ``ballquery``
   kernel's brute force, card against CPU (``idx`` in order, counts,
   every counter), nodes, the no-exit / exit node ratio, the 2**22 cut,
   warm walls and peak memory; (e) ``fig17_radius_sweep`` (256 queries
   from ``RandomState(1)``, r 0.05 to 0.4) the same way; (f)
   ``fig14_mpaccel`` at ``FULL_SCALE`` (10 scenes of 65,536 points, depth
   5, 700 OBBs each) in ``naive``, ``wavefront_fused`` and
   ``wavefront_persistent``, each card against the CPU engine, verdicts
   equal across modes, walls, nodes, leaf tests and launches;
26. the collision service (``service_phase``) on phase 5's cubby scene:
   (a) ``launch.serve.run_service`` over a ``RequestBatcher`` (the
   reference's defaults: ``max_batch`` 1024, ``max_wait_ms`` 2.0, pow2
   pads) in ``wavefront_persistent`` and ``wavefront_fused``, 8 and then
   32 closed-loop clients, each request 12 consecutive of phase 5's
   10,500 link OBBs: every request's verdicts against phase 8's, every
   coalesced pool replayed on the CPU engine from the card engine's
   capacity memo before it (verdicts and every counter), p50 / p99 ms, queries/s, launches, requests a launch, the
   pad fraction, the main path's kernel launches, the card's busy share
   over one traced run, and a 12-OBB request straight to the engine
   beside phase 8's warm query; (b) ``shards=1`` (the sharded path on the
   card) against phase 8's unsharded engine in both modes, verdicts and
   every counter, ``shards=2`` where the machine has two cards, and
   ``persist`` on the last block of an 8-way split (a live prefix short
   of its pool) against its plain version; (c) ``run_service`` under
   ``default_fault_plan(0)`` (deadline 2000 ms, ``launch_timeout_s`` 1.0)
   at one shard: every submit resolves, only typed failures, the served
   requests' verdicts phase 8's, an injected device loss typed
   ``DeviceLost`` and never bisected; (d) degraded launches
   (``wavefront_fused``, ``degrade_queue`` 2, 32 clients): every verdict
   a superset of phase 8's, the coarser ones all flagged ``degraded``;
27. one JSON line listing every kernel with its launches on the main paths
   (``launches``, phases 8, 13, 17, 20, 21, 22, 23, 24, 25 and 26) and
   elsewhere (``check_launches``), error, times (for ``persist``, ``sact_dense``,
   ``fps`` and ``ballquery`` also ``kernel_ms``, the kernel alone by
   ``torch.profiler``; ``sact_dense``'s at ``naive``'s block shape, with
   phase 10's plane as ``plane_*``; for ``ballquery`` also
   ``single_plan``, the single plan's three layers) and bound; the
   last line is
   ``{"ok": true, "device": {...}}``.

Each phase prints its seconds.

It imports nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, non-tensor fp32, and
# dense bf16 and TF32 on the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
PEAK_BF16_PER_S = 989e12
PEAK_TF32_PER_S = 495e12
# A profiled window (kernel_device_ms) opens with this many kernels that it
# does not count, and leaves this much idle time on either side of its calls.
PROFILER_LEAD_IN = 4
PROFILER_PAUSE_S = 0.05

# fp32 operations the SACT runs per pair (adds, multiplies, compares,
# min/max; abs is a sign-bit op and not counted): setup t and |R| + eps,
# the sphere stage, and each axis test in stage order.
OPS_SETUP = 12
OPS_SPHERES = 22
OPS_AXIS = [7] * 3 + [12] * 3 + [11] * 9
OPS_NODE_BOX = 10        # megakernel: node centre and half from the code

# The neural-planner path, card against CPU: fp32 matrix products summed in
# another order (cuBLAS vs the CPU's BLAS; TF32 off) move the last bits of
# every MLP layer, and 20 policy steps add them up.
FEAT_TOL = dict(rtol=1e-4, atol=1e-5)
WAYPOINT_ATOL = 1e-4

# RWKV-6 serving (phases 16-17).  Card against CPU in fp32: the matrix
# products are summed in another order (cuBLAS vs the CPU's BLAS, TF32
# off), about 1e-6 relative at these widths.  Prefill against decode in
# bf16: cuBLAS picks other kernels for 8 rows than for 8,200, so some bf16
# roundings of the projections differ and 24 layers carry them to the
# logits (std ~0.9); a greedy token may differ only where the top two
# logits lie within twice the observed difference.
LM_FP32_TOL = dict(rtol=1e-4, atol=1e-4)
LM_CONSIST_ATOL = 0.25
LM_BATCH, LM_PROMPT, LM_TOKENS = 8, 1024, 32
LM_CUT_LAYERS, LM_CUT_BATCH, LM_CUT_PROMPT, LM_CUT_STEPS = 2, 2, 64, 4
# GLM-4 9B serving (phases 19-20) uses the same sizes and tolerances, so the
# two LM paths read alike: the same reasons hold (fp32 products summed in
# another order; bf16 roundings that cuBLAS places differently for 8 rows
# than for 8,192, and here also the kernel's bf16 softmax weights, carried
# through 40 layers).


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


def kernel_name(mangled: str) -> str:
    """``ns::kernel<N, true>`` of a mangled kernel name, as far as these
    kernels need: the last of its length-prefixed names, and its int and
    bool template arguments."""
    names, p = [], 3 if mangled.startswith("_ZN") else 2
    while p < len(mangled) and mangled[p].isdigit():
        q = p
        while mangled[q].isdigit():
            q += 1
        n = int(mangled[p:q])
        names.append(mangled[q:q + n])
        p = q + n
    t = re.match(r"I((?:L[ib]\d+E)+)E", mangled[p:])
    name = names[-1] if names else mangled
    if not t:
        return name
    args = [v if k == "i" else ("true" if v == "1" else "false")
            for k, v in re.findall(r"L([ib])(\d+)E", t.group(1))]
    return f"{name}<{', '.join(args)}>"


def device_us(event) -> float:
    """A profiler event's own time on the card, in microseconds."""
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0))


def kernel_device_ms(fn, key: str, reps: int, name: str,
                     tries: int = 3, required: bool = True):
    """The mean device time of a kernel whose name holds ``key``, over a
    window of ``reps`` calls of ``fn`` (``torch.profiler``), which must
    launch kernel ``name`` once a call (the wrappers' counters) and leave
    exactly one record a call.  Late in this script the profiler drops
    the first kernel record of a window (the card showed 19 records after
    20 launches, the first one missing), so each window opens with a few
    fills of a scratch word, which match no kernel's key, and idle time on
    either side of the calls.  A window that still lost a record is
    reported and taken again, up to ``tries`` windows; none is averaged.
    A call timed back to back with CUDA events is paced by the host where
    the kernel is short: this is the kernel alone.  With ``required``
    False, a kernel whose records every window lost gives None."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    from repro_torch.kernels import _build
    fn()
    scratch = torch.empty(1, device="cuda")
    torch.cuda.synchronize()
    seen = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(PROFILER_LEAD_IN):
                scratch.fill_(0.0)
            torch.cuda.synchronize()
            time.sleep(PROFILER_PAUSE_S)
            before = _build.launch_counts().get(name, 0)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            launched = _build.launch_counts().get(name, 0) - before
            time.sleep(PROFILER_PAUSE_S)
        if launched != reps:
            raise SystemExit(f"FAIL: {reps} calls launched {launched} {name} "
                             f"kernels")
        ev = [e for e in prof.key_averages() if key in e.key]
        n = sum(e.count for e in ev)
        if n == reps:
            if seen:
                log("profiler", f"{key}: windows that lost records saw "
                    f"{seen} of {reps}; this one saw {n}")
            return sum(device_us(e) for e in ev) / 1e3 / n
        seen.append(n)
        if n > reps:
            break
    if not required and max(seen) < reps:
        log("profiler", f"{key}: the profiler kept {seen} of {reps} records "
            f"in {len(seen)} windows: not measured")
        return None
    raise SystemExit(f"FAIL: {reps} calls launched {reps} {name} kernels; "
                     f"the profiler saw {seen} {key} kernels in "
                     f"{len(seen)} windows")


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
    """Within its ``with`` block, record every call of the given kernel
    wrappers (``{name: (module, attribute)}``; arguments kept, so each call
    can be replayed and timed); the calls still run."""

    def __init__(self, targets):
        self._mods = targets
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


#: Phase 25's workloads at their benchmark scale (``benchmarks/run.py``:
#: ``fig19_mcl`` :383, ``table4_pray_psphere`` :267, ``fig17_radius_sweep``
#: :305, ``fig14_mpaccel`` :208 at ``FULL_SCALE``).
OTHER_WORKLOADS = dict(
    grid=192, particles=192, angles=24, iters=8, pose=(5.0, 5.0, 0.4),
    sigma=0.5, threshold=60.0, max_range=6.0, gate_depth=7,
    points=524288, depth=7, t4_queries=512, t4_radius=0.05, k=32,
    pray_depth=4, f17_queries=256, f17_radii=(0.05, 0.1, 0.2, 0.4),
    scenarios=10, mpaccel_points=65536, mpaccel_depth=5, trajs=4, wps=25,
    walls=5, march_reps=20)
# Per live ray-step the march runs 12 fp32 operations (two products, four
# sums and differences, two quotients, two floors, the range's sum and
# compare); a ray's state is 21 B in (pos, dirv, dist, active) and 13 B
# out.
OPS_MARCH_STEP = 12
BYTES_MARCH_RAY = 34


def other_workloads(dev, card: str, main_launches: dict, add_check_launches,
                    lap, sizes: dict = OTHER_WORKLOADS,
                    check_kernels: bool = True) -> dict:
    """Phase 25: the other workloads of the paper on the card (MCL with
    its ray march and collision gate, the ball query as tree traversal,
    the MPAccel scenes), each held against the CPU; returns the JSON
    line of the ``march`` kernel.  ``sizes`` and ``check_kernels`` let a
    rehearsal on the CPU run it at a cut size."""
    import numpy as np
    import torch
    from repro_torch.core import ballquery as tbq
    from repro_torch.core import mcl as tmcl
    from repro_torch.core.geometry import OBBs
    from repro_torch.core.octree import build_octree
    from repro_torch.data.robotics import (make_mpaccel_scenario, make_scene,
                                           scene_trajectories)
    from repro_torch.engine.executor import CollisionEngine, EngineConfig
    from repro_torch.kernels import _build
    from repro_torch.kernels.ballquery import ops as bq_ops
    from repro_torch.kernels.march import ops as march_ops
    from repro_torch.kernels.march.cases import (FIG19_GRID_SEED,
                                                 nonsquare_grid, ray_cases,
                                                 wall_points)
    from repro_torch.kernels.march.ref import march_ref
    S = sizes
    t_phase = time.perf_counter()
    persistent = "wavefront_persistent"

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def on_main(fn, want=(), tag=""):
        """Run ``fn`` as a main path: launch counts set to 0 just before,
        read just after, added to ``main_launches``; every kernel of
        ``want`` must have launched."""
        add_check_launches()
        out = fn()
        sync()
        counts = _build.launch_counts()
        _build.reset_launch_counts()
        for name, n in counts.items():
            main_launches[name] += n
        for name in want:
            if check_kernels and counts[name] < 1:
                raise SystemExit(f"FAIL: 25 {tag}: {name} launched no time "
                                 f"on the main path ({counts})")
        return out, {k: n for k, n in counts.items() if n}

    def walls_of(fn):
        walls = []
        for _ in range(S["walls"]):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            walls.append(time.perf_counter() - t0)
        return 1e3 * statistics.median(walls)

    def peak_mib(fn):
        if dev.type != "cuda":
            fn()
            return float("nan")
        sync()
        torch.cuda.reset_peak_memory_stats()
        fn()
        sync()
        return torch.cuda.max_memory_allocated() / 2**20

    def same_counters(a, b):
        a, b = a.as_dict(), b.as_dict()
        return [k for k in a if k != "wall_time_s" and a[k] != b[k]]

    # (a) the march kernel against its plain version, bit for bit
    R_MAX = S["max_range"]
    grids = {"fig19": tmcl.make_corridor_world(FIG19_GRID_SEED,
                                               size=S["grid"], device=dev),
             "nonsquare": tmcl.OccupancyGrid(
                 occ=torch.from_numpy(nonsquare_grid()).to(dev), cell=0.05)}
    add_check_launches()
    mism = compared = 0
    march_err = 0.0
    for gname, grid in grids.items():
        steps = int(np.ceil(R_MAX / grid.cell)) + 1
        for case, (org, ang) in ray_cases(grid.shape, grid.cell).items():
            dirv = tmcl.ray_directions(torch.from_numpy(ang).to(dev))
            for n in (1, 16, steps):
                runs = []
                for fn in (march_ops.march, march_ref):
                    st = (torch.tensor(org, device=dev), dirv,
                          torch.zeros(len(ang), device=dev),
                          torch.ones(len(ang), dtype=torch.bool, device=dev))
                    fn(grid.occ, grid.origin, grid.cell, *st, R_MAX, n)
                    runs.append(st)
                sync()
                compared += 1
                for got, want in zip(runs[0], runs[1]):
                    if not torch.equal(got, want):
                        mism += 1
                        march_err = max(march_err, float(
                            (got.double() - want.double()).abs().max()))
        org, ang = ray_cases(grid.shape, grid.cell)["scan"]
        for cast in (tmcl.ray_cast_dense, tmcl.ray_cast_compacted):
            got = cast(grid, torch.from_numpy(org).to(dev),
                       torch.from_numpy(ang).to(dev), R_MAX)
            saved = tmcl.march
            tmcl.march = march_ref
            try:
                want = cast(grid, torch.from_numpy(org).to(dev),
                            torch.from_numpy(ang).to(dev), R_MAX)
            finally:
                tmcl.march = saved
            compared += 1
            if not (torch.equal(got[0], want[0]) and got[1] == want[1]):
                mism += 1
    if mism:
        raise SystemExit(f"FAIL: 25 (a): march differs from plain in {mism}"
                         f" of {compared} comparisons (max abs err "
                         f"{march_err})")
    log("25 other", f"(a) march == plain, bit for bit (pos, dist, active; "
        f"both casts' ranges and cells with the plain march swapped in): "
        f"{compared} comparisons on the Fig. 19 grid ({S['grid']}^2) and a "
        f"70 x 130 grid without walls; scan (4,608 rays), grazing (1,152: "
        f"cell corners and edges at 0, +-pi/4, +-pi/2, +-3pi/4, pi) and "
        f"leaving rays (48); 1, 16 and every step of a {R_MAX} m cast")
    add_check_launches()

    # (b) Fig. 19: the filter under each policy
    grid = grids["fig19"]
    P, A, iters = S["particles"], S["angles"], S["iters"]
    angles = torch.from_numpy(np.linspace(-np.pi, np.pi, A, endpoint=False)
                              .astype(np.float32)).to(dev)
    px, py, pth = S["pose"]
    zeros3 = torch.zeros(3, device=dev)
    (obs, _), _ = on_main(lambda: tmcl.ray_cast_dense(
        grid, torch.tensor([[px, py]], device=dev).repeat(A, 1),
        pth + angles, R_MAX), ("march",), "(b) scan")
    pol_mean = {}
    for policy in ("dense", "compacted", "dynamic"):
        gen = torch.Generator().manual_seed(1)
        st = tmcl.init_particles(gen, grid, P)
        hist, rows, times = 1e9, [], []
        for it in range(iters):
            eng = (policy if policy != "dynamic"
                   else tmcl.choose_engine(hist, threshold=S["threshold"]))
            (st, stats), counts = on_main(
                lambda: tmcl.mcl_step(gen, st, grid, obs, angles, zeros3, eng,
                                      max_range=R_MAX, sigma=S["sigma"]),
                ("march",), f"(b) {policy} step {it}")
            hist = stats["cells_per_ray"]
            if it > 0:
                times.append(stats["time_s"])
            rows.append(f"{it}:{eng[0]} {hist:.1f} cells/ray "
                        f"{1e3 * stats['time_s']:.3f} ms march "
                        f"{counts.get('march', 0)} compact "
                        f"{counts.get('compact', 0)}")
        pol_mean[policy] = statistics.mean(times)
        xy = st.particles[:, :2].double().cpu()
        err = float(torch.hypot(xy[:, 0] - px, xy[:, 1] - py).mean())
        log("25 other", f"(b) Fig. 19 {policy}: {P} particles x {A} rays, "
            f"{iters} iterations | " + "; ".join(rows) + f" | mean time_s "
            f"(iterations 1-{iters - 1}) {1e3 * pol_mean[policy]:.3f} ms | "
            f"mean pose error after the last step {err:.3f} m | {card}")
    best = min(pol_mean["dense"], pol_mean["compacted"])
    log("25 other", f"(b) Fig. 19 dynamic vs best fixed: "
        f"{best / pol_mean['dynamic']:.3f}x (dense "
        f"{1e3 * pol_mean['dense']:.3f}, compacted "
        f"{1e3 * pol_mean['compacted']:.3f}, dynamic "
        f"{1e3 * pol_mean['dynamic']:.3f} ms a cast)")

    # one compacted step, card against CPU on the same draws and the
    # card's directions
    def recorded_update(g, dev_, dirs=None):
        rec = {}
        saved = (tmcl.particle_weights, tmcl.resample_indices,
                 tmcl.ray_directions)
        weights, resample, directions = saved

        def w_rec(*a):
            rec["sim"] = a[0]
            rec["w"] = weights(*a)
            return rec["w"]
        tmcl.particle_weights = w_rec
        tmcl.resample_indices = lambda w, u: rec.setdefault(
            "sel", resample(w, u))
        tmcl.ray_directions = ((lambda a: dirs.to(a.device)) if dirs
                               is not None else (lambda a: rec.setdefault(
                                   "dirs", directions(a))))
        try:
            st0 = tmcl.init_particles(torch.Generator().manual_seed(3), g, P)
            noise = torch.randn((P, 3), generator=torch.Generator()
                                .manual_seed(4)) * 0.02
            _, rec["stats"] = tmcl.mcl_update(
                st0, g, obs.to(dev_), angles.to(dev_),
                torch.zeros(3, device=dev_), noise.to(dev_), 0.37,
                "compacted", max_range=R_MAX, sigma=S["sigma"])
        finally:
            (tmcl.particle_weights, tmcl.resample_indices,
             tmcl.ray_directions) = saved
        return rec
    add_check_launches()
    a = recorded_update(grid, dev)
    cpu_grid = tmcl.OccupancyGrid(grid.occ.cpu(), grid.cell)
    b = recorded_update(cpu_grid, torch.device("cpu"), dirs=a["dirs"].cpu())
    cum = torch.cumsum(b["w"].double(), 0).numpy()
    steps_u = (0.37 + np.arange(P)) / P
    near = np.abs(steps_u[:, None] - cum[None, :]).min(1) < 1e-6
    sel_ok = bool((a["sel"].cpu() == b["sel"])[torch.from_numpy(~near)]
                  .all())
    w_ok = bool(torch.allclose(a["w"].cpu(), b["w"], rtol=1e-5, atol=0))
    if not (torch.equal(a["sim"].cpu(), b["sim"]) and w_ok and sel_ok
            and a["stats"]["cells"] == b["stats"]["cells"]):
        raise SystemExit(f"FAIL: 25 (b): mcl_update card vs CPU: ranges "
                         f"equal {torch.equal(a['sim'].cpu(), b['sim'])}, "
                         f"cells {a['stats']['cells']} / "
                         f"{b['stats']['cells']}, weights within rtol 1e-5 "
                         f"{w_ok}, indices {sel_ok}")
    org, ang = ray_cases(grid.shape, grid.cell)["scan"]
    O, An = torch.from_numpy(org).to(dev), torch.from_numpy(ang).to(dev)
    rd, cd = tmcl.ray_cast_dense(grid, O, An, R_MAX)
    rc, cc = tmcl.ray_cast_compacted(grid, O, An, R_MAX)
    if not (torch.allclose(rd, rc, rtol=0, atol=1e-6) and cc <= cd):
        raise SystemExit(f"FAIL: 25 (b): dense vs compacted on the card: "
                         f"max |dr| {float((rd - rc).abs().max())}, cells "
                         f"{cc} vs {cd}")
    log("25 other", f"(b) one compacted mcl_update, card vs CPU (the CPU "
        f"on the card's directions): ranges and cells "
        f"({a['stats']['cells']}) equal, weights within rtol 1e-5 (max rel "
        f"{float(((a['w'].cpu() - b['w']).abs() / b['w']).max()):.2e}), "
        f"resampling indices equal ({int(near.sum())} of {P} steps within "
        f"1e-6 of a cumulative weight); dense vs compacted cast on the "
        f"card: ranges equal, cells {cc} <= {cd}")

    # march timed at Fig. 19's shape: a dense cast of the scan rays, each
    # launch on a fresh copy of the rays' state
    dirv = tmcl.ray_directions(An).contiguous()
    n_steps = int(np.ceil(R_MAX / grid.cell)) + 1
    fresh = [(O.clone(), torch.zeros(len(ang), device=dev),
              torch.ones(len(ang), dtype=torch.bool, device=dev))
             for _ in range(S["march_reps"] * 3 + 40)]
    it_fresh = iter(fresh)

    def one(fn=march_ops.march):
        pos, dist, active = next(it_fresh)
        fn(grid.occ, grid.origin, grid.cell, pos, dirv, dist, active, R_MAX,
           n_steps)
    if dev.type == "cuda":
        ms = cuda_time_ms(one, S["march_reps"])
        k_ms = kernel_device_ms(one, "march_kernel", 10, "march",
                                required=False)
        plain_ms = cuda_time_ms(lambda: one(march_ref), 2)
    else:
        ms = k_ms = plain_ms = float("nan")
    live_steps = int(torch.round(fresh[0][1] / grid.cell).sum())
    H, W = grid.shape
    bms, by = bound_ms(H * W + BYTES_MARCH_RAY * len(ang),
                       OPS_MARCH_STEP * live_steps)
    add_check_launches()
    log("25 other", f"(b) march at Fig. 19's shape ({len(ang)} rays, "
        f"{n_steps} steps, {live_steps} live ray-steps, the longest ray "
        f"{int(torch.round(fresh[0][1].max() / grid.cell))}): call "
        f"{ms:.4f} ms, the kernel alone "
        + ("not measured" if k_ms is None else f"{k_ms:.4f} ms")
        + f" (torch.profiler), plain {plain_ms:.3f} ms, bound {bms:.6f} ms "
        f"({by}) | {card}")
    march_line = dict(
        name="march", route="cuda",
        source="src/repro_torch/kernels/march/csrc/march.cu",
        replaces="src/repro/core/mcl.py:93 (jax.lax.fori_loop over "
                 "_march_step; no Pallas kernel)",
        max_abs_err=march_err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=None, kernel_ms=k_ms)

    # (c) the filter with the collision gate: the grid's walls 0.8 m tall
    # as a point cloud, depth 7, wavefront_persistent
    gtree = build_octree(wall_points(grid.occ.cpu().numpy(), grid.cell),
                         depth=S["gate_depth"])
    cfg = EngineConfig(mode=persistent)
    cpu_eng = CollisionEngine(gtree, cfg, device="cpu")

    class Recording:
        def __init__(self, engine):
            self.engine, self.calls = engine, []

        def query(self, obbs):
            v, c = self.engine.query(obbs)
            self.calls.append((obbs, v, c))
            return v, c
    rec = Recording(CollisionEngine(gtree, cfg, device=dev))
    gen = torch.Generator().manual_seed(1)
    st = tmcl.init_particles(gen, grid, P)
    hist, rows, walls, gate_pairs = 1e9, [], [], 0
    for it in range(iters):
        eng = tmcl.choose_engine(hist, threshold=S["threshold"])
        t0 = time.perf_counter()
        (st, stats), counts = on_main(
            lambda: tmcl.mcl_step(gen, st, grid, obs, angles, zeros3, eng,
                                  max_range=R_MAX, sigma=S["sigma"],
                                  collision_engine=rec),
            ("march", "persist"), f"(c) step {it}")
        walls.append(time.perf_counter() - t0)
        hist = stats["cells_per_ray"]
        obbs, v, c = rec.calls[-1]
        vc, cc_ = cpu_eng.query(OBBs(*(x.cpu() for x in (
            obbs.center, obbs.half, obbs.rot))))
        bad = same_counters(c, cc_)
        if not np.array_equal(v, vc) or bad:
            raise SystemExit(f"FAIL: 25 (c) step {it}: gate card vs CPU: "
                             f"verdicts equal {np.array_equal(v, vc)}, "
                             f"counters differing {bad}")
        gate_pairs += c.nodes_traversed
        rows.append(f"{it}:{eng[0]} colliding {stats['colliding_particles']}"
                    f" persist {counts.get('persist', 0)} march "
                    f"{counts.get('march', 0)} compact "
                    f"{counts.get('compact', 0)}")
    log("25 other", f"(c) MCL with the gate ({len(gtree.points_sorted)} wall "
        f"points, depth {S['gate_depth']}, {P} footprint OBBs a step, "
        f"{persistent}): " + "; ".join(rows) + f" | gate == CPU engine "
        f"every step (verdicts, every counter; {gate_pairs} nodes) | warm "
        f"step wall median {1e3 * statistics.median(walls[1:]):.3f} ms "
        f"(first {1e3 * walls[0]:.1f}) | {card}")

    # (d) Table IV: P-Sphere with and without the early exit, P-Ray, and
    # the ballquery kernel's brute force, on the cubby scene
    sc = make_scene("cubby", num_points=S["points"])
    tree = build_octree(sc.points, depth=S["depth"])
    rs = np.random.RandomState(0)
    qs = sc.points[rs.choice(len(sc.points), S["t4_queries"],
                             replace=False)]
    r4, k = S["t4_radius"], S["k"]

    def t4_arm(name, d, r=r4, q=qs):
        Q = torch.from_numpy(q).to(d)
        if name == "p_ray":
            return tbq.ball_query_pray(torch.from_numpy(sc.points).to(d), Q,
                                       r, k, depth=S["pray_depth"])
        return tbq.ball_query_psphere(tree, Q, r, k,
                                      early_exit=name == "p_sphere")

    def card_vs_cpu(name, tag, **kw):
        out, counts = on_main(lambda: t4_arm(name, dev, **kw), ("compact",),
                              tag)
        t0 = time.perf_counter()
        want = t4_arm(name, torch.device("cpu"), **kw)
        t_cpu = time.perf_counter() - t0
        bad = same_counters(out[2], want[2])
        if not (torch.equal(out[0].cpu(), want[0])
                and torch.equal(out[1].cpu(), want[1])) or bad:
            raise SystemExit(f"FAIL: 25 {tag}: card vs CPU: idx equal "
                             f"{torch.equal(out[0].cpu(), want[0])}, counts "
                             f"equal {torch.equal(out[1].cpu(), want[1])}, "
                             f"counters differing {bad}")
        wall = walls_of(lambda: t4_arm(name, dev, **kw))
        peak = peak_mib(lambda: t4_arm(name, dev, **kw))
        return out, counts, wall, peak, t_cpu
    t4 = {}
    for name in ("p_sphere", "p_sphere_noexit", "p_ray"):
        t4[name] = card_vs_cpu(name, f"(d) {name}")
    add_check_launches()
    brute_idx, brute = bq_ops.ball_query(
        torch.from_numpy(qs).to(dev), torch.from_numpy(sc.points).to(dev),
        r4, k)
    add_check_launches()
    counts_eq = all(torch.equal(t4[n][0][1].cpu(), brute.cpu()) for n in t4)
    if not counts_eq:
        raise SystemExit(f"FAIL: 25 (d): counts differ: " + ", ".join(
            f"{n} {int((t4[n][0][1].cpu() != brute.cpu()).sum())} queries"
            for n in t4))
    cap = 1 << 22

    def cut_note(tree_, centers, r):
        """Whether the descent keeps only the first 2**22 pairs of a level
        (the reference's silent cut): the levels' widths without it."""
        c = tbq.Counters()
        tbq._traverse_to_leaves(tree_, centers, r, c, max_frontier=1 << 40)
        over = [(lv, w) for lv, w in enumerate(c.nodes_per_level) if w > cap]
        return ("not hit" if not over else "hit: " + ", ".join(
            f"level {lv} keeps {cap} of {w} pairs" for lv, w in over))
    add_check_launches()
    cuts = {"p_ray": cut_note(build_octree(qs, depth=S["pray_depth"]),
                              torch.from_numpy(sc.points).to(dev), r4),
            "p_sphere": cut_note(tree, torch.from_numpy(qs).to(dev), r4)}
    cuts["p_sphere_noexit"] = cuts["p_sphere"]
    add_check_launches()
    for name, (out, counts, wall, peak, t_cpu) in t4.items():
        c = out[2]
        rays = len(sc.points) if name == "p_ray" else len(qs)
        log("25 other", f"(d) Table IV {name}: {rays} rays, "
            f"nodes {c.nodes_traversed} per level {c.nodes_per_level}, "
            f"{c.nodes_traversed / rays:.2f} nodes a ray, leaf tests "
            f"{c.leaf_tests}, max_frontier {cap} cut {cuts[name]} | card == "
            f"CPU (idx in order, counts, every counter; CPU {t_cpu:.1f} s) | "
            f"main-path launches {counts} | warm wall median of "
            f"{S['walls']} {wall:.3f} ms | peak mem {peak:.1f} MiB | {card}")
    ee, ne = t4["p_sphere"][0][2], t4["p_sphere_noexit"][0][2]
    first_k = torch.equal(t4["p_ray"][0][0].cpu(), brute_idx.cpu())
    log("25 other", f"(d) Table IV: counts equal three ways (P-Sphere, "
        f"P-Ray, ballquery brute force; {int((brute == k).sum())} of "
        f"{len(qs)} balls full); P-Ray's idx "
        + ("==" if first_k else "!=") + f" the brute force's first k by "
        f"index | nodes without / with the early exit "
        f"{ne.nodes_traversed / max(ee.nodes_traversed, 1):.2f}x "
        f"({ne.nodes_traversed} / {ee.nodes_traversed}) | P-Ray / "
        f"P-Sphere wall {t4['p_ray'][2] / t4['p_sphere'][2]:.2f}x")

    # (e) Fig. 17: P-Sphere over radii
    rs = np.random.RandomState(1)
    q17 = sc.points[rs.choice(len(sc.points), S["f17_queries"],
                              replace=False)]
    base, rows = None, []
    for r in S["f17_radii"]:
        out, counts, wall, peak, t_cpu = card_vs_cpu(
            "p_sphere", f"(e) r {r}", r=r, q=q17)
        add_check_launches()
        _, brute = bq_ops.ball_query(torch.from_numpy(q17).to(dev),
                                     torch.from_numpy(sc.points).to(dev), r,
                                     k)
        short = int((out[1] < brute).sum())
        cut = cut_note(tree, torch.from_numpy(q17).to(dev), r)
        add_check_launches()
        base = base or wall
        rows.append(f"r {r}: wall {wall:.3f} ms (rel {wall / base:.2f}), "
                    f"nodes {out[2].nodes_traversed}, full "
                    f"{int((out[1] == k).sum())}, balls short of the brute "
                    f"force {short}, 2**22 cut {cut}, peak {peak:.1f} MiB")
    log("25 other", f"(e) Fig. 17 P-Sphere, {len(q17)} queries, k {k}, card "
        f"== CPU at every radius: " + "; ".join(rows) + f" | {card}")

    # (f) Fig. 14: the MPAccel scenes in naive, fused and persistent
    want = {"naive": ("sact_dense",), "wavefront_fused": ("traverse",
                                                         "compact"),
            persistent: ("persist",)}
    tot = {m: [0.0, 0, 0] for m in want}
    for i in range(S["scenarios"]):
        msc = make_mpaccel_scenario(i, num_points=S["mpaccel_points"])
        mtree = build_octree(msc.points, depth=S["mpaccel_depth"])
        obbs = scene_trajectories(msc, num_trajectories=S["trajs"],
                                  waypoints=S["wps"])
        verdicts, rows = None, []
        for mode, kernels in want.items():
            cfg = EngineConfig(mode=mode)
            eng = CollisionEngine(mtree, cfg, device=dev)
            (v, c), counts = on_main(lambda: eng.query(obbs), kernels,
                                     f"(f) scene {i} {mode}")
            vc, cc_ = CollisionEngine(mtree, cfg, device="cpu").query(obbs)
            bad = same_counters(c, cc_)
            if not np.array_equal(v, vc) or bad:
                raise SystemExit(f"FAIL: 25 (f) scene {i} {mode}: card vs "
                                 f"CPU: verdicts equal {np.array_equal(v, vc)}"
                                 f", counters differing {bad}")
            if verdicts is not None and not np.array_equal(v, verdicts):
                raise SystemExit(f"FAIL: 25 (f) scene {i}: {mode}'s "
                                 f"verdicts differ from naive's")
            verdicts = v
            wall = walls_of(lambda: eng.query(obbs))
            tot[mode][0] += wall
            tot[mode][1] += c.nodes_traversed
            tot[mode][2] += c.leaf_tests
            rows.append(f"{mode} {wall:.3f} ms nodes {c.nodes_traversed} "
                        f"leaf_tests {c.leaf_tests} launches {counts}")
        log("25 other", f"(f) Fig. 14 mpaccel_{i} ({len(msc.boxes_lo)} boxes,"
            f" {mtree.num_leaves} leaves, {obbs.n} OBBs, hits "
            f"{int(verdicts.sum())}): card == CPU in each mode, verdicts "
            f"equal across modes | " + "; ".join(rows))
    log("25 other", f"(f) Fig. 14 over {S['scenarios']} scenes: warm walls "
        f"summed " + ", ".join(f"{m} {v[0]:.3f} ms" for m, v in tot.items())
        + f"; naive / fused {tot['naive'][0] / tot['wavefront_fused'][0]:.2f}"
        f"x, naive / persistent "
        f"{tot['naive'][0] / tot[persistent][0]:.2f}x; nodes, leaf tests "
        + ", ".join(f"{m} {v[1]} / {v[2]}" for m, v in tot.items())
        + f" | {card}")
    add_check_launches()
    log("25 other", f"phase 25 itself {time.perf_counter() - t_phase:.1f} s")
    log("25 other", f"phase {lap():.1f} s")
    return march_line


#: Phase 26's service runs: closed-loop planner clients, each request 12
#: consecutive link OBBs of phase 5's 10,500 (one Panda arm's links at a
#: waypoint and a half), the reference's batcher defaults.
SERVICE = dict(clients=(8, 32),
               max_requests={"wavefront_persistent": 32,
                             "wavefront_fused": 12},
               queries=12, max_batch=1024,
               max_wait_ms=2.0, traced_requests=8, shard_split=8,
               shard_fcap=16384,
               chaos_clients=8, chaos_requests=32, degrade_queue=2,
               degrade_clients=32, degrade_requests=8, direct_reps=20)
#: The typed errors a chaos run may resolve a request with.
CHAOS_ERRORS = ("PlanValidationError", "InjectedFault", "SimulatedOOM",
                "LaunchStalled", "WorkerDied", "DeviceLost",
                "DeadlineExceeded", "Overloaded")


def service_phase(dev, card: str, main_launches: dict, add_check_launches,
                  lap, tree, obbs, p8_runs: dict, sizes: dict = SERVICE,
                  check_kernels: bool = True) -> int:
    """Phase 26: the collision service on the card (``RequestBatcher``
    under ``launch.serve.run_service``), on ``tree`` and ``obbs`` (phase
    5's paper-scale cubby scene and its 10,500 OBBs); ``p8_runs`` maps a
    mode to phase 8's (verdicts, counters dict, warm wall) there.

    (a) both service modes at each client count: every request's verdicts
    against phase 8's, every coalesced pool replayed on the CPU engine
    (verdicts and every counter), the SLO numbers, the main path's
    launches and the card's busy share over one traced run; (b) the
    sharded path at ``shards=1`` against phase 8's unsharded engine, and
    ``persist`` on a sharded split's last block (a live prefix short of
    its pool) against its plain version; (c) a chaos run at one shard;
    (d) degraded launches.  Returns ``persist``'s max abs error there.
    ``sizes`` and ``check_kernels`` let a rehearsal on the CPU run it at
    a cut size."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.geometry import OBBs
    from repro_torch.engine.batcher import RequestBatcher
    from repro_torch.engine.executor import CollisionEngine, EngineConfig
    from repro_torch.engine.faults import SimulatedDeviceLoss
    from repro_torch.engine.plan import plan_queries
    from repro_torch.kernels import _build
    from repro_torch.kernels.persist import ops as persist_ops
    from repro_torch.kernels.persist.ref import persist_tiles_ref
    from repro_torch.launch.serve import default_fault_plan, run_service
    S = sizes
    q = S["queries"]
    on_card = dev.type == "cuda"
    want_kernels = {"wavefront_persistent": ("persist",),
                    "wavefront_fused": ("traverse", "compact")}

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def on_main(fn, want=(), tag=""):
        add_check_launches()
        out = fn()
        sync()
        counts = _build.launch_counts()
        _build.reset_launch_counts()
        for name, n in counts.items():
            main_launches[name] += n
        for name in want:
            if check_kernels and counts[name] < 1:
                raise SystemExit(f"FAIL: 26 {tag}: {name} launched no time "
                                 f"on the main path ({counts})")
        return out, {k: n for k, n in counts.items() if n}

    def diff(a, b):
        return [k for k in a if k != "wall_time_s" and a[k] != b[k]]

    class Recording:
        """Forwards to an engine and keeps each pool that the batcher's
        threads run (not the harness's warm-up, which runs on this
        thread): its plan, the engine's capacity memo before it, and the
        output."""

        def __init__(self, inner):
            self.inner = inner
            self.calls = []

        def __getattr__(self, name):
            return getattr(self.inner, name)

        def execute(self, plan, **kw):
            memo = dict(self.inner._cap_memo)
            out = self.inner.execute(plan, **kw)
            if threading.current_thread() is not threading.main_thread():
                # a copy: the batcher adds its pads to the counters
                self.calls.append((plan, kw, memo, copy.deepcopy(out)))
            return out

    def served(rep, n_req, tag):
        """Every request's verdicts against phase 8's."""
        ref = p8_runs["wavefront_persistent"][0]
        for i, v in enumerate(rep["verdicts"][:n_req]):
            w = ref[np.arange(i * q, (i + 1) * q) % obbs.n]
            if v is not None and not np.array_equal(v, w):
                raise SystemExit(f"FAIL: 26 {tag}: request {i}'s verdicts "
                                 f"differ from phase 8's")

    # ---- (a) the healthy service -------------------------------------
    for mode in ("wavefront_persistent", "wavefront_fused"):
        cfg = EngineConfig(mode=mode)
        for clients in S["clients"]:
            requests = min(S["max_requests"][mode], obbs.n // (q * clients))
            tag = f"{mode}, {clients} clients"
            rec = Recording(CollisionEngine(tree, cfg, device=dev))
            kw = dict(clients=clients, queries_per_request=q,
                      max_batch=S["max_batch"], max_wait_ms=S["max_wait_ms"],
                      engine=rec, obbs=obbs)
            try:
                rep, counts = on_main(lambda: run_service(
                    tree, requests=requests, **kw), want_kernels[mode], tag)
            except Exception as e:               # noqa: BLE001
                raise SystemExit(f"FAIL: 26 {tag}: the healthy service "
                                 f"raised {type(e).__name__}: {e}")
            served(rep, clients * requests, tag)
            if rep["failed"] or rep["requests"] != clients * requests:
                raise SystemExit(f"FAIL: 26 {tag}: {rep['failures']}")
            # every coalesced pool, replayed on the CPU from the card
            # engine's capacity memo as it stood before that pool
            t0 = time.perf_counter()
            cpu = CollisionEngine(tree, cfg, device="cpu")
            n_pools = len(rec.calls)
            for plan, ekw, memo, (v, c) in rec.calls:
                cpu._cap_memo = dict(memo)
                vc, cc = cpu.execute(plan_queries(plan.obbs), **ekw)
                bad = diff(c.as_dict(), cc.as_dict())
                if not np.array_equal(v, vc) or bad:
                    raise SystemExit(f"FAIL: 26 {tag}: a pool of "
                                     f"{plan.num_queries} differs from the "
                                     f"CPU engine ({bad or 'verdicts'})")
            t_cpu = time.perf_counter() - t0
            # one traced run on the warm engine: the card's busy share
            rec.calls.clear()
            traced_rep = None
            with profile(activities=[ProfilerActivity.CPU]
                         + ([ProfilerActivity.CUDA] if on_card else [])
                         ) as prof:
                sync()
                t0 = time.perf_counter()
                traced_rep, tcounts = on_main(lambda: run_service(
                    tree, requests=S["traced_requests"], **kw),
                    want_kernels[mode], tag + " traced")
                sync()
                t_traced = time.perf_counter() - t0
            served(traced_rep, clients * S["traced_requests"], tag)
            dev_s = sum(device_us(e) for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA) / 1e6
            # one 12-OBB request straight to the warm engine, no batcher
            one = OBBs(obbs.center[:q], obbs.half[:q], obbs.rot[:q])
            direct = []
            for _ in range(S["direct_reps"]):
                direct.append(rec.inner.query(one)[1].wall_time_s)
            add_check_launches()
            log("26 service", f"(a) {tag} x {requests} requests of {q} "
                f"OBBs: p50 {rep['p50_ms']:.3f} ms, p99 {rep['p99_ms']:.3f} "
                f"ms, {rep['qps']:.0f} queries/s ({rep['rps']:.0f} req/s, "
                f"wall {rep['wall_s']:.3f} s) | {rep['launches']} launches, "
                f"{rep['mean_requests_per_launch']:.2f} requests a launch, "
                f"{rep['mean_live_queries_per_launch']:.1f} live queries a "
                f"launch, pad fraction {rep['pad_fraction']:.3f} | main-path "
                f"launches {counts} | verdicts == phase 8's; {n_pools} "
                f"coalesced pools == the CPU engine from the same capacity "
                f"memo, verdicts and every counter ({t_cpu:.1f} s) | traced "
                f"run of "
                f"{S['traced_requests']} requests a client: wall "
                f"{1e3 * t_traced:.1f} ms, device time {1e3 * dev_s:.2f} ms "
                f"(busy {100 * dev_s / t_traced:.1f} %), launches {tcounts} "
                f"| one {q}-OBB request straight to the engine: median "
                f"{1e3 * statistics.median(direct):.3f} ms; phase 8's warm "
                f"{obbs.n}-OBB query {1e3 * p8_runs[mode][2]:.3f} ms | "
                f"{card}")

    # ---- (b) the sharded path ------------------------------------------
    for mode in ("wavefront_persistent", "wavefront_fused"):
        eng = CollisionEngine(tree, EngineConfig(mode=mode, shards=1),
                              device=dev)
        (v, c), counts = on_main(lambda: eng.query(obbs), want_kernels[mode],
                                 f"{mode} shards=1")
        bad = diff(c.as_dict(), p8_runs[mode][1])
        if not np.array_equal(v, p8_runs[mode][0]) or bad:
            raise SystemExit(f"FAIL: 26 {mode} shards=1 differs from phase "
                             f"8's unsharded engine ({bad or 'verdicts'})")
        log("26 service", f"(b) {mode} shards=1 on {eng.shard_devices[:1]}: "
            f"verdicts and every counter == phase 8's unsharded engine "
            f"(pad_queries {c.pad_queries}, escalations {c.escalations}) | "
            f"main-path launches {counts}")
    n_dev = torch.cuda.device_count() if on_card else 1
    if n_dev > 1:
        for mode in ("wavefront_persistent", "wavefront_fused"):
            eng = CollisionEngine(tree, EngineConfig(mode=mode, shards=2),
                                  device=dev)
            if len({str(d) for d in eng.shard_devices}) != n_dev:
                raise SystemExit("FAIL: 26 a CUDA device repeats in "
                                 f"{eng.shard_devices}")
            (v, c), counts = on_main(lambda: eng.query(obbs),
                                     want_kernels[mode], f"{mode} shards=2")
            bad = diff(c.as_dict(), p8_runs[mode][1])
            bad = [k for k in bad if k not in ("pad_queries", "escalations")]
            if not np.array_equal(v, p8_runs[mode][0]) or bad:
                raise SystemExit(f"FAIL: 26 {mode} shards=2 differs ({bad})")
            log("26 service", f"(b) {mode} shards=2 over "
                f"{eng.shard_devices[:2]}: == phase 8's | launches {counts}")
    else:
        log("26 service", "(b) one card: shards=2 not run")
    # the last block of an 8-way split: its live prefix short of its pool
    shards = S["shard_split"]
    q_shard = -(-obbs.n // shards)
    nv = obbs.n - (shards - 1) * q_shard
    eng = CollisionEngine(tree, EngineConfig(mode="wavefront_persistent",
                                             shards=1), device=dev)
    host = tuple(x.cpu() for x in (obbs.center, obbs.half, obbs.rot))
    blk = eng._shard_block(host, dev, (shards - 1) * q_shard, q_shard)
    ins = persist_ops.pack_kernel_inputs(
        blk["obb_c"], blk["obb_h"], blk["obb_r"], blk["dev"],
        persist_ops.DEFAULT_BQ, num_valid=nv)
    pkw = dict(bq=persist_ops.DEFAULT_BQ, fcap=S["shard_fcap"],
               depth=tree.depth, ring_cap=persist_ops.DEFAULT_RING_CAP,
               use_spheres=False, meta_format="fp32", streamed=False)
    add_check_launches()
    got = persist_ops.persist_tiles(**ins, **pkw)
    want = persist_tiles_ref(**ins, **pkw)
    err = max(int((x.to(torch.int64) - y.to(torch.int64)).abs().max())
              for x, y in zip(got, want))
    if err:
        raise SystemExit(f"FAIL: 26 persist on a short live prefix differs "
                         f"from plain (max abs err {err})")
    add_check_launches()
    log("26 service", f"(b) persist on the last of {shards} blocks "
        f"({nv} live of {q_shard} slots, {ins['sot'].shape[0]} "
        f"tiles) == plain")

    # ---- (c) chaos at one shard ----------------------------------------
    chaos = default_fault_plan(0)
    n_chaos = S["chaos_clients"] * S["chaos_requests"]
    (rep, counts) = on_main(lambda: run_service(
        tree, clients=S["chaos_clients"], requests=S["chaos_requests"],
        queries_per_request=q, max_batch=S["max_batch"],
        max_wait_ms=S["max_wait_ms"], mode="wavefront_persistent", shards=1,
        deadline_ms=2000.0, launch_timeout_s=1.0, chaos=chaos, device=dev,
        obbs=obbs))
    served(rep, n_chaos, "chaos")
    if rep["requests"] + rep["failed"] != n_chaos:
        raise SystemExit("FAIL: 26 chaos: a request vanished")
    stray = set(rep["failures"]) - set(CHAOS_ERRORS)
    if stray:
        raise SystemExit(f"FAIL: 26 chaos: untyped failures {stray}")
    if rep["injected"]["device_loss"] and not rep["failures"].get(
            "DeviceLost"):
        raise SystemExit("FAIL: 26 chaos: a device loss at one shard did "
                         "not fail its batch with DeviceLost")
    # at one shard a device loss has no survivors: DeviceLost, not bisected
    eng = CollisionEngine(tree, EngineConfig(mode="wavefront_persistent",
                                             shards=1), device=dev)

    def lose_all(shards):
        raise SimulatedDeviceLoss(shards, shards)
    eng.device_fault_injector = lose_all
    with RequestBatcher(eng, max_wait_ms=200.0) as b:
        tickets = [b.submit(OBBs(obbs.center[i:i + q], obbs.half[i:i + q],
                                 obbs.rot[i:i + q])) for i in (0, q)]
        kinds = []
        for t in tickets:
            try:
                t.result(timeout=120)
                kinds.append("ok")
            except Exception as e:               # noqa: BLE001
                kinds.append(type(e).__name__)
    if kinds != ["DeviceLost", "DeviceLost"] or b.totals.launch_splits:
        raise SystemExit(f"FAIL: 26 a lost last device gave {kinds}, "
                         f"{b.totals.launch_splits} splits")
    log("26 service", f"(c) chaos (default_fault_plan(0), deadline 2000 ms, "
        f"launch_timeout_s 1.0, wavefront_persistent, shards=1): "
        f"{rep['requests']} of {n_chaos} served, every submit resolved; "
        f"failures {rep['failures']}; injected {rep['injected']}; "
        f"reliability: " + ", ".join(
            f"{k} {rep[k]}" for k in ("rejected", "retried",
                                      "deadline_missed", "launch_splits",
                                      "worker_restarts", "reshards",
                                      "shards_lost", "degraded_launches"))
        + f" | p50 {rep['p50_ms']:.3f} ms, p99 {rep['p99_ms']:.3f} ms over "
        f"the served | every served request == phase 8's | a lost last "
        f"device: both requests DeviceLost, 0 splits | launches {counts}")

    # ---- (d) degraded launches -----------------------------------------
    n_deg = S["degrade_clients"] * S["degrade_requests"]
    (rep, counts) = on_main(lambda: run_service(
        tree, clients=S["degrade_clients"], requests=S["degrade_requests"],
        queries_per_request=q, max_batch=S["max_batch"],
        max_wait_ms=S["max_wait_ms"], mode="wavefront_fused",
        degrade_queue=S["degrade_queue"], device=dev, obbs=obbs),
        want_kernels["wavefront_fused"], "degraded")
    ref = p8_runs["wavefront_persistent"][0]
    coarser = 0
    for i, v in enumerate(rep["verdicts"]):
        w = ref[np.arange(i * q, (i + 1) * q) % obbs.n]
        if (w & ~v).any():
            raise SystemExit(f"FAIL: 26 degraded request {i} missed a "
                             f"collision")
        coarser += int(not np.array_equal(v, w))
    if not rep["degraded_launches"] or coarser > rep["degraded_requests"]:
        raise SystemExit(f"FAIL: 26 degraded: {rep['degraded_launches']} "
                         f"degraded launches, {coarser} coarser requests of "
                         f"{rep['degraded_requests']} degraded")
    log("26 service", f"(d) wavefront_fused, degrade_queue "
        f"{S['degrade_queue']}, {S['degrade_clients']} clients: "
        f"{rep['degraded_launches']} of {rep['launches']} launches "
        f"degraded, {rep['degraded_requests']} of {n_deg} requests flagged, "
        f"{coarser} with extra hits; every verdict a superset of phase 8's | "
        f"p50 {rep['p50_ms']:.3f} ms, p99 {rep['p99_ms']:.3f} ms | launches "
        f"{counts} | {card}")
    log("26 service", f"phase {lap():.1f} s")
    return err


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--envs", default="cubby,dresser,merged_cubby,tabletop",
                    help="comma-separated environments for phases 5-8 "
                         "(the first one also serves phases 6, 9 and 10)")
    args = ap.parse_args()
    if os.environ.get("PYTHONHASHSEED") != "0":
        # make_scene seeds each environment from hash(name), which Python
        # salts per process: with the hash seed fixed every run builds the
        # same scenes
        os.execve(sys.executable, [sys.executable] + sys.argv,
                  dict(os.environ, PYTHONHASHSEED="0"))
    t_start = time.perf_counter()

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("FAIL: torch sees no CUDA device")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        raise SystemExit(f"FAIL: no repro_torch package under {src}")
    sys.path.insert(0, str(src))
    import numpy as np
    from repro_torch.core.counters import (BYTES_SHADER_HANDOFF,
                                           BYTES_UNFUSED_TEST)
    from repro_torch.core.geometry import OBBs, random_obbs
    from repro_torch.core.octree import (build_octree,
                                         concat_device_octrees,
                                         device_octree)
    from repro_torch.core import sweep as sweep_mod
    from repro_torch.core.pipeline import (check_edges, check_trajectories,
                                           plan_with_collision_gate)
    from repro_torch.data.robotics import (PANDA_JOINT_HI, PANDA_JOINT_LO,
                                           make_scene, scene_trajectories)
    from repro_torch.engine.executor import (CollisionEngine, EngineConfig,
                                             query_batched_scenes)
    from repro_torch.engine.plan import plan_scenes, plan_trajectory
    from repro_torch.kernels import _build
    from repro_torch.kernels.ballquery import ops as bq_ops
    from repro_torch.kernels.ballquery.cases import cloud_cases, radius_shell
    from repro_torch.kernels.ballquery.ref import ball_query_ref
    from repro_torch.kernels.compact import ops as compact_ops
    from repro_torch.kernels.compact.ref import compact_ref
    from repro_torch.kernels.flash_attention import cases as flash_cases
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.fps import ops as fps_ops
    from repro_torch.kernels.fps.cases import tie_cloud
    from repro_torch.kernels.fps.ref import fps_ref
    from repro_torch.kernels.persist import ops as persist_ops
    from repro_torch.kernels.persist.cases import (grazing_pool,
                                                   owner_group_pool,
                                                   ragged_pool, ragged_trees,
                                                   skewed_pool,
                                                   sweep_round_plans,
                                                   tiled_pool)
    from repro_torch.kernels.persist.ref import persist_tiles_ref
    from repro_torch.kernels.sact import ops as sact_ops
    from repro_torch.kernels.sact.cases import grazing_plane
    from repro_torch.kernels.sact.ref import sact_ref
    from repro_torch.kernels.traverse import ops as traverse_ops
    from repro_torch.kernels.traverse.cases import grazing_frontier
    from repro_torch.kernels.traverse.ref import (traverse_test_ref,
                                                  unpack_verdicts)
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.wkv6 import ops as wkv6_ops
    from repro_torch.kernels.wkv6.cases import (edge_cases, hard_cases,
                                                within_tol)
    from repro_torch.kernels.wkv6.ref import wkv6_ref
    from repro_torch.lm.serve import serve
    from repro_torch.models import api as lm_api
    from repro_torch.models import pointnet as pointnet_mod
    from repro_torch.models.planner import Planner

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = torch.device("cuda", 0)
    clock = [t_start]

    def lap() -> float:
        """Seconds since the last lap: each phase's own."""
        now = time.perf_counter()
        secs, clock[0] = now - clock[0], now
        return secs

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

    log("1 card", f"phase {lap():.1f} s")

    # ---- 2. build ---------------------------------------------------------
    secs = _build.build_all(verbose=True)
    log("2 build", f"{len(_build.SOURCES)} kernels in {secs:.1f} s "
        f"-> {_build.build_dir()}")
    spills = 0
    for name, text in sorted(_build.last_build_log.items()):
        func = "?"
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                func = kernel_name(m.group(1))
            elif "registers" in line or "spill" in line:
                log("2 build", f"{name} {func}: {line.strip()}")
                m = re.search(r"(\d+) bytes spill stores", line)
                spills += int(m.group(1)) if m else 0
    for d in flash_ops.WIDTHS:
        c = flash_ops.kernel_config(d)
        log("2 build", f"flash_hopper<{d}>: {c['threads']} threads (a "
            f"producer warpgroup at {c['producer_regs']} registers a thread, "
            f"two consumer warpgroups at {c['consumer_regs']}, by setmaxnreg),"
            f" {c['smem_bytes']} B dynamic shared memory, {c['rows']} query "
            f"rows, {c['keys']} keys a tile, {c['stages']} ring stages")
    shape = persist_ops.kernel_shape()
    log("2 build", f"persist: a cluster of {shape['cluster']} CTAs of "
        f"{shape['threads']} threads a tile, {shape['smem_bytes']} B dynamic "
        f"shared memory a CTA at bq {persist_ops.DEFAULT_BQ}; the card holds "
        f"{shape['max_clusters']} such clusters at once "
        f"(cudaOccupancyMaxActiveClusters)")
    for bq in (256, 512, 1024):
        sh = persist_ops.kernel_shape(bq)
        if sh["max_clusters"] < 1:
            raise SystemExit(f"FAIL: persist does not fit the card at bq "
                             f"{bq}: {sh}")
        log("2 build", f"persist at bq {bq}: {sh['smem_bytes']} B dynamic "
            f"shared memory a CTA; the card holds {sh['max_clusters']} such "
            f"clusters at once")
    # u8 rows add a code to every staged pair; the streamed instances (2,802
    # windows a level on fig_bigscene's big scene, their bitmaps in the
    # workspace) add none
    for bq in (128, 1024):
        for fmt, nwin in (("bf16", 2802), ("u8", 0), ("u8", 2802)):
            sh = persist_ops.kernel_shape(bq, fmt, nwin)
            if sh["max_clusters"] < 1:
                raise SystemExit(f"FAIL: persist does not fit the card at "
                                 f"bq {bq}, {fmt} rows, {nwin} windows: "
                                 f"{sh}")
            log("2 build", f"persist at bq {bq}, {fmt} rows, "
                f"{nwin or 'resident: no'} windows: {sh['smem_bytes']} B "
                f"dynamic shared memory a CTA; the card holds "
                f"{sh['max_clusters']} such clusters at once")
    log("2 build", f"spill stores over every kernel: {spills} bytes")

    log("2 build", f"phase {lap():.1f} s")

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
        pc, pe = sact_ref(o, a, sph)
        # every stage mode that a kernel ships (sact_tile.cuh's SactMode)
        for mode in sact_ops.STAGE_MODES:
            c, e = sact_ops.sact_dense_in_mode(o, a, sph, mode)
            torch.cuda.synchronize()
            mism += int((c != pc).sum()) + int((e != pe).sum())
        d = torch.diagonal(e)
        if not bool((d[0::2] != d[1::2]).all()):
            raise SystemExit("FAIL: grazing plane diagonal is not grazing")
        seen |= set(torch.unique(e).tolist())
    if mism or seen != set(range(18)):
        raise SystemExit(f"FAIL: sact_dense vs plain: {mism} mismatches, "
                         f"exit codes seen {sorted(seen)}")
    log("3 sact_dense", f"kernel == plain on 2 x 2048x2048 grazing planes "
        f"(all 18 exit codes, both sphere settings) in every stage mode "
        f"{sorted(sact_ops.STAGE_MODES)} (shipped: {sact_ops.STAGE_MODE})")

    log("3 sact_dense", f"phase {lap():.1f} s")

    # ---- 4. persist vs persist_tiles_ref ----------------------------------
    small = make_scene("cubby", num_points=16384)
    stree = build_octree(small.points, depth=5)
    sobbs = scene_trajectories(small, num_trajectories=4, waypoints=20)
    sdev = device_octree(stree, device=cuda)
    spilled_compared = 0
    pools = [("identity", bq, fcap, ring_cap, sph,
              persist_ops.pack_kernel_inputs(
                  sobbs.center.to(cuda), sobbs.half.to(cuda),
                  sobbs.rot.to(cuda), sdev, bq))
             for bq, fcap, ring_cap, sph in ((16, 64, 4096, False),
                                             (16, 64, 32, True),
                                             (128, 8192, 256, False),
                                             (128, 8192, 256, True))]
    pools += [("owner groups", 16, 64, 4096, False,
               owner_group_pool(sdev, 16, 12, seed=3)),
              ("owner groups", 128, 8192, 256, True,
               owner_group_pool(sdev, 128, 6, seed=4))]
    skewed, s_fcap, s_ring = skewed_pool(sdev, 128, 6, seed=5)
    pools += [("skewed", 128, s_fcap, s_ring, sph, skewed)
              for sph in (False, True)]
    pools += [("grazing", 128, 16384, 4096, sph,
               grazing_pool(sdev, 4, 512, seed=9 + sph, use_spheres=sph))
              for sph in (False, True)]
    # owner-group tiles past 48 KB of shared memory a CTA, groups whose
    # lanes spread over every rank, with and without overflow
    for bq in (256, 1024):
        pools += [("owner groups", bq, 64, 1 << 16, False,
                   owner_group_pool(sdev, bq, 4, seed=bq, max_group=64)),
                  ("owner groups", bq, 1 << 18, 256, True,
                   owner_group_pool(sdev, bq, 4, seed=bq + 1,
                                    max_group=64))]
    # the tiled pool of a real sweep round: its widest width-1 round
    rs = np.random.RandomState(0)
    qf_s = rs.uniform(PANDA_JOINT_LO, PANDA_JOINT_HI,
                      (32, 7)).astype(np.float32)
    qt_s = np.clip(qf_s + rs.uniform(-0.35, 0.35, (32, 7)).astype(np.float32),
                   PANDA_JOINT_LO, PANDA_JOINT_HI)
    round_plans = sweep_round_plans(
        CollisionEngine(stree, EngineConfig(mode="wavefront_persistent"),
                        device="cpu"), qf_s, qt_s, 16,
        base_pos=small.robot_base)
    pay_plans = [p for p in round_plans if p.payload is not None]
    if not pay_plans:
        raise SystemExit("FAIL: the small-scene sweep ran no payload round")
    round_tags = {}
    for round_plan in (max(pay_plans, key=lambda p: p.num_queries),
                       round_plans[0]):
        round_ins, round_bq = tiled_pool(sdev, round_plan)
        own_t = round_ins["owner"].reshape(-1, round_bq)
        if not bool(((own_t[:, 1:] < 0) | (own_t[:, :-1] >= 0)).all()):
            raise SystemExit("FAIL: the sweep round's pads are not at each "
                             "tile's tail")
        round_tags[id(round_ins)] = (f"; {own_t.shape[0]} tiles of the "
                                     f"round {round_plan.shape_tag}")
        pools.append(("sweep round", round_bq, 8192, 256, False, round_ins))
    # every pool also on bf16 and u8 rows, and streamed at the default
    # window and at windows of 64 rows (the small scene's widest level is
    # 5,160 rows: the default crosses windows there, 64 at every level
    # past the third)
    sdevs = {fmt: device_octree(stree, meta_format=fmt, device=cuda)
             for fmt in ("bf16", "u8")}
    sdevs["fp32"] = sdev
    # ragged pools: three scenes of mixed sizes, each in a box of its own,
    # over their flat table (each format's) in scene-exclusive tiles,
    # identity and owner groups, clean and spilling
    rtabs = {fmt: concat_device_octrees(ragged_trees(depth=stree.depth),
                                        meta_format=fmt, device=cuda)
             for fmt in ("fp32", "bf16", "u8")}
    tables_of = {}
    for k, (owners, sph, fcap, ring_cap) in enumerate((
            (False, False, 4096, 256), (True, True, 4096, 256),
            (False, True, 48, 4096), (True, False, 48, 4096))):
        r_ins, r_bq = ragged_pool(rtabs["fp32"], (300, 40, 150), seed=40 + k,
                                  owner_groups=owners, half=(0.01, 0.05))
        tables_of[id(r_ins)] = rtabs
        round_tags[id(r_ins)] = (f"; {r_ins['sot'].shape[0]} scene-exclusive"
                                 f" tiles, scenes "
                                 f"{r_ins['sot'].tolist()}")
        pools.append(("ragged" + (" owner groups" if owners else ""), r_bq,
                      fcap, ring_cap, sph, r_ins))
    row_runs = [(fmt, streamed, wsub) for fmt in ("fp32", "bf16", "u8")
                for streamed, wsub in ((False, None), (True, None),
                                       (True, 64))]
    meta_rows_seen = {}
    for pool, bq, fcap, ring_cap, sph, ins in pools:
        for fmt, streamed, wsub in row_runs:
            kw = dict(bq=bq, fcap=fcap, depth=stree.depth, ring_cap=ring_cap,
                      use_spheres=sph, meta_format=fmt, streamed=streamed,
                      wsub=wsub)
            ins_f = dict(ins, meta=tables_of.get(id(ins), sdevs)[fmt]
                         .node_meta)
            got = persist_ops.persist_tiles(**ins_f, **kw)
            want = persist_tiles_ref(**ins_f, **kw)
            torch.cuda.synchronize()
            rows = f"{fmt} rows, " + (f"streamed (wsub {wsub or 'default'})"
                                      if streamed else "resident")
            for name, g, w in zip(("best", "per_level", "hist", "scalars"),
                                  got, want):
                if not torch.equal(g, w):
                    raise SystemExit(f"FAIL: persist {name} differs on the "
                                     f"{pool} pool at bq={bq} fcap={fcap} "
                                     f"spheres={sph}, {rows}")
            spill = got[3][:, 6]
            fits = spill <= ring_cap
            if not torch.equal(got[4][fits], want[4][fits]):
                raise SystemExit(f"FAIL: persist ring differs on the {pool} "
                                 f"pool at bq={bq} fcap={fcap}, {rows}")
            m_rows = int(got[3][:, 7].sum())
            if (m_rows > 0) != streamed:
                raise SystemExit(f"FAIL: persist counted {m_rows} streamed "
                                 f"rows on the {pool} pool, {rows}")
            if fmt == "fp32":
                meta_rows_seen.setdefault((streamed, wsub), []).append(m_rows)
            elif m_rows != meta_rows_seen[(streamed, wsub)][-1]:
                raise SystemExit(f"FAIL: persist on the {pool} pool counted "
                                 f"{m_rows} streamed rows on {rows}, fp32 "
                                 f"{meta_rows_seen[(streamed, wsub)][-1]}")
            if fmt == "fp32" and not streamed:
                fp32_out = got
            elif any(not torch.equal(g, w) for g, w in
                     zip(got[:3] + (got[3][:, :7],),
                         fp32_out[:3] + (fp32_out[3][:, :7],))):
                raise SystemExit(f"FAIL: persist on the {pool} pool, {rows},"
                                 f" differs from fp32 resident rows")
        got = fp32_out
        spilled_compared += int(((spill > 0) & fits).sum())
        nodes = got[3][:, 0]
        codes = (got[2].sum(0) > 0).nonzero().flatten().tolist()
        if pool == "owner groups" and bq > 128 \
                and (int(spill.sum()) > 0) != (fcap == 64):
            raise SystemExit(f"FAIL: the {bq}-slot owner pool at fcap "
                             f"{fcap} overflowed {int(spill.sum())} pairs")
        log("4 persist", f"{pool} pool, bq={bq} fcap={fcap} ring={ring_cap} "
            f"spheres={sph}: kernel == plain, overflow {int(spill.sum())}, "
            f"nodes {int(nodes.sum())} (heaviest tile {int(nodes.max())}, "
            f"widest tile level {int(got[1].max())}), terminal exit codes "
            f"{codes}" + round_tags.get(id(ins), ""))
    if spilled_compared == 0:
        raise SystemExit("FAIL: no spilled ring was compared")
    log("4 persist", f"every pool above also on bf16 and u8 rows and "
        f"streamed, {len(row_runs)} runs a pool: kernel == plain, every "
        f"output equal to fp32 resident rows' but meta_rows; streamed rows "
        f"a pool at the default window {meta_rows_seen[(True, None)]}, at "
        f"64 rows {meta_rows_seen[(True, 64)]} (the same in every format)")
    add_check_launches()

    log("4 persist", f"phase {lap():.1f} s")

    # ---- 5. paper-scale scenes --------------------------------------------
    scenes, scene_objs = {}, {}
    for env in args.envs.split(","):
        t0 = time.perf_counter()
        scene = scene_objs[env] = make_scene(env, num_points=524288)
        tree = build_octree(scene.points, depth=7)
        obbs = scene_trajectories(scene, num_trajectories=25, waypoints=60)
        scenes[env] = (tree, obbs, time.perf_counter() - t0)
        log("5 scenes", f"{env}: levels {[len(lv.codes) for lv in tree.levels]}"
            f" | Q={obbs.n} | setup {scenes[env][2]:.1f} s")
    env0 = next(iter(scenes))
    tree0, obbs0, _ = scenes[env0]
    dev0 = device_octree(tree0, device=cuda)
    obb0 = sact_ops.pack_obbs(obbs0.center, obbs0.half, obbs0.rot).to(cuda)

    log("5 scenes", f"phase {lap():.1f} s")

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
    # the live prefix at its ends, and a capacity that is no multiple of 4
    # (nor of a CTA's 256 lanes) with queries out of range
    for n in (0, 1, cap):
        frontiers.append(dict(frontiers[0], n_live=n,
                              name=f"paper n_live={n}"))
    rag = cap - 179
    q_rag = frontiers[0]["q_idx"][:rag].clone()
    q_rag[::97] = -1
    q_rag[5::101] = obbs0.n + 3
    frontiers.append(dict(obb=obb0, q_idx=q_rag,
                          codes=frontiers[0]["codes"][:rag],
                          full=frontiers[0]["full"][:rag], n_live=rag - 5,
                          name="ragged, queries out of range"))
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

    log("6 traverse", f"phase {lap():.1f} s")

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

    log("7 compact", f"phase {lap():.1f} s")

    # ---- 8. main paths at paper scale --------------------------------------
    main_launches = {name: 0 for name in _build.SOURCES}
    persist_line = timing_inputs = None
    persist_runs = []   # each environment's inputs, timed alone in phase 9
    # per environment and mode: the card's verdicts, counters and warm
    # wall, which phase 22 holds the ablation arms against
    p8 = {env: {} for env in scenes}
    # (mode, rows, layout): u8 rows in both layouts beside the fused u8 run
    paths = [("wavefront_persistent", None, None), ("wavefront", None, None),
             ("wavefront_fused", None, None), ("wavefront_fused", "u8", None),
             ("wavefront_persistent", "u8", False),
             ("wavefront_persistent", "u8", True)]
    for env, (tree, obbs, _) in scenes.items():
        ref_run = None
        for mode, fmt, stream_meta in paths:
            if fmt is not None and env != env0:
                continue
            cfg = EngineConfig(mode=mode, meta_format=fmt,
                               stream_meta=stream_meta)
            tag = mode + (f"[{fmt}]" if fmt else "") + (
                "" if stream_meta is None else
                "[streamed]" if stream_meta else "[resident]")
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
                    if k not in ("wall_time_s", "bytes_moved", "escalations",
                                 "meta_rows_streamed", "meta_bytes_streamed"
                                 ) and a[k] != ref_run[1][k]:
                        raise SystemExit(
                            f"FAIL: {env} {tag}: counter {k} differs from "
                            f"wavefront_persistent: {a[k]} vs "
                            f"{ref_run[1][k]}")
            if (c1.meta_rows_streamed > 0) != bool(stream_meta) \
                    or c1.meta_bytes_streamed != c1.meta_rows_streamed * \
                    persist_ops.META_FORMAT_BYTES[eng.meta_format]:
                raise SystemExit(f"FAIL: {env} {tag}: {c1.meta_rows_streamed}"
                                 f" streamed rows, {c1.meta_bytes_streamed} "
                                 f"bytes")
            walls = []
            for _ in range(10):
                _, cw = eng.query(obbs)
                walls.append(cw.wall_time_s)
            p8[env][tag] = (v1, a, statistics.median(walls))
            kernel_note = ""
            if mode != "wavefront_persistent":
                with Recorder({"traverse": (traverse_ops, "traverse_test"),
                               "compact": (compact_ops,
                                           "compact_columns")}) as rec:
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
                          use_spheres=cfg.use_spheres,
                          meta_format=dev.meta_format,
                          streamed=eng.meta_layout == "streamed")
                got = persist_ops.persist_tiles(**ins, **kw)
                seen = torch.zeros(dev.node_meta.shape[:2], dtype=torch.bool,
                                   device=cuda)
                want = persist_tiles_ref(**ins, **kw, seen=seen)
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
                nodes = c1.nodes_traversed
                row_bytes = persist_ops.META_FORMAT_BYTES[dev.meta_format]
                # the distinct rows that the walk tests, each read once
                # (the frontier's pairs are the kernel's own, not inputs)
                in_bytes = (4 * (3 + L) + 4 * T + 4 + T * 128 * (60 + 4 + 4)
                            + int(seen.sum()) * row_bytes)
                out_bytes = (4 * T * (128 + L + 18 + 8) + 8 * int(
                    got[3][:, 6].clamp(max=kw["ring_cap"]).sum()))
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
                tile_nodes = got[3][:, 0].to(torch.float64)
                persist_runs.append((env, tag, ins, kw, ms, bms, tile_nodes))
                kernel_note = (f" | persist call {ms:.4f} ms (the kernel "
                               f"alone: phase 9), plain on card "
                               f"{plain_ms:.3f} ms, bound {bms:.5f} ms ({by}); "
                               f"{T} tiles, heaviest {int(tile_nodes.max())} "
                               f"nodes, mean {float(tile_nodes.mean()):.1f}")
            add_check_launches()
            log("8 main", f"{env} {tag}: Q={obbs.n} hits={int(v1.sum())} "
                f"nodes={c1.nodes_traversed} per level {c1.nodes_per_level} "
                f"axis_exec={c1.axis_tests_executed} escalations="
                f"{c1.escalations} cap={eng.last_capacity} | main-path "
                f"launches {counts} | cuda==cpu verdicts+counters | warm wall "
                f"median {1e3 * statistics.median(walls):.3f} ms"
                f"{kernel_note} | peak mem {peak / 2**20:.1f} MiB | cpu "
                f"engine {t_cpu:.1f} s | {card}")

    log("8 main", f"phase {lap():.1f} s")

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
    # Every call is timed before the profiler's windows, so that no call is
    # timed in a process that the profiler has attached to the card.
    ms = cuda_time_ms(lambda: traverse_ops.traverse_test(*ta, **tk), 50)
    plain_ms = cuda_time_ms(lambda: traverse_test_ref(*ta, **tk), 5)
    # compaction: the level that keeps the most pairs
    _, ca, ck = max(calls_c, key=lambda call: int(call[1][0].sum()))
    mask, cols, n_out = ca
    rows = torch.stack(list(cols), 1)
    count, out = compact_ops.compact_columns(*ca, **ck)
    want_count, want = compact_ref(mask, rows, n_out)
    err = max(abs(int(count) - int(want_count)),
              int((out.t().to(torch.int64) - want.to(torch.int64))
                  .abs().max()))
    errs["compact"] = max(errs["compact"], err)
    c_ms = cuda_time_ms(lambda: compact_ops.compact_columns(*ca, **ck), 50)
    c_plain_ms = cuda_time_ms(lambda: compact_ref(mask, rows, n_out), 5)
    library_ms = cuda_time_ms(lambda: rows[mask][:n_out], 50)
    t_device_ms = kernel_device_ms(
        lambda: traverse_ops.traverse_test(*ta, **tk), "traverse_kernel", 50,
        "traverse")
    device_ms = kernel_device_ms(
        lambda: compact_ops.compact_columns(*ca, **ck), "compact_kernel", 50,
        "compact")
    # persist on phase 8's inputs: the kernel alone, after every call above
    for env, tag, ins, kw, p_ms, p_bms, tile_nodes in persist_runs:
        p_device_ms = kernel_device_ms(
            lambda: persist_ops.persist_tiles(**ins, **kw), "persist_kernel",
            20, "persist")
        if env == env0 and tag == "wavefront_persistent":
            persist_line["kernel_ms"] = p_device_ms
        log("9 persist", f"{env} {tag} query (phase 8, "
            f"fcap {kw['fcap']}): kernel on the card {p_device_ms:.5f} ms "
            f"(torch.profiler, {p_device_ms / p_bms:.1f}x the bound "
            f"{p_bms:.5f} ms), call {p_ms:.4f} ms; {tile_nodes.numel()} "
            f"tiles, heaviest {int(tile_nodes.max())} nodes, mean "
            f"{float(tile_nodes.mean()):.1f} | {card}")
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
        max_abs_err=errs["traverse"],
        ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
        library_ms=None))
    log("9 traverse", f"{env0} wavefront_fused widest level ({n_live} live of "
        f"{got.shape[0]} lanes, {n_obbs} OBBs named): call {ms:.4f} ms (back "
        f"to back, one launch each), kernel on the card {t_device_ms:.5f} ms "
        f"(torch.profiler, {t_device_ms / bms:.2f}x the bound), plain on card"
        f" {plain_ms:.3f} ms, bound {bms:.5f} ms ({by}) | {card}")
    # Read once: the mask and the rows of the kept survivors; written
    # once: all n_out output rows (zero past the count).
    lanes = mask.shape[0]
    bms, by = bound_ms(lanes * 1 + int(count) * 8 + n_out * 8, 0)
    lines.append(dict(
        name="compact", route="cuda",
        source="src/repro_torch/kernels/compact/csrc/compact.cu",
        replaces="src/repro/kernels/compact/kernel.py:32",
        max_abs_err=errs["compact"],
        ms=c_ms, plain_ms=c_plain_ms, bound_ms=bms, bound_by=by,
        library_ms=library_ms))
    log("9 compact", f"{env0} wavefront_fused fullest level ({lanes} lanes, "
        f"{int(count)} kept, n_out {n_out}): call {c_ms:.4f} ms (back to "
        f"back, one launch each), kernel on the card {device_ms:.4f} ms "
        f"(torch.profiler, {device_ms / bms:.2f}x the bound), plain on card "
        f"{c_plain_ms:.3f} ms, vals[mask][:n_out] {library_ms:.4f} ms (call "
        f"/ library {c_ms / library_ms:.3f}), bound {bms:.5f} ms ({by}) | "
        f"{card}")
    add_check_launches()

    log("9 timing", f"phase {lap():.1f} s")

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
    s_device_ms = kernel_device_ms(lambda: sact_ops.sact_dense(o, a),
                                   "sact_dense_kernel", 20, "sact_dense")
    add_check_launches()
    M = o.shape[0]
    hist = torch.bincount(e.reshape(-1), minlength=18).cpu().numpy()
    ops = float(np.dot(hist, exit_code_ops(False)))
    bms, by = bound_ms(M * 60 + N * 24 + M * N * 5, ops)
    # The OBB's faces (the edges) run for a warp's box slot (boxes 4 * lane
    # + v of a 128-box group, sact_dense.cu's kV = 4) when one of its pairs
    # is not decided before them: exit code 5 (8) or above.
    slots = [float((e >= first).reshape(M, N // 128, 32, 4).any(dim=2)
                   .float().mean()) if N % 128 == 0 else float("nan")
             for first in (5, 8)]
    lines.insert(1, dict(
        name="sact_dense", route="cuda",
        source="src/repro_torch/kernels/sact/csrc/sact_dense.cu",
        replaces="src/repro/kernels/sact/kernel.py:112",
        max_abs_err=err, ms=ms, kernel_ms=s_device_ms,
        plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None))
    log("10 sact_dense", f"{M} x {N} plane (paper-scale OBBs x level-{lvl} "
        f"cells): call {ms:.4f} ms, kernel on the card {s_device_ms:.5f} ms "
        f"(torch.profiler, {s_device_ms / bms:.2f}x the bound), plain on "
        f"card {plain_ms:.3f} ms, bound {bms:.5f} ms ({by}); exit codes "
        f"{hist.tolist()}: {100 * slots[0]:.2f} % of warp slots run the "
        f"OBB's faces, {100 * slots[1]:.2f} % the edges; the main path's "
        f"shape (the naive arm's blocks): phase 22 | {card}")

    log("10 sact_dense", f"phase {lap():.1f} s")

    # ---- 11. fps vs plain ---------------------------------------------------
    g = torch.Generator().manual_seed(41)
    m_fps = 256
    fps_cases = []
    for B in (1, 32):
        for N in (2048, 2047, 5000):
            fps_cases.append((f"uniform B={B} N={N}",
                              torch.rand((B, N, 3), generator=g) * 2 - 1, 0))
    ties = torch.from_numpy(np.stack([
        tie_cloud(n_side=6, n_total=2048, spacing=0.125, seed=s)
        for s in range(32)]))
    fps_cases = [(name, pts, first, m_fps) for name, pts, first in fps_cases]
    fps_cases += [("ties B=1 N=2048", ties[:1], 0, m_fps),
                  ("ties B=32 N=2048", ties, 0, m_fps),
                  ("ties B=32 N=2048 first=77", ties, 77, m_fps),
                  ("uniform B=32 N=5000 first=4321", fps_cases[5][1], 4321,
                   m_fps)]
    # ragged clouds (N no multiple of threads x points a thread, N < 32),
    # one point, more picks than distinct points, the largest clouds
    for N in (1000, 33, 20, 9000, fps_ops.MAX_POINTS):
        fps_cases.append((f"uniform B=3 N={N}",
                          torch.rand((3, N, 3), generator=g) * 2 - 1, N // 2,
                          min(m_fps, N)))
    one = torch.rand((4, 1, 3), generator=g)
    fps_cases += [("one point B=4 N=1 m=1", one, 0, 1),
                  ("one point B=4 N=1 m=5", one, 0, 5)]
    few = torch.from_numpy(np.stack([
        tie_cloud(n_side=3, n_total=50, spacing=0.25, seed=s)
        for s in range(4)]))
    fps_cases.append(("ties B=4 N=50, 27 distinct, m=64", few, 3, 64))
    for name, pts, first, m_case in fps_cases:
        pts = pts.to(cuda)
        got = fps_ops.fps(pts, m_case, first)
        want = fps_ref(pts, m_case, first)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise SystemExit(f"FAIL: fps differs from plain on {name} "
                             f"(first mismatch at "
                             f"{(got != want).nonzero()[0].tolist()})")
        note = ""
        if "ties" in name:
            distinct = len(np.unique(pts[0].cpu().numpy(), axis=0))
            zeros = int((got[:, distinct:] == 0).sum())
            note = f" (ties: {zeros} picks of index 0 after the {distinct} " \
                   f"distinct points)"
        log("11 fps", f"{name}, m={m_case}, first={first}, "
            f"{fps_ops.threads_for(pts.shape[1])} threads: kernel == plain "
            f"on every index{note}")
    errs["fps"] = 0
    add_check_launches()

    log("11 fps", f"phase {lap():.1f} s")

    # ---- 12. ballquery vs plain ---------------------------------------------
    bq_cases = []
    for name, half in (("sa1 sparse", 0.5), ("sa1 saturated", 0.1)):
        pts = ((torch.rand((32, 2048, 3), generator=g) * 2 - 1) * half).to(cuda)
        ctr = fps_ops.fps(pts, 256)
        qs = pts[torch.arange(32, device=cuda)[:, None], ctr.to(torch.int64)]
        bq_cases.append((name, qs, pts, 0.1, 16))
    pts = torch.rand((3, 2047, 3), generator=g).to(cuda) * 2 - 1
    bq_cases.append(("ragged B=3 M=255 N=2047", pts[:, :255].contiguous(),
                     pts, 0.2, 16))
    for r in (0.05, 0.1, 0.2, 0.25, 0.4, 0.6):
        shell = torch.from_numpy(radius_shell(r))
        filler = torch.rand((100, 3), generator=g) * 2 - 1
        pts = torch.cat([filler[:50], shell, filler[50:]])[None].to(cuda)
        for k in (16, pts.shape[1]):
            bq_cases.append((f"radius shell r={r} k={k}",
                             torch.zeros((1, 1, 3), device=cuda), pts, r, k))
    # the edges of the kernel's design (kernels/ballquery/cases.py)
    for name, qs, pts, r, k in cloud_cases():
        bq_cases.append((name, torch.from_numpy(qs).to(cuda),
                         torch.from_numpy(pts).to(cuda), r, k))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, qs, pts, r, k in bq_cases:
        idx, cnt = bq_ops.ball_query(qs, pts, r, k)
        widx, wcnt = ball_query_ref(pts, qs, r, k)
        torch.cuda.synchronize()
        if not (torch.equal(idx, widx) and torch.equal(cnt, wcnt)):
            raise SystemExit(f"FAIL: ballquery differs from plain on {name}")
        full = float((cnt == k).float().mean())
        qb = bq_ops.query_block(qs.shape[0], qs.shape[1], sms)
        log("12 ballquery", f"{name}: B={qs.shape[0]} M={qs.shape[1]} "
            f"N={pts.shape[1]} r={r} k={k}, {qb} queries a CTA: kernel == "
            f"plain (counts and every index); {100 * full:.1f} % of balls "
            f"full, mean count {float(cnt.float().mean()):.2f}")
    errs["ballquery"] = 0
    add_check_launches()

    log("12 ballquery", f"phase {lap():.1f} s")

    # ---- 13. the neural-planner path (Fig. 18) ------------------------------
    if "tabletop" in scenes:
        tab, tree_t = scene_objs["tabletop"], scenes["tabletop"][0]
    else:
        tab = make_scene("tabletop", num_points=524288)
        tree_t = build_octree(tab.points, depth=7)
    rs = np.random.RandomState(2)
    cloud_np = tab.points[rs.choice(len(tab.points), 2048, replace=False)]
    q0_np = rs.uniform(-1, 1, 7).astype(np.float32)
    goal_np = rs.uniform(-1, 1, 7).astype(np.float32)
    cloud = torch.from_numpy(cloud_np)
    cloud_cuda = cloud.to(cuda)

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    planner = Planner(256, 512, 1, generator=gen(0), device=cuda).eval()
    planner_cpu = Planner(256, 512, 1, generator=gen(0), device="cpu").eval()
    for k, v in planner_cpu.state_dict().items():
        if not torch.equal(planner.state_dict()[k].cpu(), v):
            raise SystemExit(f"FAIL: planner weight {k} differs by device")
    n_params = sum(p.numel() for p in planner.parameters())
    kernel_attrs = {"fps": (pointnet_mod, "fps"),
                    "ballquery": (pointnet_mod, "ball_query")}
    gate_kernels = {"wavefront_fused": ("traverse", "compact"),
                    "wavefront_persistent": ("persist",)}
    engines = {}
    for mode, kinds in gate_kernels.items():
        cfg = EngineConfig(mode=mode)
        eng = engines[mode] = CollisionEngine(tree_t, cfg, device="cuda")
        eng_cpu = CollisionEngine(tree_t, cfg, device="cpu")
        eng_gate = CollisionEngine(tree_t, cfg, device="cpu")
        for sampling in ("fps", "random"):
            want_k = kinds + ("ballquery",) + (
                ("fps",) if sampling == "fps" else ())
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            _build.reset_launch_counts()
            res = plan_with_collision_gate(planner, eng, cloud_cuda, q0_np,
                                           goal_np, num_steps=20,
                                           sampling=sampling,
                                           generator=gen(3))
            counts = _build.launch_counts()
            _build.reset_launch_counts()
            peak = torch.cuda.max_memory_allocated() - base
            for name, k in counts.items():
                main_launches[name] += k
                if (k > 0) != (name in want_k):
                    raise SystemExit(f"FAIL: fig18 {mode} {sampling}: {name} "
                                     f"launched {k} times on the main path")
            res_cpu = plan_with_collision_gate(planner_cpu, eng_cpu, cloud,
                                               q0_np, goal_np, num_steps=20,
                                               sampling=sampling,
                                               generator=gen(3))
            # sampling and grouping exact, features to FEAT_TOL
            with torch.inference_mode():
                lc = planner.pointnet.encode_layers(cloud_cuda[None],
                                                    sampling, gen(3))
                lh = planner_cpu.pointnet.encode_layers(cloud[None],
                                                        sampling, gen(3))
                fc = lc[-1].feats.max(dim=1).values.cpu()
                fh = lh[-1].feats.max(dim=1).values
            feat_err = 0.0
            for li, (a, b) in enumerate(zip(lc, lh)):
                for key in ("center_idx", "centers", "neighbor_idx", "count"):
                    if not torch.equal(getattr(a, key).cpu(), getattr(b, key)):
                        raise SystemExit(f"FAIL: fig18 {sampling}: layer "
                                         f"{li + 1} {key} differs cuda/cpu")
                for x, y in ((a.feats.cpu(), b.feats), (fc, fh)):
                    if not torch.allclose(x, y, **FEAT_TOL):
                        raise SystemExit(f"FAIL: fig18 {sampling}: layer "
                                         f"{li + 1} features beyond "
                                         f"{FEAT_TOL}")
                    feat_err = max(feat_err, float((x - y).abs().max()))
            traj, traj_cpu = res.trajectory, res_cpu.trajectory
            wp_err = float(np.abs(traj - traj_cpu).max())
            if not (traj.shape == (21, 7) and np.isfinite(traj).all()
                    and wp_err <= WAYPOINT_ATOL):
                raise SystemExit(f"FAIL: fig18 {mode} {sampling}: waypoints "
                                 f"{traj.shape}, cuda/cpu max err {wp_err}")
            # the gate: the CUDA trajectory's plan on a CPU engine
            flags, cg = eng_gate.execute(plan_trajectory(
                torch.from_numpy(traj).to(cuda)))
            if not np.array_equal(flags, res.colliding_waypoints):
                raise SystemExit(f"FAIL: fig18 {mode} {sampling}: gate "
                                 f"verdicts differ cuda/cpu")
            a, b = res.counters.as_dict(), cg.as_dict()
            for k in a:
                if k != "wall_time_s" and a[k] != b[k]:
                    raise SystemExit(f"FAIL: fig18 {mode} {sampling}: gate "
                                     f"counter {k}: cuda {a[k]} cpu {b[k]}")
            walls = {"encode_s": [], "rollout_s": [], "collision_s": []}
            for _ in range(10):
                r10 = plan_with_collision_gate(planner, eng, cloud_cuda, q0_np,
                                               goal_np, num_steps=20,
                                               sampling=sampling,
                                               generator=gen(3))
                for key in walls:
                    walls[key].append(r10.timings[key])
            traj_cuda = torch.from_numpy(traj).to(cuda)
            fk = []
            for _ in range(10):
                t0 = time.perf_counter()
                plan_trajectory(traj_cuda)
                torch.cuda.synchronize()
                fk.append(time.perf_counter() - t0)
            with Recorder(kernel_attrs) as rec:
                plan_with_collision_gate(planner, eng, cloud_cuda, q0_np,
                                         goal_np, num_steps=20,
                                         sampling=sampling,
                                         generator=gen(3))
            if sampling == "fps":
                bq_single = rec.calls["ballquery"]   # timed in phase 14
            per_launch = {name: [cuda_time_ms(lambda: fn(*ca, **ck), 20)
                                 for fn, ca, ck in calls]
                          for name, calls in rec.calls.items() if calls}
            add_check_launches()
            med = {k: 1e3 * statistics.median(v) for k, v in walls.items()}
            log("13 fig18", f"{mode} {sampling}: {n_params} planner weights | "
                f"{int(flags.sum())} of 21 waypoints collide (cpu planner's "
                f"own plan: {int(res_cpu.colliding_waypoints.sum())}) | "
                f"main-path launches {counts} | cuda==cpu: sampling and "
                f"grouping indices of 3 layers, features max err "
                f"{feat_err:.3g}, waypoints max err {wp_err:.3g}, gate "
                f"verdicts + counters | warm median encode "
                f"{med['encode_s']:.3f} ms, rollout {med['rollout_s']:.3f} "
                f"ms, gate {med['collision_s']:.3f} ms (of which forward "
                f"kinematics {1e3 * statistics.median(fk):.3f} ms) | per "
                f"launch "
                + ", ".join(f"{n} {statistics.mean(v):.4f} ms x{len(v)}"
                            for n, v in per_launch.items())
                + f" per plan | peak mem {peak / 2**20:.1f} MiB above the "
                f"{base / 2**20:.1f} MiB held before the plan | {card}")

    # the card's busy share of warm plans (fps sampling), per gate mode
    for mode, eng in engines.items():
        def plan_once(eng=eng):
            plan_with_collision_gate(planner, eng, cloud_cuda, q0_np,
                                     goal_np, num_steps=20, sampling="fps")
        plan_once()
        torch.cuda.synchronize()
        reps = 5
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                plan_once()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / reps
        events = prof.key_averages()
        on_card = [e for e in events if e.device_type == DeviceType.CUDA]
        dev_ms = sum(device_us(e) for e in on_card) / reps / 1e3
        launches_host = sum(e.self_cpu_time_total for e in events
                            if e.key == "cudaLaunchKernel") / reps / 1e3
        top = sorted(on_card, key=device_us, reverse=True)[:3]
        add_check_launches()
        log("13 fig18", f"{mode} fps, torch.profiler over {reps} warm plans: "
            f"traced wall {1e3 * wall:.3f} ms a plan, device time "
            f"{dev_ms:.3f} ms (card busy {100 * dev_ms / 1e3 / wall:.1f} "
            f"%), {sum(e.count for e in on_card) // reps} kernels and "
            f"copies a plan, cudaLaunchKernel {launches_host:.3f} ms of host "
            f"time; largest: " + "; ".join(
                f"{e.key[:40]} {device_us(e) / 1e3 / reps:.4f} ms "
                f"x{e.count // reps}" for e in top) + f" | {card}")

    # one batched encode + rollout + gate, B = 32 clouds, for throughput
    rsb = np.random.RandomState(5)
    B = 32
    clouds = torch.from_numpy(np.stack([
        tab.points[rsb.choice(len(tab.points), 2048, replace=False)]
        for _ in range(B)])).to(cuda)
    q0s = torch.from_numpy(rsb.uniform(-1, 1, (B, 7)).astype(np.float32)
                           ).to(cuda)
    goals = torch.from_numpy(rsb.uniform(-1, 1, (B, 7)).astype(np.float32)
                             ).to(cuda)
    eng = engines["wavefront_persistent"]
    with torch.inference_mode():
        with Recorder(kernel_attrs) as rec_b:
            traj_b = planner.rollout(clouds, q0s, goals, 20, "fps")
        flags_b, _ = check_trajectories(eng, traj_b)
        lc = planner.pointnet.encode_layers(clouds)
        lh = planner_cpu.pointnet.encode_layers(clouds.cpu())
        for li, (a, b) in enumerate(zip(lc, lh)):
            for key in ("center_idx", "neighbor_idx", "count"):
                if not torch.equal(getattr(a, key).cpu(), getattr(b, key)):
                    raise SystemExit(f"FAIL: batched fig18: layer {li + 1} "
                                     f"{key} differs cuda/cpu")
        if not (traj_b.shape == (B, 21, 7) and bool(traj_b.isfinite().all())
                and flags_b.shape == (B, 21)):
            raise SystemExit("FAIL: batched fig18: bad trajectories")
        wb = {"plan": [], "gate": []}
        for _ in range(5):
            t0 = time.perf_counter()
            traj_b = planner.rollout(clouds, q0s, goals, 20, "fps")
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            check_trajectories(eng, traj_b)
            torch.cuda.synchronize()
            wb["plan"].append(t1 - t0)
            wb["gate"].append(time.perf_counter() - t1)
    add_check_launches()
    mp, mg = (1e3 * statistics.median(wb[k]) for k in ("plan", "gate"))
    log("13 fig18", f"batched B={B}: encode + 20-step rollout {mp:.3f} ms, "
        f"gate (wavefront_persistent, {B * 21 * 7} OBBs) {mg:.3f} ms, "
        f"{B / ((mp + mg) / 1e3):.1f} plans/s; {int(flags_b.sum())} of "
        f"{B * 21} waypoints collide; sampling and grouping indices "
        f"cuda==cpu | {card}")

    log("13 planner", f"phase {lap():.1f} s")

    # ---- 14. fps and ballquery timed at the sa1 shapes ----------------------
    _, fa, fk = rec_b.calls["fps"][0]
    pts_b, m_b = fa[0], fa[1]
    got = fps_ops.fps(*fa, **fk)
    want = fps_ref(*fa, **fk)
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    errs["fps"] = max(errs["fps"], err)
    ms = cuda_time_ms(lambda: fps_ops.fps(*fa, **fk), 20)
    plain_ms = plain_ms_fps = cuda_time_ms(lambda: fps_ref(*fa, **fk), 2)
    Bf, Nf, _ = pts_b.shape
    # read once: the clouds; written once: the indices.  Operations: each
    # of the m-1 steps, per point, 3 subtractions, 3 products, 2 sums, a
    # min and a compare.
    bms, by = bound_ms(Bf * Nf * 12 + Bf * m_b * 4, Bf * (m_b - 1) * Nf * 10)
    fps_line = dict(
        name="fps", route="cuda",
        source="src/repro_torch/kernels/fps/csrc/fps.cu",
        replaces="src/repro/kernels/fps/kernel.py:15",
        max_abs_err=errs["fps"], ms=ms,
        plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None)
    lines.append(fps_line)
    f_call, f_bms, f_by = ms, bms, by

    def bq_bound(qs, pts, k, idx, cnt):
        """Pairs this data needs and the bound: a full ball stops at its
        k-th hit, a short one tests every point.  Read once: the queries
        and, per cloud, the points up to the furthest any of its queries
        needs; written once: indices and counts.  9 operations a pair."""
        Bq, Mq, _ = qs.shape
        Nq = pts.shape[1]
        need = torch.where(cnt == k, idx[..., k - 1].to(torch.int64) + 1, Nq)
        nbytes = (Bq * Mq * 12 + 12 * int(need.max(dim=1).values.sum())
                  + Bq * Mq * k * 4 + Bq * Mq * 4)
        return int(need.sum()), *bound_ms(nbytes, 9 * int(need.sum()))

    # sa1 of the batched encode, then the single plan's three layers
    bq_runs = []
    for label, (_, ba, bk) in [("sa1 of the batched encode",
                                rec_b.calls["ballquery"][0])] + [
            (f"sa{i + 1} of the single plan", call)
            for i, call in enumerate(bq_single)]:
        qs_b, pts_b, r_b, k_b = ba
        idx, cnt = bq_ops.ball_query(*ba, **bk)
        widx, wcnt = ball_query_ref(pts_b, qs_b, r_b, k_b)
        err = max(int((idx.to(torch.int64) - widx.to(torch.int64)).abs()
                      .max()), int((cnt - wcnt).abs().max()))
        errs["ballquery"] = max(errs["ballquery"], err)
        ms = cuda_time_ms(lambda ba=ba, bk=bk: bq_ops.ball_query(*ba, **bk),
                          50)
        plain_ms = cuda_time_ms(
            lambda: ball_query_ref(pts_b, qs_b, r_b, k_b), 5)
        pairs, bms, by = bq_bound(qs_b, pts_b, k_b, idx, cnt)
        bq_runs.append(dict(label=label, args=(ba, bk), B=qs_b.shape[0],
                            M=qs_b.shape[1], N=pts_b.shape[1], r=r_b, k=k_b,
                            full=float((cnt == k_b).float().mean()),
                            pairs=pairs, ms=ms, plain_ms=plain_ms,
                            bound_ms=bms, bound_by=by))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # each alone, after every call above was timed
    for run in bq_runs:
        ba, bk = run.pop("args")
        run["kernel_ms"] = kernel_device_ms(
            lambda ba=ba, bk=bk: bq_ops.ball_query(*ba, **bk),
            "ballquery_kernel", 20, "ballquery")
        qb = bq_ops.query_block(run["B"], run["M"], sms)
        log("14 ballquery", f"{run['label']} (B={run['B']}, M={run['M']}, "
            f"N={run['N']}, r={run['r']}, k={run['k']}; {qb} queries a CTA, "
            f"{run['B'] * -(-run['M'] // qb)} CTAs): "
            f"{100 * run['full']:.1f} % of balls full, {run['pairs']} pairs "
            f"needed of {run['B'] * run['M'] * run['N']}: call "
            f"{run['ms']:.4f} ms, kernel on the card {run['kernel_ms']:.5f} "
            f"ms (torch.profiler, {run['kernel_ms'] / run['bound_ms']:.1f}x "
            f"the bound), plain on card {run['plain_ms']:.3f} ms, bound "
            f"{run['bound_ms']:.5f} ms ({run['bound_by']}) | {card}")
    sa1 = bq_runs[0]
    lines.append(dict(
        name="ballquery", route="cuda",
        source="src/repro_torch/kernels/ballquery/csrc/ballquery.cu",
        replaces="src/repro/kernels/ballquery/kernel.py:23",
        max_abs_err=errs["ballquery"],
        ms=sa1["ms"], kernel_ms=sa1["kernel_ms"], plain_ms=sa1["plain_ms"],
        bound_ms=sa1["bound_ms"], bound_by=sa1["bound_by"], library_ms=None,
        single_plan=[{key: run[key] for key in (
            "label", "B", "M", "N", "r", "k", "ms", "kernel_ms", "plain_ms",
            "bound_ms", "bound_by")} for run in bq_runs[1:]]))
    # fps alone, after both calls above were timed
    f_device_ms = kernel_device_ms(lambda: fps_ops.fps(*fa, **fk),
                                   "fps_kernel", 20, "fps")
    fps_line["kernel_ms"] = f_device_ms
    log("14 fps", f"sa1 of the batched encode (B={Bf}, N={Nf}, m={m_b}, "
        f"{fps_ops.threads_for(Nf)} threads): call {f_call:.4f} ms, kernel "
        f"on the card {f_device_ms:.4f} ms (torch.profiler, "
        f"{1e3 * f_device_ms / (m_b - 1):.3f} us a step over {m_b - 1} "
        f"dependent steps, {f_device_ms / f_bms:.1f}x the bound), plain on "
        f"card {plain_ms_fps:.3f} ms, bound {f_bms:.5f} ms ({f_by}) | {card}")
    add_check_launches()

    log("14 timing", f"phase {lap():.1f} s")

    # ---- 15. wkv6 vs plain on the hard cases -------------------------------
    n_cases = 0
    for case in hard_cases() + edge_cases():
        for dtype in (torch.float32, torch.bfloat16):
            r, k, v = (torch.from_numpy(case[n]).to(cuda, dtype)
                       for n in "rkv")
            logw, u = (torch.from_numpy(case[n]).to(cuda)
                       for n in ("logw", "u"))
            o, st = wkv6_ops.wkv6(r, k, v, logw, u)
            wo, wst = wkv6_ref(r, k, v, logw, u)
            torch.cuda.synchronize()
            dname = str(dtype)[6:]
            ex = max(within_tol(o, wo, dname), within_tol(st, wst, "float32"))
            if ex > 0 or not (bool(o.isfinite().all())
                              and bool(st.isfinite().all())):
                raise SystemExit(f"FAIL: wkv6 differs from plain on "
                                 f"{case['name']} {dname} (excess {ex:.3g} "
                                 f"over the tolerance)")
            n_cases += 1
    add_check_launches()
    log("15 wkv6", f"kernel within cases.TOL of plain on {n_cases} cases "
        "(T 1/33/1024 at D 16/64; the chunk edges T 31/32/33/64/65 at D "
        "16/32/33/64/128; T 1/1024 at D 32/128; ordinary/strong/weak decay, "
        "per-row and shared u, fp32 and bf16)")

    log("15 wkv6", f"phase {lap():.1f} s")

    # ---- 16. the RWKV-6 model, 2 layers at full width, fp32, card vs CPU --
    cfg_full = get_config("rwkv6_1_6b")
    cfg_cut = cfg_full.replace(num_layers=LM_CUT_LAYERS,
                               param_dtype="float32",
                               compute_dtype="float32")
    t0 = time.perf_counter()
    lm_cpu = lm_api.init_params(cfg_cut, gen(7), device="cpu")
    t_init = time.perf_counter() - t0
    lm_cut = copy.deepcopy(lm_cpu).to(cuda)
    rs = np.random.RandomState(1)
    toks = torch.from_numpy(rs.randint(0, cfg_cut.vocab_size,
                                       (LM_CUT_BATCH, LM_CUT_PROMPT)))
    forced = torch.from_numpy(rs.randint(0, cfg_cut.vocab_size,
                                         (LM_CUT_STEPS, LM_CUT_BATCH)))
    prefill_c, decode_c = (lm_api.make_prefill_fn(cfg_cut),
                           lm_api.make_decode_fn(cfg_cut))
    outs = {}
    for name, model, dev in (("cuda", lm_cut, cuda), ("cpu", lm_cpu, "cpu")):
        logits, caches = prefill_c(model, {"tokens": toks.to(dev)})
        seq = [("prefill", logits, caches)]
        for i, tok in enumerate(forced):
            logits, caches = decode_c(model, tok.to(dev), LM_CUT_PROMPT + i,
                                      caches)
            seq.append((f"step {i}", logits, caches))
        outs[name] = seq
    lm_err = {}
    for (tag, lg, cg), (_, lh, ch) in zip(outs["cuda"], outs["cpu"]):
        pairs = [("logits", lg, lh)] + [(key, cg[key], ch[key])
                                        for key in ch]
        for key, a, b in pairs:
            a = a.cpu()
            if not (a.shape == b.shape and torch.allclose(a, b,
                                                          **LM_FP32_TOL)):
                raise SystemExit(f"FAIL: rwkv6 2-layer fp32 {tag} {key}: "
                                 f"card vs CPU beyond {LM_FP32_TOL} (max "
                                 f"err {float((a - b).abs().max()):.3g})")
            lm_err[key] = max(lm_err.get(key, 0.0),
                              float((a - b).abs().max()))
    del lm_cpu, lm_cut, outs
    add_check_launches()
    log("16 rwkv6 fp32", f"full width, {LM_CUT_LAYERS} layers, B="
        f"{LM_CUT_BATCH}, prompt {LM_CUT_PROMPT}, {LM_CUT_STEPS} "
        f"teacher-forced steps: card == CPU within {LM_FP32_TOL}; max err "
        + ", ".join(f"{k} {v:.3g}" for k, v in lm_err.items())
        + f" | weights drawn on the CPU in {t_init:.1f} s | {card}")

    log("16 rwkv6 fp32", f"phase {lap():.1f} s")

    # ---- 17. RWKV-6 1.6B serving at full width ----------------------------
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    lm = lm_api.init_params(cfg_full,
                            torch.Generator(device=cuda).manual_seed(0),
                            device=cuda)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_weights = sum(p.numel() for p in lm.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in lm.parameters())
    prompts = np.random.RandomState(0).randint(
        0, cfg_full.vocab_size, (LM_BATCH, LM_PROMPT))
    serve(lm, prompts, 2)                                   # warm-up
    add_check_launches()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    res = serve(lm, prompts, LM_TOKENS)
    counts = _build.launch_counts()
    _build.reset_launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for name, n in counts.items():
        main_launches[name] += n
    want = {name: (cfg_full.num_layers if name == "wkv6" else 0)
            for name in counts}
    if counts != want:
        raise SystemExit(f"FAIL: rwkv6 serve launched {counts}, want {want} "
                         "(one wkv6 per layer in the prefill, none in decode)")
    with torch.inference_mode():
        lm.lm_decode_step(res.tokens[:, -1], LM_PROMPT + LM_TOKENS,
                          res.caches)
    if _build.launch_counts()["wkv6"] != 0:
        raise SystemExit("FAIL: an rwkv6 decode step launched wkv6")
    gen_toks = res.tokens.cpu()
    if not (gen_toks.shape == (LM_BATCH, LM_TOKENS)
            and bool(((gen_toks >= 0)
                      & (gen_toks < cfg_full.vocab_size)).all())
            and bool(res.logits.float().isfinite().all())):
        raise SystemExit("FAIL: rwkv6 serve: bad tokens or logits")
    # the kernel on the 24 prefill inputs of one serve, against its plain
    # version on the same inputs
    with Recorder({"wkv6": (wkv6_ops, "wkv6_heads")}) as rec_w:
        serve(lm, prompts, 1)
    add_check_launches()
    calls = rec_w.calls["wkv6"]
    if len(calls) != cfg_full.num_layers:
        raise SystemExit(f"FAIL: recorder saw {len(calls)} wkv6_heads calls")

    def plain(r, k, v, logw, u):
        Bq, H, T, D = r.shape
        fold = [x.reshape(Bq * H, T, D) for x in (r, k, v, logw)]
        return wkv6_ref(*fold, u[None].expand(Bq, H, D).reshape(-1, D))

    wkv_err = 0.0
    with torch.inference_mode():
        for li, (fn, ca, ck) in enumerate(calls):
            o, st = fn(*ca, **ck)
            wo, wst = plain(*ca)
            o, st = o.reshape(wo.shape), st.reshape(wst.shape)
            ex = max(within_tol(o, wo, str(o.dtype)[6:]),
                     within_tol(st, wst, "float32"))
            if ex > 0:
                raise SystemExit(f"FAIL: wkv6 differs from plain on layer "
                                 f"{li}'s prefill input (excess {ex:.3g})")
            wkv_err = max(wkv_err, float((o.float() - wo.float()).abs().max()),
                          float((st - wst).abs().max()))
        fn, ca, ck = calls[0]
        ms = cuda_time_ms(lambda: fn(*ca, **ck), 20)
        w_device_ms = kernel_device_ms(lambda: fn(*ca, **ck), "wkv6", 20,
                                       "wkv6")
        plain_ms = cuda_time_ms(lambda: plain(*ca), 2)
    add_check_launches()
    r = ca[0]
    Bq, H, T, D = r.shape
    BH = Bq * H
    esz = r.element_size()
    # read once: r, k, v (their dtype), logw (fp32), u; written once: o
    # (r's dtype) and the fp32 state.
    wkv_bytes = BH * T * D * (4 * esz + 4) + BH * D * 4 + BH * D * D * 4
    # The chunked form (chunks of L steps, 8-step sub-blocks), per row and
    # chunk.  Tensor products: r.S and the state update (2 L D^2 each), A's
    # off-diagonal sub-blocks ((L^2 - 8 L) D) and A v with the bonus on its
    # diagonal (L (L + 1) D), each three times for the 3xTF32 split.
    # Elementwise fp32: the cumsum (L D), the decayed r and k (3 L D each:
    # a difference, an exponential, a product), the diagonal sub-blocks (5
    # a term of 28 pairs a sub-block), the bonus (3 L D), the decay of S
    # (D^2) and the rescaling of r and k by their block factors (2 L D).
    L_c, chunks = 32, BH * -(-T // 32)
    wkv_tensor = 3 * chunks * (4 * L_c * D * D + (L_c * L_c - 8 * L_c) * D
                               + L_c * (L_c + 1) * D)
    wkv_elem = chunks * (L_c * D * (1 + 6 + 3 + 2) + (L_c // 8) * 28 * 5 * D
                         + D * D)
    t_ops = max(wkv_tensor / PEAK_TF32_PER_S, wkv_elem / PEAK_FP32_PER_S)
    t_bytes = wkv_bytes / PEAK_BYTES_PER_S
    bms, by = 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                          else "operations")
    # the step-by-step form's operations, for the record: per row and step
    # r.S (2 D^2), w*S + k*v (3 D^2), the bonus (5 D) and exp(logw) (D)
    step_bms = 1e3 * BH * T * (5 * D * D + 6 * D) / PEAK_FP32_PER_S
    lines.append(dict(
        name="wkv6", route="cuda",
        source="src/repro_torch/kernels/wkv6/csrc/wkv6.cu",
        replaces="src/repro/kernels/wkv6/kernel.py:27",
        max_abs_err=wkv_err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=None))
    # warm walls: 10 serves
    pre, dec = [], []
    for _ in range(10):
        rr = serve(lm, prompts, LM_TOKENS)
        pre.append(rr.prefill_s)
        dec.append(statistics.mean(rr.decode_s))
    add_check_launches()
    pre_ms, dec_ms = (1e3 * statistics.median(x) for x in (pre, dec))
    # prefill/decode consistency: decode token S+1 after prefilling S
    # tokens against the last logits of a forward pass over S+1 tokens
    tokens = torch.from_numpy(prompts).to(cuda)
    logits, caches = lm_api.make_prefill_fn(cfg_full)(lm, {"tokens": tokens})
    nxt = logits.argmax(-1)
    step, _ = lm_api.make_decode_fn(cfg_full)(lm, nxt, LM_PROMPT, caches)
    with torch.inference_mode():
        full, _ = lm.lm_forward(torch.cat([tokens, nxt[:, None]], 1),
                                last_only=True)
    step, full = step.float(), full[:, -1].float()
    delta = float((step - full).abs().max())
    top2 = full.topk(2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    agree = step.argmax(-1) == full.argmax(-1)
    near_tie = gap <= 2 * delta
    if not (delta <= LM_CONSIST_ATOL and bool((agree | near_tie).all())):
        raise SystemExit(f"FAIL: rwkv6 prefill/decode consistency: max|d| "
                         f"{delta:.4g} (bound {LM_CONSIST_ATOL}), greedy "
                         f"agrees on {int(agree.sum())} of {LM_BATCH} rows")
    add_check_launches()
    # busy share: one warm prefill alone, then one warm serve; decode's
    # share is the difference of the two
    traced = []
    for n_tok in (1, LM_TOKENS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            serve(lm, prompts, n_tok)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        on_card = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        traced.append((wall, sum(device_us(e) for e in on_card) / 1e6,
                       sum(e.count for e in on_card), on_card))
    add_check_launches()
    (w_pre, d_pre, n_pre, _), (w_all, d_all, n_all, on_card) = traced
    top = sorted(on_card, key=device_us, reverse=True)[:4]
    log("17 rwkv6 serve", f"{cfg_full.name}: {n_weights} weights, "
        f"{w_bytes / 1e9:.3f} GB bf16/fp32, drawn on the card in "
        f"{t_init:.1f} s | B={LM_BATCH} prompt {LM_PROMPT}, {LM_TOKENS} "
        f"greedy tokens | main-path launches {counts} (decode step: 0) | "
        f"warm median prefill {pre_ms:.3f} ms, decode {dec_ms:.3f} ms/token"
        f", {LM_BATCH / (dec_ms / 1e3):.1f} tokens/s | peak mem "
        f"{peak / 2**30:.3f} GiB ({held / 2**30:.3f} GiB held before the "
        f"serve, of which {base / 2**30:.3f} GiB before the model) | {card}")
    log("17 rwkv6 serve", f"wkv6 on the {len(calls)} captured prefill "
        f"inputs (BH={BH}, T={T}, D={D}, {r.dtype}): kernel within "
        f"cases.TOL of plain, max abs err {wkv_err:.4g}; call {ms:.4f} "
        f"ms a launch ({cfg_full.num_layers * ms:.3f} ms a prefill), kernel "
        f"on the card {w_device_ms:.4f} ms (torch.profiler, "
        f"{w_device_ms / bms:.2f}x the bound), plain on card "
        f"{plain_ms:.3f} ms, bound {bms:.5f} ms ({by}: {wkv_bytes} B, "
        f"{wkv_tensor} tensor and {wkv_elem} fp32 operations of the "
        f"chunked form); the step form's operations alone {step_bms:.4f} ms"
        f" | {card}")
    log("17 rwkv6 serve", f"prefill/decode consistency: max|d| logits "
        f"{delta:.4g} (bound {LM_CONSIST_ATOL}), greedy agrees on "
        f"{int(agree.sum())} of {LM_BATCH} rows, smallest top-2 gap "
        f"{float(gap.min()):.4g}, logits std {float(full.std()):.3f}")
    log("17 rwkv6 serve", f"torch.profiler: a warm prefill, traced wall "
        f"{1e3 * w_pre:.3f} ms, device time {1e3 * d_pre:.3f} ms (busy "
        f"{100 * d_pre / w_pre:.1f} %), {n_pre} kernels and copies; its "
        f"{LM_TOKENS - 1} decode steps, traced wall "
        f"{1e3 * (w_all - w_pre):.3f} ms, device time "
        f"{1e3 * (d_all - d_pre):.3f} ms (busy "
        f"{100 * (d_all - d_pre) / (w_all - w_pre):.1f} %), "
        f"{(n_all - n_pre) // (LM_TOKENS - 1)} kernels and copies a token; "
        f"largest over the serve: "
        + "; ".join(f"{e.key[:48]} {device_us(e) / 1e3:.3f} ms x{e.count}"
                    for e in top) + f" | {card}")
    del lm, rec_w, calls
    log("17 rwkv6 serve", f"phase {lap():.1f} s")

    # ---- 18. flash_attention vs plain on the hard cases --------------------
    n_cases = 0
    for case in flash_cases.hard_cases():
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = flash_cases.tensors(case, cuda, dtype)
            o = flash_ops.flash_attention(q, k, v, case["causal"])
            want = attention_ref(q, k, v, case["causal"])
            torch.cuda.synchronize()
            dname = str(dtype)[6:]
            ex = flash_cases.within_tol(o, want, dname, case["score_scale"])
            if ex > 0 or not bool(o.isfinite().all()):
                raise SystemExit(f"FAIL: flash_attention differs from plain "
                                 f"on {case['name']} {dname} (excess "
                                 f"{ex:.3g} over the tolerance)")
            n_cases += 1
    add_check_launches()
    log("18 flash_attention", f"kernel within cases.TOL of plain on {n_cases} "
        f"cases (d {'/'.join(map(str, sorted(flash_cases.WIDTHS)))}; causal "
        f"T {'/'.join(map(str, sorted(flash_cases.CAUSAL_LENGTHS)))}; "
        f"non-causal (Tq, Tk) {flash_cases.CROSS_LENGTHS}; groups "
        f"{'/'.join(map(str, flash_cases.GROUPS))}; strided views; x8 "
        f"scores; fp32 and bf16) in {lap():.1f} s")

    # ---- 19. GLM-4 9B, 2 layers at full width, fp32, card vs CPU ----------
    g_full = get_config("glm4_9b")
    g_cut = g_full.replace(num_layers=LM_CUT_LAYERS, param_dtype="float32",
                           compute_dtype="float32")
    t0 = time.perf_counter()
    g_card = lm_api.init_params(
        g_cut, torch.Generator(device=cuda).manual_seed(7), device=cuda)
    g_cpu = lm_api.init_params(g_cut, device="meta").to_empty(device="cpu")
    g_cpu.load_state_dict(g_card.state_dict())
    t_init = time.perf_counter() - t0
    rs = np.random.RandomState(1)
    toks = torch.from_numpy(rs.randint(0, g_cut.vocab_size,
                                       (LM_CUT_BATCH, LM_CUT_PROMPT)))
    forced = torch.from_numpy(rs.randint(0, g_cut.vocab_size,
                                         (LM_CUT_STEPS, LM_CUT_BATCH)))
    prefill_g = lm_api.make_prefill_fn(g_cut, LM_CUT_PROMPT + LM_CUT_STEPS)
    decode_g = lm_api.make_decode_fn(g_cut)
    g_err = {}

    def compare(tag, got, want):
        """Logits and every cache tensor, card against CPU, now: the
        attention caches are written in place by the next step."""
        lg, cg = got
        lh, ch = want
        pairs = [("logits", lg, lh)] + [
            (f"kv.{key}", cg["kv"][key], ch["kv"][key]) for key in "kv"]
        for key, a, b in pairs:
            a = a.cpu()
            if not (a.shape == b.shape and torch.allclose(a, b,
                                                          **LM_FP32_TOL)):
                raise SystemExit(f"FAIL: glm4 2-layer fp32 {tag} {key}: card "
                                 f"vs CPU beyond {LM_FP32_TOL} (max err "
                                 f"{float((a - b).abs().max()):.3g})")
            g_err[key] = max(g_err.get(key, 0.0), float((a - b).abs().max()))

    got = prefill_g(g_card, {"tokens": toks.to(cuda)})
    want = prefill_g(g_cpu, {"tokens": toks})
    compare("prefill", got, want)
    for i, tok in enumerate(forced):
        got = decode_g(g_card, tok.to(cuda), LM_CUT_PROMPT + i, got[1])
        want = decode_g(g_cpu, tok, LM_CUT_PROMPT + i, want[1])
        compare(f"step {i}", got, want)
    del g_card, g_cpu, got, want
    add_check_launches()
    log("19 glm4 fp32", f"full width, {LM_CUT_LAYERS} layers, B="
        f"{LM_CUT_BATCH}, prompt {LM_CUT_PROMPT}, {LM_CUT_STEPS} "
        f"teacher-forced steps: card == CPU within {LM_FP32_TOL}; max err "
        + ", ".join(f"{k} {v:.3g}" for k, v in g_err.items())
        + f" | weights drawn on the card and copied to the CPU in "
        f"{t_init:.1f} s | {lap():.1f} s | {card}")

    # ---- 20. GLM-4 9B serving at full width -------------------------------
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    glm = lm_api.init_params(g_full,
                             torch.Generator(device=cuda).manual_seed(0),
                             device=cuda)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_weights = sum(p.numel() for p in glm.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in glm.parameters())
    prompts = np.random.RandomState(0).randint(
        0, g_full.vocab_size, (LM_BATCH, LM_PROMPT))
    serve(glm, prompts, 2)                                  # warm-up
    add_check_launches()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    res = serve(glm, prompts, LM_TOKENS)
    counts = _build.launch_counts()
    _build.reset_launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for name, n in counts.items():
        main_launches[name] += n
    want = {name: (g_full.num_layers if name == "flash_attention" else 0)
            for name in counts}
    if counts != want:
        raise SystemExit(f"FAIL: glm4 serve launched {counts}, want {want} "
                         "(one flash_attention per layer in the prefill, "
                         "none in decode)")
    with torch.inference_mode():                 # the next free KV slot
        glm.lm_decode_step(res.tokens[:, -1], LM_PROMPT + LM_TOKENS - 1,
                           res.caches)
    torch.cuda.synchronize()
    if any(_build.launch_counts().values()):
        raise SystemExit(f"FAIL: a glm4 decode step launched "
                         f"{_build.launch_counts()}")
    gen_toks = res.tokens.cpu()
    kv_shape = tuple(res.caches["kv"]["k"].shape)
    if not (gen_toks.shape == (LM_BATCH, LM_TOKENS)
            and bool(((gen_toks >= 0)
                      & (gen_toks < g_full.vocab_size)).all())
            and bool(res.logits.float().isfinite().all())
            and kv_shape == (g_full.num_layers, LM_BATCH,
                             LM_PROMPT + LM_TOKENS, g_full.num_kv_heads,
                             g_full.hd)):
        raise SystemExit(f"FAIL: glm4 serve: bad tokens, logits or caches "
                         f"{kv_shape}")
    # the kernel on the 40 prefill inputs of one serve, against its plain
    # version on the same inputs
    with Recorder({"flash": (flash_ops, "flash_attention")}) as rec_f:
        serve(glm, prompts, 1)
    add_check_launches()
    calls = rec_f.calls["flash"]
    if len(calls) != g_full.num_layers:
        raise SystemExit(f"FAIL: recorder saw {len(calls)} flash_attention "
                         "calls")
    fa_err = 0.0
    with torch.inference_mode():
        for li, (fn, ca, ck) in enumerate(calls):
            o = fn(*ca, **ck)
            wo = attention_ref(*ca, **ck)
            ex = flash_cases.within_tol(o, wo, "bfloat16")
            if ex > 0:
                raise SystemExit(f"FAIL: flash_attention differs from plain "
                                 f"on layer {li}'s prefill input (excess "
                                 f"{ex:.3g})")
            fa_err = max(fa_err, float((o.float() - wo.float()).abs().max()))
        fn, ca, ck = calls[0]
        q, k, v = ca[:3]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib_err = float((sdpa(q, k, v, is_causal=True, enable_gqa=True)
                         .float() - attention_ref(q, k, v).float())
                        .abs().max())
        ms = cuda_time_ms(lambda: fn(*ca, **ck), 20)
        plain_ms = cuda_time_ms(lambda: attention_ref(*ca, **ck), 2)
        lib_ms = cuda_time_ms(
            lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True), 20)
    add_check_launches()
    Bq, Hq, T, d = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    # read once: q, k, v; written once: o (all bf16).  Operations: per
    # query row i and key j <= i, q.k and p*v, 2 d products and 2 d sums
    # on the bf16 tensor cores; the softmax (scale, max, exp, sum,
    # rescale: ~6 fp32 operations a pair) runs beside them on the CUDA
    # cores, so the least time is the larger of the two.
    pairs = sum(min(i + 1, Tk) for i in range(T)) * Bq * Hq
    fa_bytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    fa_mma, fa_fp32 = 4 * d * pairs, 6 * pairs
    t_bytes = fa_bytes / PEAK_BYTES_PER_S
    t_ops = max(fa_mma / PEAK_BF16_PER_S, fa_fp32 / PEAK_FP32_PER_S)
    fa_bound, fa_by = (1e3 * max(t_bytes, t_ops),
                       "bytes" if t_bytes >= t_ops else "operations")
    lines.append(dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/flash_attention/csrc/flash_attn.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:25",
        max_abs_err=fa_err, ms=ms, plain_ms=plain_ms, bound_ms=fa_bound,
        bound_by=fa_by, library_ms=lib_ms))
    # warm walls: 10 serves
    pre, dec = [], []
    for _ in range(10):
        rr = serve(glm, prompts, LM_TOKENS)
        pre.append(rr.prefill_s)
        dec.append(statistics.mean(rr.decode_s))
    del rr
    add_check_launches()
    pre_ms, dec_ms = (1e3 * statistics.median(x) for x in (pre, dec))
    # prefill/decode consistency: decode token S+1 after prefilling S
    # tokens against the last logits of a forward pass over S+1 tokens
    tokens = torch.from_numpy(prompts).to(cuda)
    logits, caches = lm_api.make_prefill_fn(g_full)(glm, {"tokens": tokens})
    nxt = logits.argmax(-1)
    step, _ = lm_api.make_decode_fn(g_full)(glm, nxt, LM_PROMPT, caches)
    with torch.inference_mode():
        full, _ = glm.lm_forward(torch.cat([tokens, nxt[:, None]], 1),
                                 last_only=True)
    step, full = step.float(), full[:, -1].float()
    del caches
    delta = float((step - full).abs().max())
    top2 = full.topk(2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    agree = step.argmax(-1) == full.argmax(-1)
    near_tie = gap <= 2 * delta
    if not (delta <= LM_CONSIST_ATOL and bool((agree | near_tie).all())):
        raise SystemExit(f"FAIL: glm4 prefill/decode consistency: max|d| "
                         f"{delta:.4g} (bound {LM_CONSIST_ATOL}), greedy "
                         f"agrees on {int(agree.sum())} of {LM_BATCH} rows")
    add_check_launches()
    # busy share: one warm prefill alone, then one warm serve; decode's
    # share is the difference of the two
    traced = []
    for n_tok in (1, LM_TOKENS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            serve(glm, prompts, n_tok)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        on_card = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        traced.append((wall, sum(device_us(e) for e in on_card) / 1e6,
                       sum(e.count for e in on_card), on_card))
    add_check_launches()
    (w_pre, d_pre, n_pre, on_pre), (w_all, d_all, n_all, on_card) = traced
    top_pre = sorted(on_pre, key=device_us, reverse=True)[:5]
    top = sorted(on_card, key=device_us, reverse=True)[:5]
    log("20 glm4 serve", f"{g_full.name}: {n_weights} weights, "
        f"{w_bytes / 1e9:.3f} GB bf16, drawn on the card in {t_init:.1f} s "
        f"| B={LM_BATCH} prompt {LM_PROMPT}, {LM_TOKENS} greedy tokens, KV "
        f"caches {kv_shape} | main-path launches {counts} (decode step: 0) "
        f"| warm median prefill {pre_ms:.3f} ms, decode {dec_ms:.3f} "
        f"ms/token, {LM_BATCH / (dec_ms / 1e3):.1f} tokens/s | peak mem "
        f"{peak / 2**30:.3f} GiB ({held / 2**30:.3f} GiB held before the "
        f"serve, of which {base / 2**30:.3f} GiB before the model) | {card}")
    log("20 glm4 serve", f"flash_attention on the {len(calls)} captured "
        f"prefill inputs (B={Bq}, Hq={Hq}, Hkv={Hkv}, T={T}, d={d}, "
        f"{q.dtype}, q strides {q.stride()}, v strides {v.stride()}): "
        f"kernel within cases.TOL of plain, max abs err {fa_err:.4g}; "
        f"kernel {ms:.4f} ms a launch ({g_full.num_layers * ms:.3f} ms a "
        f"prefill), plain on card {plain_ms:.3f} ms, "
        f"scaled_dot_product_attention(enable_gqa) {lib_ms:.4f} ms (max abs "
        f"diff to plain {lib_err:.4g}), bound {fa_bound:.5f} ms ({fa_by}: "
        f"{fa_bytes} B, {fa_mma} bf16 tensor ops, {fa_fp32} fp32 ops) | "
        f"achieved {fa_mma / ms / 1e9:.1f} TFLOP/s on the tensor cores, "
        f"{100 * fa_bound / ms:.1f} % of the bound, {ms / lib_ms:.3f}x "
        f"scaled_dot_product_attention | {card}")
    log("20 glm4 serve", f"prefill/decode consistency at {LM_PROMPT + 1} "
        f"tokens: max|d| logits {delta:.4g} (bound {LM_CONSIST_ATOL}), "
        f"greedy agrees on {int(agree.sum())} of {LM_BATCH} rows, smallest "
        f"top-2 gap {float(gap.min()):.4g}, logits std "
        f"{float(full.std()):.3f}")
    log("20 glm4 serve", f"torch.profiler: a warm prefill, traced wall "
        f"{1e3 * w_pre:.3f} ms, device time {1e3 * d_pre:.3f} ms (busy "
        f"{100 * d_pre / w_pre:.1f} %), {n_pre} kernels and copies, largest: "
        + "; ".join(f"{e.key[:48]} {device_us(e) / 1e3:.3f} ms x{e.count}"
                    for e in top_pre)
        + f" | its {LM_TOKENS - 1} decode steps, traced wall "
        f"{1e3 * (w_all - w_pre):.3f} ms, device time "
        f"{1e3 * (d_all - d_pre):.3f} ms (busy "
        f"{100 * (d_all - d_pre) / (w_all - w_pre):.1f} %), "
        f"{(n_all - n_pre) // (LM_TOKENS - 1)} kernels and copies a token; "
        f"largest over the serve: "
        + "; ".join(f"{e.key[:48]} {device_us(e) / 1e3:.3f} ms x{e.count}"
                    for e in top) + f" | {lap():.1f} s | {card}")
    del glm, rec_f, calls, q, k, v, res

    # ---- 21. swept-edge CCD at fig_edges' full scale -------------------------
    if "cubby" in scenes:
        ctree, csc = scenes["cubby"][0], scene_objs["cubby"]
    else:
        csc = make_scene("cubby", num_points=524288)
        ctree = build_octree(csc.points, depth=7)
    rs = np.random.RandomState(0)      # fig_edges' PRM edges
    E_ccd, R_ccd = 64, 32
    qf = rs.uniform(PANDA_JOINT_LO, PANDA_JOINT_HI, (E_ccd, 7)) \
        .astype(np.float32)
    qt = np.clip(qf + rs.uniform(-0.35, 0.35, (E_ccd, 7)).astype(np.float32),
                 PANDA_JOINT_LO, PANDA_JOINT_HI)
    ccd_kw = dict(resolution=R_ccd, base_pos=csc.robot_base)
    wps = torch.from_numpy(sweep_mod.edge_waypoints(qf, qt, R_ccd)).to(cuda)
    # FK on the card and on the CPU differ in the last bits (cuBLAS sums the
    # 4 x 4 products in another order), so the CPU sweep takes the card's
    # FK arrays: the same inputs for the rest of the path.
    card_geo = sweep_mod.edge_link_geometry(qf, qt, R_ccd,
                                            base_pos=csc.robot_base,
                                            device=cuda)
    fk_geo = sweep_mod.edge_link_geometry

    def rounds_of(eng):
        """Record every engine call of a sweep: (plan, counters)."""
        calls = []

        def rec(plan, *a, **k):
            v, c = type(eng).execute(eng, plan, *a, **k)
            calls.append((plan, c))
            return v, c
        eng.execute = rec
        return calls

    ccd_ref = None
    ccd_persist = {}
    for mode in ("wavefront_persistent", "wavefront", "wavefront_fused"):
        cfg = EngineConfig(mode=mode)
        eng = CollisionEngine(ctree, cfg, device="cuda")
        calls = rounds_of(eng)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        add_check_launches()
        res = check_edges(eng, qf, qt, **ccd_kw)
        counts = _build.launch_counts()
        _build.reset_launch_counts()
        peak = torch.cuda.max_memory_allocated()
        del eng.execute
        for name, k in counts.items():
            main_launches[name] += k
        want_kernels = {"wavefront_persistent": ("persist",),
                        "wavefront": ("compact",),
                        "wavefront_fused": ("traverse", "compact")}[mode]
        for name, k in counts.items():
            if (k > 0) != (name in want_kernels):
                raise SystemExit(f"FAIL: CCD {mode}: {name} launched {k} "
                                 f"times on the main path")
        n_calls = len(calls)
        n_esc = sum(c.escalations for _, c in calls)
        if mode == "wavefront_persistent" and \
                counts["persist"] != n_calls + n_esc:
            raise SystemExit(f"FAIL: CCD: {counts['persist']} persist "
                             f"launches for {n_calls} engine calls and "
                             f"{n_esc} escalations")
        c = res.counters
        if c.ref_arm_fallbacks != 0 or c.frontier_overflow != 0:
            raise SystemExit(f"FAIL: CCD {mode}: ref_arm_fallbacks "
                             f"{c.ref_arm_fallbacks}, overflow "
                             f"{c.frontier_overflow}")
        if not (res.first_hit.shape == (E_ccd,) and res.collide.any()
                and np.isfinite(res.first_hit[res.collide]).all()
                and np.isinf(res.first_hit[~res.collide]).all()):
            raise SystemExit(f"FAIL: CCD {mode}: implausible verdicts")
        # the same engine on the CPU, on the card's FK arrays
        sweep_mod.edge_link_geometry = lambda *a, **k: card_geo
        try:
            t0 = time.perf_counter()
            cres = check_edges(CollisionEngine(ctree, cfg, device="cpu"),
                               qf, qt, **ccd_kw)
            t_cpu = time.perf_counter() - t0
        finally:
            sweep_mod.edge_link_geometry = fk_geo
        if not (np.array_equal(res.first_hit, cres.first_hit)
                and np.array_equal(res.collide, cres.collide)):
            raise SystemExit(f"FAIL: CCD {mode}: card verdicts differ from "
                             f"the CPU engine's")
        a, b = c.as_dict(), cres.counters.as_dict()
        for k in a:
            if k != "wall_time_s" and a[k] != b[k]:
                raise SystemExit(f"FAIL: CCD {mode}: counter {k} differs: "
                                 f"cuda {a[k]} vs cpu {b[k]}")
        if ccd_ref is None:
            ccd_ref = res
        elif not (np.array_equal(res.first_hit, ccd_ref.first_hit)
                  and np.array_equal(res.collide, ccd_ref.collide)):
            raise SystemExit(f"FAIL: CCD {mode}: verdicts differ from "
                             f"wavefront_persistent")
        # dense sampling at the same resolution, and the no-exit arm
        flags, cd = check_trajectories(eng, wps, base_pos=csc.robot_base)
        dense = np.asarray(flags).any(axis=1)
        if not (~dense | res.collide).all():
            raise SystemExit(f"FAIL: CCD {mode}: a densely sampled "
                             f"collision is missing from the swept verdicts")
        add_check_launches()
        rne = check_edges(eng, qf, qt, in_traversal_exit=False, **ccd_kw)
        if not (np.array_equal(rne.first_hit, res.first_hit)
                and np.array_equal(rne.collide, res.collide)
                and rne.counters.nodes_traversed >= c.nodes_traversed):
            raise SystemExit(f"FAIL: CCD {mode}: in_traversal_exit=False "
                             f"changed the verdicts or visited fewer nodes")
        walls, dwalls = [], []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            check_edges(eng, qf, qt, **ccd_kw)
            walls.append(time.perf_counter() - t0)
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            check_trajectories(eng, wps, base_pos=csc.robot_base)
            dwalls.append(time.perf_counter() - t0)
        note = ""
        if mode == "wavefront_persistent":
            # every persist call of a warm sweep, against its plain version
            with Recorder({"persist": (persist_ops, "persist_tiles")}) as rec:
                check_edges(eng, qf, qt, **ccd_kw)
            p_calls = rec.calls["persist"]
            err = 0
            for fn, ca, ck in p_calls:
                got = fn(*ca, **ck)
                want = persist_tiles_ref(*ca, **ck)
                err = max([err] + [int((x.to(torch.int64) - y.to(torch.int64))
                                       .abs().max()) for x, y in
                                   zip(got[:4], want[:4])])
            if err:
                raise SystemExit(f"FAIL: CCD: persist differs from plain on "
                                 f"a sweep's pool (max abs err {err})")
            p_ms = [cuda_time_ms(lambda: fn(*ca, **ck), 20)
                    for fn, ca, ck in p_calls]
            ccd_persist = dict(calls=p_calls, ms=p_ms)
            note = (f" | {len(p_calls)} persist calls a sweep == plain, "
                    f"{sum(p_ms):.4f} ms of calls a sweep (each "
                    f"{min(p_ms):.4f}-{max(p_ms):.4f} ms, back to back)")
        # where a warm sweep's host time goes, then the card's busy share
        # in a traced one (after every call above is timed)
        spent = dict(fk=0.0, fit=0.0, engine=0.0)

        def timed(key, fn):
            def run(*a, **k):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    spent[key] += time.perf_counter() - t0
            return run
        fit = sweep_mod.swept_obbs
        sweep_mod.edge_link_geometry = timed("fk", fk_geo)
        sweep_mod.swept_obbs = timed("fit", fit)
        eng.execute = timed("engine", eng.execute)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            wres = check_edges(eng, qf, qt, **ccd_kw)
            t_warm = time.perf_counter() - t0
        finally:
            sweep_mod.edge_link_geometry = fk_geo
            sweep_mod.swept_obbs = fit
            del eng.execute
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            check_edges(eng, qf, qt, **ccd_kw)
            torch.cuda.synchronize()
            t_traced = time.perf_counter() - t0
        on_card = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        d_traced = sum(device_us(e) for e in on_card) / 1e6
        note += (f" | a warm sweep {1e3 * t_warm:.3f} ms: FK "
                 f"{1e3 * spent['fk']:.3f}, swept fits "
                 f"{1e3 * spent['fit']:.3f}, engine calls "
                 f"{1e3 * spent['engine']:.3f} ({wres.counters.escalations} "
                 f"escalations), the rest "
                 f"{1e3 * (t_warm - sum(spent.values())):.3f} | traced: "
                 f"wall {1e3 * t_traced:.3f} ms, device time "
                 f"{1e3 * d_traced:.3f} ms (busy "
                 f"{100 * d_traced / t_traced:.1f} %), "
                 f"{sum(e.count for e in on_card)} kernels and copies")
        shapes = []
        for plan, cc in calls:
            tiles = ""
            if mode == "wavefront_persistent" and \
                    plan.owner_of_query is not None:
                tm = persist_ops.build_tile_map(
                    plan.num_queries, persist_ops.DEFAULT_BQ, None,
                    plan.owner_of_query.numpy())
                tiles = f"/{tm.num_tiles}x{tm.bq}"
            shapes.append(f"{plan.num_queries}{tiles}"
                          + ("p" if plan.payload is not None else ""))
        log("21 ccd", f"{mode}: {E_ccd} edges at R={R_ccd}, "
            f"{int(res.collide.sum())} collide (dense: {int(dense.sum())}), "
            f"{n_calls} engine calls (slots[/tiles x bq], p = payload round: "
            f"{' '.join(shapes)}), escalations {n_esc} | main-path launches "
            f"{counts} | cuda == cpu first hits, verdicts, counters (cpu "
            f"engine {t_cpu:.1f} s) | nodes {c.nodes_traversed} (no exit "
            f"{rne.counters.nodes_traversed}, "
            f"{rne.counters.nodes_traversed / max(c.nodes_traversed, 1):.2f}"
            f"x), dense nodes {cd.nodes_traversed} | warm wall median "
            f"{1e3 * statistics.median(walls):.3f} ms, dense check of "
            f"{E_ccd * (R_ccd + 1)} waypoints "
            f"{1e3 * statistics.median(dwalls):.3f} ms{note} | peak mem "
            f"{peak / 2**20:.1f} MiB | {card}")
    add_check_launches()
    # fig_edges' no-exit baseline: a staged_noexit engine, whose rounds take
    # boolean plans and reduce on the host (no owner or payload lanes)
    cfg = EngineConfig(mode="staged_noexit")
    eng = CollisionEngine(ctree, cfg, device="cuda")
    calls = rounds_of(eng)
    torch.cuda.synchronize()
    res_nx = check_edges(eng, qf, qt, **ccd_kw)
    counts = _build.launch_counts()
    _build.reset_launch_counts()
    del eng.execute
    for name, k in counts.items():
        main_launches[name] += k
        if (k > 0) != (name == "compact"):
            raise SystemExit(f"FAIL: CCD staged_noexit: {name} launched {k} "
                             f"times on the main path")
    if any(plan.grouped for plan, _ in calls):
        raise SystemExit("FAIL: CCD staged_noexit: a round took owner or "
                         "payload lanes")
    sweep_mod.edge_link_geometry = lambda *a, **k: card_geo
    try:
        t0 = time.perf_counter()
        cres = check_edges(CollisionEngine(ctree, cfg, device="cpu"), qf, qt,
                           **ccd_kw)
        t_cpu = time.perf_counter() - t0
    finally:
        sweep_mod.edge_link_geometry = fk_geo
    if not (np.array_equal(res_nx.first_hit, cres.first_hit)
            and np.array_equal(res_nx.collide, cres.collide)):
        raise SystemExit("FAIL: CCD staged_noexit: card verdicts differ from "
                         "the CPU engine's")
    a, b = res_nx.counters.as_dict(), cres.counters.as_dict()
    for k in a:
        if k != "wall_time_s" and a[k] != b[k]:
            raise SystemExit(f"FAIL: CCD staged_noexit: counter {k} differs: "
                             f"cuda {a[k]} vs cpu {b[k]}")
    if not (np.array_equal(res_nx.first_hit, ccd_ref.first_hit)
            and np.array_equal(res_nx.collide, ccd_ref.collide)):
        raise SystemExit("FAIL: CCD staged_noexit: first hits differ from the "
                         "exit arm's")
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        check_edges(eng, qf, qt, **ccd_kw)
        walls.append(time.perf_counter() - t0)
    add_check_launches()
    cx, cs = res_nx.counters, ccd_ref.counters
    log("21 ccd", f"staged_noexit (fig_edges' no-exit baseline): {len(calls)} "
        f"engine calls, boolean plans | main-path launches {counts} | cuda == "
        f"cpu first hits, verdicts, counters (cpu engine {t_cpu:.1f} s), first "
        f"hits == the exit arm's | nodes {cx.nodes_traversed}, "
        f"wavefront_persistent {cs.nodes_traversed}: no exit / exit "
        f"{cx.nodes_traversed / max(cs.nodes_traversed, 1):.3f}x (fig_edges' "
        f"exit_ratio), frontier_overflow {cx.frontier_overflow} | warm wall "
        f"median of 3 {1e3 * statistics.median(walls):.3f} ms | {card}")
    p_calls, p_ms = ccd_persist["calls"], ccd_persist["ms"]
    big = max(range(len(p_calls)),
              key=lambda i: p_calls[i][2]["obb"].shape[0])
    fn, ca, ck = p_calls[big]
    big_ms = kernel_device_ms(lambda: fn(*ca, **ck), "persist_kernel", 20,
                              "persist")
    add_check_launches()
    persist_line["ccd_ms"] = sum(p_ms)
    persist_line["ccd_kernel_ms"] = big_ms
    log("21 ccd", f"persist alone (torch.profiler) on the sweep's widest "
        f"pool: {big_ms:.5f} ms, its call {p_ms[big]:.4f} ms | phase "
        f"{lap():.1f} s | {card}")

    # ---- 22. the Fig. 11 arms at paper scale ------------------------------
    f11_modes = ("naive", "rta_like", "staged_noexit", "predicated",
                 "wavefront_host")
    f11_env = "cubby" if "cubby" in scenes else env0
    block = EngineConfig().query_block
    device_modes = ("wavefront_persistent", "wavefront", "wavefront_fused")
    add_check_launches()
    for env, (tree, obbs, _) in scenes.items():
        v_wf, c_wf, _ = p8[env]["wavefront"]
        Q, n_tests = obbs.n, obbs.n * tree.num_leaves
        walls8 = ", ".join(f"{m} {1e3 * p8[env][m][2]:.3f}"
                           for m in device_modes)
        runs = {}
        for mode in f11_modes:
            cfg = EngineConfig(mode=mode)
            eng = CollisionEngine(tree, cfg, device="cuda")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launch_counts()
            v1, c1 = eng.query(obbs)
            counts = _build.launch_counts()
            _build.reset_launch_counts()
            peak = torch.cuda.max_memory_allocated()
            for name, k in counts.items():
                main_launches[name] += k
            # naive: one sact_dense a block of OBBs; the host arms: one
            # compact a level after the first
            want = ({"sact_dense": -(-Q // block)} if mode == "naive"
                    else {"compact": len(c1.nodes_per_level) - 1})
            for name, k in counts.items():
                if k != want.get(name, 0):
                    raise SystemExit(f"FAIL: {env} {mode}: {name} launched "
                                     f"{k} times on the main path, want "
                                     f"{want.get(name, 0)}")
            if not np.array_equal(v1, v_wf):
                raise SystemExit(f"FAIL: {env} {mode}: verdicts differ from "
                                 f"the card's wavefront (phase 8)")
            walls = [eng.query(obbs)[1].wall_time_s for _ in range(5)]
            add_check_launches()
            runs[mode] = (c1, statistics.median(walls), counts, peak)
        c = {m: r[0] for m, r in runs.items()}
        # the reference's identities between the modes
        for mode in ("wavefront_host", "predicated"):
            a = c[mode].as_dict()
            for k in a:
                if k not in ("wall_time_s", "escalations") \
                        and a[k] != c_wf[k]:
                    raise SystemExit(f"FAIL: {env} {mode}: counter {k} "
                                     f"differs from the card's wavefront: "
                                     f"{a[k]} vs {c_wf[k]}")
        a, b = c["rta_like"].as_dict(), c["staged_noexit"].as_dict()
        for k in a:
            if k not in ("wall_time_s", "shader_invocations", "bytes_moved") \
                    and a[k] != b[k]:
                raise SystemExit(f"FAIL: {env}: rta_like counter {k} differs "
                                 f"from staged_noexit: {a[k]} vs {b[k]}")
        if a["bytes_moved"] != b["bytes_moved"] \
                + BYTES_SHADER_HANDOFF * a["shader_invocations"] \
                or a["shader_invocations"] <= 0:
            raise SystemExit(f"FAIL: {env}: rta_like's shader calls and bytes")
        if b["nodes_traversed"] < c_wf["nodes_traversed"]:
            raise SystemExit(f"FAIL: {env}: staged_noexit visits fewer nodes "
                             f"than wavefront")
        cn = c["naive"]
        closed = dict(nodes_traversed=n_tests, leaf_tests=n_tests,
                      axis_tests_executed=15 * n_tests,
                      axis_tests_decoded=15 * n_tests,
                      bytes_moved=BYTES_UNFUSED_TEST * n_tests, sphere_tests=0,
                      frontier_overflow=0, shader_invocations=0, escalations=0)
        bad = {k: getattr(cn, k) for k, v in closed.items()
               if getattr(cn, k) != v}
        if bad or cn.nodes_per_level or int(cn.exit_histogram.sum()) != n_tests:
            raise SystemExit(f"FAIL: {env} naive: counters {bad} or the exit "
                             f"histogram ({int(cn.exit_histogram.sum())}) "
                             f"break the closed form for {n_tests} pairs")
        # the card against the CPU: each host arm, and naive on a block
        cpu_note = {}
        if env == f11_env:
            for mode in f11_modes[1:]:
                t0 = time.perf_counter()
                vc, cc = CollisionEngine(tree, EngineConfig(mode=mode),
                                         device="cpu").query(obbs)
                t_cpu = time.perf_counter() - t0
                a, b = c[mode].as_dict(), cc.as_dict()
                diff = [k for k in a if k != "wall_time_s" and a[k] != b[k]]
                if diff or not np.array_equal(vc, v_wf):
                    raise SystemExit(f"FAIL: {env} {mode}: card differs from "
                                     f"the CPU engine in {diff or 'verdicts'}")
                cpu_note[mode] = f"cuda == cpu (cpu engine {t_cpu:.1f} s)"
            notes = []
            for lo in (0, Q - block):
                sub = OBBs(obbs.center[lo:lo + block],
                           obbs.half[lo:lo + block], obbs.rot[lo:lo + block])
                cfg = EngineConfig(mode="naive")
                vg, cg = CollisionEngine(tree, cfg, device="cuda").query(sub)
                t0 = time.perf_counter()
                vc, cc = CollisionEngine(tree, cfg, device="cpu").query(sub)
                t_cpu = time.perf_counter() - t0
                a, b = cg.as_dict(), cc.as_dict()
                diff = [k for k in a if k != "wall_time_s" and a[k] != b[k]]
                if diff or not np.array_equal(vg, vc) \
                        or not np.array_equal(vg, v_wf[lo:lo + block]):
                    raise SystemExit(f"FAIL: {env} naive on OBBs {lo}.."
                                     f"{lo + block - 1}: card differs from "
                                     f"the CPU engine in {diff or 'verdicts'}")
                notes.append(f"{lo}..{lo + block - 1} ({t_cpu:.1f} s)")
            add_check_launches()
            cpu_note["naive"] = ("cuda == cpu on OBBs " + ", ".join(notes))
        for mode in f11_modes:
            cm, wall, counts, peak = runs[mode]
            log("22 fig11", f"{env} {mode}: Q={Q} hits={int(v_wf.sum())} "
                f"nodes={cm.nodes_traversed} per level {cm.nodes_per_level} "
                f"frontier_overflow={cm.frontier_overflow} "
                f"axis_tests_executed={cm.axis_tests_executed} "
                f"axis_tests_decoded={cm.axis_tests_decoded} sphere_tests="
                f"{cm.sphere_tests} bytes_moved={cm.bytes_moved} "
                f"shader_invocations={cm.shader_invocations} | main-path "
                f"launches {({k: v for k, v in counts.items() if v})} | "
                f"verdicts == wavefront | {cpu_note.get(mode, '')} | warm "
                f"wall median of 5 {1e3 * wall:.3f} ms (phase 8: {walls8} "
                f"ms) | peak mem {peak / 2**20:.1f} MiB | {card}")
            if cm.frontier_overflow:
                log("22 fig11", f"{env} {mode}: the frontier passed "
                    f"max_frontier ({EngineConfig().max_frontier} pairs): "
                    f"{cm.frontier_overflow} pairs dropped, so this arm's "
                    f"counters are clipped at this scale")
    # the card's busy share in one traced warm query of wavefront_host and
    # of naive, with the device's largest items
    tree_f, obbs_f, _ = scenes[f11_env]
    for mode in ("wavefront_host", "naive"):
        eng = CollisionEngine(tree_f, EngineConfig(mode=mode), device="cuda")
        eng.query(obbs_f)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.query(obbs_f)
            torch.cuda.synchronize()
            t_traced = time.perf_counter() - t0
        on_card = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        d_traced = sum(device_us(e) for e in on_card) / 1e6
        top = sorted(on_card, key=device_us, reverse=True)[:4]
        add_check_launches()
        log("22 fig11", f"{f11_env} {mode}, one traced warm query: wall "
            f"{1e3 * t_traced:.3f} ms, device time {1e3 * d_traced:.3f} ms "
            f"(busy {100 * d_traced / t_traced:.1f} %), "
            f"{sum(e.count for e in on_card)} kernels and copies, largest: "
            + "; ".join(f"{e.key[:48]} {device_us(e) / 1e3:.3f} ms x{e.count}"
                        for e in top) + f" | {card}")
    # sact_dense at the naive arm's block shape: one block of OBBs x leaves
    leaves = tree_f.leaf_aabbs()
    o = sact_ops.pack_obbs(obbs_f.center[:block], obbs_f.half[:block],
                           obbs_f.rot[:block]).to(cuda)
    a = sact_ops.pack_aabbs(leaves.center, leaves.half).to(cuda)
    c_, e = sact_ops.sact_dense(o, a)
    pc, pe = sact_ref(o, a, False)
    err = max(int((c_ != pc).sum() > 0), int((e - pe).abs().max()))
    if err:
        raise SystemExit("FAIL: sact_dense differs from plain at the naive "
                         "block shape")
    ms = cuda_time_ms(lambda: sact_ops.sact_dense(o, a), 20)
    plain_ms = cuda_time_ms(lambda: sact_ref(o, a, False), 3)
    k_ms = kernel_device_ms(lambda: sact_ops.sact_dense(o, a),
                            "sact_dense_kernel", 20, "sact_dense")
    add_check_launches()
    M, N = o.shape[0], a.shape[0]
    hist = torch.bincount(e.reshape(-1), minlength=18).cpu().numpy()
    ops = float(np.dot(hist, exit_code_ops(False)))
    bms, by = bound_ms(M * 60 + N * 24 + M * N * 5, ops)
    sd = next(line for line in lines if line["name"] == "sact_dense")
    sd.update(plane_ms=sd["ms"], plane_kernel_ms=sd["kernel_ms"],
              plane_plain_ms=sd["plain_ms"], plane_bound_ms=sd["bound_ms"],
              max_abs_err=max(sd["max_abs_err"], err), ms=ms, kernel_ms=k_ms,
              plain_ms=plain_ms, bound_ms=bms, bound_by=by, shape=[M, N])
    log("22 fig11", f"sact_dense at the naive block shape ({M} x {N}, "
        f"{f11_env}'s first OBBs x its leaves, {M * N * 5 / 1e6:.1f} MB of "
        f"outputs): kernel == plain, call {ms:.4f} ms, kernel on the card "
        f"{k_ms:.5f} ms (torch.profiler, {k_ms / bms:.2f}x the bound), plain "
        f"on card {plain_ms:.3f} ms, bound {bms:.5f} ms ({by}) | phase "
        f"{lap():.1f} s | {card}")

    # ---- 23. fig_bigscene's scenes at full scale ---------------------------
    # benchmarks/run.py::fig_bigscene at FULL_SCALE: depth 8, two uniform
    # clouds in [-1, 1]^3 from RandomState(5), drawn in its order; 1,500
    # OBBs (trajs x wps).  max_frontier is raised so that no engine clamps
    # (the fused arm's pool holds 2-10 M pairs a level, past the default
    # 2**20): every verdict is then exact and comparable.
    big_cap = 1 << 24
    rs = np.random.RandomState(5)
    big_trees = {}
    for tag, n_pts in (("small", 524288), ("big", 6 * 524288)):
        pts = rs.uniform(-1, 1, (n_pts, 3)).astype(np.float32)
        big_trees[tag] = build_octree(pts, depth=8,
                                      scene_lo=np.full(3, -1.0, np.float32),
                                      scene_size=2.0)
    n_max_of = {tag: max(len(lv.codes) for lv in t.levels)
                for tag, t in big_trees.items()}
    budget = persist_ops.meta_table_bytes(8, n_max_of["small"])
    obbs_b = random_obbs(torch.Generator().manual_seed(11), 1500)
    # the OBBs held card against CPU: all on the small scene (~1 s a
    # hundred on the CPU), one whole tile on the big one (~3 s a tile)
    n_sub_of = {"small": obbs_b.n, "big": 128}
    log("23 bigscene", f"scenes: small levels "
        f"{[len(lv.codes) for lv in big_trees['small'].levels]}, big levels "
        f"{[len(lv.codes) for lv in big_trees['big'].levels]}; "
        f"{obbs_b.n} OBBs (random_obbs, seed 11); budget of the pins "
        f"{budget} B (the small scene's fp32 table); max_frontier "
        f"{big_cap} | {card}")
    P = "wavefront_persistent"
    big_err = 0
    for tag, tree in big_trees.items():
        n_max = n_max_of[tag]
        n_sub = n_sub_of[tag]
        sub_b = OBBs(obbs_b.center[:n_sub], obbs_b.half[:n_sub],
                     obbs_b.rot[:n_sub])
        fused = CollisionEngine(tree, EngineConfig(
            mode="wavefront_fused", max_frontier=big_cap), device="cuda")
        v_f, c_f = fused.query(obbs_b)
        f_walls = [fused.query(obbs_b)[1].wall_time_s for _ in range(5)]
        add_check_launches()
        if c_f.frontier_overflow:
            raise SystemExit(f"FAIL: {tag} scene: wavefront_fused clamped "
                             f"{c_f.frontier_overflow} pairs")
        engines = [("default", dict())]
        engines.append(("fig_bigscene fp32 pin",
                        dict(vmem_budget=budget, meta_format="fp32")))
        for fmt in (("fp32", "bf16") if tag == "big" else ("u8",)):
            engines.append((f"fig_compress {fmt}",
                            dict(vmem_budget=budget, stream_meta=True,
                                 meta_format=fmt)))
        if tag == "big":   # the default's rows, resident: the window count's
            engines.append(("bf16 resident pin",     # cost, timed in turns
                            dict(stream_meta=False, meta_format="bf16")))
        turns = {}
        if tag == "big":
            try:
                CollisionEngine(tree, EngineConfig(
                    mode=P, vmem_budget=budget, stream_meta=True,
                    meta_format="u8"), device="cuda").meta_layout
            except ValueError as e:
                log("23 bigscene", f"big scene, fig_compress u8: ValueError "
                    f"as in the reference ({e})")
            else:
                raise SystemExit("FAIL: u8 rows pinned on the big scene "
                                 "did not raise")
        cpu_done = {}
        for name, kw in engines:
            cfg = EngineConfig(mode=P, max_frontier=big_cap, **kw)
            eng = CollisionEngine(tree, cfg, device="cuda")
            choice = (eng.meta_layout, eng.meta_format)
            want_choice = {
                ("small", "default"): ("resident", "bf16"),
                ("big", "default"): ("streamed", "bf16"),
                ("small", "fig_bigscene fp32 pin"): ("resident", "fp32"),
                ("big", "fig_bigscene fp32 pin"): ("streamed", "fp32"),
                ("big", "bf16 resident pin"): ("resident", "bf16"),
            }.get((tag, name), ("streamed", kw.get("meta_format")))
            if choice != want_choice:
                raise SystemExit(f"FAIL: {tag} scene, {name}: the chooser "
                                 f"picked {choice}, want {want_choice}")
            torch.cuda.synchronize()
            _build.reset_launch_counts()
            v1, c1 = eng.query(obbs_b)
            counts = _build.launch_counts()
            _build.reset_launch_counts()
            for k, n in counts.items():
                main_launches[k] += n
            want = {"persist": 1 + c1.escalations}
            if any(n != want.get(k, 0) for k, n in counts.items()):
                raise SystemExit(f"FAIL: {tag} scene, {name}: launches "
                                 f"{counts}, want {want}")
            if not np.array_equal(v1, v_f):
                raise SystemExit(f"FAIL: {tag} scene, {name}: verdicts "
                                 f"differ from wavefront_fused")
            streamed = choice[0] == "streamed"
            row_bytes = persist_ops.META_FORMAT_BYTES[choice[1]]
            if (c1.meta_rows_streamed > 0) != streamed \
                    or c1.meta_bytes_streamed != c1.meta_rows_streamed \
                    * row_bytes or c1.frontier_overflow:
                raise SystemExit(f"FAIL: {tag} scene, {name}: "
                                 f"{c1.meta_rows_streamed} streamed rows, "
                                 f"{c1.meta_bytes_streamed} bytes, "
                                 f"{c1.frontier_overflow} pairs clamped")
            # the card against the CPU on the subset, once a choice: each
            # engine's first query of that size (escalations included)
            vs, cs = (v1, c1) if n_sub == obbs_b.n else eng.query(sub_b)
            if choice not in cpu_done:
                t0 = time.perf_counter()
                cpu_done[choice] = CollisionEngine(tree, cfg,
                                                   device="cpu").query(sub_b)
                cpu_s = time.perf_counter() - t0
                cpu_note = f"cpu engine {cpu_s:.1f} s"
            else:
                cpu_note = "cpu engine of the same choice above"
            vc, cc = cpu_done[choice]
            a, b = cs.as_dict(), cc.as_dict()
            diff = [k for k in a if k != "wall_time_s" and a[k] != b[k]]
            if diff or not np.array_equal(vs, vc):
                raise SystemExit(f"FAIL: {tag} scene, {name}: card differs "
                                 f"from the CPU engine on the first {n_sub} "
                                 f"OBBs in {diff or 'verdicts'}")
            walls = [eng.query(obbs_b)[1].wall_time_s for _ in range(5)]
            # persist alone at the clean capacity: the call, the kernel,
            # the plain version on the card, the bound
            dev = eng.device_tree
            ins = persist_ops.pack_kernel_inputs(
                obbs_b.center.to(cuda), obbs_b.half.to(cuda),
                obbs_b.rot.to(cuda), dev, persist_ops.DEFAULT_BQ)
            pkw = dict(bq=persist_ops.DEFAULT_BQ, fcap=eng.last_capacity,
                       depth=tree.depth, ring_cap=persist_ops.DEFAULT_RING_CAP,
                       use_spheres=False, meta_format=choice[1],
                       streamed=streamed)
            if name in ("default", "bf16 resident pin"):
                turns[name] = (eng, ins, pkw)
            got = persist_ops.persist_tiles(**ins, **pkw)
            seen = torch.zeros(dev.node_meta.shape[:2], dtype=torch.bool,
                               device=cuda)
            want_p = persist_tiles_ref(**ins, **pkw, seen=seen)
            err = max(int((x.to(torch.int64) - y.to(torch.int64)).abs().max())
                      for x, y in zip(got, want_p))
            big_err = max(big_err, err)
            if err:
                raise SystemExit(f"FAIL: {tag} scene, {name}: persist "
                                 f"differs from plain (max abs err {err})")
            call_ms = cuda_time_ms(
                lambda: persist_ops.persist_tiles(**ins, **pkw), 5)
            plain_ms = cuda_time_ms(lambda: persist_tiles_ref(**ins, **pkw),
                                    1, warmup=0)
            # one launch between two events, five times: a kernel of
            # milliseconds, which the host does not pace
            ev_ms = statistics.median(cuda_time_ms(
                lambda: persist_ops.persist_tiles(**ins, **pkw), 1, warmup=0)
                for _ in range(5))
            k_ms = kernel_device_ms(
                lambda: persist_ops.persist_tiles(**ins, **pkw),
                "persist_kernel", 5, "persist", required=False)
            add_check_launches()
            T = ins["sot"].shape[0]
            L = tree.depth + 1
            nodes = c1.nodes_traversed
            # the distinct rows that the walk tests, each read once; the
            # frontier's pairs are the kernel's own, not inputs or outputs
            rows_read = int(seen.sum())
            in_bytes = (4 * (3 + 3 * L) + 4 * T + 4 + T * 128 * (60 + 8)
                        + rows_read * row_bytes)
            out_bytes = 4 * T * (128 + L + 18 + 8) + 8 * int(
                got[3][:, 6].clamp(max=pkw["ring_cap"]).sum())
            ops = (nodes * (OPS_SETUP + OPS_NODE_BOX)
                   + 7 * c1.axis_tests_executed)
            bms, by = bound_ms(in_bytes + out_bytes, ops)
            # the card's busy share in one traced warm query
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eng.query(obbs_b)
                torch.cuda.synchronize()
                t_traced = time.perf_counter() - t0
            on_card = [e for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA]
            d_traced = sum(device_us(e) for e in on_card) / 1e6
            kept = sum(e.count for e in on_card if "persist_kernel" in e.key)
            busy = (f"busy {100 * d_traced / t_traced:.1f} %" if kept == 1
                    else f"the trace kept {kept} of 1 persist record: busy "
                    f"by events (the kernel alone over the wall) "
                    f"{100 * ev_ms / (1e3 * t_traced):.1f} %")
            add_check_launches()
            log("23 bigscene", f"{tag} scene, {name}: {choice[0]} "
                f"{choice[1]} rows | hits {int(v1.sum())} of {obbs_b.n}, "
                f"verdicts == wavefront_fused | nodes {c1.nodes_traversed} "
                f"per level {c1.nodes_per_level} | escalations "
                f"{c1.escalations}, cap {eng.last_capacity} | main-path "
                f"launches {({k: v for k, v in counts.items() if v})} | "
                f"meta_rows_streamed {c1.meta_rows_streamed}, "
                f"meta_bytes_streamed {c1.meta_bytes_streamed} | cuda == cpu "
                f"on the first {n_sub} OBBs, every counter ({cpu_note}) | "
                f"warm wall median of 5 {1e3 * statistics.median(walls):.3f} "
                f"ms, wavefront_fused {1e3 * statistics.median(f_walls):.3f} "
                f"ms | persist call {call_ms:.4f} ms, the kernel alone "
                f"{ev_ms:.4f} ms (CUDA events around one launch, median of "
                f"5) and " + ("not measured" if k_ms is None else
                              f"{k_ms:.4f} ms") + " (torch.profiler), plain "
                f"on card {plain_ms:.1f} ms; distinct rows tested "
                f"{rows_read} ({rows_read * row_bytes} B) of "
                f"{int(dev.counts.sum())} occupied, {nodes} pairs; bound "
                f"{bms:.5f} ms ({by}), {ev_ms / bms:.0f}x | traced warm "
                f"query: wall {1e3 * t_traced:.3f} ms, {busy} | {card}")
        if tag == "big":
            # the streamed layout's cost on the card, where both layouts
            # read the rows through L2: the same bf16 rows resident and
            # streamed, in turns (r, s, s, r) x 5, the kernel by events
            # around one launch and the warm query's wall
            ev_t = {n: [] for n in turns}
            wall_t = {n: [] for n in turns}
            for _ in range(5):
                for n in ("bf16 resident pin", "default", "default",
                          "bf16 resident pin"):
                    eng_t, ins_t, pkw_t = turns[n]
                    ev_t[n].append(cuda_time_ms(
                        lambda: persist_ops.persist_tiles(**ins_t, **pkw_t),
                        1, warmup=0))
                    wall_t[n].append(eng_t.query(obbs_b)[1].wall_time_s)
            add_check_launches()
            r_ev, s_ev = (statistics.median(ev_t[n])
                          for n in ("bf16 resident pin", "default"))
            r_w, s_w = (1e3 * statistics.median(wall_t[n])
                        for n in ("bf16 resident pin", "default"))
            log("23 bigscene", f"big scene, bf16 rows resident vs streamed "
                f"(the default), in turns x 5: persist kernel (CUDA events, "
                f"median of 10) {r_ev:.4f} vs {s_ev:.4f} ms "
                f"({100 * (s_ev / r_ev - 1):+.1f} %), warm query wall "
                f"{r_w:.3f} vs {s_w:.3f} ms ({100 * (s_w / r_w - 1):+.1f} %) "
                f"| {card}")
    persist_line["max_abs_err"] = max(persist_line["max_abs_err"], big_err)
    log("23 bigscene", f"phase {lap():.1f} s")

    # ---- 24. ragged multi-scene batches ----------------------------------
    # (a) benchmarks/run.py::ragged_scenes at FULL_SCALE: depth 5; three
    # scenes of 32,768 and one of 524,288 uniform points in [-1, 1]^3 from
    # RandomState(0), drawn in its order (the small-only batch, then the
    # mixed one); 100 random_obbs a scene from generators seeded 0..S-1.
    # Each call builds its engine, as the benchmark row's does: its walls
    # include the escalation ladder.
    rs = np.random.RandomState(0)
    M_rag = 100

    def scene_set(sizes):
        trees, sets = [], []
        for i, n_pts in enumerate(sizes):
            pts = rs.uniform(-1, 1, (n_pts, 3)).astype(np.float32)
            trees.append(build_octree(pts, depth=5))
            sets.append(random_obbs(torch.Generator().manual_seed(i), M_rag))
        return trees, OBBs(*(torch.stack([getattr(o, f) for o in sets])
                             for f in ("center", "half", "rot")))

    rag_sets = {"small": scene_set([32768] * 3),
                "mixed": scene_set([32768] * 3 + [524288])}
    rag_arms = {"padded wavefront": EngineConfig(mode="wavefront"),
                "ragged persistent": EngineConfig(mode=P),
                "ragged streamed": EngineConfig(mode=P, stream_meta=True),
                "ragged fused": EngineConfig(mode="wavefront_fused")}
    # the fused mode's ragged walk is the reference's tensor code
    rag_kernels = {"padded wavefront": {"compact"},
                   "ragged persistent": {"persist"},
                   "ragged streamed": {"persist"}, "ragged fused": set()}
    add_check_launches()
    rag_v, rag_walls = {}, {}
    for name, cfg in rag_arms.items():
        for tag, (trees, rob) in rag_sets.items():
            torch.cuda.synchronize()
            _build.reset_launch_counts()
            v1, c1 = query_batched_scenes(trees, rob, cfg, device="cuda")
            counts = _build.launch_counts()
            _build.reset_launch_counts()
            for k, n in counts.items():
                main_launches[k] += n
            if {k for k, n in counts.items() if n} != rag_kernels[name]:
                raise SystemExit(f"FAIL: ragged {name} ({tag}): launches "
                                 f"{counts}")
            t0 = time.perf_counter()
            vc, cc = query_batched_scenes(trees, rob, cfg, device="cpu")
            t_cpu = time.perf_counter() - t0
            a, b = c1.as_dict(), cc.as_dict()
            diff = [k for k in a if k != "wall_time_s" and a[k] != b[k]]
            if diff or not np.array_equal(v1, vc):
                raise SystemExit(f"FAIL: ragged {name} ({tag}): card differs "
                                 f"from the CPU engine in "
                                 f"{diff or 'verdicts'}")
            S_r = len(trees)
            if v1.shape != (S_r, M_rag) or v1.dtype != bool:
                raise SystemExit(f"FAIL: ragged {name} ({tag}): verdicts "
                                 f"{v1.shape} {v1.dtype}")
            first = rag_v.setdefault(tag, v1)
            if not np.array_equal(v1, first):
                raise SystemExit(f"FAIL: ragged {name} ({tag}): verdicts "
                                 f"differ from padded wavefront's")
            if (c1.meta_rows_streamed > 0) != (name == "ragged streamed"):
                raise SystemExit(f"FAIL: ragged {name} ({tag}): "
                                 f"{c1.meta_rows_streamed} streamed rows")
            walls = [query_batched_scenes(trees, rob, cfg,
                                          device="cuda")[1].wall_time_s
                     for _ in range(10)]
            add_check_launches()
            rag_walls[(name, tag)] = statistics.median(walls)
            eng_r = CollisionEngine(trees, cfg, device="cuda")
            log("24 ragged", f"(a) {name}, {tag} batch ({S_r} scenes of "
                f"{M_rag} OBBs; rows {eng_r.meta_layout} "
                f"{eng_r.meta_format}): hits {int(v1.sum())}, nodes "
                f"{c1.nodes_traversed} per level {c1.nodes_per_level}, "
                f"escalations {c1.escalations}, meta_rows_streamed "
                f"{c1.meta_rows_streamed} | main-path launches "
                f"{({k: n for k, n in counts.items() if n})} | cuda == cpu "
                f"verdicts + counters (cpu {t_cpu:.1f} s) | warm wall "
                f"median of 10 {1e3 * rag_walls[(name, tag)]:.3f} ms | "
                f"{card}")
    for name in rag_arms:
        t_s, t_m = rag_walls[(name, "small")], rag_walls[(name, "mixed")]
        log("24 ragged", f"(a) ragged/{name}: mixed {1e3 * t_m:.3f} ms, "
            f"small_batch {1e3 * t_s:.3f} ms, big_scene_cost "
            f"{t_m / t_s:.2f}x | {card}")

    # (b) the Table III scenes of phase 5, each with phase 8's OBBs, as one
    # ragged batch
    envs = list(scenes)
    ragged_err = 0
    if len(envs) < 2:
        log("24 ragged", "(b) needs two or more --envs: skipped")
    else:
        trees_b = [scenes[e][0] for e in envs]
        obbs_b4 = OBBs(*(torch.stack([getattr(scenes[e][1], f)
                                      for e in envs])
                         for f in ("center", "half", "rot")))
        M_b = obbs_b4.center.shape[1]
        plan_b = plan_scenes(obbs_b4)
        n_cpu = min(1500, M_b)
        plan_sub = plan_scenes(OBBs(obbs_b4.center[:, :n_cpu],
                                    obbs_b4.half[:, :n_cpu],
                                    obbs_b4.rot[:, :n_cpu]))
        single = [p8[e]["wavefront_persistent"] for e in envs]
        want_work = {k: sum(s[1][k] for s in single) for k in (
            "nodes_traversed", "leaf_tests", "axis_tests_executed",
            "axis_tests_decoded", "sphere_tests")}
        n_lv = max(len(s[1]["nodes_per_level"]) for s in single)
        want_work["nodes_per_level"] = [
            sum(s[1]["nodes_per_level"][i] for s in single
                if i < len(s[1]["nodes_per_level"])) for i in range(n_lv)]
        want_work["exit_histogram"] = [
            sum(col) for col in zip(*(s[1]["exit_histogram"]
                                      for s in single))]
        sum_walls = sum(s[2] for s in single)
        arms_b = [("persistent", EngineConfig(mode=P)),
                  ("persistent streamed", EngineConfig(mode=P,
                                                       stream_meta=True)),
                  ("fused", EngineConfig(mode="wavefront_fused")),
                  ("padded wavefront", EngineConfig(mode="wavefront"))]
        for name, cfg in arms_b:
            eng = CollisionEngine(trees_b, cfg, device="cuda")
            choice = (eng.meta_layout, eng.meta_format)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launch_counts()
            v1, c1 = eng.execute(plan_b)
            counts = _build.launch_counts()
            _build.reset_launch_counts()
            peak = torch.cuda.max_memory_allocated()
            for k, n in counts.items():
                main_launches[k] += n
            kern = {"persistent": {"persist"},
                    "persistent streamed": {"persist"}, "fused": set(),
                    "padded wavefront": {"compact"}}[name]
            if {k for k, n in counts.items() if n} != kern:
                raise SystemExit(f"FAIL: (b) {name}: launches {counts}")
            for i, e in enumerate(envs):
                if not np.array_equal(v1[i], p8[e]["wavefront_persistent"][0]):
                    raise SystemExit(f"FAIL: (b) {name}: {e}'s verdicts "
                                     f"differ from phase 8's persistent")
            a = c1.as_dict()
            diff = {k: (a[k], w) for k, w in want_work.items() if a[k] != w}
            if diff or c1.frontier_overflow:
                raise SystemExit(f"FAIL: (b) {name}: work counters differ "
                                 f"from the sum of phase 8's runs: {diff}, "
                                 f"overflow {c1.frontier_overflow}")
            if (c1.meta_rows_streamed > 0) != (choice[0] == "streamed"):
                raise SystemExit(f"FAIL: (b) {name}: "
                                 f"{c1.meta_rows_streamed} streamed rows")
            cpu_note = ""
            if name == "persistent":
                vs, cs = CollisionEngine(trees_b, cfg,
                                         device="cuda").execute(plan_sub)
                t0 = time.perf_counter()
                vc, cc = CollisionEngine(trees_b, cfg,
                                         device="cpu").execute(plan_sub)
                t_cpu = time.perf_counter() - t0
                a_s, b_s = cs.as_dict(), cc.as_dict()
                diff = [k for k in a_s
                        if k != "wall_time_s" and a_s[k] != b_s[k]]
                if diff or not np.array_equal(vs, vc):
                    raise SystemExit(f"FAIL: (b) persistent: card differs "
                                     f"from the CPU engine on the first "
                                     f"{n_cpu} OBBs a scene in "
                                     f"{diff or 'verdicts'}")
                cpu_note = (f" | cuda == cpu on the first {n_cpu} OBBs of "
                            f"each scene, verdicts and every counter (cpu "
                            f"engine {t_cpu:.1f} s)")
            walls = [eng.execute(plan_b)[1].wall_time_s for _ in range(10)]
            add_check_launches()
            kernel_note = ""
            if name in ("persistent", "persistent streamed"):
                # the persist launch of a warm query, replayed
                with Recorder({"persist": (persist_ops,
                                           "persist_tiles")}) as rec:
                    eng.execute(plan_b)
                (fn, ca, ck), = rec.calls["persist"]
                sot = ck["sot"]
                T, bq_b = sot.shape[0], ck["bq"]
                if int((sot != 0).sum()) == 0 or len(sot.unique()) != \
                        len(envs):
                    raise SystemExit(f"FAIL: (b) {name}: tiles' scenes "
                                     f"{sot.unique().tolist()}")
                got = fn(*ca, **ck)
                seen = torch.zeros(ck["meta"].shape[:2], dtype=torch.bool,
                                   device=cuda)
                want_p = persist_tiles_ref(*ca, **ck, seen=seen)
                err = max(int((x.to(torch.int64) - y.to(torch.int64))
                              .abs().max()) for x, y in zip(got, want_p))
                ragged_err = max(ragged_err, err)
                if err:
                    raise SystemExit(f"FAIL: (b) {name}: persist differs "
                                     f"from plain (max abs err {err})")
                call_ms = cuda_time_ms(lambda: fn(*ca, **ck), 20)
                ev_ms = statistics.median(cuda_time_ms(
                    lambda: fn(*ca, **ck), 1, warmup=0) for _ in range(5))
                k_ms = kernel_device_ms(lambda: fn(*ca, **ck),
                                        "persist_kernel", 10, "persist",
                                        required=False)
                plain_ms = cuda_time_ms(lambda: persist_tiles_ref(*ca, **ck),
                                        1, warmup=0)
                nwin = (-(-ck["meta"].shape[1] // persist_ops.sub_window_rows(
                    ck["meta"].shape[1])) if ck["streamed"] else 0)
                shape = persist_ops.kernel_shape(bq_b, ck["meta_format"],
                                                 nwin)
                # the host's share of a warm query: the tile map and the
                # rows permuted into slot space, once a query
                pob = [x.to(cuda) for x in (plan_b.obb_c, plan_b.obb_h,
                                            plan_b.obb_r)]
                tp_s = []
                for _ in range(5):
                    t0 = time.perf_counter()
                    persist_ops.tile_pool(*pob, scene_of_query=(
                        plan_b.scene_of_query))
                    torch.cuda.synchronize()
                    tp_s.append(time.perf_counter() - t0)
                add_check_launches()
                L = trees_b[0].depth + 1
                row_bytes = persist_ops.META_FORMAT_BYTES[ck["meta_format"]]
                # the distinct rows that the walk tests, each read once;
                # the frontier's pairs are the kernel's own
                rows_read = int(seen.sum())
                in_bytes = (4 * len(envs) * (3 + 3 * L) + 4 * T + 4
                            + T * bq_b * (60 + 4 + 4) + rows_read * row_bytes)
                out_bytes = 4 * T * (bq_b + L + 18 + 8) + 8 * int(
                    got[3][:, 6].clamp(max=ck["ring_cap"]).sum())
                ops = (c1.nodes_traversed * (OPS_SETUP + OPS_NODE_BOX)
                       + 7 * c1.axis_tests_executed)
                bms, by = bound_ms(in_bytes + out_bytes, ops)
                # the card's busy share in one traced warm query
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    eng.execute(plan_b)
                    torch.cuda.synchronize()
                    t_traced = time.perf_counter() - t0
                on_card = [e for e in prof.key_averages()
                           if e.device_type == DeviceType.CUDA]
                d_traced = sum(device_us(e) for e in on_card) / 1e6
                kept = sum(e.count for e in on_card
                           if "persist_kernel" in e.key)
                busy = (f"busy {100 * d_traced / t_traced:.1f} %"
                        if kept == 1 else
                        f"the trace kept {kept} of 1 persist record: busy "
                        f"by events (the kernel alone over the wall) "
                        f"{100 * ev_ms / (1e3 * t_traced):.1f} %")
                add_check_launches()
                kernel_note = (
                    f" | persist: {T} scene-exclusive tiles of {bq_b} slots "
                    f"(tiles a scene {torch.bincount(sot).tolist()}), fcap "
                    f"{ck['fcap']}, kernel == plain; call {call_ms:.4f} ms, "
                    f"the kernel alone {ev_ms:.4f} ms (CUDA events around "
                    f"one launch, median of 5) and "
                    + ("not measured" if k_ms is None else f"{k_ms:.4f} ms")
                    + f" (torch.profiler), plain on card {plain_ms:.1f} ms; "
                    f"distinct rows tested {rows_read} "
                    f"({rows_read * row_bytes} B); bound {bms:.5f} ms "
                    f"({by}), {ev_ms / bms:.0f}x; shape {shape} | "
                    f"tile_pool (host) {1e3 * statistics.median(tp_s):.3f} "
                    f"ms a query, median of 5 | traced "
                    f"warm query: wall {1e3 * t_traced:.3f} ms, {busy}")
            log("24 ragged", f"(b) {len(envs)} Table III scenes "
                f"({', '.join(envs)}) x {M_b} OBBs, {name}: rows "
                f"{choice[0]} {choice[1]} | hits {int(v1.sum())}, verdicts "
                f"== phase 8's per scene | nodes {c1.nodes_traversed} per "
                f"level {c1.nodes_per_level} == the sum of phase 8's runs, "
                f"as every work counter | escalations {c1.escalations}, cap "
                f"{eng.last_capacity}, meta_rows_streamed "
                f"{c1.meta_rows_streamed} | main-path launches "
                f"{({k: n for k, n in counts.items() if n})}{cpu_note} | "
                f"warm wall median of 10 "
                f"{1e3 * statistics.median(walls):.3f} ms, the {len(envs)} "
                f"single-scene persistent walls of phase 8 sum to "
                f"{1e3 * sum_walls:.3f} ms{kernel_note} | peak mem "
                f"{peak / 2**20:.1f} MiB | {card}")
    persist_line["max_abs_err"] = max(persist_line["max_abs_err"],
                                      ragged_err)
    log("24 ragged", f"phase {lap():.1f} s")

    # ---- 25. the other workloads (MCL, the ball query's tree forms, the
    # MPAccel scenes) ---------------------------------------------------------
    lines.append(other_workloads(cuda, card, main_launches,
                                 add_check_launches, lap))

    # ---- 26. the collision service ------------------------------------------
    svc_modes = ("wavefront_persistent", "wavefront_fused")
    if "cubby" in scenes:
        svc_tree, svc_obbs, _ = scenes["cubby"]
        svc_runs = {m: p8["cubby"][m] for m in svc_modes}
    else:
        # phase 21 built the cubby scene; phase 8's runs on it, here
        svc_tree = ctree
        svc_obbs = scene_trajectories(csc, num_trajectories=25, waypoints=60)
        svc_runs = {}
        for m in svc_modes:
            eng = CollisionEngine(svc_tree, EngineConfig(mode=m),
                                  device="cuda")
            v1, c1 = eng.query(svc_obbs)
            walls = [eng.query(svc_obbs)[1].wall_time_s for _ in range(10)]
            svc_runs[m] = (v1, c1.as_dict(), statistics.median(walls))
        add_check_launches()
    svc_err = service_phase(cuda, card, main_launches, add_check_launches,
                            lap, svc_tree, svc_obbs, svc_runs)
    persist_line["max_abs_err"] = max(persist_line["max_abs_err"], svc_err)

    # ---- 27. result -------------------------------------------------------
    # launches on every main path (phases 8, 13, 17, 20, 21, 22, 23, 24, 25
    # and 26) and in the checks
    log("27 result", f"whole script {time.perf_counter() - t_start:.1f} s")
    for line in lines:
        line["launches"] = main_launches[line["name"]]
        line["check_launches"] = check_launches[line["name"]]
    print(json.dumps({"kernels": lines}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": n_dev}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
