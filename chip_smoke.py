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
   serve's busy share (the card's activity traced), the kernel's time per
   launch against its bound, its plain version and
   ``scaled_dot_product_attention`` (the yardstick, never used by the
   port), its achieved TFLOP/s, share of the bound and ratio to the
   yardstick, and the prefill/decode consistency of the
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
   swapped in), on Fig. 19's grid, a 70 x 130 grid without walls and a
   600 x 600 corridor grid (past the kernel's shared-memory copy), on
   every ray case of ``kernels/march/cases.py`` (Fig. 19's 4,608 scan
   rays, rays grazing cell corners and edges along the axes and
   diagonals, rays leaving the grid, one ray, 997 rays, rays whose first
   hit falls on every step 0..63), from fresh rays and from the state a
   16-step chunk leaves, at 1, 7, 16, 33 and every step of a 6 m cast;
   (b) ``benchmarks/run.py::fig19_mcl``: the corridor
   grid of 192 cells, 24 scan angles, true pose (5, 5, 0.4), 192
   particles, 8 iterations, sigma 0.5, under the ``dense``, ``compacted``
   and ``dynamic`` (threshold 60) policies, each iteration's engine,
   cells per ray, ``time_s`` and launches, the mean ``time_s`` and the
   mean pose error, one compacted ``mcl_update`` card against CPU (the
   CPU on the card's directions; ranges and cells equal, weights within
   rtol 1e-5, resampling indices equal away from the cumulative
   weights), the dense and compacted casts against each other, and
   ``march`` timed at the scan's shape and at the compacted cast's
   first chunk (the call, the kernel alone) against its plain version
   and bound; (c) the filter with its
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
27. training on the card (``train_phase``): (a) the WKV6 backward kernel
   (``wkv6_bwd.cu``) against ``wkv6_bwd_ref`` on ``kernels/wkv6/cases.py::
   bwd_cases`` (T 33 and 256, D 64, three decay regimes, with and without
   the final state's gradient, fp32 and bf16), bit for bit on a second
   run, and at RWKV-6's training shape (B 8, H 32, T 1024, D 64, bf16
   views) against autograd through ``wkv6_chunked_ref``, timed (the call,
   the four kernels alone; the call at a training microbatch, B 2) against
   its bound (bytes, or the chunked backward's operations, as phase 17's;
   the step form's printed beside it); (b)
   ``launch/train_planner.py``'s default (cubby, 65,536 points, depth 6,
   ``wavefront_fused``, 6 expert episodes, 60 steps of B 32 on a
   1,024-point cloud, FPS) with step 1 card against CPU (loss and every
   gradient within ``PLANNER_GRAD_TOL``), the loss falling below 0.8x, the
   8 gated plans against the CPU engine on the card's FK arrays, and
   ``--full`` (widen 10, 24 episodes, 300 steps) the same way: step walls,
   a traced step's busy share, peak memory, success and caught counts; (c)
   RWKV-6 1.6B at full width and depth, bf16, B 8 x S 1024 in 4
   microbatches, 5 steps through ``lm/train.py`` (launches: 2 ``wkv6`` and
   1 ``wkv6_bwd`` a layer a microbatch a step), a checkpoint at step 2
   restored into a fresh model and optimizer that runs steps 3-4 to the
   uninterrupted run's bits, step walls, busy share and peak memory; (d)
   its 2-layer fp32 cut card against CPU: loss, every gradient and two
   AdamW steps within ``LM_TRAIN_TOL``;
28. dense-transformer training on the card (``dense_train_phase``): (a)
   the flash-attention backward kernel (``flash_attn_bwd.cu``) against
   ``flash_attention_bwd_ref`` on ``kernels/flash_attention/cases.py::
   bwd_cases`` (d 16-128, groups of 1, 3, 9 and 16, causal and not, Tq !=
   Tk, Tk no multiple of a key tile, both layouts, x8 scores in fp32; fp32
   and bf16) within ``cases.BWD_TOL``, the forward's lse against
   ``attention_lse_ref``'s, bit for bit on a second call, and at GLM-4
   9B's training microbatch (q (2, 32, 4096, 128), k and v (2, 2, 4096,
   128), causal, bf16 views of (B, T, H, d)) against the fp32 plain
   version, timed (the call, the four kernels alone by ``torch.profiler``)
   against its bound, plain version and ``scaled_dot_product_attention``'s
   backward, with the forward timed with and without its lse; (b) GLM-4
   9B at full width cut to 8 of its 40 layers (its full depth's weights,
   gradients and moments do not fit one card), bf16, B 8 x S 4096 in 4
   microbatches, 5 steps through ``lm/train.py`` (launches: 2
   ``flash_attention`` and 1 ``flash_attention_bwd`` a layer a microbatch
   a step, nothing else), finite losses and gradient norms, step walls,
   tokens/s, a traced step's busy share, peak memory under the card's;
   (c) the 2-layer fp32 cuts of GLM-4 (group 16) and StarCoder2 (group 9)
   at full width card against CPU (``flash_fp32`` and the fp32 backward):
   loss, every gradient and two AdamW steps within ``LM_TRAIN_TOL``; (d)
   StarCoder2 7B at full width through phases 19 and 20's functions
   (``dense_cut_vs_cpu``, ``dense_serve``): its 2-layer fp32 cut card
   against CPU, the bf16 serve on 8 of its 32 layers (a
   ``flash_attention`` a layer a prefill; GLM-4 serves the family at full
   depth), the kernel on the captured prefill inputs, walls and
   consistency;
29. the ``moe`` and ``vlm`` families (``moe_vlm_phase``): (a) Granite-MoE
   1B at full width cut to 2 layers, fp32, card against CPU through
   ``dense_cut_vs_cpu`` (logits and caches within ``LM_FP32_TOL``; every
   layer's routes, expert ids, buffer positions and kept flags, exactly,
   a near tie of the k-th and (k+1)-th probabilities said so and its rows
   set apart; the share of pairs dropped); (b) its full 24-layer bf16
   serve through ``dense_serve`` (the prefill's drop share, the prefill's
   ``flash_attention`` at d 64, group 2, against its plain version, bound
   and SDPA, the consistency at capacity factor 8 on the same weights);
   (c) the flash backward at its training microbatch (q (2, 16, 4096,
   64)), then Granite trained at full width and depth through
   ``lm/train.py`` (B 8 x S 4096, 4 microbatches, 5 steps: losses, the
   balance term, walls, busy share, peak memory) and its 2-layer fp32
   cut's step card against CPU; (d) Pixtral 12B: its 2-layer fp32 cut
   card against CPU and its full 40-layer bf16 serve, each prompt after
   256 patch embeddings drawn from a seed (prefill Tq 1,280, group 4, 32
   heads of 128 on d 5,120; decode at ``256 + S + i``); (e) Pixtral
   trained at full width cut to ``MOE_VLM["pixtral_layers"]`` of its 40
   layers;
30. the ``encdec`` family, Whisper-medium (``encdec_phase``): (a) at full
   width cut to 2 encoder and 2 decoder layers, fp32, card against CPU
   through ``dense_cut_vs_cpu`` (B 2, a 64-token prompt against 100
   frames, 4 teacher-forced steps: logits, ``kv``, ``xk`` and ``xv``
   within ``LM_FP32_TOL``); (b) its full 24 + 24-layer bf16 serve through
   ``dense_serve``: 8 segments of 1,500 frames drawn from a seed, each
   decoder prompt Whisper's 4-token start-of-transcript sequence, 32
   greedy tokens; 72 ``flash_attention`` launches a prefill (the
   encoder's non-causal 1,500 x 1,500, the decoder's causal 4 x 4, the
   cross-attention's 4 x 1,500), none in decode, each against its plain
   version, each shape timed against its bound, plain version and SDPA
   (non-causal where the kernel is); walls, busy shares, peak memory and
   the consistency; (c) the flash backward at the training microbatch's
   shapes (q, k, v (2, 16, 1500, 64), non-causal and causal) against its
   bound and SDPA's backward, Whisper trained at full width and depth
   through ``lm/train.py`` (B 8 x S 1,500 in 4 microbatches, 5 steps;
   losses that fall) and its 2-layer fp32 cut's step card against CPU;
31. the ``hybrid`` family, Hymba 1.5B (``hybrid_phase``): (a) ``ssm_scan``
   against its plain version on ``ssm_scan/cases.py`` (the final state
   bit for bit, y within its ``TOL``), timed at B 8 x S 1,024 and B 1 x S
   10,000; (b) the flash forward with a sliding window against its plain
   version on ``window_cases`` (a window >= Tk bit for bit with none),
   timed at the 10,000-token prefill with and without the 4,096 window
   beside SDPA with the window's mask; (c) the 2-layer fp32 cut card
   against CPU on a 4,200-token prompt (past the window: the ring's roll
   and the mask act; logits, ``kv`` and ``ssm``); (d) the full 32-layer
   bf16 serve through ``dense_serve`` (32 ``flash_attention`` and 32
   ``ssm_scan`` a prefill, none in decode, each against its plain
   version); (e) a long-context serve, B 1 x 10,000 tokens and 32 greedy
   tokens past it: walls, peak memory and the consistency;
32. one JSON line listing every kernel with its launches on the main paths
   (``launches``, phases 8, 13, 17, 20, 21, 22, 23, 24, 25, 26, 27, 28,
   29, 30 and 31) and elsewhere (``check_launches``), error, times (for ``persist``,
   ``sact_dense``, ``fps``, ``ballquery``, ``wkv6_bwd`` and
   ``flash_attention_bwd`` also ``kernel_ms``, the kernel alone by
   ``torch.profiler``; ``sact_dense``'s at ``naive``'s block shape, with
   phase 10's plane as ``plane_*``; for ``ballquery`` also
   ``single_plan``, the single plan's three layers; ``flash_attention``'s
   and ``flash_attention_bwd``'s ``shape``, and phases 29-31's shapes
   under ``shapes``; ``ssm_scan``'s at the serve's prefill, its two timed
   shapes under ``shapes``) and bound; the last line is
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
from typing import Optional, Sequence

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, non-tensor fp32, and
# dense bf16 and TF32 on the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
PEAK_BF16_PER_S = 989e12
PEAK_TF32_PER_S = 495e12
# The special-function units' rate (ex2 and the like): 16 results a clock an
# SM at compute capability 9.0 (CUDA C++ Programming Guide, throughput of
# the arithmetic instructions), 132 SMs at the SXM part's 1.98 GHz boost.
PEAK_SFU_PER_S = 132 * 16 * 1.98e9
# A profiled window (kernel_device_ms) opens with this many kernels that it
# does not count, and leaves this much idle time on either side of its calls.
PROFILER_LEAD_IN = 16
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
# The attention models' warm walls (dense_serve): the median of this many
# serves; the busy shares (traced_serves): a warm prefill, then a serve of
# this many tokens, both traced.  Kept small for the script's time limit:
# the serves' repetitions and traces took ~220 s of it at 10 serves and 32
# traced tokens.
LM_WARM_SERVES = 5
LM_TRACED_TOKENS = 9
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
                     tries: int = 6, required: bool = True):
    """The mean device time of a kernel whose name holds ``key``, over a
    window of ``reps`` calls of ``fn`` (``torch.profiler``), which must
    launch kernel ``name`` once a call (the wrappers' counters) and leave
    exactly one record a call.  Late in this script the profiler drops
    the first kernel record of a window (the card showed 19 records after
    20 launches, the first one missing; up to 8 missing, or a whole window,
    on some machines), so each window opens with fills of a scratch word,
    which match no kernel's key, and idle time on either side of the
    calls.  A window that still lost a record is reported and taken again,
    up to ``tries`` windows; none is averaged.
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
    from repro_torch.kernels.march.cases import (CHUNK_STEPS,
                                                 FIG19_GRID_SEED,
                                                 LARGE_GRID_SIZE,
                                                 STEP_COUNTS,
                                                 nonsquare_grid, ray_cases,
                                                 start_states, wall_points)
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
                 occ=torch.from_numpy(nonsquare_grid()).to(dev), cell=0.05),
             "large": tmcl.make_corridor_world(
                 FIG19_GRID_SEED, size=LARGE_GRID_SIZE, device=dev)}
    add_check_launches()
    mism = compared = 0
    march_err = 0.0
    for gname, grid in grids.items():
        steps = int(np.ceil(R_MAX / grid.cell)) + 1
        for case, (org, ang) in ray_cases(grid.shape, grid.cell).items():
            dirv = tmcl.ray_directions(torch.from_numpy(ang).to(dev))
            for st0 in start_states(grid.occ, grid.origin, grid.cell, org,
                                    dirv, R_MAX).values():
                for n in STEP_COUNTS + (steps,):
                    runs = []
                    for fn in (march_ops.march, march_ref):
                        st = tuple(x.clone() for x in st0)
                        fn(grid.occ, grid.origin, grid.cell, st[0], dirv,
                           st[1], st[2], R_MAX, n)
                        runs.append(st)
                    sync()
                    compared += 1
                    for got, want in zip(runs[0], runs[1]):
                        if not torch.equal(got, want):
                            mism += 1
                            march_err = max(march_err, float(
                                (got.double() - want.double()).abs().max()))
        if gname == "large":
            continue
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
        f"{compared} comparisons on the Fig. 19 grid ({S['grid']}^2), a "
        f"70 x 130 grid without walls and a {LARGE_GRID_SIZE}^2 corridor "
        f"grid (read through L1); scan (4,608 rays), grazing (1,152: cell "
        f"corners and edges at 0, +-pi/4, +-pi/2, +-3pi/4, pi), leaving "
        f"(48), one, 997 and first-hit rays (390: first hits on every step "
        f"0..63); from fresh rays and from a {CHUNK_STEPS}-step chunk's "
        f"state; "
        f"{', '.join(map(str, STEP_COUNTS))} and every step of a {R_MAX} m "
        f"cast")
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

    # march timed at Fig. 19's shape: a dense cast of the scan rays and the
    # compacted cast's first chunk, each launch on a fresh copy of the
    # rays' state
    dirv = tmcl.ray_directions(An).contiguous()
    n_steps = int(np.ceil(R_MAX / grid.cell)) + 1

    def march_times(n):
        fresh = [(O.clone(), torch.zeros(len(ang), device=dev),
                  torch.ones(len(ang), dtype=torch.bool, device=dev))
                 for _ in range(S["march_reps"] * 3 + 40)]
        it_fresh = iter(fresh)

        def one(fn=march_ops.march):
            pos, dist, active = next(it_fresh)
            fn(grid.occ, grid.origin, grid.cell, pos, dirv, dist, active,
               R_MAX, n)
        if dev.type != "cuda":
            return fresh[0], float("nan"), float("nan"), float("nan")
        return (fresh[0], cuda_time_ms(one, S["march_reps"]),
                kernel_device_ms(one, "march_kernel", 10, "march",
                                 required=False),
                cuda_time_ms(lambda: one(march_ref), 2))
    marched, ms, k_ms, plain_ms = march_times(n_steps)
    _, chunk_ms, chunk_k_ms, _ = march_times(16)
    live_steps = int(torch.round(marched[1] / grid.cell).sum())
    H, W = grid.shape
    bms, by = bound_ms(H * W + BYTES_MARCH_RAY * len(ang),
                       OPS_MARCH_STEP * live_steps)
    add_check_launches()

    def kms(x):
        return "not measured" if x is None else f"{x:.4f} ms"
    log("25 other", f"(b) march at Fig. 19's shape ({len(ang)} rays, "
        f"{n_steps} steps, {live_steps} live ray-steps, the longest ray "
        f"{int(torch.round(marched[1].max() / grid.cell))}): call "
        f"{ms:.4f} ms, the kernel alone {kms(k_ms)} (torch.profiler), "
        f"plain {plain_ms:.3f} ms, bound {bms:.6f} ms ({by}); the compacted "
        f"cast's first chunk (16 steps): call {chunk_ms:.4f} ms, the kernel "
        f"alone {kms(chunk_k_ms)} | {card}")
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
    # a loss that fires in a call already stalled (stall_s past
    # launch_timeout_s) surfaces after its batch failed as LaunchStalled;
    # every other loss must fail its batch with DeviceLost
    lost = rep["injected"]["device_loss"]
    after_stall = rep["injected"]["device_loss_after_stall"]
    n_lost = rep["failures"].get("DeviceLost", 0)
    n_stalled = rep["failures"].get("LaunchStalled", 0)
    if lost > after_stall and not n_lost:
        raise SystemExit("FAIL: 26 chaos: a device loss at one shard did "
                         "not fail its batch with DeviceLost")
    if n_stalled < after_stall:
        raise SystemExit(f"FAIL: 26 chaos: {after_stall} device loss(es) "
                         f"in stalled calls but {n_stalled} LaunchStalled "
                         f"failures")
    log("26 service", f"(c) chaos: {lost} device loss(es) drawn, "
        f"{after_stall} of them in a call already stalled; {n_lost} "
        f"DeviceLost and {n_stalled} LaunchStalled request failures")
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


#: Phase 27's sizes: the WKV6 backward at RWKV-6's training shape, the
#: planner trainer's two widths (``launch/train_planner.py``'s default and
#: ``--full``), RWKV-6 1.6B at full width and depth, and its 2-layer fp32
#: cut card against CPU.
TRAIN = dict(
    bwd_shape=(8, 32, 1024, 64), bwd_reps=10,
    scene_points=65536, depth=6, planner_steps=60, full_steps=300,
    lm_batch=8, lm_seq=1024, lm_steps=5, lm_ckpt_every=3,
    cut_layers=2, cut_batch=2, cut_seq=256, cut_opt_steps=2)
#: The planner's step on the card against the CPU (PERF.md's planner
#: tolerance): fp32 products summed in another order, TF32 off.
PLANNER_GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
#: The 2-layer fp32 RWKV-6 cut, card against CPU: loss, gradients and
#: parameters after the optimizer steps (the forward's ``LM_FP32_TOL``).
LM_TRAIN_TOL = dict(rtol=1e-4, atol=1e-4)
# fp32 operations of the WKV6 backward's step-by-step recurrence a row and
# step, printed beside its bound for the record: S's update (3 D^2), dr (2
# D^2), dk, dv and rowsum(G (.) S) (2 D^2 each), G's update (3 D^2); the
# bonus terms and w = exp(logw), ~12 D.
OPS_WKV6_BWD_D2, OPS_WKV6_BWD_D = 14, 12


def wkv6_bwd_bound(rows: int, T: int, D: int, nbytes: float):
    """The WKV6 backward's bound, counted as the forward's: the larger of its
    bytes' time and the chunked form's operations (chunks of L = 32 steps,
    8-step sub-blocks, per row and chunk).  Tensor products, each three times
    for the 3xTF32 split: the chunk's boundary state recomputed (2 L D^2), dO
    S^T, r~^T dO (into dS), v dS^T and k~ dS (2 L D^2 each); A = r~ k~^T, dA k~
    and dA^T r~ on the off-diagonal sub-blocks ((L^2 - 8 L) D each); dA = dO
    v^T and A^T dO with the bonus on the diagonal (L (L + 1) D each).
    Elementwise fp32: the cumsum (L D), the decayed r and k (3 L D each), the
    bonus terms of dr, dk, dv and du (10 L D), the rescaling of dr~ and dk~ (2
    L D), dlogw's products and reverse cumsum (4 L D), the diagonal sub-blocks
    of A, dr and dk (5 a term of 28 pairs a sub-block each), the decays of S
    and dS and dlogw's state term (4 D^2).
    Returns (bound_ms, bound_by)."""
    L_c, chunks = 32, rows * -(-T // 32)
    tensor = 3 * chunks * (10 * L_c * D * D + 3 * (L_c * L_c - 8 * L_c) * D
                           + 2 * L_c * (L_c + 1) * D)
    elem = chunks * (L_c * D * (1 + 6 + 10 + 2 + 4)
                     + 3 * (L_c // 8) * 28 * 5 * D + 4 * D * D)
    t_ops = max(tensor / PEAK_TF32_PER_S, elem / PEAK_FP32_PER_S)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def traced_busy(fn, on_card: bool):
    """(traced wall s, device s, the largest device kernels and host
    operations) of one ``fn()`` under the profiler; a run off the card
    gives (1, 0, "")."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if not on_card:
        return 1.0, 0.0, ""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = prof.key_averages()
    on_dev = [e for e in ev if e.device_type == DeviceType.CUDA]
    dev_s = sum(device_us(e) for e in on_dev) / 1e6
    host = [e for e in ev if e.device_type != DeviceType.CUDA]
    top = ("card: " + "; ".join(
        f"{e.key[:40]} {device_us(e) / 1e3:.1f} ms x{e.count}"
        for e in sorted(on_dev, key=device_us, reverse=True)[:4])
        + " | host, self: " + "; ".join(
        f"{e.key[:32]} {e.self_cpu_time_total / 1e3:.1f} ms x{e.count}"
        for e in sorted(host, key=lambda e: e.self_cpu_time_total,
                        reverse=True)[:5]))
    return wall, dev_s, top


def traced_serves(serve_n, host: bool = False) -> list:
    """A warm prefill alone (``serve_n(1)``), then a warm serve of
    ``LM_TRACED_TOKENS`` tokens, each under the profiler: for each, (traced wall
    s, device s, device records, the device's key averages); decode's
    busy share is the difference of the two.  The LM serves record the
    card's activity alone: the host's operator records (~100k a serve)
    cost ~100 s a serve to gather and lengthen the traced wall.
    ``host=True`` records them too (``tools/serve_trace_modes.py`` sets
    the two readings side by side)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = ([ProfilerActivity.CPU] if host else []) + [ProfilerActivity.CUDA]
    traced = []
    for n_tok in (1, LM_TRACED_TOKENS):
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            serve_n(n_tok)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        on_card = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        traced.append((wall, sum(device_us(e) for e in on_card) / 1e6,
                       sum(e.count for e in on_card), on_card))
    return traced


def lm_train_card_vs_cpu(cut, card_lm, cpu_lm, dev, batch: dict,
                         opt_steps: int, phase: str) -> dict:
    """The loss, every gradient and the parameters after ``opt_steps``
    AdamW steps of ``card_lm`` on ``dev`` against ``cpu_lm`` (the same
    weights) on the CPU, on one host ``batch``, within ``LM_TRAIN_TOL``.
    Returns the largest error of each kind."""
    import torch
    from repro_torch.models import api as lm_api
    from repro_torch.train import optimizer as opt_mod
    loss_fn = lm_api.make_loss_fn(cut)
    ocfg = opt_mod.OptConfig()
    sides = {}
    for tag, model, d in (("card", card_lm, dev), ("cpu", cpu_lm, "cpu")):
        b = {key: torch.from_numpy(x).to(d) for key, x in batch.items()}
        params = dict(model.named_parameters())
        state = opt_mod.init_opt_state(params, ocfg)
        for i in range(opt_steps):
            loss, _ = loss_fn(model, b)
            grads = dict(zip(params, torch.autograd.grad(
                loss, list(params.values()))))
            if i == 0:
                first = (loss.detach(), grads)
            opt_mod.adamw_update(params, grads, state, ocfg,
                                 opt_mod.stacked_decay)
        sides[tag] = (first, {k: v.detach() for k, v in params.items()})
    ((l_c, g_c), p_c), ((l_h, g_h), p_h) = sides["card"], sides["cpu"]
    errs = {"loss": abs(float(l_c) - float(l_h))}
    pairs = ([("loss", l_c, l_h)] + [(f"grad {k}", g, g_h[k])
                                     for k, g in g_c.items()]
             + [(f"param {k}", p, p_h[k]) for k, p in p_c.items()])
    # compared where the card's tensors lie: the CPU's copied over once
    # (at full width the CPU would take tens of seconds for the same sums)
    for name, a, b in pairs:
        b = b.to(a.device)
        err = float((a - b).abs().max())
        if not torch.allclose(a, b, **LM_TRAIN_TOL):
            raise SystemExit(f"FAIL: {phase} {cut.name} fp32 {name}: card "
                             f"vs CPU beyond {LM_TRAIN_TOL} (max err "
                             f"{err:.3g})")
        kind = name.split()[0]
        errs[kind] = max(errs.get(kind, 0.0), err)
    return errs


def train_phase(dev, card: str, main_launches: dict, add_check_launches,
                lap, sizes: dict = TRAIN, check_kernels: bool = True):
    """Phase 27: training on the card.

    (a) the WKV6 backward kernel against its plain version
    (``wkv6_bwd_ref``) on ``kernels/wkv6/cases.py::bwd_cases`` in fp32 and
    bf16, bit for bit on a second run, and at RWKV-6's training shape
    (bf16 (B, H, T, D) views) against autograd through
    ``wkv6_chunked_ref``, timed; (b) ``launch/train_planner.py``'s default
    (60 steps, FPS) with step 1 card against CPU, the loss falling, the 8
    gated plans against the CPU engine on the card's FK arrays, then
    ``--full``; (c) RWKV-6 1.6B trained 5 steps at full width and depth
    through ``lm/train.py``, checkpointed at step 2 and resumed bit for
    bit; (d) its 2-layer fp32 cut card against CPU: loss, every gradient
    and two AdamW steps.  Returns the JSON line of ``wkv6_bwd``.
    ``sizes`` and ``check_kernels`` let a rehearsal on the CPU run it at a
    cut size (the timers and the profiler run only on the card)."""
    import dataclasses
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.configs.base import ShapeSpec, get_config
    from repro_torch.data.pipeline import synth_batch
    from repro_torch.core.geometry import NUM_LINKS, arm_link_obbs
    from repro_torch.engine.executor import CollisionEngine, EngineConfig
    from repro_torch.engine.plan import QueryPlan
    from repro_torch.kernels import _build
    from repro_torch.kernels.wkv6 import ops as wkv6_ops
    from repro_torch.kernels.wkv6.cases import (bwd_cases, make_case,
                                                within_tol)
    from repro_torch.kernels.wkv6.ref import wkv6_bwd_ref, wkv6_chunked_ref
    from repro_torch.launch import train_planner as tp
    from repro_torch.lm import train as lm_train
    from repro_torch.models import api as lm_api
    from repro_torch.models.planner import Planner
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train import train_loop
    S = sizes
    on_card = dev.type == "cuda"
    names = ("dr", "dk", "dv", "dlogw", "du")

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def peak_reset():
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()

    def peak_gib():
        return torch.cuda.max_memory_allocated() / 2**30 if on_card else 0.0

    def on_main(fn, want=(), tag=""):
        """Run ``fn`` as a main path: launch counts set to 0 just before,
        read just after, added to ``main_launches``."""
        add_check_launches()
        out = fn()
        sync()
        counts = _build.launch_counts()
        _build.reset_launch_counts()
        for name, n in counts.items():
            main_launches[name] += n
        for name in want:
            if check_kernels and counts[name] < 1:
                raise SystemExit(f"FAIL: 27 {tag}: {name} launched no time "
                                 f"on the main path ({counts})")
        return out, {k: n for k, n in counts.items() if n}

    def busy(fn):
        return traced_busy(fn, on_card)

    def grads_of(x_outs, xs, g_outs):
        got = torch.autograd.grad(x_outs, xs, g_outs)
        sync()
        return got

    # ---- (a) the WKV6 backward against its plain version ----------------
    n_cases = 0
    for case in bwd_cases():
        for dtype in (torch.float32, torch.bfloat16):
            ins = [torch.from_numpy(case[n]).to(dev, dtype) for n in "rkv"]
            ins += [torch.from_numpy(case[n]).to(dev)
                    for n in ("logw", "u")]
            do = torch.from_numpy(case["do"]).to(dev, dtype)
            ds = (None if case["dstate"] is None
                  else torch.from_numpy(case["dstate"]).to(dev))
            runs = []
            for _ in range(2):
                xs = [x.clone().requires_grad_() for x in ins]
                o, st = wkv6_ops.wkv6(*xs)
                outs, gs = [o], [do]
                if ds is not None:
                    outs, gs = [o, st], [do, ds]
                runs.append(grads_of(outs, xs, gs))
            want = wkv6_bwd_ref(*ins, do, ds)
            for name, g, g2, w in zip(names, runs[0], runs[1], want):
                dn = ("float32" if name in ("dlogw", "du")
                      else str(dtype)[6:])
                ex = within_tol(g, w, dn)
                if ex > 0 or not bool(g.isfinite().all()):
                    raise SystemExit(f"FAIL: 27 wkv6_bwd {name} differs "
                                     f"from plain on {case['name']} {dtype}"
                                     f" (excess {ex:.3g})")
                if not torch.equal(g, g2):
                    raise SystemExit(f"FAIL: 27 wkv6_bwd {name} not "
                                     f"deterministic on {case['name']}")
            n_cases += 1
    add_check_launches()
    log("27 train", f"(a) wkv6_bwd within cases.TOL of wkv6_bwd_ref and"
        f" bit for bit on a second run on {n_cases} cases (T 33/256, D 64, "
        "ordinary/strong/weak decays, with and without dS, per-row and "
        "shared u, fp32 and bf16)")

    # RWKV-6's training shape: bf16 (B, H, T, D) views of (B, T, H, D)
    Bq, H, T, D = S["bwd_shape"]
    case = make_case(Bq * H, T, D, "ordinary", per_row_u=False, seed=27)
    rs = np.random.RandomState(27)

    def view(a, dt):
        return (torch.from_numpy(a).to(dev, dt).reshape(Bq, H, T, D)
                .transpose(1, 2).contiguous().transpose(1, 2))
    heads = [view(case[n], dt) for n, dt in (
        ("r", torch.bfloat16), ("k", torch.bfloat16),
        ("v", torch.bfloat16), ("logw", torch.float32))]
    u = torch.from_numpy((rs.normal(size=(H, D)) * 0.3)
                         .astype(np.float32)).to(dev)
    do = view(rs.normal(size=(Bq * H, T, D)).astype(np.float32),
              torch.bfloat16)
    runs = []
    for _ in range(2):
        xs = [x.clone().requires_grad_() for x in heads + [u]]
        o, _ = wkv6_ops.wkv6_heads(*xs)
        runs.append(grads_of([o], xs, [do]))
    fold = [x.reshape(Bq * H, T, D).clone().requires_grad_()
            for x in heads]
    u_rows = u[None].expand(Bq, H, D).reshape(Bq * H, D).clone()
    u_rows.requires_grad_()
    o_c, _ = wkv6_chunked_ref(*fold, u_rows)
    want = grads_of([o_c], fold + [u_rows], [do.reshape(Bq * H, T, D)])
    want = list(want[:4]) + [want[4].reshape(Bq, H, D).sum(0)]
    del o_c, fold, u_rows
    bwd_err = 0.0
    for name, g, g2, w in zip(names, runs[0], runs[1], want):
        g = g.reshape(w.shape)
        dn = "float32" if name in ("dlogw", "du") else "bfloat16"
        ex = within_tol(g, w, dn)
        if ex > 0 or not torch.equal(runs[0][names.index(name)], g2):
            raise SystemExit(f"FAIL: 27 wkv6_bwd {name} at RWKV-6's shape: "
                             f"excess {ex:.3g} over autograd through "
                             f"wkv6_chunked_ref, or not deterministic")
        bwd_err = max(bwd_err, float((g.float() - w.float()).abs().max()))
    del runs, want
    add_check_launches()
    xs = [x.detach() for x in heads + [u]]

    def bwd_call():
        return wkv6_ops._backward(*xs, do, None, True)

    if on_card:
        ms = cuda_time_ms(bwd_call, S["bwd_reps"])
        # the call's four kernels: the carries' chunk terms, their scan,
        # every chunk, du's sum
        kern_parts = {key: kernel_device_ms(bwd_call, key, S["bwd_reps"],
                                            "wkv6_bwd")
                      for key in ("wkv6_bwd_update", "wkv6_bwd_scan",
                                  "wkv6_bwd_chunk", "wkv6_bwd_du_sum")}
        kern_ms = sum(kern_parts.values())
        # a training microbatch (lm/train.py's B 8 in 4): B 2 of the 8
        micro_ms = cuda_time_ms(
            lambda: wkv6_ops._backward(*[x[:2] for x in xs[:4]], u, do[:2],
                                       None, True), S["bwd_reps"])
        fold = [x.reshape(Bq * H, T, D) for x in xs[:4]]
        u_rows = u[None].expand(Bq, H, D).reshape(Bq * H, D)
        plain_ms = cuda_time_ms(
            lambda: wkv6_bwd_ref(*fold, u_rows, do.reshape(Bq * H, T, D)),
            1, warmup=0)
        del fold, u_rows
    else:
        ms = kern_ms = plain_ms = micro_ms = float("nan")
        kern_parts = {}
    add_check_launches()
    rows = Bq * H
    # read once: r, k, v, do (bf16), logw (fp32), u; written once: dr, dk,
    # dv (bf16), dlogw (fp32), du
    bwd_bytes = rows * T * D * (4 * 2 + 4 + 3 * 2 + 4) + 2 * H * D * 4
    bms, by = wkv6_bwd_bound(rows, T, D, bwd_bytes)
    step_ops = rows * T * (OPS_WKV6_BWD_D2 * D * D + OPS_WKV6_BWD_D * D)
    step_bms = 1e3 * step_ops / PEAK_FP32_PER_S
    line = dict(name="wkv6_bwd", route="cuda",
                source="src/repro_torch/kernels/wkv6/csrc/wkv6_bwd.cu",
                replaces="none: the reference differentiates "
                         "src/repro/kernels/wkv6/ref.py:10 (wkv6_ref's "
                         "lax.scan); the forward is "
                         "src/repro/kernels/wkv6/kernel.py:27",
                max_abs_err=bwd_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, library_ms=None,
                kernel_ms=kern_ms, microbatch_ms=micro_ms)
    log("27 train", f"(a) wkv6_bwd at RWKV-6's training shape (B {Bq}, H "
        f"{H}, T {T}, D {D}, bf16 views): within cases.TOL of autograd "
        f"through wkv6_chunked_ref, deterministic, max abs err "
        f"{bwd_err:.4g}; call {ms:.4f} ms, kernels on the card "
        f"{kern_ms:.4f} ms ("
        + ", ".join(f"{k_} {v_:.4f}" for k_, v_ in kern_parts.items())
        + f"; torch.profiler, {kern_ms / bms:.1f}x the bound), plain "
        f"{plain_ms:.3f} ms, bound {bms:.5f} ms ({by}: {bwd_bytes} B; the "
        f"chunked form's operations; the step form's {step_ops} fp32 "
        f"operations would take {step_bms:.5f} ms); at a training "
        f"microbatch (B 2, BH {2 * H}) call {micro_ms:.4f} ms | {card}")
    del heads, xs, do, u
    log("27 train", f"(a) phase part {lap():.1f} s")

    # ---- (b) planner training --------------------------------------------
    def gate_on_cpu(data_cpu_engine, evals):
        """Each gated plan's verdicts against the CPU engine handed the
        card's FK arrays (C.15)."""
        for i, e in enumerate(evals):
            traj = torch.from_numpy(e["result"].trajectory).to(dev)
            ob = arm_link_obbs(traj)
            plan = QueryPlan(kind="trajectory", obb_c=ob.center.cpu(),
                             obb_h=ob.half.cpu(), obb_r=ob.rot.cpu(),
                             out_shape=(traj.shape[0], NUM_LINKS),
                             reduce_last=True)
            flags, _ = data_cpu_engine.execute(plan)
            if not np.array_equal(np.asarray(flags),
                                  e["result"].colliding_waypoints):
                raise SystemExit(f"FAIL: 27 planner: gated plan {i}'s "
                                 "verdicts differ from the CPU engine's on "
                                 "the card's FK arrays")

    for full in (False, True):
        tag = "--full" if full else "default"
        steps = S["full_steps"] if full else S["planner_steps"]
        peak_reset()
        t0 = time.perf_counter()
        gen = torch.Generator().manual_seed(0)
        cpu_planner = Planner(widen=10 if full else 1, generator=gen,
                              device="cpu")
        planner = copy.deepcopy(cpu_planner).to(dev)

        def check_step1(data):
            """Step 1 card against CPU: the same parameters and batch."""
            idx = copy.deepcopy(data.rs).randint(0, len(data.qs), tp.BATCH)
            gl, gg = tp.loss_and_grads(
                planner, tp.batch_at(data, idx, dev), "fps", None)
            wl, wg = tp.loss_and_grads(
                cpu_planner, tp.batch_at(data, idx, "cpu"), "fps", None)
            errs = {"loss": abs(float(gl) - float(wl))}
            if not torch.allclose(gl.cpu(), wl, **PLANNER_GRAD_TOL):
                raise SystemExit(f"FAIL: 27 planner step 1 loss card "
                                 f"{float(gl)} vs CPU {float(wl)}")
            for n, g in gg.items():
                if not torch.allclose(g.cpu(), wg[n], **PLANNER_GRAD_TOL):
                    raise SystemExit(f"FAIL: 27 planner step 1 gradient {n}"
                                     " card vs CPU beyond "
                                     f"{PLANNER_GRAD_TOL}")
                errs[n] = float((g.cpu() - wg[n]).abs().max())
            return max(errs.values())

        def train_and_evaluate(data):
            losses, walls = tp.train(planner, data, steps, "fps", log=None)
            return losses, walls, tp.evaluate(planner, data, "fps", log=None)

        data, c_setup = on_main(
            lambda: tp.setup(full, dev, num_points=S["scene_points"],
                             depth=S["depth"]),
            ("traverse", "compact"), f"planner {tag} expert data")
        if not full:
            step1_err = check_step1(data)
            add_check_launches()
        (losses, walls, evals), c_train = on_main(
            lambda: train_and_evaluate(data),
            ("fps", "ballquery", "traverse", "compact"), f"planner {tag}")
        counts = {k: c_setup.get(k, 0) + c_train.get(k, 0)
                  for k in set(c_setup) | set(c_train)}
        secs = time.perf_counter() - t0
        peak = peak_gib()
        # the default run's loss must fall below 0.8x its first, as
        # test_substrate.py::test_planner_bc_loss_decreases asks of the
        # reference; --full's is printed
        if not (np.isfinite(losses).all()
                and (full or losses[-1] < 0.8 * losses[0])):
            raise SystemExit(f"FAIL: 27 planner {tag}: the loss did not fall"
                             f" below 0.8x its first ({losses[0]:.4f} -> "
                             f"{losses[-1]:.4f})")
        cpu_engine = CollisionEngine(data.engine.octrees[0],
                                     EngineConfig(mode="wavefront_fused"),
                                     device="cpu")
        gate_on_cpu(cpu_engine, evals)
        ok = sum(e["collision_free"] and e["reached"] for e in evals)
        caught = sum(not e["collision_free"] for e in evals)
        traced = dataclasses.replace(data, rs=copy.deepcopy(data.rs))
        w_tr, d_tr, top = busy(lambda: tp.train(planner, traced, 1, "fps",
                                                log=None))
        add_check_launches()
        n_params = sum(p.numel() for p in planner.parameters())
        warm = statistics.median(walls[min(5, len(walls) - 1):])
        log("27 train", f"(b) planner {tag}: {n_params} parameters, "
            f"{len(data.qs)} expert tuples, {steps} steps: loss "
            f"{losses[0]:.4f} -> {losses[-1]:.4f}; warm step wall "
            f"{1e3 * warm:.2f} ms (median of steps 5+), a traced step "
            f"{1e3 * w_tr:.2f} ms, device {1e3 * d_tr:.2f} ms (busy "
            f"{100 * d_tr / w_tr:.1f} %); {len(evals)} gated plans: "
            f"success {ok}, caught {caught}, each == the CPU engine on the "
            f"card's FK; main-path launches {counts}; peak mem "
            f"{peak:.3f} GiB; {secs:.1f} s in all | {card}")
        log("27 train", f"(b) planner {tag}, the traced step's largest: "
            f"{top}")
        if not full:
            log("27 train", f"(b) step 1 card == CPU within "
                f"{PLANNER_GRAD_TOL}: max abs err "
                f"{step1_err:.3g} (loss and every "
                "gradient)")
        del planner, cpu_planner, data, evals
    log("27 train", f"(b) phase part {lap():.1f} s")

    # ---- (c) RWKV-6 1.6B training at full width and depth ------------------
    cfg = get_config("rwkv6_1_6b")
    micro = cfg.train_microbatches
    shape = ShapeSpec("t", S["lm_seq"], S["lm_batch"], "train")
    ck_dir = tempfile.mkdtemp(prefix="repro_torch_train_")
    kw = dict(batch=S["lm_batch"], seq=S["lm_seq"], microbatches=micro,
              ckpt_dir=ck_dir, device=dev, log=None)
    try:
        peak_reset()
        t0 = time.perf_counter()
        res, counts = on_main(
            lambda: lm_train.train(cfg, S["lm_steps"],
                                   ckpt_every=S["lm_ckpt_every"], **kw),
            ("wkv6", "wkv6_bwd"), "rwkv6 training")
        t_run = time.perf_counter() - t0
        peak = peak_gib()
        fwd_want = 2 * cfg.num_layers * micro * S["lm_steps"]
        if check_kernels and (counts.get("wkv6") != fwd_want or counts.get(
                "wkv6_bwd") != fwd_want // 2):
            raise SystemExit(f"FAIL: 27 rwkv6 training launched {counts}; "
                             f"want {fwd_want} wkv6 (forward and remat, a "
                             f"layer a microbatch a step) and "
                             f"{fwd_want // 2} wkv6_bwd")
        if not (np.isfinite(res.losses).all()
                and np.isfinite(res.grad_norms).all()):
            raise SystemExit(f"FAIL: 27 rwkv6 training: losses "
                             f"{res.losses}, grad norms {res.grad_norms}")
        losses, gnorms, walls = res.losses, res.grad_norms, res.walls
        n_weights = sum(p.numel() for p in res.model.parameters())
        # kept on the card: a copy to the host of 16 GB would cost more
        # than the steps
        final = {k: v.detach().clone()
                 for k, v in res.model.state_dict().items()}
        final_opt = {key: {k: v.clone()
                           for k, v in res.opt_state[key].items()}
                     for key in ("m", "v")}
        # one more step, traced (the model is done with)
        batch = {key: torch.from_numpy(x).to(dev)
                 for key, x in synth_batch(cfg, shape, 99).items()}
        step_fn = train_loop.make_train_step(cfg, opt_mod.OptConfig(), micro)
        w_tr, d_tr, top = busy(lambda: step_fn(res.model, res.opt_state,
                                               batch))
        del res, batch, step_fn
        add_check_launches()
        t0 = time.perf_counter()
        again, _ = on_main(
            lambda: lm_train.train(cfg, S["lm_steps"], ckpt_every=10 ** 6,
                                   resume=True, **kw),
            ("wkv6", "wkv6_bwd"), "rwkv6 resume")
        t_resume = time.perf_counter() - t0
        if again.start != S["lm_ckpt_every"]:
            raise SystemExit(f"FAIL: 27 rwkv6 resume started at step "
                             f"{again.start}")
        diff = [k for k, v in again.model.state_dict().items()
                if not torch.equal(v.detach(), final[k])]
        diff += [f"{key}:{k}" for key in ("m", "v")
                 for k, v in again.opt_state[key].items()
                 if not torch.equal(v, final_opt[key][k])]
        if diff or again.losses != losses[again.start:]:
            raise SystemExit(f"FAIL: 27 rwkv6 resume from step "
                             f"{again.start - 1} differs from the "
                             f"uninterrupted run: {diff[:4]}, losses "
                             f"{again.losses} vs {losses[again.start:]}")
        del again, final, final_opt
    finally:
        shutil.rmtree(ck_dir, ignore_errors=True)
    warm = statistics.median(walls[1:])
    tokens = S["lm_batch"] * S["lm_seq"]
    log("27 train", f"(c) {cfg.name}: {n_weights} weights, bf16, B "
        f"{S['lm_batch']} x S {S['lm_seq']} in {micro} microbatches, "
        f"{S['lm_steps']} steps through lm/train.py: losses "
        + ", ".join(f"{x:.4f}" for x in losses) + "; grad norms "
        + ", ".join(f"{x:.3f}" for x in gnorms)
        + f"; step walls " + ", ".join(f"{1e3 * x:.1f}" for x in walls)
        + f" ms (warm median {1e3 * warm:.1f} ms, {tokens / warm:.0f} "
        f"tokens/s); a traced step {1e3 * w_tr:.1f} ms, device "
        f"{1e3 * d_tr:.1f} ms (busy {100 * d_tr / w_tr:.1f} %); main-path "
        f"launches {counts}; peak mem {peak:.3f} GiB; the run {t_run:.1f} s"
        f" (steps {sum(walls):.1f} s; the rest the draw of the weights, "
        f"the checkpoint's copy to the host and its writer) | {card}")
    log("27 train", f"(c) the traced step's largest: {top}")
    log("27 train", f"(c) checkpoint at step {S['lm_ckpt_every'] - 1}, a "
        f"fresh model and optimizer restored from it ran steps "
        f"{S['lm_ckpt_every']}-{S['lm_steps'] - 1} in {t_resume:.1f} s "
        "(draw, restore, steps): parameters and moments equal the "
        "uninterrupted run's bit for bit")
    log("27 train", f"(c) phase part {lap():.1f} s")

    # ---- (d) the 2-layer fp32 cut, card against CPU -------------------------
    cut = cfg.replace(num_layers=S["cut_layers"], param_dtype="float32",
                      compute_dtype="float32")
    cpu_lm = lm_api.init_params(cut, torch.Generator().manual_seed(7),
                                device="cpu")
    card_lm = copy.deepcopy(cpu_lm).to(dev)
    batch = synth_batch(cut, ShapeSpec("t", S["cut_seq"], S["cut_batch"],
                                       "train"), 0)
    errs = lm_train_card_vs_cpu(cut, card_lm, cpu_lm, dev, batch,
                                S["cut_opt_steps"], "27 rwkv6")
    add_check_launches()
    del cpu_lm, card_lm
    log("27 train", f"(d) {cfg.name} at full width, {S['cut_layers']} "
        f"layers, fp32 (TF32 off), B {S['cut_batch']} x S {S['cut_seq']}: "
        f"loss, every gradient and the parameters after "
        f"{S['cut_opt_steps']} AdamW steps card == CPU within "
        f"{LM_TRAIN_TOL}; max err " + ", ".join(
            f"{k} {v:.3g}" for k, v in errs.items()) + f" | {card}")
    log("27 train", f"(d) phase part {lap():.1f} s")
    return line


def compare_routes(tag: str, card_calls, cpu_calls, batch: int,
                   excluded: set) -> dict:
    """Each recorded ``models/ffn.py::moe_route`` call of the card against
    the CPU's, both replayed on their recorded inputs: expert ids, buffer
    positions and kept flags exactly equal.  A token's ids may differ only
    where the CPU's k-th and (k+1)-th probabilities lie within twice the
    call's largest router-logit difference (the greedy-token checks'
    rule); its dispatch group (a batch row in prefill, the whole batch in
    decode) is then said so and joins ``excluded``: those rows are compared
    no further.  Returns the pairs compared, those the routes drop, and the
    near-tie tokens."""
    import torch
    out = dict(pairs=0, dropped=0, ties=0)
    if len(card_calls) != len(cpu_calls):
        raise SystemExit(f"FAIL: {tag}: {len(card_calls)} moe_route calls on "
                         f"the card, {len(cpu_calls)} on the CPU")
    for layer, ((fc, ac, kc), (fh, ah, kh)) in enumerate(zip(card_calls,
                                                             cpu_calls)):
        with torch.inference_mode():
            got = [t.cpu() for t in fc(*ac, **kc)]
            want = fh(*ah, **kh)
        probs, idx, pos, keep = want[0], want[2], want[3], want[4]
        k = idx.shape[-1]
        for g in range(idx.shape[0]):
            rows = {g} if idx.shape[0] == batch else set(range(batch))
            if rows & excluded:
                continue
            if all(torch.equal(a[g], b[g]) for a, b in zip(got[2:], want[2:])):
                out["pairs"] += idx[g].numel()
                out["dropped"] += int((~keep[g]).sum())
                continue
            differ = (got[2][g] != idx[g]).any(-1)
            with torch.inference_mode():
                delta = float(((ac[1][g].float() @ ac[0]["router"]).cpu()
                               - ah[1][g].float() @ ah[0]["router"]
                               ).abs().max())
            top = probs[g].sort(-1, descending=True).values
            gap = top[:, k - 1] - top[:, k]
            if not bool(differ.any()) or bool((gap[differ] > 2 * delta).any()):
                raise SystemExit(
                    f"FAIL: {tag} layer call {layer} group {g}: routes differ "
                    f"card vs CPU ({int(differ.sum())} tokens' experts) where "
                    f"the k-th and (k+1)-th probabilities are further apart "
                    f"than 2 x {delta:.3g}")
            out["ties"] += int(differ.sum())
            excluded |= rows
            log(tag, f"layer call {layer} group {g}: {int(differ.sum())} "
                f"tokens route otherwise on the card, each a near tie (top-k "
                f"gap <= 2 x {delta:.3g}, the router-logit difference); rows "
                f"{sorted(rows)} are compared no further")
    return out


def dense_cut_vs_cpu(arch: str, phase: str, cuda, card: str,
                     add_check_launches, lap, batch: int = LM_CUT_BATCH,
                     prompt: int = LM_CUT_PROMPT,
                     steps: int = LM_CUT_STEPS) -> None:
    """Phases 19, 28 (d), 29 (a, d), 30 (a) and 31 (c): the attention model
    ``arch`` at full width cut to ``LM_CUT_LAYERS`` layers (an ``encdec``
    model's encoder too), in fp32 (TF32 off), weights drawn on the card and
    copied to a CPU twin: B = ``batch``, a prompt of ``prompt`` tokens and
    ``steps`` teacher-forced decode steps, logits and every cache tensor
    (the k and v caches; an ``encdec`` model's cross caches, a ``hybrid``
    model's SSM states too) within ``LM_FP32_TOL``.  A
    ``vlm`` model's prompts follow ``num_patches`` patch embeddings drawn
    from a seed, and its decode positions follow both; an ``encdec``
    model's attend ``ENCDEC["cut_frames"]`` frames drawn from a seed.  A
    MoE model's
    routes are held card against CPU at every layer of every call
    (:func:`compare_routes`), and the share of pairs dropped is
    printed."""
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import api as lm_api
    from repro_torch.models import ffn as ffn_mod
    g_full = get_config(arch)
    g_cut = g_full.replace(num_layers=LM_CUT_LAYERS, param_dtype="float32",
                           compute_dtype="float32",
                           encoder_layers=min(g_full.encoder_layers,
                                              LM_CUT_LAYERS))
    t0 = time.perf_counter()
    g_card = lm_api.init_params(
        g_cut, torch.Generator(device=cuda).manual_seed(7), device=cuda)
    g_cpu = lm_api.init_params(g_cut, device="meta").to_empty(device="cpu")
    g_cpu.load_state_dict(g_card.state_dict())
    t_init = time.perf_counter() - t0
    rs = np.random.RandomState(1)
    toks = torch.from_numpy(rs.randint(0, g_cut.vocab_size,
                                       (batch, prompt)))
    forced = torch.from_numpy(rs.randint(0, g_cut.vocab_size,
                                         (steps, batch)))
    P = g_cut.num_patches if g_cut.family == "vlm" else 0
    host = {"tokens": toks}
    if P:
        host["patch_embeds"] = torch.from_numpy(rs.normal(
            size=(batch, P, g_cut.d_model)).astype(np.float32))
    n_frames = ENCDEC["cut_frames"] if g_cut.family == "encdec" else 0
    if n_frames:
        host["frames"] = torch.from_numpy(rs.normal(
            size=(batch, n_frames, g_cut.d_model)).astype(np.float32))
    prefill_g = lm_api.make_prefill_fn(g_cut,
                                       P + prompt + steps)
    decode_g = lm_api.make_decode_fn(g_cut)
    targets = ({"route": (ffn_mod, "moe_route")} if g_cut.num_experts
               else {})
    g_err, excluded = {}, set()
    routes = dict(pairs=0, dropped=0, ties=0)

    def run(tag, on_card, on_cpu):
        """Both sides of one call, then their routes and outputs."""
        with Recorder(targets) as rec_c:
            got = on_card()
        with Recorder(targets) as rec_h:
            want = on_cpu()
        if targets:
            r = compare_routes(f"{phase} {tag}", rec_c.calls["route"],
                               rec_h.calls["route"], batch, excluded)
            for key in r:
                routes[key] += r[key]
            if tag == "prefill":
                routes["prefill_pairs"] = r["pairs"]
                routes["prefill_dropped"] = r["dropped"]
        compare(tag, got, want)
        return got, want

    def compare(tag, got, want):
        """Logits and every cache tensor, card against CPU, now (the
        attention caches are written in place by the next step), on the
        rows no near-tie route has set apart."""
        rows = [b for b in range(batch) if b not in excluded]
        lg, cg = got
        lh, ch = want
        pairs = [("logits", lg, lh, 0)] + [
            (f"kv.{key}", cg["kv"][key], ch["kv"][key], 1) for key in "kv"]
        pairs += [(key, cg[key], ch[key], 1) for key in ("xk", "xv", "ssm")
                  if key in cg]
        for key, a, b, dim in pairs:
            a = a.cpu()
            if a.shape != b.shape:
                raise SystemExit(f"FAIL: {arch} 2-layer fp32 {tag} {key}: "
                                 f"shape {tuple(a.shape)} vs {tuple(b.shape)}")
            a, b = a.index_select(dim, torch.tensor(rows)), b.index_select(
                dim, torch.tensor(rows))
            if not torch.allclose(a, b, **LM_FP32_TOL):
                raise SystemExit(f"FAIL: {arch} 2-layer fp32 {tag} {key}: "
                                 f"card vs CPU beyond {LM_FP32_TOL} (max err "
                                 f"{float((a - b).abs().max()):.3g})")
            g_err[key] = max(g_err.get(key, 0.0), float((a - b).abs().max()))

    got, want = run("prefill",
                    lambda: prefill_g(g_card, {key: t.to(cuda)
                                               for key, t in host.items()}),
                    lambda: prefill_g(g_cpu, host))
    for i, tok in enumerate(forced):
        pos = P + prompt + i
        got, want = run(f"step {i}",
                        lambda: decode_g(g_card, tok.to(cuda), pos, got[1]),
                        lambda: decode_g(g_cpu, tok, pos, want[1]))
    del g_card, g_cpu, got, want
    add_check_launches()
    if len(excluded) == batch:
        raise SystemExit(f"FAIL: {arch}: near-tie routes left no row to "
                         "compare")
    route_note = ""
    if targets:
        C = ffn_mod.moe_capacity(g_cut, prompt)
        pre, pre_drop = routes["prefill_pairs"], routes["prefill_dropped"]
        route_note = (
            f" | routes (expert ids, buffer positions, kept flags) of every "
            f"layer card == CPU on {routes['pairs']} (token, slot) pairs, "
            f"near-tie tokens {routes['ties']}, rows set apart "
            f"{sorted(excluded)}; the prefill (C {C} a row) drops "
            f"{pre_drop} of {pre} pairs ({100 * pre_drop / max(pre, 1):.2f} "
            f"%), the decode steps {routes['dropped'] - pre_drop}")
    log(phase, f"full width, {LM_CUT_LAYERS} layers"
        + (f" (and {g_cut.encoder_layers} encoder layers over {n_frames} "
           f"frames)" if n_frames else "") + f", B="
        f"{batch}, {f'{P} patch embeddings + ' if P else ''}prompt "
        f"{prompt}, {steps} teacher-forced steps (positions "
        f"from {P + prompt}): card == CPU within {LM_FP32_TOL}; max "
        f"err " + ", ".join(f"{k} {v:.3g}" for k, v in g_err.items())
        + route_note + f" | weights drawn on the card and copied to the CPU "
        f"in {t_init:.1f} s | {lap():.1f} s | {card}")


def attention_calls(cfg) -> int:
    """The flash-attention calls of one forward of ``cfg``: one a layer,
    and an ``encdec`` model's encoder self-attention and decoder
    cross-attention besides (72 for Whisper-medium)."""
    if cfg.family == "encdec":
        return cfg.encoder_layers + 2 * cfg.num_layers
    return cfg.num_layers


def flash_fwd_bound(q, k, causal: bool = True, window: int = 0):
    """The bf16 flash-attention forward's bound: q, k and v read once and o
    written once over the memory rate, against its operations: per seen
    pair (a query row and each key at or before it when causal, within
    ``window`` keys of it where given, every key otherwise) q.k and p*v, 2
    d products and 2 d sums on the bf16 tensor
    cores, and the softmax (scale, max, exp, sum, rescale: ~6 fp32
    operations a pair) beside them on the CUDA cores, so the least time is
    the larger of the two.  Returns (ms, bound_by, bytes, tensor
    operations, fp32 operations)."""
    Bq, Hq, Tq, d = q.shape
    Tk = k.shape[2]
    pairs = (sum(min(i + 1, Tk, window or Tq) for i in range(Tq)) if causal
             else Tq * Tk) * Bq * Hq
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    mma, fp32 = 4 * d * pairs, 6 * pairs
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = max(mma / PEAK_BF16_PER_S, fp32 / PEAK_FP32_PER_S)
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", nbytes, mma, fp32)


def dense_serve(arch: str, phase: str, cuda, card: str, main_launches: dict,
                add_check_launches, lap, num_layers: int = 0,
                prompt: Optional[Sequence[int]] = None,
                batch: int = LM_BATCH, prompt_len: int = LM_PROMPT,
                repeats: bool = True,
                scans_held: Optional[int] = None) -> dict:
    """Phases 20, 28 (d), 29 (b, d), 30 (b) and 31 (d, e):
    ``lm.serve.serve`` on the
    bf16 attention model ``arch`` at full width and depth (cut to
    ``num_layers`` where given; weights drawn on the card from a seeded
    generator), ``batch`` prompts of ``prompt_len`` random tokens (or
    each the ``prompt`` given; after ``num_patches`` patch embeddings drawn
    from a seed for a ``vlm`` model, against ``ENCDEC["frames"]`` frames
    drawn from a seed for an ``encdec`` one) and ``LM_TOKENS`` greedy
    tokens; :func:`attention_calls` ``flash_attention`` launches in the
    prefill and none in decode; the kernel against its plain version on
    every captured prefill input; warm walls (the median of
    ``LM_WARM_SERVES``), peak memory, busy shares, the kernel's time
    against its bound, plain version and ``scaled_dot_product_attention``
    at each shape the prefill gives it (one in a decoder-only model;
    Whisper's encoder, decoder and cross-attention); a MoE model's share of
    pairs dropped in the prefill; prefill/decode consistency (a MoE model's
    at capacity factor 8 on the same weights: the prefill drops pairs that
    a decode group never does).  A ``hybrid`` model's prefill also
    launches ``ssm_scan`` once a layer: each captured scan (or
    ``scans_held`` of them, spread over the layers) against its plain
    version (the state bit for bit), and the scan timed against its bound
    and plain version.  With ``repeats`` off, the walls are the counted
    serve's, and the warm serves and the traced ones are left out.
    Returns the ``flash_attention`` line of the
    JSON result: the first shape's figures, and where the prefill gave the
    kernel more than one shape, every shape's under ``shapes``; a
    ``hybrid`` model's scan figures under ``scan``."""
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import cases as flash_cases
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.ssm_scan import ops as scan_ops
    from repro_torch.lm.serve import serve
    from repro_torch.models import api as lm_api
    from repro_torch.models import ffn as ffn_mod
    g_full = get_config(arch)
    if num_layers:
        g_full = g_full.replace(num_layers=num_layers)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t0 = t_begin = time.perf_counter()
    lm = lm_api.init_params(g_full,
                             torch.Generator(device=cuda).manual_seed(0),
                             device=cuda)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_weights = sum(p.numel() for p in lm.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in lm.parameters())
    rs = np.random.RandomState(0)
    prompts = (np.tile(np.asarray(prompt), (batch, 1)) if prompt
               else rs.randint(0, g_full.vocab_size, (batch, prompt_len)))
    S = prompts.shape[1]
    P = g_full.num_patches if g_full.family == "vlm" else 0
    patches = (torch.from_numpy(rs.normal(size=(
        batch, P, g_full.d_model)).astype(np.float32)).to(cuda)
               if P else None)
    n_frames = ENCDEC["frames"] if g_full.family == "encdec" else 0
    frames = (torch.from_numpy(rs.normal(size=(
        batch, n_frames, g_full.d_model)).astype(np.float32)).to(cuda)
              if n_frames else None)
    n_calls = attention_calls(g_full)
    hybrid = g_full.family == "hybrid"
    prefill_launches = {"flash_attention": n_calls}
    if hybrid:
        prefill_launches["ssm_scan"] = g_full.num_layers
    decode = lm_api.make_decode_fn(g_full)

    def serve_(n: int):
        return serve(lm, prompts, n, patch_embeds=patches, frames=frames)
    serve_(2)                                              # warm-up
    add_check_launches()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    res = serve_(LM_TOKENS)
    counts = _build.launch_counts()
    _build.reset_launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for name, n in counts.items():
        main_launches[name] += n
    want = {name: prefill_launches.get(name, 0) for name in counts}
    if counts != want:
        raise SystemExit(f"FAIL: {arch} serve launched {counts}, want {want} "
                         f"({prefill_launches} in the prefill, none in "
                         f"decode)")
    decode(lm, res.tokens[:, -1], P + S + LM_TOKENS - 1,   # the next slot
           res.caches)
    torch.cuda.synchronize()
    if any(_build.launch_counts().values()):
        raise SystemExit(f"FAIL: a {arch} decode step launched "
                         f"{_build.launch_counts()}")
    gen_toks = res.tokens.cpu()
    kv_shape = tuple(res.caches["kv"]["k"].shape)
    L, K, hd = g_full.num_layers, g_full.num_kv_heads, g_full.hd
    x_shape = (tuple(res.caches["xk"].shape) if n_frames
               else (L, batch, n_frames, K, hd))
    if not (gen_toks.shape == (batch, LM_TOKENS)
            and bool(((gen_toks >= 0)
                      & (gen_toks < g_full.vocab_size)).all())
            and bool(res.logits.float().isfinite().all())
            and kv_shape == (L, batch, g_full.sliding_window
                             or P + S + LM_TOKENS, K, hd)
            and x_shape == (L, batch, n_frames, K, hd)):
        raise SystemExit(f"FAIL: {arch} serve: bad tokens, logits or caches "
                         f"{kv_shape}, {x_shape}")
    # the kernel on the prefill inputs of one serve, against its plain
    # version on the same inputs; a MoE model's routes
    targets = {"flash": (flash_ops, "flash_attention")}
    if g_full.num_experts:
        targets["route"] = (ffn_mod, "moe_route")
    if hybrid:
        targets["scan"] = (scan_ops, "ssm_scan")
    with Recorder(targets) as rec_f:
        serve_(1)
    add_check_launches()
    calls = rec_f.calls["flash"]
    drop_note = ""
    if g_full.num_experts:
        kept = pairs_ = 0
        with torch.inference_mode():
            for fn, ca, ck in rec_f.calls.pop("route"):
                keep = fn(*ca, **ck)[4]
                kept += int(keep.sum())
                pairs_ += keep.numel()
        drop_note = (f" | the prefill drops {pairs_ - kept} of {pairs_} "
                     f"(token, slot) pairs over its {g_full.num_layers} "
                     f"layers ({100 * (pairs_ - kept) / pairs_:.2f} %; C "
                     f"{ffn_mod.moe_capacity(g_full, P + S)} a row "
                     f"of {P + S} tokens)")
    if len(calls) != n_calls:
        raise SystemExit(f"FAIL: recorder saw {len(calls)} flash_attention "
                         f"calls, want {n_calls}")
    groups = {}               # (q shape, k shape, causal) -> [errs, call]
    with torch.inference_mode():
        for li, (fn, ca, ck) in enumerate(calls):
            o = fn(*ca, **ck)
            wo = attention_ref(*ca, **ck)
            ex = flash_cases.within_tol(o, wo, "bfloat16")
            if ex > 0:
                raise SystemExit(f"FAIL: flash_attention differs from plain "
                                 f"on call {li}'s prefill input (excess "
                                 f"{ex:.3g})")
            causal = bool(ca[3] if len(ca) > 3 else ck.get("causal", True))
            window = int(ca[4] if len(ca) > 4 else ck.get("window", 0))
            key = (tuple(ca[0].shape), tuple(ca[1].shape), causal, window)
            group = groups.setdefault(key, [[], (fn, ca, ck)])
            group[0].append(float((o.float() - wo.float()).abs().max()))
        figures = []
        for (_, _, causal, window), (errs, (fn, ca, ck)) in groups.items():
            q, k, v = ca[:3]
            lib = sdpa_call(q, k, v, causal, window)
            lib_err = float((lib().float() - attention_ref(
                q, k, v, causal, window).float()).abs().max())
            ms = cuda_time_ms(lambda: fn(*ca, **ck), 20)
            # the kernel alone: a small shape's call is paced by the host
            kern_ms = kernel_device_ms(lambda: fn(*ca, **ck), "flash_hopper",
                                       20, "flash_attention", required=False)
            plain_ms = cuda_time_ms(lambda: attention_ref(*ca, **ck), 2)
            lib_ms = cuda_time_ms(lib, 20)
            bound, by, nbytes, mma, fp32 = flash_fwd_bound(q, k, causal,
                                                           window)
            figures.append(dict(
                max_abs_err=max(errs), ms=ms, kernel_ms=kern_ms,
                plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=lib_ms,
                shape=dict(q=list(q.shape), k=list(k.shape)), causal=causal,
                window=window,
                calls=len(errs), lib_err=lib_err, nbytes=nbytes, mma=mma,
                fp32=fp32, q_strides=q.stride(), v_strides=v.stride(),
                dtype=q.dtype))
    add_check_launches()
    line = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/flash_attention/csrc/flash_attn.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:25",
        **{key: figures[0][key] for key in (
            "max_abs_err", "ms", "kernel_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "shape")})
    if len(figures) > 1:
        line["shapes"] = [{key: f[key] for key in (
            "shape", "causal", "calls", "max_abs_err", "ms", "kernel_ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")}
            for f in figures]
    if hybrid:
        line["scan"] = scan_figures(rec_f.calls.pop("scan"), phase, card,
                                    g_full.num_layers, scans_held)
    add_check_launches()
    # warm walls
    t_checks = time.perf_counter()
    pre, dec = [res.prefill_s], [statistics.mean(res.decode_s)]
    if repeats:
        pre, dec = [], []
        for _ in range(LM_WARM_SERVES):
            rr = serve_(LM_TOKENS)
            pre.append(rr.prefill_s)
            dec.append(statistics.mean(rr.decode_s))
        del rr
    add_check_launches()
    pre_ms, dec_ms = (1e3 * statistics.median(x) for x in (pre, dec))
    t_warm = time.perf_counter()
    # prefill/decode consistency: decode token S+1 after prefilling S
    # tokens (after the prefix, against the frames) against the last logits
    # of a forward pass over S+1 tokens; a MoE model at capacity factor 8,
    # where no pair drops
    c_cfg = (g_full.replace(moe_capacity_factor=8.0) if g_full.num_experts
             else g_full)
    tokens = torch.from_numpy(prompts).to(cuda)
    inputs = {"tokens": tokens}
    if P:
        inputs["patch_embeds"] = patches
    if n_frames:
        inputs["frames"] = frames
    lm.cfg = c_cfg
    try:
        logits, caches = lm_api.make_prefill_fn(c_cfg)(lm, inputs)
        nxt = logits.argmax(-1)
        step, _ = lm_api.make_decode_fn(c_cfg)(lm, nxt, P + S, caches)
        longer = torch.cat([tokens, nxt[:, None]], 1)
        with torch.inference_mode():
            full = (lm.encdec_forward(frames, longer, last_only=True)
                    if n_frames else
                    lm.lm_forward(longer, patches, last_only=True))[0]
    finally:
        lm.cfg = g_full
    step, full = step.float(), full[:, -1].float()
    del caches
    delta = float((step - full).abs().max())
    top2 = full.topk(2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    agree = step.argmax(-1) == full.argmax(-1)
    near_tie = gap <= 2 * delta
    if not (delta <= LM_CONSIST_ATOL and bool((agree | near_tie).all())):
        raise SystemExit(f"FAIL: {arch} prefill/decode consistency: max|d| "
                         f"{delta:.4g} (bound {LM_CONSIST_ATOL}), greedy "
                         f"agrees on {int(agree.sum())} of {batch} rows")
    add_check_launches()
    t_consist = time.perf_counter()
    stages = (f"stages: set-up and kernel checks {t_checks - t_begin:.1f} s, "
              f"{LM_WARM_SERVES if repeats else 0} warm serves "
              f"{t_warm - t_checks:.1f} s, consistency "
              f"{t_consist - t_warm:.1f} s")
    x_note = ""
    if n_frames:
        xk = res.caches["xk"]
        x_bytes = 2 * xk.numel() * xk.element_size()
        x_note = (f", cross caches {x_shape} ({x_bytes / 1e9:.3f} GB, read "
                  f"whole by every decode step: "
                  f"{1e3 * x_bytes / PEAK_BYTES_PER_S:.4f} ms at "
                  f"{PEAK_BYTES_PER_S / 1e12:.2f} TB/s)")
    log(phase, f"{g_full.name}"
        + (f" cut to {num_layers} of its {get_config(arch).num_layers} "
           f"layers" if num_layers else "") + f": {n_weights} weights, "
        f"{w_bytes / 1e9:.3f} GB bf16, drawn on the card in {t_init:.1f} s "
        f"| B={batch} {f'{P} patch embeddings + ' if P else ''}prompt "
        f"{S}{f' against {n_frames} frames' if n_frames else ''}, "
        f"{LM_TOKENS} greedy tokens, KV caches {kv_shape}{x_note} | "
        f"main-path launches {counts} (decode step: 0) "
        + (f"| warm median of {LM_WARM_SERVES}: " if repeats
           else "| the counted serve: ")
        + f"prefill {pre_ms:.3f} ms, decode {dec_ms:.3f} "
        f"ms/token, {batch / (dec_ms / 1e3):.1f} tokens/s | peak mem "
        f"{peak / 2**30:.3f} GiB ({held / 2**30:.3f} GiB held before the "
        f"serve, of which {base / 2**30:.3f} GiB before the model)"
        f"{drop_note} | {card}")
    for f in figures:
        Bq, Hq, T, d = f["shape"]["q"]
        Hkv, Tk = f["shape"]["k"][1:3]
        ms = f["ms"]
        kern = ("not measured" if f["kernel_ms"] is None
                else f"{f['kernel_ms']:.4f} ms")
        log(phase, f"flash_attention on the {f['calls']} captured "
            f"prefill inputs (B={Bq}, Hq={Hq}, Hkv={Hkv}, T={T}"
            + (f", Tk={Tk}" if Tk != T else "")
            + f", d={d}, {'causal' if f['causal'] else 'non-causal'}, "
            f"{f['dtype']}"
            + (f", window {f['window']}" if f["window"] else "")
            + f", q strides {f['q_strides']}, v strides "
            f"{f['v_strides']}): kernel within cases.TOL of plain, max abs "
            f"err {f['max_abs_err']:.4g}; call {ms:.4f} ms a launch "
            f"({f['calls'] * ms:.3f} ms a prefill), the kernel alone "
            f"{kern} (torch.profiler), plain on card "
            f"{f['plain_ms']:.3f} ms, scaled_dot_product_attention("
            f"enable_gqa{'' if f['causal'] else ', is_causal=False'}) "
            f"{f['library_ms']:.4f} ms (max abs diff to plain "
            f"{f['lib_err']:.4g}), bound {f['bound_ms']:.5f} ms "
            f"({f['bound_by']}: {f['nbytes']} B, {f['mma']} bf16 tensor "
            f"ops, {f['fp32']} fp32 ops) | achieved "
            f"{f['mma'] / ms / 1e9:.1f} TFLOP/s on the tensor cores, "
            f"{100 * f['bound_ms'] / ms:.1f} % of the bound, "
            f"{ms / f['library_ms']:.3f}x scaled_dot_product_attention | "
            f"{card}")
    log(phase, f"prefill/decode consistency at {P + S + 1} "
        f"positions{' (capacity factor 8)' if g_full.num_experts else ''}: "
        f"max|d| logits {delta:.4g} (bound {LM_CONSIST_ATOL}), "
        f"greedy agrees on {int(agree.sum())} of {batch} rows, smallest "
        f"top-2 gap {float(gap.min()):.4g}, logits std "
        f"{float(full.std()):.3f}" + ("" if repeats else
                                      f" | {stages} | {lap():.1f} s"))
    if not repeats:
        del lm, rec_f, calls, groups, q, k, v, res, patches, frames
        return line
    # busy share: one warm prefill alone, then one warm serve; decode's
    # share is the difference of the two
    traced = traced_serves(serve_)
    add_check_launches()
    (w_pre, d_pre, n_pre, on_pre), (w_all, d_all, n_all, on_card) = traced
    stages += (f", traced serves "
               f"{time.perf_counter() - t_consist:.1f} s")
    top_pre = sorted(on_pre, key=device_us, reverse=True)[:5]
    top = sorted(on_card, key=device_us, reverse=True)[:5]
    log(phase, f"torch.profiler: a warm prefill, traced wall "
        f"{1e3 * w_pre:.3f} ms, device time {1e3 * d_pre:.3f} ms (busy "
        f"{100 * d_pre / w_pre:.1f} %), {n_pre} kernels and copies, largest: "
        + "; ".join(f"{e.key[:48]} {device_us(e) / 1e3:.3f} ms x{e.count}"
                    for e in top_pre)
        + f" | its {LM_TRACED_TOKENS - 1} decode steps, traced wall "
        f"{1e3 * (w_all - w_pre):.3f} ms, device time "
        f"{1e3 * (d_all - d_pre):.3f} ms (busy "
        f"{100 * (d_all - d_pre) / (w_all - w_pre):.1f} %), "
        f"{(n_all - n_pre) // (LM_TRACED_TOKENS - 1)} kernels and copies a "
        f"token; largest over the serve: "
        + "; ".join(f"{e.key[:48]} {device_us(e) / 1e3:.3f} ms x{e.count}"
                    for e in top) + f" | {stages} | {lap():.1f} s | {card}")
    del lm, rec_f, calls, groups, q, k, v, res, patches, frames
    return line


def sdpa_call(q, k, v, causal: bool, window: int = 0):
    """One ``scaled_dot_product_attention`` call of the same function (the
    library time beside the kernel's): ``is_causal``, or under a window
    that masks something a boolean (Tq, Tk) mask of the keys each query
    sees."""
    import torch
    sdpa = torch.nn.functional.scaled_dot_product_attention
    Tq, Tk = q.shape[2], k.shape[2]
    if not (causal and window and window < Tq):
        return lambda: sdpa(q, k, v, is_causal=causal, enable_gqa=True)
    i = torch.arange(Tq, device=q.device)[:, None]
    j = torch.arange(Tk, device=q.device)[None, :]
    mask = (i >= j) & (i - j < window)
    return lambda: sdpa(q, k, v, attn_mask=mask, enable_gqa=True)


def ssm_scan_bound(xi, Bm, dt, h0=None):
    """The selective scan's bound: its inputs read once (xi, B, C, dt, A,
    h0) and y and the state written once (fp32) over the memory rate,
    against its operations, each type at its rate: B S di n exponentials
    (one a state element) on the special-function units, and 6 fp32
    operations a state element (dt A, (dt x) B, decay h, the add, h C and
    the sum over n) with B S di products dt x (one a channel, shared by
    its n lanes) at the fp32 rate.  Returns (ms, bound_by, bytes, fp32
    operations, exponentials)."""
    Bb, S, di = xi.shape
    n = Bm.shape[2]
    es = xi.element_size()
    nbytes = (es * (xi.numel() + 2 * Bb * S * n + Bb * S) + 4 * di * n
              + 4 * Bb * S * di + 4 * Bb * di * n * (2 if h0 is not None
                                                      else 1))
    exps = Bb * S * di * n
    ops = 6 * exps + Bb * S * di
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = max(ops / PEAK_FP32_PER_S, exps / PEAK_SFU_PER_S)
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops, exps)


def scan_figures(calls, phase: str, card: str, layers: int,
                 held: Optional[int] = None) -> dict:
    """A ``hybrid`` prefill's captured ``ssm_scan`` calls: each (or
    ``held`` of them, the first and the last layer's among them) against
    its plain version (the final state bit for bit, y within
    ``ssm_scan/cases.py::TOL``), then the first call's inputs timed: the
    call (CUDA events), the kernel alone (``torch.profiler``), the plain
    version, and the bound."""
    import torch
    from repro_torch.kernels.ssm_scan import cases as scan_cases
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
    if len(calls) != layers:
        raise SystemExit(f"FAIL: {phase}: recorder saw {len(calls)} ssm_scan "
                         f"calls, want {layers}")
    errs = []
    which = (range(layers) if held is None else
             sorted({round(i * (layers - 1) / (held - 1))
                     for i in range(held)}))
    with torch.inference_mode():
        for li in which:
            fn, ca, ck = calls[li]
            y, h = fn(*ca, **ck)
            wy, wh = ssm_scan_ref(*ca, **ck)
            ex = scan_cases.within_tol(y, wy)
            if ex > 0 or not torch.equal(h, wh):
                raise SystemExit(
                    f"FAIL: {phase}: ssm_scan differs from plain on layer "
                    f"{li}'s prefill input (y excess {ex:.3g}, state max "
                    f"diff {float((h - wh).abs().max()):.3g})")
            errs.append(float((y - wy).abs().max()))
        fn, ca, ck = calls[0]
        fig = scan_timed(lambda: fn(*ca, **ck), lambda: ssm_scan_ref(
            *ca, **ck), ca, phase, card)
    fig.update(max_abs_err=max(errs), calls=len(calls), held=len(errs))
    return fig


def scan_timed(call, plain, ins, phase: str, card: str,
               reps: int = 20) -> dict:
    """``ssm_scan`` timed on ``ins`` (xi, Bm, Cm, dt, A, h0): the call by
    CUDA events, the kernel alone by ``torch.profiler``, the plain version
    once, and its bound; logged beside the card."""
    xi, Bm, _, dt, _, h0 = (tuple(ins) + (None,))[:6]
    ms = cuda_time_ms(call, reps)
    kern_ms = kernel_device_ms(call, "ssm_scan_kernel", reps, "ssm_scan",
                               required=False)
    plain_ms = cuda_time_ms(plain, 1)
    bound, by, nbytes, ops, exps = ssm_scan_bound(xi, Bm, dt, h0)
    kern = "not measured" if kern_ms is None else f"{kern_ms:.4f} ms"
    log(phase, f"ssm_scan at B={xi.shape[0]}, S={xi.shape[1]}, "
        f"di={xi.shape[2]}, n={Bm.shape[2]}, {xi.dtype} gates"
        f"{', h0' if h0 is not None else ''}: call {ms:.4f} ms, kernel "
        f"{kern} (torch.profiler), plain on card {plain_ms:.2f} ms, bound "
        f"{bound:.5f} ms ({by}: {nbytes} B, {exps} exponentials, {ops} "
        f"fp32 operations); "
        f"{100 * bound / (kern_ms or ms):.1f} % of the bound | {card}")
    return dict(ms=ms, kernel_ms=kern_ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=None,
                shape=dict(xi=list(xi.shape), n=Bm.shape[2]))


#: Phase 28's sizes: the backward at GLM-4 9B's training microbatch (B,
#: Hq, Hkv, T, d), GLM-4 9B at full width cut to ``layers`` of its 40
#: (its weights, gradients and fp32 moments at full depth, ~150 GB, do not
#: fit one card), B 8 x S 4096 in 4 microbatches, the 2-layer fp32
#: cuts card against CPU at a B x S the CPU side runs in seconds, and
#: StarCoder2 7B served on ``serve_layers`` of its 32 layers.
DENSE_TRAIN = dict(
    bwd_shape=(2, 32, 2, 4096, 128), bwd_reps=10, layers=8, lm_batch=8,
    lm_seq=4096, lm_steps=5, cut_layers=2, cut_batch=2, cut_seq=64,
    cut_opt_steps=2, serve_layers=8)


def flash_bwd_bound(q, k, causal: bool = True):
    """The bf16 flash-attention backward's bound: the larger of its bytes
    (q, k, v, o, do and lse read once, dq, dk and dv written once) over the
    memory rate and its five products (S, dP, dV, dK, dQ: 2 d operations a
    seen pair each) at the bf16 tensor-core rate, beside the ~8 fp32
    operations a pair of the softmax's gradient at the fp32 rate.  Returns
    (ms, bound_by, bytes, tensor operations)."""
    Bq, Hq, Tq, d = q.shape
    Tk = k.shape[2]
    pairs = (sum(min(i + 1, Tk) for i in range(Tq)) if causal
             else Tq * Tk) * Bq * Hq
    nbytes = ((4 * q.numel() + 4 * k.numel()) * q.element_size()
              + Bq * Hq * Tq * 4)
    mma = 10 * d * pairs
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = max(mma / PEAK_BF16_PER_S, 8 * pairs / PEAK_FP32_PER_S)
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", nbytes, mma)


def flash_bwd_timed(dev, shape, seed: int, reps: int, phase: str,
                    what: str, card: str, causal: bool = True) -> dict:
    """The flash-attention backward at a training microbatch ``shape`` (B,
    Hq, Hkv, T, d): bf16 (B, H, T, d) views of (B, T, H, d) projections,
    causal or not, against the fp32 plain version row by row and bit for
    bit on a second call; timed (the call by CUDA events, its four kernels
    alone by ``torch.profiler``) beside its bound, the plain version,
    ``scaled_dot_product_attention``'s backward (as causal), and the
    forward with and without its lse.  Returns the JSON line's numbers."""
    import torch
    from repro_torch.kernels.flash_attention import cases as flash_cases
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import (
        attention_lse_ref, flash_attention_bwd_ref)
    Bq, Hq, Hkv, T, d = shape
    gen = torch.Generator(device=dev).manual_seed(seed)

    def view(h):
        return torch.randn((Bq, T, h, d), generator=gen, device=dev,
                           dtype=torch.bfloat16).transpose(1, 2)
    q, k, v, do = view(Hq), view(Hkv), view(Hkv), view(Hq)
    o, lse = flash_ops._forward(q, k, v, causal, True)
    got = flash_ops._backward(q, k, v, o, lse, do, causal)
    again = flash_ops._backward(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    _, want_lse = attention_lse_ref(q, k, v, causal)
    ex = flash_cases.lse_within_tol(lse, want_lse)
    del want_lse
    want = flash_attention_bwd_ref(q, k, v, o, lse, do, causal)
    bwd_err, excesses = 0.0, []
    for name, g, g2, w in zip(("dq", "dk", "dv"), got, again, want):
        exg = flash_cases.bwd_within_tol(g, w, "bfloat16")
        excesses.append(f"{name} {exg:.3g}")
        if ex > 0 or exg > 0 or not torch.equal(g, g2):
            raise SystemExit(f"FAIL: {phase} flash_attention_bwd {name} at "
                             f"{what} training shape: excess {exg:.3g} over "
                             f"flash_attention_bwd_ref (lse {ex:.3g}), or "
                             f"not deterministic")
        bwd_err = max(bwd_err, float((g.float() - w.float()).abs().max()))
    del got, again, want

    def bwd_call():
        return flash_ops._backward(q, k, v, o, lse, do, causal)

    ms = cuda_time_ms(bwd_call, reps)
    # the call's four kernels (the partials' sum runs only where the group
    # is split)
    kern_parts = {key: kernel_device_ms(bwd_call, key, reps,
                                        "flash_attention_bwd",
                                        required=key != "bwd_dkdv_reduce")
                  for key in ("bwd_prep_bf16", "bwd_dkdv_hopper",
                              "bwd_dkdv_reduce", "bwd_dq_hopper")}
    kern_ms = sum(x for x in kern_parts.values() if x is not None)
    plain_ms = cuda_time_ms(
        lambda: flash_attention_bwd_ref(q, k, v, o, lse, do, causal), 1,
        warmup=0)
    fwd_ms = cuda_time_ms(lambda: flash_ops._forward(q, k, v, causal,
                                                     False), 10)
    fwd_lse_ms = cuda_time_ms(lambda: flash_ops._forward(q, k, v, causal,
                                                         True), 10)
    # the yardstick, never used by the port: SDPA's backward alone, its
    # forward's graph kept
    xs = [x.detach().requires_grad_() for x in (q, k, v)]
    out = torch.nn.functional.scaled_dot_product_attention(
        *xs, is_causal=causal, enable_gqa=True)
    lib_ms = cuda_time_ms(lambda: torch.autograd.grad(
        out, xs, do, retain_graph=True), 10)
    del xs, out
    bms, by, bwd_bytes, bwd_mma = flash_bwd_bound(q, k, causal)
    log(phase, f"flash_attention_bwd at {what} training microbatch (B {Bq}, "
        f"Hq {Hq}, Hkv {Hkv}, T {T}, d {d}, "
        f"{'causal' if causal else 'non-causal'}, bf16 views): within "
        f"cases.BWD_TOL of the fp32 plain version row by row (largest "
        f"excess over a row's bound: {', '.join(excesses)}), deterministic, "
        f"max abs err {bwd_err:.4g}; call {ms:.4f} ms, the kernels on the "
        f"card {kern_ms:.4f} ms ("
        + ", ".join(f"{k_} {'not measured' if v_ is None else f'{v_:.4f}'}"
                    for k_, v_ in kern_parts.items())
        + f"; torch.profiler, {kern_ms / bms:.1f}x the bound), plain "
        f"{plain_ms:.3f} ms, scaled_dot_product_attention's backward "
        f"{lib_ms:.4f} ms, bound {bms:.4f} ms ({by}: {bwd_mma} bf16 tensor "
        f"ops, {bwd_bytes} B) | achieved {bwd_mma / kern_ms / 1e9:.1f} "
        f"TFLOP/s | forward {fwd_ms:.4f} ms, with its lse {fwd_lse_ms:.4f} "
        f"ms | {card}")
    del q, k, v, o, lse, do
    return dict(max_abs_err=bwd_err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms, kernel_ms=kern_ms,
                fwd_ms=fwd_ms, fwd_lse_ms=fwd_lse_ms,
                shape=dict(q=[Bq, Hq, T, d], k=[Bq, Hkv, T, d]),
                causal=causal)


def lm_train_on_card(cfg, phase: str, dev, card: str, main_launches: dict,
                     add_check_launches, S: dict) -> list:
    """Phases 28 (b), 29 (c, e) and 30 (c): the attention model ``cfg``
    (bf16, at full width, cut in depth where its full state does not fit
    the card) trained ``S["lm_steps"]`` steps of B ``S["lm_batch"]`` x S
    ``S["lm_seq"]`` in ``cfg.train_microbatches`` microbatches through
    ``lm/train.py``: launches 2 ``flash_attention`` and 1
    ``flash_attention_bwd`` an attention (:func:`attention_calls`) a
    microbatch a step and nothing else, finite losses and gradient norms,
    step walls, tokens/s (a ``vlm`` batch's patch positions counted; an
    ``encdec`` batch's decoder tokens), the MoE balance term, a traced
    step's busy share and largest kernels, peak memory under the card's.
    Returns the losses."""
    import numpy as np
    import torch
    from repro_torch.configs.base import ShapeSpec, get_config
    from repro_torch.data.pipeline import synth_batch
    from repro_torch.kernels import _build
    from repro_torch.lm import train as lm_train
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train import train_loop
    micro = cfg.train_microbatches
    steps = S["lm_steps"]
    full_layers = get_config(cfg.name).num_layers
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    add_check_launches()
    t0 = time.perf_counter()
    res = lm_train.train(cfg, steps, batch=S["lm_batch"], seq=S["lm_seq"],
                         microbatches=micro, ckpt_every=10 ** 6, device=dev,
                         log=None)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    counts = _build.launch_counts()
    _build.reset_launch_counts()
    for n_, c_ in counts.items():
        main_launches[n_] += c_
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(dev).total_memory
    fwd_want = 2 * attention_calls(cfg) * micro * steps
    want_counts = {n_: (fwd_want if n_ == "flash_attention" else
                        fwd_want // 2 if n_ == "flash_attention_bwd" else 0)
                   for n_ in counts}
    if counts != want_counts:
        raise SystemExit(f"FAIL: {phase} {cfg.name} training launched "
                         f"{counts}; want {want_counts} (flash_attention "
                         f"twice an attention a microbatch a step, forward "
                         f"and remat, and flash_attention_bwd once; no "
                         f"other kernel)")
    if not (np.isfinite(res.losses).all()
            and np.isfinite(res.grad_norms).all()):
        raise SystemExit(f"FAIL: {phase} {cfg.name} training: losses "
                         f"{res.losses}, grad norms {res.grad_norms}")
    if peak >= total:
        raise SystemExit(f"FAIL: {phase} {cfg.name} training peak {peak} B "
                         f"past the card's {total} B")
    n_weights = sum(p.numel() for p in res.model.parameters())
    # 6 N D over the weights a token runs through: a MoE token's top k
    # experts of E
    n_active = n_weights
    if cfg.num_experts:
        n_active -= ((cfg.num_experts - cfg.experts_per_token)
                     * (3 if cfg.mlp_act == "swiglu" else 2)
                     * cfg.d_model * cfg.d_ff * cfg.num_layers)
    batch = {key: torch.from_numpy(x).to(dev) for key, x in synth_batch(
        cfg, ShapeSpec("t", S["lm_seq"], S["lm_batch"], "train"),
        99).items()}
    step_fn = train_loop.make_train_step(cfg, opt_mod.OptConfig(), micro)
    traced = {}
    w_tr, d_tr, top = traced_busy(lambda: traced.update(
        m=step_fn(res.model, res.opt_state, batch)[2]), True)
    losses, gnorms, walls = res.losses, res.grad_norms, res.walls
    auxes = res.moe_aux
    traced_aux = float(traced["m"].get("moe_aux", 0.0))
    del res, batch, step_fn, traced
    add_check_launches()
    warm = statistics.median(walls[1:])
    P = cfg.num_patches if cfg.family == "vlm" else 0
    tokens = S["lm_batch"] * (P + S["lm_seq"])
    aux_note = (("; moe_aux (the last microbatch's) " + ", ".join(
        f"{x:.4f}" for x in auxes) + f", traced step {traced_aux:.4f}")
        if cfg.num_experts else "")
    log(phase, f"{cfg.name} at full width"
        + (f" cut to {cfg.num_layers} of its {full_layers} layers"
           if cfg.num_layers != full_layers else ", full depth")
        + f": {n_weights} weights ({n_active} active a token), bf16, B "
        f"{S['lm_batch']} x S {S['lm_seq']}"
        + (f" after {P} patch embeddings" if P else "")
        + (f" against as many frames ({cfg.encoder_layers} encoder layers)"
           if cfg.family == "encdec" else "")
        + f" in {micro} microbatches, {steps} steps through lm/train.py: "
        f"losses " + ", ".join(f"{x:.4f}" for x in losses) + "; grad norms "
        + ", ".join(f"{x:.3f}" for x in gnorms) + aux_note
        + "; step walls " + ", ".join(f"{1e3 * x:.1f}" for x in walls)
        + f" ms (warm median {1e3 * warm:.1f} ms, {tokens / warm:.0f} "
        f"tokens/s, 6 N D = {6 * n_active * tokens / warm / 1e12:.1f} "
        f"TFLOP/s); a traced step {1e3 * w_tr:.1f} ms, device "
        f"{1e3 * d_tr:.1f} ms (busy {100 * d_tr / w_tr:.1f} %); main-path "
        f"launches { {k_: c_ for k_, c_ in counts.items() if c_} }; peak mem "
        f"{peak / 2**30:.3f} GiB of {total / 2**30:.1f}; the run "
        f"{t_run:.1f} s (steps {sum(walls):.1f} s; the rest the draw of the "
        f"weights) | {card}")
    log(phase, f"the traced step's largest: {top}")
    return losses


def lm_train_cut_vs_cpu(arch: str, phase: str, dev, card: str,
                        add_check_launches, S: dict) -> None:
    """Phases 28 (c), 29 (c) and 30 (c): the model ``arch`` at full width
    cut to ``S["cut_layers"]`` layers (an ``encdec`` model's encoder too)
    in fp32 (TF32 off: ``flash_fp32`` and the
    fp32 backward), weights drawn on the card and copied to the CPU: loss,
    every gradient and the parameters after ``S["cut_opt_steps"]`` AdamW
    steps within ``LM_TRAIN_TOL``."""
    import torch
    from repro_torch.configs.base import ShapeSpec, get_config
    from repro_torch.data.pipeline import synth_batch
    from repro_torch.models import api as lm_api
    full = get_config(arch)
    cut = full.replace(num_layers=S["cut_layers"], param_dtype="float32",
                       compute_dtype="float32",
                       encoder_layers=min(full.encoder_layers,
                                          S["cut_layers"]))
    t0 = time.perf_counter()
    card_lm = lm_api.init_params(
        cut, torch.Generator(device=dev).manual_seed(7), device=dev)
    cpu_lm = lm_api.init_params(cut, device="meta").to_empty(device="cpu")
    cpu_lm.load_state_dict(card_lm.state_dict())
    batch = synth_batch(cut, ShapeSpec("t", S["cut_seq"], S["cut_batch"],
                                       "train"), 0)
    errs = lm_train_card_vs_cpu(cut, card_lm, cpu_lm, dev, batch,
                                S["cut_opt_steps"], phase)
    add_check_launches()
    del card_lm, cpu_lm
    log(phase, f"{arch} at full width, {S['cut_layers']} layers, fp32 (TF32 "
        f"off; flash_fp32 and the fp32 backward), group "
        f"{cut.num_heads // cut.num_kv_heads}, B {S['cut_batch']} x S "
        f"{S['cut_seq']}: loss, every gradient and the parameters after "
        f"{S['cut_opt_steps']} AdamW steps card == CPU within "
        f"{LM_TRAIN_TOL}; max err " + ", ".join(
            f"{k_} {v_:.3g}" for k_, v_ in errs.items())
        + f" | {time.perf_counter() - t0:.1f} s | {card}")


def dense_train_phase(dev, card: str, main_launches: dict,
                      add_check_launches, lap) -> dict:
    """Phase 28: dense-transformer training on the card.

    (a) the flash-attention backward kernel (``flash_attn_bwd.cu``) against
    its plain version on ``kernels/flash_attention/cases.py::bwd_cases`` in
    fp32 and bf16 (the forward's lse against ``attention_lse_ref``'s too),
    bit for bit on a second call, and at GLM-4 9B's training microbatch
    (bf16 views of (B, T, H, d)) against the fp32 plain version, timed
    (the call; the kernels alone by ``torch.profiler``) beside its bound,
    the plain version and ``scaled_dot_product_attention``'s backward, and
    the forward with and without its lse; (b) GLM-4 9B at full width cut
    to 8 of its 40 layers, bf16, trained 5 steps through ``lm/train.py``;
    (c) the 2-layer fp32 cuts of GLM-4 and StarCoder2 card against CPU;
    (d) StarCoder2 7B served at full width and depth (phases 19 and 20's
    functions).  Sizes are :data:`DENSE_TRAIN`'s.  Returns the JSON line of
    ``flash_attention_bwd``."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import cases as flash_cases
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import (
        attention_lse_ref, flash_attention_bwd_ref)
    S = DENSE_TRAIN
    names = ("dq", "dk", "dv")
    sync = torch.cuda.synchronize

    # ---- (a) the backward against its plain version ---------------------
    n_cases, lse_err, bf16_excess = 0, 0.0, -1.0
    for case in flash_cases.bwd_cases():
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = flash_cases.bwd_tensors(case, dev, dtype)
            causal, ss = case["causal"], case["score_scale"]
            o, lse = flash_ops._forward(q, k, v, causal, True)
            got = flash_ops._backward(q, k, v, o, lse, do, causal)
            again = flash_ops._backward(q, k, v, o, lse, do, causal)
            want = flash_attention_bwd_ref(q, k, v, o, lse, do, causal)
            _, want_lse = attention_lse_ref(q, k, v, causal)
            sync()
            ex = flash_cases.lse_within_tol(lse, want_lse, ss)
            if ex > 0:
                raise SystemExit(f"FAIL: 28 flash_attention lse differs from"
                                 f" attention_lse_ref on {case['name']} "
                                 f"{dtype} (excess {ex:.3g})")
            lse_err = max(lse_err, float((lse - want_lse).abs().max()))
            dname = str(dtype)[6:]
            for name, g, g2, w in zip(names, got, again, want):
                ex = flash_cases.bwd_within_tol(g, w, dname, ss)
                # x8 scores are held in fp32 only (bwd_cases' docstring)
                held = dtype == torch.float32 or ss == 1.0
                if held and dtype == torch.bfloat16:
                    bf16_excess = max(bf16_excess, ex)
                if (held and ex > 0) or not bool(g.isfinite().all()):
                    raise SystemExit(f"FAIL: 28 flash_attention_bwd {name} "
                                     f"differs from plain on {case['name']}"
                                     f" {dname} (excess {ex:.3g})")
                if not torch.equal(g, g2):
                    raise SystemExit(f"FAIL: 28 flash_attention_bwd {name} "
                                     f"not deterministic on {case['name']} "
                                     f"{dname}")
            n_cases += 1
    add_check_launches()
    log("28 dense train", f"(a) flash_attention_bwd within cases.BWD_TOL of "
        f"flash_attention_bwd_ref and bit for bit on a second call, the "
        f"forward's lse within cases.LSE_ATOL of attention_lse_ref (max err "
        f"{lse_err:.3g}; bf16 rows' largest excess over their bound "
        f"{bf16_excess:.3g}), on {n_cases} cases (d 16-128; groups "
        f"{'/'.join(map(str, flash_cases.BWD_GROUPS))}; causal and not; Tq "
        f"!= Tk; Tk no multiple of a key tile; both layouts; x8 scores held "
        f"in fp32; fp32 and bf16)")

    # GLM-4 9B's training microbatch
    line = flash_bwd_timed(dev, S["bwd_shape"], 28, S["bwd_reps"],
                           "28 dense train (a)", "GLM-4 9B's", card)
    add_check_launches()
    line = dict(name="flash_attention_bwd", route="cuda",
                source="src/repro_torch/kernels/flash_attention/csrc/"
                       "flash_attn_bwd.cu",
                replaces="none: the reference differentiates "
                         "src/repro/models/flash_jnp.py:32 (flash_mha's "
                         "custom VJP, _flash_bwd :85); the forward is "
                         "src/repro/kernels/flash_attention/kernel.py:25",
                **line)
    log("28 dense train", f"(a) phase part {lap():.1f} s")

    # ---- (b) GLM-4 9B at full width, cut in depth, trained ---------------
    lm_train_on_card(get_config("glm4_9b").replace(num_layers=S["layers"]),
                     "28 dense train (b)", dev, card, main_launches,
                     add_check_launches, S)
    log("28 dense train", f"(b) phase part {lap():.1f} s")

    # ---- (c) the 2-layer fp32 cuts, card against CPU -----------------------
    for arch in ("glm4_9b", "starcoder2_7b"):
        lm_train_cut_vs_cpu(arch, "28 dense train (c)", dev, card,
                            add_check_launches, S)
    log("28 dense train", f"(c) phase part {lap():.1f} s")

    # ---- (d) StarCoder2 7B served at full width and depth ------------------
    dense_cut_vs_cpu("starcoder2_7b", "28 dense train (d) fp32", dev, card,
                     add_check_launches, lap)
    # at 8 of its 32 layers: the dense family is served at full depth by
    # GLM-4 (phase 20), and the script's time limit holds phase 29 too
    dense_serve("starcoder2_7b", "28 dense train (d) serve", dev, card,
                main_launches, add_check_launches, lap,
                num_layers=DENSE_TRAIN["serve_layers"])
    return line


#: Phase 29's sizes: the flash backward at Granite-MoE 1B's training
#: microbatch (B, Hq, Hkv, T, d); Granite-MoE trained at full width and
#: depth and Pixtral 12B at full width cut to ``pixtral_layers`` of its 40
#: (its weights, gradients and fp32 moments at full depth, ~196 GB, do
#: not fit one card; on an H100 ``tools/pixtral_train_depth.py`` peaked
#: at 70.8 GiB on 9 layers and 74.4 on 10 of the card's 79.2, a layer
#: adding ~3.6 GiB of bf16 weights, fp32 gradient sums and moments; this
#: script holds ~2.6 GiB more before phase 29, and on 10 layers here the
#: allocator ran out, 69.0 GiB allocated and 5.8 cached), each B 8 x
#: S 4096 (Pixtral's 256 patch embeddings
#: before each row) in 4 microbatches, 5 steps; Granite's 2-layer fp32 cut
#: card against CPU at phase 28's size.
MOE_VLM = dict(bwd_shape=(2, 16, 8, 4096, 64), bwd_reps=10,
               pixtral_layers=9, lm_batch=8, lm_seq=4096, lm_steps=5,
               cut_layers=2, cut_batch=2, cut_seq=64, cut_opt_steps=2)


def shape_figures(line: dict) -> dict:
    """A kernel's figures at one shape, for the JSON line's ``shapes``."""
    return {key: line[key] for key in (
        "shape", "causal", "max_abs_err", "ms", "plain_ms", "bound_ms",
        "bound_by", "library_ms", "kernel_ms") if key in line}


def moe_vlm_phase(dev, card: str, main_launches: dict, add_check_launches,
                  lap):
    """Phase 29: the ``moe`` and ``vlm`` families on the card.

    (a) Granite-MoE 1B at full width cut to 2 layers, fp32, card against
    CPU, its routes held exactly (:func:`dense_cut_vs_cpu`); (b) served at
    full width and depth, bf16 (:func:`dense_serve`, the consistency at
    capacity factor 8); (c) the flash backward at its training
    microbatch, then trained at full width and depth through
    ``lm/train.py`` (:func:`lm_train_on_card`) and its 2-layer fp32 cut's
    training step card against CPU; (d) Pixtral 12B's 2-layer fp32 cut card
    against CPU and its full bf16 serve with 256 patch embeddings before
    each prompt; (e) Pixtral trained at full width, cut in depth.  Sizes
    are :data:`MOE_VLM`'s.  Returns the new shapes' figures for the JSON
    line's ``flash_attention`` and ``flash_attention_bwd`` entries."""
    import torch
    from repro_torch.configs.base import get_config
    S = MOE_VLM
    fa_shapes, bwd_shapes = {}, {}

    # ---- (a) Granite-MoE, 2 layers at full width, fp32, card vs CPU -------
    dense_cut_vs_cpu("granite_moe_1b_a400m", "29 moe (a) fp32", dev, card,
                     add_check_launches, lap)
    # ---- (b) Granite-MoE served at full width and depth --------------------
    fa_shapes["granite_prefill"] = shape_figures(dense_serve(
        "granite_moe_1b_a400m", "29 moe (b) serve", dev, card, main_launches,
        add_check_launches, lap))
    # ---- (c) Granite-MoE trained at full width and depth -------------------
    bwd_shapes["granite_microbatch"] = shape_figures(flash_bwd_timed(
        dev, S["bwd_shape"], 29, S["bwd_reps"], "29 moe (c)",
        "Granite-MoE 1B's", card))
    add_check_launches()
    lm_train_on_card(get_config("granite_moe_1b_a400m"), "29 moe (c) train",
                     dev, card, main_launches, add_check_launches, S)
    lm_train_cut_vs_cpu("granite_moe_1b_a400m", "29 moe (c) fp32 train",
                        dev, card, add_check_launches, S)
    log("29 moe", f"(c) phase part {lap():.1f} s")
    # ---- (d) Pixtral 12B served at full width and depth --------------------
    dense_cut_vs_cpu("pixtral_12b", "29 vlm (d) fp32", dev, card,
                     add_check_launches, lap)
    fa_shapes["pixtral_prefill"] = shape_figures(dense_serve(
        "pixtral_12b", "29 vlm (d) serve", dev, card, main_launches,
        add_check_launches, lap))
    # ---- (e) Pixtral 12B trained at full width, cut in depth ---------------
    torch.cuda.empty_cache()             # the serves' cached blocks
    lm_train_on_card(get_config("pixtral_12b").replace(
        num_layers=S["pixtral_layers"]), "29 vlm (e) train", dev, card,
        main_launches, add_check_launches, S)
    torch.cuda.empty_cache()
    log("29 vlm", f"(e) phase part {lap():.1f} s")
    return fa_shapes, bwd_shapes


#: Phase 30's sizes: Whisper-medium (24 encoder and 24 decoder layers, d
#: 1,024, 16 heads of 64) at full width and depth, which fits one card
#: for serving and training.  ``frames``: a 30-second window after
#: Whisper's stride-2 conv stem (which the reference stubs), 8 segments a
#: serve; ``cut_frames``, the 2-layer fp32 cut's, no multiple of a tile;
#: the flash backward at the training microbatch (B, Hq, Hkv, T, d) of B 8
#: x S 1,500 in 4 microbatches (frames and tokens share S in the
#: reference's pipeline, so the encoder's and the cross-attention's shape
#: is one, non-causal; the decoder's causal); 5 training steps; the 2-layer
#: fp32 cut's training step card against CPU at phase 28's size.
ENCDEC = dict(frames=1500, cut_frames=100, bwd_shape=(2, 16, 16, 1500, 64),
              bwd_reps=10, lm_batch=8, lm_seq=1500, lm_steps=5, cut_layers=2,
              cut_batch=2, cut_seq=64, cut_opt_steps=2)
#: Whisper's start-of-transcript sequence in its multilingual vocabulary of
#: 51,865 tokens: <|startoftranscript|> <|en|> <|transcribe|>
#: <|notimestamps|>, each serve's decoder prompt.
WHISPER_SOT = (50258, 50259, 50359, 50363)


def encdec_phase(dev, card: str, main_launches: dict, add_check_launches,
                 lap):
    """Phase 30: the ``encdec`` family, Whisper-medium, on the card.

    (a) At full width cut to 2 encoder and 2 decoder layers, fp32, card
    against CPU (:func:`dense_cut_vs_cpu`: B 2, a 64-token prompt against
    ``ENCDEC["cut_frames"]`` frames, 4 teacher-forced steps; logits,
    ``kv``, ``xk`` and ``xv``); (b) served at full width and depth, bf16
    (:func:`dense_serve`: ``LM_BATCH`` segments of ``ENCDEC["frames"]``
    frames drawn from a seed, each decoder prompt :data:`WHISPER_SOT`,
    ``LM_TOKENS`` greedy tokens; 72 ``flash_attention`` launches a
    prefill, none in decode, each against its plain version; the encoder's,
    the decoder's and the cross-attention's shapes timed against their
    bounds, plain version and SDPA); (c) the flash backward at the training
    microbatch's non-causal and causal shapes (:func:`flash_bwd_timed`),
    Whisper trained at full width and depth through ``lm/train.py`` (its
    losses must fall) and the 2-layer fp32 cut's training step card
    against CPU.  Sizes are :data:`ENCDEC`'s.  Returns the new shapes'
    figures for the JSON line's ``flash_attention`` and
    ``flash_attention_bwd`` entries."""
    import torch
    from repro_torch.configs.base import get_config
    S = ENCDEC
    arch = "whisper_medium"
    fa_shapes, bwd_shapes = {}, {}

    # ---- (a) 2 + 2 layers at full width, fp32, card vs CPU -----------------
    dense_cut_vs_cpu(arch, "30 encdec (a) fp32", dev, card,
                     add_check_launches, lap)
    # ---- (b) served at full width and depth --------------------------------
    line = dense_serve(arch, "30 encdec (b) serve", dev, card, main_launches,
                       add_check_launches, lap, prompt=WHISPER_SOT)
    for fig in line["shapes"]:
        q, k = fig["shape"]["q"], fig["shape"]["k"]
        role = ("decoder" if fig["causal"] else
                "encoder" if q[2] == k[2] else "cross")
        fa_shapes[f"whisper_{role}"] = shape_figures(fig)
    if set(fa_shapes) != {"whisper_encoder", "whisper_decoder",
                          "whisper_cross"}:
        raise SystemExit(f"FAIL: 30 Whisper's prefill gave flash_attention "
                         f"the shapes {line['shapes']}")
    # ---- (c) trained at full width and depth -------------------------------
    torch.cuda.empty_cache()             # the serve's cached blocks
    for causal, role, what in (
            (False, "encoder_cross", "Whisper-medium's encoder and "
                                     "cross-attention"),
            (True, "decoder", "Whisper-medium's decoder")):
        bwd_shapes[f"whisper_{role}_microbatch"] = shape_figures(
            flash_bwd_timed(dev, S["bwd_shape"], 30, S["bwd_reps"],
                            "30 encdec (c)", what, card, causal=causal))
        add_check_launches()
    losses = lm_train_on_card(get_config(arch), "30 encdec (c) train", dev,
                              card, main_launches, add_check_launches, S)
    if not losses[-1] < losses[0]:
        raise SystemExit(f"FAIL: 30 Whisper-medium's losses did not fall: "
                         f"{losses}")
    torch.cuda.empty_cache()
    lm_train_cut_vs_cpu(arch, "30 encdec (c) fp32 train", dev, card,
                        add_check_launches, S)
    log("30 encdec", f"(c) phase part {lap():.1f} s")
    return fa_shapes, bwd_shapes


#: Phase 31's sizes: the scan timed at Hymba's two serving prefills (B 8 x
#: S 1,024, B 1 x S 10,000), the windowed flash forward at the long one
#: (q (1, 25, 10,000, 64), k and v (1, 5, 10,000, 64), window 4,096), the
#: 2-layer fp32 cut on one prompt of 4,200 tokens (past the window: the
#: ring's roll and the window's mask act) with 4 teacher-forced steps, and
#: the long-context serve (B 1, 10,000 tokens, ``LM_TOKENS`` greedy).
HYBRID = dict(scan_shapes=((8, 1024), (1, 10000)), scan_reps=20,
              flash_long=(1, 25, 5, 10000, 64), flash_reps=10, cut_batch=1,
              cut_prompt=4200, cut_steps=4, long_prompt=10000,
              long_scans_held=2)


def key_tiles(T: int, window: int, tile: int = 128) -> int:
    """The key tiles the bf16 flash kernel's causal items visit at Tq = Tk
    = T by ``flash_attn.cu::item_of``'s schedule, copied here for the log
    (computed, not measured): each 128-row query tile from its first row's
    window, rounded down to a tile, to its diagonal."""
    n = 0
    for q0 in range(0, T, tile):
        tend = -(-min(T, q0 + tile) // tile)
        t0 = min(max(0, q0 - window + 1) // tile, tend - 1) if window else 0
        n += tend - t0
    return n


def hybrid_phase(dev, card: str, main_launches: dict, add_check_launches,
                 lap):
    """Phase 31: the ``hybrid`` family, Hymba 1.5B, served on the card.

    (a) ``ssm_scan`` against its plain version on ``ssm_scan/cases.py``
    (the final state bit for bit, y within ``TOL``; fp32 and bf16 gates),
    then timed at B 8 x S 1,024 and B 1 x S 10,000; (b) the windowed
    flash forward against its plain version on ``window_cases`` (a window
    that masks nothing gives the bits of none), then at the long prefill
    with and without the window beside SDPA with the window's mask; (c)
    the 2-layer fp32 cut card against CPU on a prompt past the window
    (:func:`dense_cut_vs_cpu`: logits, the ring caches and the SSM
    states); (d) the full 32-layer bf16 serve (:func:`dense_serve`: 32
    ``flash_attention`` and 32 ``ssm_scan`` launches a prefill, none in
    decode, every captured input against its plain version); (e) a
    long-context serve through :func:`dense_serve`, B 1, a 10,000-token
    prompt and ``LM_TOKENS`` greedy tokens decoded at positions 10,000 on
    (the ring full, each step overwriting its oldest slot): the counted
    serve's walls, peak memory, launches, its prefill's windowed flash
    inputs (every layer's) and scan inputs (``long_scans_held`` layers')
    against their plain versions, and the consistency of the decode logits
    with a forward over S + 1.  Sizes are
    :data:`HYBRID`'s.  Returns the JSON line's ``ssm_scan`` entry and
    ``flash_attention``'s new shapes."""
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import cases as flash_cases
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.ssm_scan import cases as scan_cases
    from repro_torch.kernels.ssm_scan import ops as scan_ops
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
    Z = HYBRID
    arch = "hymba_1_5b"
    cfg = get_config(arch)
    phase = "31 hybrid"
    t_phase = time.perf_counter()

    # ---- (a) the selective scan against its plain version, then timed -----
    n_cases, scan_err = 0, 0.0
    for case in scan_cases.hard_cases():
        for dtype in (torch.float32, torch.bfloat16):
            ins = scan_cases.tensors(case, dev, dtype)
            with torch.inference_mode():
                y, h = scan_ops.ssm_scan(*ins)
                wy, wh = ssm_scan_ref(*ins)
            torch.cuda.synchronize()
            ex = scan_cases.within_tol(y, wy)
            if (ex > 0 or not torch.equal(h, wh)
                    or not bool(y.isfinite().all())):
                raise SystemExit(
                    f"FAIL: ssm_scan differs from plain on {case['name']} "
                    f"{str(dtype)[6:]} (y excess {ex:.3g}, state max diff "
                    f"{float((h - wh).abs().max()):.3g})")
            scan_err = max(scan_err, float((y - wy).abs().max()))
            n_cases += 1
    add_check_launches()
    log(phase, f"(a) ssm_scan: the final state equal to plain bit for bit "
        f"and y within cases.TOL {scan_cases.TOL} on {n_cases} cases (S "
        f"{'/'.join(map(str, scan_cases.LENGTHS))}, di up to 1600, n 8 and "
        f"16, B 1/3/8, with and without h0, strong decays; fp32 and bf16 "
        f"gates), max abs err of y {scan_err:.3g} | {card}")
    scan_shapes = {}
    for i, (Bq, Sq) in enumerate(Z["scan_shapes"]):
        case = scan_cases.make_case(Bq, Sq, cfg.d_model, cfg.ssm_state,
                                    seed=3100 + i)
        ins = scan_cases.tensors(case, dev, torch.bfloat16)
        del case
        with torch.inference_mode():
            y, h = scan_ops.ssm_scan(*ins)
            wy, wh = ssm_scan_ref(*ins)
            ex = scan_cases.within_tol(y, wy)
            if ex > 0 or not torch.equal(h, wh):
                raise SystemExit(f"FAIL: ssm_scan differs from plain at B "
                                 f"{Bq} x S {Sq} (y excess {ex:.3g})")
            fig = scan_timed(lambda: scan_ops.ssm_scan(*ins),
                             lambda: ssm_scan_ref(*ins), ins,
                             f"{phase} (a)", card, Z["scan_reps"])
        fig["max_abs_err"] = float((y - wy).abs().max())
        scan_shapes[f"hymba_B{Bq}_S{Sq}"] = fig
        del ins, y, h, wy, wh
    add_check_launches()
    log(phase, f"(a) phase part {lap():.1f} s")

    # ---- (b) the windowed flash forward ------------------------------------
    n_cases, fa_err = 0, 0.0
    for case in flash_cases.window_cases():
        w = case["window"]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = flash_cases.tensors(case, dev, dtype)
            o = flash_ops.flash_attention(q, k, v, True, w)
            want = attention_ref(q, k, v, True, w)
            torch.cuda.synchronize()
            dname = str(dtype)[6:]
            ex = flash_cases.within_tol(o, want, dname)
            bad = ex > 0 or not bool(o.isfinite().all())
            if case.get("same_as_none"):
                bad |= not torch.equal(o, flash_ops.flash_attention(
                    q, k, v, True))
            dead = k.shape[2] + w - 1
            if q.shape[2] > dead:
                bad |= not bool((o[:, :, dead:] == 0).all())
            if bad:
                raise SystemExit(f"FAIL: windowed flash_attention differs "
                                 f"from plain on {case['name']} {dname} "
                                 f"(excess {ex:.3g})")
            fa_err = max(fa_err, float((o.float() - want.float()).abs()
                                       .max()))
            n_cases += 1
    add_check_launches()
    log(phase, f"(b) flash_attention with a window: within cases.TOL of "
        f"plain on {n_cases} cases (windows "
        f"{'/'.join(map(str, flash_cases.WINDOWS))} and >= Tk, group 5, d "
        f"32 and 64, T 333 and 4,200, rows that see no key; fp32 and bf16); "
        f"a window >= Tk gives the bits of none; max abs err {fa_err:.3g} "
        f"| {card}")
    Bq, Hq, Hkv, T, d = Z["flash_long"]
    rs = np.random.RandomState(31)

    def bthd(H):           # (B, H, T, d) views of (B, T, H, d), as the model
        return torch.from_numpy(rs.normal(size=(Bq, T, H, d)).astype(
            np.float32)).to(dev, torch.bfloat16).transpose(1, 2)
    q, k, v = bthd(Hq), bthd(Hkv), bthd(Hkv)
    fa_shapes = {}
    all_tiles = key_tiles(T, 0)
    for w in (cfg.sliding_window, 0):
        def call(w=w):
            return flash_ops.flash_attention(q, k, v, True, w)
        o = call()
        want = attention_ref(q, k, v, True, w)
        ex = flash_cases.within_tol(o, want, "bfloat16")
        if ex > 0:
            raise SystemExit(f"FAIL: flash_attention differs from plain at "
                             f"the long prefill, window {w} (excess "
                             f"{ex:.3g})")
        err = float((o.float() - want.float()).abs().max())
        del o, want
        ms = cuda_time_ms(call, Z["flash_reps"])
        kern_ms = kernel_device_ms(call, "flash_hopper", Z["flash_reps"],
                                   "flash_attention", required=False)
        plain_ms = cuda_time_ms(lambda: attention_ref(q, k, v, True, w), 1)
        torch.cuda.empty_cache()
        lib = sdpa_call(q, k, v, True, w)
        lib_ms = cuda_time_ms(lib, Z["flash_reps"])
        bound, by, nbytes, mma, fp32 = flash_fwd_bound(q, k, True, w)
        tiles = key_tiles(T, w)
        fa_shapes["hymba_long" + ("_window" if w else "_causal")] = dict(
            shape=dict(q=list(q.shape), k=list(k.shape)), causal=True,
            window=w, max_abs_err=err, ms=ms, kernel_ms=kern_ms,
            plain_ms=plain_ms, bound_ms=bound, bound_by=by,
            library_ms=lib_ms)
        kern = "not measured" if kern_ms is None else f"{kern_ms:.4f} ms"
        log(phase, f"(b) flash_attention at q {tuple(q.shape)}, k, v "
            f"{tuple(k.shape)}, causal, bf16, "
            + (f"window {w}" if w else "no window")
            + f": call {ms:.4f} ms, kernel {kern} (torch.profiler), plain "
            f"{plain_ms:.2f} ms, scaled_dot_product_attention("
            + ("the window's boolean mask" if w else "is_causal")
            + f") {lib_ms:.4f} ms, bound {bound:.5f} ms ({by}: {nbytes} B, "
            f"{mma} bf16 tensor ops, {fp32} fp32 ops), {tiles} key tiles "
            f"a walk by item_of's schedule ({tiles / all_tiles:.3f} of the "
            f"causal walk's {all_tiles}; computed, not measured); "
            f"{100 * bound / (kern_ms or ms):.1f} % of the "
            f"bound | {card}")
        del lib
    del q, k, v
    torch.cuda.empty_cache()
    add_check_launches()
    log(phase, f"(b) phase part {lap():.1f} s")

    # ---- (c) 2 layers at full width, fp32, card vs CPU, past the window ---
    dense_cut_vs_cpu(arch, f"{phase} (c) fp32", dev, card,
                     add_check_launches, lap, batch=Z["cut_batch"],
                     prompt=Z["cut_prompt"], steps=Z["cut_steps"])
    torch.cuda.empty_cache()

    # ---- (d) served at full width and depth --------------------------------
    line = dense_serve(arch, f"{phase} (d) serve", dev, card, main_launches,
                       add_check_launches, lap)
    scan_main = line.pop("scan")
    fa_shapes["hymba_prefill"] = dict(shape_figures(line),
                                      window=cfg.sliding_window)
    torch.cuda.empty_cache()

    # ---- (e) a long-context serve -------------------------------------------
    S = Z["long_prompt"]
    line = dense_serve(arch, f"{phase} (e) long serve", dev, card,
                       main_launches, add_check_launches, lap, batch=1,
                       prompt_len=S, repeats=False,
                       scans_held=Z["long_scans_held"])
    scan_long = line.pop("scan")
    fa_shapes["hymba_long_serve"] = dict(shape_figures(line),
                                         window=cfg.sliding_window)
    torch.cuda.empty_cache()
    log(phase, f"(e) B=1, a {S}-token prompt: {LM_TOKENS} greedy tokens "
        f"at positions {S}-{S + LM_TOKENS - 2} (ring slots "
        f"{S % cfg.sliding_window}-"
        f"{(S + LM_TOKENS - 2) % cfg.sliding_window} of "
        f"{cfg.sliding_window}, each step overwriting the oldest key); the "
        f"prefill's {cfg.num_layers} windowed flash_attention inputs and "
        f"{scan_long['held']} of its "
        f"{scan_long['calls']} ssm_scan inputs held against their plain "
        f"versions; phase 31 {time.perf_counter() - t_phase:.1f} s")

    scan_line = dict(
        name="ssm_scan", route="cuda",
        source="src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu",
        replaces="src/repro/models/ssm.py:47",
        max_abs_err=max(scan_err, scan_main["max_abs_err"],
                        scan_long["max_abs_err"],
                        *(f["max_abs_err"] for f in scan_shapes.values())),
        **{key: scan_main[key] for key in (
            "ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "shape")},
        shapes=dict(scan_shapes, hymba_long_serve=scan_long))
    return scan_line, fa_shapes


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
    for d in flash_ops.WIDTHS:
        c = flash_ops.bwd_kernel_config(d)
        log("2 build", f"flash_attention_bwd bf16 at d {d}: bwd_dkdv_hopper "
            f"and bwd_dq_hopper, {c['threads']} threads a CTA (a producer "
            f"warpgroup at {c['producer_regs']} registers a thread, two "
            f"consumer warpgroups at {c['consumer_regs']}, by setmaxnreg); "
            f"dk/dv {c['keys']} keys a CTA, {c['dkdv_smem_bytes']} B dynamic "
            f"shared memory; dq {c['rows']} query rows a CTA, "
            f"{c['dq_smem_bytes']} B; {c['stages']} ring stages")
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
    traced = traced_serves(lambda n_tok: serve(lm, prompts, n_tok))
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
        f"{LM_TRACED_TOKENS - 1} decode steps, traced wall "
        f"{1e3 * (w_all - w_pre):.3f} ms, device time "
        f"{1e3 * (d_all - d_pre):.3f} ms (busy "
        f"{100 * (d_all - d_pre) / (w_all - w_pre):.1f} %), "
        f"{(n_all - n_pre) // (LM_TRACED_TOKENS - 1)} kernels and copies a "
        f"token; largest over the serve: "
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
    dense_cut_vs_cpu("glm4_9b", "19 glm4 fp32", cuda, card,
                     add_check_launches, lap)

    # ---- 20. GLM-4 9B serving at full width -------------------------------
    lines.append(dense_serve("glm4_9b", "20 glm4 serve", cuda, card,
                             main_launches, add_check_launches, lap))

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

    # ---- 27. training on the card ------------------------------------------
    lines.append(train_phase(cuda, card, main_launches, add_check_launches,
                             lap))

    # ---- 28. dense-transformer training on the card -----------------------
    lines.append(dense_train_phase(cuda, card, main_launches,
                                   add_check_launches, lap))

    # ---- 29. the MoE and VLM families ---------------------------------------
    fa_shapes, bwd_shapes = moe_vlm_phase(cuda, card, main_launches,
                                          add_check_launches, lap)

    # ---- 30. the encoder-decoder family -------------------------------------
    fa_more, bwd_more = encdec_phase(cuda, card, main_launches,
                                     add_check_launches, lap)

    # ---- 31. the hybrid family ------------------------------------------------
    scan_line, fa_hybrid = hybrid_phase(cuda, card, main_launches,
                                        add_check_launches, lap)
    lines.append(scan_line)
    by_name = {line["name"]: line for line in lines}
    by_name["flash_attention"]["shapes"] = dict(fa_shapes, **fa_more,
                                                **fa_hybrid)
    by_name["flash_attention_bwd"]["shapes"] = dict(bwd_shapes, **bwd_more)

    # ---- 32. result -------------------------------------------------------
    # launches on every main path (phases 8, 13, 17, 20, 21, 22, 23, 24, 25,
    # 26, 27, 28, 29, 30 and 31) and in the checks
    log("32 result", f"whole script {time.perf_counter() - t_start:.1f} s")
    for line in lines:
        line["launches"] = main_launches[line["name"]]
        line["check_launches"] = check_launches[line["name"]]
    print(json.dumps({"kernels": lines}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": n_dev}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
