"""Collision-serving harness: N concurrent planner clients, one engine.

Counterpart of ``repro.launch.serve``, with its flags plus ``--device``
(default ``cuda``; the engine runs on the card unless asked for the CPU).
The requests come from an explicit ``torch.Generator`` seeded by
``seed`` (JAX's keys cannot be matched, so a report agrees with the
reference's in its fields and contract, not its values), or, with
``obbs=``, are consecutive slices of a given OBB set.

The service stack (DESIGN.md §6): each synthetic client is a closed-loop
planner issuing small query sets (``plan_queries`` over a handful of link
OBBs); a :class:`repro_torch.engine.batcher.RequestBatcher` coalesces whatever
is in flight into single engine launches — optionally sharded over the
device mesh (``--shards``) — and each client blocks on its ticket.  The
harness reports the SLO quantities (:data:`SLO_METRICS`): client-observed
p50/p99 latency and sustained queries/sec, plus batching effectiveness
and the reliability counters (:data:`RELIABILITY_METRICS`, DESIGN.md §7).

  PYTHONPATH=src python -m repro_torch.launch.serve --clients 8 --requests 32
  ... --shards 4          # shard the coalesced pool over 4 devices
  ... --chaos             # inject faults; the SLO table must degrade
                          # gracefully: shed/retried/deadline-missed are
                          # counted, no ticket hangs, nothing is dropped

Chaos mode wraps the engine in :class:`repro_torch.engine.faults.FaultyEngine`
(malformed plans, engine exceptions, launch stalls, simulated OOM at the
``FaultPlan`` rates) and runs every client with a deadline and a launch
timeout; every submit must still resolve — to a verdict or a typed
error — which the harness asserts by accounting for all of them.
"""
from __future__ import annotations

import argparse
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.device import DEFAULT_DEVICE
from repro_torch.core.geometry import OBBs, random_obbs
from repro_torch.core.octree import Octree, build_octree
from repro_torch.engine.batcher import (RequestBatcher, RequestStats,
                                        ServiceError, _pad_bucket)
from repro_torch.engine.executor import CollisionEngine, EngineConfig
from repro_torch.engine.faults import FaultPlan, FaultyEngine, poison_obbs
from repro_torch.engine.plan import PlanValidationError, plan_queries

#: SLO quantities the harness reports (drift-guarded against the
#: DESIGN.md §6 SLO table): client-observed latency percentiles over
#: ``total_s`` (admission wait + shared engine call) and sustained
#: throughput over the timed window.
SLO_METRICS = ("p50_ms", "p99_ms", "qps")

#: Reliability counters in every report (drift-guarded against the
#: DESIGN.md §7 reliability table): requests shed at admission, transient
#: launch retries, pre-launch deadline kills, bisect-retry splits,
#: watchdog worker restarts, device-loss re-shard relaunches and the
#: shard devices lost to them, elastic shard-width rescales, and
#: launches served in declared degraded mode.  All zero on a healthy,
#: unloaded run.
RELIABILITY_METRICS = ("rejected", "retried", "deadline_missed",
                       "launch_splits", "worker_restarts", "reshards",
                       "shards_lost", "shard_rescales",
                       "degraded_launches")


def run_service(octree: Octree, *, clients: int = 8, requests: int = 32,
                queries_per_request: int = 12, max_batch: int = 1024,
                max_wait_ms: float = 2.0, mode: str = "wavefront_fused",
                shards: Optional[int] = None, seed: int = 0,
                engine: Optional[CollisionEngine] = None,
                deadline_ms: Optional[float] = None,
                max_queue: int = 4096,
                launch_timeout_s: Optional[float] = None,
                max_retries: int = 2,
                max_queue_work: Optional[int] = None,
                degrade_queue: Optional[int] = None,
                degraded_max_depth: Optional[int] = None,
                autoscale_shards: bool = False,
                target_p99_ms: Optional[float] = None,
                chaos: Optional[FaultPlan] = None,
                device=DEFAULT_DEVICE,
                obbs: Optional[OBBs] = None) -> dict:
    """Drive ``clients`` closed-loop clients, ``requests`` requests each.

    Every request is ``queries_per_request`` random OBBs against the bound
    scene, drawn from ``torch.Generator().manual_seed(seed)``; with
    ``obbs`` given, request ``i`` is instead its OBBs ``[i * q, (i + 1) *
    q)`` (``q = queries_per_request``, wrapping around the set).  The
    engine is built on ``device`` unless ``engine`` is given.  Returns a
    report dict: the :data:`SLO_METRICS` quantities over
    the requests that completed, requests/sec, batching effectiveness
    (mean requests and live queries per launch, pad fraction), the
    :data:`RELIABILITY_METRICS` counters, a per-error-type breakdown of
    failed requests, and the aggregate engine counters; besides the
    reference's keys, ``verdicts`` (each submitted request's verdicts, in
    submit order, None where it failed) and ``injected`` (the chaos
    engine's injection counts, empty without ``chaos``).

    With ``chaos`` set, the engine is wrapped in a
    :class:`repro_torch.engine.faults.FaultyEngine` and each client corrupts a
    ``malformed_rate`` fraction of its own requests pre-submit; the
    harness asserts that EVERY submitted request resolved (verdict or
    typed error) — a hung or silently dropped ticket fails the run.
    """
    if engine is None:
        engine = CollisionEngine(octree, EngineConfig(mode=mode,
                                                      shards=shards),
                                 device=device)
    # Pre-generate every request's OBBs so the timed window measures the
    # service, not the client-side random number generation.
    n_sub = clients * requests
    if obbs is None:
        gen = torch.Generator().manual_seed(seed)
        reqs = [random_obbs(gen, queries_per_request) for _ in range(n_sub)]
    else:
        q = queries_per_request
        reqs = []
        for i in range(n_sub):
            idx = torch.arange(i * q, (i + 1) * q) % obbs.n
            reqs.append(OBBs(center=obbs.center[idx], half=obbs.half[idx],
                             rot=obbs.rot[idx]))
    stats: List[List[RequestStats]] = [[] for _ in range(clients)]
    verdicts: List[Optional[np.ndarray]] = [None] * n_sub
    #: error-type name -> count, over every request that resolved typed.
    failures: dict = {}
    fail_lock = threading.Lock()
    errors: List[BaseException] = []

    # Warm up outside the timed window: the batcher pads every pool to a
    # pow2 bucket, so pre-executing one pool per bucket width the
    # coalesced launches can hit keeps the kernels' first build and each
    # width's capacity ladder out of the latency percentiles.  Warmup
    # runs on the INNER engine so chaos injection rates apply only to the
    # timed window.
    top = _pad_bucket(min(max(clients * requests, 1) * queries_per_request,
                          max_batch + queries_per_request))
    width = _pad_bucket(1)
    while width <= top:
        engine.execute(plan_queries(
            random_obbs(torch.Generator().manual_seed(seed + 1), width)))
        width <<= 1

    served = FaultyEngine(engine, chaos) if chaos is not None else engine

    def tally(e: BaseException) -> None:
        with fail_lock:
            failures[type(e).__name__] = \
                failures.get(type(e).__name__, 0) + 1

    with RequestBatcher(served, max_batch=max_batch,
                        max_wait_ms=max_wait_ms, max_queue=max_queue,
                        launch_timeout_s=launch_timeout_s,
                        max_retries=max_retries,
                        max_queue_work=max_queue_work,
                        degrade_queue=degrade_queue,
                        degraded_max_depth=degraded_max_depth,
                        autoscale_shards=autoscale_shards,
                        target_p99_ms=target_p99_ms) as batcher:
        batcher.submit(plan_queries(reqs[0])).result(timeout=600)
        launches0 = batcher.num_launches

        def client(ci: int):
            try:
                for ri in range(requests):
                    req = reqs[ci * requests + ri]
                    if chaos is not None:
                        kind = chaos.draw_malformed()
                        if kind is not None:
                            req = poison_obbs(req, kind)
                    try:
                        ticket = batcher.submit(plan_queries(req),
                                                deadline_ms=deadline_ms)
                        v, st = ticket.result(timeout=600)
                        stats[ci].append(st)
                        verdicts[ci * requests + ri] = v
                    except (ServiceError, PlanValidationError) as e:
                        if chaos is None:
                            raise        # healthy runs tolerate nothing
                        tally(e)
                    except RuntimeError as e:
                        if chaos is None:
                            raise
                        tally(e)         # injected engine faults
            except BaseException as e:              # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=client, args=(ci,))
                   for ci in range(clients)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        totals = batcher.totals
        launches = batcher.num_launches - launches0
    if errors:
        raise errors[0]

    flat = [s for per_client in stats for s in per_client]
    n_ok = len(flat)
    n_failed = sum(failures.values())
    # The §7 no-lost-tickets contract: every request either completed or
    # resolved to a typed error the client saw.
    assert n_ok + n_failed == n_sub, \
        f"{n_sub - n_ok - n_failed} requests vanished (hung or dropped)"
    lat_ms = np.asarray([s.total_s for s in flat]) * 1e3
    n_q = n_ok * queries_per_request
    return {
        "p50_ms": float(np.percentile(lat_ms, 50)) if n_ok else float("nan"),
        "p99_ms": float(np.percentile(lat_ms, 99)) if n_ok else float("nan"),
        "qps": n_q / wall,
        "rps": n_ok / wall,
        "wall_s": wall,
        "clients": clients,
        "submitted": n_sub,
        "requests": n_ok,
        "failed": n_failed,
        "failures": dict(failures),
        "queries": n_q,
        "launches": launches,
        "mean_requests_per_launch": float(np.mean(
            [s.batch_requests for s in flat])) if n_ok else 0.0,
        "mean_live_queries_per_launch": n_q / max(launches, 1),
        "pad_fraction": totals.pad_queries / max(totals.num_queries, 1),
        "rejected": totals.rejected,
        "retried": totals.retried,
        "deadline_missed": totals.deadline_missed,
        "launch_splits": totals.launch_splits,
        "worker_restarts": totals.worker_restarts,
        "reshards": totals.reshards,
        "shards_lost": totals.shards_lost,
        "shard_rescales": totals.shard_rescales,
        "degraded_launches": totals.degraded_launches,
        "degraded_requests": sum(1 for s in flat if s.degraded),
        "counters": totals,
        "verdicts": verdicts,
        "injected": dict(served.injected) if chaos is not None else {},
    }


def default_fault_plan(seed: int = 0) -> FaultPlan:
    """The ``--chaos`` rates: every §7 failure mode fires on a smoke-sized
    run, while most launches stay healthy so the SLO percentiles remain
    meaningful.  ``device_loss_rate`` only bites on sharded engines (the
    injector seam lives inside ``_exec_sharded``); single-device chaos
    runs simply never draw it."""
    return FaultPlan(malformed_rate=0.08, exception_rate=0.06,
                     oom_rate=0.05, stall_rate=0.02, crash_rate=0.01,
                     device_loss_rate=0.03, stall_s=2.5, seed=seed)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=20000)
    ap.add_argument("--depth", type=int, default=5)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--requests", type=int, default=32,
                    help="requests per client")
    ap.add_argument("--queries", type=int, default=12,
                    help="query OBBs per request")
    ap.add_argument("--max-batch", type=int, default=1024)
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--mode", default="wavefront_fused")
    ap.add_argument("--shards", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="where the engine runs: cuda (default) or cpu")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request latency budget (typed rejection)")
    ap.add_argument("--launch-timeout-s", type=float, default=None,
                    help="liveness bound on one engine call")
    ap.add_argument("--chaos", action="store_true",
                    help="inject faults (FaultPlan) and report graceful "
                         "degradation; implies a deadline and launch "
                         "timeout unless given explicitly")
    ap.add_argument("--max-queue-work", type=int, default=None,
                    help="work-based admission cap: shed when queued "
                         "scene_nodes x queries would exceed this")
    ap.add_argument("--degrade-queue", type=int, default=None,
                    help="queue depth past which launches run in declared "
                         "degraded mode instead of shedding")
    ap.add_argument("--degraded-max-depth", type=int, default=None,
                    help="traversal depth cap used by degraded launches "
                         "(default: scene depth - 1)")
    ap.add_argument("--autoscale", action="store_true",
                    help="let the batcher rescale EngineConfig.shards "
                         "between launches (sharded engines only)")
    ap.add_argument("--target-p99-ms", type=float, default=None,
                    help="latency SLO the autoscaler steers toward")
    ap.add_argument("--soak-s", type=float, default=None,
                    help="repeat the whole run (fresh seed each pass) "
                         "until this much wall time has elapsed; reports "
                         "aggregate per-pass reliability counters")
    args = ap.parse_args()
    deadline_ms = args.deadline_ms
    launch_timeout_s = args.launch_timeout_s
    if args.chaos:
        if deadline_ms is None:
            deadline_ms = 2000.0
        if launch_timeout_s is None:
            launch_timeout_s = 1.0

    rs = np.random.RandomState(args.seed)
    pts = rs.uniform(-1, 1, (args.points, 3)).astype(np.float32)
    tree = build_octree(pts, depth=args.depth)

    # --soak-s repeats the whole closed-loop run (fresh seed per pass, so
    # the chaos draw sequence differs) until the wall clock budget runs
    # out — the CI soak profile drives device-loss recovery through many
    # re-shard cycles instead of the one-shot PR smoke.
    t_start = time.perf_counter()
    passes = 0
    while True:
        seed = args.seed + passes
        chaos = default_fault_plan(seed) if args.chaos else None
        rep = run_service(
            tree, clients=args.clients, requests=args.requests,
            queries_per_request=args.queries, max_batch=args.max_batch,
            max_wait_ms=args.max_wait_ms, mode=args.mode,
            shards=args.shards, seed=seed, deadline_ms=deadline_ms,
            launch_timeout_s=launch_timeout_s,
            max_queue_work=args.max_queue_work,
            degrade_queue=args.degrade_queue,
            degraded_max_depth=args.degraded_max_depth,
            autoscale_shards=args.autoscale,
            target_p99_ms=args.target_p99_ms, chaos=chaos,
            device=args.device)
        passes += 1
        if args.soak_s is not None:
            print(f"--- soak pass {passes} "
                  f"({time.perf_counter() - t_start:.1f}s elapsed) ---")
        _print_report(rep)
        if args.soak_s is None or \
                time.perf_counter() - t_start >= args.soak_s:
            break
    if args.soak_s is not None:
        print(f"soak: {passes} passes, every submit resolved, "
              f"{time.perf_counter() - t_start:.1f}s total")


def _print_report(rep: dict) -> None:
    print(f"served {rep['requests']}/{rep['submitted']} requests "
          f"/ {rep['queries']} queries from {rep['clients']} clients "
          f"in {rep['wall_s']:.2f}s")
    print(f"latency p50 {rep['p50_ms']:.2f} ms  p99 {rep['p99_ms']:.2f} ms")
    print(f"throughput {rep['qps']:.0f} queries/s  {rep['rps']:.0f} req/s")
    print(f"batching: {rep['launches']} launches, "
          f"{rep['mean_requests_per_launch']:.1f} req/launch, "
          f"pad fraction {rep['pad_fraction']:.2f}")
    print(f"reliability: rejected {rep['rejected']}  "
          f"retried {rep['retried']}  "
          f"deadline_missed {rep['deadline_missed']}  "
          f"launch_splits {rep['launch_splits']}  "
          f"worker_restarts {rep['worker_restarts']}  "
          f"reshards {rep['reshards']}  "
          f"shards_lost {rep['shards_lost']}  "
          f"shard_rescales {rep['shard_rescales']}  "
          f"degraded_launches {rep['degraded_launches']}")
    if rep["degraded_requests"]:
        print(f"degraded (declared, conservative-superset verdicts): "
              f"{rep['degraded_requests']} requests")
    if rep["failed"]:
        kinds = ", ".join(f"{k}={v}" for k, v in
                          sorted(rep["failures"].items()))
        print(f"failed typed (no hangs, no drops): {rep['failed']} "
              f"[{kinds}]")


if __name__ == "__main__":
    main()
