"""Port parity: the collision service on the CPU -- sharded execution,
continuous batching, the serve harness -- against the JAX reference.

Sharded results are held against the port's single-device engine, which
is held against the reference's single-device engine on the same numpy
pool (the reference's own sharded path fails on the installed jax,
ROADMAP C.1).  A list that repeats ``"cpu"`` stands in for the
reference's eight virtual CPU devices.  Every wait on a ticket or a
thread is bounded, and no latency is used as an oracle.
"""
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import geometry as jgeo
from repro.core import octree as joct
from repro.engine import executor as jexe
from repro_torch.convert import octree_from_reference
from repro_torch.core.geometry import OBBs, rotation_from_euler
from repro_torch.core.octree import build_octree
from repro_torch.engine import plan as tplan
from repro_torch.engine.batcher import RequestBatcher, _pad_bucket
from repro_torch.engine.executor import (DEPTH_CAP_MODES, CollisionEngine,
                                         EngineConfig, traversal_cache_info)
from repro_torch.kernels import _build
from repro_torch.kernels.compact import ops as compact_ops

torch.set_num_threads(1)

MODES3 = ("wavefront", "wavefront_fused", "wavefront_persistent")
CPU8 = ["cpu"] * 8
#: The reference's arm each mode is held against (run under
#: ``jax.disable_jit()``); the persistent mode against its kernel arm.
REF_ARMS = {"wavefront": {}, "wavefront_fused": {},
            "wavefront_persistent": dict(use_pallas_traverse=True,
                                         stream_meta=False,
                                         meta_format="fp32")}
WAIT = 60     # seconds: every ticket and join is bounded


def _tree(seed, n=3000, depth=4):
    rs = np.random.RandomState(seed)
    return build_octree(rs.uniform(-1, 1, (n, 3)).astype(np.float32),
                        depth=depth)


def _arrays(n, seed, lo=0.01, hi=0.08):
    """OBBs as numpy arrays, some of them past the scene, so that verdicts
    are mixed."""
    rs = np.random.RandomState(seed)
    c = rs.uniform(-1.4, 1.4, (n, 3)).astype(np.float32)
    h = rs.uniform(lo, hi, (n, 3)).astype(np.float32)
    rot = rotation_from_euler(torch.from_numpy(
        rs.uniform(-3, 3, (n, 3)).astype(np.float32))).numpy()
    return [c, h, rot]


def _obbs(n, seed, **kw):
    return OBBs(*(torch.from_numpy(x) for x in _arrays(n, seed, **kw)))


def _run_threads(threads):
    """Start ``threads``, join each with a bound, and check that each ended."""
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT)
        assert not t.is_alive(), f"{t.name} still running after {WAIT} s"


def _assert_counters_equal(c0, c1, ctx, skip=()):
    d0, d1 = c0.as_dict(), c1.as_dict()
    for k in d0:
        if k in ("wall_time_s", "pad_queries") + tuple(skip):
            continue
        assert d0[k] == d1[k], (ctx, k, d0[k], d1[k])


@pytest.fixture(scope="module")
def scene():
    rs = np.random.RandomState(0)
    jtree = joct.build_octree(rs.uniform(-1, 1, (3000, 3)).astype(
        np.float32), depth=4)
    return jtree, octree_from_reference(jtree)


# ---------------------------------------------------------------------------
# The reference's tuples and exports
# ---------------------------------------------------------------------------

def test_service_tuples_equal_reference():
    from repro.engine import batcher as jb, faults as jf
    from repro.launch import serve as js
    from repro_torch.engine import batcher as tb, faults as tf
    from repro_torch.launch import serve as ts
    assert tb.ADMISSION_KNOBS == jb.ADMISSION_KNOBS
    assert tb.TICKET_STATES == jb.TICKET_STATES
    assert tf.FAILURE_MODES == jf.FAILURE_MODES
    assert tf.POISON_KINDS == jf.POISON_KINDS
    assert ts.SLO_METRICS == js.SLO_METRICS
    assert ts.RELIABILITY_METRICS == js.RELIABILITY_METRICS


def test_engine_exports_typed_service_errors():
    import repro_torch.engine as E
    for name in ("ServiceError", "Overloaded", "DeadlineExceeded",
                 "LaunchStalled", "WorkerDied", "BatcherClosed",
                 "DeviceLost", "RequestBatcher", "RequestStats",
                 "DEPTH_CAP_MODES"):
        assert name in E.__all__ and hasattr(E, name), name
    for err in (E.Overloaded, E.DeadlineExceeded, E.LaunchStalled,
                E.WorkerDied, E.BatcherClosed, E.DeviceLost):
        assert issubclass(err, E.ServiceError)
    assert not issubclass(E.ServiceError, ValueError)


# ---------------------------------------------------------------------------
# Sharded execution
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES3)
def test_single_device_engine_matches_reference(scene, mode):
    """The single-device engine that the sharded runs are held against
    equals the reference's on the same numpy pool, bit for bit."""
    jtree, ttree = scene
    a = _arrays(101, 1)
    with jax.disable_jit():
        want = jexe.CollisionEngine(jtree, jexe.EngineConfig(
            mode=mode, frontier_capacity=4096, **REF_ARMS[mode])).query(
                jgeo.OBBs(*map(jnp.asarray, a)))
    v, c = CollisionEngine(ttree, EngineConfig(
        mode=mode, frontier_capacity=4096), device="cpu").query(
            OBBs(*map(torch.from_numpy, a)))
    assert np.array_equal(v, np.asarray(want[0]))
    assert 0 < v.sum() < len(v)
    _assert_counters_equal(want[1], c, mode)


@pytest.mark.parametrize("Q", [96, 101])
@pytest.mark.parametrize("mode", MODES3)
def test_sharded_matches_single_device(scene, mode, Q):
    """shards 1, 3 and 8 over CPU device lists, an even and an uneven pool
    (padding): verdicts and every counter but wall and pads equal the
    single-device engine; ``pad_queries == (-Q) % shards``."""
    _, tree = scene
    plan = tplan.plan_queries(_obbs(Q, Q))
    cfg = dict(mode=mode, frontier_capacity=4096)
    v0, c0 = CollisionEngine(tree, EngineConfig(**cfg),
                             device="cpu").execute(plan)
    for shards in (1, 3, 8):
        eng = CollisionEngine(tree, EngineConfig(**cfg, shards=shards),
                              device="cpu", shard_devices=CPU8)
        v1, c1 = eng.execute(plan)
        assert np.array_equal(v0, v1), (mode, Q, shards)
        _assert_counters_equal(c0, c1, (mode, Q, shards))
        assert c1.pad_queries == (-Q) % shards
        assert c1.reshards == 0 and c1.shards_lost == 0
    assert c0.pad_queries == 0


@pytest.mark.parametrize("mode", MODES3)
def test_sharded_escalation_replays_fewer_or_equal(scene, mode):
    """The escalation ladder (no pinned capacity, a small first bucket):
    every field but ``escalations`` equals the single-device run; each
    block's frontier is at most the whole pool's at one capacity, so a
    sharded run clears the ladder in as many replays or fewer (ROADMAP
    C.20)."""
    _, tree = scene
    plan = tplan.plan_queries(_obbs(101, 2))
    cfg = dict(mode=mode, min_bucket=64)
    v0, c0 = CollisionEngine(tree, EngineConfig(**cfg),
                             device="cpu").execute(plan)
    assert c0.escalations == 2
    seen = {}
    for shards in (1, 3, 8):
        v1, c1 = CollisionEngine(tree, EngineConfig(**cfg, shards=shards),
                                 device="cpu",
                                 shard_devices=CPU8).execute(plan)
        assert np.array_equal(v0, v1)
        _assert_counters_equal(c0, c1, (mode, shards), skip=("escalations",))
        seen[shards] = c1.escalations
    assert seen == {1: 2, 3: 1, 8: 0}


def test_sharded_depth_cap_equals_single_device(scene):
    """max_depth on a sharded engine equals the single-device capped run
    (verdicts and counters), for both per-level modes."""
    _, tree = scene
    plan = tplan.plan_queries(_obbs(64, 12))
    for mode in ("wavefront", "wavefront_fused"):
        v0, c0 = CollisionEngine(tree, EngineConfig(mode=mode),
                                 device="cpu").execute(plan, max_depth=2)
        v1, c1 = CollisionEngine(tree, EngineConfig(mode=mode, shards=3),
                                 device="cpu", shard_devices=CPU8).execute(
                                     plan, max_depth=2)
        assert np.array_equal(v0, v1)
        _assert_counters_equal(c0, c1, mode)


def test_sharded_config_and_plan_validation(scene):
    from repro_torch.parallel.sharding import make_collision_mesh
    _, tree = scene
    with pytest.raises(ValueError):
        EngineConfig(mode="wavefront_host", shards=2)
    with pytest.raises(ValueError):
        EngineConfig(mode="wavefront_fused", shards=0)
    with pytest.raises(ValueError, match="shard device"):
        CollisionEngine(tree, EngineConfig(mode="wavefront_fused", shards=2),
                        device="cpu")
    eng = CollisionEngine(tree, EngineConfig(mode="wavefront_fused",
                                             shards=1), device="cpu")
    assert eng.shard_devices == [torch.device("cpu")]
    obbs = _obbs(8, 2)
    with pytest.raises(ValueError, match="boolean"):
        eng.execute(tplan.plan_edges(obbs, np.zeros(8, np.int32), 1))
    batch = OBBs(center=obbs.center.reshape(2, 4, 3),
                 half=obbs.half.reshape(2, 4, 3),
                 rot=obbs.rot.reshape(2, 4, 3, 3))
    eng2 = CollisionEngine([tree, _tree(2, n=800, depth=4)],
                           EngineConfig(mode="wavefront_fused", shards=1),
                           device="cpu")
    with pytest.raises(ValueError, match="single-scene"):
        eng2._exec_sharded(tplan.plan_scenes(batch))
    with pytest.raises(ValueError):
        make_collision_mesh(0, CPU8)
    with pytest.raises(ValueError):
        make_collision_mesh(9, CPU8)
    assert make_collision_mesh(3, CPU8) == [torch.device("cpu")] * 3
    # set_shards is bounded by the engine's device list
    eng8 = CollisionEngine(tree, EngineConfig(mode="wavefront", shards=2),
                           device="cpu", shard_devices=CPU8)
    assert eng8.active_shards == 2 and eng8.scene_nodes == sum(
        len(lv.codes) for lv in tree.levels)
    eng8.set_shards(8)
    assert eng8.cfg.shards == 8 and eng8.active_shards == 8
    with pytest.raises(ValueError, match=r"\[1, 8\]"):
        eng8.set_shards(9)
    with pytest.raises(ValueError, match="cfg.shards"):
        eng.__class__(tree, EngineConfig(mode="wavefront"),
                      device="cpu").set_shards(1)


def test_traversal_cache_info_counts_sharded_keys(scene):
    _, tree = scene
    before = traversal_cache_info()["sharded_entries"]
    eng = CollisionEngine(tree, EngineConfig(mode="wavefront", shards=5,
                                             frontier_capacity=3000),
                          device="cpu", shard_devices=CPU8)
    eng.execute(tplan.plan_queries(_obbs(7, 5)))
    eng.execute(tplan.plan_queries(_obbs(7, 6)))
    info = traversal_cache_info()
    assert info["sharded_entries"] == before + 1
    assert ("wavefront", "sharded", 3000, False, False, 5, None) \
        in info["traces"]


# ---------------------------------------------------------------------------
# Threads and the kernels' host state
# ---------------------------------------------------------------------------

def test_compact_generation_tags_distinct_across_threads():
    """8 threads x 10,000 draws: every generation tag distinct (two
    launches with one tag on one stream would share status words)."""
    tags = [[] for _ in range(8)]

    def draw(i):
        for _ in range(10_000):
            tags[i].append(compact_ops._next_gen())

    threads = [threading.Thread(target=draw, args=(i,)) for i in range(8)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)              # switch threads often
    try:
        _run_threads(threads)
    finally:
        sys.setswitchinterval(old)
    flat = [g for per in tags for g in per]
    assert len(flat) == 80_000 and len(set(flat)) == 80_000


def test_launch_counts_exact_across_threads():
    before = _build.launch_counts()["march"]

    def bump():
        for _ in range(10_000):
            _build.count_launch("march")

    threads = [threading.Thread(target=bump) for _ in range(8)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _run_threads(threads)
    finally:
        sys.setswitchinterval(old)
    assert _build.launch_counts()["march"] - before == 80_000


# ---------------------------------------------------------------------------
# Continuous batching
# ---------------------------------------------------------------------------

def test_batcher_routes_k_requests_order_independent():
    """K concurrent requests of mixed sizes coalesce into fewer launches
    and every caller gets exactly its own verdicts back."""
    eng = CollisionEngine(_tree(3), EngineConfig(mode="wavefront_fused"),
                          device="cpu")
    K = 10
    reqs = [_obbs(3 + (7 * i) % 11, 30 + i) for i in range(K)]
    refs = [eng.execute(tplan.plan_queries(o))[0] for o in reqs]
    with RequestBatcher(eng, max_batch=4096, max_wait_ms=250.0) as b:
        tickets = [None] * K

        def submit(i):
            tickets[i] = b.submit(reqs[i])

        _run_threads([threading.Thread(target=submit, args=(i,))
                      for i in reversed(range(K))])
        results = [tickets[i].result(timeout=WAIT) for i in range(K)]
        launches = b.num_launches
    for i, (verdict, stats) in enumerate(results):
        assert verdict.shape == (reqs[i].n,)
        assert (verdict == refs[i]).all(), i
        assert stats.total_s >= stats.exec_s >= 0
        assert stats.wait_s >= 0
        assert 1 <= stats.batch_requests <= K
    assert launches < K, "requests did not coalesce"


def test_batcher_mixed_workload_kinds_share_a_launch():
    """A trajectory plan and a flat query plan coalesce into one pool and
    each un-flattens through its own recipe."""
    eng = CollisionEngine(_tree(4), EngineConfig(mode="wavefront_fused"),
                          device="cpu")
    wps = np.random.RandomState(5).uniform(-1, 1, (4, 7)).astype(np.float32)
    traj = tplan.plan_trajectory(wps)
    obbs = _obbs(9, 6)
    ref_traj = eng.execute(traj)[0]
    ref_q = eng.execute(tplan.plan_queries(obbs))[0]
    with RequestBatcher(eng, max_batch=4096, max_wait_ms=1000.0) as b:
        t1 = b.submit(traj)
        t2 = b.submit(obbs)                  # OBBs shorthand
        v1, s1 = t1.result(timeout=WAIT)
        v2, s2 = t2.result(timeout=WAIT)
    assert v1.shape == (4,) and (v1 == ref_traj).all()
    assert (v2 == ref_q).all()
    assert s1.batch_requests == 2 and s2.batch_requests == 2
    assert s1.batch_queries == traj.num_queries + obbs.n
    assert s1.pad_queries == _pad_bucket(s1.batch_queries) \
        - s1.batch_queries


def test_batcher_pad_accounting_and_rejections():
    tree = _tree(7, n=2000, depth=3)
    eng = CollisionEngine(tree, EngineConfig(mode="wavefront_fused"),
                          device="cpu")
    obbs = _obbs(5, 8)
    two = OBBs(center=obbs.center[:4].reshape(2, 2, 3),
               half=obbs.half[:4].reshape(2, 2, 3),
               rot=obbs.rot[:4].reshape(2, 2, 3, 3))
    with RequestBatcher(eng, max_batch=64, max_wait_ms=1.0) as b:
        _, stats = b.submit(obbs).result(timeout=WAIT)
        with pytest.raises(ValueError, match="boolean"):      # grouped
            b.submit(tplan.plan_edges(obbs, np.zeros(5, np.int32), 1))
        with pytest.raises(ValueError, match="single-scene"):
            b.submit(tplan.plan_scenes(two))
    assert stats.pad_queries == _pad_bucket(5) - 5
    assert b.totals.pad_queries >= stats.pad_queries
    assert b.totals.num_queries >= 5
    with pytest.raises(RuntimeError):        # closed
        b.submit(obbs)


def test_batcher_verdicts_match_reference_engine(scene):
    """Three requests through the batcher (coalesced, padded) against the
    reference engine on the same OBBs (one reference query of the three
    requests' OBBs: a query's verdict does not depend on its pool)."""
    jtree, ttree = scene
    eng = CollisionEngine(ttree, EngineConfig(mode="wavefront_fused"),
                          device="cpu")
    a = _arrays(101, 60)
    cuts = [(0, 33), (33, 67), (67, 101)]
    with RequestBatcher(eng, max_wait_ms=100.0) as b:
        tickets = [b.submit(OBBs(*(torch.from_numpy(x[i:j]) for x in a)))
                   for i, j in cuts]
        got = [t.result(timeout=WAIT) for t in tickets]
    assert any(st.batch_requests > 1 for _, st in got)
    with jax.disable_jit():
        want = np.asarray(jexe.CollisionEngine(jtree, jexe.EngineConfig(
            mode="wavefront_fused", frontier_capacity=4096)).query(
                jgeo.OBBs(*map(jnp.asarray, a)))[0])
    for (i, j), (v, _) in zip(cuts, got):
        assert np.array_equal(v, want[i:j])


# ---------------------------------------------------------------------------
# Depth-capped traversal (the degraded mode's substrate)
# ---------------------------------------------------------------------------

def test_depth_cap_conservative_superset_and_mode_agreement():
    """execute(max_depth=k): verdicts a superset of the exact ones,
    identical across DEPTH_CAP_MODES; full depth is a no-op."""
    tree = _tree(11)
    plan = tplan.plan_queries(_obbs(64, 12))
    exact = CollisionEngine(tree, EngineConfig(mode="wavefront_fused"),
                            device="cpu").execute(plan)[0]
    for k in (1, 2, tree.depth):
        capped = {}
        for mode in DEPTH_CAP_MODES:
            eng = CollisionEngine(tree, EngineConfig(mode=mode),
                                  device="cpu")
            assert eng.supports_depth_cap
            capped[mode] = eng.execute(plan, max_depth=k)[0]
            assert not (exact & ~capped[mode]).any(), (mode, k)
        ref = capped[DEPTH_CAP_MODES[0]]
        for mode, v in capped.items():
            assert (v == ref).all(), (mode, k)
        if k == tree.depth:
            assert (ref == exact).all()
    # a sharded capped run equals the single-device one
    v0 = CollisionEngine(tree, EngineConfig(mode="wavefront_fused"),
                         device="cpu").execute(plan, max_depth=2)[0]
    v1 = CollisionEngine(tree, EngineConfig(mode="wavefront_fused",
                                            shards=1),
                         device="cpu").execute(plan, max_depth=2)[0]
    assert (v1 == v0).all()


def test_depth_cap_rejected_where_unsupported():
    tree = _tree(13, n=2000, depth=3)
    eng = CollisionEngine(tree, EngineConfig(mode="wavefront_persistent"),
                          device="cpu")
    assert not eng.supports_depth_cap
    obbs = _obbs(4, 14)
    with pytest.raises(ValueError, match="max_depth"):
        eng.execute(tplan.plan_queries(obbs), max_depth=1)
    eng2 = CollisionEngine(tree, EngineConfig(mode="wavefront_fused"),
                           device="cpu")
    with pytest.raises(ValueError):
        eng2.execute(tplan.plan_queries(obbs), max_depth=0)


# ---------------------------------------------------------------------------
# Live rebind + elastic shard width
# ---------------------------------------------------------------------------

def test_rebind_under_live_batcher_streaming_clients():
    """Swapping the bound scene while clients stream requests: every
    verdict is the request's against scene A or scene B, and a submit
    after ``rebind`` sees scene B."""
    tree_a = _tree(15, n=2000, depth=3)
    tree_b = _tree(16, n=2000, depth=3)
    cfg = EngineConfig(mode="wavefront_fused")
    ref_a = CollisionEngine(tree_a, cfg, device="cpu")
    ref_b = CollisionEngine(tree_b, cfg, device="cpu")
    n_clients, n_reqs = 3, 6
    reqs = [[_obbs(4 + ri % 3, 100 * ci + ri) for ri in range(n_reqs)]
            for ci in range(n_clients)]
    refs = [[(ref_a.query(o)[0], ref_b.query(o)[0]) for o in per]
            for per in reqs]
    live = CollisionEngine(tree_a, cfg, device="cpu")
    results = [[None] * n_reqs for _ in range(n_clients)]
    errors = []
    with RequestBatcher(live, max_wait_ms=1.0) as b:
        def client(ci):
            try:
                for ri in range(n_reqs):
                    v, _ = b.submit(reqs[ci][ri]).result(timeout=WAIT)
                    results[ci][ri] = v
            except BaseException as e:        # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=client, args=(ci,))
                   for ci in range(n_clients)]
        for t in threads:
            t.start()
        b.rebind(tree_b, timeout=WAIT)
        probe = _obbs(6, 999)
        v_after, _ = b.submit(probe).result(timeout=WAIT)
        for t in threads:
            t.join(WAIT)
            assert not t.is_alive()
    assert not errors, errors
    assert (v_after == ref_b.query(probe)[0]).all()
    for ci in range(n_clients):
        for ri in range(n_reqs):
            v = results[ci][ri]
            va, vb = refs[ci][ri]
            assert (v == va).all() or (v == vb).all(), (ci, ri)


def test_autoscale_widens_shards_under_load_on_eight_cpu_entries():
    """The elastic batcher widens EngineConfig.shards between launches when
    p99 is past the SLO (an unmeetable one here), bounded by the engine's
    device list, and verdicts stay exact across the rescale."""
    tree = _tree(0, n=2000, depth=3)
    eng = CollisionEngine(tree, EngineConfig(mode="wavefront_fused",
                                             shards=1), device="cpu",
                          shard_devices=CPU8)
    reqs = [_obbs(5 + i % 7, 200 + i) for i in range(14)]
    refs = [eng.execute(tplan.plan_queries(o))[0] for o in reqs]
    with RequestBatcher(eng, max_wait_ms=1.0, autoscale_shards=True,
                        target_p99_ms=1e-6) as b:
        for o, ref in zip(reqs, refs):
            v, _ = b.submit(o).result(timeout=WAIT)
            assert (v == ref).all()
    assert b.totals.shard_rescales >= 1, b.totals.shard_rescales
    assert 1 < eng.cfg.shards <= 8, eng.cfg.shards


# ---------------------------------------------------------------------------
# Serve harness
# ---------------------------------------------------------------------------

def test_run_service_reports_slos():
    from repro_torch.launch.serve import (RELIABILITY_METRICS, SLO_METRICS,
                                          run_service)
    tree = _tree(9, n=2000, depth=3)
    rep = run_service(tree, clients=2, requests=3, queries_per_request=4,
                      max_wait_ms=5.0, mode="wavefront_fused", seed=0,
                      device="cpu")
    for metric in SLO_METRICS:
        assert rep[metric] > 0, metric
    for metric in RELIABILITY_METRICS:
        assert rep[metric] == 0, metric
    assert rep["requests"] == 6 and rep["queries"] == 24
    assert rep["launches"] >= 1
    assert rep["p99_ms"] >= rep["p50_ms"]
    assert rep["counters"].num_queries >= 24
    assert all(v.shape == (4,) for v in rep["verdicts"])


def test_run_service_sharded_on_eight_cpu_entries():
    """The whole stack (a sharded engine under the batcher under
    concurrent clients), its requests slices of a given OBB set whose
    verdicts come back as the single-device engine gives them."""
    from repro_torch.launch.serve import run_service
    tree = _tree(0, n=2000, depth=3)
    eng = CollisionEngine(tree, EngineConfig(mode="wavefront_fused",
                                             shards=8), device="cpu",
                          shard_devices=CPU8)
    obbs = _obbs(16, 77)
    want = CollisionEngine(tree, EngineConfig(mode="wavefront_fused"),
                           device="cpu").query(obbs)[0]
    rep = run_service(tree, clients=2, requests=2, queries_per_request=4,
                      max_wait_ms=5.0, engine=eng, obbs=obbs)
    assert rep["requests"] == 4 and rep["qps"] > 0
    assert np.array_equal(np.concatenate(rep["verdicts"]), want)
    assert rep["counters"].pad_queries > 0
