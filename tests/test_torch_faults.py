"""Port parity: the collision service's reliability contract under
injected faults, on the CPU.

Each test drives the port's batcher through ``repro_torch.engine.faults``
and holds the contract of the reference's chaos suite: every ``submit``
resolves, to a verdict or a typed error, and a poisoned request never
fails an innocent co-batched one.  Each ``FAILURE_MODES`` row has a test
here.  Injected stalls last at most 0.3 s; a test that needs the worker
inside a launch holds the call on an event instead of a clock.  Every
wait is bounded, and no latency is used as an oracle (ROADMAP C.2).
"""
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import geometry as jgeo
from repro.engine import faults as jfaults
from repro.engine import plan as jplan
from repro_torch.core.geometry import OBBs, rotation_from_euler
from repro_torch.core.octree import build_octree
from repro_torch.engine.batcher import (BatcherClosed, DeadlineExceeded,
                                        DeviceLost, LaunchStalled,
                                        Overloaded, RequestBatcher,
                                        WorkerDied, _is_transient,
                                        _pad_bucket)
from repro_torch.engine.executor import (CollisionEngine, EngineConfig,
                                         device_loss_count)
from repro_torch.engine.faults import (FAILURE_MODES, POISON_KINDS,
                                       FaultPlan, FaultyEngine,
                                       InjectedFault, SimulatedDeviceLoss,
                                       SimulatedOOM, poison_obbs,
                                       poisoned_plan)
from repro_torch.engine.plan import (PlanValidationError, plan_queries,
                                     validate_plan)

torch.set_num_threads(1)

WAIT = 60        # seconds: every ticket and join is bounded
STALL = 0.3      # an injected stall
CPU8 = ["cpu"] * 8


def _tree(seed, n=2000, depth=3):
    rs = np.random.RandomState(seed)
    return build_octree(rs.uniform(-1, 1, (n, 3)).astype(np.float32),
                        depth=depth)


def _engine(seed=0, **cfg):
    return CollisionEngine(_tree(seed), EngineConfig(mode="wavefront_fused",
                                                     **cfg), device="cpu")


def _obbs(n, seed):
    rs = np.random.RandomState(seed)
    return OBBs(center=torch.from_numpy(
                    rs.uniform(-1.4, 1.4, (n, 3)).astype(np.float32)),
                half=torch.from_numpy(
                    rs.uniform(0.02, 0.1, (n, 3)).astype(np.float32)),
                rot=rotation_from_euler(torch.from_numpy(
                    rs.uniform(-3, 3, (n, 3)).astype(np.float32))))


def _wait_launched(ticket):
    """Until the worker has taken ``ticket`` into a launch (bounded)."""
    t_end = time.perf_counter() + WAIT
    while ticket.state == "queued":
        assert time.perf_counter() < t_end, "the request never launched"
        time.sleep(0.005)


class _CountingEngine:
    """Engine wrapper proving what does / does not reach ``execute``."""

    def __init__(self, inner):
        self.inner = inner
        self.calls = 0

    @property
    def octree(self):
        return self.inner.octree

    @property
    def cfg(self):
        return self.inner.cfg

    def execute(self, plan):
        self.calls += 1
        return self.inner.execute(plan)


class _ProxyEngine:
    """Forwarding wrapper: subclasses override execute."""

    def __init__(self, inner):
        self.inner = inner

    def __getattr__(self, name):
        return getattr(self.inner, name)


class _HeldEngine(_ProxyEngine):
    """Holds its first engine call until ``gate`` is set, so the worker
    sits inside a launch for as long as a test needs, with no timing."""

    def __init__(self, inner):
        super().__init__(inner)
        self.gate = threading.Event()
        self.calls = 0

    def execute(self, plan, max_depth=None):
        self.calls += 1
        if self.calls == 1:
            assert self.gate.wait(WAIT), "the test never released the call"
        if max_depth is None:
            return self.inner.execute(plan)
        return self.inner.execute(plan, max_depth=max_depth)


# ---------------------------------------------------------------------------
# malformed_plan: rejected at submit
# ---------------------------------------------------------------------------

def test_failure_modes_tuple_is_canonical():
    assert FAILURE_MODES == jfaults.FAILURE_MODES
    assert POISON_KINDS == jfaults.POISON_KINDS
    assert len(set(FAILURE_MODES)) == len(FAILURE_MODES)


@pytest.mark.parametrize("kind", POISON_KINDS)
def test_poisons_rejected_like_reference(kind):
    """Every poison kind, at a middle slot: the port's and the reference's
    ``validate_plan`` both reject it, with the same message."""
    obbs = _obbs(9, 1)
    bad = poisoned_plan(obbs, kind, slot=4)
    jbad = jfaults.poisoned_plan(jgeo.OBBs(*(jnp.asarray(x.numpy()) for x in (
        obbs.center, obbs.half, obbs.rot))), kind, slot=4)
    with pytest.raises(PlanValidationError) as got:
        validate_plan(bad)
    with pytest.raises(jplan.PlanValidationError) as want:
        jplan.validate_plan(jbad)
    assert str(got.value) == str(want.value)
    assert "obb_" in str(got.value)
    with pytest.raises(ValueError, match="unknown poison"):
        poison_obbs(obbs, "bad_kind")


def test_malformed_plans_rejected_at_submit_never_reach_engine():
    """Each poison kind dies at ``submit``; the engine never sees it and
    an innocent request beside it completes."""
    eng = _CountingEngine(_engine())
    good = _obbs(4, 3)
    want = eng.inner.execute(plan_queries(good))[0]
    with RequestBatcher(eng, max_wait_ms=1.0) as b:
        for i, kind in enumerate(POISON_KINDS):
            with pytest.raises(PlanValidationError):
                b.submit(poisoned_plan(_obbs(6, 10 + i), kind, slot=i))
        v, _ = b.submit(good).result(timeout=WAIT)
    assert (v == want).all()
    assert eng.calls == 1, "a malformed plan reached engine.execute"
    assert b.totals.rejected == len(POISON_KINDS)


def test_clean_plans_pass_validation_and_wrong_shape_fails():
    plan = plan_queries(_obbs(9, 2))
    assert validate_plan(plan) is plan
    bad = plan_queries(_obbs(4, 3))
    object.__setattr__(bad, "obb_h", bad.obb_h[:, :2])
    with pytest.raises(PlanValidationError, match="shape"):
        validate_plan(bad)


# ---------------------------------------------------------------------------
# engine_exception: bisect-retry isolates the poisoned request
# ---------------------------------------------------------------------------

def test_poisoned_request_fails_alone_in_16_request_batch():
    """One poisoned request in a 16-request coalesced batch errors alone;
    the other 15 verdicts equal un-batched execution."""
    inner = _engine()
    reqs = [_obbs(3 + i % 5, 100 + i) for i in range(16)]
    refs = [inner.execute(plan_queries(o))[0] for o in reqs]
    poisoned_i = 11
    fe = FaultyEngine(inner, FaultPlan(poison_nan=True))
    with RequestBatcher(fe, max_batch=4096, max_wait_ms=250.0,
                        max_retries=0) as b:
        tickets = [b.submit(poisoned_plan(o, "nan_center"), validate=False)
                   if i == poisoned_i else b.submit(o)
                   for i, o in enumerate(reqs)]
        for i, t in enumerate(tickets):
            if i == poisoned_i:
                with pytest.raises(InjectedFault):
                    t.result(timeout=WAIT)
            else:
                v, st = t.result(timeout=WAIT)
                assert (v == refs[i]).all(), i
                assert st.splits >= 1
        assert 4 <= b.totals.launch_splits <= 15


# ---------------------------------------------------------------------------
# device_oom: transient, retried at a reduced width
# ---------------------------------------------------------------------------

def test_transient_oom_retries_at_reduced_width():
    """SimulatedOOM retries with backoff at half the pow2 pad bucket; both
    co-batched requests complete."""
    inner = _engine()
    reqs = [_obbs(5, 1), _obbs(3, 2)]
    refs = [inner.execute(plan_queries(o))[0] for o in reqs]
    fe = FaultyEngine(inner, FaultPlan(oom_rate=1.0, max_faults=1))
    with RequestBatcher(fe, max_wait_ms=100.0, max_retries=2,
                        retry_backoff_ms=0.1) as b:
        tickets = [b.submit(o) for o in reqs]
        got = [t.result(timeout=WAIT) for t in tickets]
    for (v, st), ref in zip(got, refs):
        assert (v == ref).all()
        assert st.retries == 1 and st.batch_requests == 2
        # the first attempt padded 8 live slots to 64; the retry asked
        # for half of that
        assert st.pad_queries == _pad_bucket(8) // 2 - 8
    assert b.totals.retried == 1 and fe.injected["oom"] == 1


def test_retries_exhausted_surfaces_transient_error():
    fe = FaultyEngine(_engine(), FaultPlan(oom_rate=1.0))
    with RequestBatcher(fe, max_wait_ms=1.0, max_retries=1,
                        retry_backoff_ms=0.1) as b:
        with pytest.raises(SimulatedOOM):
            b.submit(_obbs(4, 2)).result(timeout=WAIT)
    assert b.totals.retried == 1


def test_cuda_oom_is_transient_and_device_loss_is_classified():
    assert _is_transient(torch.cuda.OutOfMemoryError("CUDA out of memory"))
    assert _is_transient(SimulatedOOM(64))
    assert not _is_transient(RuntimeError("an illegal memory access"))
    assert device_loss_count(SimulatedDeviceLoss(3, 8)) == 3
    assert device_loss_count(RuntimeError("DEVICE_LOST: gone")) == 1
    # a CUDA fault leaves the context unusable: it is no device loss
    assert device_loss_count(
        RuntimeError("CUDA error: an illegal memory access")) is None


# ---------------------------------------------------------------------------
# deadline_miss and overload: shed before a launch
# ---------------------------------------------------------------------------

def test_deadline_exceeded_rejected_fast_never_launched():
    """A request whose deadline passed while queued fails typed before the
    launch: the engine never sees its queries."""
    held = _HeldEngine(_engine())
    obbs = _obbs(4, 3)
    with RequestBatcher(held, max_wait_ms=1.0) as b:
        t1 = b.submit(obbs)                  # rides the held launch
        _wait_launched(t1)
        t2 = b.submit(obbs, deadline_ms=0.01)
        held.gate.set()
        with pytest.raises(DeadlineExceeded, match="unmeetable"):
            t2.result(timeout=WAIT)
        t1.result(timeout=WAIT)
        assert held.calls == 1
        b.submit(obbs).result(timeout=WAIT)  # service still live
        assert held.calls == 2               # ... and t2 never launched
    assert b.totals.deadline_missed == 1


def test_overload_and_work_based_admission_shed_at_submit():
    """Bounded admission: past ``max_queue`` requests, or past
    ``max_queue_work`` predicted work (scene nodes x queries), a submit
    fails fast with Overloaded while the queued requests complete; an
    oversized request on an empty queue still admits."""
    for knobs, extra_n, match in ((dict(max_queue=1), 4, "queue full"),
                                  (None, 6, "work")):
        held = _HeldEngine(_engine())
        nodes = held.scene_nodes
        assert nodes > 1
        if knobs is None:
            knobs = dict(max_queue_work=8 * nodes)
        with RequestBatcher(held, max_wait_ms=1.0, **knobs) as b:
            t1 = b.submit(_obbs(4, 20))
            _wait_launched(t1)               # the worker is held in it
            t2 = b.submit(_obbs(4, 21))      # 4 x nodes queued
            with pytest.raises(Overloaded, match=match):
                b.submit(_obbs(extra_n, 22))
            assert b.totals.rejected == 1
            held.gate.set()
            t1.result(timeout=WAIT)
            t2.result(timeout=WAIT)
    with RequestBatcher(_engine(), max_wait_ms=1.0, max_queue_work=1) as b:
        v, _ = b.submit(_obbs(4, 23)).result(timeout=WAIT)
        assert v.shape == (4,)


# ---------------------------------------------------------------------------
# launch_stall and worker_death: the watchdogs
# ---------------------------------------------------------------------------

def test_launch_stall_fails_batch_typed_and_service_recovers():
    fe = FaultyEngine(_engine(), FaultPlan(stall_rate=1.0, stall_s=STALL,
                                           max_faults=1))
    obbs = _obbs(4, 5)
    ref = fe.inner.execute(plan_queries(obbs))[0]
    with RequestBatcher(fe, max_wait_ms=1.0, launch_timeout_s=0.1) as b:
        with pytest.raises(LaunchStalled, match="launch_timeout_s"):
            b.submit(obbs).result(timeout=WAIT)
        v, _ = b.submit(obbs).result(timeout=WAIT)   # service recovered
        assert (v == ref).all()
    assert all(not th.is_alive() for th in b._abandoned)


def test_worker_death_fails_inflight_typed_and_self_heals():
    """A WorkerKill escapes per-launch containment and kills the worker;
    the watchdog fails the in-flight tickets with WorkerDied and restarts
    the worker, which serves the next submit."""
    fe = FaultyEngine(_engine(), FaultPlan(crash_rate=1.0, max_faults=1))
    obbs = _obbs(4, 6)
    ref = fe.inner.execute(plan_queries(obbs))[0]
    with RequestBatcher(fe, max_wait_ms=1.0) as b:
        with pytest.raises(WorkerDied, match="watchdog"):
            b.submit(obbs).result(timeout=WAIT)
        v, _ = b.submit(obbs).result(timeout=WAIT)
        assert (v == ref).all()
        assert b.totals.worker_restarts == 1


def test_ticket_state_and_recallable_result():
    """Ticket state is queued / launched / done, the timeout error names
    it, and ``result`` can be called again."""
    held = _HeldEngine(_engine())
    obbs = _obbs(4, 7)
    with RequestBatcher(held, max_wait_ms=1.0) as b:
        t1 = b.submit(obbs)
        _wait_launched(t1)
        assert t1.state == "launched"
        t2 = b.submit(obbs)                  # queued behind the held call
        assert t2.state == "queued"
        with pytest.raises(TimeoutError, match="queued"):
            t2.result(timeout=0.01)
        with pytest.raises(TimeoutError, match="launched"):
            t1.result(timeout=0.01)
        held.gate.set()
        v1, _ = t1.result(timeout=WAIT)
        v2, _ = t2.result(timeout=WAIT)
        assert t1.state == "done" and t2.state == "done"
        assert (v1 == v2).all()
        v1b, _ = t1.result(timeout=0.01)
        assert (v1b == v1).all()


# ---------------------------------------------------------------------------
# close(): nothing stranded
# ---------------------------------------------------------------------------

def test_close_fails_stranded_requests_typed():
    """Requests still queued when the batcher stops under a stuck worker
    resolve with BatcherClosed; submit after close raises the same."""
    held = _HeldEngine(_engine())
    obbs = _obbs(4, 8)
    b = RequestBatcher(held, max_wait_ms=1.0)
    first = b.submit(obbs)
    _wait_launched(first)
    stranded = [b.submit(obbs) for _ in range(3)]
    b.close(timeout=0.05)                    # worker still inside the call
    for t in stranded:
        with pytest.raises(BatcherClosed):
            t.result(timeout=WAIT)
    with pytest.raises(BatcherClosed):
        b.submit(obbs)
    held.gate.set()
    first.result(timeout=WAIT)               # the held launch completes
    b._worker.join(WAIT)                     # ... and the worker then ends
    assert not b._worker.is_alive()


def test_close_launches_already_queued_work():
    eng = _engine()
    obbs = _obbs(4, 9)
    ref = eng.execute(plan_queries(obbs))[0]
    b = RequestBatcher(eng, max_wait_ms=1.0)
    t = b.submit(obbs)
    b.close()
    v, _ = t.result(timeout=WAIT)
    assert (v == ref).all()


# ---------------------------------------------------------------------------
# device_loss: re-shard below the batcher, typed with no survivors
# ---------------------------------------------------------------------------

def test_device_loss_reshard_bitwise_identical_on_eight_cpu_entries():
    """Losing 3 of 8 shard devices mid-launch re-shards over the 5
    survivors: verdicts and every counter but padding, wall and the
    recovery's own equal the healthy 8-shard run; the engine stays at 5
    until ``set_shards``."""
    tree = _tree(0)
    plan = plan_queries(_obbs(37, 1))        # uneven: forces a pad
    cfg = dict(mode="wavefront_fused", frontier_capacity=4096)
    v_ref, c_ref = CollisionEngine(tree, EngineConfig(**cfg, shards=8),
                                   device="cpu",
                                   shard_devices=CPU8).execute(plan)
    eng = CollisionEngine(tree, EngineConfig(**cfg, shards=8), device="cpu",
                          shard_devices=CPU8)
    fired = []

    def lose_three_once(shards):
        if not fired:
            fired.append(shards)
            raise SimulatedDeviceLoss(3, shards)
    eng.device_fault_injector = lose_three_once
    v, c = eng.execute(plan)
    assert fired == [8]
    assert (v == v_ref).all()
    assert c.reshards == 1 and c.shards_lost == 3
    assert c.pad_queries == (-37) % 5
    assert eng.active_shards == 5
    d0, d1 = c_ref.as_dict(), c.as_dict()
    for k in d0:
        if k not in ("wall_time_s", "pad_queries", "reshards",
                     "shards_lost"):
            assert d0[k] == d1[k], k
    v2, c2 = eng.execute(plan)               # the survivors, no reshard
    assert (v2 == v_ref).all()
    assert c2.reshards == 0 and c2.pad_queries == (-37) % 5
    eng.set_shards(8)                        # re-probes the full list
    assert eng.active_shards == 8


def test_device_loss_no_survivors_fails_typed_never_bisected():
    """A mesh that loses its last device fails the whole batch with
    DeviceLost; neither bisect-retry nor the transient retry kicks in."""
    eng = _engine(shards=1)

    def lose_all(shards):
        raise SimulatedDeviceLoss(shards, shards)
    eng.device_fault_injector = lose_all
    with RequestBatcher(eng, max_wait_ms=100.0, max_retries=2) as b:
        t1 = b.submit(_obbs(4, 11))
        t2 = b.submit(_obbs(5, 12))
        for t in (t1, t2):
            with pytest.raises(DeviceLost, match="no surviv"):
                t.result(timeout=WAIT)
    assert b.totals.launch_splits == 0
    assert b.totals.retried == 0


def test_chaos_device_loss_recovery_on_eight_cpu_entries():
    """run_service under deterministic device loss (8 -> 5 -> 2 shard
    devices): recovery happens below the batcher, so every request
    completes, and the recovery counters reach the report."""
    from repro_torch.launch.serve import run_service
    tree = _tree(0, n=1500)
    eng = CollisionEngine(tree, EngineConfig(mode="wavefront_fused",
                                             shards=8), device="cpu",
                          shard_devices=CPU8)
    chaos = FaultPlan(device_loss_rate=1.0, devices_lost=3, max_faults=2,
                      seed=0)
    rep = run_service(tree, clients=2, requests=4, queries_per_request=4,
                      max_wait_ms=5.0, engine=eng, deadline_ms=30000.0,
                      chaos=chaos)
    assert rep["requests"] == rep["submitted"] == 8, rep["failures"]
    assert rep["failed"] == 0
    assert rep["reshards"] == 2 and rep["shards_lost"] == 6
    assert eng.active_shards == 2 and rep["injected"]["device_loss"] == 2


# ---------------------------------------------------------------------------
# Degraded mode and the per-bucket exec estimate
# ---------------------------------------------------------------------------

def test_degraded_mode_flagged_and_conservative_superset():
    """Past ``degrade_queue`` the batcher serves depth-capped launches:
    they say so (``degraded``, ``degraded_launches``), and every degraded
    verdict is a superset of the exact one."""
    inner = _engine(40)
    held = _HeldEngine(inner)               # a queue builds behind launch 1
    reqs = [_obbs(5, 41 + i) for i in range(5)]
    refs = [inner.execute(plan_queries(o))[0] for o in reqs]
    with RequestBatcher(held, max_wait_ms=1.0, degrade_queue=1) as b:
        t0 = b.submit(reqs[0])
        _wait_launched(t0)
        later = [b.submit(o) for o in reqs[1:]]
        held.gate.set()
        results = [t.result(timeout=WAIT) for t in [t0] + later]
    assert b.totals.degraded_launches >= 1
    assert any(st.degraded for _, st in results)
    for (v, st), ref in zip(results, refs):
        assert not (ref & ~v).any(), "a degraded verdict missed a collision"
        if not st.degraded:
            assert (v == ref).all()


def test_per_bucket_exec_estimate():
    """The deadline estimate is kept per pow2 pad bucket: after wide
    launches, a small request's bucket (unseen) falls back to the
    work-rate estimate scaled to its own width, not the wide bucket's."""
    inner = _engine(50)
    big, small = _obbs(1000, 51), _obbs(8, 52)
    with RequestBatcher(inner, max_batch=2048, max_wait_ms=1.0) as b:
        for _ in range(2):
            b.submit(big).result(timeout=WAIT)
        wide = _pad_bucket(1000)
        assert set(b._exec_ewma) == {wide}
        est = b._estimate_exec_s(8)
        assert est == b._work_rate * b._scene_nodes() * _pad_bucket(8)
        assert est == pytest.approx(
            b._work_rate * b._scene_nodes() * wide * _pad_bucket(8) / wide)
        v, _ = b.submit(small).result(timeout=WAIT)
        assert set(b._exec_ewma) == {wide, _pad_bucket(8)}
    assert v.shape == (8,)


# ---------------------------------------------------------------------------
# Chaos end to end
# ---------------------------------------------------------------------------

def test_chaos_service_no_hangs_no_drops():
    """``run_service`` under every failure mode at once: every submit
    resolves, the reliability counters reach the report, healthy requests
    still complete with the engine's verdicts, and at one shard a device
    loss fails its batch typed."""
    from repro_torch.launch.serve import RELIABILITY_METRICS, run_service
    tree = _tree(10, n=1500)
    obbs = _obbs(96, 13)
    want = CollisionEngine(tree, EngineConfig(mode="wavefront_fused"),
                           device="cpu").query(obbs)[0]
    chaos = FaultPlan(malformed_rate=0.15, exception_rate=0.12,
                      oom_rate=0.1, stall_rate=0.06, crash_rate=0.04,
                      device_loss_rate=0.1, stall_s=STALL, seed=0)
    rep = run_service(tree, clients=3, requests=8, queries_per_request=4,
                      max_wait_ms=5.0, mode="wavefront_fused", shards=1,
                      seed=0, deadline_ms=5000.0, launch_timeout_s=0.1,
                      chaos=chaos, device="cpu", obbs=obbs)
    assert rep["submitted"] == 24
    assert rep["requests"] + rep["failed"] == rep["submitted"]
    assert rep["failed"] > 0 and sum(rep["injected"].values()) > 0
    for metric in RELIABILITY_METRICS:
        assert metric in rep
    assert rep["rejected"] >= 1
    assert rep["requests"] > 0
    if rep["injected"]["device_loss"]:
        assert rep["failures"].get("DeviceLost", 0) >= 1
    for i, v in enumerate(rep["verdicts"]):
        if v is not None:
            assert (v == want[4 * i:4 * i + 4]).all(), i


@pytest.mark.parametrize("fmt", ["bf16", "u8"])
def test_chaos_streamed_quantized_scene_no_hangs(fmt):
    """Chaos over a persistent engine on streamed compressed rows: every
    submit resolves and the survivors' verdicts are exact."""
    inner = CollisionEngine(_tree(60), EngineConfig(
        mode="wavefront_persistent", stream_meta=True, meta_format=fmt),
        device="cpu")
    reqs = [_obbs(3 + i % 5, 61 + i) for i in range(12)]
    refs = [inner.execute(plan_queries(o))[0] for o in reqs]
    fe = FaultyEngine(inner, FaultPlan(exception_rate=0.2, stall_rate=0.1,
                                       stall_s=STALL, seed=2))
    n_ok = n_failed = 0
    with RequestBatcher(fe, max_wait_ms=1.0, max_retries=2,
                        retry_backoff_ms=0.1, launch_timeout_s=2.0) as b:
        tickets = [b.submit(plan_queries(o), deadline_ms=30000.0)
                   for o in reqs]
        for i, t in enumerate(tickets):
            try:
                v, _ = t.result(timeout=WAIT)
            except (SimulatedOOM, InjectedFault, LaunchStalled,
                    DeadlineExceeded):
                n_failed += 1
                continue
            n_ok += 1
            assert (v == refs[i]).all(), (fmt, i)
    assert sum(fe.injected.values()) > 0, "chaos injected nothing"
    assert n_ok + n_failed == len(reqs) and n_ok > 0
