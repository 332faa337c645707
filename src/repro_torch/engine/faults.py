"""Fault injection for the collision service (DESIGN.md §7).

Counterpart of ``repro.engine.faults``: the same fault plan, drawn from
one seeded ``numpy.random.RandomState`` in the same call order, so a seed
injects what it injects in the reference.

The reliability layer (validation at submit, bisect-retry, deadlines,
backpressure, the launch watchdog — see :mod:`repro_torch.engine.batcher`)
only earns trust if it is exercised against the failures it claims to
contain.  This module is the chaos harness: a :class:`FaultPlan`
describes WHAT to inject (malformed plans, engine exceptions, artificial
launch stalls, simulated device OOM) and at WHAT rate, and a
:class:`FaultyEngine` wraps any :class:`repro_torch.engine.executor.
CollisionEngine` to apply those faults at the execute boundary — the
exact seam where a real device failure (an out-of-memory error, a hung
launch, a poisoned launch) would surface to the service.

Determinism: every injection decision comes from one seeded
``numpy.random.RandomState``, so a chaos test that fails replays
bit-identically from its seed.  The chaos suite
(``tests/test_torch_faults.py``) and ``launch/serve.py --chaos`` both
drive the service through this wrapper and assert the §7 contract: no
ticket ever hangs, every submit resolves to a verdict or a typed error,
and a poisoned request never fails an innocent co-batched one.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.counters import Counters
from repro_torch.core.geometry import OBBs
from repro_torch.engine.executor import CollisionEngine
from repro_torch.engine.plan import QueryPlan, plan_queries

#: Failure modes the service contains, one per row of the DESIGN.md §7
#: failure-mode table and the README reliability table (drift-guarded by
#: tests/test_docs_modes like ADMISSION_KNOBS/SLO_METRICS).
FAILURE_MODES = ("malformed_plan", "engine_exception", "worker_death",
                 "launch_stall", "device_oom", "overload", "deadline_miss",
                 "device_loss")

#: Ways :func:`poison_obbs` can corrupt a request, each one a condition
#: ``repro_torch.engine.plan.validate_plan`` must catch at submit.
POISON_KINDS = ("nan_center", "inf_half", "zero_half", "wrong_dtype")


class SimulatedOOM(RuntimeError):
    """Injected stand-in for the runtime's RESOURCE_EXHAUSTED: transient —
    the batcher retries it with backoff at reduced pool width."""

    transient = True

    def __init__(self, width: int):
        super().__init__(
            f"RESOURCE_EXHAUSTED (injected): simulated device OOM on a "
            f"{width}-slot pool")


class InjectedFault(RuntimeError):
    """Injected non-transient engine exception (a poisoned launch): the
    batcher bisect-retries the batch to isolate the poisoned request."""


class SimulatedDeviceLoss(RuntimeError):
    """Injected stand-in for the runtime's DEVICE_LOST: ``lost`` shard
    devices dropped out of the collision mesh mid-launch.  The sharded
    executor classifies it (``device_loss`` attribute or a DEVICE_LOST
    token in the message, the reference's spelling of real device loss),
    re-shards the flat pair pool over the surviving device set, and
    relaunches; only a mesh with no survivors propagates it to the
    batcher, which fails the batch with the typed ``DeviceLost`` error."""

    device_loss = True

    def __init__(self, lost: int, shards: int):
        super().__init__(
            f"DEVICE_LOST (injected): {lost} of {shards} shard devices "
            f"dropped out of the collision mesh mid-launch")
        self.lost = int(lost)
        self.shards = int(shards)


class WorkerKill(BaseException):
    """Injected worker-thread death: derives from ``BaseException`` and is
    flagged ``fatal`` so the batcher's per-launch containment re-raises it
    and the worker thread dies WITHOUT resolving its tickets — exactly the
    silent-death scenario the liveness watchdog exists to detect."""

    fatal = True


@dataclasses.dataclass
class FaultPlan:
    """Injection rates/points for one chaos run.

    Rates are per engine call (``oom_rate``/``exception_rate``/
    ``stall_rate``/``crash_rate``) or per client request
    (``malformed_rate``, applied by the chaos clients in
    ``launch/serve.py`` before submit).  ``poison_nan`` is the targeted
    variant: any pool containing a non-finite OBB raises
    :class:`InjectedFault`, which is how the bisect-isolation tests model
    "this one request crashes any launch it rides in".
    """

    malformed_rate: float = 0.0    # corrupt client plans pre-submit
    exception_rate: float = 0.0    # non-transient engine exception
    oom_rate: float = 0.0          # transient SimulatedOOM
    stall_rate: float = 0.0        # artificial launch stall
    crash_rate: float = 0.0        # kill the worker thread (WorkerKill)
    device_loss_rate: float = 0.0  # drop shard devices from the mesh
    #                                (sharded engines only; fires at the
    #                                per-attempt injector seam inside
    #                                _exec_sharded, so the recovery path —
    #                                not just the batcher — is exercised)
    devices_lost: int = 1          # shard devices dropped per injection
    stall_s: float = 0.5           # injected stall duration
    poison_nan: bool = False       # any non-finite pool raises
    max_faults: Optional[int] = None   # stop injecting after this many
    seed: int = 0

    def __post_init__(self):
        for f in ("malformed_rate", "exception_rate", "oom_rate",
                  "stall_rate", "crash_rate", "device_loss_rate"):
            v = getattr(self, f)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{f} must be in [0, 1], got {v}")
        self._rs = np.random.RandomState(self.seed)
        self._lock = threading.Lock()
        self.num_injected = 0

    # -- decision points (deterministic given seed + call order) ----------
    def _fire(self, rate: float) -> bool:
        with self._lock:
            if self.max_faults is not None \
                    and self.num_injected >= self.max_faults:
                return False
            hit = rate > 0.0 and self._rs.uniform() < rate
            if hit:
                self.num_injected += 1
            return hit

    def draw_malformed(self) -> Optional[str]:
        """Client-side decision: corrupt this request?  Returns a poison
        kind or None."""
        if not self._fire(self.malformed_rate):
            return None
        with self._lock:
            return POISON_KINDS[self._rs.randint(len(POISON_KINDS))]


def poison_obbs(obbs: OBBs, kind: str, slot: int = 0) -> OBBs:
    """Corrupt one query slot of an OBB set in the named way.

    Every kind is a condition :func:`repro_torch.engine.plan.validate_plan`
    rejects at submit — the chaos clients use this to prove malformed
    requests die at admission, not inside a shared launch.
    """
    c, h, r = (torch.as_tensor(x, dtype=torch.float32).clone()
               for x in (obbs.center, obbs.half, obbs.rot))
    if kind == "nan_center":
        c[slot] = float("nan")
    elif kind == "inf_half":
        h[slot, 0] = float("inf")
    elif kind == "zero_half":
        h[slot] = 0.0
    elif kind == "wrong_dtype":
        h = h.to(torch.float64)
    else:
        raise ValueError(
            f"unknown poison kind {kind!r}; allowed: "
            f"{', '.join(POISON_KINDS)}")
    return OBBs(center=c, half=h, rot=r)


def poisoned_plan(obbs: OBBs, kind: str, slot: int = 0) -> QueryPlan:
    """A lowered plan carrying one poisoned query slot."""
    return plan_queries(poison_obbs(obbs, kind, slot))


class FaultyEngine:
    """CollisionEngine wrapper injecting a :class:`FaultPlan` at execute.

    Duck-types the slice of the engine surface the batcher touches
    (``execute``, ``octree``, ``cfg``, ``device``), so it drops into
    :class:`repro_torch.engine.batcher.RequestBatcher` and
    ``launch/serve.py --chaos`` unchanged.  Injection order per call:
    crash, stall, OOM, exception — a stall can therefore be followed by a
    clean result (the watchdog, not the engine, decides it took too long).
    """

    def __init__(self, engine: CollisionEngine, faults: FaultPlan):
        self.inner = engine
        self.faults = faults
        self.calls = 0
        # ``device_loss_after_stall`` counts the device losses that fired in
        # a call already stalled: with ``stall_s`` past the batcher's
        # ``launch_timeout_s`` that batch has failed as LaunchStalled before
        # its loss surfaces, so the loss can leave no DeviceLost behind.
        self.injected = {"exception": 0, "oom": 0, "stall": 0, "crash": 0,
                         "poison": 0, "device_loss": 0,
                         "device_loss_after_stall": 0}
        self._call = threading.local()
        if faults.device_loss_rate > 0.0:
            # Device loss must fire INSIDE the sharded launch attempt (the
            # recovery loop lives in _exec_sharded, below the execute
            # boundary every other fault uses), so it rides the engine's
            # per-attempt injector seam.
            engine.device_fault_injector = self._lose_devices

    def _lose_devices(self, shards: int) -> None:
        f = self.faults
        if shards > 0 and f._fire(f.device_loss_rate):
            self.injected["device_loss"] += 1
            if getattr(self._call, "stalled", False):
                self.injected["device_loss_after_stall"] += 1
            raise SimulatedDeviceLoss(min(f.devices_lost, shards), shards)

    # The batcher reads these off the engine it serves.
    @property
    def octree(self):
        return self.inner.octree

    @property
    def cfg(self):
        return self.inner.cfg

    @property
    def device(self):
        return self.inner.device

    @property
    def shard_devices(self):
        return self.inner.shard_devices

    @property
    def scene_nodes(self):
        return self.inner.scene_nodes

    @property
    def active_shards(self):
        return self.inner.active_shards

    @property
    def supports_depth_cap(self):
        return self.inner.supports_depth_cap

    def set_shards(self, shards: int) -> None:
        self.inner.set_shards(shards)

    def rebind_octrees(self, octree) -> None:
        self.inner.rebind_octrees(octree)

    def execute(self, plan: QueryPlan,
                max_depth: Optional[int] = None) -> Tuple[np.ndarray,
                                                          Counters]:
        self.calls += 1
        self._call.stalled = False
        f = self.faults
        if f.poison_nan and not bool(
                torch.isfinite(torch.as_tensor(plan.obb_c)).all()
                and torch.isfinite(torch.as_tensor(plan.obb_h)).all()):
            self.injected["poison"] += 1
            raise InjectedFault(
                "injected: non-finite OBB poisoned this launch")
        if f._fire(f.crash_rate):
            self.injected["crash"] += 1
            raise WorkerKill("injected: worker thread killed mid-launch")
        if f._fire(f.stall_rate):
            self.injected["stall"] += 1
            self._call.stalled = True
            time.sleep(f.stall_s)
        if f._fire(f.oom_rate):
            self.injected["oom"] += 1
            raise SimulatedOOM(plan.num_queries)
        if f._fire(f.exception_rate):
            self.injected["exception"] += 1
            raise InjectedFault("injected: engine exception mid-launch")
        # Like the batcher, only forward max_depth when set, so wrapped
        # duck-typed engines with an execute(plan)-only signature keep
        # working un-degraded.
        if max_depth is None:
            return self.inner.execute(plan)
        return self.inner.execute(plan, max_depth=max_depth)


__all__ = ["FAILURE_MODES", "FaultPlan", "FaultyEngine", "InjectedFault",
           "POISON_KINDS", "SimulatedDeviceLoss", "SimulatedOOM",
           "WorkerKill", "poison_obbs", "poisoned_plan"]
