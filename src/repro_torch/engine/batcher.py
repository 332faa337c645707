"""Async request aggregator: continuous batching for the collision engine.

Counterpart of ``repro.engine.batcher``, with its names, knobs and
reliability contract; the engine it serves is the port's
:class:`repro_torch.engine.executor.CollisionEngine`, on the card or the
CPU.  The worker thread and every launch thread make their engine call
under the engine's device (``torch.cuda.device``), so a thread, which
PyTorch starts on card 0, never launches for another card.

The serving problem (DESIGN.md §6): planner clients issue many SMALL query
sets — a dozen link OBBs per motion-plan step — while the engine's
throughput comes from LARGE flat pools that keep the persistent megakernel
saturated.  The :class:`RequestBatcher` bridges the two: client threads
``submit`` plans and block on a ticket; a single worker thread coalesces
whatever is queued into ONE flat pool, launches it as one engine execute,
and routes each slice of the verdict back through the submitting plan's
own un-flattening recipe.

Admission policy (the knobs in :data:`ADMISSION_KNOBS`, drift-guarded
against DESIGN.md §6):

* ``max_batch`` — launch as soon as the coalesced pool holds this many
  query slots (one oversized request still launches alone);
* ``max_wait_ms`` — never hold the FIRST queued request longer than this
  before launching, whatever the pool size;
* ``max_queue`` — bounded admission: a submit that finds this many
  requests already queued is shed immediately with :class:`Overloaded`
  instead of growing an unbounded backlog;
* ``launch_timeout_s`` — liveness bound on one engine call: the launch
  runs on a monitored thread, and a call that outlives the bound fails
  its batch with :class:`LaunchStalled` instead of hanging every client;
* ``max_retries`` — transient launch failures (RESOURCE_EXHAUSTED /
  simulated OOM) retry up to this many times with exponential backoff,
  shrinking an oversized pow2 pad bucket toward the exact pool width;
* ``max_queue_work`` — work-based admission (service v2): bound the
  queued PREDICTED WORK (scene node count x query count,
  :meth:`repro_torch.engine.plan.QueryPlan.work_units`) instead of only the
  request count — one 10k-query sweep costs what it costs, not "1";
* ``degrade_queue`` — graceful degradation: at this queue depth (or
  after device loss shrank the mesh) launches run DEGRADED — halved pad
  bucket, depth-capped traversal — and say so (``RequestStats.degraded``)
  rather than shedding;
* ``degraded_max_depth`` — the traversal depth cap degraded launches use
  (default: one level above the scene's leaves; conservative-superset
  verdicts, never a missed collision);
* ``target_p99_ms`` — the elastic-width SLO: with ``autoscale_shards``
  the batcher resizes the engine's collision mesh between launches when
  the windowed p99 (or queue depth) drifts past it.

Reliability contract (DESIGN.md §7): every ``submit`` resolves — to a
verdict, or to a typed :class:`ServiceError` — and a poisoned request
never fails an innocent co-batched one:

* plans are validated at submit (:func:`repro_torch.engine.plan.validate_plan`)
  so malformed OBBs die at admission, not inside a shared launch;
* a launch that still fails **bisect-retries**: the batch splits in half
  and each half relaunches, recursively, until the poisoned request is
  isolated and errors alone (``Counters.launch_splits`` counts splits);
* per-request deadlines (``submit(..., deadline_ms=...)``) shed requests
  whose deadline cannot be met — queued time plus the EWMA of recent
  launch exec times already past due — with :class:`DeadlineExceeded`
  BEFORE wasting a launch on them;
* a watchdog thread detects a dead worker, fails its unresolved in-flight
  tickets with :class:`WorkerDied`, and restarts the worker so the
  service self-heals (``Counters.worker_restarts``);
* device loss inside the sharded mesh is recovered BELOW the batcher
  (``_exec_sharded`` re-shards over the survivors, bitwise-identical —
  ``Counters.reshards``); only a mesh with no survivors surfaces here,
  failing the whole batch with :class:`DeviceLost` (never bisected: the
  loss is not attributable to any one request);
* scene swaps route through the worker (:meth:`RequestBatcher.rebind`),
  so a ``rebind_octrees`` can never race a live launch's traversal-cache
  or capacity-memo state;
* ``close()`` fails everything still queued (or racing the drain) with
  :class:`BatcherClosed`; submit after close raises the same type.

The coalesced pool pads up to a power-of-two bucket (``pad_pow2``) with
degenerate OBBs far outside the scene — they fail the root test and die
at level 0 — so the engine sees O(log max_batch) distinct pool widths
(capacity-memo keys) instead of one per arrival pattern.  The pad count is
reported in ``Counters.pad_queries``.

Per-request latency accounting (:class:`RequestStats`): ``wait_s`` is
admission (submit -> launch), ``exec_s`` the shared engine call,
``total_s`` their sum — the quantities the serve harness turns into
p50/p99 SLO rows — plus the reliability fields ``retries`` (transient
relaunches the request rode through) and ``splits`` (bisect depth).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import logging
import queue
import threading
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.counters import Counters
from repro_torch.core.geometry import OBBs
from repro_torch.engine.executor import CollisionEngine, device_loss_count
from repro_torch.engine.plan import (PlanValidationError, QueryPlan,
                                     plan_queries, validate_plan)

#: Admission-policy knobs of the batcher (drift-guarded against the
#: DESIGN.md §6 admission table).
ADMISSION_KNOBS = ("max_batch", "max_wait_ms", "max_queue",
                   "launch_timeout_s", "max_retries", "max_queue_work",
                   "degrade_queue", "degraded_max_depth", "target_p99_ms")

#: Lifecycle of a submitted request's ticket (:attr:`BatchTicket.state`).
TICKET_STATES = ("queued", "launched", "done")

logger = logging.getLogger(__name__)


class ServiceError(RuntimeError):
    """Base of every typed error the service resolves a ticket with."""


class BatcherClosed(ServiceError):
    """The batcher shut down before (or while) this request could launch."""


class Overloaded(ServiceError):
    """Admission queue is full: the request was shed at submit."""


class DeadlineExceeded(ServiceError):
    """The request's deadline could not be met; it was never launched."""


class LaunchStalled(ServiceError):
    """An engine call outlived ``launch_timeout_s``; the batch was failed
    so no client hangs on a wedged device."""


class WorkerDied(ServiceError):
    """The worker thread died mid-launch; the watchdog failed this ticket
    and restarted the worker."""


class DeviceLost(ServiceError):
    """The sharded collision mesh lost devices and had NO survivors to
    re-shard onto (a recoverable loss never reaches clients — the
    executor relaunches on the surviving set, bitwise-identical).  The
    whole batch fails typed, never bisected: device loss is not
    attributable to any one request."""


@dataclasses.dataclass
class RequestStats:
    """Latency + batching accounting for one submitted request."""

    wait_s: float          # submit -> batch launch (admission queueing)
    exec_s: float          # the shared engine call the request rode in
    total_s: float         # wait_s + exec_s (client-observed latency)
    batch_requests: int    # requests coalesced into the launch
    batch_queries: int     # live query slots in the coalesced pool
    pad_queries: int       # dead pow2-bucket pad slots in the pool
    retries: int = 0       # transient-failure relaunches before success
    splits: int = 0        # bisect-retry depth the request rode through
    degraded: bool = False  # served in declared degraded mode (halved pad
    #                         bucket + depth-capped traversal): verdicts
    #                         are a conservative superset — no silent
    #                         quality loss, the response says what it is


class BatchTicket:
    """Handle returned by :meth:`RequestBatcher.submit`.

    Resolution is idempotent and first-wins: whichever of the worker, the
    bisect-retry path, or the watchdog resolves the ticket first decides
    the outcome, so an abandoned stalled launch completing late can never
    overwrite the error the client already saw.
    """

    def __init__(self):
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._value: Optional[np.ndarray] = None
        self._stats: Optional[RequestStats] = None
        self._error: Optional[BaseException] = None
        self._state = "queued"

    @property
    def state(self) -> str:
        """``"queued"`` (awaiting admission), ``"launched"`` (riding an
        engine call), or ``"done"`` (:meth:`result` will not block)."""
        return self._state

    def result(self, timeout: Optional[float] = None
               ) -> Tuple[np.ndarray, RequestStats]:
        """Block until the request resolves; returns (un-flattened
        verdicts, per-request stats) or raises the typed error the
        request failed with.  Safe to call again after a
        :class:`TimeoutError` — the ticket stays live until resolved.
        """
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"collision request not done after {timeout}s "
                f"(state: {self._state})")
        if self._error is not None:
            raise self._error
        return self._value, self._stats

    def done(self) -> bool:
        return self._event.is_set()

    # -- resolution (batcher-internal, first call wins) -------------------
    def _mark_launched(self) -> None:
        with self._lock:
            if not self._event.is_set():
                self._state = "launched"

    def _resolve(self, value, stats: RequestStats) -> bool:
        with self._lock:
            if self._event.is_set():
                return False
            self._value, self._stats = value, stats
            self._state = "done"
            self._event.set()
            return True

    def _fail(self, error: BaseException) -> bool:
        with self._lock:
            if self._event.is_set():
                return False
            self._error = error
            self._state = "done"
            self._event.set()
            return True


@dataclasses.dataclass
class _Pending:
    plan: QueryPlan
    ticket: BatchTicket
    t_submit: float
    t_deadline: Optional[float] = None   # absolute perf_counter deadline
    work: int = 0                        # predicted work units (admission)


@dataclasses.dataclass
class _Rebind:
    """A scene swap queued behind the in-flight requests: the worker
    executes it between launches, so ``rebind_octrees`` can never race a
    live launch (part of DESIGN.md §7's isolation story)."""

    octree: object
    event: threading.Event
    error: Optional[BaseException] = None


_STOP = object()

#: Launches between elastic-width changes: long enough for the latency
#: window to reflect the new mesh before the next decision.
_RESCALE_COOLDOWN = 4


def _pad_bucket(n: int, floor: int = 64) -> int:
    b = floor
    while b < n:
        b <<= 1
    return b


def _is_transient(e: BaseException) -> bool:
    """Transient = worth retrying the SAME batch: allocator pressure, not
    a poisoned request.  Matches the RESOURCE_EXHAUSTED string (XLA's
    OOMs in the reference), anything flagged ``transient`` (injected
    ones) and ``torch.cuda.OutOfMemoryError``, PyTorch's spelling of the
    same runtime condition."""
    return bool(getattr(e, "transient", False)) \
        or "RESOURCE_EXHAUSTED" in str(e) \
        or isinstance(e, torch.cuda.OutOfMemoryError)


class RequestBatcher:
    """Coalesce concurrent small plans into single engine launches.

    ``engine`` is any :class:`repro_torch.engine.executor.CollisionEngine`
    bound to ONE scene — including a sharded one (``cfg.shards``), which
    is how the service stacks continuous batching on top of the device
    mesh — or a :class:`repro_torch.engine.faults.FaultyEngine` wrapping one
    (chaos mode).  Accepts boolean single-scene plans of any workload
    kind; the verdicts come back through each plan's own ``unflatten``
    recipe, so a trajectory client gets per-waypoint flags while an OBB
    client gets per-query booleans out of the same coalesced launch.
    """

    def __init__(self, engine: CollisionEngine, max_batch: int = 1024,
                 max_wait_ms: float = 2.0, pad_pow2: bool = True,
                 max_queue: int = 4096,
                 launch_timeout_s: Optional[float] = None,
                 max_retries: int = 2, retry_backoff_ms: float = 1.0,
                 max_queue_work: Optional[int] = None,
                 degrade_queue: Optional[int] = None,
                 degraded_max_depth: Optional[int] = None,
                 autoscale_shards: bool = False,
                 target_p99_ms: Optional[float] = None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        if max_queue_work is not None and max_queue_work < 1:
            raise ValueError(
                f"max_queue_work must be >= 1, got {max_queue_work}")
        if degrade_queue is not None and degrade_queue < 1:
            raise ValueError(
                f"degrade_queue must be >= 1, got {degrade_queue}")
        if degraded_max_depth is not None and degraded_max_depth < 1:
            raise ValueError(
                f"degraded_max_depth must be >= 1, got {degraded_max_depth}")
        self.engine = engine
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self.pad_pow2 = pad_pow2
        self.max_queue = max_queue
        self.launch_timeout_s = launch_timeout_s
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_ms / 1e3
        self.max_queue_work = max_queue_work
        self.degrade_queue = degrade_queue
        self.degraded_max_depth = degraded_max_depth
        self.autoscale_shards = autoscale_shards
        self.target_p99_ms = target_p99_ms
        #: Aggregate engine counters over every launch (includes pads),
        #: plus the §7 reliability counters (rejected/retried/
        #: deadline_missed/launch_splits/worker_restarts/reshards/
        #: shards_lost/shard_rescales/degraded_launches).
        self.totals = Counters()
        self.num_launches = 0
        self._queue: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self._closed = False
        self._closed_event = threading.Event()
        # Requests the CURRENT launch is carrying: the watchdog fails the
        # unresolved ones if the worker dies under them.
        self._inflight: List[_Pending] = []
        # Deadline-shedding estimates, PER pow2 pad bucket: one global
        # EWMA made a 64-wide launch after a 1024-wide one inherit a
        # wildly pessimistic estimate and over-shed.  Buckets the service
        # has not measured yet fall back to the work-rate EWMA
        # (seconds per predicted work unit), which scales the estimate
        # with the bucket instead of pinning it to the largest one seen.
        self._exec_ewma: dict = {}
        self._work_rate: Optional[float] = None
        # Predicted work units currently queued (work-based admission).
        self._queued_work = 0
        # Queue depth observed as the current launch formed (see
        # _run_inner); feeds the degrade decision alongside live qsize.
        self._pressure = 0
        # Launch threads abandoned by the stall watchdog, still running
        # their engine call; close() bounded-joins them so a process
        # exiting right after a stall doesn't tear down the interpreter
        # under a live launch.
        self._abandoned: List[threading.Thread] = []
        # Client-observed latencies of recent requests: the autoscaler's
        # p99 window.
        self._lat_window: collections.deque = collections.deque(maxlen=64)
        self._last_rescale_launch = -_RESCALE_COOLDOWN
        # The card every engine call of this batcher's threads runs under
        # (None for a CPU or duck-typed engine).
        dev = getattr(engine, "device", None)
        if isinstance(dev, torch.device) and dev.type == "cuda":
            self._cuda: Optional[torch.device] = torch.device(
                "cuda", dev.index if dev.index is not None
                else torch.cuda.current_device())
        else:
            self._cuda = None
        self._worker = self._start_worker()
        self._watchdog = threading.Thread(target=self._watch, daemon=True,
                                          name="collision-watchdog")
        self._watchdog.start()

    def _start_worker(self) -> threading.Thread:
        t = threading.Thread(target=self._run, daemon=True,
                             name="collision-batcher")
        t.start()
        return t

    # ------------------------------------------------------------------
    def submit(self, plan_or_obbs, deadline_ms: Optional[float] = None,
               validate: bool = True) -> BatchTicket:
        """Enqueue one request; returns a ticket to block on.

        Takes a lowered boolean plan, or bare :class:`OBBs` as shorthand
        for ``plan_queries``.  ``deadline_ms`` is a client-observed
        latency budget from NOW: a request the batcher cannot launch in
        time fails fast with :class:`DeadlineExceeded` instead of riding
        a launch whose result nobody wants.  ``validate=False`` skips the
        malformed-plan admission check (trusted in-process callers only;
        the chaos suite uses it to prove what validation protects
        against).

        Raises :class:`BatcherClosed` after :meth:`close`,
        :class:`Overloaded` when the admission queue is full, and
        :class:`repro_torch.engine.plan.PlanValidationError` for malformed
        plans — all before the request can touch a shared launch.
        """
        t_submit = time.perf_counter()
        plan = (plan_queries(plan_or_obbs)
                if isinstance(plan_or_obbs, OBBs) else plan_or_obbs)
        if plan.grouped:
            raise ValueError(
                "the batcher coalesces boolean plans; owner/payload "
                "verdict groups cannot share a pool with other requests")
        if plan.num_scenes != 1:
            raise ValueError(
                "the batcher serves single-scene plans against the "
                "engine's bound scene")
        if self._closed:
            raise BatcherClosed("batcher is closed")
        if validate:
            try:
                validate_plan(plan)
            except PlanValidationError:
                with self._lock:
                    self.totals.rejected += 1
                raise
        if self._queue.qsize() >= self.max_queue:
            with self._lock:
                self.totals.rejected += 1
            raise Overloaded(
                f"admission queue full ({self.max_queue} requests "
                f"queued); shedding new arrivals")
        work = plan.work_units(self._scene_nodes())
        if self.max_queue_work is not None:
            with self._lock:
                # One oversized request with an empty queue still admits
                # (like an over-max_batch request still launching alone);
                # the bound sheds ADDITIONAL work on top of a backlog.
                shed = (self._queued_work > 0
                        and self._queued_work + work > self.max_queue_work)
                if shed:
                    self.totals.rejected += 1
            if shed:
                raise Overloaded(
                    f"admission queue holds {self._queued_work} predicted "
                    f"work units; adding {work} would exceed "
                    f"max_queue_work={self.max_queue_work} — shedding")
        deadline = (None if deadline_ms is None
                    else t_submit + deadline_ms / 1e3)
        pending = _Pending(plan, BatchTicket(), t_submit, deadline, work)
        with self._lock:
            self._queued_work += work
        self._queue.put(pending)
        if self._closed:
            # Raced close(): the final drain may already have run past
            # the queue, so fail the ticket here (first-wins makes a
            # double fail harmless) and surface the typed error.
            if pending.ticket._fail(BatcherClosed(
                    "batcher closed while this request was being "
                    "submitted")):
                with self._lock:
                    self.totals.rejected += 1
            raise BatcherClosed("batcher is closed")
        return pending.ticket

    def close(self, timeout: float = 30.0) -> None:
        """Launch what is already queued, then stop the worker; everything
        that cannot launch fails with :class:`BatcherClosed` — no ticket
        is ever silently dropped."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._queue.put(_STOP)
        self._worker.join(timeout)
        self._closed_event.set()
        self._watchdog.join(timeout)
        # Bounded wait for launches the stall watchdog abandoned (their
        # results were already discarded by first-wins resolution); a
        # genuinely wedged one stays daemon and cannot block close.
        t_end = time.perf_counter() + timeout
        for th in self._abandoned:
            th.join(max(0.0, t_end - time.perf_counter()))
        # Final drain: anything still queued (worker dead/stuck, or a
        # submit that raced the worker's own drain) fails typed.
        self._drain_closed()
        if self._worker.is_alive():
            # The drain took the stop marker too: leave one for a worker
            # still inside a launch, so that it ends when the launch does
            # instead of waiting on the empty queue for good.
            self._queue.put(_STOP)

    def rebind(self, octree, timeout: Optional[float] = 60.0) -> None:
        """Swap the engine's bound scene(s) THROUGH the worker thread.

        Calling ``engine.rebind_octrees`` directly under a live batcher
        races the launch path: a rebind mid-launch swaps the device
        tables, scene signature and capacity memo out from under an
        in-flight traversal.  This routes the swap into the admission
        queue instead — FIFO with the requests around it, executed by
        the worker strictly BETWEEN launches — and blocks until applied.
        Requests submitted before the rebind run against the old scene,
        requests after it against the new one.
        """
        if self._closed:
            raise BatcherClosed("batcher is closed")
        r = _Rebind(octree, threading.Event())
        self._queue.put(r)
        if not r.event.wait(timeout):
            raise TimeoutError(f"scene rebind not applied after {timeout}s")
        if r.error is not None:
            raise r.error

    def _scene_nodes(self) -> int:
        """Per-query factor of the predicted-work estimate; 1 for duck-
        typed engines that don't expose a node count (work then reduces
        to the query count — the v1 behavior)."""
        return max(1, int(getattr(self.engine, "scene_nodes", 1)))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------
    def _drain_closed(self) -> None:
        """Fail every request still in the admission queue: the batcher is
        closing and they will never launch."""
        while True:
            try:
                p = self._queue.get_nowait()
            except queue.Empty:
                return
            if p is _STOP:
                continue
            if isinstance(p, _Rebind):
                p.error = BatcherClosed(
                    "batcher closed before this rebind applied")
                p.event.set()
                continue
            with self._lock:
                self._queued_work -= p.work
            if p.ticket._fail(BatcherClosed(
                    "batcher closed before this request launched")):
                with self._lock:
                    self.totals.rejected += 1

    def _watch(self) -> None:
        """Liveness watchdog: a worker that dies (an exception escaping
        the per-launch containment — a real bug, or an injected
        ``WorkerKill``) leaves its batch's tickets unresolved and every
        queued client stranded.  Detect it, fail the unresolved in-flight
        tickets with a diagnosable :class:`WorkerDied`, and restart the
        worker so queued and future requests keep being served."""
        while not self._closed_event.wait(0.05):
            if self._worker.is_alive():
                continue
            with self._lock:
                if self._closed:
                    return
                self.totals.worker_restarts += 1
                inflight, self._inflight = self._inflight, []
            for p in inflight:
                p.ticket._fail(WorkerDied(
                    "collision-batcher worker died mid-launch; the "
                    "watchdog restarted it — resubmit if the request "
                    "is still wanted"))
            self._worker = self._start_worker()

    # ------------------------------------------------------------------
    def _on_device(self):
        """The engine's card as the thread's current device (no-op off
        CUDA)."""
        if self._cuda is None:
            return contextlib.nullcontext()
        return torch.cuda.device(self._cuda)

    def _run(self):
        try:
            with self._on_device():
                self._run_inner()
        except BaseException as e:                # noqa: BLE001
            if not getattr(e, "fatal", False):
                raise      # real bug: traceback + watchdog restart
            # Injected worker death (chaos): die quietly — the thread
            # ending WITHOUT resolving its tickets is the scenario, and
            # the watchdog is the handler; no traceback spam.

    def _do_rebind(self, r: _Rebind) -> None:
        """Apply a queued scene swap (worker thread, between launches).
        The measured exec estimates describe the OLD scene's traversal
        cost, so they reset with it."""
        try:
            self.engine.rebind_octrees(r.octree)
            with self._lock:
                self._exec_ewma.clear()
                self._work_rate = None
        except BaseException as e:                # noqa: BLE001
            r.error = e
        finally:
            r.event.set()

    def _run_inner(self):
        while True:
            first = self._queue.get()
            if first is _STOP:
                self._drain_closed()
                return
            if isinstance(first, _Rebind):
                self._do_rebind(first)
                continue
            with self._lock:
                self._queued_work -= first.work
            # Backlog behind this launch as it forms: coalescing drains
            # the queue, so the overload signal must be read BEFORE it
            # (a launch that absorbs the whole backlog is still a launch
            # that formed under pressure).
            self._pressure = self._queue.qsize()
            batch = [first]
            total = first.plan.num_queries
            deadline = time.perf_counter() + self.max_wait_s
            stop = False
            rebind = None
            while total < self.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is _STOP:
                    stop = True
                    break
                if isinstance(nxt, _Rebind):
                    # Stop coalescing: requests queued BEFORE the rebind
                    # launch against the old scene first (FIFO), then the
                    # swap applies.
                    rebind = nxt
                    break
                with self._lock:
                    self._queued_work -= nxt.work
                batch.append(nxt)
                total += nxt.plan.num_queries
            self._admit(batch)
            if rebind is not None:
                self._do_rebind(rebind)
            if stop:
                self._drain_closed()
                return

    def _estimate_exec_s(self, num_queries: int) -> float:
        """Deadline-shedding estimate for a pool of this many live query
        slots: the pad bucket's own EWMA when measured, else the
        work-rate EWMA scaled to this bucket, else 0 (optimistic — never
        shed on no data)."""
        bucket = _pad_bucket(num_queries) if self.pad_pow2 else num_queries
        est = self._exec_ewma.get(bucket)
        if est is not None:
            return est
        if self._work_rate is not None:
            return self._work_rate * self._scene_nodes() * bucket
        return 0.0

    def _admit(self, batch: List[_Pending]) -> None:
        """Deadline shedding at launch time: a request whose budget is
        already spent — or will be by the end of an average engine call —
        is failed fast, never launched dead."""
        now = time.perf_counter()
        est = self._estimate_exec_s(sum(p.plan.num_queries for p in batch))
        live = []
        for p in batch:
            if p.t_deadline is not None and now + est > p.t_deadline:
                with self._lock:
                    self.totals.deadline_missed += 1
                p.ticket._fail(DeadlineExceeded(
                    f"deadline unmeetable: {1e3 * (now - p.t_submit):.1f}ms "
                    f"queued + ~{1e3 * est:.1f}ms estimated exec exceeds "
                    f"the {1e3 * (p.t_deadline - p.t_submit):.1f}ms budget"))
            else:
                live.append(p)
        if live:
            self._launch(live)

    def _pad_obbs(self, n: int) -> OBBs:
        """Degenerate pad queries: point-sized OBBs far outside the scene
        AABB, so the root-cell test fails and each pad retires at level 0
        with one node visit of work."""
        lo = np.asarray(self.engine.octree.scene_lo, np.float32)
        far = torch.from_numpy(lo - np.float32(1e6))
        return OBBs(center=far.expand(n, 3).contiguous(),
                    half=torch.full((n, 3), 1e-6, dtype=torch.float32),
                    rot=torch.eye(3, dtype=torch.float32).expand(
                        n, 3, 3).contiguous())

    def _call_engine(self, plan: QueryPlan,
                     max_depth: Optional[int] = None):
        """One engine execute under the liveness bound: with
        ``launch_timeout_s`` set the call runs on a monitored thread, and
        on timeout the batch fails with :class:`LaunchStalled` while the
        abandoned call finishes (or hangs) on its daemon thread — its
        late result is discarded by first-wins ticket resolution."""
        # Only degraded launches pass max_depth, so duck-typed engines
        # with an execute(plan)-only signature keep working un-degraded.
        kw = {} if max_depth is None else {"max_depth": max_depth}
        if self.launch_timeout_s is None:
            with self._on_device():
                return self.engine.execute(plan, **kw)
        box: dict = {}

        def target():
            try:
                with self._on_device():
                    box["out"] = self.engine.execute(plan, **kw)
            except BaseException as e:            # noqa: BLE001
                box["err"] = e

        th = threading.Thread(target=target, daemon=True,
                              name="collision-launch")
        th.start()
        th.join(self.launch_timeout_s)
        if th.is_alive():
            # Track the abandoned thread so close() can wait for it:
            # exiting the process while it is still inside a launch aborts
            # interpreter teardown.
            self._abandoned.append(th)
            raise LaunchStalled(
                f"engine call exceeded launch_timeout_s="
                f"{self.launch_timeout_s}; failing the batch so no "
                f"client hangs on a wedged launch")
        if "err" in box:
            raise box["err"]
        return box["out"]

    def _should_degrade(self) -> bool:
        """Degrade rather than shed (DESIGN.md §7): under sustained
        overload (queue at ``degrade_queue``) or while device loss has
        the mesh below its configured width."""
        if self.degrade_queue is not None \
                and max(self._queue.qsize(),
                        self._pressure) >= self.degrade_queue:
            return True
        active = getattr(self.engine, "active_shards", None)
        configured = getattr(getattr(self.engine, "cfg", None),
                             "shards", None)
        return (active is not None and configured is not None
                and active < configured)

    def _degraded_depth(self) -> Optional[int]:
        """Traversal depth cap for degraded launches: the configured
        ``degraded_max_depth``, defaulting to one level above the leaves;
        None when the engine's mode has no cap (degradation is then the
        halved pad bucket alone)."""
        if not getattr(self.engine, "supports_depth_cap", False):
            return None
        if self.degraded_max_depth is not None:
            return self.degraded_max_depth
        return max(1, self.engine.octree.depth - 1)

    def _execute_with_retry(self, batch: List[_Pending],
                            degraded: bool = False):
        """Build the coalesced pool and execute it, retrying transient
        failures with exponential backoff.  An oversized pow2 pad bucket
        shrinks toward the exact pool width across retries (the
        RESOURCE_EXHAUSTED response: ask for less).  A degraded launch
        starts from a HALVED pad bucket and caps traversal depth.
        Returns (verdict, counters, live, pad, retries)."""
        c, h, r = ([torch.as_tensor(getattr(p.plan, f)).cpu() for p in batch]
                   for f in ("obb_c", "obb_h", "obb_r"))
        live = sum(a.shape[0] for a in c)
        bucket = _pad_bucket(live) if self.pad_pow2 else live
        max_depth = None
        if degraded:
            bucket = max(live, bucket >> 1)
            max_depth = self._degraded_depth()
        retries = 0
        while True:
            pad = bucket - live
            cc, hh, rr = list(c), list(h), list(r)
            if pad:
                po = self._pad_obbs(pad)
                cc.append(po.center)
                hh.append(po.half)
                rr.append(po.rot)
            pool = OBBs(center=torch.cat(cc), half=torch.cat(hh),
                        rot=torch.cat(rr))
            try:
                verdict, counters = self._call_engine(plan_queries(pool),
                                                      max_depth)
                return verdict, counters, live, pad, retries
            except BaseException as e:            # noqa: BLE001
                if not _is_transient(e) or retries >= self.max_retries:
                    raise
                retries += 1
                with self._lock:
                    self.totals.retried += 1
                if bucket > live:                 # retry at half width
                    bucket = max(live, bucket >> 1)
                time.sleep(self.retry_backoff_s * (1 << (retries - 1)))

    def _launch(self, batch: List[_Pending], depth: int = 0):
        """Launch one coalesced batch; on failure, bisect-retry so only
        the poisoned request's ticket errors while innocent co-riders
        complete (fault isolation, DESIGN.md §7)."""
        t_launch = time.perf_counter()
        for p in batch:
            p.ticket._mark_launched()
        with self._lock:
            self._inflight = list(batch)
        degraded = self._should_degrade()
        try:
            verdict, counters, live, pad, retries = \
                self._execute_with_retry(batch, degraded)
            counters.pad_queries += pad
            if degraded:
                counters.degraded_launches += 1
            t_done = time.perf_counter()
            exec_s = t_done - t_launch
            width = live + pad
            with self._lock:
                self.totals.merge(counters)
                self.num_launches += 1
                prev = self._exec_ewma.get(width)
                self._exec_ewma[width] = (
                    exec_s if prev is None else 0.5 * prev + 0.5 * exec_s)
                rate = exec_s / max(self._scene_nodes() * width, 1)
                self._work_rate = (
                    rate if self._work_rate is None
                    else 0.5 * self._work_rate + 0.5 * rate)
            off = 0
            for p in batch:
                q = p.plan.num_queries
                stats = RequestStats(
                    wait_s=t_launch - p.t_submit,
                    exec_s=exec_s,
                    total_s=t_done - p.t_submit,
                    batch_requests=len(batch), batch_queries=live,
                    pad_queries=pad, retries=retries, splits=depth,
                    degraded=degraded)
                p.ticket._resolve(p.plan.unflatten(verdict[off:off + q]),
                                  stats)
                self._lat_window.append(stats.total_s)
                off += q
            if depth == 0:
                self._maybe_rescale()
        except BaseException as e:                    # noqa: BLE001
            if getattr(e, "fatal", False):
                # Simulated (or real) worker death: propagate WITHOUT
                # resolving tickets — the watchdog's job is to catch
                # exactly this and fail the in-flight tickets itself.
                raise
            if device_loss_count(e) is not None:
                # The executor already tried every surviving subset; a
                # loss surfacing here means the mesh has no devices left
                # to re-shard onto.  Not attributable to any request —
                # the whole batch fails typed, never bisected.
                err = DeviceLost(
                    f"collision mesh lost its devices with no survivors "
                    f"to re-shard onto: {e}")
                for p in batch:
                    p.ticket._fail(err)
                return
            if len(batch) == 1 or isinstance(e, LaunchStalled):
                # A singleton owns its failure; a stall is not
                # attributable to any one request, so the whole batch
                # fails typed rather than stalling again per half.
                for p in batch:
                    p.ticket._fail(e)
                return
            # Bisect-retry: the failure rode in with SOME request; split
            # the batch and relaunch each half so the poison isolates to
            # a singleton while everyone else completes.
            with self._lock:
                self.totals.launch_splits += 1
            mid = len(batch) // 2
            self._launch(batch[:mid], depth + 1)
            self._launch(batch[mid:], depth + 1)

    def _maybe_rescale(self) -> None:
        """Elastic width (DESIGN.md §6): between launches, resize the
        engine's collision mesh when the windowed p99 or the queue depth
        drifts past the SLO.  Doubling under pressure / halving when
        comfortably idle, cooled down so the window reflects each new
        width before the next decision.  A rescale re-probes the full
        device set, which is also how devices lost to a recovery rejoin.
        """
        if not self.autoscale_shards:
            return
        eng = self.engine
        cur = getattr(eng, "active_shards", None)
        if cur is None or not hasattr(eng, "set_shards"):
            return
        if self.num_launches - self._last_rescale_launch < _RESCALE_COOLDOWN:
            return
        n_dev = len(getattr(eng, "shard_devices", ()))
        lat = sorted(self._lat_window)
        p99 = (lat[min(len(lat) - 1, int(0.99 * len(lat)))]
               if lat else None)
        target_s = (None if self.target_p99_ms is None
                    else self.target_p99_ms / 1e3)
        depth = self._queue.qsize()
        new = None
        if cur < n_dev and (
                (target_s is not None and p99 is not None and p99 > target_s)
                or depth >= max(1, self.max_queue // 2)):
            new = min(cur * 2, n_dev)
        elif cur > 1 and depth == 0 and target_s is not None \
                and p99 is not None and p99 < target_s / 4:
            new = max(1, cur // 2)
        if new is None or new == cur:
            return
        try:
            eng.set_shards(new)
        except Exception as e:                        # noqa: BLE001
            logger.warning("elastic rescale %d -> %d shards failed: %s",
                           cur, new, e)
            return
        logger.info(
            "elastic rescale: %d -> %d shards (p99 %.1fms vs target %s, "
            "queue depth %d)", cur, new,
            0.0 if p99 is None else 1e3 * p99, self.target_p99_ms, depth)
        with self._lock:
            self.totals.shard_rescales += 1
            self._last_rescale_launch = self.num_launches
        # Old-width latencies no longer describe the mesh being measured.
        self._lat_window.clear()
