"""Fault tolerance: preemption handling and straggler mitigation.

Counterpart of ``repro.train.ft``.  ``PreemptionGuard`` flips a flag on
SIGTERM (or ``trigger()``); the train loop checkpoints at the next step
boundary and exits.  ``PrefetchingLoader`` keeps a bounded queue filled by
a background thread; if the producer misses the deadline the loop reuses
the last good batch (the skip policy) and counts it.  One change from the
reference: every wait is bounded.  The reference's cold start waits for
the first batch without end; here it waits ``cold_start_s`` and raises
``TimeoutError``, and the producer's puts poll a stop flag, so
``close()`` ends the thread.
"""
from __future__ import annotations

import queue
import signal
import threading
from typing import Iterator


class PreemptionGuard:
    def __init__(self, signals=(signal.SIGTERM,)):
        self._flag = threading.Event()
        self._installed = False
        self._signals = signals

    def install(self):
        for s in self._signals:
            try:
                signal.signal(s, self._handler)
            except ValueError:
                pass  # non-main thread (tests)
        self._installed = True
        return self

    def _handler(self, signum, frame):
        self._flag.set()

    def trigger(self):                    # for tests
        self._flag.set()

    @property
    def should_checkpoint(self) -> bool:
        return self._flag.is_set()


class PrefetchingLoader:
    """Bounded-queue prefetcher with straggler skip.

    ``next_batch(deadline_s)``: returns the next batch, or - if the
    producer is slower than the deadline - the previous batch again
    (counted in ``.skipped``).  The first batch is waited for at most
    ``cold_start_s``.  Never blocks the step loop without a bound.
    """

    #: How often a blocked producer looks at the stop flag, in seconds.
    POLL_S = 0.1

    def __init__(self, it: Iterator, depth: int = 2,
                 cold_start_s: float = 600.0):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._last = None
        self._cold_start_s = cold_start_s
        self._stop = threading.Event()
        self.skipped = 0
        self._done = False
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        try:
            for item in self._it:
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=self.POLL_S)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
        finally:
            self._done = True

    def next_batch(self, deadline_s: float = 10.0):
        try:
            b = self._q.get(timeout=deadline_s)
            self._last = b
            return b
        except queue.Empty:
            if self._last is None:
                # cold start: wait for the first batch, within a bound
                try:
                    b = self._q.get(timeout=self._cold_start_s)
                except queue.Empty:
                    raise TimeoutError(
                        f"no first batch within {self._cold_start_s} s"
                    ) from None
                self._last = b
                return b
            self.skipped += 1
            return self._last

    def close(self, timeout_s: float = 5.0) -> None:
        """Stop the producer and wait for its thread at most
        ``timeout_s``."""
        self._stop.set()
        self._thread.join(timeout=timeout_s)
