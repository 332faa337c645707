"""Work model of the collision engine, field for field as in ``repro``.

The port reproduces every counter exactly as the JAX reference defines it,
whatever the H100 does in hardware: the counters are a model of the work a
conditional-return machine would execute (axis tests executed vs decoded,
sphere tests, nodes per level, exit-code histogram) and of the bytes the
fused traversal would move, not a measurement.

Bytes model (f32), unchanged from the reference:
  unfused test  = 84 (boxes) + 2*108 (terms round trip) + 2*60 (margins) + 4
                = 424 B
  fused test    = 84 + 8 (result+exit code)              = 92 B
  fused step    = 40 B per live (query, node) pair per level
  persistent    = 16 B per query (seed in, verdict out)
                  + 24 B per spilled pair
                  + streamed metadata rows at the row format's width
                    (fp32 16 B, bf16 8 B, u8 4 B)
  payload lane  = 4 B per carried owner / payload lane
  shader handoff (Mochi) = 128 B per reported hit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

BYTES_UNFUSED_TEST = 424
BYTES_FUSED_TEST = 92
BYTES_FUSED_STEP = 40
BYTES_PERSIST_QUERY = 16
BYTES_PERSIST_SPILL = 24
BYTES_META_STREAM = 16
BYTES_META_STREAM_BF16 = 8
BYTES_META_STREAM_U8 = 4
BYTES_PAYLOAD_LANE = 4
BYTES_SHADER_HANDOFF = 128
NUM_EXIT_CODES = 18


@dataclasses.dataclass
class Counters:
    """Aggregate work counters for one engine invocation."""

    num_queries: int = 0
    nodes_traversed: int = 0            # (query, node) pairs tested
    nodes_per_level: List[int] = dataclasses.field(default_factory=list)
    leaf_tests: int = 0                 # tests against terminal (leaf/full) nodes
    axis_tests_executed: int = 0        # conditional-return work model
    axis_tests_decoded: int = 0         # predication / no-exit work model
    sphere_tests: int = 0
    exit_histogram: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(NUM_EXIT_CODES, np.int64))
    shader_invocations: int = 0
    bytes_moved: int = 0
    frontier_overflow: int = 0          # entries dropped at capacity (should be 0)
    escalations: int = 0                # overflow replays before a clean run
    meta_rows_streamed: int = 0         # HBM metadata rows DMA'd (streamed layout)
    meta_bytes_streamed: int = 0        # rows x the format's packed row width
    pad_queries: int = 0                # dead pool slots added by sharding /
    #                                     batch coalescing (zero work each —
    #                                     the live-prefix num_valid lane masks
    #                                     them — but they occupy pool width)
    ref_arm_fallbacks: int = 0          # persistent-mode plans the executor
    #                                     routed to the jnp ref arm instead of
    #                                     the Pallas kernel (capability gap,
    #                                     e.g. an owner group past MAX_TILE_BQ;
    #                                     each is also logged with the plan
    #                                     shape — MUST stay 0 in the kernel
    #                                     figure benches)
    # Service reliability counters (DESIGN.md §7): accumulated by the
    # RequestBatcher, reported in the fig_serve SLO rows.
    rejected: int = 0                   # shed at admission (malformed plan,
    #                                     full queue, or submit after close)
    retried: int = 0                    # transient-failure launch retries
    deadline_missed: int = 0            # failed pre-launch: deadline unmeetable
    launch_splits: int = 0              # bisect-retry splits isolating a
    #                                     poisoned request from co-riders
    worker_restarts: int = 0            # watchdog-detected worker deaths
    reshards: int = 0                   # device-loss recoveries: sharded
    #                                     launches re-sharded over the
    #                                     surviving device set and relaunched
    shards_lost: int = 0                # shard devices dropped from the
    #                                     collision mesh by those recoveries
    shard_rescales: int = 0             # elastic-width changes the batcher
    #                                     applied between launches (queue
    #                                     depth / p99 drifted past the SLO)
    degraded_launches: int = 0          # launches served in declared
    #                                     degraded mode (halved pad bucket,
    #                                     capped max_depth) instead of shed
    wall_time_s: float = 0.0

    def merge_exit_codes(self, codes: np.ndarray, valid: np.ndarray) -> None:
        hist = np.bincount(codes[valid].astype(np.int64),
                           minlength=NUM_EXIT_CODES)
        self.exit_histogram[:len(hist)] += hist

    def as_dict(self) -> Dict[str, object]:
        d = dataclasses.asdict(self)
        d["exit_histogram"] = self.exit_histogram.tolist()
        return d

    def merge(self, other: "Counters") -> None:
        """Accumulate another invocation's work into this one (batched
        front-end; wall clock is owned by the caller and left untouched)."""
        self.num_queries += other.num_queries
        self.nodes_traversed += other.nodes_traversed
        self.leaf_tests += other.leaf_tests
        self.axis_tests_executed += other.axis_tests_executed
        self.axis_tests_decoded += other.axis_tests_decoded
        self.sphere_tests += other.sphere_tests
        self.shader_invocations += other.shader_invocations
        self.bytes_moved += other.bytes_moved
        self.frontier_overflow += other.frontier_overflow
        self.escalations += other.escalations
        self.meta_rows_streamed += other.meta_rows_streamed
        self.meta_bytes_streamed += other.meta_bytes_streamed
        self.pad_queries += other.pad_queries
        self.ref_arm_fallbacks += other.ref_arm_fallbacks
        self.rejected += other.rejected
        self.retried += other.retried
        self.deadline_missed += other.deadline_missed
        self.launch_splits += other.launch_splits
        self.worker_restarts += other.worker_restarts
        self.reshards += other.reshards
        self.shards_lost += other.shards_lost
        self.shard_rescales += other.shard_rescales
        self.degraded_launches += other.degraded_launches
        self.exit_histogram += other.exit_histogram
        a, b = self.nodes_per_level, other.nodes_per_level
        self.nodes_per_level = [
            (a[i] if i < len(a) else 0) + (b[i] if i < len(b) else 0)
            for i in range(max(len(a), len(b)))]

    def early_exit_fraction(self, half: int = 7) -> float:
        """Fraction of tests that terminate within ``half`` axis tests.

        Paper §I: "around 60% of collision queries can be terminated early
        after less than half of the total tests".
        """
        total = int(self.exit_histogram.sum())
        if total == 0:
            return 0.0
        # sphere exits (codes 0,1) + axis exits with index < half
        early = int(self.exit_histogram[0] + self.exit_histogram[1]
                    + self.exit_histogram[2:2 + half].sum())
        return early / total
