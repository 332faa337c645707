"""Plan executor: one engine consuming :class:`repro_torch.engine.plan.QueryPlan`.

Counterpart of ``repro.engine.executor`` for ``mode="wavefront_persistent"``:
mode checks, capacity escalation (the frontier runs in a fixed-capacity
buffer; overflow is counted on the device and the query replays at 4x
capacity until clean) and counter assembly, around the persistent
megakernel of :mod:`repro_torch.kernels.persist`.

The engine runs on the card (``device="cuda"``, the default) or, when the
caller asks, on the CPU through the kernels' plain PyTorch versions; the
two give identical verdicts and counters.  Without a CUDA device a CUDA
engine raises; it never drops to the CPU by itself.  Modes, options and
plan shapes this slice has not ported raise ``NotImplementedError`` naming
the ROADMAP item that adds them.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.counters import (BYTES_FUSED_STEP, BYTES_META_STREAM,
                                       BYTES_META_STREAM_BF16,
                                       BYTES_META_STREAM_U8,
                                       BYTES_PAYLOAD_LANE,
                                       BYTES_PERSIST_QUERY,
                                       BYTES_PERSIST_SPILL,
                                       BYTES_UNFUSED_TEST, Counters)
from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.core.geometry import OBBs
from repro_torch.core.octree import DeviceOctree, Octree, device_octree
from repro_torch.core.quantize import META_FORMATS
from repro_torch.engine.plan import QueryPlan, plan_batch, plan_queries
from repro_torch.kernels.persist.ops import (H100_L2_BYTES,
                                             choose_meta_layout,
                                             require_ported_layout,
                                             traverse_whole)

MODES = ("naive", "rta_like", "staged_noexit", "predicated", "wavefront_host",
         "wavefront", "wavefront_fused", "wavefront_persistent")
#: Modes whose traversal runs fully on the device.
DEVICE_MODES = ("wavefront", "wavefront_fused", "wavefront_persistent")
#: CSR-frontier modes.
CSR_MODES = ("wavefront_fused", "wavefront_persistent")
#: Modes this port runs so far.
PORTED_MODES = ("wavefront_persistent",)


def _unported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    mode: str = "wavefront"
    use_spheres: bool = False      # MPAccel bounding/inscribing sphere pre-tests
    max_frontier: int = 1 << 20    # hard cap on live pairs per level
    min_bucket: int = 1024         # smallest frontier allocation
    query_block: int = 128         # naive-mode OBB block size
    frontier_capacity: Optional[int] = None  # static capacity (no escalation)
    use_pallas_compact: Optional[bool] = None   # reference field, unused here
    use_pallas_traverse: Optional[bool] = None  # reference field, unused here
    # Budget of the resident node-metadata table.  The field keeps the
    # reference's name; on the H100 the table is read through L2, so the
    # default is the card's L2 size, not the TPU's VMEM.
    vmem_budget: int = H100_L2_BYTES
    stream_meta: Optional[bool] = None
    meta_format: Optional[str] = None
    shards: Optional[int] = None

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(
                f"unknown engine mode {self.mode!r}; allowed modes: "
                f"{', '.join(MODES)}")
        if self.shards is not None:
            if self.mode not in DEVICE_MODES:
                raise ValueError(
                    f"shards={self.shards} needs a device-resident mode "
                    f"({', '.join(DEVICE_MODES)}), not {self.mode!r}")
            if self.shards < 1:
                raise ValueError(f"shards must be >= 1, got {self.shards}")
        if self.meta_format is not None:
            if self.meta_format not in META_FORMATS:
                raise ValueError(
                    f"unknown meta_format {self.meta_format!r}; allowed: "
                    f"{', '.join(META_FORMATS)}")
            if self.mode not in CSR_MODES:
                raise ValueError(
                    f"meta_format={self.meta_format!r} needs a CSR mode "
                    f"({', '.join(CSR_MODES)}), not {self.mode!r}: only the "
                    "CSR frontiers decode packed metadata rows")


def _bucket(n: int, cfg: EngineConfig) -> int:
    b = cfg.min_bucket
    while b < n:
        b <<= 1
    return min(b, cfg.max_frontier)


def frontier_capacity_bound(level_counts: Sequence[int], num_queries: int,
                            cfg: EngineConfig) -> int:
    """Static worst-case frontier size for a query set against one tree:
    level l+1 holds at most 8x level l, and never more than every query
    paired with every occupied node of that level."""
    if cfg.frontier_capacity is not None:
        return max(cfg.frontier_capacity, num_queries)
    bound = cap = num_queries                # level 0: one root cell
    for n_l in level_counts[1:]:
        bound = min(bound * 8, num_queries * n_l)
        cap = max(cap, bound)
    cap = min(cap, cfg.max_frontier)
    return max(_bucket(cap, cfg), num_queries)


def _initial_capacity(num_queries: int, cfg: EngineConfig) -> int:
    """First-attempt frontier bucket: the one that holds the level-0
    frontier (one pair per query); overflow replays buy more."""
    if cfg.frontier_capacity is not None:
        return max(cfg.frontier_capacity, num_queries)
    guess = min(max(num_queries, cfg.min_bucket), cfg.max_frontier)
    return max(_bucket(guess, cfg), num_queries)


def _escalate(run, num_queries: int, worst: int, cfg: EngineConfig,
              start: Optional[int] = None):
    """Run ``run(capacity)`` -> (verdict, stats), replaying at 4x capacity
    while the call reports frontier overflow; a pinned
    ``frontier_capacity`` disables escalation.  Returns (verdict, stats,
    clean_capacity, num_replays)."""
    cap = _initial_capacity(num_queries, cfg)
    if start is not None and cfg.frontier_capacity is None:
        cap = min(max(start, cap), max(worst, num_queries))
    replays = 0
    while True:
        verdict, st = run(cap)
        if cfg.frontier_capacity is not None or cap >= worst:
            return verdict, st, cap, replays
        if int(st["overflow"]) == 0:
            return verdict, st, cap, replays
        cap = min(max(cap * 4, cfg.min_bucket), worst)
        replays += 1


def _stats_to_counters(st, mode: str, replays: int = 0,
                       extra_lanes: int = 0,
                       meta_format: str = "fp32") -> Counters:
    st = {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v,
                        np.int64) for k, v in st.items()}
    c = Counters()

    def tot(x):
        return int(np.sum(st[x]))

    c.nodes_traversed = tot("nodes")
    c.leaf_tests = tot("leaf")
    c.axis_tests_executed = tot("axis_exec")
    c.axis_tests_decoded = tot("axis_dec")
    c.sphere_tests = tot("sphere")
    c.frontier_overflow = tot("overflow")
    c.escalations = replays
    per = st["per_level"]
    if per.ndim > 1:
        per = per.reshape(-1, per.shape[-1]).sum(axis=0)
    c.nodes_per_level = [int(n) for n in per if n > 0]
    hist = st["exit_hist"]
    c.exit_histogram += hist.reshape(-1, hist.shape[-1]).sum(axis=0)
    if "meta_rows" in st:
        c.meta_rows_streamed = tot("meta_rows")
    row_bytes = {"fp32": BYTES_META_STREAM, "bf16": BYTES_META_STREAM_BF16,
                 "u8": BYTES_META_STREAM_U8}[meta_format]
    c.meta_bytes_streamed = c.meta_rows_streamed * row_bytes
    extra = BYTES_PAYLOAD_LANE * extra_lanes
    if mode == "wavefront_persistent":
        seeds = int(per[0]) if per.size else 0
        c.bytes_moved = (seeds * (BYTES_PERSIST_QUERY + extra)
                         + c.frontier_overflow * BYTES_PERSIST_SPILL
                         + c.meta_bytes_streamed)
    elif mode == "wavefront_fused":
        c.bytes_moved = c.nodes_traversed * (BYTES_FUSED_STEP + extra)
    else:
        c.bytes_moved = c.nodes_traversed * (BYTES_UNFUSED_TEST + extra)
    return c


class CollisionEngine:
    """Octree collision queries for one fixed scene, on one device.

    ``device`` defaults to CUDA; pass ``device="cpu"`` to run the plain
    PyTorch versions of the kernels.  The engine is the executor of
    :class:`repro_torch.engine.plan.QueryPlan`; ``query`` and
    ``query_batched`` build the obvious plan.
    """

    def __init__(self, octree: Union[Octree, List[Octree]],
                 config: EngineConfig = EngineConfig(),
                 device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        if config.mode not in PORTED_MODES:
            raise _unported(f"mode {config.mode!r}", "A.6")
        if config.shards is not None:
            raise _unported("sharded execution (EngineConfig.shards)", "A.8")
        self.cfg = config
        # Last clean frontier capacity per (query shape, scene signature).
        self._cap_memo: dict = {}
        #: Frontier capacity of the last call's clean run.
        self.last_capacity: Optional[int] = None
        self.rebind_octrees(octree)

    def rebind_octrees(self, octree: Union[Octree, List[Octree]]) -> None:
        """(Re)bind the engine to a new scene, keeping config and caches;
        the layout/format choice and device tables are rebuilt lazily."""
        octrees = (list(octree) if isinstance(octree, (list, tuple))
                   else [octree])
        if len(octrees) != 1:
            raise _unported("multi-scene engines", "A.5.6")
        self.octrees = octrees
        self.octree = octrees[0]
        self._dev: dict = {}
        self._meta_choice = None
        self._scene_sig = tuple(
            sum(len(lv.codes) for lv in t.levels) for t in self.octrees)
        self._cap_memo = {k: v for k, v in self._cap_memo.items()
                          if k[-1] == self._scene_sig}

    def _device_tree(self, fmt: str) -> DeviceOctree:
        if fmt not in self._dev:
            self._dev[fmt] = device_octree(self.octree, meta_format=fmt,
                                           device=self.device)
        return self._dev[fmt]

    @property
    def device_tree(self) -> DeviceOctree:
        """Packed level tensors on this engine's device, in its format."""
        return self._device_tree(self.meta_format)

    def _choose_meta(self):
        if self._meta_choice is None:
            n_max = max(len(lv.codes) for lv in self.octree.levels)
            layout = (None if self.cfg.stream_meta is None else
                      ("streamed" if self.cfg.stream_meta else "resident"))
            self._meta_choice = choose_meta_layout(
                self.octree.depth, n_max, self.cfg.vmem_budget,
                fmt=self.cfg.meta_format, layout=layout)
        return self._meta_choice

    @property
    def meta_layout(self) -> str:
        """``"resident"`` or ``"streamed"`` node-metadata layout."""
        return self._choose_meta().layout

    @property
    def meta_format(self) -> str:
        """Packed node-metadata row format ("fp32" | "bf16" | "u8")."""
        if self.cfg.meta_format is not None:
            return self.cfg.meta_format
        return self._choose_meta().fmt

    def _capacity(self, num_queries: int) -> int:
        counts = [len(lv.codes) for lv in self.octree.levels]
        return frontier_capacity_bound(counts, num_queries, self.cfg)

    def query(self, obbs: OBBs) -> Tuple[np.ndarray, Counters]:
        return self.execute(plan_queries(obbs))

    def query_batched(self, obbs: OBBs) -> Tuple[np.ndarray, Counters]:
        """(B, M) OBB fields -> ((B, M) verdicts, aggregate counters), one
        flat pool of B * M slots in a single traversal."""
        return self.execute(plan_batch(obbs))

    def execute(self, plan: QueryPlan,
                max_depth: Optional[int] = None
                ) -> Tuple[np.ndarray, Counters]:
        """Run one lowered plan; returns (un-flattened verdicts, counters)."""
        t0 = time.perf_counter()
        if plan.num_scenes != len(self.octrees):
            raise ValueError(
                f"plan carries {plan.num_scenes} scene(s) but the engine "
                f"holds {len(self.octrees)}")
        if max_depth is not None:
            raise _unported("max_depth (depth-capped traversal)", "A.6")
        if plan.grouped:
            raise _unported("owner/payload plans", "A.5.3")
        value, counters = self._exec_device(plan)
        counters.wall_time_s = time.perf_counter() - t0
        counters.num_queries = plan.num_queries
        return plan.unflatten(value), counters

    def _exec_device(self, plan: QueryPlan):
        cfg = self.cfg
        Q = plan.num_queries
        choice = self._choose_meta()
        require_ported_layout(choice)
        dev = self.device_tree
        obb_c, obb_h, obb_r = (
            torch.as_tensor(x, dtype=torch.float32).to(self.device)
            for x in (plan.obb_c, plan.obb_h, plan.obb_r))
        memo_key = ("single", Q, plan.grouped, None, self._scene_sig)

        def run(cap):
            return traverse_whole(obb_c, obb_h, obb_r, dev, cap,
                                  use_spheres=cfg.use_spheres,
                                  streamed=False)

        verdict, st, cap, replays = _escalate(
            run, Q, self._capacity(Q), cfg, start=self._cap_memo.get(memo_key))
        self._cap_memo[memo_key] = cap
        self.last_capacity = cap
        counters = _stats_to_counters(st, cfg.mode, replays,
                                      meta_format=choice.fmt)
        return verdict.cpu().numpy(), counters
