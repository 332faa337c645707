"""Plan executor: one engine consuming :class:`repro_torch.engine.plan.QueryPlan`.

Counterpart of ``repro.engine.executor``: mode dispatch, capacity
escalation (the device modes' frontier runs in a fixed-capacity buffer;
overflow is counted on the device and the query replays at 4x capacity
until clean) and counter assembly for all eight modes of Fig. 11
(:data:`MODES`).  The three device modes:

* ``wavefront_persistent``: the persistent megakernel of
  :mod:`repro_torch.kernels.persist`, the whole walk in one launch;
* ``wavefront`` (the paper's "RoboCore (CR)" arm): a level loop over a
  (query, Morton code) frontier, the staged SACT and both
  ``searchsorted`` probes as plain tensor ops, and the stream-compaction
  kernel of :mod:`repro_torch.kernels.compact` between levels;
* ``wavefront_fused`` ("RoboCore (CR+CU)"): a level loop over a (query,
  CSR node) frontier, each level one
  :func:`repro_torch.kernels.traverse.ops.traverse_step` (the traversal
  step kernel, then the compaction kernel).

The ablation arms:

* ``naive`` (the CUDA baseline): every OBB against every leaf, all 15
  axes, in blocks of ``query_block`` OBBs, each block one launch of the
  dense SACT kernel (:func:`repro_torch.kernels.sact.ops.sact_dense`)
  reduced on the device;
* ``wavefront_host``, ``predicated``, ``staged_noexit`` and ``rta_like``
  (the host-in-the-loop arms): the level loop of ``wavefront`` with the
  frontier re-bucketed by the host between levels, its live count read
  back each level to size the next bucket.  ``staged_noexit`` and
  ``rta_like`` (an RT-accelerator model: a shader call per overlapping
  pair) retire no decided query; ``predicated`` and ``wavefront_host``
  do.

The device modes' level loops never wait for the device: they run every
level up to the tree's (or the cap's) depth with the live count kept on
the device.  A level after the frontier empties has no live lane, so it
adds 0 to every counter and leaves its ``per_level`` slot at 0 -- the
same result, bit for bit, as the reference's ``lax.while_loop`` stopping
at ``n_live == 0``.  A run waits for the device only where the host needs
a value: ``_escalate``'s overflow check, the host arms' live count, and
the counters' readout.

The engine runs on the card (``device="cuda"``, the default) or, when the
caller asks, on the CPU through the kernels' plain PyTorch versions; the
two give identical verdicts and counters.  Plans with owner and payload
lanes (swept-edge CCD, :func:`repro_torch.engine.plan.plan_edges`) run in
the three device modes: the persistent mode on an owner-group tiled pool
(:func:`repro_torch.kernels.persist.ops.tile_pool`), the per-level modes
with the payload fold of :func:`repro_torch.core.sact.fold_verdicts`
between levels.  Ragged multi-scene batches
(:func:`repro_torch.engine.plan.plan_scenes`, :func:`query_batched_scenes`)
run in the three device modes as the reference runs them: the persistent
mode on the megakernel's scene-exclusive tiles over the scenes' flat
table, ``wavefront_fused`` on the reference's global-pool walk over that
table (:func:`repro_torch.kernels.persist.ref.traverse_whole_ref`), and
``wavefront`` on the scenes padded to the widest one, one scene after
another at one shared capacity; the host arms and ``naive`` refuse them.  Without a CUDA device a CUDA engine raises; it never
drops to the CPU by itself.  Options and plan shapes this port has not
ported raise ``NotImplementedError`` naming the ROADMAP item that adds
them.
"""
from __future__ import annotations

import dataclasses
import time
import weakref
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import sact as sact_mod
from repro_torch.core.counters import (BYTES_FUSED_STEP, BYTES_META_STREAM,
                                       BYTES_META_STREAM_BF16,
                                       BYTES_META_STREAM_U8,
                                       BYTES_PAYLOAD_LANE,
                                       BYTES_PERSIST_QUERY,
                                       BYTES_PERSIST_SPILL,
                                       BYTES_SHADER_HANDOFF,
                                       BYTES_UNFUSED_TEST, NUM_EXIT_CODES,
                                       Counters)
from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.core.geometry import OBBs
from repro_torch.core.octree import (MAX_DEPTH, DeviceOctree, Octree,
                                     concat_device_octrees, device_octree,
                                     lookup_children, node_centers_from_codes,
                                     stack_device_octrees)
from repro_torch.core.quantize import META_FORMATS
from repro_torch.core.sact import NUM_AXES, PAYLOAD_INF
from repro_torch.engine.plan import (QueryPlan, plan_batch, plan_queries,
                                     plan_scenes)
from repro_torch.kernels.compact.ops import compact_pairs
from repro_torch.kernels.persist.ops import (H100_L2_BYTES,
                                             choose_meta_layout, tile_pool,
                                             traverse_whole)
from repro_torch.kernels.persist.ref import traverse_whole_ref
from repro_torch.kernels.sact.ops import pack_aabbs, pack_obbs, sact_dense
from repro_torch.kernels.traverse.ops import traverse_step

MODES = ("naive", "rta_like", "staged_noexit", "predicated", "wavefront_host",
         "wavefront", "wavefront_fused", "wavefront_persistent")
#: Modes whose traversal runs fully on the device.
DEVICE_MODES = ("wavefront", "wavefront_fused", "wavefront_persistent")
#: CSR-frontier modes.
CSR_MODES = ("wavefront_fused", "wavefront_persistent")
#: Modes whose traversal accepts a ``max_depth`` cap (the degraded
#: service mode): every cap-level overlap counts as a hit, so capped
#: verdicts are a conservative superset of full-depth ones.  The
#: persistent megakernel has no cap.
DEPTH_CAP_MODES = ("wavefront_host", "wavefront", "wavefront_fused")


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
    # Reference fields, accepted and ignored: a CUDA engine always runs
    # the kernels, a CPU engine their plain versions.
    use_pallas_compact: Optional[bool] = None
    use_pallas_traverse: Optional[bool] = None
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

    @property
    def early_exit(self) -> bool:
        return self.mode in ("predicated", "wavefront_host") + DEVICE_MODES

    @property
    def stage_split(self) -> bool:
        return self.mode in ("wavefront_host",) + DEVICE_MODES

    @property
    def fused(self) -> bool:
        return self.mode == "wavefront_fused"

    @property
    def persistent(self) -> bool:
        return self.mode == "wavefront_persistent"

    @property
    def device_resident(self) -> bool:
        return self.mode in DEVICE_MODES


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


# ---------------------------------------------------------------------------
# Per-level device arms (a level loop on the host, no waits on the device)
# ---------------------------------------------------------------------------

def _empty_stats(device) -> dict:
    """Device-side work counters of one traversal, all int64 zeros."""
    z = dict(dtype=torch.int64, device=device)
    stats = {k: torch.zeros((), **z) for k in (
        "nodes", "leaf", "axis_exec", "axis_dec", "sphere", "overflow")}
    stats["per_level"] = torch.zeros(MAX_DEPTH + 1, **z)
    stats["exit_hist"] = torch.zeros(NUM_EXIT_CODES, **z)
    return stats


def _verdict_init(num_queries: int, grouped: bool, device) -> torch.Tensor:
    """Boolean verdicts (one per query, as int32 for ``scatter_reduce_``)
    or, for a grouped plan, int32 ``best`` cells at ``PAYLOAD_INF``.

    Grouped verdicts get one cell per query slot whatever the plan's group
    count (owner ids are compact, ``G <= Q``; the executor keeps the first
    G cells after the call), as in the reference."""
    if not grouped:
        return torch.zeros(num_queries, dtype=torch.int32, device=device)
    return torch.full((num_queries,), PAYLOAD_INF, dtype=torch.int32,
                      device=device)


def _count_level(st: dict, level: int, valid, is_term, res, n_new,
                 capacity: int) -> None:
    """Add one level's work to ``st`` in place (the reference's formulas;
    an empty level adds 0)."""
    n_valid = valid.sum()
    term_valid = valid & is_term
    st["nodes"] += n_valid
    st["leaf"] += term_valid.sum()
    st["axis_exec"] += res.axis_tests.sum()
    st["axis_dec"] += n_valid * NUM_AXES
    st["sphere"] += res.sphere_tests.sum()
    st["overflow"] += (n_new - capacity).clamp(min=0)
    st["per_level"][level] = n_valid
    st["exit_hist"].index_add_(0, res.exit_code.to(torch.int64),
                               term_valid.to(torch.int64))


def _seed(num_queries: int, capacity: int, device, num_valid=None):
    """Level-0 frontier: query ``i`` on lane ``i`` against the root, the
    lanes past the queries on query 0 (in range for every gather); the
    first ``num_valid`` lanes (default all queries) are live."""
    lane = torch.arange(capacity, dtype=torch.int32, device=device)
    q0 = torch.where(lane < num_queries, lane, 0)
    nv = num_queries if num_valid is None else int(num_valid)
    n_live = torch.tensor(min(nv, capacity), dtype=torch.int32,
                          device=device)
    return n_live, q0, torch.zeros(capacity, dtype=torch.int32,
                                   device=device)


def _test_level(obb_c, obb_h, obb_r, dev: DeviceOctree, level: int,
                depth: int, q_idx, codes, valid, use_spheres: bool):
    """One level of a (query, Morton code) frontier: the staged SACT of
    :func:`repro_torch.core.sact.sact_frontier` on every lane and the
    terminal flag (leaves, or the cap level ``depth``, or full subtrees,
    probed by ``searchsorted`` on :attr:`DeviceOctree.codes_unsigned`).
    Returns ``(q64, codes_u, res, is_term)``: the lanes' int64 query ids
    and unsigned codes, the SACT result and the terminal flags."""
    q64 = q_idx.to(torch.int64)
    node_c, node_h = node_centers_from_codes(codes, dev.scene_lo,
                                             dev.cell_sizes[level])
    res = sact_mod.sact_frontier(obb_c[q64], obb_h[q64], obb_r[q64],
                                 node_c, node_h, valid,
                                 use_spheres=use_spheres)
    codes_u = codes.to(torch.int64) & 0xFFFFFFFF
    if level == depth:
        is_term = torch.ones_like(valid)
    else:
        pos = torch.searchsorted(dev.codes_unsigned[level], codes_u)
        is_term = dev.full[level][pos.clamp(0, dev.codes.shape[-1] - 1)]
    return q64, codes_u, res, is_term


def _traverse(obb_c, obb_h, obb_r, dev: DeviceOctree, capacity: int,
              use_spheres: bool, max_depth: Optional[int] = None,
              owner=None, payload=None, num_valid=None):
    """Multi-level wavefront traversal (``mode="wavefront"``) for one query
    set against one scene; returns ``(verdict, stats)``: (M,) bool, or
    with ``owner`` / ``payload`` lanes (M,) int32 ``best`` cells (those
    past the plan's group count unused).

    The frontier carries (query, Morton code) pairs.  Per level:
    :func:`_test_level`, the 8-child occupancy probe of
    :func:`repro_torch.core.octree.lookup_children` on the next level, and
    the compaction kernel.  ``max_depth`` caps the walk at that level,
    where every node counts as terminal.  ``num_valid`` (default M) is the
    pool's live prefix: slots past it seed nothing and add 0 to every
    counter, so a padded pool walks as its unpadded prefix does.
    """
    device = dev.device
    M = obb_c.shape[0]
    depth = dev.depth if max_depth is None else min(dev.depth, max_depth)
    lane = torch.arange(capacity, device=device)
    grouped = owner is not None or payload is not None
    verdict = _verdict_init(M, grouped, device)
    st = _empty_stats(device)
    n_live, q_idx, codes = _seed(M, capacity, device, num_valid)
    for level in range(depth + 1):
        valid = lane < n_live
        q64, codes_u, res, is_term = _test_level(
            obb_c, obb_h, obb_r, dev, level, depth, q_idx, codes, valid,
            use_spheres)
        overlap = res.collide & valid
        verdict, undecided = sact_mod.fold_verdicts(
            verdict, q64, overlap & is_term, owner, payload)
        cand, child_idx = lookup_children(
            dev.codes_unsigned[min(level + 1, depth)], codes_u)
        # Early exit: decided queries retire their whole wavefront share.
        expand = overlap & ~is_term & undecided
        child_mask = (expand[:, None] & (child_idx >= 0)).reshape(-1)
        n_new = child_mask.sum()
        _count_level(st, level, valid, is_term, res, n_new, capacity)
        n_live, q_idx, codes = compact_pairs(
            child_mask, q_idx.repeat_interleave(8), cand.reshape(-1),
            capacity)
    return (verdict if grouped else verdict != 0), st


def _traverse_fused(obb: torch.Tensor, dev: DeviceOctree, capacity: int,
                    use_spheres: bool, max_depth: Optional[int] = None,
                    owner=None, payload=None, num_valid=None):
    """Fused multi-level wavefront traversal (``mode="wavefront_fused"``):
    the frontier carries (query, CSR node index) pairs and each level is
    one :func:`repro_torch.kernels.traverse.ops.traverse_step`.  ``obb``
    is the packed (M, 15) table.  Returns ``(verdict, stats)`` as
    :func:`_traverse` does.

    ``max_depth`` stops the walk at that level.  The step treats only true
    leaves and full subtrees as terminal, so the cap level's other hits
    are folded into the verdicts here and do not count as leaf tests (the
    reference's accounting, which differs from :func:`_traverse`'s under a
    cap in ``leaf_tests`` and the exit histogram).  ``num_valid`` is the
    pool's live prefix, as in :func:`_traverse`.
    """
    device = dev.device
    M = obb.shape[0]
    depth = dev.depth if max_depth is None else min(dev.depth, max_depth)
    capped = depth < dev.depth
    grouped = owner is not None or payload is not None
    assert not (capped and grouped), \
        "depth-capped traversal serves boolean plans only"
    verdict = _verdict_init(M, grouped, device)
    st = _empty_stats(device)
    n_live, q_idx, node_idx = _seed(M, capacity, device, num_valid)
    for level in range(depth + 1):
        n_next, q_next, idx_next, verdict, info = traverse_step(
            obb, dev, level, n_live, q_idx, node_idx, verdict,
            use_spheres=use_spheres, owner=owner, payload=payload)
        res, valid, is_term = info["res"], info["valid"], info["is_term"]
        if capped and level == depth:
            cap_hit = res.collide & valid & ~is_term
            verdict.scatter_reduce_(0, q_idx.to(torch.int64),
                                    cap_hit.to(torch.int32), "amax")
        _count_level(st, level, valid, is_term, res, info["n_new"],
                     capacity)
        n_live, q_idx, node_idx = n_next, q_next, idx_next
    return (verdict if grouped else verdict != 0), st


def _traverse_host(obb_c, obb_h, obb_r, dev: DeviceOctree, cfg: EngineConfig,
                   max_depth: Optional[int] = None):
    """Host-in-the-loop traversal of a boolean query set (``wavefront_host``
    and the ``predicated``, ``staged_noexit`` and ``rta_like`` arms);
    returns ``(verdict (M,) bool numpy, stats)``, the stats read back.

    :func:`_traverse`'s level loop, with the frontier re-bucketed by
    the host: each level reads back one number, the count of child pairs,
    which sizes the next level's bucket (:func:`_bucket`; a count past
    ``cfg.max_frontier`` is cut to it and the surplus counted as
    ``frontier_overflow``), and the compaction kernel packs the pairs into
    it.  That round trip is what these arms ablate.  Every other counter
    adds up on the device and is read once, at the end, with the verdicts.
    Decided queries retire only under ``cfg.early_exit``; ``rta_like``
    also counts a shader call per overlapping pair (``"shader"``).
    ``max_depth`` caps the walk at that level, where every node counts as
    terminal.
    """
    device = dev.device
    M = obb_c.shape[0]
    depth = dev.depth if max_depth is None else min(dev.depth, max_depth)
    bucket = _bucket(M, cfg)
    if bucket < M:
        raise ValueError(
            f"{M} queries do not fit max_frontier={cfg.max_frontier}: the "
            "level-0 frontier holds one pair per query")
    z = dict(dtype=torch.int64, device=device)
    leaf, axis_exec, sphere, shader = (torch.zeros((), **z) for _ in range(4))
    hist = torch.zeros(NUM_EXIT_CODES, **z)
    per_level = np.zeros(MAX_DEPTH + 1, np.int64)
    overflow = 0
    verdict = _verdict_init(M, False, device)
    _, q_idx, codes = _seed(M, bucket, device)
    n_live = M
    for level in range(depth + 1):
        if n_live == 0:
            break
        per_level[level] = n_live
        valid = torch.arange(bucket, device=device) < n_live
        q64, codes_u, res, is_term = _test_level(
            obb_c, obb_h, obb_r, dev, level, depth, q_idx, codes, valid,
            cfg.use_spheres)
        overlap = res.collide & valid
        term_valid = valid & is_term
        verdict, undecided = sact_mod.fold_verdicts(verdict, q64,
                                                    overlap & is_term)
        leaf += term_valid.sum()
        axis_exec += res.axis_tests.sum()
        sphere += res.sphere_tests.sum()
        if cfg.mode == "rta_like":
            shader += overlap.sum()
        hist.index_add_(0, res.exit_code.to(torch.int64),
                        term_valid.to(torch.int64))
        if level == depth:
            break
        expand = overlap & ~is_term
        if cfg.early_exit:
            expand = expand & undecided
        cand, child_idx = lookup_children(dev.codes_unsigned[level + 1],
                                          codes_u)
        child_mask = (expand[:, None] & (child_idx >= 0)).reshape(-1)
        n_live = int(child_mask.sum())      # the level's one read back
        if n_live == 0:
            break
        if n_live > cfg.max_frontier:
            overflow += n_live - cfg.max_frontier
            n_live = cfg.max_frontier
        bucket = _bucket(n_live, cfg)
        _, q_idx, codes = compact_pairs(child_mask, q_idx.repeat_interleave(8),
                                        cand.reshape(-1), bucket)
    out = torch.cat([torch.stack([leaf, axis_exec, sphere, shader]), hist,
                     verdict.to(torch.int64)]).cpu().numpy()
    nodes = int(per_level.sum())
    stats = dict(nodes=nodes, leaf=out[0], axis_exec=out[1],
                 axis_dec=nodes * NUM_AXES, sphere=out[2], shader=out[3],
                 overflow=overflow, per_level=per_level,
                 exit_hist=out[4:4 + NUM_EXIT_CODES])
    return out[4 + NUM_EXIT_CODES:] != 0, stats


def _exit_counts(codes: torch.Tensor) -> torch.Tensor:
    """Histogram of int32 exit codes (any shape) as a (NUM_EXIT_CODES,)
    int64 tensor on their device.  On the card ``histc`` with its range
    given reads nothing back (``bincount`` reads the codes' range back);
    on the CPU, where ``histc`` takes no integers, ``bincount``."""
    flat = codes.reshape(-1)
    if flat.device.type == "cuda":
        return torch.histc(flat, bins=NUM_EXIT_CODES, min=0,
                           max=NUM_EXIT_CODES).to(torch.int64)
    return torch.bincount(flat, minlength=NUM_EXIT_CODES)


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


def _sum_stats(stats: List[dict]) -> dict:
    """Field-wise sum of per-scene stats dicts."""
    return {k: torch.stack([st[k] for st in stats]).sum(0) for k in stats[0]}


#: Scene-table memo for repeat multi-scene batches: building the flat or
#: stacked level tables is a host numpy pass over every level of every
#: scene plus a copy to the device, far more than a warm walk costs.
#: Keyed by the octree objects' identities (and the table's kind, row
#: format and device); weak references guard against an id reused after
#: a tree is freed.
_TABLE_CACHE: dict = {}
_TABLE_CACHE_MAX = 8
_TABLE_STATS = {"hits": 0, "misses": 0}
#: The first use of each (mode, batch kind, capacity, statics) key.
_TRACE_COUNTS: dict = {}


def _scene_tables(octrees: List[Octree], padded: bool, fmt: str = "fp32",
                  device=DEFAULT_DEVICE):
    """The stacked (``padded``) or flat table of ``octrees`` on
    ``device``, memoized."""
    device = resolve_device(device)
    key = (padded, fmt, str(device), tuple(id(t) for t in octrees))
    hit = _TABLE_CACHE.get(key)
    if hit is not None:
        refs, tables = hit
        if all(r() is t for r, t in zip(refs, octrees)):
            _TABLE_STATS["hits"] += 1
            return tables
    _TABLE_STATS["misses"] += 1
    tables = (stack_device_octrees(octrees, device=device) if padded
              else concat_device_octrees(octrees, meta_format=fmt,
                                         device=device))
    while len(_TABLE_CACHE) >= _TABLE_CACHE_MAX:
        _TABLE_CACHE.pop(next(iter(_TABLE_CACHE)))
    _TABLE_CACHE[key] = ([weakref.ref(t) for t in octrees], tables)
    return tables


def traversal_cache_info() -> dict:
    """The reference's cache report, under its keys.  PyTorch compiles no
    traversal, so here ``hits``, ``misses`` and ``entries`` count the
    multi-scene table memo (:func:`_scene_tables`: tables served from it,
    tables built, tables held), ``sharded_entries`` is 0 (sharded
    execution is ROADMAP A.8), and ``traces`` maps each (mode, batch kind,
    capacity, use_spheres, streamed, meta_format, max_depth) key that a
    device-mode walk has run to 1, its first use, which is where the
    reference traces."""
    return dict(hits=_TABLE_STATS["hits"], misses=_TABLE_STATS["misses"],
                entries=len(_TABLE_CACHE), sharded_entries=0,
                traces=dict(_TRACE_COUNTS))


class CollisionEngine:
    """Octree collision queries for fixed scene(s), on one device.

    ``device`` defaults to CUDA; pass ``device="cpu"`` to run the plain
    PyTorch versions of the kernels.  The engine is the executor of
    :class:`repro_torch.engine.plan.QueryPlan`; ``query`` and
    ``query_batched`` build the obvious plan.  Construct with one
    :class:`Octree` for single-scene service or a list for multi-scene
    plans (:func:`repro_torch.engine.plan.plan_scenes`).
    """

    def __init__(self, octree: Union[Octree, List[Octree]],
                 config: EngineConfig = EngineConfig(),
                 device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        if config.shards is not None:
            raise _unported("sharded execution (EngineConfig.shards)", "A.8")
        self.cfg = config
        # Last clean frontier capacity per (query shape, scene signature).
        self._cap_memo: dict = {}
        #: Frontier capacity of the last call's clean run.
        self.last_capacity: Optional[int] = None
        self.rebind_octrees(octree)

    def rebind_octrees(self, octree: Union[Octree, List[Octree]]) -> None:
        """(Re)bind the engine to new scene(s), keeping config and caches;
        the layout/format choice and device tables are rebuilt lazily, and
        the clean-capacity memo keeps only the new scenes' keys."""
        octrees = (list(octree) if isinstance(octree, (list, tuple))
                   else [octree])
        if not octrees:
            raise ValueError("need at least one octree")
        self.octrees = octrees
        self.octree = octrees[0]
        self._dev: dict = {}
        self._leaves: Optional[torch.Tensor] = None
        self._meta_choice = None
        self._scene_sig = tuple(
            sum(len(lv.codes) for lv in t.levels) for t in self.octrees)
        self._cap_memo = {k: v for k, v in self._cap_memo.items()
                          if k[-1] == self._scene_sig}

    @property
    def supports_depth_cap(self) -> bool:
        """Whether ``execute(plan, max_depth=...)`` can cap this engine's
        traversal depth (the coarser half of the degraded mode)."""
        return self.cfg.mode in DEPTH_CAP_MODES

    def _device_tree(self, fmt: str) -> DeviceOctree:
        if fmt not in self._dev:
            self._dev[fmt] = device_octree(self.octree, meta_format=fmt,
                                           device=self.device)
        return self._dev[fmt]

    @property
    def device_tree(self) -> DeviceOctree:
        """Packed level tensors on this engine's device, in
        :attr:`meta_format`."""
        return self._device_tree(self.meta_format)

    def _choose_meta(self):
        """The layout/format choice, memoized.  A multi-scene engine sizes
        the flat table's per-level totals, the table its CSR modes read."""
        if self._meta_choice is None:
            n_levels = max(len(t.levels) for t in self.octrees)
            n_max = max(sum(len(t.levels[lv].codes) for t in self.octrees
                            if lv < len(t.levels))
                        for lv in range(n_levels))
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
        """Packed node-metadata row format ("fp32" | "bf16" | "u8"):
        always fp32 for the Morton-code frontier of ``mode="wavefront"``
        (it never reads the packed rows); else ``cfg.meta_format`` when
        pinned, the chooser's pick for the persistent megakernel and fp32
        for ``wavefront_fused``."""
        if self.cfg.mode not in CSR_MODES:
            return "fp32"
        if self.cfg.meta_format is not None:
            return self.cfg.meta_format
        if self.cfg.mode == "wavefront_persistent":
            return self._choose_meta().fmt
        return "fp32"

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
        if plan.num_scenes > 1 and not self.cfg.device_resident:
            raise ValueError("multi-scene batching needs a device mode")
        if plan.grouped and not self.cfg.device_resident:
            raise ValueError(
                "owner/payload plans need a device-resident mode; lower to "
                "a boolean plan and reduce on the host instead")
        if max_depth is not None:
            if not self.supports_depth_cap:
                raise ValueError(
                    f"max_depth needs a depth-cappable mode "
                    f"({', '.join(DEPTH_CAP_MODES)}), not "
                    f"{self.cfg.mode!r}")
            if plan.grouped or plan.num_scenes > 1:
                raise ValueError(
                    "max_depth serves single-scene boolean plans (the "
                    "degraded service path); grouped/multi-scene plans "
                    "run at full depth")
            if max_depth < 1:
                raise ValueError(f"max_depth must be >= 1, got {max_depth}")
        if self.cfg.mode == "naive":
            value, counters = self._exec_naive(plan)
        elif self.cfg.device_resident:
            value, counters = self._exec_device(plan, max_depth)
        else:
            value, counters = self._exec_host(plan, max_depth)
        counters.wall_time_s = time.perf_counter() - t0
        counters.num_queries = plan.num_queries
        return plan.unflatten(value), counters

    def _plan_obbs(self, plan: QueryPlan):
        """The plan's OBB fields as float32 tensors on this engine's
        device."""
        return tuple(torch.as_tensor(x, dtype=torch.float32).to(self.device)
                     for x in (plan.obb_c, plan.obb_h, plan.obb_r))

    def _exec_naive(self, plan: QueryPlan):
        """CUDA-baseline arm: every OBB against every leaf AABB, all 15
        axes, no sphere stages.  Each block of ``cfg.query_block`` OBBs is
        one :func:`repro_torch.kernels.sact.ops.sact_dense` launch over
        all leaves, reduced on the device into the verdicts and the
        exit-code histogram; the (block, leaves) plane never leaves the
        device, and both reductions are read back once, at the end.  The
        work counters are closed-form."""
        if self._leaves is None:
            leaves = self.octree.leaf_aabbs()
            self._leaves = pack_aabbs(leaves.center,
                                      leaves.half).to(self.device)
        aabb = self._leaves
        obb = pack_obbs(*self._plan_obbs(plan))
        M, N = obb.shape[0], aabb.shape[0]
        z = dict(dtype=torch.int64, device=self.device)
        hist = torch.zeros(NUM_EXIT_CODES, **z)
        hit = torch.zeros(M, **z)
        block = self.cfg.query_block
        for s in range(0, M, block):
            collide, code = sact_dense(obb[s:s + block], aabb,
                                       use_spheres=False)
            hit[s:s + block] = collide.any(dim=1)
            hist += _exit_counts(code)
        out = torch.cat([hist, hit]).cpu().numpy()
        c = Counters()
        n_tests = M * N
        c.nodes_traversed = n_tests
        c.leaf_tests = n_tests
        c.axis_tests_executed = n_tests * NUM_AXES
        c.axis_tests_decoded = n_tests * NUM_AXES
        c.bytes_moved = n_tests * BYTES_UNFUSED_TEST
        c.exit_histogram += out[:NUM_EXIT_CODES]
        return out[NUM_EXIT_CODES:] != 0, c

    def _exec_host(self, plan: QueryPlan, max_depth: Optional[int] = None):
        """Host-in-the-loop arms (``wavefront_host``, ``predicated``,
        ``staged_noexit``, ``rta_like``): :func:`_traverse_host`, no
        capacity ladder (``escalations`` stays 0)."""
        M = plan.num_queries
        if len(self.octree.levels[0].codes) == 0:
            return np.zeros(M, bool), Counters()
        verdict, st = _traverse_host(*self._plan_obbs(plan), self.device_tree,
                                     self.cfg, max_depth)
        c = _stats_to_counters(st, self.cfg.mode)
        c.shader_invocations = int(st["shader"])
        c.bytes_moved += c.shader_invocations * BYTES_SHADER_HANDOFF
        return verdict, c

    def _exec_device(self, plan: QueryPlan,
                     max_depth: Optional[int] = None):
        cfg = self.cfg
        Q = plan.num_queries
        fmt = self.meta_format
        # The persistent megakernel's layout: the chooser's pick against
        # cfg.vmem_budget unless cfg.stream_meta pins it.
        streamed = cfg.persistent and self.meta_layout == "streamed"
        obb_c, obb_h, obb_r = self._plan_obbs(plan)
        owner, payload, soq = (
            None if x is None else
            torch.as_tensor(x, dtype=torch.int32).to(self.device)
            for x in (plan.owner_of_query, plan.payload,
                      plan.scene_of_query))
        ragged = plan.num_scenes > 1
        batch, n_escalate = "single", Q
        if ragged and cfg.mode in CSR_MODES:
            # one flat pool of (query, CSR node) pairs over the scenes'
            # concatenated table
            dev = _scene_tables(self.octrees, padded=False, fmt=fmt,
                                device=self.device)
            per_scene = Q // plan.num_scenes
            worst = min(sum(frontier_capacity_bound(
                [len(lv.codes) for lv in t.levels], per_scene, cfg)
                for t in self.octrees), max(cfg.max_frontier, Q))
            memo_key = ("csr_scenes", Q, plan.grouped, self._scene_sig)
        elif ragged:
            # mode="wavefront" (a Morton-code frontier): the scenes padded
            # to the widest one, walked one after another at one capacity
            if plan.grouped:
                raise ValueError("owner/payload plans need a CSR mode for "
                                 "multi-scene batches")
            stacked = _scene_tables(self.octrees, padded=True,
                                    device=self.device)
            S, M = plan.out_shape
            worst = max(frontier_capacity_bound(
                [len(lv.codes) for lv in t.levels], M, cfg)
                for t in self.octrees)
            memo_key = ("pad_scenes", S, M, self._scene_sig)
            batch, n_escalate = "scenes", M
        else:
            dev = self.device_tree
            worst = self._capacity(Q)
            memo_key = ("single", Q, plan.grouped, max_depth,
                        self._scene_sig)

        if cfg.persistent and (ragged or owner is not None):
            # Scenes and owner groups cross query tiles: pack them into a
            # tiled pool once, before the escalation ladder (the tile map
            # is host numpy, built from the plan's host lanes).
            tiled = tile_pool(obb_c, obb_h, obb_r, plan.owner_of_query,
                              payload, scene_of_query=(
                                  plan.scene_of_query if ragged else None))

            def run(cap):
                return traverse_whole(dev=dev, capacity=cap,
                                      use_spheres=cfg.use_spheres,
                                      streamed=streamed, **tiled)
        elif cfg.persistent:
            def run(cap):
                return traverse_whole(obb_c, obb_h, obb_r, dev, cap,
                                      use_spheres=cfg.use_spheres,
                                      payload=payload, streamed=streamed)
        elif ragged and cfg.fused:
            # the reference serves the fused mode's ragged pool with its
            # global-pool walk, not with the per-level step kernel
            def run(cap):
                return traverse_whole_ref(
                    obb_c, obb_h, obb_r, dev.node_meta, dev.cell_sizes,
                    dev.scene_lo, dev.depth, cap, cfg.use_spheres,
                    scene_of_query=soq, owner_of_query=owner,
                    payload=payload, meta_format=fmt, codes=dev.codes)
        elif cfg.fused:
            obb = pack_obbs(obb_c, obb_h, obb_r)

            def run(cap):
                return _traverse_fused(obb, dev, cap, cfg.use_spheres,
                                       max_depth, owner, payload)
        elif ragged:
            def run(cap):
                outs = [_traverse(obb_c[s * M:(s + 1) * M],
                                  obb_h[s * M:(s + 1) * M],
                                  obb_r[s * M:(s + 1) * M],
                                  stacked.scene(s), cap, cfg.use_spheres)
                        for s in range(S)]
                return (torch.cat([v for v, _ in outs]),
                        _sum_stats([st for _, st in outs]))
        else:
            def run(cap):
                return _traverse(obb_c, obb_h, obb_r, dev, cap,
                                 cfg.use_spheres, max_depth, owner, payload)

        def traced(cap):
            _TRACE_COUNTS.setdefault((cfg.mode, batch, cap, cfg.use_spheres,
                                      streamed, fmt, max_depth), 1)
            return run(cap)

        verdict, st, cap, replays = _escalate(
            traced, n_escalate, worst, cfg,
            start=self._cap_memo.get(memo_key))
        self._cap_memo[memo_key] = cap
        self.last_capacity = cap
        lanes = (plan.owner_of_query is not None) + (plan.payload is not None)
        counters = _stats_to_counters(st, cfg.mode, replays,
                                      extra_lanes=lanes, meta_format=fmt)
        verdict = verdict.cpu().numpy()
        if plan.grouped:
            # Grouped verdicts are computed in a Q-sized buffer (owner ids
            # are compact); only the first G cells are meaningful.
            verdict = verdict[:plan.groups]
        return verdict, counters


def query_batched_scenes(octrees: List[Octree], obbs: OBBs,
                         config: EngineConfig = EngineConfig(),
                         device=DEFAULT_DEVICE
                         ) -> Tuple[np.ndarray, Counters]:
    """S scenes, each with its own (M,) OBB set, in one traversal:
    ``obbs`` fields carry a leading scene axis (center (S, M, 3)); the
    trees share a depth and may differ in size.  Returns ((S, M) verdicts,
    aggregate counters).

    The CSR modes walk one flat pool over the scenes' concatenated table
    (:func:`repro_torch.core.octree.concat_device_octrees`), with no work
    for the largest scene's padding: ``wavefront_persistent`` on the
    megakernel's scene-exclusive tiles, ``wavefront_fused`` on the
    reference's global-pool walk
    (:func:`repro_torch.kernels.persist.ref.traverse_whole_ref`).
    ``mode="wavefront"`` walks the scenes padded to the widest one
    (:func:`repro_torch.core.octree.stack_device_octrees`) at one shared
    capacity.  The device tables are memoized module-wide, so repeat calls
    on the same octree list skip the table build.
    """
    if not config.device_resident:
        raise ValueError("multi-scene batching needs a device mode")
    if obbs.center.ndim != 3 or obbs.center.shape[0] != len(octrees):
        raise ValueError(f"want OBB fields of shape ({len(octrees)}, M, 3), "
                         f"got {tuple(obbs.center.shape)}")
    return CollisionEngine(list(octrees), config, device=device).execute(
        plan_scenes(obbs))
