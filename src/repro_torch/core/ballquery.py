"""Fixed-radius neighbour search (PointNet++ "ball query").

Counterpart of ``repro.core.ballquery``.  :func:`ball_query_ref` is the
brute force: the serving path calls :func:`repro_torch.kernels.ballquery.
ops.ball_query`, which runs the CUDA kernel ``kernels/ballquery/csrc/
ballquery.cu`` on CUDA tensors and this function on CPU tensors.

RoboGPU §IV poses the ball query as tree traversal two ways (Table IV,
Fig. 17):

  * P-Sphere (:func:`ball_query_psphere`): each query centre traverses the
    octree of the cloud's points; its leaves are visited closest-first in
    rounds of ``chunk`` ranks, and with the early exit a query that holds
    ``k`` neighbours retires (the paper: 6x fewer nodes);
  * P-Ray (:func:`ball_query_pray`): every cloud point traverses a small
    octree over the query centres; no early exit is possible.

Both descend with :func:`_traverse_to_leaves` (tensor code a level, the
frontier packed by the ``compact`` kernel on the card) and gather the
leaves' points by index arithmetic on padded arrays; the counters are the
reference's, exact.  Distances are summed ``(d0*d0 + d1*d1) + d2*d2`` as
the reference sums them, so the card and the CPU agree bit for bit.
"""
from __future__ import annotations

import time
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.counters import Counters
from repro_torch.core.fps import sq_dist
from repro_torch.core.geometry import point_aabb_sq_distance
from repro_torch.core.octree import (Octree, build_octree, lookup_children,
                                     node_centers_from_codes)
from repro_torch.kernels.compact.ops import compact_columns


def radius_sq(radius: float) -> float:
    """The reference's threshold: ``radius * radius`` as a Python (double)
    product, rounded once to float32 at the comparison.  For r = 0.1 this
    is 0.01f, where ``0.1f * 0.1f`` would be 0.010000001f."""
    r = float(radius)
    return float(np.float32(r * r))


def ball_query_ref(points: torch.Tensor, queries: torch.Tensor,
                   radius: float, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Brute force: the first ``k`` point indices (ascending) within
    ``radius`` of each query, -1 padded, and ``count = min(hits, k)``.

    ``points (N, 3)``, ``queries (M, 3)`` -> ``idx (M, k)`` int32, ``count
    (M,)`` int32; or batched, ``(B, N, 3)`` and ``(B, M, 3)`` -> ``(B, M,
    k)`` and ``(B, M)``.
    """
    batched = points.ndim == 3
    pts, qs = (points, queries) if batched else (points[None], queries[None])
    B, N, _ = pts.shape
    M = qs.shape[1]
    d2 = sq_dist(qs[:, :, None, :], pts[:, None, :, :])        # (B, M, N)
    hit = d2 <= radius_sq(radius)
    count = torch.clamp(hit.sum(-1), max=k).to(torch.int32)
    rank = torch.cumsum(hit.to(torch.int64), -1) - 1             # among hits
    slot = torch.where(hit & (rank < k), rank, k)
    out = torch.full((B, M, k + 1), -1, dtype=torch.int32, device=pts.device)
    # Every hit past the k-th lands on slot k, which is cut off below.
    src = torch.arange(N, dtype=torch.int32, device=pts.device)
    out.scatter_(2, slot, src.expand(B, M, N))
    idx = out[..., :k]
    return (idx, count) if batched else (idx[0], count[0])


def _merge_candidates(out_idx: torch.Tensor, counts: torch.Tensor,
                      q_flat: torch.Tensor, p_flat: torch.Tensor,
                      hit: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Append candidate hits ``(q, p)`` to per-query buffers, capped at
    ``k``: each query's hits in candidate order (a stable sort by query),
    after the ``counts`` it already holds.  Returns new ``(out_idx (M, k),
    counts (M,))``.

    The reference scatters with ``mode="drop"``; torch drops nothing, so a
    candidate that is no hit or finds its query full writes to a pad row
    and column that are cut off (C.8).
    """
    M, K = out_idx.shape
    dev = out_idx.device
    E = q_flat.shape[0]
    qk = torch.where(hit, q_flat.to(torch.int32), M)
    qs, order = torch.sort(qk, stable=True)
    ps = p_flat[order].to(torch.int32)
    seg_start = torch.searchsorted(qs, qs, side="left")
    rank = torch.arange(E, device=dev) - seg_start
    slot = counts[qs.clamp(max=M - 1).to(torch.int64)].to(torch.int64) + rank
    ok = (qs < M) & (slot < K)
    rows = torch.where(ok, qs.to(torch.int64), M)
    cols = torch.where(ok, slot, K)
    out = torch.full((M + 1, K + 1), -1, dtype=torch.int32, device=dev)
    out[:M, :K] = out_idx
    out.index_put_((rows, cols), ps)
    cnt = torch.zeros(M + 1, dtype=torch.int32, device=dev)
    cnt[:M] = counts
    cnt.index_add_(0, rows, ok.to(torch.int32))
    return out[:M, :K].contiguous(), cnt[:M].contiguous()


def _level_codes(tree: Octree, level: int, dev: torch.device
                 ) -> torch.Tensor:
    """Level ``level``'s sorted codes as unsigned values in int64 (C.9)."""
    return torch.from_numpy(tree.levels[level].codes.astype(np.int64)).to(dev)


def _traverse_to_leaves(tree: Octree, centers: torch.Tensor, radius: float,
                        c: Counters, max_frontier: int = 1 << 22
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Wavefront sphere-vs-node descent: the (query, leaf code) pairs whose
    leaf lies within ``radius`` of the query, in frontier order, as int32
    tensors.  One live-count read a level; the frontier is packed by
    ``compact``.  A level past ``max_frontier`` pairs keeps its first
    ``max_frontier``, as the reference does, and says nothing (ROADMAP
    C.19)."""
    dev = centers.device
    M = centers.shape[0]
    q_idx = torch.arange(M, dtype=torch.int32, device=dev)
    codes = torch.zeros(M, dtype=torch.int32, device=dev)
    scene_lo = torch.from_numpy(np.asarray(tree.scene_lo, np.float32)).to(dev)
    r2 = radius_sq(radius)
    for level in range(tree.depth + 1):
        node_c, node_h = node_centers_from_codes(codes, scene_lo,
                                                 tree.cell_size(level))
        d2 = point_aabb_sq_distance(centers[q_idx.to(torch.int64)], node_c,
                                    node_h)
        overlap = d2 <= r2
        c.nodes_traversed += int(codes.shape[0])
        c.nodes_per_level.append(int(codes.shape[0]))
        # the first n lanes where the mask holds, in order: the compact
        # kernel on the card, its plain version on the CPU
        if level == tree.depth:
            n = int(overlap.sum())
            q_idx, codes = compact_columns(overlap, (q_idx, codes), n)[1]
            return q_idx, codes
        child_codes, child_idx = lookup_children(
            _level_codes(tree, level + 1, dev), codes)
        flat_mask = (overlap[:, None] & (child_idx >= 0)).reshape(-1)
        n = int(flat_mask.sum())
        if n == 0:
            empty = torch.zeros(0, dtype=torch.int32, device=dev)
            return empty, empty.clone()
        q_idx, codes = compact_columns(
            flat_mask, (q_idx.repeat_interleave(8),
                        child_codes.reshape(-1).to(torch.int32)),
            min(n, max_frontier))[1]
    raise AssertionError


def _padded_storage(tree: Octree, dev: torch.device):
    """The tree's sorted points and their indices, padded with ``leaf_cap``
    rows of ``inf`` / ``-1`` so that a leaf's ``leaf_cap`` slots never run
    past the end; with the leaves' starts and counts and ``leaf_cap``."""
    leaf_cap = int(np.max(tree.leaf_point_count))
    pts = np.concatenate([np.asarray(tree.points_sorted, np.float32),
                          np.full((leaf_cap, 3), np.inf, np.float32)])
    pidx = np.concatenate([np.asarray(tree.point_index, np.int32),
                           np.full((leaf_cap,), -1, np.int32)])

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return (t(pts), t(pidx), t(tree.leaf_point_start).to(torch.int64),
            t(tree.leaf_point_count), leaf_cap)


def _leaf_positions(tree: Octree, codes: torch.Tensor) -> torch.Tensor:
    """Each leaf code's row in the leaf level (int64), clamped into it."""
    leaf_codes = _level_codes(tree, tree.depth, codes.device)
    pos = torch.searchsorted(leaf_codes, codes.to(torch.int64) & 0xFFFFFFFF)
    return pos.clamp(max=leaf_codes.shape[0] - 1)


def _empty_result(M: int, k: int, dev: torch.device):
    return (torch.full((M, k), -1, dtype=torch.int32, device=dev),
            torch.zeros(M, dtype=torch.int32, device=dev))


def ball_query_psphere(tree: Octree, queries: torch.Tensor, radius: float,
                       k: int, chunk: int = 8, early_exit: bool = True
                       ) -> Tuple[torch.Tensor, torch.Tensor, Counters]:
    """P-Sphere: each query centre traverses the point octree (which must
    carry its point storage), on the queries' device.

    Each query's leaves are visited closest-first, ``chunk`` ranks a
    round; with ``early_exit`` a query that holds ``k`` neighbours drops
    out of the next round (the paper's early exit; without it, the RTNN
    baseline).  Returns ``idx (M, k)`` int32 (-1 past the count),
    ``count (M,)`` int32 and the work counters.
    """
    t0 = time.perf_counter()
    queries = queries.to(torch.float32)
    dev = queries.device
    M = queries.shape[0]
    c = Counters(num_queries=M)
    if tree.leaf_point_count.shape[0] != tree.num_leaves:
        raise ValueError("ball_query_psphere needs the tree's point storage "
                         "(convert.octree_from_reference carries it)")
    q_idx, codes = _traverse_to_leaves(tree, queries, radius, c)
    # the leaf level is counted again, round by round, below
    c.nodes_traversed -= int(q_idx.shape[0])
    c.nodes_per_level.pop()
    out_idx, counts = _empty_result(M, k, dev)
    if q_idx.shape[0] == 0:
        c.wall_time_s = time.perf_counter() - t0
        return out_idx, counts, c
    pts, pidx, starts_all, counts_all, leaf_cap = _padded_storage(tree, dev)
    leaf_pos = _leaf_positions(tree, codes)
    # each query's leaves closest-first: sorted by distance, then stably by
    # query (the reference's lexsort is not stable: leaves at one distance
    # from a query may come in another order there)
    leaf_c, _ = node_centers_from_codes(
        codes, torch.from_numpy(np.asarray(tree.scene_lo, np.float32)).to(dev),
        tree.cell_size(tree.depth))
    q64 = q_idx.to(torch.int64)
    d2leaf = sq_dist(leaf_c, queries[q64])
    _, order = torch.sort(d2leaf, stable=True)
    _, order2 = torch.sort(q64[order], stable=True)
    order = order[order2]
    q64, leaf_pos = q64[order], leaf_pos[order]
    seg_start = torch.searchsorted(q64, q64, side="left")
    rank = torch.arange(q64.shape[0], device=dev) - seg_start
    max_rank = int(rank.max())

    r2 = radius_sq(radius)
    slots = torch.arange(leaf_cap, device=dev)
    lanes = torch.arange(q64.shape[0], dtype=torch.int32, device=dev)
    for round_i in range(0, max_rank + 1, chunk):
        live = (rank >= round_i) & (rank < round_i + chunk)
        if early_exit:
            live &= counts[q64] < k
        n = int(live.sum())
        if n == 0:
            continue
        keep = compact_columns(live, (lanes,), n)[1][0].to(torch.int64)
        qv, lv = q64[keep], leaf_pos[keep]
        c.nodes_traversed += n
        st, cnt = starts_all[lv], counts_all[lv]
        gather = st[:, None] + slots[None, :]            # (n, leaf_cap)
        cand, cand_idx = pts[gather], pidx[gather]
        valid = slots[None, :] < cnt[:, None]
        hit = (sq_dist(cand, queries[qv][:, None, :]) <= r2) & valid
        c.leaf_tests += int(valid.sum())
        out_idx, counts = _merge_candidates(
            out_idx, counts, qv.repeat_interleave(leaf_cap),
            cand_idx.reshape(-1), hit.reshape(-1))
    counts = counts.clamp(max=k)
    c.wall_time_s = time.perf_counter() - t0
    return out_idx, counts, c


def ball_query_pray(points: torch.Tensor, queries: torch.Tensor,
                    radius: float, k: int, depth: int = 6
                    ) -> Tuple[torch.Tensor, torch.Tensor, Counters]:
    """P-Ray: every cloud point traverses a small octree built (on the
    host) over the query centres; one merge, no early exit (a point cannot
    know whether its queries are full).  On the points' device; returns
    as :func:`ball_query_psphere`, a query's neighbours in point order
    (the brute force's first ``k``, unless the descent's ``max_frontier``
    cut dropped pairs: ROADMAP C.19)."""
    t0 = time.perf_counter()
    points = points.to(torch.float32)
    dev = points.device
    queries_np = queries.detach().to("cpu", torch.float32).numpy()
    qtree = build_octree(queries_np, depth=depth)
    M, N = queries_np.shape[0], points.shape[0]
    c = Counters(num_queries=int(N))             # rays = points
    p_idx, codes = _traverse_to_leaves(qtree, points, radius, c)
    out_idx, counts = _empty_result(M, k, dev)
    if p_idx.shape[0] == 0:
        c.wall_time_s = time.perf_counter() - t0
        return out_idx, counts, c
    qpts, qmap, starts_all, counts_all, q_leafcap = _padded_storage(qtree,
                                                                    dev)
    leaf_pos = _leaf_positions(qtree, codes)
    starts, cnts = starts_all[leaf_pos], counts_all[leaf_pos]
    slots = torch.arange(q_leafcap, device=dev)
    gather = starts[:, None] + slots[None, :]            # (E, cap)
    cand_q, cand_qi = qpts[gather], qmap[gather]
    valid = slots[None, :] < cnts[:, None]
    p64 = p_idx.to(torch.int64)
    hit = (sq_dist(cand_q, points[p64][:, None, :]) <= radius_sq(radius)
           ) & valid
    c.leaf_tests += int(valid.sum())
    out_idx, counts = _merge_candidates(
        out_idx, counts, cand_qi.reshape(-1),
        p_idx.repeat_interleave(q_leafcap), hit.reshape(-1))
    counts = counts.clamp(max=k)
    c.wall_time_s = time.perf_counter() - t0
    return out_idx, counts, c
