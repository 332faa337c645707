"""Swept-edge (CCD) validation of motion-planning graph edges (PyTorch).

Counterpart of ``repro.core.sweep``.  A planning-graph *edge* is a
straight segment in joint space; validating it means finding the first
colliding configuration along the motion.  The edge wants to stop at its
first hit, not sample every waypoint.

1. The edge is cut into ``resolution`` sub-intervals; forward kinematics
   runs once for every waypoint of every edge, on the engine's device
   (:func:`repro_torch.core.geometry.arm_link_obbs`), and the corners and
   rotations come to host numpy once (:func:`edge_link_geometry`).
2. Each segment ``[t0, t1]`` is enclosed in conservative swept OBBs, one a
   robot link: in the frame of the link's rotation at the segment's middle
   waypoint, the box fitted around the corners of every contained
   waypoint's link OBB (:func:`swept_obbs`, host numpy, the reference's
   expressions in its order).
3. **Left-first bisection**: per edge a queue of disjoint untested
   segments sorted by ``t0``.  Each round pops every undecided edge's
   earliest segment into one pool, its links grouped under one verdict
   owner (:func:`repro_torch.engine.plan.plan_edges`), and bisects only
   the segments whose swept volume hit occupied leaves.  A miss retires
   its whole sub-interval, so the first width-1 confirmation is the first
   hit.
4. Width-1 prefixes go through the **payload lane**: each slot's payload
   is its sub-interval rank, the owner lane groups a whole edge, and the
   traversal keeps the per-edge least payload that hit, with lanes that
   can no longer beat it retired inside the traversal.

``in_traversal_exit=False`` runs every round as a boolean plan and
reduces the groups and minima on the host: the same verdicts, more nodes
visited.  An engine in a mode that is not device-resident (the host
arms, ``naive``) takes no owner or payload lanes, so its rounds take that
path whatever ``in_traversal_exit`` says.  The enclosures reach the engine as tensors on its device.
"""
from __future__ import annotations

import time
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.counters import Counters
from repro_torch.core.geometry import (NUM_LINKS, OBBs, arm_link_obbs,
                                       obb_corners)
from repro_torch.core.sact import PAYLOAD_INF
from repro_torch.engine.plan import plan_edges, plan_queries

#: Absolute inflation of fitted enclosures: keeps containment strict under
#: float32 rounding of the two rotation transforms (world -> mid frame ->
#: world), so the soundness invariant survives exact SACT comparisons.
_FIT_EPS = 1e-5


def edge_waypoints(q_from: np.ndarray, q_to: np.ndarray,
                   resolution: int) -> np.ndarray:
    """(E, 7) endpoint configs -> (E, R+1, 7) linear joint-space waypoints."""
    t = np.linspace(0.0, 1.0, resolution + 1, dtype=np.float32)[None, :, None]
    qf = np.asarray(q_from, np.float32)[:, None, :]
    qt = np.asarray(q_to, np.float32)[:, None, :]
    return qf * (1.0 - t) + qt * t


def edge_link_geometry(q_from: np.ndarray, q_to: np.ndarray, resolution: int,
                       base_pos=None, *, device
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """FK every edge waypoint once, on ``device``.

    Returns host numpy (corners (E, R+1, L, 8, 3), rot (E, R+1, L, 3, 3)):
    all the geometry the bisection needs; later rounds only re-fit
    enclosures over subsets of these corners.
    """
    E = np.asarray(q_from).shape[0]
    R = resolution
    cfgs = torch.from_numpy(edge_waypoints(q_from, q_to, R)).to(device)
    obbs = arm_link_obbs(cfgs, base_pos=base_pos)
    corners = obb_corners(obbs).cpu().numpy().reshape(E, R + 1, NUM_LINKS,
                                                      8, 3)
    rot = obbs.rot.cpu().numpy().reshape(E, R + 1, NUM_LINKS, 3, 3)
    return corners, rot


def swept_obbs(corners: np.ndarray, rot: np.ndarray, edge: np.ndarray,
               lo: np.ndarray, hi: np.ndarray, device) -> OBBs:
    """Conservative swept enclosures for segments [lo, hi] of some edges.

    For each (segment, link): in the frame of the link's rotation at the
    middle waypoint, fit the min/max extents of the corners of every
    contained waypoint box.  Returns flat OBBs on ``device``, segment-major
    x link-minor (``n_seg * NUM_LINKS`` boxes).
    """
    edge = np.asarray(edge)
    lo = np.asarray(lo)
    hi = np.asarray(hi)
    # Mixed widths share one gather: clamping the waypoint span to ``hi``
    # duplicates the last contained waypoint, which cannot move a min/max.
    w = int((hi - lo).max())
    span = np.minimum(lo[:, None] + np.arange(w + 1)[None, :], hi[:, None])
    pts = corners[edge[:, None], span]                        # (N, w+1, L, 8, 3)
    r_mid = rot[edge, (lo + hi) // 2]                         # (N, L, 3, 3)
    local = np.einsum("nlji,nwlkj->nwlki", r_mid, pts)
    mn = local.min(axis=(1, 3))                               # (N, L, 3)
    mx = local.max(axis=(1, 3))
    half = (mx - mn) * 0.5 + _FIT_EPS
    center = np.einsum("nlij,nlj->nli", r_mid, (mn + mx) * 0.5)
    n = len(edge) * NUM_LINKS

    def tensor(x, shape):
        return torch.from_numpy(np.ascontiguousarray(
            x.reshape(shape), dtype=np.float32)).to(device)
    return OBBs(center=tensor(center, (n, 3)), half=tensor(half, (n, 3)),
                rot=tensor(r_mid, (n, 3, 3)))


def _segment_hits(engine, obbs: OBBs, n_seg: int,
                  in_traversal_exit: bool = True
                  ) -> Tuple[np.ndarray, Counters]:
    """One coarse refinement round: per-segment any-link hit flags."""
    if engine.cfg.device_resident and in_traversal_exit:
        owner = np.repeat(np.arange(n_seg, dtype=np.int32), NUM_LINKS)
        best, c = engine.execute(plan_edges(obbs, owner, n_seg))
        return best < PAYLOAD_INF, c
    collide, c = engine.execute(plan_queries(obbs))
    return collide.reshape(n_seg, NUM_LINKS).any(axis=1), c


def _first_hits(engine, obbs: OBBs, edge: np.ndarray, lo: np.ndarray,
                in_traversal_exit: bool = True
                ) -> Tuple[np.ndarray, Counters]:
    """One payload round over width-1 segments: per-edge first hit.

    ``edge`` may repeat (several sub-intervals of one edge race in one
    traversal); returns the (E',) best payload per distinct edge in
    ``np.unique(edge)`` order, ``PAYLOAD_INF`` where nothing hit.
    """
    uniq, local = np.unique(edge, return_inverse=True)
    if engine.cfg.device_resident and in_traversal_exit:
        owner = np.repeat(local.astype(np.int32), NUM_LINKS)
        payload = np.repeat(lo.astype(np.int32), NUM_LINKS)
        got, c = engine.execute(
            plan_edges(obbs, owner, len(uniq), payload=payload))
        return np.asarray(got, np.int64), c
    collide, c = engine.execute(plan_queries(obbs))
    seg_hit = collide.reshape(len(edge), NUM_LINKS).any(axis=1)
    best = np.full(len(uniq), PAYLOAD_INF, np.int64)
    np.minimum.at(best, local[seg_hit], lo[seg_hit].astype(np.int64))
    return best, c


def sweep_edges(engine, q_from, q_to, resolution: int = 16,
                base_pos=None, in_traversal_exit: bool = True
                ) -> Tuple[np.ndarray, np.ndarray, Counters]:
    """Batched first-hit validation of E joint-space edges (module doc).

    Returns ``(first_hit (E,) float32, collide (E,) bool, counters)``:
    ``first_hit[e]`` is the parameter t0 of the first colliding
    sub-interval ``[t0, t0 + 1/resolution]`` (``inf`` for a collision-free
    edge), and ``counters`` sums the work of every refinement round.
    ``in_traversal_exit=False`` is the ablation arm: every round takes the
    ungrouped ``plan_queries`` path and reduces owner groups and payload
    minima on the host -- the same verdicts, more nodes visited.
    """
    q_from = np.asarray(q_from, np.float32)
    q_to = np.asarray(q_to, np.float32)
    if q_from.ndim != 2 or q_from.shape != q_to.shape:
        raise ValueError("q_from / q_to must both be (E, 7) configurations")
    R = int(resolution)
    if R < 1 or (R & (R - 1)) != 0:
        # The bisection halves segments down to width 1; a non-power-of-two
        # grid would split unevenly and misalign first_hit = best / R.
        raise ValueError(f"resolution must be a power of two, got {R}")
    E = q_from.shape[0]
    device = engine.device
    t0_wall = time.perf_counter()
    corners, rot = edge_link_geometry(q_from, q_to, R, base_pos=base_pos,
                                      device=device)
    total = Counters()

    # Left-first descent.  Queues hold disjoint untested segments sorted by
    # t0; popping always takes the earliest, so segments deeper in a queue
    # start at or after everything ever popped -- the first width-1
    # confirmation is the edge's true first hit.
    queues = [[(0, R)] for _ in range(E)]
    best = np.full(E, PAYLOAD_INF, np.int64)
    decided = np.zeros(E, bool)
    while True:
        ce, clo, chi = [], [], []            # this round's coarse pops
        fe, flo = [], []                     # width-1 prefix pops
        for e in range(E):
            if decided[e] or not queues[e]:
                continue
            if queues[e][0][1] - queues[e][0][0] == 1:
                while queues[e] and queues[e][0][1] - queues[e][0][0] == 1:
                    s = queues[e].pop(0)
                    fe.append(e)
                    flo.append(s[0])
            else:
                s = queues[e].pop(0)
                ce.append(e)
                clo.append(s[0])
                chi.append(s[1])
        if not ce and not fe:
            break
        if fe:
            fe = np.asarray(fe, np.int32)
            flo = np.asarray(flo, np.int32)
            got, c = _first_hits(
                engine, swept_obbs(corners, rot, fe, flo, flo + 1, device),
                fe, flo, in_traversal_exit=in_traversal_exit)
            total.merge(c)
            uniq = np.unique(fe)
            hit = got < PAYLOAD_INF
            best[uniq[hit]] = got[hit]
            decided[uniq[hit]] = True
        if ce:
            ce = np.asarray(ce, np.int32)
            clo = np.asarray(clo, np.int32)
            chi = np.asarray(chi, np.int32)
            hits, c = _segment_hits(
                engine, swept_obbs(corners, rot, ce, clo, chi, device),
                len(ce), in_traversal_exit=in_traversal_exit)
            total.merge(c)
            for e, lo, hi in zip(ce[hits], clo[hits], chi[hits]):
                mid = (lo + hi) // 2
                queues[e].insert(0, (mid, hi))
                queues[e].insert(0, (lo, mid))

    first_hit = np.where(best < PAYLOAD_INF,
                         best.astype(np.float32) / np.float32(R),
                         np.inf).astype(np.float32)
    total.wall_time_s = time.perf_counter() - t0_wall
    return first_hit, best < PAYLOAD_INF, total
