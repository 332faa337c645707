"""Separating-Axis Collision Test (SACT) between OBBs and AABBs (PyTorch).

Counterpart of ``repro.core.sact``: the staged test of RoboGPU Fig. 6,

  stage 0  bounding-sphere test      -> early NO-collision cull
  stage 1  inscribing-sphere test    -> early COLLISION confirm
  stages 2..7   6 box-normal axes    -> early NO-collision per axis
  stages 8..16  9 edge x edge axes   -> early NO-collision per axis
  stage 17 no separating axis        -> COLLISION

evaluated elementwise over broadcastable box batches.  The exit code
records what a conditional-return machine would have executed.

Axis formulas follow Ericson, *Real-Time Collision Detection* §4.4.1, with
box A = AABB and box B = OBB; ``R[i, j]`` is component ``i`` of OBB axis
``j``.  The 3-term dot products are written out as ``x0*y0 + x1*y1 +
x2*y2``, one rounding per operation (torch runs each op on its own and
never contracts ``a*b+c`` into a fused multiply-add).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

_EPS = 1e-6

EXIT_BSPHERE = 0          # bounding-sphere cull           -> no collision
EXIT_ISPHERE = 1          # inscribing-sphere confirm      -> collision
EXIT_AXIS0 = 2            # separating axis k found        -> no collision
EXIT_FULL = 17            # all 15 axes overlap            -> collision
NUM_AXES = 15
NUM_BOX_NORMAL = 6
NUM_EDGE = 9

#: Payload-lane "no hit" sentinel: a group's ``best`` cell ends as the
#: smallest payload that hit, and ``PAYLOAD_INF`` means it never hit.
PAYLOAD_INF = 2**31 - 1


class PairTerms(NamedTuple):
    """Precomputed per-pair quantities shared by all axis tests."""

    t: torch.Tensor       # (..., 3)  OBB centre in AABB frame
    R: torch.Tensor       # (..., 3, 3)
    absR: torch.Tensor    # (..., 3, 3)  |R| + eps
    a_half: torch.Tensor  # (..., 3)  AABB half extents
    b_half: torch.Tensor  # (..., 3)  OBB half extents


def make_pair_terms(obb_center, obb_half, obb_rot, aabb_center, aabb_half
                    ) -> PairTerms:
    """Preprocessing stage.  All args broadcast against each other."""
    t = obb_center - aabb_center
    absR = torch.abs(obb_rot) + _EPS
    return PairTerms(t=t, R=obb_rot, absR=absR, a_half=aabb_half,
                     b_half=obb_half)


def _dot3(x, y):
    """x[..., 0]*y[..., 0] + x[..., 1]*y[..., 1] + x[..., 2]*y[..., 2]."""
    return x[..., 0] * y[..., 0] + x[..., 1] * y[..., 1] + x[..., 2] * y[..., 2]


def box_normal_margins(p: PairTerms) -> torch.Tensor:
    """Margins for the 6 box-normal axes -> (..., 6); positive separates.

    Axes 0..2 are the AABB axes, 3..5 the OBB axes.
    """
    # L = A_i: |t[i]| vs a_half[i] + sum_j b_half[j] * absR[i, j]
    rb_a = torch.stack([_dot3(p.b_half, p.absR[..., i, :]) for i in range(3)],
                       dim=-1)
    m_a = torch.abs(p.t) - (p.a_half + rb_a)
    # L = B_j: |t . R[:, j]| vs sum_i a_half[i] * absR[i, j] + b_half[j]
    t_in_b = torch.stack([_dot3(p.t, p.R[..., :, j]) for j in range(3)],
                         dim=-1)
    ra_b = torch.stack([_dot3(p.a_half, p.absR[..., :, j]) for j in range(3)],
                       dim=-1)
    m_b = torch.abs(t_in_b) - (ra_b + p.b_half)
    return torch.cat([m_a, m_b], dim=-1)


def edge_margins(p: PairTerms) -> torch.Tensor:
    """Margins for the 9 edge x edge axes A_i x B_j -> (..., 9), axis
    ``k = A_{k//3} x B_{k%3}``."""
    margins = []
    for i in range(3):
        i1, i2 = (i + 1) % 3, (i + 2) % 3
        for j in range(3):
            j1, j2 = (j + 1) % 3, (j + 2) % 3
            ra = (p.a_half[..., i1] * p.absR[..., i2, j]
                  + p.a_half[..., i2] * p.absR[..., i1, j])
            rb = (p.b_half[..., j1] * p.absR[..., i, j2]
                  + p.b_half[..., j2] * p.absR[..., i, j1])
            lhs = torch.abs(p.t[..., i2] * p.R[..., i1, j]
                            - p.t[..., i1] * p.R[..., i2, j])
            margins.append(lhs - (ra + rb))
    return torch.stack(margins, dim=-1)


def all_axis_margins(p: PairTerms) -> torch.Tensor:
    """All 15 axis margins, stage order -> (..., 15)."""
    return torch.cat([box_normal_margins(p), edge_margins(p)], dim=-1)


def sphere_tests(obb_center, obb_half, aabb_center, aabb_half
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bounding / inscribing sphere pre-tests -> (bsphere_miss, isphere_hit)."""
    d = torch.clamp(torch.abs(obb_center - aabb_center) - aabb_half, min=0.0)
    d2 = _dot3(d, d)
    r_out = torch.sqrt(_dot3(obb_half, obb_half))
    r_in = obb_half.min(dim=-1).values
    return d2 > torch.square(r_out), d2 < torch.square(r_in)


class SactResult(NamedTuple):
    collide: torch.Tensor       # (...,) bool
    exit_code: torch.Tensor     # (...,) int32, see EXIT_* above
    axis_tests: torch.Tensor    # (...,) int32 axis tests a CR machine runs
    sphere_tests: torch.Tensor  # (...,) int32 sphere tests executed (0 or 2)


def axis_tests_from_exit(exit_code: torch.Tensor) -> torch.Tensor:
    """Conditional-return axis-test count of an exit code: sphere exits
    run none, separating axis k (code 2 + k) costs k + 1, EXIT_FULL 15."""
    code = exit_code.to(torch.int32)
    return torch.where(code <= EXIT_ISPHERE, 0,
                       torch.clamp(code - 1, max=NUM_AXES)).to(torch.int32)


def _staged_result(bsphere_miss, isphere_hit, margins, use_spheres: bool
                   ) -> SactResult:
    sep = margins > 0.0
    any_sep = sep.any(dim=-1)
    first_sep = torch.where(any_sep, sep.to(torch.uint8).argmax(dim=-1),
                            NUM_AXES)
    axis_code = torch.where(any_sep, EXIT_AXIS0 + first_sep, EXIT_FULL)
    if use_spheres:
        collide = torch.where(bsphere_miss, False,
                              torch.where(isphere_hit, True, ~any_sep))
        exit_code = torch.where(bsphere_miss, EXIT_BSPHERE,
                                torch.where(isphere_hit, EXIT_ISPHERE,
                                            axis_code))
        n_sphere = torch.full(exit_code.shape, 2, dtype=torch.int32,
                              device=margins.device)
    else:
        collide = ~any_sep
        exit_code = axis_code
        n_sphere = torch.zeros(exit_code.shape, dtype=torch.int32,
                               device=margins.device)
    exit_code = exit_code.to(torch.int32)
    return SactResult(collide=collide, exit_code=exit_code,
                      axis_tests=axis_tests_from_exit(exit_code),
                      sphere_tests=n_sphere)


def _no_spheres(shape, device):
    z = torch.zeros(shape, dtype=torch.bool, device=device)
    return z, z


def sact(obb_center, obb_half, obb_rot, aabb_center, aabb_half,
         use_spheres: bool = False) -> SactResult:
    """Elementwise staged SACT over broadcastable box batches."""
    p = make_pair_terms(obb_center, obb_half, obb_rot, aabb_center, aabb_half)
    margins = all_axis_margins(p)
    if use_spheres:
        bs, is_ = sphere_tests(obb_center, obb_half, aabb_center, aabb_half)
    else:
        bs, is_ = _no_spheres(margins.shape[:-1], margins.device)
    return _staged_result(bs, is_, margins, use_spheres)


def payload_min_update(best, owner_lane, payload_lane, hit):
    """Fold a frontier's terminal hits into the per-group ``best`` lane
    with a scatter-min (``include_self``: a cell keeps its value where no
    lane beats it); non-hit lanes contribute the sentinel, a no-op.  The
    payload generalisation of the boolean ``amax`` fold."""
    vals = torch.where(hit, payload_lane.to(torch.int32),
                       torch.full_like(payload_lane, PAYLOAD_INF,
                                       dtype=torch.int32))
    return best.scatter_reduce(0, owner_lane.to(torch.int64), vals, "amin",
                               include_self=True)


def fold_verdicts(verdict, q64, term_hit, owner=None, payload=None):
    """Fold one frontier level's terminal hits into the verdicts; returns
    ``(verdict, undecided)``, ``undecided`` the lanes that may still
    expand.  The per-level arms' shared step.

    Boolean plans (no lanes): ``verdict`` is (M,) int32, 1 once a query
    hit, updated in place; a lane is undecided while its query is 0.
    With ``owner`` / ``payload`` lanes ((M,) int32; a missing owner lane
    is the identity, a missing payload lane zeros): each lane's payload is
    min-folded into its owner's ``best`` cell, and a lane is undecided
    while its payload can still beat that cell.  ``q64`` is the lanes'
    int64 query ids.
    """
    if owner is None and payload is None:
        verdict.scatter_reduce_(0, q64, term_hit.to(verdict.dtype), "amax")
        return verdict, verdict[q64] == 0
    pay = (torch.zeros(q64.shape, dtype=torch.int32, device=q64.device)
           if payload is None else payload[q64])
    own = q64 if owner is None else owner[q64].to(torch.int64)
    verdict = payload_min_update(verdict, own, pay, term_hit)
    return verdict, pay < verdict[own]


def mask_frontier_result(res: SactResult, valid) -> SactResult:
    """Clear booleans / zero counters on invalid (padding) lanes."""
    return SactResult(*(x & valid if x.dtype == torch.bool
                        else torch.where(valid, x, 0) for x in res))


def sact_frontier(obb_center, obb_half, obb_rot, aabb_center, aabb_half,
                  valid, use_spheres: bool = False) -> SactResult:
    """Staged SACT over a frontier of gathered pairs with a validity mask:
    :func:`sact` on every lane, then invalid (padding) lanes cleared.  The
    unstaged test of ``mode="wavefront"``."""
    res = sact(obb_center, obb_half, obb_rot, aabb_center, aabb_half,
               use_spheres=use_spheres)
    return mask_frontier_result(res, valid)


def sact_frontier_staged(obb_center, obb_half, obb_rot, aabb_center,
                         aabb_half, valid, use_spheres: bool = False
                         ) -> SactResult:
    """Two-phase frontier SACT: spheres plus the 6 box-normal axes on every
    pair, the 9 edge axes only when some valid pair is still undecided.

    Exit codes and axis-test counts do not depend on the skip: phase-2
    margins only influence lanes that reach phase 2.
    """
    p = make_pair_terms(obb_center, obb_half, obb_rot, aabb_center, aabb_half)
    m_box = box_normal_margins(p)
    shape = m_box.shape[:-1]
    if use_spheres:
        bs, is_ = sphere_tests(obb_center, obb_half, aabb_center, aabb_half)
    else:
        bs, is_ = _no_spheres(shape, m_box.device)
    undecided = valid & ~bs & ~is_ & ~(m_box > 0.0).any(dim=-1)
    if bool(undecided.any()):
        m_edge = edge_margins(p)
    else:
        m_edge = torch.zeros(shape + (NUM_EDGE,), dtype=m_box.dtype,
                             device=m_box.device)
    res = _staged_result(bs, is_, torch.cat([m_box, m_edge], dim=-1),
                         use_spheres)
    return mask_frontier_result(res, valid)


def sact_pairwise(obbs, aabbs, use_spheres: bool = False) -> SactResult:
    """Dense all-pairs staged SACT: (M,) OBBs x (N,) AABBs -> (M, N)
    results."""
    return sact(obbs.center[:, None, :], obbs.half[:, None, :],
                obbs.rot[:, None, :, :], aabbs.center[None, :, :],
                aabbs.half[None, :, :], use_spheres=use_spheres)


def sact_collide_only(obb_center, obb_half, obb_rot, aabb_center, aabb_half
                      ) -> torch.Tensor:
    """Cheapest full test: just the boolean, no work model."""
    p = make_pair_terms(obb_center, obb_half, obb_rot, aabb_center, aabb_half)
    return ~(all_axis_margins(p) > 0.0).any(dim=-1)


def sact_pairwise_blocked(obbs, aabbs, block: int = 256,
                          use_spheres: bool = False) -> SactResult:
    """:func:`sact_pairwise` in OBB blocks of ``block`` rows, to bound
    peak memory; (M, N) results.  The test is elementwise, so a block's
    rows equal the whole plane's."""
    parts = [sact(obbs.center[s:s + block, None, :],
                  obbs.half[s:s + block, None, :],
                  obbs.rot[s:s + block, None, :, :],
                  aabbs.center[None, :, :], aabbs.half[None, :, :],
                  use_spheres=use_spheres)
             for s in range(0, max(obbs.n, 1), block)]
    return SactResult(*(torch.cat(f, dim=0) for f in zip(*parts)))
