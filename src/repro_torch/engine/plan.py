"""Query planning: lower front-end batch shapes to one canonical pool.

Counterpart of ``repro.engine.plan``.  A :class:`QueryPlan` is a flat OBB
pool ``(Q, 3)/(Q, 3)/(Q, 3, 3)`` of tensors, optional scene / owner /
payload lanes, and an un-flattening recipe that maps the flat verdicts back
to the front end's shape.  This package lowers single query sets
(:func:`plan_queries`), (B, M) batches (:func:`plan_batch`), S scenes of
M queries each with a scene lane (:func:`plan_scenes`), joint-space
trajectories (:func:`plan_trajectory`) and swept-edge pools with owner and
payload lanes (:func:`plan_edges`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.geometry import NUM_LINKS, OBBs, arm_link_obbs
from repro_torch.core.sact import PAYLOAD_INF

#: Front-end workloads a plan can carry (the reference's tuple).
WORKLOADS = ("queries", "batch", "scenes", "trajectory", "edges")


class PlanValidationError(ValueError):
    """A plan's OBB pool is malformed (shape/dtype/NaN/inf/degenerate)."""


@dataclasses.dataclass(frozen=True)
class QueryPlan:
    """One lowered collision query batch (see module docstring)."""

    kind: str                     # workload tag, one of WORKLOADS
    obb_c: torch.Tensor           # (Q, 3) flat query OBB pool
    obb_h: torch.Tensor           # (Q, 3)
    obb_r: torch.Tensor           # (Q, 3, 3)
    out_shape: Tuple[int, ...]    # group verdicts reshape to this
    num_scenes: int = 1
    scene_of_query: Optional[torch.Tensor] = None   # (Q,) int32
    owner_of_query: Optional[torch.Tensor] = None   # (Q,) int32
    num_groups: Optional[int] = None                # None = Q
    payload: Optional[torch.Tensor] = None          # (Q,) int32
    reduce_last: bool = False     # any() over out_shape's last axis

    def __post_init__(self):
        if self.kind not in WORKLOADS:
            raise ValueError(
                f"unknown workload {self.kind!r}; allowed: "
                f"{', '.join(WORKLOADS)}")
        if math.prod(self.out_shape) != self.groups:
            raise ValueError(
                f"out_shape {self.out_shape} does not hold {self.groups} "
                f"verdict groups")

    @property
    def num_queries(self) -> int:
        return self.obb_c.shape[0]

    @property
    def groups(self) -> int:
        return self.num_groups if self.num_groups is not None \
            else self.num_queries

    @property
    def grouped(self) -> bool:
        """True when the plan carries owner or payload lanes."""
        return self.owner_of_query is not None or self.payload is not None

    @property
    def obbs(self) -> OBBs:
        return OBBs(center=self.obb_c, half=self.obb_h, rot=self.obb_r)

    @property
    def shape_tag(self) -> str:
        """One-line plan-shape descriptor for logs."""
        lanes = [n for n, v in (("scene", self.scene_of_query),
                                ("owner", self.owner_of_query),
                                ("payload", self.payload))
                 if v is not None]
        return (f"{self.kind}[Q={self.num_queries} S={self.num_scenes} "
                f"G={self.groups} lanes={'+'.join(lanes) or 'none'}]")

    def work_units(self, scene_nodes: int) -> int:
        """Predicted traversal work: scene node count x query count."""
        return int(scene_nodes) * self.num_queries

    def unflatten(self, flat) -> np.ndarray:
        """Map flat (G,) group verdicts back to the front end's shape."""
        if isinstance(flat, torch.Tensor):
            flat = flat.cpu().numpy()
        out = np.asarray(flat).reshape(self.out_shape)
        if self.reduce_last:
            out = out.any(axis=-1)
        return out


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def validate_plan(plan: QueryPlan) -> QueryPlan:
    """Reject malformed OBB pools, naming the first offending field."""
    q = plan.num_queries
    fields = (("obb_c", plan.obb_c, (q, 3)), ("obb_h", plan.obb_h, (q, 3)),
              ("obb_r", plan.obb_r, (q, 3, 3)))
    for name, arr, want in fields:
        a = _np(arr)
        if a.shape != want:
            raise PlanValidationError(
                f"plan.{name} has shape {a.shape}, want {want}")
        if a.dtype != np.float32:
            raise PlanValidationError(
                f"plan.{name} has dtype {a.dtype}, want float32 (the "
                f"engine's pool dtype; cast before submitting)")
        if not np.isfinite(a).all():
            bad = int(np.flatnonzero(
                ~np.isfinite(a).reshape(q, -1).all(1))[0])
            raise PlanValidationError(
                f"plan.{name} contains NaN/inf (first bad query slot "
                f"{bad}); non-finite OBBs poison every SACT test in the "
                f"coalesced pool")
    h = _np(plan.obb_h)
    if not (h > 0).all():
        bad = int(np.flatnonzero(~(h > 0).all(axis=1))[0])
        raise PlanValidationError(
            f"plan.obb_h must be strictly positive (first degenerate "
            f"query slot {bad}); zero/negative half extents make the "
            f"separating-axis margins meaningless")
    for name, lane in (("scene_of_query", plan.scene_of_query),
                       ("owner_of_query", plan.owner_of_query),
                       ("payload", plan.payload)):
        if lane is None:
            continue
        a = _np(lane)
        if a.shape != (q,) or a.dtype != np.int32:
            raise PlanValidationError(
                f"plan.{name} must be ({q},) int32, got {a.shape} "
                f"{a.dtype}")
    return plan


def plan_queries(obbs: OBBs) -> QueryPlan:
    """Single flat query set: (M,) OBBs against one scene."""
    assert obbs.center.ndim == 2, "plan_queries wants flat (M, 3) fields"
    return QueryPlan(kind="queries", obb_c=obbs.center, obb_h=obbs.half,
                     obb_r=obbs.rot, out_shape=(obbs.n,))


def plan_batch(obbs: OBBs) -> QueryPlan:
    """(B, M) query sets against one scene, lowered to one flat pool."""
    assert obbs.center.ndim == 3, "plan_batch wants (B, M, 3) fields"
    B, M = obbs.center.shape[:2]
    return QueryPlan(kind="batch", obb_c=obbs.center.reshape(-1, 3),
                     obb_h=obbs.half.reshape(-1, 3),
                     obb_r=obbs.rot.reshape(-1, 3, 3), out_shape=(B, M))


def plan_scenes(obbs: OBBs) -> QueryPlan:
    """S scenes x (M,) queries each: the flat pool of S * M slots, scene
    ``s``'s queries at slots ``[s * M, (s + 1) * M)``, and the scene lane
    ``scene_of_query = repeat(arange(S), M)`` (int32, on the OBBs'
    device)."""
    assert obbs.center.ndim == 3, "plan_scenes wants (S, M, 3) fields"
    S, M = obbs.center.shape[:2]
    soq = torch.arange(S, dtype=torch.int32,
                       device=obbs.center.device).repeat_interleave(M)
    return QueryPlan(kind="scenes", obb_c=obbs.center.reshape(-1, 3),
                     obb_h=obbs.half.reshape(-1, 3),
                     obb_r=obbs.rot.reshape(-1, 3, 3), out_shape=(S, M),
                     num_scenes=S, scene_of_query=soq)


def plan_trajectory(waypoints, base_pos=None) -> QueryPlan:
    """Joint-space waypoints (..., 7) -> link-OBB pool with an any-link
    reduction: forward kinematics (on the waypoints' device) emits
    ``NUM_LINKS`` query slots per waypoint, and the un-flattening recipe
    ORs them back into per-waypoint flags."""
    waypoints = torch.as_tensor(waypoints, dtype=torch.float32)
    obbs = arm_link_obbs(waypoints, base_pos=base_pos)   # flat (prod*L,)
    return QueryPlan(kind="trajectory", obb_c=obbs.center, obb_h=obbs.half,
                     obb_r=obbs.rot,
                     out_shape=tuple(waypoints.shape[:-1]) + (NUM_LINKS,),
                     reduce_last=True)


def plan_edges(obbs: OBBs, owner, num_groups: int,
               payload=None) -> QueryPlan:
    """Swept-edge pool: flat swept OBBs with owner (+ optional payload)
    lanes.

    ``owner`` groups the slots that decide together (a segment's links, or
    every surviving segment of one edge); ``payload`` carries each slot's
    sub-interval rank for first-hit queries.  Owner ids must be compact --
    every value in ``[0, num_groups)`` with ``num_groups <= len(owner)`` --
    so the executor can keep grouped verdicts in a pool-sized buffer.
    The lanes become int32 tensors where the caller's arrays are (host
    numpy -> CPU).  Built by :func:`repro_torch.core.sweep.sweep_edges`.
    """
    assert obbs.center.ndim == 2, "plan_edges wants a flat pool"
    own_np = _np(owner)
    if num_groups > obbs.n or (own_np.size and (
            int(own_np.min()) < 0 or int(own_np.max()) >= num_groups)):
        # Non-compact ids would scatter hits into the sliced-off tail of
        # the executor's Q-sized verdict buffer: a silently lost verdict.
        raise ValueError(
            f"owner ids must be compact in [0, {num_groups}) with "
            f"num_groups <= {obbs.n} query slots")
    own = torch.as_tensor(owner, dtype=torch.int32)
    pay = None if payload is None else torch.as_tensor(payload,
                                                       dtype=torch.int32)
    return QueryPlan(kind="edges", obb_c=obbs.center, obb_h=obbs.half,
                     obb_r=obbs.rot, out_shape=(num_groups,),
                     owner_of_query=own, num_groups=num_groups, payload=pay)


__all__ = ["PAYLOAD_INF", "PlanValidationError", "QueryPlan", "WORKLOADS",
           "plan_batch", "plan_edges", "plan_queries", "plan_scenes",
           "plan_trajectory", "validate_plan"]
