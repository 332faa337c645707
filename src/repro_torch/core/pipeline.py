"""End-to-end motion planning with the explicit collision gate (PyTorch).

Counterpart of ``repro.core.pipeline``, RoboGPU Fig. 18: point-cloud
processing (sampling and grouping) -> neural planner rollout -> explicit
collision check of the proposed trajectory.  The trajectory lowers through
:func:`repro_torch.engine.plan.plan_trajectory` and runs on
:meth:`repro_torch.engine.executor.CollisionEngine.execute`.  Stage walls
are honest: each stage ends in ``torch.cuda.synchronize()`` on the card
(the reference's ``block_until_ready``), so no stage's queued launches
are charged to the next.

``check_edges`` is the swept-edge (CCD) workload: batched first-hit
validation of planning-graph edges (:mod:`repro_torch.core.sweep`).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.sweep import sweep_edges
from repro_torch.engine.executor import CollisionEngine
from repro_torch.engine.plan import plan_trajectory
from repro_torch.models.planner import Planner


@dataclasses.dataclass
class PipelineResult:
    trajectory: np.ndarray           # (T+1, 7) joint waypoints
    collision_free: bool
    colliding_waypoints: np.ndarray  # (T+1,) bool
    timings: Dict[str, float]
    counters: Optional[object] = None


@dataclasses.dataclass
class EdgeCheckResult:
    """Batched swept-edge validation verdicts (``check_edges``)."""

    first_hit: np.ndarray   # (E,) float32 t0 of the first colliding
    #                         sub-interval (inf = edge collision-free)
    collide: np.ndarray     # (E,) bool
    counters: Optional[object] = None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def check_trajectory(engine: CollisionEngine, waypoints, base_pos=None):
    """FK every waypoint ``(T, 7)`` -> link OBBs -> one octree query; the
    plan ORs each waypoint's links.  Returns ((T,) flags, counters)."""
    return engine.execute(plan_trajectory(waypoints, base_pos=base_pos))


def check_trajectories(engine: CollisionEngine, waypoints, base_pos=None):
    """Collision-gate a batch of trajectories ``(B, T, 7)`` in one query;
    returns ((B, T) flags, counters)."""
    return engine.execute(plan_trajectory(waypoints, base_pos=base_pos))


def check_edges(engine: CollisionEngine, q_from, q_to, resolution: int = 16,
                base_pos=None,
                in_traversal_exit: bool = True) -> EdgeCheckResult:
    """Swept-edge (CCD) validation of E planning-graph edges.

    Each edge ``q_from[e] -> q_to[e]`` ((E, 7) joint configurations,
    linear interpolation) is enclosed in conservative swept OBBs and
    bisected only where the swept volume hits occupied leaves; the finest
    rounds' payload lane returns each edge's first colliding sub-interval
    with in-traversal early exit.  ``first_hit[e]`` is that
    sub-interval's t0 (``inf`` for a collision-free edge), an upper-bound
    verdict over dense waypoint sampling at the same ``resolution``, which
    must be a power of two.
    """
    first_hit, collide, counters = sweep_edges(
        engine, q_from, q_to, resolution=resolution, base_pos=base_pos,
        in_traversal_exit=in_traversal_exit)
    return EdgeCheckResult(first_hit=first_hit, collide=collide,
                           counters=counters)


def plan_with_collision_gate(planner: Planner, engine: CollisionEngine,
                             cloud, q0, goal, num_steps: int = 40,
                             sampling: str = "random",
                             generator: Optional[torch.Generator] = None
                             ) -> PipelineResult:
    """One planning episode: encode -> rollout -> explicit collision gate.

    ``cloud (N, 3)``, ``q0 (7,)`` and ``goal (7,)`` go to the planner's
    device; ``generator`` feeds random sampling.  Timings: ``encode_s``,
    ``rollout_s``, their sum ``plan_s`` and ``collision_s``; ``counters``
    come from the collision gate only.
    """
    dev = next(planner.parameters()).device
    cloud, q0, goal = (torch.as_tensor(x, dtype=torch.float32).to(dev)
                       for x in (cloud, q0, goal))
    with torch.inference_mode():
        t0 = time.perf_counter()
        feat = planner.encode_cloud(cloud[None], sampling, generator)
        _sync(dev)
        t_encode = time.perf_counter() - t0

        t0 = time.perf_counter()
        traj = planner.policy_rollout(feat, q0[None], goal[None], num_steps)
        _sync(dev)
        t_rollout = time.perf_counter() - t0

        t0 = time.perf_counter()
        flags, counters = check_trajectory(engine, traj[0])
        _sync(engine.device)
        t_collision = time.perf_counter() - t0
    flags = np.asarray(flags)
    return PipelineResult(
        trajectory=traj[0].cpu().numpy(),
        collision_free=not bool(flags.any()), colliding_waypoints=flags,
        timings={"encode_s": t_encode, "rollout_s": t_rollout,
                 "plan_s": t_encode + t_rollout, "collision_s": t_collision},
        counters=counters)
