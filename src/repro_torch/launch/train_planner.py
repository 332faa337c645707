"""Train the MpiNet-lite neural planner and evaluate it with the explicit
collision gate (the paper's full pipeline), on the card.

Twin of the reference's ``examples/train_planner.py``, with its numbers:

    python3 -m repro_torch.launch.train_planner --device cuda   # 60 steps
    python3 -m repro_torch.launch.train_planner --full          # 54 M params

Stages:
  1. Build the cubby scene (65,536 points) and its depth-6 octree on a
     ``wavefront_fused`` engine.
  2. Generate expert trajectories (goal-seeking with collision-aware
     rejection, each step gated by the engine) and behaviour-clone the
     planner on (cloud, q, goal) -> dq with AdamW.
  3. Evaluate 8 rollouts; every plan passes through the collision gate.

Every draw comes from one ``np.random.RandomState(0)`` in the example's
order (the episodes, the cloud, each step's batch indices, the evaluation
poses), so with the same gate verdicts and ``sampling="fps"`` the port sees
the reference's data.  Random sampling draws from a CPU
``torch.Generator`` seeded as the example seeds its keys (1000 + step, and
the episode); it cannot reproduce ``jax.random``'s stream.  Training runs
in grad mode, the gated evaluation under ``inference_mode``.
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.core.octree import build_octree
from repro_torch.core.pipeline import (check_trajectory,
                                       plan_with_collision_gate)
from repro_torch.data.robotics import make_scene
from repro_torch.engine.executor import CollisionEngine, EngineConfig
from repro_torch.models.planner import Planner, planner_loss
from repro_torch.train.optimizer import OptConfig, adamw_update, init_opt_state

#: The example's joint box for the expert's starts and goals.
EXPERT_LO = np.asarray([-2.8, -1.7, -2.8, -3.0, -2.8, 0.0, -2.8], np.float32)
EXPERT_HI = np.asarray([2.8, 1.7, 2.8, -0.1, 2.8, 3.7, 2.8], np.float32)
BATCH = 32
CLOUD_POINTS = 1024
EPISODE_STEPS = 20
EVAL_EPISODES = 8
EVAL_STEPS = 20


def make_expert_data(engine: CollisionEngine, scene, n_episodes: int,
                     steps: int, rs: np.random.RandomState
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Greedy goal-seeking expert with collision-aware step rejection: each
    candidate step is gated on ``engine`` (forward kinematics on its
    device); a colliding one is replaced by a random detour step.  Returns
    ``(qs, goals, deltas)``, each (n_episodes * steps, 7) float32."""
    qs, goals, deltas = [], [], []
    for _ in range(n_episodes):
        q = rs.uniform(EXPERT_LO, EXPERT_HI).astype(np.float32)
        goal = rs.uniform(EXPERT_LO, EXPERT_HI).astype(np.float32)
        for _ in range(steps):
            step_v = np.clip(goal - q, -0.4, 0.4)
            cand = q + step_v
            flags, _ = check_trajectory(
                engine, torch.from_numpy(cand[None]).to(engine.device))
            if bool(np.asarray(flags)[0]):
                # collision: deflect with a random detour step
                step_v = rs.uniform(-0.3, 0.3, 7).astype(np.float32)
                cand = q + step_v
            qs.append(q.copy())
            goals.append(goal.copy())
            deltas.append(step_v.astype(np.float32))
            q = cand
    return np.stack(qs), np.stack(goals), np.stack(deltas)


@dataclasses.dataclass
class Setup:
    """The scene, its engine, the expert data and the cloud, as the
    example builds them, and the ``RandomState`` it continues with."""
    scene: object
    engine: CollisionEngine
    qs: np.ndarray
    goals: np.ndarray
    deltas: np.ndarray
    cloud: np.ndarray
    rs: np.random.RandomState


def setup(full: bool = False, device=DEFAULT_DEVICE,
          num_points: int = 65536, depth: int = 6,
          episodes: Optional[int] = None) -> Setup:
    """Stages 1 and 2's data: ``make_scene("cubby", num_points)``, the
    depth-``depth`` octree on a ``wavefront_fused`` engine on ``device``,
    the expert's 6 (``full``: 24) episodes of 20 steps and a
    ``CLOUD_POINTS``-point cloud, all from ``RandomState(0)``."""
    dev = resolve_device(device)
    rs = np.random.RandomState(0)
    scene = make_scene("cubby", num_points=num_points)
    tree = build_octree(scene.points, depth=depth)
    engine = CollisionEngine(tree, EngineConfig(mode="wavefront_fused"),
                             device=dev)
    n_eps = episodes or (24 if full else 6)
    qs, goals, deltas = make_expert_data(engine, scene, n_eps,
                                         EPISODE_STEPS, rs)
    cloud = scene.points[rs.choice(len(scene.points), CLOUD_POINTS,
                                   replace=False)]
    return Setup(scene, engine, qs, goals, deltas,
                 np.asarray(cloud, np.float32), rs)


def batch_at(data: Setup, idx: np.ndarray, device) -> Dict[str, torch.Tensor]:
    """The batch of expert tuples ``idx`` on ``device``, each with the
    cloud."""
    dev = torch.device(device)
    cloud = torch.from_numpy(data.cloud).to(dev)
    B = len(idx)
    return {"cloud": cloud[None].expand(B, -1, -1).contiguous(),
            "q": torch.from_numpy(data.qs[idx]).to(dev),
            "goal": torch.from_numpy(data.goals[idx]).to(dev),
            "expert_delta": torch.from_numpy(data.deltas[idx]).to(dev)}


def loss_and_grads(planner: Planner, batch: Dict, sampling: str,
                   generator: Optional[torch.Generator]
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The behaviour-cloning loss and its gradient to every parameter."""
    params = dict(planner.named_parameters())
    with torch.enable_grad():
        loss, _ = planner_loss(planner, batch, sampling, generator)
        grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train(planner: Planner, data: Setup, train_steps: int,
          sampling: str = "random", batch: int = BATCH,
          log: Optional[Callable[[str], None]] = print
          ) -> Tuple[List[float], List[float]]:
    """Behaviour-clone ``planner`` for ``train_steps`` AdamW steps on
    batches of ``batch`` tuples drawn from ``data.rs``; returns each step's
    loss and wall (ending in a sync on the card)."""
    dev = next(planner.parameters()).device
    cfg = OptConfig(lr=3e-4, warmup_steps=10, total_steps=train_steps,
                    weight_decay=0.01)
    params = dict(planner.named_parameters())
    state = init_opt_state(params, cfg)
    n = len(data.qs)
    losses, walls = [], []
    t_start = time.perf_counter()
    for step in range(train_steps):
        idx = data.rs.randint(0, n, batch)
        t0 = time.perf_counter()
        b = batch_at(data, idx, dev)
        loss, grads = loss_and_grads(
            planner, b, sampling, torch.Generator().manual_seed(1000 + step))
        adamw_update(params, grads, state, cfg)
        _sync(dev)
        walls.append(time.perf_counter() - t0)
        losses.append(float(loss))
        if log and step % max(train_steps // 10, 1) == 0:
            log(f"step {step:4d}  bc-loss {losses[-1]:.4f}  "
                f"({time.perf_counter() - t_start:.0f}s)")
    return losses, walls


def evaluate(planner: Planner, data: Setup, sampling: str = "random",
             episodes: int = EVAL_EPISODES,
             log: Optional[Callable[[str], None]] = print) -> List[Dict]:
    """Stage 3: ``episodes`` gated plans from poses drawn from
    ``data.rs``; each entry holds the plan's poses, result, ``reached``
    and ``collision_free``."""
    out = []
    for ep in range(episodes):
        q0 = data.rs.uniform(-1.5, 1.5, 7).astype(np.float32)
        goal = data.rs.uniform(-1.5, 1.5, 7).astype(np.float32)
        res = plan_with_collision_gate(
            planner, data.engine, data.cloud, q0, goal,
            num_steps=EVAL_STEPS, sampling=sampling,
            generator=torch.Generator().manual_seed(ep))
        reached = float(np.linalg.norm(res.trajectory[-1] - goal)) < 0.5
        out.append(dict(q0=q0, goal=goal, result=res, reached=reached,
                        collision_free=res.collision_free))
        if log:
            log(f"  ep{ep}: reached={reached} "
                f"collision_free={res.collision_free} "
                f"plan={res.timings['plan_s'] * 1e3:.0f}ms "
                f"gate={res.timings['collision_s'] * 1e3:.0f}ms")
    return out


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--full", action="store_true",
                    help="~100M-param planner, more data/steps")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--sampling", default="random",
                    choices=["random", "fps"])
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    widen = 10 if args.full else 1           # 10x MLP ~ 100M params
    train_steps = args.steps or (300 if args.full else 60)
    print("building scene + octree, generating expert data ...")
    data = setup(args.full, dev)
    print(f"  {len(data.qs)} expert tuples")
    planner = Planner(widen=widen, generator=torch.Generator().manual_seed(0),
                      device=dev)
    n_params = sum(p.numel() for p in planner.parameters())
    print(f"planner params: {n_params / 1e6:.1f}M")
    losses, walls = train(planner, data, train_steps, args.sampling)
    print("\nevaluating with the explicit collision gate ...")
    evals = evaluate(planner, data, args.sampling)
    ok = sum(e["collision_free"] and e["reached"] for e in evals)
    caught = sum(not e["collision_free"] for e in evals)
    print(f"\nsuccess(collision-free & reached)={ok}/{len(evals)}; "
          f"unsafe plans caught by the gate={caught}/{len(evals)}; "
          f"median step {1e3 * statistics.median(walls):.1f} ms")
    return dict(losses=losses, walls=walls, evals=evals, ok=ok,
                caught=caught, n_params=n_params)


if __name__ == "__main__":
    main()
