"""Synthetic reconstructions of the MpiNet evaluation environments.

Counterpart of ``repro.data.robotics``: the four environment families of
Table III (Cubby, Dresser, Merged Cubby, Tabletop) as box-obstacle scenes
with 524 288 surface points, robot-arm trajectories whose link OBB counts
land in the paper's range, and the small MPAccel-style scenes of Fig. 14.
Scene sampling is the reference's numpy code unchanged.  Note that the
scene seed mixes in ``hash(name) % 1000``, and Python salts string hashes
per process: the same name gives the same scene in both packages within
one process, but a different scene in another process (unless
``PYTHONHASHSEED`` is fixed).
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from repro_torch.core.geometry import OBBs, trajectory_obbs

ENVIRONMENTS = ("cubby", "dresser", "merged_cubby", "tabletop")

#: Panda-like joint limits used for every sampled configuration.
PANDA_JOINT_LO = np.asarray([-2.8, -1.7, -2.8, -3.0, -2.8, 0.0, -2.8],
                            np.float32)
PANDA_JOINT_HI = np.asarray([2.8, 1.7, 2.8, -0.1, 2.8, 3.7, 2.8],
                            np.float32)


@dataclasses.dataclass(frozen=True)
class Scene:
    name: str
    points: np.ndarray          # (P, 3) surface point cloud
    boxes_lo: np.ndarray        # (B, 3) ground-truth obstacle AABBs
    boxes_hi: np.ndarray        # (B, 3)
    robot_base: np.ndarray      # (3,)


def _sample_box_surfaces(rs: np.random.RandomState, lo: np.ndarray,
                         hi: np.ndarray, n: int) -> np.ndarray:
    """Sample n points uniformly (area-weighted) on the faces of B boxes."""
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    size = hi - lo
    areas = 2 * (size[:, 0] * size[:, 1] + size[:, 1] * size[:, 2]
                 + size[:, 0] * size[:, 2])
    pbox = areas / areas.sum()
    box = rs.choice(len(lo), size=n, p=pbox)
    u = rs.uniform(size=(n, 3)).astype(np.float32)
    pts = lo[box] + u * size[box]
    s = size[box]
    face_area = np.stack([s[:, 1] * s[:, 2], s[:, 0] * s[:, 2],
                          s[:, 0] * s[:, 1]], -1)
    face_area = face_area / face_area.sum(-1, keepdims=True)
    axis = np.array([rs.choice(3, p=fa) for fa in face_area]) if n < 20000 \
        else _vector_choice(rs, face_area)
    side = rs.randint(0, 2, n)
    rows = np.arange(n)
    pts[rows, axis] = np.where(side == 1, hi[box, :][rows, axis],
                               lo[box, :][rows, axis])
    return pts


def _vector_choice(rs: np.random.RandomState, probs: np.ndarray) -> np.ndarray:
    """Vectorized categorical sampling over rows of probs (n, k)."""
    c = np.cumsum(probs, -1)
    u = rs.uniform(size=(len(probs), 1)).astype(np.float32)
    return (u > c[:, :-1]).sum(-1)


def _cubby_boxes(rs, origin=(0.45, -0.5, 0.0), n_rows=3, n_cols=3,
                 cw=0.32, ch=0.30, depth=0.35, t=0.02):
    """Shelf with n_rows x n_cols open compartments."""
    ox, oy, oz = origin
    W = n_cols * cw + (n_cols + 1) * t
    H = n_rows * ch + (n_rows + 1) * t
    los, his = [], []
    los.append([ox + depth, oy, oz])
    his.append([ox + depth + t, oy + W, oz + H])
    for r in range(n_rows + 1):
        z = oz + r * (ch + t)
        los.append([ox, oy, z])
        his.append([ox + depth, oy + W, z + t])
    for c_ in range(n_cols + 1):
        y = oy + c_ * (cw + t)
        los.append([ox, y, oz])
        his.append([ox + depth, y + t, oz + H])
    return np.asarray(los, np.float32), np.asarray(his, np.float32)


def _dresser_boxes(rs, origin=(0.5, -0.45, 0.0), w=0.9, d=0.4, h=0.85,
                   n_drawers=4, t=0.02):
    ox, oy, oz = origin
    los, his = [], []
    los.append([ox + d, oy, oz])
    his.append([ox + d + t, oy + w, oz + h])
    los.append([ox, oy, oz])
    his.append([ox + d, oy + t, oz + h])
    los.append([ox, oy + w - t, oz])
    his.append([ox + d, oy + w, oz + h])
    los.append([ox, oy, oz + h - t])
    his.append([ox + d, oy + w, oz + h])
    los.append([ox, oy, oz])
    his.append([ox + d, oy + w, oz + t])
    for k in range(1, n_drawers):
        z = oz + k * h / n_drawers
        pull = 0.05 + 0.1 * rs.uniform()   # partially open drawer fronts
        los.append([ox - pull, oy + t, z - t])
        his.append([ox, oy + w - t, z + t])
    return np.asarray(los, np.float32), np.asarray(his, np.float32)


def _tabletop_boxes(rs, n_objects=9):
    los = [[0.30, -0.55, 0.30]]
    his = [[0.95, 0.55, 0.34]]                      # table slab
    for _ in range(n_objects):
        sx, sy, sz = rs.uniform(0.04, 0.22, 3)
        x = rs.uniform(0.32, 0.9 - sx)
        y = rs.uniform(-0.5, 0.5 - sy)
        los.append([x, y, 0.34])
        his.append([x + sx, y + sy, 0.34 + sz])
    return np.asarray(los, np.float32), np.asarray(his, np.float32)


def make_scene(name: str, seed: int = 0, num_points: int = 524288) -> Scene:
    rs = np.random.RandomState(seed + hash(name) % 1000)
    if name == "cubby":
        lo, hi = _cubby_boxes(rs)
    elif name == "dresser":
        lo, hi = _dresser_boxes(rs)
    elif name == "merged_cubby":
        lo1, hi1 = _cubby_boxes(rs)
        lo2, hi2 = _cubby_boxes(rs, origin=(0.45, 0.55, 0.0))
        lo, hi = np.concatenate([lo1, lo2]), np.concatenate([hi1, hi2])
    elif name == "tabletop":
        lo, hi = _tabletop_boxes(rs)
    else:
        raise ValueError(name)
    pts = _sample_box_surfaces(rs, lo, hi, num_points)
    return Scene(name=name, points=pts, boxes_lo=lo, boxes_hi=hi,
                 robot_base=np.asarray([0.0, 0.0, 0.0], np.float32))


def scene_trajectories(scene: Scene, num_trajectories: int = 25,
                       waypoints: int = 60, seed: int = 0) -> OBBs:
    """Random joint-space trajectories -> link OBBs on the CPU (paper
    Table III scale: num_trajectories * waypoints * 7 links OBBs)."""
    rs = np.random.RandomState(seed)
    lo, hi = PANDA_JOINT_LO, PANDA_JOINT_HI
    all_obbs: List[OBBs] = []
    for _ in range(num_trajectories):
        q0 = rs.uniform(lo, hi).astype(np.float32)
        q1 = rs.uniform(lo, hi).astype(np.float32)
        all_obbs.append(trajectory_obbs(torch.from_numpy(q0),
                                        torch.from_numpy(q1), waypoints,
                                        base_pos=scene.robot_base))
    return OBBs(center=torch.cat([o.center for o in all_obbs]),
                half=torch.cat([o.half for o in all_obbs]),
                rot=torch.cat([o.rot for o in all_obbs]))


def make_mpaccel_scenario(idx: int, num_points: int = 65536) -> Scene:
    """Small sparse scenes in the style of MPAccel (paper Fig. 14): 3 to 6
    random boxes from ``RandomState(1000 + idx)``."""
    rs = np.random.RandomState(1000 + idx)
    n_obs = rs.randint(3, 7)
    los, his = [], []
    for _ in range(n_obs):
        s = rs.uniform(0.05, 0.25, 3)
        c = rs.uniform(-0.7, 0.7, 3) + np.array([0.6, 0.0, 0.4])
        los.append(c - s / 2)
        his.append(c + s / 2)
    lo = np.asarray(los, np.float32)
    hi = np.asarray(his, np.float32)
    pts = _sample_box_surfaces(rs, lo, hi, num_points)
    return Scene(name=f"mpaccel_{idx}", points=pts, boxes_lo=lo, boxes_hi=hi,
                 robot_base=np.asarray([0.0, 0.0, 0.0], np.float32))
