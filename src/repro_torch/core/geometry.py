"""Geometry primitives for the collision engine (PyTorch).

Struct-of-arrays layouts, as in ``repro.core.geometry``: a batch of OBBs is
(centers (M,3), half_extents (M,3), rot (M,3,3)); a batch of AABBs is
(centers (N,3), half_extents (N,3)).  ``rot[m]`` columns are the OBB's local
axes in world coordinates, so ``world = rot @ local + center``.

Also the 7-DOF serial arm (Franka-like DH chain) whose links carry fixed
local OBBs, used to turn joint-space trajectories into the OBB sets the
paper collision-checks (Table III).  Forward kinematics is a float formula
on the host side of the kernels; its last bits may differ from the JAX
reference (another library's sin/cos and matmul order), which is why the
parity tests feed both engines the same OBB arrays.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class OBBs:
    """Batch of oriented bounding boxes (SoA tensors)."""

    center: torch.Tensor  # (M, 3)
    half: torch.Tensor    # (M, 3)
    rot: torch.Tensor     # (M, 3, 3), columns = local axes in world frame

    @property
    def n(self) -> int:
        return self.center.shape[0]


@dataclasses.dataclass(frozen=True)
class AABBs:
    """Batch of axis-aligned bounding boxes (SoA tensors)."""

    center: torch.Tensor  # (N, 3)
    half: torch.Tensor    # (N, 3)

    @property
    def n(self) -> int:
        return self.center.shape[0]


def rotation_from_euler(rpy: torch.Tensor) -> torch.Tensor:
    """Rotation matrices from (…, 3) roll/pitch/yaw angles -> (…, 3, 3)."""
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    row0 = torch.stack([cy * cp, cy * sp * sr - sy * cr,
                        cy * sp * cr + sy * sr], -1)
    row1 = torch.stack([sy * cp, sy * sp * sr + cy * cr,
                        sy * sp * cr - cy * sr], -1)
    row2 = torch.stack([-sp, cp * sr, cp * cr], -1)
    return torch.stack([row0, row1, row2], -2)


def point_aabb_sq_distance(points: torch.Tensor, aabb_center: torch.Tensor,
                           aabb_half: torch.Tensor) -> torch.Tensor:
    """Squared distance from points (..., 3) to AABBs (..., 3) / (..., 3),
    broadcast; 0 inside the box.  Summed ``(d0*d0 + d1*d1) + d2*d2``, the
    reference's order, so that the card and the CPU agree bit for bit."""
    d = torch.clamp((points - aabb_center).abs() - aabb_half, min=0.0)
    sq = d * d
    return (sq[..., 0] + sq[..., 1]) + sq[..., 2]


# Modified DH parameters (a, d, alpha) per joint; 7 revolute joints.
_PANDA_DH = np.array(
    [
        [0.0000, 0.3330, 0.0],
        [0.0000, 0.0000, -np.pi / 2],
        [0.0000, 0.3160, np.pi / 2],
        [0.0825, 0.0000, np.pi / 2],
        [-0.0825, 0.3840, -np.pi / 2],
        [0.0000, 0.0000, np.pi / 2],
        [0.0880, 0.0000, np.pi / 2],
    ],
    dtype=np.float32,
)

# Per-link local OBB half-extents (rough Panda link volumes, metres).
_PANDA_LINK_HALF = np.array(
    [
        [0.060, 0.060, 0.170],
        [0.060, 0.090, 0.060],
        [0.060, 0.060, 0.160],
        [0.060, 0.085, 0.060],
        [0.055, 0.055, 0.195],
        [0.060, 0.080, 0.055],
        [0.050, 0.050, 0.080],
    ],
    dtype=np.float32,
)

# Local OBB centre offset (in the link frame) so boxes sit mid-link.
_PANDA_LINK_OFF = np.array(
    [
        [0.0, 0.0, -0.170],
        [0.0, 0.0, 0.0],
        [0.0, 0.0, -0.160],
        [0.0825, 0.0, 0.0],
        [-0.0825, 0.0, -0.190],
        [0.0, 0.0, 0.0],
        [0.088, 0.0, 0.080],
    ],
    dtype=np.float32,
)

NUM_LINKS = 7


def _dh_transform(theta: torch.Tensor, a, d, alpha) -> torch.Tensor:
    """Modified-DH 4x4 transform for one joint; theta (...,) -> (...,4,4)."""
    ct, st = torch.cos(theta), torch.sin(theta)
    alpha = torch.as_tensor(alpha, dtype=theta.dtype, device=theta.device)
    ca, sa = torch.cos(alpha), torch.sin(alpha)
    zeros = torch.zeros_like(ct)
    ones = torch.ones_like(ct)
    rows = [
        torch.stack([ct, -st, zeros, a * ones], -1),
        torch.stack([st * ca, ct * ca, -sa * ones, -d * sa * ones], -1),
        torch.stack([st * sa, ct * sa, ca * ones, d * ca * ones], -1),
        torch.stack([zeros, zeros, zeros, ones], -1),
    ]
    return torch.stack(rows, -2)


def arm_link_obbs(joint_angles, base_pos=None) -> OBBs:
    """Forward kinematics: joint angles (..., 7) -> per-link world OBBs.

    Returns OBBs with leading dims flattened: (prod(...)*7,) boxes, on the
    device of ``joint_angles``.
    """
    q = torch.as_tensor(joint_angles, dtype=torch.float32)
    dev = q.device
    q = q.reshape(-1, NUM_LINKS)
    B = q.shape[0]
    dh = torch.as_tensor(_PANDA_DH, device=dev)
    base = torch.eye(4, dtype=torch.float32, device=dev)
    if base_pos is not None:
        base[:3, 3] = torch.as_tensor(base_pos, dtype=torch.float32,
                                      device=dev)
    T = base.expand(B, 4, 4)
    link_off = torch.as_tensor(_PANDA_LINK_OFF, device=dev)
    centers, rots = [], []
    for j in range(NUM_LINKS):
        Tj = _dh_transform(q[:, j], dh[j, 0], dh[j, 1], dh[j, 2])
        T = torch.einsum("bij,bjk->bik", T, Tj)
        R = T[:, :3, :3]
        centers.append(T[:, :3, 3] + torch.einsum("bij,j->bi", R,
                                                  link_off[j]))
        rots.append(R)
    center = torch.stack(centers, 1).reshape(-1, 3)
    rot = torch.stack(rots, 1).reshape(-1, 3, 3)
    half = torch.as_tensor(_PANDA_LINK_HALF, device=dev).repeat(B, 1)
    return OBBs(center=center.contiguous(), half=half.contiguous(),
                rot=rot.contiguous())


def trajectory_obbs(start, goal, num_waypoints: int, base_pos=None) -> OBBs:
    """Discretize a straight joint-space path into waypoints and emit OBBs."""
    start = torch.as_tensor(start, dtype=torch.float32)
    goal = torch.as_tensor(goal, dtype=torch.float32, device=start.device)
    t = torch.linspace(0.0, 1.0, num_waypoints, dtype=torch.float32,
                       device=start.device)[:, None]
    qs = (1.0 - t) * start[None, :] + t * goal[None, :]
    return arm_link_obbs(qs, base_pos=base_pos)


def _uniform(generator: torch.Generator, shape, lo: float, hi: float,
             device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=generator.device)
    return (lo + (hi - lo) * u).to(device)


def random_obbs(generator: torch.Generator, n: int, scene_lo: float = -1.0,
                scene_hi: float = 1.0, min_half: float = 0.02,
                max_half: float = 0.25, device="cpu") -> OBBs:
    """Random OBBs for testing, drawn from ``generator``."""
    center = _uniform(generator, (n, 3), scene_lo, scene_hi, device)
    half = _uniform(generator, (n, 3), min_half, max_half, device)
    rot = rotation_from_euler(_uniform(generator, (n, 3), -math.pi, math.pi,
                                       device))
    return OBBs(center=center, half=half, rot=rot)


def random_aabbs(generator: torch.Generator, n: int, scene_lo: float = -1.0,
                 scene_hi: float = 1.0, min_half: float = 0.02,
                 max_half: float = 0.25, device="cpu") -> AABBs:
    """Random AABBs for testing, drawn from ``generator``."""
    center = _uniform(generator, (n, 3), scene_lo, scene_hi, device)
    half = _uniform(generator, (n, 3), min_half, max_half, device)
    return AABBs(center=center, half=half)


def obb_corners(obbs: OBBs) -> torch.Tensor:
    """All 8 world-space corners of each OBB -> (M, 8, 3)."""
    signs = torch.tensor(
        [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
        dtype=torch.float32, device=obbs.center.device)
    local = signs[None, :, :] * obbs.half[:, None, :]
    return obbs.center[:, None, :] + torch.einsum("mij,mkj->mki", obbs.rot,
                                                  local)
