"""MpiNet-lite: neural motion planner = PointNet++ encoder + MLP policy.

Counterpart of ``repro.models.planner``: serving (``planner_apply``,
``encode_cloud``, ``rollout``) and training (:func:`planner_loss`, which
behaviour-clones an expert; the trainer is
:mod:`repro_torch.launch.train_planner`).  The policy predicts the next
joint-space delta from (cloud feature, current configuration, goal), is
rolled out autoregressively, and is always validated by the explicit
collision gate (:mod:`repro_torch.core.pipeline`): the paper's safety
argument (section II-B).  Where the reference passes a parameter tree,
the port passes the :class:`Planner` module.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.core.geometry import NUM_LINKS
from repro_torch.models.common import dense_linear
from repro_torch.models.pointnet import PointNetEncoder

#: Distance to the goal below which a step snaps onto it.
SNAP_DIST = 0.4


class Planner(nn.Module):
    """PointNet++ encoder and a three-layer MLP policy.

    Weights are drawn from ``generator`` (one seeded 0 when None) on the
    CPU, so every device holds the same planner, then moved to ``device``
    (the card unless the caller asks for the CPU).  ``widen`` scales the
    MLP, as the reference's ``init_planner``.
    """

    def __init__(self, feat_dim: int = 256, hidden: int = 512,
                 widen: int = 1, generator: Optional[torch.Generator] = None,
                 device=DEFAULT_DEVICE):
        super().__init__()
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        h = hidden * widen
        d_in = feat_dim + 2 * NUM_LINKS
        self.pointnet = PointNetEncoder(feat_dim, generator)
        self.fc1 = dense_linear(d_in, h, generator)
        self.fc2 = dense_linear(h, h, generator)
        self.fc3 = dense_linear(h, h, generator)
        self.out = dense_linear(h, NUM_LINKS, generator, scale=0.1)
        self.to(dev)

    def forward(self, cloud_feat: torch.Tensor, q: torch.Tensor,
                goal: torch.Tensor) -> torch.Tensor:
        """``planner_apply``: (B, F), (B, 7), (B, 7) -> delta-q (B, 7)."""
        x = torch.cat([cloud_feat, q, goal], -1)
        for layer in (self.fc1, self.fc2, self.fc3):
            x = torch.relu(layer(x))
        return torch.tanh(self.out(x)) * 0.4

    def encode_cloud(self, cloud: torch.Tensor, sampling: str = "fps",
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
        """(B, N, 3) clouds -> (B, F) features."""
        return self.pointnet(cloud, sampling, generator)

    def policy_rollout(self, cloud_feat: torch.Tensor, q0: torch.Tensor,
                       goal: torch.Tensor, num_steps: int) -> torch.Tensor:
        """The policy loop of :meth:`rollout` on encoded clouds: waypoints
        (B, num_steps + 1, 7), snapping onto the goal within
        :data:`SNAP_DIST`."""
        q, traj = q0, [q0]
        for _ in range(num_steps):
            dq = self(cloud_feat, q, goal)
            dist = torch.linalg.vector_norm(goal - q, dim=-1, keepdim=True)
            dq = torch.where(dist < SNAP_DIST, goal - q, dq)
            q = q + dq
            traj.append(q)
        return torch.stack(traj, 1)

    def rollout(self, cloud: torch.Tensor, q0: torch.Tensor,
                goal: torch.Tensor, num_steps: int, sampling: str = "fps",
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Autoregressive plan: waypoints (B, num_steps + 1, 7).  The cloud
        is encoded once per plan (static scene, as in MpiNet)."""
        feat = self.encode_cloud(cloud, sampling, generator)
        return self.policy_rollout(feat, q0, goal, num_steps)


def planner_loss(planner: Planner, batch: Dict, sampling: str = "fps",
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, Dict]:
    """Behaviour cloning: the mean square error between the policy's delta
    on (cloud feature, q, goal) and ``batch["expert_delta"]``; ``batch``
    holds ``cloud`` (B, N, 3), ``q``, ``goal``, ``expert_delta`` (B, 7) on
    the planner's device.  Returns ``(mse, {"mse": mse})``.  The FPS and
    ball-query kernels give indices only; the gradient flows through the
    encoder's gathers, MLPs and max-pools."""
    feat = planner.encode_cloud(batch["cloud"], sampling, generator)
    pred = planner(feat, batch["q"], batch["goal"])
    mse = (pred - batch["expert_delta"]).square().mean()
    return mse, {"mse": mse}
