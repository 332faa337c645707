"""PointNet++ set-abstraction backbone (MpiNet's point-cloud encoder).

Counterpart of ``repro.models.pointnet``.  Sampling is FPS or random
selection (the paper's Fig. 9 trade-off) and grouping is ball query: the
two operations RoboGPU accelerates (section IV).  On CUDA tensors both
run as the port's kernels, :func:`repro_torch.kernels.fps.ops.fps` and
:func:`repro_torch.kernels.ballquery.ops.ball_query`, one launch per
layer for the whole batch of clouds (the reference's ``vmap`` over clouds
is the kernels' batch dimension); on CPU tensors their plain versions
run.  The two per-neighbour MLP layers are plain ``nn.Linear`` products.

Masking follows the reference exactly: -1 neighbour slots are clamped to
0 before gathering (torch gathers do not clamp), set to ``-inf`` before
the max, and an empty ball pools to 0.  The pools are ``torch.amax``,
whose gradient splits evenly among tied maxima as ``jnp.max``'s does
(``Tensor.max(dim)`` would send it all to one): a point that a ball
holds twice ties with itself.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
from torch import nn

from repro_torch.core.fps import random_sampling
from repro_torch.kernels.ballquery.ops import ball_query
from repro_torch.kernels.fps.ops import fps
from repro_torch.models.common import dense_linear

SAMPLINGS = ("fps", "random")


@dataclasses.dataclass
class SAOutput:
    """One set-abstraction layer's sampling, grouping and features."""

    center_idx: torch.Tensor     # (B, M) int32 sampled point indices
    centers: torch.Tensor        # (B, M, 3)
    neighbor_idx: torch.Tensor   # (B, M, k) int32, -1 padded
    count: torch.Tensor          # (B, M) int32
    feats: torch.Tensor          # (B, M, C) pooled features


def sample_centers(xyz: torch.Tensor, n_centers: int, sampling: str,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
    """``(B, M)`` int32 centre indices for each cloud of ``xyz (B, N, 3)``.

    ``"random"`` draws each cloud's sample in turn from ``generator`` (a
    CPU generator; a fresh one seeded 0 when it is None).
    """
    if sampling == "fps":
        return fps(xyz, n_centers)
    if sampling != "random":
        raise ValueError(f"unknown sampling {sampling!r}; allowed: "
                         f"{', '.join(SAMPLINGS)}")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    B, N, _ = xyz.shape
    idx = torch.stack([random_sampling(generator, N, n_centers, device="cpu")
                       for _ in range(B)])
    return idx.to(xyz.device)


class SetAbstraction(nn.Module):
    """Sample centres, group their ball neighbourhoods, run a two-layer
    point MLP on (relative xyz, neighbour features) and max-pool."""

    def __init__(self, c_in: int, c_out: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.mlp1 = dense_linear(c_in + 3, c_out, generator)
        self.mlp2 = dense_linear(c_out, c_out, generator)

    def forward(self, xyz: torch.Tensor, feats: Optional[torch.Tensor],
                n_centers: int, radius: float, k: int,
                sampling: str = "fps",
                generator: Optional[torch.Generator] = None) -> SAOutput:
        """``xyz (B, N, 3)``, ``feats (B, N, C)`` or None -> one layer."""
        B = xyz.shape[0]
        cidx = sample_centers(xyz, n_centers, sampling, generator)
        rows = torch.arange(B, device=xyz.device)[:, None]
        centers = xyz[rows, cidx.to(torch.int64)]               # (B, M, 3)
        nidx, count = ball_query(centers, xyz, radius, k)       # (B, M, k)
        safe = nidx.clamp(min=0).to(torch.int64)
        rows = rows[:, :, None]
        g = xyz[rows, safe] - centers[:, :, None, :]            # (B, M, k, 3)
        if feats is not None:
            g = torch.cat([g, feats[rows, safe]], -1)
        h = torch.relu(self.mlp2(torch.relu(self.mlp1(g))))
        h = h.masked_fill((nidx < 0)[..., None], float("-inf"))
        pooled = torch.amax(h, dim=2)
        pooled = torch.where(torch.isfinite(pooled), pooled, 0.0)  # empty balls
        return SAOutput(center_idx=cidx, centers=centers, neighbor_idx=nidx,
                        count=count, feats=pooled)


class PointNetEncoder(nn.Module):
    """Three set-abstraction layers (64, 128, ``c_out`` channels) and a
    global max: ``(B, N, 3)`` cloud -> ``(B, c_out)`` feature."""

    def __init__(self, c_out: int = 256,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.sa1 = SetAbstraction(0, 64, generator)
        self.sa2 = SetAbstraction(64, 128, generator)
        self.sa3 = SetAbstraction(128, c_out, generator)

    def encode_layers(self, xyz: torch.Tensor, sampling: str = "fps",
                      generator: Optional[torch.Generator] = None,
                      n1: int = 256, n2: int = 64, n3: int = 16,
                      r1: float = 0.1, r2: float = 0.25, r3: float = 0.6
                      ) -> List[SAOutput]:
        """Every layer's output (the keywords of the reference's
        ``pointnet_encode``; k = 16, 16, 8)."""
        l1 = self.sa1(xyz, None, n1, r1, 16, sampling, generator)
        l2 = self.sa2(l1.centers, l1.feats, n2, r2, 16, sampling, generator)
        l3 = self.sa3(l2.centers, l2.feats, n3, r3, 8, sampling, generator)
        return [l1, l2, l3]

    def forward(self, xyz: torch.Tensor, sampling: str = "fps",
                generator: Optional[torch.Generator] = None,
                **radii_and_counts) -> torch.Tensor:
        """``(B, N, 3)`` -> ``(B, c_out)``; keywords as
        :meth:`encode_layers`."""
        layers = self.encode_layers(xyz, sampling, generator,
                                    **radii_and_counts)
        return torch.amax(layers[-1].feats, dim=1)
