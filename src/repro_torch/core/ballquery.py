"""Fixed-radius neighbour search (PointNet++ "ball query"), plain version.

Counterpart of ``repro.core.ballquery.ball_query_ref``.  The serving path
calls :func:`repro_torch.kernels.ballquery.ops.ball_query`, which runs the
CUDA kernel ``kernels/ballquery/csrc/ballquery.cu`` on CUDA tensors and
this function on CPU tensors.  The octree workloads of the reference
module (``ball_query_psphere``, ``ball_query_pray``) are not ported yet
(ROADMAP A.7.5).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.fps import sq_dist


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
