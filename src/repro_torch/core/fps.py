"""Point sampling for PointNet++ set abstraction (PyTorch).

Counterpart of ``repro.core.fps``.  Furthest-point sampling (FPS) is
38.6 % of MpiNet inference in the paper's profile (Fig. 9); the paper's
counter-proposal is *random* sampling, at a small success-rate cost that
the explicit collision gate recovers.

:func:`farthest_point_sampling` is the plain version: the serving path
calls :func:`repro_torch.kernels.fps.ops.fps`, which runs the CUDA kernel
``kernels/fps/csrc/fps.cu`` on CUDA tensors and this function on CPU
tensors.  The squared distance is written out component by component,
``(dx*dx + dy*dy) + dz*dz``, the order of the reference kernel body (and
of the kernel, built with ``--fmad=false``), so the two agree bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.core.device import DEFAULT_DEVICE, resolve_device


def sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``|a - b|^2`` over the last axis (size 3), broadcast, summed in the
    kernels' order: ``(dx*dx + dy*dy) + dz*dz``."""
    d = a[..., 0] - b[..., 0]
    d2 = d * d
    for c in (1, 2):
        d = a[..., c] - b[..., c]
        d2 = d2 + d * d
    return d2


def farthest_point_sampling(points: torch.Tensor, m: int,
                            first: int = 0) -> torch.Tensor:
    """Iterative FPS: ``(m,)`` int32 indices into ``points (N, 3)``, or
    ``(B, m)`` for a batch ``(B, N, 3)``; index 0 is ``first``, each next
    one the point furthest from those chosen (first index on ties, as
    ``torch.argmax`` and ``jnp.argmax`` both keep)."""
    batched = points.ndim == 3
    pts = points if batched else points[None]
    B, N, _ = pts.shape
    if not 0 <= first < N or m < 1:
        raise ValueError(f"need 0 <= first < N = {N} and m >= 1, got "
                         f"first={first}, m={m}")
    rows = torch.arange(B, device=pts.device)
    dist = torch.full((B, N), float("inf"), dtype=pts.dtype,
                      device=pts.device)
    idx = torch.zeros((B, m), dtype=torch.int64, device=pts.device)
    idx[:, 0] = first
    for i in range(1, m):
        latest = pts[rows, idx[:, i - 1]]                    # (B, 3)
        dist = torch.minimum(dist, sq_dist(pts, latest[:, None, :]))
        idx[:, i] = torch.argmax(dist, dim=-1)
    idx = idx.to(torch.int32)
    return idx if batched else idx[0]


def random_sampling(generator: torch.Generator, n_points: int, m: int,
                    device=DEFAULT_DEVICE) -> torch.Tensor:
    """Uniform sampling without replacement: ``(m,)`` int32 indices.

    Drawn on ``generator``, which must be a CPU generator, and moved to
    ``device``: a CUDA generator gives another permutation from the same
    seed, and a card run must sample what its CPU twin samples.  The
    reference's ``jax.random.choice`` stream is not reproduced.
    """
    if generator.device.type != "cpu":
        raise ValueError("random_sampling draws on a CPU generator, got one "
                         f"on {generator.device}")
    if not 0 <= m <= n_points:
        raise ValueError(f"cannot draw {m} of {n_points} points")
    perm = torch.randperm(n_points, generator=generator)[:m]
    return perm.to(torch.int32).to(resolve_device(device))


def sampling_spread(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Quality metric: mean distance from every point to its nearest sample
    (lower = better coverage; FPS should beat random sampling)."""
    sel = points[idx.to(torch.int64)]                        # (m, 3)
    d2 = sq_dist(points[:, None, :], sel[None, :, :])
    return torch.sqrt(d2.min(dim=-1).values).mean()
