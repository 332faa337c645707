"""Inputs that stress the FPS kernel's tie-breaking.

Shared by the CPU tests and the card checks (``chip_smoke.py``,
``tests/test_torch_kernels_gpu.py``).
"""
from __future__ import annotations

import numpy as np


def tie_cloud(n_side: int = 4, n_total: int = 114, spacing: float = 0.25,
              seed: int = 7) -> np.ndarray:
    """An ``n_side``-cubed lattice of exact float32 coordinates, topped up
    to ``n_total`` points with duplicates of lattice points and shuffled:
    many squared distances are exactly equal, and once FPS has taken every
    distinct point all distances are 0, so each later pick is index 0."""
    g = np.arange(n_side, dtype=np.float32) * np.float32(spacing)
    lat = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    if n_total < len(lat):
        raise ValueError(f"n_total {n_total} below the {len(lat)} lattice "
                         "points")
    rs = np.random.RandomState(seed)
    dup = lat[rs.choice(len(lat), n_total - len(lat))]
    pts = np.concatenate([lat, dup])
    return pts[rs.permutation(len(pts))]
