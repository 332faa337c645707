"""Inputs that put points exactly on, and one ulp around, a ball's radius.

Shared by the CPU tests and the card checks (``chip_smoke.py``,
``tests/test_torch_kernels_gpu.py``).
"""
from __future__ import annotations

import numpy as np


def radius_shell(radius: float, ulps: int = 4) -> np.ndarray:
    """Points on the six axis directions from the origin at every float32
    within ``ulps`` of ``float32(radius)``: with a query at the origin,
    their squared distances straddle the threshold ``float32(radius *
    radius)`` -- and, for r = 0.1, 0.2, 0.4 ..., include ``float32(r) **
    2``, which lies above it."""
    x = np.float32(radius)
    xs, lo, hi = [x], x, x
    for _ in range(ulps):
        lo = np.nextafter(lo, np.float32(0))
        hi = np.nextafter(hi, np.float32(np.inf))
        xs += [lo, hi]
    pts = np.zeros((len(xs) * 6, 3), np.float32)
    for i, v in enumerate(xs):
        for axis in range(3):
            pts[6 * i + 2 * axis, axis] = v
            pts[6 * i + 2 * axis + 1, axis] = -v
    return pts
