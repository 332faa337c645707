"""Check inputs for the ball-query kernel.

:func:`cloud_cases` gives sparse, dense, ragged and long clouds and the
edges of the kernel's design (clouds over one staged tile, clouds shorter
than a trip, query counts that are no multiple of a query block, a block
that stops after its first tile, a cloud in which no ball fills);
:func:`radius_shell` puts points exactly on, and one ulp around, a ball's
radius.  Shared by the CPU tests and the card checks (``chip_smoke.py``,
``tests/test_torch_kernels_gpu.py``).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

#: Points a staged tile of the kernel (``kTile`` in ``csrc/ballquery.cu``).
TILE = 2048

Case = Tuple[str, np.ndarray, np.ndarray, float, int]


def cloud_cases(seed: int = 0) -> List[Case]:
    """``(name, queries (B, M, 3), points (B, N, 3), radius, k)``, float32,
    drawn from ``seed``.  Queries are points of their cloud (so every ball
    holds its centre) unless the name says otherwise."""
    rs = np.random.RandomState(seed)

    def cloud(B, N, half):
        return rs.uniform(-half, half, (B, N, 3)).astype(np.float32)

    def case(name, B, M, N, half, r, k):
        pts = cloud(B, N, half)
        return (name, np.ascontiguousarray(pts[:, :M]), pts, r, k)

    cases = [
        case("sparse (sa1, most balls short)", 4, 256, 2048, 0.5, 0.1, 16),
        case("dense (sa1, saturated)", 4, 256, 2048, 0.1, 0.1, 16),
        case("ragged", 3, 255, 2047, 1.0, 0.2, 16),
        case("N=1", 2, 1, 1, 1.0, 0.6, 8),
        case("N=31", 2, 31, 31, 1.0, 0.6, 8),
        case("N=33", 2, 33, 33, 1.0, 0.6, 8),
        case("M=67, no multiple of a block", 5, 67, 300, 1.0, 0.4, 16),
        case("B=1 M=997, no multiple of a block", 1, 997, 1000, 1.0, 0.2,
             16),
    ]
    # balls that fill in the second or third tile, or walk all eight
    for N, r in ((TILE + 1, 0.3), (5000, 0.3), (8 * TILE, 0.15)):
        cases.append(case(f"long N={N}", 2, 64, N, 1.0, r, 32))
    # every ball fills from the first tile, which the block's vote sees
    pts = cloud(2, 5000, 1.0)
    pts[:, :TILE] = cloud(2, TILE, 0.05)
    qs = cloud(2, 64, 0.02)
    cases.append(("every ball full in the first tile (queries off the "
                  "cloud)", qs, pts, 0.1, 16))
    # the balls hold their centre and hardly anything else: every block
    # walks every tile
    cases.append(case("no ball fills", 2, 64, 5000, 1.0, 0.02, 16))
    return cases


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
