"""Inputs that check the ray-march kernel and the MCL collision gate.

Shared by ``chip_smoke.py`` and the card tests: the kernel against its
plain version on rays of Fig. 19's shape, rays that graze cell edges and
corners along the axes and diagonals, rays that leave the grid, a grid
that is not square, a grid too large for the kernel's shared-memory copy,
one ray, a ray count no CTA size divides, rays whose first hit falls on
every step of a round and its neighbours, step counts that are no
multiple of a round, and the partly ended state a chunk leaves; and the
gate scene the reference leaves undefined (walls of the occupancy grid as
a 3-D point cloud).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.march.ref import march_ref

#: The seed ``repro.core.mcl.make_corridor_world`` draws from
#: ``jax.random.PRNGKey(0)``, the key of ``benchmarks/run.py::fig19_mcl``:
#: ``make_corridor_world(FIG19_GRID_SEED, size=192)`` is Fig. 19's grid.
FIG19_GRID_SEED = 31327077

#: Steps a check marches each ray case, beside every step of a whole cast:
#: one step, counts that are no multiple of the kernel's round (7, 33) and
#: the compacted cast's chunk (16).
STEP_COUNTS = (1, 7, 16, 33)

#: Steps of the chunk whose state (rays partly ended, ``dist`` past 0)
#: the checks also march on from: the compacted cast's chunk.
CHUNK_STEPS = 16

#: The side of a corridor grid too large for the kernel's shared-memory
#: copy (it stages grids of up to 48 KB): the kernel reads it through L1.
LARGE_GRID_SIZE = 600

#: Steps at which ``first_hit`` rays end: 0 to 63 (on a grid without
#: boxes in their way), every step of a round of up to 32 steps and the
#: first of the next.
FIRST_HIT_STEPS = 64

#: Axis and diagonal headings: a ray along a cell edge or through corners.
GRAZING_ANGLES = np.float32(np.pi) * np.asarray(
    [0.0, 0.5, -0.5, 1.0, 0.25, -0.25, 0.75, -0.75], np.float32)


def nonsquare_grid(seed: int = 0, H: int = 70, W: int = 130) -> np.ndarray:
    """An (H, W) grid of random boxes and no border walls: rays leave it."""
    rs = np.random.RandomState(seed)
    occ = np.zeros((H, W), bool)
    for _ in range(12):
        h, w = rs.randint(2, 10, 2)
        r, c = rs.randint(0, H - 2), rs.randint(0, W - 2)
        occ[r:r + h, c:c + w] = True
    return occ


def ray_cases(shape: Tuple[int, int], cell: float, seed: int = 0,
              particles: int = 192, angles: int = 24
              ) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """name -> (origins (R, 2), angles (R,)) float32 on a grid of ``shape``
    and ``cell`` at the origin: ``scan``, Fig. 19's particles x scan angles
    (192 x 24 = 4,608 rays) uniform over the interior; ``grazing``, origins
    on cell corners and edge midpoints under :data:`GRAZING_ANGLES`;
    ``leaving``, origins outside the grid and in its outermost cells,
    heading out; ``one``, a single scan ray; ``odd``, the first 997 scan
    rays, a count no CTA size divides; ``first_hit``, rays heading along
    +x from row ``H - k`` and along +y from column ``W - k`` (cell
    centres, three lanes each), for k = 1 .. :data:`FIRST_HIT_STEPS` + 1:
    each leaves the grid at step k - 1 (or meets a border wall a step
    earlier, or a box before), so first hits fall on every step of a
    round and on the next round's first."""
    H, W = shape
    c = np.float32(cell)
    rs = np.random.RandomState(seed)
    xy = rs.uniform(c, (np.asarray([H, W]) - 1) * c,
                    (particles, 2)).astype(np.float32)
    th = rs.uniform(-np.pi, np.pi, particles).astype(np.float32)
    scan = np.linspace(-np.pi, np.pi, angles, endpoint=False,
                       dtype=np.float32)
    out = {"scan": (np.repeat(xy, angles, axis=0),
                    (th[:, None] + scan[None, :]).reshape(-1))}
    i = rs.randint(1, H - 1, 48).astype(np.float32)
    j = rs.randint(1, W - 1, 48).astype(np.float32)
    half = np.float32(0.5)
    org = np.concatenate([np.stack([i * c, j * c], -1),             # corners
                          np.stack([i * c, (j + half) * c], -1),    # edges
                          np.stack([(i + half) * c, j * c], -1)])
    n = org.shape[0]
    out["grazing"] = (np.repeat(org, len(GRAZING_ANGLES), axis=0),
                      np.tile(GRAZING_ANGLES, n))
    lo, hi = np.float32(-2.5) * c, np.asarray([H, W], np.float32) * c
    edge = np.asarray([[lo, lo], [hi[0] - half * c, half * c],
                       [half * c, hi[1] - half * c], [hi[0] + c, hi[1] + c],
                       [hi[0] * half, lo], [lo, hi[1] * half]], np.float32)
    head = np.asarray([-2.4, -0.3, 1.7, 0.8, -1.6, 3.0], np.float32)
    out["leaving"] = (np.repeat(edge, 8, axis=0),
                      np.repeat(head, 8) + np.tile(
                          np.linspace(-0.3, 0.3, 8, dtype=np.float32), 6))
    sx, sa = out["scan"]
    out["one"] = (sx[:1], sa[:1])
    out["odd"] = (sx[:997], sa[:997])
    k = np.repeat(np.arange(1, min(FIRST_HIT_STEPS + 1, H - 1, W - 1) + 1),
                  3)
    lane = k * 7 + np.tile(np.arange(3) * 29, len(k) // 3)
    rows = np.stack([H - k + half, lane % (W - 2) + 1 + half], -1)
    cols = np.stack([lane % (H - 2) + 1 + half, W - k + half], -1)
    out["first_hit"] = (
        (np.concatenate([rows, cols]) * c).astype(np.float32),
        np.repeat(np.float32([0.0, np.pi / 2]), len(k)))
    return out


def start_states(occ: torch.Tensor, origin: Sequence[float], cell: float,
                 org: np.ndarray, dirv: torch.Tensor, max_range: float
                 ) -> Dict[str, Tuple[torch.Tensor, ...]]:
    """name -> (pos, dist, active) on ``dirv``'s device for rays from
    ``org`` along ``dirv``: ``fresh``, every ray at its origin and active;
    ``chunk``, the state :data:`CHUNK_STEPS` steps of the plain march
    leave (rays partly ended, ``dist`` past 0).  Copy before marching."""
    dev = dirv.device
    R = dirv.shape[0]
    fresh = (torch.from_numpy(np.asarray(org, np.float32)).to(dev),
             torch.zeros(R, device=dev),
             torch.ones(R, dtype=torch.bool, device=dev))
    chunk = tuple(x.clone() for x in fresh)
    march_ref(occ, origin, cell, chunk[0], dirv, chunk[1], chunk[2],
              max_range, CHUNK_STEPS)
    return {"fresh": fresh, "chunk": chunk}


def wall_points(occ: np.ndarray, cell: float, layers: int = 16,
                dz: float = 0.05) -> np.ndarray:
    """The centres of a grid's occupied cells (origin at 0), lifted to
    ``z = dz / 2 + dz * l`` for ``l < layers`` (walls ``layers * dz``
    tall): the MCL collision gate's 3-D scene, ``(N, 3)`` float32."""
    i, j = np.nonzero(np.asarray(occ, bool))
    xy = (np.stack([i, j], -1).astype(np.float32) + 0.5) * np.float32(cell)
    z = np.float32(dz) * (np.arange(layers, dtype=np.float32) + 0.5)
    pts = np.concatenate([np.concatenate(
        [xy, np.full((len(xy), 1), zl, np.float32)], -1) for zl in z])
    return pts.astype(np.float32)
