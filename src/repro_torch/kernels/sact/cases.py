"""Check inputs for the SACT kernels: random planes with grazing diagonals.

A kernel that contracts ``a*b+c`` into a fused multiply-add, or reorders a
sum, agrees with the plain version on almost every random pair and
disagrees only where a margin lies within a rounding error of zero.  So
the planes built here put such pairs on their diagonal: for each pair the
OBB moves along a random ray out of the AABB, and a bisection over the
float32 bit pattern of the ray parameter finds the two neighbouring
positions where the plain :func:`~repro_torch.kernels.sact.ref.sact_tile`
changes its exit code.  The off-diagonal pairs are random and cover every
exit code.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.geometry import rotation_from_euler
from repro_torch.kernels.sact.ref import _EPS, sact_tile


def _codes(oc, oh, R, ac, ah, use_spheres):
    """Elementwise exit codes of the plain sact_tile over pair lists."""
    t = [oc[:, i] - ac[:, i] for i in range(3)]
    Rb = [[R[:, i, j] for j in range(3)] for i in range(3)]
    A = [[torch.abs(Rb[i][j]) + _EPS for j in range(3)] for i in range(3)]
    _, code = sact_tile(t, Rb, A, [ah[:, i] for i in range(3)],
                        [oh[:, i] for i in range(3)], use_spheres=use_spheres)
    return code


def graze(ac: torch.Tensor, ah: torch.Tensor, oh: torch.Tensor,
          R: torch.Tensor, d: torch.Tensor, use_spheres: bool
          ) -> torch.Tensor:
    """OBB centres (2n, 3) that graze n boxes: OBB i (half ``oh[i]``,
    rotation ``R[i]``) moves from the centre of box i (``ac[i]``, ``ah[i]``)
    along the unit ray ``d[i]``; rows 2i and 2i+1 are the two neighbouring
    float32 positions around one change of its exit code.
    """
    n = ac.shape[0]

    def centre(bits):
        lam = bits.to(torch.int32).view(torch.float32)[:, None]
        return ac + lam * d

    lo = torch.zeros(n, dtype=torch.int64)                 # lambda = 0
    hi = torch.full((n,), int(np.float32(4.0).view(np.int32)),
                    dtype=torch.int64)
    # Odd pairs keep the far end's code, even pairs the near end's: the
    # two find the outermost and an inner change (with spheres: the
    # bounding-sphere and the inscribed-sphere boundary).
    from_hi = torch.arange(n) % 2 == 1
    key = torch.where(from_hi, _codes(centre(hi), oh, R, ac, ah, use_spheres),
                      _codes(centre(lo), oh, R, ac, ah, use_spheres))
    for _ in range(40):
        mid = (lo + hi) // 2
        same = _codes(centre(mid), oh, R, ac, ah, use_spheres) == key
        to_lo = same != from_hi          # mid lies on lo's side
        lo = torch.where(to_lo, mid, lo)
        hi = torch.where(to_lo, hi, mid)
    return torch.stack([centre(lo), centre(hi)], 1).reshape(2 * n, 3)


def grazing_plane(n: int, seed: int, use_spheres: bool
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(obb (2n, 15), aabb (2n, 6)) float32; pairs (k, k) graze a test.

    Pairs 2i and 2i+1 are the same boxes at the two neighbouring ray
    positions around one exit-code change.
    """
    g = torch.Generator().manual_seed(seed)

    def u(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=g)
    ac = u((n, 3), -1.0, 1.0)
    ah = u((n, 3), 0.02, 0.25)
    oh = u((n, 3), 0.02, 0.25)
    R = rotation_from_euler(u((n, 3), -np.pi, np.pi))
    d = torch.nn.functional.normalize(u((n, 3), -1.0, 1.0), dim=-1)
    oc = graze(ac, ah, oh, R, d, use_spheres)
    rep = [x.repeat_interleave(2, 0) for x in (oh, R, ac, ah)]
    obb = torch.cat([oc, rep[0], rep[1].reshape(2 * n, 9)], -1)
    aabb = torch.cat([rep[2], rep[3]], -1)
    return obb.numpy(), aabb.numpy()
