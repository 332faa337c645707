"""Plain PyTorch versions of the staged SACT kernels.

:func:`sact_tile` is the counterpart of ``repro.kernels.sact.kernel.
sact_tile``: the same formulas in the same operation order, over
component-unrolled tensors of one common shape.  It is the plain version
of the CUDA ``__device__ sact_tile`` in ``csrc/sact_tile.cuh`` (which the
dense kernel and the persistent megakernel share) and must agree with it
bit for bit, grazing boxes included.  :func:`sact_ref` runs it over a
dense OBB x AABB plane, the plain version of ``csrc/sact_dense.cu``.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

_EPS = 1e-6


def sact_tile(t: Sequence[torch.Tensor], Rb, A, ahb: Sequence[torch.Tensor],
              ohb: Sequence[torch.Tensor], *, use_spheres: bool
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Staged SACT over component lists (``t``/``ahb``/``ohb`` three tensors,
    ``Rb``/``A`` (= |R| + eps) 3x3 nested lists).  Returns (collide bool,
    exit_code int32).

    Per lane: the first test that decides wins, in stage order; the edge
    stage is skipped when every lane is decided after the box normals,
    which changes no lane's result.
    """
    shape = torch.broadcast_shapes(*(x.shape for x in (*t, *ahb, *ohb)))
    dev = t[0].device
    decided = torch.zeros(shape, dtype=torch.bool, device=dev)
    exit_code = torch.full(shape, 17, dtype=torch.int32, device=dev)

    def note_sep(decided, code, sep_now, code_val):
        newly = sep_now & ~decided
        return decided | sep_now, torch.where(newly, code_val, code)

    confirmed = torch.zeros(shape, dtype=torch.bool, device=dev)
    if use_spheres:
        d2 = torch.zeros(shape, dtype=torch.float32, device=dev)
        for i in range(3):
            d = torch.clamp(torch.abs(t[i]) - ahb[i], min=0.0)
            d2 = d2 + d * d
        r_out2 = ohb[0] * ohb[0] + ohb[1] * ohb[1] + ohb[2] * ohb[2]
        r_in = torch.minimum(torch.minimum(ohb[0], ohb[1]), ohb[2])
        decided, exit_code = note_sep(decided, exit_code, d2 > r_out2, 0)
        newly_hit = (d2 < r_in * r_in) & ~decided
        confirmed = confirmed | newly_hit
        exit_code = torch.where(newly_hit, 1, exit_code)

    live0 = ~(decided | confirmed)
    for i in range(3):   # L = A_i
        rb = ohb[0] * A[i][0] + ohb[1] * A[i][1] + ohb[2] * A[i][2]
        sep = (torch.abs(t[i]) > ahb[i] + rb) & live0
        decided, exit_code = note_sep(decided, exit_code, sep, 2 + i)
    for j in range(3):   # L = B_j
        lhs = torch.abs(t[0] * Rb[0][j] + t[1] * Rb[1][j] + t[2] * Rb[2][j])
        ra = ahb[0] * A[0][j] + ahb[1] * A[1][j] + ahb[2] * A[2][j]
        sep = (lhs > ra + ohb[j]) & live0
        decided, exit_code = note_sep(decided, exit_code, sep, 5 + j)

    if not bool((decided | confirmed).all()):
        live = live0 & ~decided
        for i in range(3):
            i1, i2 = (i + 1) % 3, (i + 2) % 3
            for j in range(3):
                j1, j2 = (j + 1) % 3, (j + 2) % 3
                ra = ahb[i1] * A[i2][j] + ahb[i2] * A[i1][j]
                rb = ohb[j1] * A[i][j2] + ohb[j2] * A[i][j1]
                lhs = torch.abs(t[i2] * Rb[i1][j] - t[i1] * Rb[i2][j])
                sep = (lhs > ra + rb) & live
                decided, exit_code = note_sep(decided, exit_code, sep,
                                              8 + 3 * i + j)
    collide = (~decided) | confirmed
    return collide, exit_code


def sact_ref(obb: torch.Tensor, aabb: torch.Tensor, use_spheres: bool
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense plane: packed OBBs (M, 15) x packed AABBs (N, 6) -> (collide
    (M, N) bool, exit (M, N) int32), as ``sact_kernel`` computes it."""
    oc = [obb[:, i, None] for i in range(3)]
    oh = [obb[:, 3 + i, None] for i in range(3)]
    R = [[obb[:, 6 + 3 * i + j, None] for j in range(3)] for i in range(3)]
    ac = [aabb[None, :, i] for i in range(3)]
    ah = [aabb[None, :, 3 + i] for i in range(3)]
    t = [oc[i] - ac[i] for i in range(3)]
    A = [[torch.abs(R[i][j]) + _EPS for j in range(3)] for i in range(3)]
    return sact_tile(t, R, A, ah, oh, use_spheres=use_spheres)
