"""Plain PyTorch version of the ray-march kernel.

Contract (``repro.core.mcl._march_step`` repeated ``n_steps`` times, the
body of the reference's ``jax.lax.fori_loop``, and the CUDA
``csrc/march.cu``): every active ray steps one cell along its direction,

    npos = pos + dirv * cell
    ij   = floor((npos - origin) / cell)          (int; row, column)
    occ  = grid[ij] inside the grid, True outside
    hit  = active & (occ | dist + cell >= max_range)

and ``pos``, ``dist`` and ``active`` take the step's values where the ray
was active.  Everything is float32, each product, sum and quotient
rounded once (the kernel is built with ``--fmad=false`` and divides with
IEEE division); ``cell`` and ``max_range`` enter as float32.  The march
updates ``pos``, ``dist`` and ``active`` in place.

The scalars are 0-dim tensors on the rays' device: on a CUDA tensor torch
divides by a CPU scalar as a product with its reciprocal, which is not the
reference's quotient.
"""
from __future__ import annotations

from typing import Sequence

import torch


def march_ref(occ: torch.Tensor, origin: Sequence[float], cell: float,
              pos: torch.Tensor, dirv: torch.Tensor, dist: torch.Tensor,
              active: torch.Tensor, max_range: float, n_steps: int) -> None:
    """March ``n_steps`` steps in place: ``occ (H, W)`` bool or uint8,
    ``pos``/``dirv (R, 2)`` float32, ``dist (R,)`` float32, ``active
    (R,)`` bool.  Stops early once no ray is active (nothing changes after
    that)."""
    dev = pos.device
    H, W = occ.shape
    f32 = dict(dtype=torch.float32, device=dev)
    cell_t = torch.tensor(cell, **f32)
    range_t = torch.tensor(max_range, **f32)
    org = torch.tensor([float(origin[0]), float(origin[1])], **f32)
    grid = occ.to(torch.bool)
    for _ in range(n_steps):
        if not bool(active.any()):
            return
        npos = pos + dirv * cell_t
        ij = torch.floor((npos - org) / cell_t).to(torch.int64)
        i, j = ij[:, 0], ij[:, 1]
        inb = (i >= 0) & (i < H) & (j >= 0) & (j < W)
        hit_cell = torch.where(inb, grid[i.clamp(0, H - 1),
                                         j.clamp(0, W - 1)], True)
        ndist = dist + cell_t
        hit = active & (hit_cell | (ndist >= range_t))
        pos.copy_(torch.where(active[:, None], npos, pos))
        dist.copy_(torch.where(active, ndist, dist))
        active &= ~hit
