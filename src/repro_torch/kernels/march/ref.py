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

:func:`march_grouped_ref` is the CUDA kernel's schedule in PyTorch: rounds
of ``group`` steps, each round's positions and distances by the serial
sums first, then every step's cell and test at once, then the first step
that hits.  It gives the same bits as :func:`march_ref`, which the CPU
tests hold.

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


def march_grouped_ref(occ: torch.Tensor, origin: Sequence[float],
                      cell: float, pos: torch.Tensor, dirv: torch.Tensor,
                      dist: torch.Tensor, active: torch.Tensor,
                      max_range: float, n_steps: int, group: int) -> None:
    """:func:`march_ref` in the kernel's order, in place: each round
    marches the next ``group`` steps of every live ray speculatively (the
    kernel's lanes a ray times steps a lane): the ``group`` positions and
    distances by the serial sums, then each step's cell and test, with no
    dependence between them, steps past ``n_steps`` left out.  A ray takes
    its first step that hits (and ends), or the round's last step; a step
    past the first hit changes nothing."""
    if group < 1:
        raise ValueError(f"group must be >= 1, got {group}")
    dev = pos.device
    H, W = occ.shape
    f32 = dict(dtype=torch.float32, device=dev)
    cell_t = torch.tensor(cell, **f32)
    range_t = torch.tensor(max_range, **f32)
    org = torch.tensor([float(origin[0]), float(origin[1])], **f32)
    grid = occ.to(torch.bool)
    step = dirv * cell_t                 # the product every step forms
    rows = torch.arange(pos.shape[0], device=dev)
    live = active.clone()
    p, t = pos.clone(), dist.clone()
    for base in range(0, n_steps, group):
        if not bool(live.any()):
            return
        g = min(group, n_steps - base)
        P = torch.empty((pos.shape[0], g, 2), **f32)
        T = torch.empty((pos.shape[0], g), **f32)
        for k in range(g):
            p = p + step
            t = t + cell_t
            P[:, k], T[:, k] = p, t
        ij = torch.floor((P - org) / cell_t).to(torch.int64)
        i, j = ij[..., 0], ij[..., 1]
        inb = (i >= 0) & (i < H) & (j >= 0) & (j < W)
        hit_cell = torch.where(inb, grid[i.clamp(0, H - 1),
                                         j.clamp(0, W - 1)], True)
        hit = live[:, None] & (hit_cell | (T >= range_t))
        ends = hit.any(1)
        # argmax takes a row's first maximum: its first step that hits
        k = torch.where(ends, hit.to(torch.uint8).argmax(1), g - 1)
        pos.copy_(torch.where(live[:, None], P[rows, k], pos))
        dist.copy_(torch.where(live, T[rows, k], dist))
        active &= ~ends
        live &= ~ends
