"""Monte Carlo Localization (RoWild DeliBot) with dynamic engine switching.

Counterpart of ``repro.core.mcl`` (paper §V-3, §VI-C, Fig. 19).  The
filter casts ``A`` rays per particle through a 2-D occupancy grid, and
switches per iteration between two ray casts, keyed on the mean number of
cells a ray traversed in the previous iteration (the paper's heuristic):

  * ``dense``      — every ray marches ``max_steps`` steps (the "CUDA
                     cores" arm): one ``march`` launch a cast;
  * ``compacted``  — the rays march ``chunk`` steps a launch, and once
                     fewer than half are live the finished ones retire and
                     the live ones are packed (``compact``) into a smaller
                     set (the "RoboCore" arm).

Both march on :func:`repro_torch.kernels.march.ops.march` (the CUDA kernel
on CUDA tensors, its plain version on CPU tensors) and return the same
ranges; ``cells`` is the reference's work count, exact.  With a 3-D scene,
:func:`particle_collision_mask` gates the particles through one
``CollisionEngine.query`` of their footprint OBBs.

Random draws come from an explicit CPU ``torch.Generator`` and are moved
to the grid's device, so a card run and a CPU run with one seed see the
same draws; :func:`mcl_update` takes the draws as arguments.  The
reference's ``jax.random`` streams are not reproduced.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.core.geometry import OBBs
from repro_torch.kernels.compact.ops import compact_columns
from repro_torch.kernels.march.ops import march


@dataclasses.dataclass(frozen=True)
class OccupancyGrid:
    occ: torch.Tensor     # (H, W) bool on the device
    cell: float           # metres per cell
    origin: Tuple[float, float] = (0.0, 0.0)

    @property
    def shape(self):
        return tuple(self.occ.shape)


def make_corridor_world(seed: int, size: int = 256, n_boxes: int = 24,
                        cell: float = 0.05,
                        device=DEFAULT_DEVICE) -> OccupancyGrid:
    """Synthetic indoor floor plan: border walls + random box obstacles,
    drawn from ``RandomState(seed)`` (the reference draws its seed from a
    key: ``jax.random.randint(key, (), 0, 2**31 - 1)`` gives the same
    grid)."""
    occ = np.zeros((size, size), bool)
    occ[0, :] = occ[-1, :] = occ[:, 0] = occ[:, -1] = True
    rs = np.random.RandomState(int(seed))
    for _ in range(n_boxes):
        h, w = rs.randint(4, 20, 2)
        r, c = rs.randint(1, size - 20, 2)
        occ[r:r + h, c:c + w] = True
    return OccupancyGrid(occ=torch.from_numpy(occ).to(resolve_device(device)),
                         cell=cell)


def ray_directions(angles: torch.Tensor) -> torch.Tensor:
    """Unit directions ``(R, 2)`` of angles ``(R,)``: ``(cos, sin)``.  The
    one place the ray casts take them from (cos and sin differ in the last
    bit between libraries and devices)."""
    return torch.stack([torch.cos(angles), torch.sin(angles)], -1)


def _max_steps(grid: OccupancyGrid, max_range: float) -> int:
    return int(np.ceil(max_range / grid.cell)) + 1


def _rays(origins: torch.Tensor, angles: torch.Tensor):
    R = origins.shape[0]
    f32 = dict(dtype=torch.float32, device=origins.device)
    pos = origins.to(torch.float32).clone().contiguous()
    dirv = ray_directions(angles.to(torch.float32)).contiguous()
    return (R, pos, dirv, torch.zeros(R, **f32),
            torch.ones(R, dtype=torch.bool, device=origins.device))


def ray_cast_dense(grid: OccupancyGrid, origins: torch.Tensor,
                   angles: torch.Tensor, max_range: float
                   ) -> Tuple[torch.Tensor, int]:
    """Fixed-trip masked marcher ("CUDA cores" arm): one ``march`` of
    ``max_steps`` steps.  Returns (ranges (R,), cells traversed): every
    lane pays ``max_steps`` steps, ``R * max_steps``."""
    R, pos, dirv, dist, active = _rays(origins, angles)
    max_steps = _max_steps(grid, max_range)
    march(grid.occ, grid.origin, grid.cell, pos, dirv, dist, active,
          max_range, max_steps)
    return dist, R * max_steps


def ray_cast_compacted(grid: OccupancyGrid, origins: torch.Tensor,
                       angles: torch.Tensor, max_range: float,
                       chunk: int = 16) -> Tuple[torch.Tensor, int]:
    """Chunked marcher with compaction ("RoboCore" arm).

    Marches ``chunk`` steps a launch and reads the live count; once fewer
    than half the lanes are live, the finished rays' ranges retire and the
    live rays are packed (``compact``); cells traversed counts the lanes
    of each chunk.
    """
    R, pos, dirv, dist, active = _rays(origins, angles)
    dev = pos.device
    max_steps = _max_steps(grid, max_range)
    ranges = torch.zeros(R, dtype=torch.float32, device=dev)
    idx = torch.arange(R, dtype=torch.int64, device=dev)
    cells = steps_done = 0
    while steps_done < max_steps:
        n = min(chunk, max_steps - steps_done)
        cells += pos.shape[0] * n
        march(grid.occ, grid.origin, grid.cell, pos, dirv, dist, active,
              max_range, n)
        steps_done += n
        live = int(active.sum())
        if live == 0:
            break
        if live < pos.shape[0] // 2:
            # the finished lanes' ranges are final; the live ones are
            # written again when they finish
            ranges[idx] = dist
            lanes = torch.arange(pos.shape[0], dtype=torch.int32, device=dev)
            _, kept = compact_columns(active, (lanes,), live)
            keep = kept[0].to(torch.int64)
            pos, dist, idx, dirv = (pos[keep], dist[keep], idx[keep],
                                    dirv[keep])
            active = torch.ones(live, dtype=torch.bool, device=dev)
    ranges[idx] = dist
    return ranges, cells


def footprint_obbs(particles: torch.Tensor,
                   footprint_half=(0.25, 0.25, 0.4),
                   z_center: float = 0.4) -> OBBs:
    """One yawed footprint OBB per particle ``(x, y, theta)``."""
    x, y, th = particles[:, 0], particles[:, 1], particles[:, 2]
    z = torch.zeros_like(x)
    c, s = torch.cos(th), torch.sin(th)
    one = torch.ones_like(x)
    rot = torch.stack([torch.stack([c, -s, z], -1),
                       torch.stack([s, c, z], -1),
                       torch.stack([z, z, one], -1)], -2)
    center = torch.stack([x, y, torch.full_like(x, z_center)], -1)
    half = torch.tensor(footprint_half, dtype=torch.float32,
                        device=x.device).expand(x.shape[0], 3)
    return OBBs(center=center, half=half.contiguous(), rot=rot)


def particle_collision_mask(engine, particles: torch.Tensor,
                            footprint_half=(0.25, 0.25, 0.4),
                            z_center: float = 0.4) -> np.ndarray:
    """Per-particle footprint collision against a 3-D scene octree: the
    whole population is one ``engine.query`` (in ``wavefront_persistent``
    one ``persist`` launch).  Returns (P,) bool, True = in collision."""
    collide, _ = engine.query(footprint_obbs(particles, footprint_half,
                                             z_center))
    return collide


@dataclasses.dataclass
class MCLState:
    particles: torch.Tensor   # (P, 3) x, y, theta
    weights: torch.Tensor     # (P,)


def _cpu_generator(generator: torch.Generator) -> torch.Generator:
    if generator.device.type != "cpu":
        raise ValueError("MCL draws on a CPU generator (a card run and a CPU "
                         f"run then draw alike), got one on "
                         f"{generator.device}")
    return generator


def init_particles(generator: torch.Generator, grid: OccupancyGrid,
                   n: int) -> MCLState:
    """``n`` particles uniform over the grid's interior and all headings,
    drawn on ``generator`` (CPU) and placed on the grid's device."""
    g = _cpu_generator(generator)
    H, W = grid.shape

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(n, generator=g)
    x = uniform(grid.cell, (H - 1) * grid.cell)
    y = uniform(grid.cell, (W - 1) * grid.cell)
    th = uniform(-math.pi, math.pi)
    dev = grid.occ.device
    return MCLState(particles=torch.stack([x, y, th], -1).to(dev),
                    weights=torch.full((n,), 1.0 / n, device=dev))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _f32(x, dev: torch.device) -> torch.Tensor:
    """A number as a float32 tensor on ``dev``: torch divides a CUDA tensor
    by a Python number as a product with its reciprocal, the CPU truly."""
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def particle_weights(sim: torch.Tensor, observed: torch.Tensor,
                     sigma: float, colliding=None) -> torch.Tensor:
    """Normalised weights ``(P,)`` from the simulated ranges ``(P, A)``:
    ``softmax(-mean((sim - observed)^2) / (2 sigma^2))``; particles marked
    in ``colliding`` get log-weight ``-1e9``, unless every one is."""
    err = torch.mean(torch.square(sim - observed[None, :]), -1)
    logw = -err / _f32(2 * sigma * sigma, sim.device)
    if colliding is not None and not bool(colliding.all()):
        logw = torch.where(colliding, -1e9, logw)
    return torch.softmax(logw, 0)


def resample_indices(w: torch.Tensor, u) -> torch.Tensor:
    """Systematic resampling: for ``(u + i) / P``, i < P, the first index
    whose cumulative weight reaches it (clamped to P - 1)."""
    P = w.shape[0]
    steps = ((_f32(u, w.device) + torch.arange(P, device=w.device))
             / _f32(P, w.device))
    return torch.searchsorted(torch.cumsum(w, 0), steps).clamp(0, P - 1)


def mcl_update(state: MCLState, grid: OccupancyGrid, observed: torch.Tensor,
               scan_angles: torch.Tensor, motion: torch.Tensor,
               noise: torch.Tensor, u, engine: str, max_range: float = 6.0,
               sigma: float = 0.25, collision_engine=None,
               footprint_half=(0.25, 0.25, 0.4)) -> Tuple[MCLState, dict]:
    """One predict-update-resample iteration on given draws: ``noise (P,
    3)`` (already scaled) and ``u`` in [0, 1).  Returns the new state and
    the reference's stats; ``time_s`` brackets the ray cast and ends in a
    device sync.

    With ``collision_engine`` (a ``CollisionEngine`` over the 3-D scene),
    particles whose footprint OBB hits the scene get weight ``-1e9``
    before resampling, unless every particle collides.
    """
    dev = grid.occ.device
    P = state.particles.shape[0]
    A = scan_angles.shape[0]
    parts = state.particles + motion[None, :] + noise
    origins = parts[:, :2].repeat_interleave(A, dim=0)
    angles = (parts[:, 2:3] + scan_angles[None, :]).reshape(-1)
    cast = ray_cast_dense if engine == "dense" else ray_cast_compacted
    _sync(dev)
    t0 = time.perf_counter()
    ranges, cells = cast(grid, origins, angles, max_range)
    _sync(dev)
    dt = time.perf_counter() - t0
    colliding = None
    n_colliding = 0
    if collision_engine is not None:
        colliding = torch.from_numpy(np.asarray(particle_collision_mask(
            collision_engine, parts, footprint_half=footprint_half))).to(dev)
        n_colliding = int(colliding.sum())
    w = particle_weights(ranges.reshape(P, A), observed, sigma, colliding)
    new_parts = parts[resample_indices(w, u)]
    stats = {"cells": int(cells), "rays": int(P * A),
             "cells_per_ray": float(cells) / float(P * A),
             "time_s": dt, "engine": engine,
             "colliding_particles": n_colliding}
    return MCLState(particles=new_parts,
                    weights=torch.full((P,), 1.0 / P, device=dev)), stats


def mcl_step(generator: torch.Generator, state: MCLState,
             grid: OccupancyGrid, observed: torch.Tensor,
             scan_angles: torch.Tensor, motion: torch.Tensor, engine: str,
             max_range: float = 6.0, sigma: float = 0.25,
             collision_engine=None, footprint_half=(0.25, 0.25, 0.4)
             ) -> Tuple[MCLState, dict]:
    """One iteration: the draws (motion noise ``N(0, 0.02^2)`` per
    coordinate, the resampling offset ``u``) on ``generator`` (CPU), then
    :func:`mcl_update`."""
    g = _cpu_generator(generator)
    P = state.particles.shape[0]
    dev = grid.occ.device
    noise = (torch.randn((P, 3), generator=g) * 0.02).to(dev)
    u = torch.rand((), generator=g)
    return mcl_update(state, grid, observed, scan_angles, motion, noise, u,
                      engine, max_range=max_range, sigma=sigma,
                      collision_engine=collision_engine,
                      footprint_half=footprint_half)


def choose_engine(prev_cells_per_ray: float, threshold: float) -> str:
    """Paper §VI-C: switch on mean traversal length of previous iteration."""
    return "compacted" if prev_cells_per_ray >= threshold else "dense"
