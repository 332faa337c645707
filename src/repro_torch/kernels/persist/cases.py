"""Pools that stress the persistent megakernel's owner groups and balance.

Shared by the CPU tests and the card checks (``chip_smoke.py``,
``tests/test_torch_kernels_gpu.py``); random numbers come from numpy.

:func:`owner_group_pool` cuts each tile into tile-local verdict groups:
each slot names its group's first slot, pads are -1 at the tile's tail,
payloads are small random integers, so a group's lanes fold into one
``best`` cell and the gate ``payload < best[owner]`` stops some of them
and not others.  :func:`skewed_pool` puts most of the work into one tile
(large OBBs there, small ones elsewhere): its levels are many times wider
than a CTA, so on the card they span every rank of the tile's cluster
and several lanes a thread, and the frontier capacity it returns spills
the widest level part way through its children.  :func:`grazing_pool`
walks OBBs that graze cells of one level
(:func:`repro_torch.kernels.traverse.cases.grazing_frontier`), so the
kernel's SACT decides pairs within a rounding of their planes there.
:func:`sweep_round_plans` records the plans of a real swept-edge sweep
and :func:`tiled_pool` packs one of them as the engine does
(:func:`repro_torch.kernels.persist.ops.build_tile_map`): whole owner
groups a tile, pads at each tile's tail, real payloads.
:func:`ragged_trees` builds scenes of mixed sizes, each in a box of its
own, and :func:`ragged_pool` packs a ragged batch over their flat table
(:func:`repro_torch.core.octree.concat_device_octrees`) as the engine
does: scene-exclusive tiles, each seeded at its scene's root, optionally
with owner groups inside each scene.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.geometry import rotation_from_euler
from repro_torch.core.octree import (DeviceOctree, MultiSceneOctree, Octree,
                                     build_octree)
from repro_torch.kernels.persist.ops import (DEFAULT_BQ, pack_kernel_inputs,
                                             tile_pool)
from repro_torch.kernels.persist.ref import persist_tiles_ref
from repro_torch.kernels.sact.ops import pack_obbs
from repro_torch.kernels.traverse.cases import grazing_frontier


def _obbs(rs: np.random.RandomState, dev: DeviceOctree, n: int,
          half: Tuple[float, float]) -> torch.Tensor:
    """``n`` packed OBBs (n, 15) inside the scene's box, half extents a
    fraction ``half`` (low, high) of its side."""
    lo = np.asarray(dev.host_lo, np.float32)
    side = np.float32(dev.host_cells[0])
    c = lo + rs.uniform(0.0, 1.0, (n, 3)).astype(np.float32) * side
    h = rs.uniform(*half, (n, 3)).astype(np.float32) * side
    rpy = rs.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    r = rotation_from_euler(torch.from_numpy(rpy))
    return pack_obbs(torch.from_numpy(c), torch.from_numpy(h), r)


def _groups(rs: np.random.RandomState, n_live: int, bq: int,
            max_group: int) -> np.ndarray:
    """Tile-local owners of one tile: consecutive groups of 1 to
    ``max_group`` slots over the live prefix, each slot naming its group's
    first slot; -1 past ``n_live``."""
    own = np.full(bq, -1, np.int32)
    s = 0
    while s < n_live:
        g = min(int(rs.randint(1, max_group + 1)), n_live - s)
        own[s:s + g] = s
        s += g
    return own


def owner_group_pool(dev: DeviceOctree, bq: int, num_tiles: int, seed: int,
                     half=(0.02, 0.12), max_group: int = 4,
                     max_payload: int = 6) -> Dict[str, torch.Tensor]:
    """Inputs of :func:`repro_torch.kernels.persist.ops.persist_tiles` on
    ``dev.device``: ``num_tiles`` tiles of ``bq`` slots, each with a live
    prefix of at least half the tile in owner groups and pads at its tail,
    payloads in [0, ``max_payload``)."""
    rs = np.random.RandomState(seed)
    T = num_tiles
    n_live = rs.randint(max(bq // 2, 1), bq + 1, T)
    owner = np.concatenate([_groups(rs, int(n), bq, max_group)
                            for n in n_live])
    payload = rs.randint(0, max_payload, T * bq).astype(np.int32)
    obb = _obbs(rs, dev, T * bq, half)
    obb[torch.from_numpy(owner < 0)] = 0.0
    return _pack(dev, obb, owner, payload, T)


def skewed_pool(dev: DeviceOctree, bq: int, num_tiles: int, seed: int,
                heavy_tile: int = 1, spill_at: float = 0.65
                ) -> Tuple[Dict[str, torch.Tensor], int, int]:
    """An owner-group pool whose tile ``heavy_tile`` has large OBBs (the
    others small ones), with the ``fcap`` that spills that tile's widest
    level at ``spill_at`` of its children and a ``ring_cap`` that holds
    every spilled pair.  Returns ``(inputs, fcap, ring_cap)``."""
    ins = owner_group_pool(dev, bq, num_tiles, seed, half=(0.01, 0.03))
    rs = np.random.RandomState(seed + 1)
    heavy = slice(heavy_tile * bq, (heavy_tile + 1) * bq)
    live = ins["owner"][heavy] >= 0
    big = _obbs(rs, dev, bq, (0.15, 0.3)).to(dev.device)
    ins["obb"][heavy] = torch.where(live[:, None], big, 0.0)
    kw = dict(bq=bq, depth=dev.depth, ring_cap=1, use_spheres=False,
              meta_format=dev.meta_format)
    cpu = {k: v.cpu() for k, v in ins.items()}
    _, per_level, _, scalars, _ = persist_tiles_ref(**cpu, fcap=1 << 16,
                                                    **kw)
    if int(scalars[:, 5].max()) > 0:
        raise ValueError("skewed_pool: a level outgrows 65,536 lanes")
    widest = int(per_level[heavy_tile].max())
    fcap = max(int(widest * spill_at), 1)
    spilled = persist_tiles_ref(**cpu, fcap=fcap, **kw)[3][:, 6]
    return ins, fcap, max(int(spilled.max()), 1)


def grazing_pool(dev: DeviceOctree, level: int, n: int, seed: int,
                 use_spheres: bool, bq: int = 128) -> Dict[str, torch.Tensor]:
    """An identity pool (every slot its own group, zero payloads) of the
    ``2 n`` OBBs of ``grazing_frontier(dev, level, n, seed, use_spheres)``,
    each placed against a cell of ``level`` within a rounding of where the
    SACT's decision changes; pads at the last tile's tail."""
    obb = grazing_frontier(dev, level, n, seed, use_spheres)["obb"]
    m = obb.shape[0]
    T = -(-m // bq)
    owner = np.full(T * bq, -1, np.int32)
    owner[:m] = np.arange(m) % bq
    obb = torch.nn.functional.pad(obb, (0, 0, 0, T * bq - m))
    return _pack(dev, obb, owner, np.zeros(T * bq, np.int32), T)


def _pack(dev: DeviceOctree, obb: torch.Tensor, owner: np.ndarray,
          payload: np.ndarray, T: int) -> Dict[str, torch.Tensor]:
    d = dev.device
    scal = torch.cat([dev.scene_lo.to(torch.float32),
                      dev.cell_sizes.to(torch.float32)])
    cnt = dev.counts.to(torch.int32)
    return dict(scal=scal, sot=torch.zeros(T, dtype=torch.int32, device=d),
                nvalid=torch.tensor([obb.shape[0]], dtype=torch.int32,
                                    device=d),
                obb=obb.to(d).contiguous(), meta=dev.node_meta,
                payload=torch.from_numpy(payload).to(d),
                owner=torch.from_numpy(owner).to(d),
                off=torch.zeros_like(cnt), cnt=cnt)


def sweep_round_plans(engine, q_from, q_to, resolution: int,
                      base_pos=None) -> List:
    """Run ``check_edges`` on ``engine`` and return every plan its rounds
    executed, in order (the coarse rounds' owner plans and the width-1
    rounds' owner + payload plans)."""
    from repro_torch.core.pipeline import check_edges
    plans = []
    execute = engine.execute

    def record(plan, *a, **k):
        plans.append(plan)
        return execute(plan, *a, **k)
    engine.execute = record
    try:
        check_edges(engine, q_from, q_to, resolution=resolution,
                    base_pos=base_pos)
    finally:
        del engine.execute
    return plans


def tiled_pool(dev: DeviceOctree, plan, bq: int = DEFAULT_BQ
               ) -> Tuple[Dict[str, torch.Tensor], int]:
    """Inputs of :func:`repro_torch.kernels.persist.ops.persist_tiles` for
    a plan with an owner lane, packed as the engine packs them
    (:func:`repro_torch.kernels.persist.ops.tile_pool`).  Returns
    ``(inputs, bq)`` with the tile map's ``bq``."""
    d = dev.device
    t = tile_pool(plan.obb_c.to(d), plan.obb_h.to(d), plan.obb_r.to(d),
                  plan.owner_of_query, plan.payload, bq)
    ins = pack_kernel_inputs(t["obb_c"], t["obb_h"], t["obb_r"], dev,
                             t["bq"], payload=t["payload"],
                             owner_local=t["tiles"].owner_local,
                             scene_of_tile=t["tiles"].scene_of_tile)
    return ins, t["bq"]


def ragged_trees(sizes: Sequence[int] = (6000, 700, 2500), depth: int = 5,
                 seed: int = 0) -> List[Octree]:
    """Scenes of ``sizes`` uniform points each, at one depth, each in a box
    of its own (scaled and shifted), so that every scene has its own
    origin, cell sizes and level widths."""
    rs = np.random.RandomState(seed)
    trees = []
    for i, n in enumerate(sizes):
        shift = rs.uniform(-2.0, 2.0, 3)
        pts = rs.uniform(-1.0, 1.0, (n, 3)) * (0.5 + i) + shift
        trees.append(build_octree(pts.astype(np.float32), depth=depth))
    return trees


def ragged_pool(multi: MultiSceneOctree, per_scene: Sequence[int],
                seed: int, owner_groups: bool = False,
                half=(0.02, 0.12), bq: int = DEFAULT_BQ
                ) -> Tuple[Dict[str, torch.Tensor], int]:
    """Inputs of :func:`repro_torch.kernels.persist.ops.persist_tiles` on
    ``multi.device`` for a ragged batch of ``per_scene[s]`` OBBs in scene
    ``s`` (inside its box, half extents a fraction ``half`` of its side),
    tiled as the engine tiles it (:func:`tile_pool`: scene-exclusive
    tiles, pads at each tile's tail).  With ``owner_groups`` each scene's
    queries fall into consecutive groups of 1 to 4 slots with payloads in
    [0, 6); else every query is its own group.  Returns ``(inputs,
    bq)``."""
    rs = np.random.RandomState(seed)
    lo = multi.scene_lo.cpu().numpy()
    side = multi.cell_sizes[:, 0].cpu().numpy()
    soq = np.repeat(np.arange(len(per_scene)), per_scene).astype(np.int32)
    n = soq.size
    c = lo[soq] + rs.uniform(0.0, 1.0, (n, 3)) * side[soq, None]
    h = rs.uniform(*half, (n, 3)) * side[soq, None]
    r = rotation_from_euler(torch.from_numpy(
        rs.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)))
    owner = payload = None
    if owner_groups:
        owner = np.zeros(n, np.int32)
        g = s = 0
        for q in range(n):
            if q == s or soq[q] != soq[q - 1]:
                s = q + int(rs.randint(1, 5))
                g += q > 0
            owner[q] = g
        payload = rs.randint(0, 6, n).astype(np.int32)
    d = multi.device
    t = tile_pool(torch.from_numpy(c.astype(np.float32)).to(d),
                  torch.from_numpy(h.astype(np.float32)).to(d), r.to(d),
                  owner, payload, bq, scene_of_query=soq)
    ins = pack_kernel_inputs(t["obb_c"], t["obb_h"], t["obb_r"], multi,
                             t["bq"], payload=t["payload"],
                             owner_local=t["tiles"].owner_local,
                             scene_of_tile=t["tiles"].scene_of_tile)
    return ins, t["bq"]
