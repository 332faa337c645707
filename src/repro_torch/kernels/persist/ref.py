"""Plain PyTorch version of the persistent whole-traversal megakernel.

:func:`persist_tiles_ref` follows the kernel's **per-tile** contract
(``repro.kernels.persist.kernel.persist_kernel``, and the CUDA
``csrc/persist.cu``): the pool is cut into tiles of ``bq`` slots, and each
tile walks all levels with its own ``fcap``-lane frontier, spill ring and
outputs.  It is vectorised over tiles, one level at a time, and processes
each level only over the widest live prefix.  Overflow is counted per
tile, which is what makes its counters, and so the engine's escalation,
agree with the kernel's on every run, not only on overflow-free ones (the
reference's global-pool ``traverse_whole_ref`` counts one shared pool).

It is the CPU arm of ``mode="wavefront_persistent"`` and the oracle the
CUDA kernel is held against on the card.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.counters import NUM_EXIT_CODES
from repro_torch.core.octree import morton_decode
from repro_torch.core.sact import PAYLOAD_INF, axis_tests_from_exit
from repro_torch.kernels.sact.ref import _EPS, sact_tile

_POP8 = torch.tensor([bin(i).count("1") for i in range(256)],
                     dtype=torch.int32)


def popcount8(x: torch.Tensor) -> torch.Tensor:
    """Population count of the low 8 bits (torch has no popcount op)."""
    return _POP8.to(x.device)[(x & 0xFF).to(torch.int64)]


def csr_child_slots(child_mask: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CSR occupancy mask (...,) int32 -> (occupied (..., 8) bool, offs).

    ``offs[..., j] = popcount(mask & ((1 << j) - 1))``: the child's rank
    among its parent's occupied octants and its offset from the parent's
    ``child_start``.
    """
    eight = torch.arange(8, dtype=torch.int32, device=child_mask.device)
    m = child_mask[..., None]
    occupied = ((m >> eight) & 1) != 0
    offs = popcount8(m & ((1 << eight) - 1))
    return occupied, offs


def decode_meta_rows(meta: torch.Tensor, meta_format: str):
    """Gathered packed rows (..., words) -> (xyz (..., 3) int32, full bool,
    child_start int32, child_mask int32).  fp32 rows only."""
    if meta_format != "fp32":
        raise NotImplementedError(
            f"meta_format {meta_format!r}: bf16 and u8 rows land with "
            "ROADMAP A.5.5")
    return (morton_decode(meta[..., 0]), meta[..., 1] != 0, meta[..., 2],
            meta[..., 3])


def persist_tiles_ref(scal, sot, nvalid, obb, meta, payload, owner, *,
                      bq: int, fcap: int, depth: int, ring_cap: int,
                      use_spheres: bool, meta_format: str = "fp32"):
    """Per-tile whole traversal, resident rows.

    Args (the kernel's inputs): ``scal`` f32 (S * (3 + L),) per scene
    [scene_lo xyz, cell size per level]; ``sot`` i32 (T,) scene of each
    tile; ``nvalid`` i32 (1,) live prefix of the pool; ``obb`` f32
    (T * bq, 15); ``meta`` i32 (L, n_max, 4) fp32 rows; ``payload`` and
    ``owner`` i32 (T * bq,) (owner = the slot's verdict group as a
    tile-local slot, -1 = pad).

    Returns ``(best (T, bq), per_level (T, L), hist (T, 18), scalars
    (T, 8), ring (T, ring_cap, 2))``, all int32; scalars are [nodes, leaf,
    axis_exec, axis_dec, sphere, overflow, spilled, meta_rows].  Where
    one level spills more than ``ring_cap`` pairs, ring slots receive
    several pairs and which one stays is undefined, as in the kernel.
    """
    dev = obb.device
    i32, i64 = torch.int32, torch.int64
    T = sot.shape[0]
    L = depth + 1
    n_max = meta.shape[1]
    inf = PAYLOAD_INF
    tiles = torch.arange(T, device=dev, dtype=i64)
    q_base = tiles * bq
    own_tile = owner.reshape(T, bq).to(i64)
    pay_tile = payload.reshape(T, bq).to(i64)
    n_q = torch.minimum((own_tile >= 0).sum(1),
                        (nvalid.to(i64)[0] - q_base).clamp(0, bq))
    scene = sot.to(i64)
    sb = scene * (3 + L)
    lo = scal[sb[:, None] + torch.arange(3, device=dev)]          # (T, 3)
    cells = scal[sb[:, None] + 3 + torch.arange(L, device=dev)]   # (T, L)

    lane = torch.arange(fcap, device=dev, dtype=i64)
    seeded = lane[None, :] < n_q[:, None]
    fq = torch.where(seeded, q_base[:, None] + lane[None, :], 0)
    fn = torch.where(seeded, scene[:, None], 0)
    n_live = torch.minimum(n_q, torch.tensor(fcap, device=dev))
    best = torch.full((T, bq), inf, dtype=i64, device=dev)
    per_level = torch.zeros((T, L), dtype=i64, device=dev)
    hist = torch.zeros((T, NUM_EXIT_CODES), dtype=i64, device=dev)
    leaf = torch.zeros(T, dtype=i64, device=dev)
    axis = torch.zeros(T, dtype=i64, device=dev)
    overflow = torch.zeros(T, dtype=i64, device=dev)
    cursor = torch.zeros(T, dtype=i64, device=dev)
    ring = torch.zeros((T, ring_cap, 2), dtype=i32, device=dev)

    for level in range(L):
        per_level[:, level] = n_live
        w = int(n_live.max())
        if w == 0:
            break
        q, idx = fq[:, :w], fn[:, :w]
        valid = lane[None, :w] < n_live[:, None]
        ql = (q - q_base[:, None]).clamp(0, bq - 1)
        rows = obb[q]                                              # (T, w, 15)
        oc = [rows[..., i] for i in range(3)]
        oh = [rows[..., 3 + i] for i in range(3)]
        R = [[rows[..., 6 + 3 * i + k] for k in range(3)] for i in range(3)]
        xyz, full_l, child_start, child_mask = decode_meta_rows(
            meta[level][idx.clamp(0, n_max - 1)], meta_format)
        cell = cells[:, level, None]                               # (T, 1)
        node_h = cell * 0.5
        node_c = [lo[:, i, None] + (xyz[..., i].to(torch.float32) + 0.5) * cell
                  for i in range(3)]
        tt = [oc[i] - node_c[i] for i in range(3)]
        A = [[torch.abs(R[i][k]) + _EPS for k in range(3)] for i in range(3)]
        collide, exit_code = sact_tile(tt, R, A, [node_h] * 3, oh,
                                       use_spheres=use_spheres)
        is_term = full_l | (level == depth)
        overlap = collide & valid
        term_hit = overlap & is_term

        # Terminal hits fold the lane's payload into its owner's best.
        own_lane = own_tile.gather(1, ql)
        pay_lane = pay_tile.gather(1, ql)
        own_ok = (own_lane >= 0) & (own_lane < bq)
        own_c = own_lane.clamp(0, bq - 1)
        best = best.scatter_reduce(
            1, own_c, torch.where(term_hit & own_ok, pay_lane, inf), "amin")

        term_valid = valid & is_term
        leaf += term_valid.sum(1)
        axis += torch.where(valid, axis_tests_from_exit(exit_code), 0).sum(1)
        hist.scatter_add_(1, exit_code.to(i64), term_valid.to(i64))

        # Expand while the payload could still beat the owner's best
        # (after ALL of this level's folds), children in lane order.
        cand_mask = torch.where(overlap & ~is_term, child_mask, 0)
        best_lane = torch.where(own_ok, best.gather(1, own_c), inf)
        expand = (cand_mask != 0) & (pay_lane < best_lane)
        occupied, offs = csr_child_slots(cand_mask)
        n_child = torch.where(expand, popcount8(cand_mask), 0).to(i64)
        base = torch.cumsum(n_child, 1) - n_child
        n_new = n_child.sum(1)
        live = expand[..., None] & occupied                        # (T, w, 8)
        pos = base[..., None] + offs
        q_rep = q[..., None].expand(-1, -1, 8)
        cand = (child_start[..., None] + offs).to(i64)
        t_rep = tiles[:, None, None].expand_as(pos)

        fq_next = torch.zeros((T, fcap), dtype=i64, device=dev)
        fn_next = torch.zeros((T, fcap), dtype=i64, device=dev)
        keep = live & (pos < fcap)
        fq_next[t_rep[keep], pos[keep]] = q_rep[keep]
        fn_next[t_rep[keep], pos[keep]] = cand[keep]
        spill = live & (pos >= fcap)
        slot = (cursor[:, None, None] + pos - fcap) % ring_cap
        ring[t_rep[spill], slot[spill], 0] = q_rep[spill].to(i32)
        ring[t_rep[spill], slot[spill], 1] = cand[spill].to(i32)

        spill_now = (n_new - fcap).clamp(min=0)
        overflow += spill_now
        cursor = (cursor + spill_now) % ring_cap
        n_live = n_new.clamp(max=fcap)
        fq, fn = fq_next, fn_next

    nodes = per_level.sum(1)
    sphere = 2 * nodes if use_spheres else torch.zeros_like(nodes)
    scalars = torch.stack([nodes, leaf, axis, nodes * 15, sphere, overflow,
                           overflow, torch.zeros_like(nodes)], dim=1)
    return (best.to(i32), per_level.to(i32), hist.to(i32), scalars.to(i32),
            ring)
