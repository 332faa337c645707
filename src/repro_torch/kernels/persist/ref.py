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

Rows come in the three formats of :mod:`repro_torch.core.quantize` (fp32,
bf16, u8), decoded by :func:`decode_meta_rows` as the kernel decodes them;
u8 rows store only the node's octant, so each lane carries its own Morton
code (the parent-code lane, seeded 0 at the root).  Under the streamed
layout each tile reads a level through fixed windows of ``wsub`` rows over
its scene's sub-extent (``off`` / ``cnt``), and ``meta_rows`` counts the
rows of every window that some valid lane of the tile points into, each
window's occupied span rounded out to whole 8-row chunks: the reference's
schedule (``repro.kernels.persist.ref.traverse_whole_ref``, per tile).

It is the CPU arm of ``mode="wavefront_persistent"`` and the oracle the
CUDA kernel is held against on the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.counters import NUM_EXIT_CODES
from repro_torch.core.octree import align_rows, morton_decode
from repro_torch.core.quantize import (BF16_START_BITS, GRID_BITS,
                                       META_FORMATS, U8_START_BITS)
from repro_torch.core.sact import PAYLOAD_INF, axis_tests_from_exit
from repro_torch.kernels.sact.ref import _EPS, sact_tile

#: Rows of one window of the streamed layout (the reference's).
SUB_WINDOW_ROWS = 1024

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


def decode_meta_rows(meta: torch.Tensor, meta_format: str, level: int,
                     pcode: Optional[torch.Tensor] = None):
    """Gathered packed rows (..., words) of ``level`` -> (xyz (..., 3)
    int32 cell coordinates, full bool, child_start int32, child_mask
    int32, code_own int32), as the reference decodes them.

    fp32 rows are ``[code, full, child_start, child_mask]``.  The packed
    formats keep topology in word 0, ``full << 31 | [octant << 28 |]
    child_start << 8 | mask``, whose right shifts sign-extend when
    ``full`` is set, so every field is masked.  bf16 takes the cell
    coordinates from word 1 (three 10-bit leaf-grid fields, each shifted
    down to ``level``); u8 rebuilds the lane's own code from its parent's,
    ``pcode`` (``code_own = pcode << 3 | octant``), and decodes it.
    ``code_own`` is 0 but under u8, where the children inherit it.
    """
    if meta_format == "fp32":
        return (morton_decode(meta[..., 0]), meta[..., 1] != 0, meta[..., 2],
                meta[..., 3], torch.zeros_like(meta[..., 0]))
    w0 = meta[..., 0]
    full = w0 < 0
    child_mask = w0 & 0xFF
    if meta_format == "bf16":
        child_start = (w0 >> 8) & ((1 << BF16_START_BITS) - 1)
        w1 = meta[..., 1]
        shift = GRID_BITS - level
        xyz = torch.stack([((w1 >> 20) & 0x3FF) >> shift,
                           ((w1 >> 10) & 0x3FF) >> shift,
                           (w1 & 0x3FF) >> shift], dim=-1)
        return xyz, full, child_start, child_mask, torch.zeros_like(w0)
    if meta_format != "u8" or pcode is None:
        raise ValueError(f"meta_format {meta_format!r} (allowed: "
                         f"{META_FORMATS}; u8 needs the parent-code lane)")
    child_start = (w0 >> 8) & ((1 << U8_START_BITS) - 1)
    code_own = (pcode.to(torch.int32) << 3) | ((w0 >> 28) & 7)
    return morton_decode(code_own), full, child_start, child_mask, code_own


def sub_window_rows(n_max: int) -> int:
    """Window size of the streamed layout for an ``n_max``-wide table: the
    fixed :data:`SUB_WINDOW_ROWS`, or the aligned table width when that is
    narrower."""
    return min(SUB_WINDOW_ROWS, align_rows(n_max))


def window_spans(off_l: torch.Tensor, cnt_l: torch.Tensor, wsub: int,
                 nwin: int) -> torch.Tensor:
    """Rows fetched for each window of a level under the streamed layout:
    (..., nwin) int64 from the (...,) level offsets and counts.  Window
    ``w`` covers rows ``[off + w * wsub, off + w * wsub + occ)`` with
    ``occ = clip(cnt - w * wsub, 0, wsub)``, fetched rounded out to whole
    8-row chunks (``floor8(lo) .. ceil8(hi)``); an empty window fetches
    nothing."""
    wlo = torch.arange(nwin, device=off_l.device, dtype=torch.int64) * wsub
    off_l, cnt_l = off_l.to(torch.int64)[..., None], \
        cnt_l.to(torch.int64)[..., None]
    occ = (cnt_l - wlo).clamp(0, wsub)
    g_lo = off_l + wlo
    g_hi = g_lo + occ
    floor8 = torch.div(g_lo, 8, rounding_mode="floor") * 8
    ceil8 = -torch.div(-g_hi, 8, rounding_mode="floor") * 8
    return torch.where(occ > 0, ceil8 - floor8, 0)


def persist_tiles_ref(scal, sot, nvalid, obb, meta, payload, owner, off=None,
                      cnt=None, *, bq: int, fcap: int, depth: int,
                      ring_cap: int, use_spheres: bool,
                      meta_format: str = "fp32", streamed: bool = False,
                      wsub: Optional[int] = None,
                      seen: Optional[torch.Tensor] = None):
    """Per-tile whole traversal.

    Args (the kernel's inputs): ``scal`` f32 (S * (3 + L),) per scene
    [scene_lo xyz, cell size per level]; ``sot`` i32 (T,) scene of each
    tile; ``nvalid`` i32 (1,) live prefix of the pool; ``obb`` f32
    (T * bq, 15); ``meta`` i32 (L, n_max, words) rows in ``meta_format``;
    ``payload`` and ``owner`` i32 (T * bq,) (owner = the slot's verdict
    group as a tile-local slot, -1 = pad); ``off`` / ``cnt`` i32 (S * L,)
    each scene's sub-extent of the level rows (read only when
    ``streamed``).  ``streamed`` counts the windows of ``wsub`` rows
    (default :func:`sub_window_rows`) into ``meta_rows``.  ``seen``, a
    bool (L, n_max) tensor when given, gets every row that a valid lane
    tests set: the distinct rows that the walk must read.

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
    # u8: each lane's parent code (its own code's bits above the octant);
    # every root's is 0
    fc = torch.zeros((T, fcap), dtype=torch.int32, device=dev)
    if streamed:
        wsub = sub_window_rows(n_max) if wsub is None else wsub
        nwin = -(-n_max // wsub)
        off_t = off.to(i64)[scene[:, None] * L + torch.arange(L, device=dev)]
        cnt_t = cnt.to(i64)[scene[:, None] * L + torch.arange(L, device=dev)]
    meta_rows = torch.zeros(T, dtype=i64, device=dev)
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
        if seen is not None:
            seen[level, idx[valid]] = True
        xyz, full_l, child_start, child_mask, code_own = decode_meta_rows(
            meta[level][idx.clamp(0, n_max - 1)], meta_format, level,
            fc[:, :w])
        if streamed:
            # the windows that some valid lane of the tile points into
            win = torch.div(idx - off_t[:, level, None], wsub,
                            rounding_mode="floor").clamp(0, nwin - 1)
            touched = torch.zeros((T, nwin), dtype=i64, device=dev)
            touched.scatter_reduce_(1, win, valid.to(i64), "amax")
            meta_rows += (touched * window_spans(
                off_t[:, level], cnt_t[:, level], wsub, nwin)).sum(1)
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
        fc_next = torch.zeros((T, fcap), dtype=torch.int32, device=dev)
        keep = live & (pos < fcap)
        fq_next[t_rep[keep], pos[keep]] = q_rep[keep]
        fn_next[t_rep[keep], pos[keep]] = cand[keep]
        # children inherit their parent's own code as their parent code
        fc_next[t_rep[keep], pos[keep]] = \
            code_own[..., None].expand(-1, -1, 8)[keep]
        spill = live & (pos >= fcap)
        slot = (cursor[:, None, None] + pos - fcap) % ring_cap
        ring[t_rep[spill], slot[spill], 0] = q_rep[spill].to(i32)
        ring[t_rep[spill], slot[spill], 1] = cand[spill].to(i32)

        spill_now = (n_new - fcap).clamp(min=0)
        overflow += spill_now
        cursor = (cursor + spill_now) % ring_cap
        n_live = n_new.clamp(max=fcap)
        fq, fn, fc = fq_next, fn_next, fc_next

    nodes = per_level.sum(1)
    sphere = 2 * nodes if use_spheres else torch.zeros_like(nodes)
    scalars = torch.stack([nodes, leaf, axis, nodes * 15, sphere, overflow,
                           overflow, meta_rows], dim=1)
    return (best.to(i32), per_level.to(i32), hist.to(i32), scalars.to(i32),
            ring)
