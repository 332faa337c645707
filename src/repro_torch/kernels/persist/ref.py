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

:func:`traverse_whole_ref` is the reference's global-pool walk
(``repro.kernels.persist.ref.traverse_whole_ref``), ported for the one arm
the reference serves with it: ``wavefront_fused`` on a ragged multi-scene
batch, where it is tensor code that runs on the card.  It is not the
persistent mode's plain version, and that mode never reaches it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.counters import NUM_EXIT_CODES
from repro_torch.core.octree import (MAX_DEPTH, align_rows, morton_decode,
                                     node_centers_from_xyz)
from repro_torch.core.quantize import (BF16_START_BITS, GRID_BITS,
                                       META_FORMATS, U8_START_BITS)
from repro_torch.core.sact import (NUM_AXES, PAYLOAD_INF,
                                   axis_tests_from_exit, fold_verdicts,
                                   sact_frontier_staged)
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


def frontier_widths(capacity: int, w_min: int = 128) -> Tuple[int, ...]:
    """Power-of-two processing widths from ``w_min`` up to ``capacity``."""
    widths = []
    w = min(w_min, capacity)
    while w < capacity:
        widths.append(w)
        w *= 2
    widths.append(capacity)
    return tuple(widths)


def traverse_whole_ref(obb_c, obb_h, obb_r, node_meta, cell_sizes, scene_lo,
                       depth: int, capacity: int, use_spheres: bool,
                       scene_of_query=None, w_min: int = 128,
                       owner_of_query=None, payload=None, num_valid=None,
                       meta_format: str = "fp32", codes=None):
    """The reference's whole walk over one global frontier pool of
    ``capacity`` lanes; returns ``(verdict, stats)``, the contract of the
    per-level fused arm: (Q,) bool collide flags, or with ``owner_of_query``
    / ``payload`` lanes the (Q,) int32 ``best`` cells of the verdict groups.

    The fused mode's arm for a ragged multi-scene batch, as in the
    reference: ``node_meta`` is the flat :class:`MultiSceneOctree` table
    and ``scene_of_query`` (Q,) names each query's scene, whose origin and
    cell size each pair gathers (``scene_lo`` (S, 3), ``cell_sizes`` (S,
    L)); scene ``s``'s root is flat node ``s`` of level 0.  Without
    ``scene_of_query`` it walks one scene (``scene_lo`` (3,),
    ``cell_sizes`` (L,)).  Rows are decoded in each of the three formats
    (:func:`decode_meta_rows`); u8 rows take each lane's parent code from
    the ``codes`` plane (int32 bit patterns), as the reference does.

    Overflow is counted on the one global pool (children past
    ``capacity`` are dropped, the highest positions first), not per tile:
    that is why this is not the persistent mode's plain version
    (:func:`persist_tiles_ref` is), and the persistent mode never reaches
    it, on either device.  Each level runs at the least width of
    :func:`frontier_widths` that holds its live lanes (one read of the live
    count a level); the lanes past the live count are masked, so the width
    changes no result.  ``num_valid`` (default Q) is the pool's live
    prefix: slots past it seed nothing and add 0 to every counter.
    """
    device = obb_c.device
    i64 = torch.int64
    Q = obb_c.shape[0]
    n_max = node_meta.shape[-2]
    if meta_format == "u8" and codes is None:
        raise ValueError("u8 rows need the codes plane to rebuild each "
                         "lane's code")
    ragged = scene_of_query is not None
    grouped = owner_of_query is not None or payload is not None
    widths = frontier_widths(capacity, w_min)
    lane = torch.arange(capacity, device=device)
    q_idx = torch.where(lane < Q, lane, 0)
    # scene s's root is flat node s of the level-0 row
    node_idx = (scene_of_query.to(i64)[q_idx] if ragged
                else torch.zeros(capacity, dtype=i64, device=device))
    n_live = min(Q if num_valid is None else int(num_valid), capacity)
    verdict = (torch.full((Q,), PAYLOAD_INF, dtype=torch.int32,
                          device=device) if grouped
               else torch.zeros(Q, dtype=torch.int32, device=device))
    st = {k: torch.zeros((), dtype=i64, device=device) for k in (
        "nodes", "leaf", "axis_exec", "axis_dec", "sphere", "overflow")}
    st["per_level"] = torch.zeros(MAX_DEPTH + 1, dtype=i64, device=device)
    st["exit_hist"] = torch.zeros(NUM_EXIT_CODES, dtype=i64, device=device)
    for level in range(depth + 1):
        if n_live == 0:
            break
        w = next(x for x in widths if x >= n_live)
        q, idx = q_idx[:w], node_idx[:w]
        idx_c = idx.clamp(0, n_max - 1)
        valid = torch.arange(w, device=device) < n_live
        pcode = codes[level][idx_c] >> 3 if meta_format == "u8" else None
        xyz, full_l, child_start, child_mask, _ = decode_meta_rows(
            node_meta[level][idx_c], meta_format, level, pcode)
        if ragged:
            sid = scene_of_query.to(i64)[q]
            cell, lo = cell_sizes[:, level][sid], scene_lo[sid]
        else:
            cell, lo = cell_sizes[level], scene_lo
        node_c, node_h = node_centers_from_xyz(xyz, lo, cell)
        res = sact_frontier_staged(obb_c[q], obb_h[q], obb_r[q], node_c,
                                   node_h, valid, use_spheres=use_spheres)
        is_term = full_l | (level == depth)
        overlap = res.collide & valid
        verdict, undecided = fold_verdicts(verdict, q, overlap & is_term,
                                           owner_of_query, payload)
        n_valid = valid.sum()
        term_valid = valid & is_term
        st["nodes"] += n_valid
        st["leaf"] += term_valid.sum()
        st["axis_exec"] += res.axis_tests.sum()
        st["axis_dec"] += n_valid * NUM_AXES
        st["sphere"] += res.sphere_tests.sum()
        st["per_level"][level] = n_valid
        st["exit_hist"].index_add_(0, res.exit_code.to(i64),
                                   term_valid.to(i64))

        # children in lane order (parent-major, octant-minor); those past
        # the capacity drop
        expand = overlap & ~is_term & undecided
        occupied, offs = csr_child_slots(child_mask)
        n_child = torch.where(expand, popcount8(child_mask), 0).to(i64)
        base = torch.cumsum(n_child, 0) - n_child
        n_new = int(n_child.sum())
        pos = base[:, None] + offs
        keep = expand[:, None] & occupied & (pos < capacity)
        q_idx = torch.zeros(capacity, dtype=i64, device=device)
        node_idx = torch.zeros(capacity, dtype=i64, device=device)
        q_idx[pos[keep]] = q[:, None].expand(-1, 8)[keep]
        node_idx[pos[keep]] = (child_start[:, None] + offs).to(i64)[keep]
        st["overflow"] += max(n_new - capacity, 0)
        n_live = min(n_new, capacity)
    return (verdict if grouped else verdict != 0), st
