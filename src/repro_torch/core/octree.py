"""Linear Morton octree over point clouds (host build in numpy, device tables
in PyTorch).

Counterpart of ``repro.core.octree``.  For every level ``l`` the tree keeps
the sorted Morton codes of occupied nodes, a ``full`` flag (all descendants
occupied => terminal solid box) and a CSR child table (first-child offset +
8-bit occupancy mask).  The build runs once per scene on the host and is
the reference's numpy code unchanged, so both packages build identical
levels from identical points.

:func:`device_octree` pads the ragged levels into rectangular tensors on a
device and packs the gather-optimized ``node_meta`` row table the
persistent megakernel reads.  A batch of scenes becomes either one table
with a leading scene axis padded to the widest scene
(:func:`stack_device_octrees`, for ``mode="wavefront"``) or one flat
table of all scenes' nodes back to back (:func:`concat_device_octrees`,
a :class:`MultiSceneOctree`, for the CSR modes).  Torch's ``uint32``
supports few ops, so the
device code planes keep the codes as their int32 bit pattern (``PAD_CODE``
becomes -1) and decode them through int64.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.core.geometry import AABBs
from repro_torch.core.quantize import (GRID_BITS, META_FORMATS,
                                       pack_geom_bf16, pack_topo_bf16,
                                       pack_topo_u8)

MAX_DEPTH = 10  # 30 bits of Morton code
assert GRID_BITS == MAX_DEPTH, "packed-geometry grid must match MAX_DEPTH"
PAD_CODE = np.uint32(0xFFFFFFFF)  # > any 30-bit Morton code; keeps rows sorted
#: Row-alignment quantum of the level-major device tables (every padded
#: level row is a whole number of these rows).
META_ROW_ALIGN = 128


def align_rows(n: int) -> int:
    """Round a level width up to the :data:`META_ROW_ALIGN` row quantum."""
    return max(((int(n) + META_ROW_ALIGN - 1) // META_ROW_ALIGN)
               * META_ROW_ALIGN, META_ROW_ALIGN)


def _part1by2(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32) & 0x3FF
    x = (x | (x << 16)) & np.uint32(0x030000FF)
    x = (x | (x << 8)) & np.uint32(0x0300F00F)
    x = (x | (x << 4)) & np.uint32(0x030C30C3)
    x = (x | (x << 2)) & np.uint32(0x09249249)
    return x


def morton_encode(ix: np.ndarray, iy: np.ndarray, iz: np.ndarray) -> np.ndarray:
    return (_part1by2(ix) | (_part1by2(iy) << 1) | (_part1by2(iz) << 2)
            ).astype(np.uint32)


def _compact1by2(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32) & np.uint32(0x09249249)
    x = (x | (x >> 2)) & np.uint32(0x030C30C3)
    x = (x | (x >> 4)) & np.uint32(0x0300F00F)
    x = (x | (x >> 8)) & np.uint32(0x030000FF)
    x = (x | (x >> 16)) & np.uint32(0x000003FF)
    return x


def morton_decode_np(code: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """uint32 codes -> (x, y, z) uint32 cell coordinates (numpy)."""
    return (_compact1by2(code), _compact1by2(code >> 1),
            _compact1by2(code >> 2))


def _torch_compact1by2(x: torch.Tensor) -> torch.Tensor:
    x = x & 0x09249249
    x = (x | (x >> 2)) & 0x030C30C3
    x = (x | (x >> 4)) & 0x0300F00F
    x = (x | (x >> 8)) & 0x030000FF
    x = (x | (x >> 16)) & 0x000003FF
    return x


def morton_decode(code: torch.Tensor) -> torch.Tensor:
    """(...,) codes as int32 bit patterns -> (..., 3) int32 cell coords.

    The bit pattern is widened to int64 and masked to its low 32 bits, so
    the right shifts are logical, as on the reference's uint32 codes.
    """
    c = code.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([_torch_compact1by2(c), _torch_compact1by2(c >> 1),
                        _torch_compact1by2(c >> 2)], dim=-1).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class OctreeLevel:
    codes: np.ndarray        # (n_l,) uint32, sorted occupied node codes
    full: np.ndarray         # (n_l,) bool, all descendants occupied
    # CSR child pointers into the next level's sorted code array: children
    # of node i occupy [child_start[i], child_start[i] + popcount(mask[i])),
    # bit j of child_mask set iff octant j is occupied; zeros at the leaves.
    child_start: np.ndarray  # (n_l,) int32
    child_mask: np.ndarray   # (n_l,) uint8


@dataclasses.dataclass(frozen=True)
class Octree:
    """Linear octree over a cubic scene volume (host numpy arrays)."""

    scene_lo: np.ndarray         # (3,)
    scene_size: float            # cube edge length
    depth: int                   # leaf level
    levels: List[OctreeLevel]    # levels[0] = root level (1 cell), … [depth]
    # Point storage (for ball query): points sorted by leaf Morton code.
    points_sorted: np.ndarray    # (P, 3)
    point_index: np.ndarray      # (P,) int32
    leaf_point_start: np.ndarray  # (n_leaf,) int32
    leaf_point_count: np.ndarray  # (n_leaf,) int32

    @property
    def num_leaves(self) -> int:
        return len(self.levels[self.depth].codes)

    def cell_size(self, level: int) -> float:
        return self.scene_size / (1 << level)

    def node_aabbs(self, level: int) -> AABBs:
        """All occupied nodes of a level as AABBs (CPU tensors)."""
        codes = self.levels[level].codes
        xyz = np.stack(morton_decode_np(codes), -1).astype(np.float32)
        cs = self.cell_size(level)
        center = self.scene_lo[None, :] + (xyz + 0.5) * cs
        half = np.full_like(center, cs / 2.0)
        return AABBs(center=torch.from_numpy(np.ascontiguousarray(center)),
                     half=torch.from_numpy(half))

    def leaf_aabbs(self) -> AABBs:
        return self.node_aabbs(self.depth)


def _pack_node_meta(codes: np.ndarray, full: np.ndarray,
                    child_start: np.ndarray, child_mask: np.ndarray,
                    meta_format: str) -> np.ndarray:
    """Pack padded ``(L, n_max)`` channel matrices into the ``(L, n_max,
    words)`` int32 ``node_meta`` table for ``meta_format`` (see
    :mod:`repro_torch.core.quantize`).  Pad rows pack to zero words in the
    compressed formats."""
    if meta_format not in META_FORMATS:
        raise ValueError(f"unknown meta_format {meta_format!r}; "
                         f"allowed: {', '.join(META_FORMATS)}")
    if meta_format == "fp32":
        return np.stack([codes.view(np.int32), full.astype(np.int32),
                         child_start, child_mask], axis=-1)
    pad = codes == PAD_CODE
    full_p = np.where(pad, False, full)
    start_p = np.where(pad, 0, child_start)
    mask_p = np.where(pad, 0, child_mask)
    if meta_format == "u8":
        octant = (codes & np.uint32(7)).astype(np.int32)
        w = pack_topo_u8(full_p, np.where(pad, 0, octant), start_p, mask_p)
        return w[..., None]
    w0 = pack_topo_bf16(full_p, start_p, mask_p)
    w1 = np.zeros_like(w0)
    for level in range(codes.shape[0]):
        xyz = np.stack(morton_decode_np(codes[level]), axis=-1)
        w1[level] = np.where(pad[level], 0,
                             pack_geom_bf16(np.where(pad[level, :, None], 0,
                                                     xyz), level))
    return np.stack([w0, w1], axis=-1)


@dataclasses.dataclass(frozen=True)
class DeviceOctree:
    """Padded tensors of the octree levels on one device.

    Rows are tail-padded to the widest level, rounded up to
    :data:`META_ROW_ALIGN`.  ``codes`` holds the uint32 Morton codes as
    their int32 bit pattern (``PAD_CODE`` reads as -1).  ``host_cells``
    and ``host_lo`` are host copies of ``cell_sizes`` and ``scene_lo``
    (the same float32 values), for kernels that take them as arguments.
    """

    codes: torch.Tensor        # (depth+1, n_max) int32 bit patterns
    full: torch.Tensor         # (depth+1, n_max) bool, False padded
    counts: torch.Tensor       # (depth+1,) int32 occupied nodes per level
    cell_sizes: torch.Tensor   # (depth+1,) float32
    scene_lo: torch.Tensor     # (3,) float32
    child_start: torch.Tensor  # (depth+1, n_max) int32
    child_mask: torch.Tensor   # (depth+1, n_max) int32 (low 8 bits used)
    node_meta: torch.Tensor    # (depth+1, n_max, words) int32 packed rows
    depth: int
    meta_format: str = "fp32"
    host_cells: Tuple[float, ...] = ()
    host_lo: Tuple[float, ...] = ()

    @property
    def device(self) -> torch.device:
        return self.node_meta.device

    @functools.cached_property
    def codes_unsigned(self) -> torch.Tensor:
        """``codes`` as unsigned values in int64, (depth+1, n_max).

        The int32 bit patterns are not sorted: the pad ``PAD_CODE`` reads
        as -1, below every real code, so ``torch.searchsorted`` on an int32
        row returns wrong slots.  Masked to 32 bits the pad reads
        4294967295, above every 30-bit code, and each row is sorted.
        """
        return self.codes.to(torch.int64) & 0xFFFFFFFF

    def scene(self, s: int) -> "DeviceOctree":
        """Scene ``s`` of a table with a leading scene axis
        (:func:`stack_device_octrees`), as a one-scene table: its rows
        keep the stack's padded width."""
        return DeviceOctree(
            codes=self.codes[s], full=self.full[s], counts=self.counts[s],
            cell_sizes=self.cell_sizes[s], scene_lo=self.scene_lo[s],
            child_start=self.child_start[s], child_mask=self.child_mask[s],
            node_meta=self.node_meta[s], depth=self.depth,
            meta_format=self.meta_format, host_cells=self.host_cells[s],
            host_lo=self.host_lo[s])


def _level_columns(tree: Octree, n_max: int):
    """The (L, n_max) code, full, child-start and child-mask columns of
    ``tree``, tail-padded (codes with ``PAD_CODE``, the rest with 0), and
    its (L,) level counts."""
    L = tree.depth + 1
    codes = np.full((L, n_max), PAD_CODE, np.uint32)
    full = np.zeros((L, n_max), bool)
    counts = np.zeros((L,), np.int32)
    child_start = np.zeros((L, n_max), np.int32)
    child_mask = np.zeros((L, n_max), np.int32)
    for lv_i, lvl in enumerate(tree.levels):
        n = len(lvl.codes)
        codes[lv_i, :n] = lvl.codes
        full[lv_i, :n] = lvl.full
        counts[lv_i] = n
        child_start[lv_i, :n] = lvl.child_start
        child_mask[lv_i, :n] = lvl.child_mask
    return codes, full, child_start, child_mask, counts


def _cells(tree: Octree) -> np.ndarray:
    return np.asarray([tree.cell_size(lv) for lv in range(tree.depth + 1)],
                      np.float32)


def _to(dev: torch.device):
    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    return t


def device_octree(tree: Octree, meta_format: str = "fp32",
                  device=DEFAULT_DEVICE) -> DeviceOctree:
    """Pad the ragged level lists of ``tree`` into rectangular tensors on
    ``device`` (CUDA unless the caller asks for the CPU) and pack the
    ``node_meta`` rows in ``meta_format``."""
    t = _to(resolve_device(device))
    n_max = align_rows(max(len(lv.codes) for lv in tree.levels))
    codes, full, child_start, child_mask, counts = _level_columns(tree,
                                                                  n_max)
    cells = _cells(tree)
    meta = _pack_node_meta(codes, full, child_start, child_mask, meta_format)
    lo = np.asarray(tree.scene_lo, np.float32)
    return DeviceOctree(codes=t(codes.view(np.int32)), full=t(full),
                        counts=t(counts), cell_sizes=t(cells),
                        scene_lo=t(lo), child_start=t(child_start),
                        child_mask=t(child_mask), node_meta=t(meta),
                        depth=tree.depth, meta_format=meta_format,
                        host_cells=tuple(float(c) for c in cells),
                        host_lo=tuple(float(x) for x in lo))


def _same_depth(trees: List[Octree]) -> int:
    if not trees:
        raise ValueError("need at least one octree")
    depth = trees[0].depth
    if any(t.depth != depth for t in trees):
        raise ValueError(f"scene depths must match, got "
                         f"{[t.depth for t in trees]}")
    return depth


def stack_device_octrees(trees: List[Octree],
                         device=DEFAULT_DEVICE) -> DeviceOctree:
    """Stack scenes into one :class:`DeviceOctree` with a leading scene
    axis (``codes`` (S, depth+1, n_max), ``counts`` (S, depth+1), ...), as
    the reference does: every scene's rows tail-padded to the widest level
    of the widest scene, codes with ``PAD_CODE`` (so every row of
    :attr:`DeviceOctree.codes_unsigned` stays sorted), and fp32
    ``node_meta`` packed from the padded columns.  All trees must share a
    depth.  ``host_cells`` and ``host_lo`` hold one tuple a scene;
    :meth:`DeviceOctree.scene` takes one scene out."""
    depth = _same_depth(trees)
    t = _to(resolve_device(device))
    n_max = max(align_rows(max(len(lv.codes) for lv in tr.levels))
                for tr in trees)
    cols = [_level_columns(tr, n_max) for tr in trees]
    codes, full, child_start, child_mask, counts = (
        np.stack([c[i] for c in cols]) for i in range(5))
    meta = np.stack([_pack_node_meta(*c[:4], "fp32") for c in cols])
    cells = np.stack([_cells(tr) for tr in trees])
    los = np.stack([np.asarray(tr.scene_lo, np.float32) for tr in trees])
    return DeviceOctree(codes=t(codes.view(np.int32)), full=t(full),
                        counts=t(counts), cell_sizes=t(cells),
                        scene_lo=t(los), child_start=t(child_start),
                        child_mask=t(child_mask), node_meta=t(meta),
                        depth=depth, meta_format="fp32",
                        host_cells=tuple(tuple(float(c) for c in row)
                                         for row in cells),
                        host_lo=tuple(tuple(float(x) for x in row)
                                      for row in los))


@dataclasses.dataclass(frozen=True)
class MultiSceneOctree:
    """Flat multi-scene CSR table: one row a level, scenes concatenated.

    The ragged alternative to :func:`stack_device_octrees`: level ``l``
    holds the nodes of all scenes back to back (scene-major), so the pad a
    row is shared by the batch and the work follows the sum of the scene
    sizes, not S times the largest.  ``node_meta``'s child pointers are
    rebased to flat next-level indices; codes stay scene-local (a node's
    box comes from its code and its scene's ``scene_lo`` and cell size).
    Scene ``s``'s root is flat node ``s`` of level 0, and its nodes at
    level ``l`` are flat rows ``[scene_off[s, l], scene_off[s, l] +
    scene_counts[s, l])``.
    """

    node_meta: torch.Tensor     # (depth+1, n_max, words) int32 packed rows
    codes: torch.Tensor         # (depth+1, n_max) int32 bit patterns
    counts: torch.Tensor        # (depth+1,) int32 nodes a level, all scenes
    cell_sizes: torch.Tensor    # (S, depth+1) float32
    scene_lo: torch.Tensor      # (S, 3) float32
    scene_off: torch.Tensor     # (S, depth+1) int32 first flat row
    scene_counts: torch.Tensor  # (S, depth+1) int32 nodes of the scene
    depth: int
    meta_format: str = "fp32"

    @property
    def num_scenes(self) -> int:
        return self.cell_sizes.shape[0]

    @property
    def device(self) -> torch.device:
        return self.node_meta.device


def concat_device_octrees(trees: List[Octree], meta_format: str = "fp32",
                          device=DEFAULT_DEVICE) -> MultiSceneOctree:
    """Concatenate scenes into one flat level table (see
    :class:`MultiSceneOctree`) on ``device``, rows packed in
    ``meta_format``.  All trees must share a depth; their sizes may
    differ.  Child pointers are rebased to flat indices before packing,
    so a compressed format's pointer field must hold the concatenated
    level widths (packing raises otherwise)."""
    depth = _same_depth(trees)
    t = _to(resolve_device(device))
    L = depth + 1
    per_scene = np.asarray([[len(tr.levels[lv].codes) for lv in range(L)]
                            for tr in trees], np.int32)          # (S, L)
    totals = per_scene.sum(axis=0)
    offs = (np.cumsum(per_scene, axis=0) - per_scene).astype(np.int32)
    n_max = align_rows(int(totals.max()))
    codes = np.full((L, n_max), PAD_CODE, np.uint32)
    full = np.zeros((L, n_max), bool)
    child_start = np.zeros((L, n_max), np.int32)
    child_mask = np.zeros((L, n_max), np.int32)
    for lv in range(L):
        for s, tr in enumerate(trees):
            lvl = tr.levels[lv]
            a, n = offs[s, lv], per_scene[s, lv]
            codes[lv, a:a + n] = lvl.codes
            full[lv, a:a + n] = lvl.full
            if lv < depth:   # rebase into the flat next level
                child_start[lv, a:a + n] = lvl.child_start + offs[s, lv + 1]
                child_mask[lv, a:a + n] = lvl.child_mask
    meta = _pack_node_meta(codes, full, child_start, child_mask, meta_format)
    return MultiSceneOctree(
        node_meta=t(meta), codes=t(codes.view(np.int32)),
        counts=t(totals.astype(np.int32)),
        cell_sizes=t(np.stack([_cells(tr) for tr in trees])),
        scene_lo=t(np.stack([np.asarray(tr.scene_lo, np.float32)
                             for tr in trees])),
        scene_off=t(offs), scene_counts=t(per_scene), depth=depth,
        meta_format=meta_format)


def node_centers_from_xyz(xyz: torch.Tensor, scene_lo: torch.Tensor,
                          cell_size) -> Tuple[torch.Tensor, torch.Tensor]:
    """Integer cell coords (K, 3) at a level -> (centers, halves) (K, 3).

    The shared float formula of every traversal arm,
    ``lo + (xyz + 0.5) * cell``: identical int coordinates give
    bitwise-identical geometry.
    """
    xyz = xyz.to(torch.float32)
    cell = torch.as_tensor(cell_size, dtype=torch.float32, device=xyz.device)
    if cell.ndim:
        cell = cell[..., None]
    lo = scene_lo if scene_lo.ndim > 1 else scene_lo[None, :]
    center = lo + (xyz + 0.5) * cell
    half = torch.broadcast_to(cell / 2.0, center.shape)
    return center, half


def node_centers_from_codes(codes: torch.Tensor, scene_lo: torch.Tensor,
                            cell_size) -> Tuple[torch.Tensor, torch.Tensor]:
    """Codes (K,) at a level (int32 bit patterns) -> (centers (K, 3),
    halves (K, 3)): :func:`morton_decode` then :func:`node_centers_from_xyz`.
    """
    return node_centers_from_xyz(morton_decode(codes), scene_lo, cell_size)


def build_octree(points: np.ndarray, depth: int = 6,
                 scene_lo: np.ndarray | None = None,
                 scene_size: float | None = None) -> Octree:
    """Build a linear octree from a point cloud (host-side, once per scene)."""
    points = np.asarray(points, np.float32)
    assert 1 <= depth <= MAX_DEPTH
    if scene_lo is None or scene_size is None:
        lo = points.min(0)
        hi = points.max(0)
        pad = 1e-3 * float(np.max(hi - lo) + 1e-6)
        scene_lo = lo - pad
        scene_size = float(np.max(hi - lo) + 2 * pad)
    scene_lo = np.asarray(scene_lo, np.float32)

    res = 1 << depth
    rel = (points - scene_lo[None, :]) / scene_size
    cells = np.clip((rel * res).astype(np.int64), 0, res - 1).astype(np.uint32)
    pt_codes = morton_encode(cells[:, 0], cells[:, 1], cells[:, 2])

    order = np.argsort(pt_codes, kind="stable")
    pt_codes_sorted = pt_codes[order]
    points_sorted = points[order]

    leaf_codes, leaf_start, leaf_count = np.unique(
        pt_codes_sorted, return_index=True, return_counts=True)
    leaf_codes = leaf_codes.astype(np.uint32)

    # Bottom-up levels with full flags.  A leaf is full by definition; an
    # internal node is full iff all 8 children exist and are full.
    levels: List[OctreeLevel] = [None] * (depth + 1)  # type: ignore
    n_leaf = len(leaf_codes)
    levels[depth] = OctreeLevel(codes=leaf_codes, full=np.ones(n_leaf, bool),
                                child_start=np.zeros(n_leaf, np.int32),
                                child_mask=np.zeros(n_leaf, np.uint8))
    child_codes = leaf_codes
    child_full = levels[depth].full
    for lv in range(depth - 1, -1, -1):
        parent_of_child = child_codes >> np.uint32(3)
        codes_l, inv = np.unique(parent_of_child, return_inverse=True)
        n_children = np.zeros(len(codes_l), np.int32)
        np.add.at(n_children, inv, 1)
        n_full = np.zeros(len(codes_l), np.int32)
        np.add.at(n_full, inv, child_full.astype(np.int32))
        full_l = (n_children == 8) & (n_full == 8)
        # CSR child pointers: sorted child codes group contiguously by
        # parent, so the first-child offset is an exclusive scan of the
        # per-parent child counts; the occupancy bitmask ORs each child's
        # octant (low 3 code bits) into its parent's slot.
        start_l = (np.cumsum(n_children) - n_children).astype(np.int32)
        mask_l = np.zeros(len(codes_l), np.uint8)
        np.bitwise_or.at(
            mask_l, inv,
            (np.uint8(1) << (child_codes & np.uint32(7)).astype(np.uint8)))
        levels[lv] = OctreeLevel(codes=codes_l.astype(np.uint32), full=full_l,
                                 child_start=start_l, child_mask=mask_l)
        child_codes, child_full = codes_l.astype(np.uint32), full_l

    return Octree(scene_lo=scene_lo, scene_size=float(scene_size), depth=depth,
                  levels=levels, points_sorted=points_sorted,
                  point_index=order.astype(np.int32),
                  leaf_point_start=leaf_start.astype(np.int32),
                  leaf_point_count=leaf_count.astype(np.int32))


def lookup_children(level_codes: torch.Tensor, parent_codes: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Occupancy lookup for the 8 children of each parent code.

    Args:
      level_codes: (n_{l+1},) sorted occupied codes at the child level as
        unsigned values in int64: a row of
        :attr:`DeviceOctree.codes_unsigned`, whose pads sort last.
      parent_codes: (K,) parent codes (level l), int64 values or int32 bit
        patterns.
    Returns:
      (child_codes (K, 8) int64 in [0, 2**32), child_idx (K, 8) int32 with
      -1 = empty).  The candidates wrap at 32 bits, as the reference's
      uint32 shift does; positions are clamped into the row before the
      gather (torch does not clamp an index).
    """
    parent = parent_codes.to(torch.int64) & 0xFFFFFFFF
    eight = torch.arange(8, dtype=torch.int64, device=parent.device)
    cand = ((parent[:, None] << 3) | eight[None, :]) & 0xFFFFFFFF
    pos = torch.searchsorted(level_codes, cand.reshape(-1)).reshape(cand.shape)
    pos_c = pos.clamp(0, level_codes.shape[0] - 1)
    found = level_codes[pos_c] == cand
    return cand, torch.where(found, pos_c, -1).to(torch.int32)
