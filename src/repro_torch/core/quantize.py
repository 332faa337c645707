"""Quantized node-metadata formats for bandwidth-bound traversal.

The streamed metadata layout (kernels/persist, DESIGN.md §3) made node
rows the explicit HBM cost of large-scene traversal: 16 B per fetched
row.  This module defines the compressed row formats that shrink that
row — and with it the resident table — without ever changing a verdict:

* ``fp32`` — the original 4 x int32 row ``[code, full, child_start,
  child_mask]``; 16 B, decode-free.
* ``bf16`` — 2 x int32: a packed topology word (full flag, 23-bit CSR
  child pointer, 8-bit child-occupancy mask) plus a geometry word
  holding the node's lo corner as 3 x 10-bit fixed-point coordinates on
  the scene's leaf grid (``2**GRID_BITS`` cells per axis); 8 B.  The
  name marks the half-width tier of the bf16/u8 ladder: three
  IEEE bf16 coordinates plus the CSR topology cannot fit 8 B, so the
  half row spends its geometry bits on fixed point instead — which is
  *exact* for octree-aligned cells (a level-``l`` cell coordinate is an
  integer on the leaf grid), where true bf16 mantissas would have to
  round (see :func:`quantize_aabb_bf16` for the genuine-bf16 outward
  rounding used on general, non-aligned boxes).
* ``u8`` — 1 x int32: the topology word alone (full flag, 3-bit octant,
  20-bit child pointer, 8-bit mask); 4 B.  Geometry travels with the
  frontier instead of the row: each lane carries its own Morton code
  (seeded 0 at the root, child = ``(code << 3) | octant``), so the row
  only needs the child's octant — the uint8-offsets-relative-to-parent
  scheme collapsed to its information content, since an octree child's
  bounds relative to its parent cell ARE its 3-bit octant.

Outward rounding is what keeps compressed culling *sound*: a quantized
bound must contain the fp32 bound so a quantized node can only be
visited MORE, never culled when fp32 would visit.  For the aligned
octree cells above the packed coordinates are exact, so verdicts and
every work counter stay bitwise-identical to fp32 (CI-enforced).  The
generic conservative quantizers (:func:`quantize_child_aabb_u8`,
:func:`quantize_aabb_bf16`) implement the outward rounding for
arbitrary boxes — degenerate thin ones included — and are
property-tested for containment in ``tests/test_quantize.py``.

Host-side packing is pure numpy; the in-register dequantize lives in
the traversal arms (kernels/persist/ref.py and the CUDA megakernel).
Byte pricing lives with the rest of the bytes model in
:mod:`repro_torch.core.counters` (``BYTES_META_STREAM{,_BF16,_U8}``).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

#: Node-metadata row formats (drift-guarded against the DESIGN.md §3 /
#: README META_FORMATS tables, like ``META_LAYOUTS``).
META_FORMATS = ("fp32", "bf16", "u8")

#: int32 words per node-metadata row; bytes = 4 * words (the counters
#: module prices them as ``BYTES_META_STREAM{,_BF16,_U8}``).
META_FORMAT_WORDS = {"fp32": 4, "bf16": 2, "u8": 1}

#: Leaf-grid resolution exponent of the packed geometry word: 10-bit
#: fixed point per axis = the finest Morton grid
#: (``repro_torch.core.octree.MAX_DEPTH`` levels; octree.py asserts the two
#: stay equal).
GRID_BITS = 10

#: CSR child-pointer field widths of the packed topology word.  The
#: word is ``full << 31 | [octant << 28 |] child_start << 8 | mask``;
#: a format can only index scenes whose widest level fits its pointer
#: field (:func:`format_eligible` — the chooser's gate, with fp32 as
#: the always-eligible fallback).
BF16_START_BITS = 23
U8_START_BITS = 20

#: Grid of the generic parent-relative uint8 quantizer (offsets are
#: 1/256ths of the parent cell).
U8_GRID = 256


def format_eligible(fmt: str, n_max: int) -> bool:
    """Can ``fmt``'s packed child pointer index a scene whose widest
    level holds ``n_max`` nodes?  fp32 (unpacked int32 pointer) always
    can; the packed formats are bounded by their field width."""
    if fmt not in META_FORMATS:
        raise ValueError(f"unknown meta_format {fmt!r}; "
                         f"allowed: {', '.join(META_FORMATS)}")
    if fmt == "fp32":
        return True
    bits = BF16_START_BITS if fmt == "bf16" else U8_START_BITS
    return int(n_max) <= (1 << bits)


def _check_start(child_start: np.ndarray, bits: int, fmt: str) -> np.ndarray:
    start = np.asarray(child_start, np.int64)
    if start.size and int(start.max()) >= (1 << bits):
        raise ValueError(
            f"meta_format {fmt!r}: child_start {int(start.max())} overflows "
            f"the {bits}-bit packed pointer field; use a wider format")
    return start.astype(np.uint32)


def pack_topo_bf16(full: np.ndarray, child_start: np.ndarray,
                   child_mask: np.ndarray) -> np.ndarray:
    """bf16 topology word: ``full << 31 | child_start << 8 | mask``."""
    start = _check_start(child_start, BF16_START_BITS, "bf16")
    w = ((np.asarray(full, np.uint32) << np.uint32(31))
         | (start << np.uint32(8))
         | (np.asarray(child_mask, np.uint32) & np.uint32(0xFF)))
    return w.view(np.int32)


def pack_topo_u8(full: np.ndarray, octant: np.ndarray,
                 child_start: np.ndarray, child_mask: np.ndarray
                 ) -> np.ndarray:
    """u8 row: ``full << 31 | octant << 28 | child_start << 8 | mask``."""
    start = _check_start(child_start, U8_START_BITS, "u8")
    w = ((np.asarray(full, np.uint32) << np.uint32(31))
         | ((np.asarray(octant, np.uint32) & np.uint32(7)) << np.uint32(28))
         | (start << np.uint32(8))
         | (np.asarray(child_mask, np.uint32) & np.uint32(0xFF)))
    return w.view(np.int32)


def pack_geom_bf16(xyz: np.ndarray, level: int) -> np.ndarray:
    """bf16 geometry word from (n, 3) int cell coordinates at ``level``.

    A level-``l`` cell coordinate ``x < 2**l`` becomes the leaf-grid
    fixed-point value ``x << (GRID_BITS - l)`` (its lo corner in
    1/1024ths of the scene edge) — exact, 10 bits per axis, packed
    ``qx << 20 | qy << 10 | qz``.
    """
    q = np.asarray(xyz, np.uint32) << np.uint32(GRID_BITS - level)
    if q.size and int(q.max()) >= (1 << GRID_BITS):
        raise ValueError(f"cell coordinate overflows the {GRID_BITS}-bit "
                         f"leaf grid at level {level}")
    w = (q[:, 0] << np.uint32(20)) | (q[:, 1] << np.uint32(10)) | q[:, 2]
    return w.view(np.int32)


def unpack_geom_bf16(word: np.ndarray, level: int) -> np.ndarray:
    """Inverse of :func:`pack_geom_bf16` -> (n, 3) int32 cell coords."""
    q = np.asarray(word).view(np.uint32)
    qs = np.stack([(q >> np.uint32(20)) & np.uint32(0x3FF),
                   (q >> np.uint32(10)) & np.uint32(0x3FF),
                   q & np.uint32(0x3FF)], axis=-1)
    return (qs >> np.uint32(GRID_BITS - level)).astype(np.int32)


def unpack_topo(word: np.ndarray, fmt: str
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Packed topology word -> (full, octant, child_start, child_mask).

    ``octant`` is zeros for ``fmt="bf16"`` (its geometry word carries the
    coordinates instead).
    """
    u = np.asarray(word).view(np.uint32)
    full = (u >> np.uint32(31)) != 0
    mask = (u & np.uint32(0xFF)).astype(np.int32)
    if fmt == "u8":
        octant = ((u >> np.uint32(28)) & np.uint32(7)).astype(np.int32)
        start = ((u >> np.uint32(8))
                 & np.uint32((1 << U8_START_BITS) - 1)).astype(np.int32)
    else:
        octant = np.zeros_like(mask)
        start = ((u >> np.uint32(8))
                 & np.uint32((1 << BF16_START_BITS) - 1)).astype(np.int32)
    return full, octant, start, mask


# ---------------------------------------------------------------------------
# Generic conservative (outward-rounded) AABB quantizers.  The packed
# octree rows above never need them (aligned cells quantize exactly);
# they define — and the hypothesis suite verifies — the containment
# contract any future non-aligned compressed node (e.g. an LBVH over
# raw triangles) must satisfy: dequantized bounds ⊇ fp32 bounds.
# ---------------------------------------------------------------------------

def quantize_child_aabb_u8(child_lo, child_hi, parent_lo, parent_cell
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Child AABB ⊆ parent cell -> outward-rounded uint8 offsets.

    ``qlo`` is the lo corner's offset from the parent's lo corner and
    ``qhi`` the hi corner's offset from the parent's HI corner, both
    floored onto the parent cell's 256-grid — flooring an offset
    measured *inward from its own face* rounds each face outward.  A
    verification nudge absorbs float rounding in the grid arithmetic,
    so containment holds exactly, degenerate thin boxes included.
    """
    child_lo = np.asarray(child_lo, np.float64)
    child_hi = np.asarray(child_hi, np.float64)
    parent_lo = np.asarray(parent_lo, np.float64)
    cell = np.float64(parent_cell)
    step = cell / U8_GRID
    qlo = np.clip(np.floor((child_lo - parent_lo) / step), 0,
                  U8_GRID - 1)
    qhi = np.clip(np.floor((parent_lo + cell - child_hi) / step), 0,
                  U8_GRID - 1)
    # Guard the containment contract against rounding in the division:
    # one step outward is always enough (floor is off by at most 1 ulp).
    qlo = np.where(parent_lo + qlo * step > child_lo,
                   np.maximum(qlo - 1, 0), qlo)
    qhi = np.where(parent_lo + cell - qhi * step < child_hi,
                   np.maximum(qhi - 1, 0), qhi)
    return qlo.astype(np.uint8), qhi.astype(np.uint8)


def dequantize_child_aabb_u8(qlo, qhi, parent_lo, parent_cell
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """Inverse of :func:`quantize_child_aabb_u8`; bounds ⊇ the input box."""
    parent_lo = np.asarray(parent_lo, np.float64)
    cell = np.float64(parent_cell)
    step = cell / U8_GRID
    lo = parent_lo + np.asarray(qlo, np.float64) * step
    hi = parent_lo + cell - np.asarray(qhi, np.float64) * step
    return lo, hi


def bf16_round_down(x: np.ndarray) -> np.ndarray:
    """Largest bfloat16-representable value <= ``x`` (finite float32 in).

    Pure uint32 bit arithmetic — no ``ml_dtypes`` dependency — so the
    conservative rounding works on every host; :func:`bf16_support`
    names whether a native bfloat16 cross-check is available.
    """
    x = np.asarray(x, np.float32)
    b = x.view(np.uint32)
    trunc = b & np.uint32(0xFFFF0000)
    # Truncation rounds toward zero; for negative values with dropped
    # mantissa bits that is UP, so step one bf16 ulp further from zero.
    dropped = (b & np.uint32(0xFFFF)) != 0
    neg = (b >> np.uint32(31)) != 0
    bump = np.where(dropped & neg, np.uint32(0x10000), np.uint32(0))
    return (trunc + bump).view(np.float32)


def bf16_round_up(x: np.ndarray) -> np.ndarray:
    """Smallest bfloat16-representable value >= ``x``."""
    return -bf16_round_down(-np.asarray(x, np.float32))


def quantize_aabb_bf16(lo, hi) -> Tuple[np.ndarray, np.ndarray]:
    """Outward-rounded genuine-bf16 bounds: (round_down(lo), round_up(hi));
    always contains the fp32 box, thin/degenerate boxes included."""
    return bf16_round_down(lo), bf16_round_up(hi)


def bf16_support() -> Tuple[bool, str]:
    """(ok, reason): is native bfloat16 rounding available on this host?

    The packed rows and the quantizers above are integer/bit arithmetic
    and never lower bfloat16 ops, so the engine works regardless; tests
    use this guard to cross-check :func:`bf16_round_down`/``up`` against
    ``ml_dtypes`` casts where available and to skip that cross-check —
    with this named reason — where not (satellite: no raw lowering
    errors on bf16-less hosts).
    """
    try:
        import ml_dtypes
    except Exception as e:  # pragma: no cover - ml_dtypes ships with jax
        return False, (f"ml_dtypes unavailable ({e.__class__.__name__}): "
                       f"using uint32-truncation bf16 rounding only")
    try:
        np.asarray([1.0 + 2.0 ** -10], np.float32).astype(ml_dtypes.bfloat16)
    except Exception as e:  # pragma: no cover - defensive
        return False, (f"bfloat16 cast failed on this host ({e}): "
                       f"using uint32-truncation bf16 rounding only")
    return True, "native ml_dtypes bfloat16"
