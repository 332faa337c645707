"""Plain PyTorch version of the fused traversal-step test kernel.

Contract (``repro.kernels.traverse.kernel.traverse_kernel``, and the CUDA
``csrc/traverse.cu``): given one wavefront level's frontier lanes --
``q_idx`` / ``codes`` / ``full`` -- and the packed OBB table, emit one
int32 word per lane:

  bit 0      collide   (staged SACT verdict)
  bit 1      is_term   (leaf level, or full-subtree internal node)
  bits 2..6  exit_code (see repro_torch.core.sact EXIT_*)

Lanes at or past ``n_live`` pack to 0.  :func:`traverse_test_ref` follows
the kernel's formulas, not ``core/sact.py``'s: the OBB gathered by
``q_idx`` (zeros out of range, as the reference's one-hot gather gives),
the node box ``lo + (xyz + 0.5) * cell`` / ``cell * 0.5`` from the Morton
code, and :func:`repro_torch.kernels.sact.ref.sact_tile`.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.core.octree import morton_decode
from repro_torch.core.sact import SactResult
from repro_torch.kernels.sact.ref import _EPS, sact_tile


def _pack(collide, is_term, exit_code) -> torch.Tensor:
    return (collide.to(torch.int32) | (is_term.to(torch.int32) << 1)
            | (exit_code.to(torch.int32) << 2))


def pack_verdicts(res: SactResult, is_term: torch.Tensor) -> torch.Tensor:
    """(collide, is_term, exit_code) -> packed int32 word per lane."""
    return _pack(res.collide, is_term, res.exit_code)


def unpack_verdicts(packed: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Packed word -> (collide bool, is_term bool, exit_code int32)."""
    return (packed & 1) != 0, (packed & 2) != 0, packed >> 2


def traverse_test_ref(obb: torch.Tensor, q_idx: torch.Tensor,
                      codes: torch.Tensor, full: torch.Tensor,
                      n_live: torch.Tensor, *, cell: float,
                      lo: Sequence[float], is_leaf: bool,
                      use_spheres: bool) -> torch.Tensor:
    """Packed (capacity,) verdict words of one frontier level.

    ``obb`` (m, 15) packed OBBs; ``q_idx``, ``codes`` (int32 bit patterns)
    and ``full`` (nonzero = full subtree) (capacity,) lanes; ``n_live`` the
    live prefix, a 0-d or (1,) int tensor; ``cell``, ``lo`` and ``is_leaf``
    the level's scalars.
    """
    dev = obb.device
    f32 = dict(dtype=torch.float32, device=dev)
    m = obb.shape[0]
    q = q_idx.to(torch.int64)
    in_range = (q >= 0) & (q < m)
    rows = torch.where(in_range[:, None], obb[q.clamp(0, max(m - 1, 0))],
                       torch.zeros((), **f32))
    oc = [rows[:, i] for i in range(3)]
    oh = [rows[:, 3 + i] for i in range(3)]
    R = [[rows[:, 6 + 3 * i + k] for k in range(3)] for i in range(3)]
    xyz = morton_decode(codes).to(torch.float32)
    cell_t = torch.tensor(cell, **f32)
    node_c = [torch.tensor(lo[i], **f32) + (xyz[:, i] + 0.5) * cell_t
              for i in range(3)]
    node_h = cell_t * 0.5
    t = [oc[i] - node_c[i] for i in range(3)]
    A = [[torch.abs(R[i][k]) + _EPS for k in range(3)] for i in range(3)]
    collide, exit_code = sact_tile(t, R, A, [node_h] * 3, oh,
                                   use_spheres=use_spheres)
    is_term = (full != 0) | bool(is_leaf)
    lane = torch.arange(q_idx.shape[0], device=dev)
    valid = lane < n_live.reshape(())
    return torch.where(valid, _pack(collide, is_term, exit_code), 0)
