"""Check frontiers for the traversal-step kernel: real cells, grazing OBBs.

:func:`grazing_frontier` picks occupied cells of one octree level and, for
each, an OBB that grazes it: the OBB moves out of the cell along a random
ray and a bisection over the float32 ray parameter
(:func:`repro_torch.kernels.sact.cases.graze`) stops it at the two
neighbouring positions where the kernel's test changes its exit code.
The cell boxes are built with the kernel's own formula, so each grazing
lane sits within one rounding of a decision.  Every OBB is also paired
with the cells that follow its own in Morton order, which adds nearby,
undecided and far pairs.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.geometry import rotation_from_euler
from repro_torch.core.octree import DeviceOctree, node_centers_from_codes
from repro_torch.kernels.sact.cases import graze
from repro_torch.kernels.sact.ops import pack_obbs


def grazing_frontier(dev: DeviceOctree, level: int, n: int, seed: int,
                     use_spheres: bool, shifts: int = 4
                     ) -> Dict[str, torch.Tensor]:
    """Frontier lanes at ``level`` of ``dev`` (CPU tensors): ``obb`` (2n,
    15) packed OBBs and ``q_idx``, ``codes``, ``full`` (2n * shifts,) int32
    lanes.  Lane ``k * shifts + s`` pairs OBB ``k`` with the ``s``-th cell
    after the one it grazes (``s = 0``: the grazed cell itself)."""
    g = torch.Generator().manual_seed(seed)
    n_l = int(dev.counts[level])
    cell_idx = torch.randint(0, n_l, (n,), generator=g)
    codes_l = dev.codes[level].cpu()
    cell = dev.host_cells[level]
    lo = torch.tensor(dev.host_lo, dtype=torch.float32)
    ac, ah = node_centers_from_codes(codes_l[cell_idx], lo, cell)

    def u(shape, a, b):
        return a + (b - a) * torch.rand(shape, generator=g)
    oh = u((n, 3), 0.1, 1.0) * cell
    R = rotation_from_euler(u((n, 3), -np.pi, np.pi))
    d = torch.nn.functional.normalize(u((n, 3), -1.0, 1.0), dim=-1)
    oc = graze(ac, ah, oh, R, d, use_spheres)
    obb = pack_obbs(oc, oh.repeat_interleave(2, 0), R.repeat_interleave(2, 0))
    k = torch.arange(2 * n).repeat_interleave(shifts)
    s = torch.arange(shifts).repeat(2 * n)
    idx = (cell_idx.repeat_interleave(2, 0)[k] + s) % n_l
    return dict(obb=obb, q_idx=k.to(torch.int32), codes=codes_l[idx],
                full=dev.full[level].cpu()[idx].to(torch.int32))
