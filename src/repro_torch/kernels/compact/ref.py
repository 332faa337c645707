"""Plain PyTorch version of the stream-compaction kernel.

Contract (``repro.kernels.compact.ref.compact_ref``, and the CUDA
``csrc/compact.cu``): given ``mask (N,)`` and rows ``vals (N, C)``, pack
the rows where ``mask`` holds, in ascending input order, into the first
``count = min(sum(mask), n_out)`` rows of an ``(n_out, C)`` buffer;
survivors whose slot would be ``n_out`` or more are dropped.  Rows past
``count`` are zero, in this version and in the kernel.

It uses no boolean-mask indexing, which would wait for the device.
"""
from __future__ import annotations

from typing import Tuple

import torch


def compact_ref(mask: torch.Tensor, vals: torch.Tensor, n_out: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference compaction: (count () int32, packed (n_out, C))."""
    mask = mask.to(torch.bool)
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1       # inclusive scan - 1
    keep = mask & (pos < n_out)
    tgt = torch.where(keep, pos, n_out)                   # parked at n_out
    out = torch.zeros((n_out + 1,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                      device=vals.device)
    # Every parked lane lands on row n_out, which is cut off below.
    out.index_copy_(0, tgt, vals)
    count = torch.clamp(mask.sum(dtype=torch.int32), max=n_out)
    return count, out[:n_out]
