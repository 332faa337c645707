"""The collision "mesh": the devices a sharded engine splits its pool over.

Counterpart of the collision half of ``repro.parallel.sharding``.  In
PyTorch the mesh is a plain list of ``torch.device`` entries, one a shard;
the reference's ``shard_collision_traversal`` (a ``shard_map`` whose stats
``psum`` over the mesh, ``overflow`` a ``pmax``) becomes a host loop over
the blocks in :meth:`repro_torch.engine.executor.CollisionEngine.
_exec_sharded`.  The LM sharding rules of the reference are not ported
here (ROADMAP A.11).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch


def visible_devices() -> List[torch.device]:
    """Every CUDA device this process sees, in index order (empty without
    a card)."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_collision_mesh(shards: int,
                        devices: Optional[Sequence] = None
                        ) -> List[torch.device]:
    """The first ``shards`` entries of ``devices`` (default: every visible
    card), as ``torch.device``; raises ``ValueError`` outside ``[1,
    len(devices)]``."""
    devs = [torch.device(d) for d in (visible_devices() if devices is None
                                      else devices)]
    if not 1 <= shards <= len(devs):
        raise ValueError(
            f"collision mesh wants {shards} device(s) but the device list "
            f"holds {len(devs)}")
    return devs[:shards]


__all__ = ["make_collision_mesh", "visible_devices"]
