"""Compatibility shim: the engine's public names under their old path.

Counterpart of ``repro.core.wavefront``, which re-exports
:mod:`repro.engine.executor` for callers that import the engine from
``core.wavefront``; this module re-exports the same names of
:mod:`repro_torch.engine.executor`.  New code imports from
:mod:`repro_torch.engine`.
"""
from repro_torch.engine.executor import (CSR_MODES, DEVICE_MODES, MODES,
                                         CollisionEngine, EngineConfig,
                                         frontier_capacity_bound,
                                         query_batched_scenes,
                                         traversal_cache_info)

__all__ = [
    "CSR_MODES", "CollisionEngine", "DEVICE_MODES", "EngineConfig", "MODES",
    "frontier_capacity_bound", "query_batched_scenes", "traversal_cache_info",
]
