"""Compatibility shim: the engine's public names under their old path.

Counterpart of ``repro.core.wavefront``, which re-exports
:mod:`repro.engine.executor` for callers that import the engine from
``core.wavefront``.  Re-exports the names this package has, which serve
every mode of :data:`MODES`; new code imports from
:mod:`repro_torch.engine`.
"""
from repro_torch.engine.executor import (CSR_MODES, DEVICE_MODES, MODES,
                                         CollisionEngine, EngineConfig,
                                         frontier_capacity_bound)

__all__ = [
    "CSR_MODES", "CollisionEngine", "DEVICE_MODES", "EngineConfig", "MODES",
    "frontier_capacity_bound",
]
