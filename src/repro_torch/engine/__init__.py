"""Collision engine: query-plan lowering + mode-dispatching executor.

``plan`` lowers the front-end batch shapes (a query set, a (B, M) batch,
S scenes of M queries, a trajectory, a swept-edge pool) to one canonical
pool; ``executor`` owns mode dispatch (the eight modes of Fig. 11),
capacity escalation and counter assembly.
``repro_torch.core.wavefront`` re-exports the executor's public names.
"""
from repro_torch.engine.executor import (CSR_MODES, DEPTH_CAP_MODES,
                                         DEVICE_MODES, MODES,
                                         CollisionEngine, EngineConfig,
                                         frontier_capacity_bound,
                                         query_batched_scenes,
                                         traversal_cache_info)
from repro_torch.engine.plan import (PAYLOAD_INF, PlanValidationError,
                                     QueryPlan, WORKLOADS, plan_batch,
                                     plan_edges, plan_queries, plan_scenes,
                                     plan_trajectory, validate_plan)

__all__ = [
    "CSR_MODES", "CollisionEngine", "DEPTH_CAP_MODES", "DEVICE_MODES",
    "EngineConfig", "MODES", "PAYLOAD_INF", "PlanValidationError",
    "QueryPlan", "WORKLOADS", "frontier_capacity_bound", "plan_batch",
    "plan_edges", "plan_queries", "plan_scenes", "plan_trajectory",
    "query_batched_scenes", "traversal_cache_info", "validate_plan",
]
