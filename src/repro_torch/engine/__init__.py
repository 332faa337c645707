"""Plan/execute split: query plans and the collision engine."""
from repro_torch.engine.executor import CollisionEngine, EngineConfig, MODES
from repro_torch.engine.plan import (PlanValidationError, QueryPlan,
                                     plan_batch, plan_queries, validate_plan)

__all__ = ["CollisionEngine", "EngineConfig", "MODES", "PlanValidationError",
           "QueryPlan", "plan_batch", "plan_queries", "validate_plan"]
