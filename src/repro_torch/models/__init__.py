"""Neural-planner models: the PointNet++ encoder and the MpiNet-lite policy."""
