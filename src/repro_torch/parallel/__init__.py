"""Device lists for the collision service's sharded execution."""
