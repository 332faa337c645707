"""Host data model: geometry, octree, SACT, counters, row formats."""
