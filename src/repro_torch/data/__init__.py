"""Scene and trajectory generators."""
