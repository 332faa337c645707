"""Launchers: the collision-serving harness (``python -m
repro_torch.launch.serve``)."""
