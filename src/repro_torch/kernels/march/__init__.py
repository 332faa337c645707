"""Occupancy-grid ray march (MCL's ray cast): CUDA kernel and plain version."""
