"""Selective scan of the hybrid layers: CUDA kernel and plain version."""
