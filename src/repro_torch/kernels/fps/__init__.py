"""Furthest point sampling: CUDA kernel and plain version."""
