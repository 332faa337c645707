"""Fused wavefront traversal step: CUDA kernel and plain version."""
