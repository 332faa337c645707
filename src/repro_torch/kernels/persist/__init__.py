"""Persistent whole-traversal megakernel: CUDA kernel and plain version."""
