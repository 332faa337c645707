"""Fixed-radius ball query: CUDA kernel and plain version."""
