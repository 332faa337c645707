"""Stable stream compaction: CUDA kernel and plain version."""
