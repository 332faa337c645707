"""Staged separating-axis test: CUDA kernels and plain versions."""
