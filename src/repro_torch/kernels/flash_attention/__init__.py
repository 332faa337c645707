"""Causal GQA flash attention (forward): CUDA kernel and plain version."""
