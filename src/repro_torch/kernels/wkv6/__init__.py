"""RWKV-6 WKV recurrence: CUDA kernel and plain version."""
