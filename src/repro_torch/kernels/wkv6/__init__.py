"""RWKV6 WKV recurrence: CUDA kernel, ops and plain version."""
