"""RG-LRU diagonal linear recurrence: CUDA kernel, ops and plain version."""
