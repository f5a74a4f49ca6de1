"""Flash attention: CUDA kernel, ops and plain version."""
