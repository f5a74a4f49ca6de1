"""Grouped expert MLP over capacity buffers: CUDA kernel, ops and plain version."""
