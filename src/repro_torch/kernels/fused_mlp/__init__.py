"""Fused dense gated MLP: CUDA kernel, ops and plain version."""
