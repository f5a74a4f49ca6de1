"""Fused RMSNorm(+residual): CUDA kernel, ops and plain version."""
