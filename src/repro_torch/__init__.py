"""PyTorch/CUDA port of the serving substrate, for one NVIDIA H100.

The JAX package `repro` is the reference; this package stands alone (it
imports `torch` and `numpy`, never `jax` or `repro`) and mirrors its
layout: `models/`, `serving/`, `kernels/<name>/{kernel,ops,ref}.py`,
`launch/`.  Kernels are CUDA C++ under `csrc/`, built with nvcc at first
use (`kernels._build`).  Entry points run on the card unless the caller
passes `device="cpu"`.
"""
