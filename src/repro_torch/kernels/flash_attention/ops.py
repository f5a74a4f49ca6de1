"""Public attention ops in the model layout:

* `flash_attention`: q (B, Sq, H, hd), k/v (B, Sk, Hkv, hd) ->
  (B, Sq, H, hd), causal, optional sliding window; k and v of one shape
  on either device, as the JAX op takes them (it refuses MLA's v, narrower
  than q and k);
* `paged_decode_attention`: q (B, 1, H, hd) for the current token against
  one layer's page pools k/v (P, ps, Hkv, hd) (page 0 the never-read
  null page) through int32 tables (B, npp) and lengths (B,) that include
  the current token, whose k/v are already in the pool -> (B, 1, H, hd);
* `paged_decode_attention_int8`: the same over int8 pools with one
  float32 scale a (page, kv head), the current token's k/v (B, Hkv, hd)
  given beside the pool (it is quantized after the step attends).

A CPU tensor takes the plain PyTorch version (`ref`); a CUDA tensor
launches the CUDA kernel, which raises on anything it does not take.
Under autograd flash's kernel forward takes the plain version's
gradients (`_grad.run`; k and v may or may not require one); the paged
ops serve decode only and raise when a gradient is wanted on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _grad

from . import kernel, ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    if k.shape != v.shape:
        raise ValueError(f"flash_attention: k and v must share one shape, got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    return _grad.run(kernel.flash_attention_cuda, ref.flash_attention_ref, q, k, v,
                     causal=causal, window=window)


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, tables: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    if q.device.type == "cpu":
        return ref.paged_decode_attention_ref(q, k_pages, v_pages, tables,
                                              lengths)
    _grad.refuse("paged_decode_attention", q, k_pages, v_pages)
    return kernel.paged_decode_attention_cuda(q, k_pages, v_pages, tables,
                                              lengths)


def paged_decode_attention_int8(q: torch.Tensor, k_pages: torch.Tensor,
                                v_pages: torch.Tensor, k_scales: torch.Tensor,
                                v_scales: torch.Tensor, tables: torch.Tensor,
                                lengths: torch.Tensor, k_new: torch.Tensor,
                                v_new: torch.Tensor) -> torch.Tensor:
    args = (q, k_pages, v_pages, k_scales, v_scales, tables, lengths, k_new, v_new)
    if q.device.type == "cpu":
        return ref.paged_decode_attention_int8_ref(*args)
    _grad.refuse("paged_decode_attention_int8", *args)
    return kernel.paged_decode_attention_int8_cuda(*args)
