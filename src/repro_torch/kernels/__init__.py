"""Hand-written CUDA kernels of the port, one `<name>/` directory each
with `kernel.py` (launch wrapper), `ops.py` (public op: plain version on
the CPU, kernel on the card) and `ref.py` (plain PyTorch version):

    fused_norm/       RMSNorm and RMSNorm+residual
    fused_mlp/        dense gated MLP, hidden never in device memory
    flash_attention/  causal GQA flash attention (prefill) and paged
                      single-token decode attention from the page pool
    moe_mlp/          grouped expert MLP over MoE capacity buffers
    wkv6/             RWKV6 WKV recurrence, returning the final state
    rglru_scan/       RG-LRU diagonal linear recurrence

Sources live in `repro_torch/csrc/`; `_build` compiles and binds them.
"""
