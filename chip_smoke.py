#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`src/repro_torch`).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc); imports nothing of JAX
or of the JAX package.  Phases, each of which fails the run (non-zero
exit, no result line) when a check fails:

1. Card and build: prints the card's name and power limit
   (`nvidia-smi`) and builds the CUDA kernels from `src/repro_torch/csrc`
   (one nvcc per source, all at once), printing the build time and
   ptxas's registers and spilled bytes for each kernel; no kernel of any
   source may spill.
2. Kernels: each kernel's launch wrapper against its plain PyTorch
   version on the card, at the serving paths' shapes (smollm-135m: d 576,
   F 1536, 9 query / 3 KV heads of 64, bfloat16 and float32, the fused
   MLP at N 1, 4, 5, 16, 256 and 300, swiglu and GELU, and paged decode
   over 4 slots of 16-332 tokens in pages of 16 with the null page and
   the positions past each length poisoned, also at head dims 80 (32 / 8
   heads) and 96 (16 / 4), and bfloat16 rows where bytes set the bound:
   smollm's heads over 16 slots and internlm2-1.8b's 16 / 8 heads of 128
   over 8 slots, 2048 positions each; the norms and the fused MLP
   also at d 4096 (F 14336) and d 5120 (F 27648); mixtral-8x7b: flash
   attention over 32 query / 8 KV heads of 128 with its window of 4096,
   at a 300-token prompt and at 4352 tokens (past the window), moe_mlp
   over 8 experts of d 4096, F 14336 at capacities 8, 12, 80 and 96 and a
   GELU row, bfloat16; flash attention also at h2o-danube-1.8b's 32 / 8
   heads of 80 (window 4096, S 300) and over a ragged batch of two
   100-token prompts; rwkv6-3b: wkv6 over 40 heads of 64, in the JAX
   op's (BH, S, D) layout and in the model's (B, S, H, D) layout that
   `rwkv6.time_mix` passes, float32, at decode, a 256- and a 1024-token
   prefill, with Dv 32 and with bfloat16 inputs (o within one bfloat16
   rounding, at decode and S 256); recurrentgemma-2b: rglru_scan over
   2560 channels at decode (B 4) and prefills of 256, 300 and 1024 tokens
   and B 4 x 256, float32, and bfloat16 rows at decode and 256 tokens
   (h within one bfloat16 rounding of the float32 recurrence), every
   prefill row on the cluster kernel
   and decode on the step kernel), TF32 off, with the tolerance stated;
   then every op at widths its JAX kernel takes and no served model
   uses (`widths_rows`: flash hd 96, 100 and 256, paged decode hd 100
   and 576, wkv6 (D, Dv) (40, 24), (64, 256) and (200, 64), the bf16 MLP
   tile at d 580, F 1540, the norms at d 12288), with flash hd 64 and the
   fused MLP's d 576 forced through the padding bit-equal to their
   native routes; then one float16 row per kernel at its served shape
   (`float16_rows`); the column splits past the kernels' register tiles
   (`column_split_rows`: flash hd 288 and 512, paged decode hd 1152 and
   2048, the bfloat16 MLP tile at d 7168 and 8192, F 2048, fused and
   MoE; the flash rows beside one SDPA call); and paged_decode's int8
   pool route with q float32 and bfloat16 (bfloat16 within one bfloat16
   rounding of the float32 result) at smollm's decode shape and
   internlm2-1.8b's 8 slots x 2048 positions, with the null page and the
   positions at or past each length - 1 poisoned (`int8_paged_rows`); then
   paged_decode's pool routes with a NaN in a live page of one slot (the
   tensor-core route at 16 splits and at 1, the FMA route at hd 80 in
   float32, the int8 route through a page's scales; K, V and both): that
   slot's output non-finite on every head, the other slots' bits
   unchanged, and a NaN in the null page or past each length changing no
   bit (`nan_paged_rows`); then the rows at the variant archs' served
   shapes (`variant_rows`: flash and paged decode at qwen2-vl-2b's 12 / 2
   heads of 128, its int8 row in `Q8_ROWS`, the MLP tile at N 4 at
   h2o-danube-1.8b's, qwen2-vl-2b's and deepseek-v3-671b's widths,
   moe_mlp over deepseek-v3's 256 experts at capacities 8 and 16, one
   call's extra device memory within 64 MB); then the rows at the local
   shapes tensor parallelism over 2 ranks gives the kernels (`tp_rows`:
   the MLP tile at smollm-135m's F 768, h2o-danube-1.8b's F 3456,
   qwen2-vl-2b's F 4480 and deepseek-v3's shared expert at F 1024;
   flash at danube's 16 / 4 heads of 80, qwen2-vl's 6 / 1 of 128 and
   mixtral's 16 / 4 of 128; paged decode at qwen2-vl's 6 / 1 heads;
   moe_mlp at mixtral's E 4 and deepseek-v3's E 128; wkv6 at rwkv6-3b's 20
   of 40 heads and rglru_scan at recurrentgemma-2b's 1280 of 2560
   channels, a decode step and a 256-token prefill, float32); then each of the seven
   ops under autograd, float32 (`grad_rows`: the norms, the fused MLP
   with and without a gate, flash with a window and k / v without a
   gradient, moe_mlp, rglru_scan, wkv6 in both layouts): one kernel
   launch in the forward and none in the backward, each output within
   the op's float32 tolerance of the plain version's, the gradients
   within 1e-5 of each input's largest of the plain version's (a check
   of the route's plumbing: the backward is the plain version's), and
   the paged decode ops raising under grad; kernel,
   plain-version and library times from CUDA events and from the
   profiler's device time, and the least time the card could take (bytes
   over 3.35 TB/s or operations over the type's peak).  Every bfloat16
   MLP and flash row, and every paged decode, wkv6 and rglru_scan row,
   must give bit-identical outputs on a second launch,
   and each bfloat16 flash row the same bits under the tile's other block
   size (4 or 8 warps; its device time is printed); in a windowed
   bfloat16 flash row past its window, each row q >= window (an average
   over `window` keys, so its values are small) must also be within
   2.5e-2 of its own RMS of the float32 plain version.  One moe_mlp call
   at capacity 96 may take at most 64 MB of device memory beside its
   output.
3. Correctness end to end, float32 at full width: smollm-135m (4 layers)
   serves one 8-request trace through the plain impls, through the kernel
   impls (decode attention from the page pool: one paged_decode launch a
   layer a step) and through the dense KV state (paged=False), and its
   first decode's logits by the pool route are held against the gather
   route's; mixtral-8x7b (2 layers), rwkv6-3b (2 layers) and
   recurrentgemma-2b (3 layers: two recurrent, one attention) serve one
   trace on the card, which runs the kernels, and on the CPU, which runs
   the plain versions.  Greedy tokens must be equal and the first
   prefill's logits within 1e-3.  smollm-135m (2 layers) with int8 KV
   serves one trace by the int8 pool route and by the gather route: equal
   greedy tokens (`int8_e2e_phase`).  smollm-135m (4 layers, the kernel
   impls) on 2 cluster replicas through a scripted fault drill (kill,
   restart, stall, nan; watchdog stall_steps 5): every request's tokens
   equal a fault-free engine's, one "nan" and one "stall" quarantine,
   requests requeued, none unrouted (`cluster_drill_phase`); and a
   `SpecDecodeEngine` (2-layer target, 1-layer shared-trunk draft, k 4)
   emits the target-only engine's greedy tokens (`spec_e2e_phase`).
   qwen2-vl-2b (2 layers; M-RoPE) serves one trace through the plain
   impls, the kernel impls (pool route) and the kernel impls with the
   gather route, and deepseek-v3-671b (2 layers: one dense, one MoE over
   256 experts; weights drawn on the card) through the plain and the
   kernel impls (flash off: it refuses MLA's v), and h2o-danube-1.8b (2
   layers) with two prompts past its window of 4096 through the plain
   and the kernel impls: equal greedy tokens (`qwen2_vl_e2e_phase`,
   `danube_e2e_phase`, `deepseek_e2e_phase`).  One `value_and_grad` step
   through the kernel route and through the plain route, float32 at full
   width (`grad_e2e_phase`): smollm-135m (4 layers, flash, fused MLP and
   norms against einsum, dense and the plain norm, both on the card),
   rwkv6-3b (2 layers), recurrentgemma-2b (3 layers, the fused norms and
   flash) and mixtral-8x7b (1 layer, all three flags) on the card against
   the CPU; every kernel of the route launched in the forward, losses
   within 1e-4 and every gradient leaf within 1e-3 of its largest.
4. Main paths, each at full width in bfloat16 with random weights from a
   seed, through `repro_torch.launch.serve`: smollm-135m with a policy
   that turns all three fusion flags on (12 requests), rwkv6-3b and
   recurrentgemma-2b (8 requests each), and mixtral-8x7b cut to 4 of its
   32 layers with the three flags on (8 requests, dense KV state, the
   moe_mlp kernel); prompts of 16-300 tokens, 32 new tokens each, 4
   slots, max_len 512; then a fifth path, smollm-135m (30 layers) with
   int8 KV on the pool route, 12 requests from the port's Zipf workload
   generator over bands that cross the 64-512 buckets: the int8
   paged_decode once a layer a decode step, the bfloat16 one never, the
   decode step on `paged_split_kernel` and not `paged_tc_kernel`, and the
   int8 pool's pages per byte against a bfloat16 pool's printed
   (`int8_path_phase`); a sixth, the cluster path: smollm-135m with the
   three flags on, 2 replicas on the card sharing one set of weights, 16
   requests from the `LoadGenerator` (Poisson at 4 a second, 2000 ms
   deadlines) under the seed-0 chaos script over 64 steps, through
   `serve_cluster` (every request done with a finish reason, none lost,
   twice or unrouted, paged_decode a layer a decode step on every engine
   that decoded, a "nan" quarantine where a nan event found a live slot;
   the aggregate and per-replica summary and the share of requests whose
   tokens equal a fault-free engine's printed; `cluster_path_phase`); a
   seventh, the spec-decode path: smollm-135m (30 layers, three flags,
   dense KV) with a 7-layer shared-trunk draft, k 4, 8 requests through
   `serve_specdec`, beside the target-only engine on the same requests
   (tokens/s, the bf16 share of equal streams) and `high_tar_pair`'s
   acceptance and tokens/s (`spec_path_phase`); then the variant archs,
   weights drawn on the card (`variant_path_phases`): h2o-danube-1.8b
   (24 layers, 6 prompts of 16-300 tokens and 2 of 4200 and 4600, past
   its 4096 window; windowed flash once a layer a prefill), qwen2-vl-2b
   (28 layers, the pool route, 8 requests; paged_decode once a layer a
   decode step; then 4 requests with int8 KV), deepseek-v3-671b cut to
   4 of its 61 layers (3 dense, 1 MoE; flash off; moe_mlp once a MoE
   layer and fused_mlp once a dense layer or shared expert a prefill and
   a decode step) and whisper-base (6 + 6 layers, 8 requests with 1500
   frames each; no kernel of the port may launch); then the training
   path (`train_path_phase`): smollm-135m at 30 layers, bf16, the three
   flags, through `repro_torch.training.loop.train` for 30 AdamW steps of
   8 x 256 SyntheticLM tokens with checkpoints every 10 steps: every loss
   finite, the last at least 1 nat below the first, the norms, the fused
   MLP and flash launched (31, 30, 30 and 30 a step) under autograd, the
   last checkpoint restored on the card bit-equal to the trained weights
   and a save / restore of the whole state bit-equal; each of one step's
   121 kernel calls held against its plain version on its own bf16
   inputs (2.5e-2), the first of each op also a timed row with its bound
   and library call; that step's loss and gradients by the kernel route
   within 1e-2 and 5e-2 (relative L2) of the plain route's; train()'s
   tokens/s between two checkpoints and over its whole run, and the step
   rate on batches already on the card (CUDA events) and its peak device
   memory by both routes, printed with the card's name and power
   limit; then serving on a mesh (`tp_path_phase`): two ranks spawned on
   the one card over gloo, a (1, 2) mesh, smollm-135m (6 of 30 layers, bf16,
   the three flags) serving the main path's 12 requests through the
   paged engine with tensor parallelism (every rank's kernel launches
   and collectives per layer per step as the sharding implies, the
   kernels at their local shapes, bf16 logits of a prefill and 3 decode
   steps within `TP_LOGITS_SLACK` of the unsharded engine's distance from
   the float32 route; tokens/s, TTFT and TPOT printed as two ranks
   sharing one card), smollm-135m (4 layers), h2o-danube-1.8b (2 layers,
   16 / 4 heads a rank) and mixtral-8x7b with EP (2 layers) in float32
   token-equal to the unsharded engine, deepseek-v3 (2 layers) with the
   shard_map MoE dispatch (its bf16 logits, at a capacity factor that
   drops no choice, within `TP_LOGITS_SLACK` of the unsharded engine's
   distance from the bf16 plain route) and mixtral-8x7b with
   moe_groups=4 on one rank (float32, no drops, token-equal to
   moe_groups=0).  Each rank draws only its blocks of the weights.  Then
   every family on that (1, 2) mesh (`family_mesh_phase`): rwkv6-3b (6
   of 32 layers, wkv6 at 20 heads), recurrentgemma-2b (4 of 26 layers, rglru_scan at
   1280 channels, flash and the fused norm, its 10 / 1 heads replicated)
   and whisper-base (6 + 6 layers, 1500-frame windows) at full width in
   bf16, 8 requests each, every rank's launches and collectives per layer
   per step as the sharding implies and bf16 logits held to
   `TP_LOGITS_SLACK`; rwkv6 and whisper at 2 layers, recurrentgemma at 3
   in float32 token-equal to the unsharded engine; spec-decode with the
   target sharded and the 7-layer draft whole on each rank (bf16, the
   one-card engine's streams compared and printed; at 8 layers in float32
   tokens and acceptance counts equal to the one-card engine's); then the
   cluster on a (2, 2) mesh of four ranks (`cluster_mesh_phase`): 2
   replicas x tp 2 of smollm-135m (6 of 30 layers, bf16, the three flags), 16
   `LoadGenerator` requests under the seed-0 chaos script, every rank
   ending with the same request records, paged_decode once a layer for
   every decode step of the rank's own replica's engines, and at 4 layers
   in float32 the same prompts as a burst under the chaos script
   token-equal to the one-card 2-replica cluster.  Launch counts are
   set to 0 just before each path
   and read just after; every kernel of the path must have run, each
   recurrent layer's kernel and each MoE layer's moe_mlp exactly once a
   prefill and once a decode step, and smollm's paged_decode once a layer
   a decode step.  Prints tokens/s, TTFT and TPOT.  After smollm's and
   mixtral's runs, on the served bfloat16 weights: the last-position
   logits of one prompt through the flash route and through the einsum
   route, both bfloat16, each against the float32 plain route; the flash
   route's max |diff| must be within 1.25x the einsum route's + 1e-3.
5. Breakdown, for each main path: the wall time of a steady decode step
   on the same engine, and from one profiled window the device's busy
   time, the heaviest kernels and the port's own kernels' time a step;
   smollm's and mixtral's (bfloat16) must run the MLP's cluster tile and
   not the float32 partial kernel, smollm's the tensor-core paged decode
   and its combine, rwkv6's the wkv6 step kernel, recurrentgemma's the
   rglru step kernel.  Then one profiled prefill (smollm's bucket 512,
   mixtral's 300 tokens, rwkv6's and recurrentgemma's 256): device time,
   flash's (wkv6's, rglru's) share and kernel count; the transformers
   must run flash_tc_kernel and not the float32 flash_fwd_kernel, rwkv6
   the three chunked wkv6 kernels, recurrentgemma the cluster scan
   (rglru_scan_kernel) and not the step kernel.  Spec-decode: one
   propose/verify iteration (4 slots) timed and profiled; the verify must
   run the MLP's cluster tile and the norm kernels
   (`spec_breakdown_phase`).  The variant paths' decode steps and one
   prefill each (danube's 4600 tokens, qwen2-vl's and deepseek's 300)
   are broken down the same way; whisper's step must run none of the
   port's kernels.

Before the closing lines, one JSON object `{"tp_path": {...}}` with the
mesh path's record and one `{"train_path": {...}}` with the training
path's numbers, the gradient checks and the op rows.  The
last two lines are one JSON object listing the kernels and one with the
device: `{"ok": true, "device": {"platform": "gpu", ...}}`.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12                 # H100 SXM
L2_BYTES = 50e6                           # H100 SXM L2
PEAK_FLOPS = {"bfloat16": 989e12,         # dense tensor-core bf16
              "float16": 989e12,          # dense tensor-core fp16
              "float32": 67e12}           # float32 outside the tensor cores
# float16: a 16-bit output rounds to 2^-11 of its size (bfloat16 2^-8);
# the MLP tile also rounds h once (the JAX kernel tests' bf16 2.5e-2 is
# for 3 fewer mantissa bits)
TOL = {"bfloat16": 2.5e-2, "float16": 1e-2}
# wkv6: sums in another order than the plain version's chunked form,
# which clips its decay exponents at -60 (o and s_final alike); paged_decode:
# the JAX paged kernel test's tolerance; moe_mlp and the wide fused_mlp rows: float32
# sums over F = 14336-27648 hidden units in another order than cuBLAS's
TOL_F32 = {"fused_rmsnorm": 1e-5, "fused_rmsnorm_residual": 1e-5,
           "fused_mlp": 1e-5, "flash_attention": 3e-5, "wkv6": 1e-4,
           "rglru_scan": 1e-5, "paged_decode": 2e-5, "moe_mlp": 1e-4,
           "paged_decode_int8": 2e-5}
TOL_F32_WIDE_MLP = 1e-4
D, F_FF, H, HKV, HD = 576, 1536, 9, 3, 64  # smollm-135m
PAGE = 16                                  # the engine's page size
DECODE_N = 4                               # the main path's slot count
WIDE = ((4096, 14336), (5120, 27648))      # mixtral-8x7b, qwen2.5-32b (d, F)
MOE_E, MOE_D, MOE_F = 8, 4096, 14336       # mixtral-8x7b experts
MX_H, MX_HKV, MX_HD, MX_WINDOW = 32, 8, 128, 4096   # mixtral-8x7b attention
MX_SEQS = (300, 4352)      # the main path's longest prompt; past the window
RWKV_H, RWKV_D = 40, 64                    # rwkv6-3b heads of 64
LRU_W = 2560                               # recurrentgemma-2b lru_width
# the port's CUDA kernels, as the profiler names them (mlp_* serve both
# fused_mlp and moe_mlp: the cluster tile and its fix-up pass for
# bfloat16, the partial / reduce pair for float32)
OWN_KERNELS = ("rmsnorm_kernel", "rmsnorm_row_kernel", "rmsnorm_wide_kernel",
               "mlp_cluster_kernel",
               "mlp_fixup_kernel", "mlp_partial_kernel", "mlp_reduce_kernel",
               "flash_tc_kernel", "flash_fwd_kernel", "paged_tc_kernel",
               "paged_split_kernel", "paged_combine_kernel", "wkv6_step_kernel",
               "wkv6_prep_kernel", "wkv6_state_kernel", "wkv6_out_kernel",
               "rglru_scan_kernel", "rglru_step_kernel")
# paged_decode rows where bytes set the bound (bf16, pages of 16, every
# slot at 2048 positions): smollm-135m (B 16, 9 / 3 heads of 64) and
# internlm2-1.8b (B 8, 16 / 8 heads of 128); and rows at head dims 80 and
# 96 (B 4, 32 / 8 and 16 / 4 heads, lengths 1-332)
PD_LONG = (("smollm-135m", 16, 9, 3, 64), ("internlm2-1.8b", 8, 16, 8, 128))
PD_LONG_LEN = 2048
PD_HEAD_DIMS = ((32, 8, 80), (16, 4, 96))
# wkv6 rows beyond the served shapes: a 1024-token prefill, Dv != D (D 64,
# Dv 32) and bfloat16 inputs (256 tokens); a bfloat16 o is held to one
# bfloat16 rounding of the plain version's (2^-7 of its size) + 1e-4
WKV_LONG_S = 1024
WKV_BF16_RTOL = 2.0 ** -7
DANUBE = (32, 8, 80, 4096, 300)            # h2o-danube-1.8b: H, Hkv, hd, window, S
FLASH_RAGGED = (2, 100)                    # a ragged batch: B, S
FLASH_E2E_SLACK = (1.25, 1e-3)             # flash route's logits error bound
MLP_NS = (1, DECODE_N, 5, 16, 256, 300)     # fused_mlp rows at smollm's width
MOE_CAPS = (8, 12, 80, 96)                 # moe_mlp capacities (decode, prefill)
MOE_EXTRA_MB = 64                          # extra device memory of a C-96 call
# rglru_scan rows (B, S, dtype) at W 2560; a bfloat16 h is held to one
# bfloat16 rounding (2^-8 of its size) of the float32 recurrence + 1e-5
LRU_ROWS = ((DECODE_N, 1, "float32"), (1, 256, "float32"), (1, 300, "float32"),
            (1, 1024, "float32"), (4, 256, "float32"), (DECODE_N, 1, "bfloat16"),
            (1, 256, "bfloat16"))
LRU_BF16_RTOL = 2.0 ** -8
# profiler windows taken for one reading at most (`profiled`)
PROFILE_TRIES = 5
# widths no served model uses (padded, split, masked or wide routes): flash (H, Hkv, hd,
# window) at S 300 -- hd 256 is recurrentgemma-2b's local attention --;
# paged decode (H, Hkv, hd); wkv6 (D, Dv); the MLP tile (d, F); norm d
WIDE_FLASH = ((16, 4, 96, None), (8, 2, 100, None), (10, 1, 256, 2048))
WIDE_FLASH_S = 300
WIDE_PAGED = ((8, 2, 100), (16, 1, 576))
WIDE_WKV = ((40, 24), (64, 256), (200, 64))
WIDE_MLP = (580, 1540)
WIDE_NORM_D = 12288
# widths past the kernels' register tiles (column splits): flash (H, Hkv,
# hd) at S 300; paged decode (H, Hkv, hd) over the smoke lengths; the
# 16-bit MLP tile (d, F) -- deepseek-v3's dense layers (d 7168, F 2048)
# and d 8192 -- as fused_mlp (N 4, 256) and as moe_mlp (E 8, C 8)
COLS_FLASH = ((8, 2, 288), (8, 2, 512))
COLS_PAGED = ((8, 2, 1152), (8, 2, 2048))
COLS_MLP = ((7168, 2048), (8192, 2048))
# the int8 pool route, q float32 and bfloat16: smollm-135m's decode (4
# slots, 16-332 positions) and internlm2-1.8b's 8 slots x 2048 positions
# (16 / 8 heads of 128); a bfloat16 output is held to one bfloat16
# rounding (2^-8 of its size) of the float32 result + 1e-5
Q8_BF16_RTOL = 2.0 ** -8
Q8_BF16_ATOL = 1e-5
Q8_ROWS = (("smollm-135m", DECODE_N, H, HKV, HD, None),
           ("internlm2-1.8b", 8, 16, 8, 128, PD_LONG_LEN),
           ("qwen2-vl-2b", DECODE_N, 12, 2, 128, None))
# the fifth path: smollm-135m with int8 KV on the pool route; its Zipf
# prompt bands cross the 64 - 512 prefill buckets, the longest band the
# most likely (Zipf weights 1/(i+1) in band order)
Q8_BANDS = ((257, 400), (129, 255), (65, 127), (40, 63))
# the cluster's float32 chaos drill (4 layers, 2 replicas, 8 requests of
# 24 tokens, watchdog stall_steps 5): (step, replica, kind), set so every
# fault lands while its replica holds work -- kill 0 (its work moves to
# 1), restart 0, stall 1 (quarantined 5 steps later, its work to 0), nan
# on 0 (quarantined; its work parks while 1 is down), restart 1 (drains
# the parked work), restart 0
DRILL = ((2, 0, "kill"), (14, 0, "restart"), (16, 1, "stall"), (24, 0, "nan"),
         (26, 1, "restart"), (30, 0, "restart"))
DRILL_STALL_STEPS = 5
# the cluster path: 16 Poisson requests at 4 a second, 2000 ms deadlines,
# the seed-0 chaos script over 64 steps (the CLI's horizon, max(16 x 32,
# 64) = 512, would put every event past the ~100 steps this trace serves)
CLUSTER_REQUESTS, CLUSTER_RATE, CLUSTER_DEADLINE_MS, CLUSTER_HORIZON = 16, 4.0, 2000.0, 64
FINISH_REASONS = ("eos", "max_new_tokens", "length", "rejected", "capacity", "shed",
                  "poison")
# the spec-decode path: smollm-135m's 30 layers, the CLI's shared-trunk
# draft of a quarter of them (7 layers), k 4
SPEC_K = 4
# serving on a mesh: 2 ranks (gloo) share the one card; a sharded MLP
# rounds its two partial sums to bfloat16 and adds them (one rounding
# more than the unsharded MLP's), so its logits may lie up to twice as
# far from the float32 route as the unsharded engine's, plus a floor
TP = 2
MESH_SMOLLM_LAYERS = 6       # smollm-135m's depth (of 30) on the serving meshes
TP_LOGITS_SLACK = (2.0, 1e-3)
# (arch, d, F / 2, N), (arch, H / 2, Hkv / 2, hd, window), (arch, E / 2, d, F, C)
TP_MLP = (("smollm-135m", 576, 768, (DECODE_N, 300)), ("h2o-danube-1.8b", 2560, 3456, (DECODE_N,)),
          ("qwen2-vl-2b", 1536, 4480, (DECODE_N,)),
          ("deepseek-v3-671b shared expert", 7168, 1024, (DECODE_N,)))
TP_FLASH = (("h2o-danube-1.8b", 16, 4, 80, 4096), ("qwen2-vl-2b", 6, 1, 128, None),
            ("mixtral-8x7b", 16, 4, 128, 4096))
TP_MOE = (("mixtral-8x7b", 4, 4096, 14336, 8), ("deepseek-v3-671b", 128, 7168, 2048, 8))
# every family, the cluster and spec-decode on a mesh (ranks share the one
# card over gloo): the float32 cut depths of the families' token checks
# (recurrentgemma's 3 layers hold its one attention layer, layer 2 at
# attn_every 3), the float32 spec-decode check (target layers, draft =
# a quarter) and the float32 cluster check's depth; the cluster path runs
# 2 replicas x tp 2 on four ranks
FAM_F32_LAYERS = (("rwkv6-3b", 2), ("recurrentgemma-2b", 3), ("whisper-base", 2))
FAM_LAYERS = {"rwkv6-3b": 6, "recurrentgemma-2b": 4}     # of 32 and 26, full width
RGLRU_KERNELS = dict(attn_impl="flash", norm_impl="fused")
SPEC_F32_LAYERS = 8
CLUSTER_MESH = (2, 2)
CLUSTER_F32_LAYERS = 4
# four ranks share the one card there: a cluster step takes ~5x the
# one-card cluster's, so its deadlines are 10x `CLUSTER_DEADLINE_MS` (at
# 2000 ms, 13 of 16 requests were shed before a token on an H100)
CLUSTER_MESH_DEADLINE_MS = 10 * CLUSTER_DEADLINE_MS
# serving with the batch over "data": world sizes of the (2, 1) and (2, 2)
# meshes, and danube's SP path (a prompt past its 4096 ring, its depth)
DATA_MESH_WORLDS = (2, 4)
DATA_SP_PROMPT = 6000
DATA_SP_LAYERS = 2
DATA_F32_LAYERS = 8         # smollm's float32 token check on the data mesh (of 30)
# the variant archs' served paths (bf16, full width, weights drawn on the card):
# h2o-danube-1.8b's prompts, 6 of 16-300 tokens and 2 past its window of
# 4096 (the ring wraps, the window cuts), and its max_len; qwen2-vl-2b's
# attention (H, Hkv, hd: group 6); the MLP tile's served widths (arch,
# d, F, the longest prompt's N); deepseek-v3-671b's experts (E, d, F), the moe_mlp capacities of
# a 4-slot decode step and of a 300-token prefill (`transformer.capacity`),
# and its depth on one card (its 3 dense layers and 1 MoE layer of 61:
# 671 B parameters do not fit 80 GB); whisper-base's encoder window (30
# s of frames) and max_len
DANUBE_LENS = (16, 57, 120, 188, 251, 300, 4200, 4600)
DANUBE_MAX_LEN = 4640
QVL_ATTN = (12, 2, 128)
VARIANT_MLP = (("h2o-danube-1.8b", 2560, 6912, DANUBE_LENS[-1]),
               ("qwen2-vl-2b", 1536, 8960, 300), ("deepseek-v3-671b", 7168, 2048, 300))
DS_MOE = (256, 7168, 2048)
DS_CAPS = (8, 16)
DS_LAYERS = 4
WHISPER_ENC = 1500
WHISPER_MAX_LEN = 256
# training (PR 21): the main training path and the gradient checks
# training on a mesh: (a) float32 layers, steps, global rows, seq;
# (b) bfloat16 steps, global rows, seq, checkpoint interval; (c) the
# pipeline's microbatches (count, rows, seq), float32 depth, gradient gap
TRAIN_MESH = (2, 2)
TRAIN_MESH_F32 = (4, 3, 4, 128)
TRAIN_MESH_BF16 = (6, 8, 256, 3)
TRAIN_MESH_BF16_LAYERS = 10  # of smollm-135m's 30
PIPE_MICRO = (4, 2, 256)
PIPE_F32_LAYERS = 4
PIPE_GRAD_TOL = 1e-4
TRAIN_STEPS = 30
TRAIN_BATCH, TRAIN_SEQ = 8, 256
TRAIN_DROP = 1.0          # nats the last logged loss must lie below the first
# one bf16 step, kernel route against plain route (30 layers): the losses'
# relative gap, and the gradient trees' gap in relative L2 norm (bf16
# rounds each op's output to 2^-8 of its size, in another place by each route)
TRAIN_BF16_LOSS_TOL = 1e-2
TRAIN_BF16_GRAD_TOL = 5e-2
GRAD_DEPTHS = (("smollm-135m", 4), ("rwkv6-3b", 2), ("recurrentgemma-2b", 3),
               ("mixtral-8x7b", 1))
GRAD_TOL = 1e-3           # a leaf's gradient: |kernels - plain| <= GRAD_TOL x max |plain| + 1e-6
GRAD_OP_TOL = 1e-5        # an op's gradient against its plain version's, the same form


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 30, warmup: int = 3) -> float:
    """Mean milliseconds of fn() over `iters` calls, by CUDA events."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def profiled(torch, fn, need=(), tries: int = PROFILE_TRIES) -> dict[str, list]:
    """{kernel name: [device microseconds, launches]} of the CUDA kernels
    that one profiler window around fn() recorded.  The profiler now and
    then records no device event in a window, at times in several windows
    in a row; such a window, or one that lacks a kernel whose name holds
    an entry of `need`, is taken again, after a pause, up to `tries`
    windows.  The last window's record is returned."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    by_name: dict[str, list] = {}
    for t in range(tries):
        if t:
            time.sleep(0.2)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        by_name = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                rec = by_name.setdefault(e.name, [0.0, 0])
                rec[0] += e.time_range.elapsed_us()
                rec[1] += 1
        if by_name and all(any(k in n for n in by_name) for k in need):
            break
    return by_name


def device_ms(torch, fn, iters: int = 10) -> float | None:
    """Mean milliseconds of device time (every CUDA kernel, by the
    profiler) that one fn() call launches: the device's share of what
    `time_ms` reads, without the host's.  None when no profiler window
    recorded a device event (not measured)."""
    fn(0)
    torch.cuda.synchronize()

    def calls():
        for i in range(iters):
            fn(i)

    us = sum(t for t, _ in profiled(torch, calls).values())
    return us / iters / 1e3 if us > 0 else None


def agreement(torch, out, ref, tol) -> tuple[float, bool]:
    """max |out - ref| over every output, and whether each output is
    finite with |out - ref| <= tol + tol * |ref|."""
    o, r = [t.float() for t in (out if isinstance(out, tuple) else (out,))], \
        [t.float() for t in (ref if isinstance(ref, tuple) else (ref,))]
    e = max(float((a - b).abs().max()) for a, b in zip(o, r))
    ok = all(bool(((a - b).abs() <= tol + tol * b.abs()).all()) and
             bool(torch.isfinite(a).all()) for a, b in zip(o, r))
    return e, ok


def bound_ms(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def ptxas_phase() -> None:
    """Print ptxas's registers and spilled bytes for each kernel of each
    source built by this process; no kernel of any source may spill."""
    from repro_torch.kernels import _build

    def readable(names):
        """Kernel names without their mangling (cu++filt, beside nvcc)."""
        tool = Path(_build.nvcc_path()).parent / "cu++filt"
        try:
            out = subprocess.run([str(tool), *names], capture_output=True,
                                 text=True, check=True, timeout=60)
        except (OSError, subprocess.SubprocessError):
            return names
        got = out.stdout.splitlines()
        if len(got) != len(names):
            return names
        names = [g.replace("(anonymous namespace)::", "")
                 .replace("<unnamed>::", "").removeprefix("void ") for g in got]
        return [g[:g.rfind("(")] if g.endswith(")") else g for g in names]

    for name in _build.SOURCES:
        usage = _build.ptxas_usage(name)
        if usage is None:
            print(f"[smoke] ptxas {name}.cu: not built by this process (its "
                  f"library was already there)", flush=True)
            continue
        check(bool(usage) and all(u["registers"] is not None and
                                  u["spill_stores"] is not None for u in usage),
              f"ptxas {name}.cu: no register report")
        print(f"[smoke] ptxas {name}.cu: " + "; ".join(
            f"{k} {u['registers']} registers, {u['spill_stores']} / "
            f"{u['spill_loads']} bytes spilled (stores / loads)"
            for k, u in zip(readable([u["kernel"] for u in usage]), usage)),
            flush=True)
        check(all(u["spill_stores"] == 0 and u["spill_loads"] == 0
                  for u in usage), f"ptxas {name}.cu: a kernel spills")


def flash_other_plan(torch, q, k, v, window, out) -> None:
    """The bfloat16 flash tile under the block size the rule did not pick
    (4 <-> 8 warps) must give `out` bit for bit (a warp's walk depends
    only on its own 16 rows); prints its device time beside the rule's
    block size."""
    from repro_torch.kernels import _attn_plan
    from repro_torch.kernels.flash_attention import kernel as fk

    b, sq, h, hd = q.shape
    _, sk, hkv, _ = k.shape
    chosen = _attn_plan.flash_plan(
        b, h, hkv, sq, hd,
        sms=torch.cuda.get_device_properties(q.device).multi_processor_count)
    other = 4 if chosen.warps == 8 else 8

    def run(i):
        return fk.launch(q, k, v, True, window, 1.0 / math.sqrt(hd), warps=other)

    got = run(0)
    check(torch.equal(got, out), f"flash {[b, sq, h, hkv, hd, window]}: {other} "
          f"warps a block differ from the rule's {chosen.warps}")
    print(json.dumps({"flash_other_plan": [b, sq, h, hkv, hd, window],
                      "warps": chosen.warps, "other_warps": other,
                      "other_device_ms": device_ms(torch, run, 10 if sq <= 512 else 3)}),
          flush=True)


def window_rows_err(q, k, v, window, out) -> float:
    """Largest |out - ref| / RMS(ref row) over the rows q >= window, the
    float32 plain version as ref: those rows average over `window` keys,
    so their values are about window ** -0.5 in size and the bfloat16
    tolerance alone would pass a wrong window edge."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    ref = flash_attention_ref(q.float(), k.float(), v.float(), window=window)[:, window:]
    rms = ref.pow(2).mean(-1, keepdim=True).sqrt().clamp_min(1e-30)
    return float(((out.float()[:, window:] - ref).abs() / rms).max())


def norm_trace(torch, ns=(DECODE_N, 256)) -> None:
    """What one bfloat16 `fused_rmsnorm` call and one `F.rms_norm` call
    launch at smollm's width (d 576, N in `ns`), by the profiler: each
    device kernel's name and microseconds.  Prints one JSON line a call.
    (Standalone against another checkout's kernels: put its `src` first
    on sys.path, import this file and call norm_trace(torch).)"""
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.fused_norm import kernel as nk

    g = torch.Generator(device="cuda").manual_seed(0)
    for n in ns:
        x = torch.randn((n, D), generator=g, device="cuda").to(torch.bfloat16)
        sc = (torch.randn((D,), generator=g, device="cuda") * 0.1).to(torch.bfloat16)
        w1 = (1.0 + sc.float()).to(torch.bfloat16)
        for name, fn in (("fused_rmsnorm", lambda: nk.fused_rmsnorm_cuda(x, sc)),
                         ("F.rms_norm", lambda: F.rms_norm(x, (D,), weight=w1, eps=1e-6))):
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            kern = [[e.name[:80], e.time_range.elapsed_us()] for e in prof.events()
                    if e.device_type == DeviceType.CUDA]
            print(json.dumps({"norm_trace": name, "shape": [n, D], "dtype": "bfloat16",
                              "kernels": kern}), flush=True)


def paged_tables(torch, lens, npp, prng):
    """Page tables (B, npp) on the card for slots of `lens` positions in
    pages of PAGE, drawn as a random permutation of pages 1..; page 0 is
    the null page.  Returns (tables, pages in the pool)."""
    pages = 1 + len(lens) * npp
    tables = torch.zeros((len(lens), npp), dtype=torch.int32)
    perm = torch.randperm(pages - 1, generator=prng) + 1
    off = 0
    for b, n_pos in enumerate(lens):
        n = -(-int(n_pos) // PAGE)
        tables[b, :n] = perm[off:off + n]
        off += n
    return tables.to("cuda"), pages


def paged_row(torch, record, dtype, q, kp, vp, tables, lens_d, extra=None):
    """One paged_decode row through `record`; returns the kernel's output.
    Bytes: q and out, the live K/V rows, the tables and lengths."""
    from repro_torch.kernels import _attn_plan
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import paged_decode_attention_ref

    b, _, h, hd = q.shape
    _, ps, hkv, _ = kp.shape
    es = q.element_size()
    live = int(lens_d.sum())
    plan = _attn_plan.paged_plan(b, h, hkv, tables.shape[1], ps, hd, es,
                                 sms=torch.cuda.get_device_properties(0).multi_processor_count)
    out = fk.paged_decode_attention_cuda(q, kp, vp, tables, lens_d)
    record("paged_decode", [b, h, hkv, hd, ps], dtype, out,
           paged_decode_attention_ref(q, kp, vp, tables, lens_d),
           lambda i: fk.paged_decode_attention_cuda(q, kp, vp, tables, lens_d),
           lambda i: paged_decode_attention_ref(q, kp, vp, tables, lens_d), None,
           (2 * b * h * hd + 2 * live * hkv * hd) * es + 4 * (tables.numel() + b),
           4 * hd * live * h,
           extra=dict(extra or {}, live_positions=live, route=plan.route,
                      splits=plan.splits, blocks=plan.blocks))
    return out


def kernel_phase(torch, F):
    """Check each kernel against its plain version and time it.  Returns
    the rows and `record`, which checks, times and appends one more."""
    from repro_torch.kernels import _build as B
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels import _mlp_plan as mplan
    from repro_torch.kernels.fused_mlp import kernel as mk
    from repro_torch.kernels.fused_mlp.ref import fused_mlp_ref
    from repro_torch.kernels.fused_norm import kernel as nk
    from repro_torch.kernels.fused_norm.ref import (fused_rmsnorm_ref,
                                                    fused_rmsnorm_residual_ref)
    from repro_torch.kernels.moe_mlp import kernel as ek
    from repro_torch.kernels.moe_mlp.ref import moe_mlp_ref
    from repro_torch.kernels.rglru_scan import kernel as gk
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
    from repro_torch.kernels.wkv6 import kernel as wk
    from repro_torch.kernels.wkv6 import ops as wops
    from repro_torch.kernels.wkv6.ref import wkv6_bshd_ref, wkv6_ref

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    dgen = torch.Generator(device=dev).manual_seed(0)
    # library yardsticks, where this PyTorch has them
    rms_norm = getattr(F, "rms_norm", None)
    sdpa_gqa = tuple(int(p) for p in torch.__version__.split(".")[:2]) >= (2, 5)
    dts = {"bfloat16": torch.bfloat16, "float32": torch.float32}

    def rand(shape, dt, scale=1.0):
        return (torch.randn(shape, generator=dgen, device=dev) * scale).to(dt)

    rows = []

    launchers = {"fused_rmsnorm": nk.RMSNORM,
                 "fused_rmsnorm_residual": nk.RMSNORM_RESIDUAL,
                 "fused_mlp": mk.MLP, "flash_attention": fk.FLASH,
                 "paged_decode": fk.PAGED, "moe_mlp": ek.MOE,
                 "wkv6": wk.WKV6, "rglru_scan": gk.SCAN,
                 "paged_decode_int8": fk.PAGED_INT8}

    def record(name, shape, dtype, out, ref, kern, plain, lib, nbytes, flops,
               tol=None, iters=30, act=None, extra=None, ops_dtype=None):
        """`out` is the kernel's first result (launched by the caller) on
        the inputs of kern(0); `launches` counts that launch and the
        event-timed ones.  The `*_device_ms` keys are profiler device
        times of the same calls; each time is the mean of `iters` calls.
        A bfloat16 MLP or flash row, and every paged_decode and wkv6 row,
        must give bit-identical outputs on a second launch (each sums in a
        fixed order, no atomics).  `ops_dtype`: the type the arithmetic
        runs in, where it is not `dtype` (its peak bounds the operations).
        A profiler reading of a call that moves more than four times the
        L2 can not beat the byte bound: one that does (a window that lost
        events) is taken again, up to PROFILE_TRIES times, else recorded as
        not measured (None) and named in `invalid_readings`."""
        tol = tol or TOL.get(dtype, TOL_F32[name])
        e, ok = agreement(torch, out, ref, tol)
        check(ok, f"{name} {shape} {dtype}: kernel disagrees with its plain "
                  f"version (max abs err {e:.3g}, tol {tol})")
        same = None
        if name in ("paged_decode", "paged_decode_int8", "wkv6", "rglru_scan") or (
                dtype in ("bfloat16", "float16") and
                name in ("fused_mlp", "moe_mlp", "flash_attention")):
            again = kern(0)
            same = all(bool(torch.equal(a, b)) for a, b in zip(
                again if isinstance(again, tuple) else (again,),
                out if isinstance(out, tuple) else (out,)))
            check(same, f"{name} {shape} {dtype}: two launches on the same "
                        f"inputs differ")
        b, by = bound_ms(nbytes, flops, ops_dtype or dtype)
        before = launchers[name].launches - 1
        kernel_ms = time_ms(torch, kern, iters)
        row = {"name": name, "shape": shape, "dtype": dtype,
               "launches": launchers[name].launches - before, "max_err": e,
               "tol": tol, "kernel_ms": kernel_ms,
               "plain_ms": time_ms(torch, plain, iters),
               "library_ms": None if lib is None else time_ms(torch, lib, iters),
               "bound_ms": b, "bound_by": by}
        if act is not None:
            row["act"] = act
        row.update(extra or {})
        if same is not None:
            row["bit_identical"] = same
        byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
        invalid = []
        for key, fn in (("kernel_device_ms", kern), ("plain_device_ms", plain),
                        ("library_device_ms", lib)):
            ms = None
            for _ in range(PROFILE_TRIES if fn is not None else 0):
                ms = device_ms(torch, fn, min(iters, 10))
                if ms is None or nbytes <= 4 * L2_BYTES or ms >= byte_ms:
                    break
                invalid.append([key, ms])
                print(f"[smoke] {name} {shape} {dtype}: {key} {ms:.4g} below the "
                      f"byte bound {byte_ms:.4g}: not a valid reading", flush=True)
                ms = None
            row[key] = ms
        if invalid:
            row["invalid_readings"] = invalid
        rows.append(row)
        print(json.dumps(row), flush=True)
        return row

    for dtype, dt in dts.items():
        es = torch.tensor([], dtype=dt).element_size()
        for n in (DECODE_N, 16, 256):
            x, r = rand((n, D), dt), rand((n, D), dt)
            sc = rand((D,), dt, 0.1)
            w1 = (1.0 + sc.float()).to(dt)
            record("fused_rmsnorm", [n, D], dtype,
                   nk.fused_rmsnorm_cuda(x, sc), fused_rmsnorm_ref(x, sc),
                   lambda i: nk.fused_rmsnorm_cuda(x, sc),
                   lambda i: fused_rmsnorm_ref(x, sc),
                   None if rms_norm is None else
                   lambda i: rms_norm(x, (D,), weight=w1, eps=1e-6),
                   (2 * n * D + D) * es, 4 * n * D)
            record("fused_rmsnorm_residual", [n, D], dtype,
                   nk.fused_rmsnorm_residual_cuda(x, r, sc),
                   fused_rmsnorm_residual_ref(x, r, sc),
                   lambda i: nk.fused_rmsnorm_residual_cuda(x, r, sc),
                   lambda i: fused_rmsnorm_residual_ref(x, r, sc), None,
                   (4 * n * D + D) * es, 5 * n * D)
        # the fused MLP at smollm's width, swiglu and GELU; weights are
        # read cold on the serving path (30 layers' worth, beyond the 50 MB
        # L2): rotate through copies that exceed it
        w_bytes = 3 * D * F_FF * es
        copies = max(1, math.ceil(64e6 / w_bytes))
        ws = [(rand((D, F_FF), dt, D ** -0.5), rand((D, F_FF), dt, D ** -0.5),
               rand((F_FF, D), dt, F_FF ** -0.5)) for _ in range(copies)]
        for n in MLP_NS:
            xm = rand((n, D), dt)
            for sw in (True, False):
                def mlp_lib(i, xm=xm, sw=sw):
                    g, u, o = ws[i % len(ws)]
                    h = F.silu(xm @ g) * (xm @ u) if sw else \
                        F.gelu(xm @ u, approximate="tanh")
                    return h @ o

                def mlp_kern(i, xm=xm, sw=sw):
                    g, u, o = ws[i % len(ws)]
                    return mk.fused_mlp_cuda(xm, g if sw else None, u, o, swiglu=sw)

                def mlp_plain(i, xm=xm, sw=sw):
                    g, u, o = ws[i % len(ws)]
                    return fused_mlp_ref(xm, g if sw else None, u, o, swiglu=sw)

                record("fused_mlp", [n, D, F_FF], dtype, mlp_kern(0), mlp_plain(0),
                       mlp_kern, mlp_plain, mlp_lib,
                       (2 * n * D + (3 if sw else 2) * D * F_FF) * es,
                       (6 if sw else 4) * n * D * F_FF,
                       act="swiglu" if sw else "gelu")
        del ws
        # flash attention: smollm's prefill buckets, a ragged batch of two,
        # mixtral-8x7b's (hd 128, 32 / 8 heads, window 4096; the longer
        # prompt runs past the window, so its mask cuts) and
        # h2o-danube-1.8b's head dim 80
        flash_shapes = [(1, s, H, HKV, HD, None) for s in (16, 128, 512)] + \
            [(FLASH_RAGGED[0], FLASH_RAGGED[1], H, HKV, HD, None)] + \
            [(1, s, MX_H, MX_HKV, MX_HD, MX_WINDOW) for s in MX_SEQS] + \
            [(1, DANUBE[4], *DANUBE[:4])]
        for b, s, h, hkv, hd, w in flash_shapes:
            q, k, v = rand((b, s, h, hd), dt), rand((b, s, hkv, hd), dt), \
                rand((b, s, hkv, hd), dt)
            # (q, k) pairs inside the causal window: min(q + 1, w) a query
            ww = w or s
            pairs = min(s, ww) * (min(s, ww) + 1) // 2 + max(0, s - ww) * ww
            lib = None
            if sdpa_gqa:
                qpos = torch.arange(s, device=dev)[:, None]
                kpos = torch.arange(s, device=dev)[None, :]
                allowed = None if w is None else (kpos <= qpos) & (kpos > qpos - w)

                def lib(i, q=q, k=k, v=v, allowed=allowed):
                    return F.scaled_dot_product_attention(
                        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                        attn_mask=allowed, is_causal=allowed is None,
                        enable_gqa=True)

            out = fk.flash_attention_cuda(q, k, v, window=w)
            extra = None
            if dtype == "bfloat16" and w and s > w:
                rel = window_rows_err(q, k, v, w, out)
                check(rel <= TOL[dtype], f"flash {[b, s, h, hkv, hd, w]}: rows past "
                      f"the window off by {rel:.3g} of their RMS (tol {TOL[dtype]})")
                extra = {"window_rows_rms_err": rel}
            record("flash_attention", [b, s, h, hkv, hd] + ([w] if w else []),
                   dtype, out, flash_attention_ref(q, k, v, window=w),
                   lambda i, q=q, k=k, v=v, w=w: fk.flash_attention_cuda(q, k, v, window=w),
                   lambda i, q=q, k=k, v=v, w=w: flash_attention_ref(q, k, v, window=w),
                   lib, (2 * b * s * h * hd + 2 * b * s * hkv * hd) * es,
                   4 * hd * pairs * h * b, iters=30 if s <= 512 else 5, extra=extra)
            if dtype == "bfloat16":
                flash_other_plan(torch, q, k, v, w, out)
            del q, k, v, out
        free(torch)

    # the norms and the fused MLP at the widths of mixtral-8x7b (d 4096)
    # and qwen2.5-32b (d 5120, F 27648); weights read cold (one copy
    # exceeds the L2)
    for dtype, dt in dts.items():
        es = torch.tensor([], dtype=dt).element_size()
        wtol = TOL.get(dtype, TOL_F32_WIDE_MLP)
        for d, f in WIDE:
            for n in (DECODE_N, 256):
                x, r = rand((n, d), dt), rand((n, d), dt)
                sc = rand((d,), dt, 0.1)
                w1 = (1.0 + sc.float()).to(dt)
                record("fused_rmsnorm", [n, d], dtype,
                       nk.fused_rmsnorm_cuda(x, sc), fused_rmsnorm_ref(x, sc),
                       lambda i, x=x, sc=sc: nk.fused_rmsnorm_cuda(x, sc),
                       lambda i, x=x, sc=sc: fused_rmsnorm_ref(x, sc),
                       None if rms_norm is None else
                       lambda i, x=x, d=d, w1=w1: rms_norm(x, (d,), weight=w1, eps=1e-6),
                       (2 * n * d + d) * es, 4 * n * d)
                record("fused_rmsnorm_residual", [n, d], dtype,
                       nk.fused_rmsnorm_residual_cuda(x, r, sc),
                       fused_rmsnorm_residual_ref(x, r, sc),
                       lambda i, x=x, r=r, sc=sc: nk.fused_rmsnorm_residual_cuda(x, r, sc),
                       lambda i, x=x, r=r, sc=sc: fused_rmsnorm_residual_ref(x, r, sc),
                       None, (4 * n * d + d) * es, 5 * n * d)
                xm = rand((n, d), dt)
                wg, wi, wo = rand((d, f), dt, d ** -0.5), rand((d, f), dt, d ** -0.5), \
                    rand((f, d), dt, f ** -0.5)
                record("fused_mlp", [n, d, f], dtype,
                       mk.fused_mlp_cuda(xm, wg, wi, wo), fused_mlp_ref(xm, wg, wi, wo),
                       lambda i, a=(xm, wg, wi, wo): mk.fused_mlp_cuda(*a),
                       lambda i, a=(xm, wg, wi, wo): fused_mlp_ref(*a),
                       lambda i, xm=xm, wg=wg, wi=wi, wo=wo:
                           (F.silu(xm @ wg) * (xm @ wi)) @ wo,
                       (2 * n * d + 3 * d * f) * es, 6 * n * d * f, wtol)
                del wg, wi, wo
        free(torch)

    # paged decode at smollm's decode shape: 4 slots of 16-332 tokens in
    # pages of 16, one layer's slice of a 2-layer pool; then the null page
    # and every position past a slot's length poisoned, which must leave
    # the kernel's output bit for bit unchanged
    prng = torch.Generator().manual_seed(5)
    lens = torch.randint(16, 333, (DECODE_N,), generator=prng)
    lens[0] = 332
    npp = 512 // PAGE
    tables, pages = paged_tables(torch, lens.tolist(), npp, prng)
    lens_d = lens.to(dev, torch.int32)
    for dtype, dt in dts.items():
        q = rand((DECODE_N, 1, H, HD), dt)
        kpool, vpool = rand((2, pages, PAGE, HKV, HD), dt), rand((2, pages, PAGE, HKV, HD), dt)
        kp, vp = kpool[1], vpool[1]
        out = paged_row(torch, record, dtype, q, kp, vp, tables, lens_d)
        kp[0], vp[0] = 1e4, -1e4
        for b in range(DECODE_N):
            last = int(tables[b, (int(lens[b]) - 1) // PAGE])
            kp[last, (int(lens[b]) - 1) % PAGE + 1:] = -1e4
            vp[last, (int(lens[b]) - 1) % PAGE + 1:] = 1e4
        poisoned = fk.paged_decode_attention_cuda(q, kp, vp, tables, lens_d)
        check(torch.equal(poisoned, out), f"paged_decode {dtype}: the null page "
              f"or positions past the lengths leaked into the output")
        print(f"[smoke] paged_decode {dtype}: output unchanged with the null "
              f"page and positions past the lengths poisoned", flush=True)
        del q, kpool, vpool, kp, vp
    # head dims 80 and 96 at the same lengths, both dtypes
    for h, hkv, hd in PD_HEAD_DIMS:
        for dtype, dt in dts.items():
            q = rand((DECODE_N, 1, h, hd), dt)
            kp, vp = rand((pages, PAGE, hkv, hd), dt), rand((pages, PAGE, hkv, hd), dt)
            paged_row(torch, record, dtype, q, kp, vp, tables, lens_d)
            del q, kp, vp
    # where bytes set the bound: every slot at 2048 positions, bf16
    for arch, b, h, hkv, hd in PD_LONG:
        ll = [PD_LONG_LEN] * b
        npl = PD_LONG_LEN // PAGE
        tl, pl = paged_tables(torch, ll, npl, prng)
        q = rand((b, 1, h, hd), torch.bfloat16)
        kp, vp = rand((pl, PAGE, hkv, hd), torch.bfloat16), rand((pl, PAGE, hkv, hd), torch.bfloat16)
        paged_row(torch, record, "bfloat16", q, kp, vp, tl,
                  torch.tensor(ll, dtype=torch.int32, device=dev), extra={"arch": arch})
        del q, kp, vp
    free(torch)

    # moe_mlp at mixtral's shapes, bfloat16: a decode step's capacity
    # buffers (the floor of 8 slots, and 12), a 256-token prefill's (80)
    # and a 300-token one's (96); then a GELU row.  At capacity 96 the
    # call's extra peak device memory (beyond its output) is read.
    dt, es = torch.bfloat16, 2
    wg, wi = rand((MOE_E, MOE_D, MOE_F), dt, MOE_D ** -0.5), \
        rand((MOE_E, MOE_D, MOE_F), dt, MOE_D ** -0.5)
    wo = rand((MOE_E, MOE_F, MOE_D), dt, MOE_F ** -0.5)
    print(f"[smoke] moe_mlp bf16 plans (clusters the card holds at once, "
          f"from the occupancy query): " + "; ".join(
              f"C {cap}: {mplan.launch_plan('moe_mlp', MOE_E, cap, MOE_D, MOE_F, 'bfloat16', True)}"
              for cap in MOE_CAPS), flush=True)
    for cap, sw in [(c, True) for c in MOE_CAPS] + [(8, False)]:
        xe = rand((MOE_E, cap, MOE_D), dt)
        g = wg if sw else None

        def moe_lib(i, xe=xe, sw=sw):
            h = F.silu(torch.bmm(xe, wg)) * torch.bmm(xe, wi) if sw else \
                F.gelu(torch.bmm(xe, wi), approximate="tanh")
            return torch.bmm(h, wo)

        if cap == MOE_CAPS[-1]:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        out = ek.moe_mlp_cuda(xe, g, wi, wo, swiglu=sw)
        if cap == MOE_CAPS[-1]:
            torch.cuda.synchronize()
            extra = torch.cuda.max_memory_allocated() - base - out.numel() * es
            print(f"[smoke] moe_mlp C {cap} bf16: extra peak device memory of "
                  f"one call {extra / 1e6:.3f} MB (limit {MOE_EXTRA_MB} MB)",
                  flush=True)
            check(extra <= MOE_EXTRA_MB * 1e6, f"moe_mlp C {cap}: {extra} bytes "
                  f"of device memory beside the output")
        record("moe_mlp", [MOE_E, cap, MOE_D, MOE_F], "bfloat16", out,
               moe_mlp_ref(xe, g, wi, wo, swiglu=sw),
               lambda i, xe=xe, g=g, sw=sw: ek.moe_mlp_cuda(xe, g, wi, wo, swiglu=sw),
               lambda i, xe=xe, g=g, sw=sw: moe_mlp_ref(xe, g, wi, wo, swiglu=sw),
               moe_lib,
               (2 * MOE_E * cap * MOE_D + (3 if sw else 2) * MOE_E * MOE_D * MOE_F) * es,
               (6 if sw else 4) * MOE_E * cap * MOE_D * MOE_F,
               iters=30 if cap <= 16 else 10, act="swiglu" if sw else "gelu")
        if cap == MOE_CAPS[-1]:
            rows[-1]["extra_peak_mb"] = extra / 1e6
        del xe, out
    del wg, wi, wo
    free(torch)

    # recurrent kernels, float32 as the models call them: decode (four
    # slots, one token) and one prefill of 256 tokens
    f32 = torch.float32
    for bh, s in ((DECODE_N * RWKV_H, 1), (RWKV_H, 256)):
        r, k, v = (rand((bh, s, RWKV_D), f32, 0.5) for _ in range(3))
        logw = torch.log(torch.exp(-torch.exp(
            rand((bh, s, RWKV_D), f32).clamp(-1.0, 1.0))).clamp(min=1e-12))
        u = rand((bh, 1, RWKV_D), f32, 0.1)
        s0 = rand((bh, RWKV_D, RWKV_D), f32, 0.1)

        def wkv_kern(i, r=r, k=k, v=v, logw=logw, u=u, s0=s0):
            return wops.wkv6(r, k, v, logw, u, s0)      # CUDA tensors: the kernel

        def wkv_plain(i, r=r, k=k, v=v, logw=logw, u=u, s0=s0):
            return wkv6_ref(r, k, v, logw, u, s0, chunk=32)

        record("wkv6", [bh, s, RWKV_D], "float32", wkv_kern(0), wkv_plain(0),
               wkv_kern, wkv_plain, None,
               4 * (5 * bh * s * RWKV_D + 2 * bh * RWKV_D ** 2),
               4 * bh * s * RWKV_D ** 2)
    # the model layout that `rwkv6.time_mix` passes: (B, S, H, D) views of
    # (B, S, H*D) projections (time stride H*D), u (H, D), s0 (B, H, D, Dv);
    # then a 1024-token prefill, Dv != D and bfloat16 inputs
    for b, s, dv, dtype in ((DECODE_N, 1, RWKV_D, "float32"), (1, 256, RWKV_D, "float32"),
                            (1, WKV_LONG_S, RWKV_D, "float32"), (1, 256, RWKV_D // 2, "float32"),
                            (DECODE_N, 1, RWKV_D, "bfloat16"), (1, 256, RWKV_D, "bfloat16")):
        dt = dts[dtype]
        shape = (b, s, RWKV_H, RWKV_D)
        r, k = (rand((b, s, RWKV_H * RWKV_D), f32, 0.5).to(dt).reshape(shape)
                for _ in range(2))
        v = rand((b, s, RWKV_H * dv), f32, 0.5).to(dt).reshape(b, s, RWKV_H, dv)
        logw = torch.log(torch.exp(-torch.exp(
            rand((b, s, RWKV_H * RWKV_D), f32).clamp(-1.0, 1.0))).clamp(
                min=1e-12)).to(dt).reshape(shape)
        u = rand((RWKV_H, RWKV_D), f32, 0.1)
        s0 = rand((b, RWKV_H, RWKV_D, dv), f32, 0.1)

        def bshd_kern(i, r=r, k=k, v=v, logw=logw, u=u, s0=s0):
            return wops.wkv6_bshd(r, k, v, logw, u, s0)

        def bshd_plain(i, r=r, k=k, v=v, logw=logw, u=u, s0=s0):
            return wkv6_bshd_ref(r, k, v, logw, u, s0, chunk=32)

        out, ref = bshd_kern(0), bshd_plain(0)
        if dtype == "bfloat16":
            tol = TOL_F32["wkv6"]
            ok = bool(((out[0].float() - ref[0].float()).abs()
                       <= tol + WKV_BF16_RTOL * ref[0].float().abs()).all()) and \
                bool(((out[1] - ref[1]).abs() <= tol + tol * ref[1].abs()).all())
            check(ok, f"wkv6 {list(shape)} bf16: o beyond one bfloat16 rounding "
                      f"or s_final beyond {tol} of the plain version")
        bh = b * RWKV_H
        es = torch.tensor([], dtype=dt).element_size()
        record("wkv6", list(shape) + ([dv] if dv != RWKV_D else []), dtype, out, ref,
               bshd_kern, bshd_plain, None,
               es * bh * s * (3 * RWKV_D + 2 * dv)
               + 4 * (RWKV_H * RWKV_D + 2 * bh * RWKV_D * dv),
               4 * bh * s * RWKV_D * dv, iters=30 if s <= 256 else 10)
        del r, k, v, logw, out, ref
    # rglru_scan at recurrentgemma-2b's width: decode (B 4) and prefills of
    # 256, 300 (the path's longest prompt) and 1024 tokens and B 4 x 256,
    # float32 as the model calls it; then bfloat16 a, b and h0 (h comes out
    # in bfloat16, held to one bfloat16 rounding of the float32
    # recurrence).  Prefill rows must run the cluster kernel, decode the
    # step kernel.
    for b, s, dtype in LRU_ROWS:
        dt = dts[dtype]
        a = torch.rand((b, s, LRU_W), generator=gen).to(dev).to(dt)
        x, h0 = rand((b, s, LRU_W), dt), rand((b, LRU_W), dt)
        want = "rglru_step_kernel" if s == 1 else "rglru_scan_kernel"
        before = dict(gk.kernel_launches)
        out = gk.rglru_scan_cuda(a, x, h0)
        ran = [k for k, n in gk.kernel_launches.items() if n != before[k]]
        check(ran == [want], f"rglru_scan {[b, s, LRU_W]} {dtype}: the C entry "
                             f"reports {ran}, not {want}")
        names = kernel_names(torch, lambda: gk.rglru_scan_cuda(a, x, h0), want)
        check(not names or any(want in n for n in names),
              f"rglru_scan {[b, s, LRU_W]} {dtype}: the profiler saw {names}, "
              f"not {want}")
        if not names:
            print(f"[smoke] rglru_scan {[b, s, LRU_W]} {dtype}: no profiler window "
                  f"recorded a device event; the kernel is the C entry's report",
                  flush=True)
        if dtype == "bfloat16":
            r32 = rglru_scan_ref(a.float(), x.float(), h0.float())
            tol = TOL_F32["rglru_scan"]
            check(out.dtype == torch.bfloat16 and bool(
                ((out.float() - r32).abs() <= tol + LRU_BF16_RTOL * r32.abs()).all()),
                f"rglru_scan {[b, s, LRU_W]} bf16: h beyond one bfloat16 rounding "
                f"of the float32 recurrence")
        plan = gk.launch_plan(b, s, LRU_W, B.DTYPE_CODES[dt], B.DTYPE_CODES[dt], 0)
        es = a.element_size()
        # reads a, b and h0, writes h (no final-state output)
        record("rglru_scan", [b, s, LRU_W], dtype, out, rglru_scan_ref(a, x, h0),
               lambda i, a=a, x=x, h0=h0: gk.rglru_scan_cuda(a, x, h0),
               lambda i, a=a, x=x, h0=h0: rglru_scan_ref(a, x, h0), None,
               es * (3 * b * s * LRU_W + b * LRU_W), 2 * b * s * LRU_W,
               iters=30 if s <= 300 else 10,
               extra={"route": plan.route, "cluster": plan.cluster,
                      "chunk": plan.chunk, "blocks": plan.blocks})
        del a, x, h0, out
    widths_rows(torch, record, rand, dts, F)
    float16_rows(torch, record, rand, F)
    column_split_rows(torch, record, rand, dts, F)
    int8_paged_rows(torch, record, rand)
    nan_paged_rows(torch, rand)
    variant_rows(torch, record, rand, F)
    tp_rows(torch, record, rand, F)
    return rows, record


def widths_rows(torch, record, rand, dts, F) -> None:
    """Every ported op at widths its JAX kernel takes and no served model
    uses (padded, split, masked or wide routes), each against its plain
    version:
    flash hd 96, 100 (zero-padded to 128) and 256 (recurrentgemma-2b's
    local attention), paged decode hd 100 (its last lane chunk masked,
    rows read value by value in bfloat16) and 576 (deepseek-v3's absorbed
    latent), wkv6 (D, Dv) = (40, 24), (64, 256) and (200, 64), the bfloat16
    MLP tile at d 580, F 1540 (fused and MoE), the norms at d 12288.  Where
    a native route exists, a native width forced through the padding must
    give the native route's bits: flash hd 64 run at 80, the fused MLP's d
    576 run at 584."""
    from repro_torch.kernels import _attn_plan
    from repro_torch.kernels import _mlp_plan as mplan
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.fused_mlp import kernel as mk
    from repro_torch.kernels.fused_mlp.ref import fused_mlp_ref
    from repro_torch.kernels.fused_norm import kernel as nk
    from repro_torch.kernels.fused_norm.ref import (fused_rmsnorm_ref,
                                                    fused_rmsnorm_residual_ref)
    from repro_torch.kernels.moe_mlp import kernel as ek
    from repro_torch.kernels.moe_mlp.ref import moe_mlp_ref
    from repro_torch.kernels.wkv6 import ops as wops
    from repro_torch.kernels.wkv6.ref import wkv6_bshd_ref

    f32 = torch.float32
    s = WIDE_FLASH_S
    for h, hkv, hd, w in WIDE_FLASH:
        for dtype, dt in dts.items():
            es = torch.tensor([], dtype=dt).element_size()
            q, k, v = rand((1, s, h, hd), dt), rand((1, s, hkv, hd), dt), \
                rand((1, s, hkv, hd), dt)
            ww = w or s
            pairs = min(s, ww) * (min(s, ww) + 1) // 2 + max(0, s - ww) * ww
            record("flash_attention", [1, s, h, hkv, hd] + ([w] if w else []), dtype,
                   fk.flash_attention_cuda(q, k, v, window=w),
                   flash_attention_ref(q, k, v, window=w),
                   lambda i, q=q, k=k, v=v, w=w: fk.flash_attention_cuda(q, k, v, window=w),
                   lambda i, q=q, k=k, v=v, w=w: flash_attention_ref(q, k, v, window=w),
                   None, (2 * s * h * hd + 2 * s * hkv * hd) * es, 4 * hd * pairs * h,
                   iters=10, extra={"runs_at_hd": _attn_plan.padded_head_dim(hd)})
            del q, k, v
    for dtype, dt in dts.items():               # hd 64 forced through the padding
        q, k, v = rand((1, 128, H, HD), dt), rand((1, 128, HKV, HD), dt), \
            rand((1, 128, HKV, HD), dt)
        native = fk.flash_attention_cuda(q, k, v)
        padded = fk.padded_flash(q, k, v, causal=True, window=None, hd_to=80)
        check(torch.equal(native, padded), f"flash hd {HD} {dtype}: the padded "
              f"route (run at hd 80) differs from the native route's bits")
        print(json.dumps({"padded_route_bits": "flash_attention", "shape": [1, 128, H, HKV, HD],
                          "runs_at_hd": 80, "dtype": dtype, "equal": True}), flush=True)
    # paged decode at the smoke lengths (4 slots of 16-332 positions)
    prng = torch.Generator().manual_seed(6)
    lens = torch.randint(16, 333, (DECODE_N,), generator=prng)
    npp = 512 // PAGE
    tables, pages = paged_tables(torch, lens.tolist(), npp, prng)
    lens_d = lens.to("cuda", torch.int32)
    for h, hkv, hd in WIDE_PAGED:
        for dtype, dt in dts.items():
            q = rand((DECODE_N, 1, h, hd), dt)
            kp, vp = rand((pages, PAGE, hkv, hd), dt), rand((pages, PAGE, hkv, hd), dt)
            paged_row(torch, record, dtype, q, kp, vp, tables, lens_d)
            del q, kp, vp
    # wkv6 in the model layout, float32, a 256-token prefill
    for d, dv in WIDE_WKV:
        b, hh, sw = 1, RWKV_H, 256
        r, k = (rand((b, sw, hh, d), f32, 0.5) for _ in range(2))
        v = rand((b, sw, hh, dv), f32, 0.5)
        logw = torch.log(torch.exp(-torch.exp(rand((b, sw, hh, d), f32).clamp(-1.0, 1.0)))
                         .clamp(min=1e-12))
        u, s0 = rand((hh, d), f32, 0.1), rand((b, hh, d, dv), f32, 0.1)
        record("wkv6", [b, sw, hh, d, dv], "float32", wops.wkv6_bshd(r, k, v, logw, u, s0),
               wkv6_bshd_ref(r, k, v, logw, u, s0, chunk=32),
               lambda i, a=(r, k, v, logw, u, s0): wops.wkv6_bshd(*a),
               lambda i, a=(r, k, v, logw, u, s0): wkv6_bshd_ref(*a, chunk=32), None,
               4 * (b * sw * hh * (3 * d + 2 * dv) + hh * d + 2 * b * hh * d * dv),
               4 * b * hh * sw * d * dv, iters=10)
        del r, k, v, logw, u, s0
    # the bfloat16 MLP tile at d 580, F 1540 (zero-padded to 584, 1544)
    bf = torch.bfloat16
    d, f = WIDE_MLP
    wg, wi, wo = rand((d, f), bf, d ** -0.5), rand((d, f), bf, d ** -0.5), \
        rand((f, d), bf, f ** -0.5)
    for n in (DECODE_N, 256):
        xm = rand((n, d), bf)
        record("fused_mlp", [n, d, f], "bfloat16", mk.fused_mlp_cuda(xm, wg, wi, wo),
               fused_mlp_ref(xm, wg, wi, wo),
               lambda i, xm=xm: mk.fused_mlp_cuda(xm, wg, wi, wo),
               lambda i, xm=xm: fused_mlp_ref(xm, wg, wi, wo),
               lambda i, xm=xm: (F.silu(xm @ wg) * (xm @ wi)) @ wo,
               (2 * n * d + 3 * d * f) * 2, 6 * n * d * f, iters=10,
               extra={"runs_at": list(mplan.tile_widths(d, f))})
    xe = rand((MOE_E, 8, d), bf)
    ewg, ewi, ewo = rand((MOE_E, d, f), bf, d ** -0.5), rand((MOE_E, d, f), bf, d ** -0.5), \
        rand((MOE_E, f, d), bf, f ** -0.5)
    record("moe_mlp", [MOE_E, 8, d, f], "bfloat16", ek.moe_mlp_cuda(xe, ewg, ewi, ewo),
           moe_mlp_ref(xe, ewg, ewi, ewo),
           lambda i: ek.moe_mlp_cuda(xe, ewg, ewi, ewo),
           lambda i: moe_mlp_ref(xe, ewg, ewi, ewo), None,
           (2 * MOE_E * 8 * d + 3 * MOE_E * d * f) * 2, 6 * MOE_E * 8 * d * f, iters=10,
           extra={"runs_at": list(mplan.tile_widths(d, f))})
    del wg, wi, wo, xe, ewg, ewi, ewo
    x = rand((DECODE_N, D), bf)                  # d 576 forced through the padding
    wg, wi, wo = rand((D, F_FF), bf, D ** -0.5), rand((D, F_FF), bf, D ** -0.5), \
        rand((F_FF, D), bf, F_FF ** -0.5)
    native = mk.fused_mlp_cuda(x, wg, wi, wo)
    padded = mplan.padded_call(mk.launch, x, wg, wi, wo, D + 8, F_FF)
    check(torch.equal(native, padded), f"fused_mlp d {D} bf16: the padded route (run "
          f"at d {D + 8}) differs from the native route's bits")
    print(json.dumps({"padded_route_bits": "fused_mlp", "shape": [DECODE_N, D, F_FF],
                      "runs_at": [D + 8, F_FF], "dtype": "bfloat16", "equal": True}),
          flush=True)
    # the norms past the widest row held in registers
    dw = WIDE_NORM_D
    for dtype, dt in dts.items():
        es = torch.tensor([], dtype=dt).element_size()
        for n in (DECODE_N, 256):
            x, r = rand((n, dw), dt), rand((n, dw), dt)
            sc = rand((dw,), dt, 0.1)
            w1 = (1.0 + sc.float()).to(dt)
            rms_norm = getattr(F, "rms_norm", None)
            record("fused_rmsnorm", [n, dw], dtype, nk.fused_rmsnorm_cuda(x, sc),
                   fused_rmsnorm_ref(x, sc),
                   lambda i, x=x, sc=sc: nk.fused_rmsnorm_cuda(x, sc),
                   lambda i, x=x, sc=sc: fused_rmsnorm_ref(x, sc),
                   None if rms_norm is None else
                   lambda i, x=x, w1=w1: rms_norm(x, (dw,), weight=w1, eps=1e-6),
                   (2 * n * dw + dw) * es, 4 * n * dw, iters=10)
            record("fused_rmsnorm_residual", [n, dw], dtype,
                   nk.fused_rmsnorm_residual_cuda(x, r, sc),
                   fused_rmsnorm_residual_ref(x, r, sc),
                   lambda i, x=x, r=r, sc=sc: nk.fused_rmsnorm_residual_cuda(x, r, sc),
                   lambda i, x=x, r=r, sc=sc: fused_rmsnorm_residual_ref(x, r, sc),
                   None, (4 * n * dw + dw) * es, 5 * n * dw, iters=10)
    free(torch)


def float16_rows(torch, record, rand, F) -> None:
    """One float16 row per kernel at its served shape, each against its
    plain version (float16 in, float32 math, float16 out; the MLP tile and
    flash also bit-identical across two launches): the norms and the fused
    MLP at smollm's width (N 4), flash over smollm's 512-token bucket,
    paged decode at smollm's decode shape, moe_mlp at mixtral's decode
    capacity (C 8), rglru_scan at decode (B 4) and a 256-token prefill,
    wkv6 at decode (B 4) and a 256-token prefill."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.fused_mlp import kernel as mk
    from repro_torch.kernels.fused_mlp.ref import fused_mlp_ref
    from repro_torch.kernels.fused_norm import kernel as nk
    from repro_torch.kernels.fused_norm.ref import (fused_rmsnorm_ref,
                                                    fused_rmsnorm_residual_ref)
    from repro_torch.kernels.moe_mlp import kernel as ek
    from repro_torch.kernels.moe_mlp.ref import moe_mlp_ref
    from repro_torch.kernels.rglru_scan import kernel as gk
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
    from repro_torch.kernels.wkv6 import ops as wops
    from repro_torch.kernels.wkv6.ref import wkv6_bshd_ref

    h16, es, n = torch.float16, 2, DECODE_N
    rms_norm = getattr(F, "rms_norm", None)
    x, r = rand((n, D), h16), rand((n, D), h16)
    sc = rand((D,), h16, 0.1)
    w1 = (1.0 + sc.float()).to(h16)
    record("fused_rmsnorm", [n, D], "float16", nk.fused_rmsnorm_cuda(x, sc),
           fused_rmsnorm_ref(x, sc), lambda i: nk.fused_rmsnorm_cuda(x, sc),
           lambda i: fused_rmsnorm_ref(x, sc),
           None if rms_norm is None else lambda i: rms_norm(x, (D,), weight=w1, eps=1e-6),
           (2 * n * D + D) * es, 4 * n * D)
    record("fused_rmsnorm_residual", [n, D], "float16",
           nk.fused_rmsnorm_residual_cuda(x, r, sc), fused_rmsnorm_residual_ref(x, r, sc),
           lambda i: nk.fused_rmsnorm_residual_cuda(x, r, sc),
           lambda i: fused_rmsnorm_residual_ref(x, r, sc), None,
           (4 * n * D + D) * es, 5 * n * D)
    wg, wi, wo = rand((D, F_FF), h16, D ** -0.5), rand((D, F_FF), h16, D ** -0.5), \
        rand((F_FF, D), h16, F_FF ** -0.5)
    xm = rand((n, D), h16)
    record("fused_mlp", [n, D, F_FF], "float16", mk.fused_mlp_cuda(xm, wg, wi, wo),
           fused_mlp_ref(xm, wg, wi, wo), lambda i: mk.fused_mlp_cuda(xm, wg, wi, wo),
           lambda i: fused_mlp_ref(xm, wg, wi, wo),
           lambda i: (F.silu(xm @ wg) * (xm @ wi)) @ wo,
           (2 * n * D + 3 * D * F_FF) * es, 6 * n * D * F_FF)
    s = 512
    q, k, v = rand((1, s, H, HD), h16), rand((1, s, HKV, HD), h16), rand((1, s, HKV, HD), h16)
    lib = None
    if tuple(int(p) for p in torch.__version__.split(".")[:2]) >= (2, 5):
        def lib(i):
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, enable_gqa=True)
    record("flash_attention", [1, s, H, HKV, HD], "float16",
           fk.flash_attention_cuda(q, k, v), flash_attention_ref(q, k, v),
           lambda i: fk.flash_attention_cuda(q, k, v), lambda i: flash_attention_ref(q, k, v),
           lib, (2 * s * H * HD + 2 * s * HKV * HD) * es, 4 * HD * s * (s + 1) // 2 * H)
    prng = torch.Generator().manual_seed(5)
    lens = torch.randint(16, 333, (n,), generator=prng)
    tables, pages = paged_tables(torch, lens.tolist(), 512 // PAGE, prng)
    q = rand((n, 1, H, HD), h16)
    kp, vp = rand((pages, PAGE, HKV, HD), h16), rand((pages, PAGE, HKV, HD), h16)
    paged_row(torch, record, "float16", q, kp, vp, tables, lens.to("cuda", torch.int32))
    del q, k, v, kp, vp
    ewg, ewi = (rand((MOE_E, MOE_D, MOE_F), h16, MOE_D ** -0.5) for _ in range(2))
    ewo = rand((MOE_E, MOE_F, MOE_D), h16, MOE_F ** -0.5)
    xe = rand((MOE_E, 8, MOE_D), h16)
    record("moe_mlp", [MOE_E, 8, MOE_D, MOE_F], "float16", ek.moe_mlp_cuda(xe, ewg, ewi, ewo),
           moe_mlp_ref(xe, ewg, ewi, ewo), lambda i: ek.moe_mlp_cuda(xe, ewg, ewi, ewo),
           lambda i: moe_mlp_ref(xe, ewg, ewi, ewo),
           lambda i: torch.bmm(F.silu(torch.bmm(xe, ewg)) * torch.bmm(xe, ewi), ewo),
           (2 * MOE_E * 8 * MOE_D + 3 * MOE_E * MOE_D * MOE_F) * es,
           6 * MOE_E * 8 * MOE_D * MOE_F, iters=10)
    del ewg, ewi, ewo, xe
    free(torch)
    for b, sl in ((n, 1), (1, 256)):
        a = torch.rand((b, sl, LRU_W), device="cuda").to(h16)
        xr, h0 = rand((b, sl, LRU_W), h16), rand((b, LRU_W), torch.float32)
        record("rglru_scan", [b, sl, LRU_W], "float16", gk.rglru_scan_cuda(a, xr, h0),
               rglru_scan_ref(a, xr, h0), lambda i: gk.rglru_scan_cuda(a, xr, h0),
               lambda i: rglru_scan_ref(a, xr, h0), None,
               es * 3 * b * sl * LRU_W + 4 * b * LRU_W, 2 * b * sl * LRU_W)
    for b, sl in ((n, 1), (1, 256)):
        hh, d = RWKV_H, RWKV_D
        rr, kk, vv = (rand((b, sl, hh, d), h16, 0.5) for _ in range(3))
        logw = torch.log(torch.exp(-torch.exp(rand((b, sl, hh, d), torch.float32)
                                              .clamp(-1.0, 1.0))).clamp(min=1e-12)).to(h16)
        u, s0 = rand((hh, d), torch.float32, 0.1), rand((b, hh, d, d), torch.float32, 0.1)
        args = (rr, kk, vv, logw, u, s0)
        record("wkv6", [b, sl, hh, d], "float16", wops.wkv6_bshd(*args),
               wkv6_bshd_ref(*args, chunk=32), lambda i: wops.wkv6_bshd(*args),
               lambda i: wkv6_bshd_ref(*args, chunk=32), None,
               es * b * sl * hh * 5 * d + 4 * (hh * d + 2 * b * hh * d * d),
               4 * b * hh * sl * d * d, iters=10)
    free(torch)


def column_split_rows(torch, record, rand, dts, F) -> None:
    """The widths past the kernels' register tiles, each on its column
    split against its plain version (and, in bfloat16, bit-identical across
    two launches): flash hd 288 and 512 at S 300 (blocks of 256 output
    columns), paged decode hd 1152 and 2048 at the smoke lengths (blocks
    of 1024), the bfloat16 MLP tile at d 7168 and 8192, F 2048 (groups of
    at most 6144 output columns), as fused_mlp (N 4, 256) and as moe_mlp
    (E 8, C 8)."""
    from repro_torch.kernels import _attn_plan
    from repro_torch.kernels import _mlp_plan as mplan
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.fused_mlp import kernel as mk
    from repro_torch.kernels.fused_mlp.ref import fused_mlp_ref
    from repro_torch.kernels.moe_mlp import kernel as ek
    from repro_torch.kernels.moe_mlp.ref import moe_mlp_ref

    s = WIDE_FLASH_S
    sdpa = tuple(int(p) for p in torch.__version__.split(".")[:2]) >= (2, 5)
    for h, hkv, hd in COLS_FLASH:
        for dtype, dt in dts.items():
            es = torch.tensor([], dtype=dt).element_size()
            q, k, v = rand((1, s, h, hd), dt), rand((1, s, hkv, hd), dt), \
                rand((1, s, hkv, hd), dt)

            def lib(i, q=q, k=k, v=v):
                return F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    is_causal=True, enable_gqa=True)

            record("flash_attention", [1, s, h, hkv, hd], dtype,
                   fk.flash_attention_cuda(q, k, v), flash_attention_ref(q, k, v),
                   lambda i, q=q, k=k, v=v: fk.flash_attention_cuda(q, k, v),
                   lambda i, q=q, k=k, v=v: flash_attention_ref(q, k, v),
                   lib if sdpa else None,
                   (2 * s * h * hd + 2 * s * hkv * hd) * es, 4 * hd * s * (s + 1) // 2 * h,
                   iters=10, extra={"column_blocks": _attn_plan.flash_column_blocks(hd)})
            del q, k, v
    prng = torch.Generator().manual_seed(6)
    lens = torch.randint(16, 333, (DECODE_N,), generator=prng)
    tables, pages = paged_tables(torch, lens.tolist(), 512 // PAGE, prng)
    lens_d = lens.to("cuda", torch.int32)
    for h, hkv, hd in COLS_PAGED:
        for dtype, dt in dts.items():
            q = rand((DECODE_N, 1, h, hd), dt)
            kp, vp = rand((pages, PAGE, hkv, hd), dt), rand((pages, PAGE, hkv, hd), dt)
            paged_row(torch, record, dtype, q, kp, vp, tables, lens_d,
                      extra={"column_blocks": -(-hd // _attn_plan.PAGED_COL_BLOCK)})
            del q, kp, vp
    bf = torch.bfloat16
    for d, f in COLS_MLP:
        plan = mplan.mlp_plan(1, DECODE_N, d, f, "bfloat16")
        wg, wi, wo = rand((d, f), bf, d ** -0.5), rand((d, f), bf, d ** -0.5), \
            rand((f, d), bf, f ** -0.5)
        for n in (DECODE_N, 256):
            xm = rand((n, d), bf)
            record("fused_mlp", [n, d, f], "bfloat16", mk.fused_mlp_cuda(xm, wg, wi, wo),
                   fused_mlp_ref(xm, wg, wi, wo),
                   lambda i, xm=xm: mk.fused_mlp_cuda(xm, wg, wi, wo),
                   lambda i, xm=xm: fused_mlp_ref(xm, wg, wi, wo),
                   lambda i, xm=xm: (F.silu(xm @ wg) * (xm @ wi)) @ wo,
                   (2 * n * d + 3 * d * f) * 2, 6 * n * d * f, iters=10,
                   extra={"column_groups": plan.groups, "group_cols": plan.gcols})
        del wg, wi, wo
        ewg, ewi = (rand((MOE_E, d, f), bf, d ** -0.5) for _ in range(2))
        ewo = rand((MOE_E, f, d), bf, f ** -0.5)
        xe = rand((MOE_E, 8, d), bf)
        record("moe_mlp", [MOE_E, 8, d, f], "bfloat16", ek.moe_mlp_cuda(xe, ewg, ewi, ewo),
               moe_mlp_ref(xe, ewg, ewi, ewo),
               lambda i: ek.moe_mlp_cuda(xe, ewg, ewi, ewo),
               lambda i: moe_mlp_ref(xe, ewg, ewi, ewo),
               lambda i: torch.bmm(F.silu(torch.bmm(xe, ewg)) * torch.bmm(xe, ewi), ewo),
               (2 * MOE_E * 8 * d + 3 * MOE_E * d * f) * 2, 6 * MOE_E * 8 * d * f,
               iters=10, extra={"column_groups": plan.groups, "group_cols": plan.gcols})
        del ewg, ewi, ewo, xe
    free(torch)


def int8_paged_rows(torch, record, rand) -> None:
    """paged_decode's int8 pool route (int8 pages with a float32 scale a
    (page, kv head), the current token's k/v beside the pool; q, the
    current k/v and out in float32, then bfloat16) against its plain
    version at smollm-135m's decode shape and at internlm2-1.8b's 8 slots
    x 2048 positions: float32 within TOL_F32, bfloat16 within one
    bfloat16 rounding of the plain version's float32 result;
    bit-identical across two launches; then the null page (codes 127,
    scale NaN) and every position at or past each slot's length - 1 in
    the pool (the current token's slot included: its k/v come from beside
    the pool) poisoned, which must leave both outputs bit for bit
    unchanged.  Bytes: the live int8 rows and their pages' scales, q, the
    current k/v, out, tables and lengths; operations in float32."""
    from repro_torch.kernels import _attn_plan
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import paged_decode_attention_int8_ref

    for arch, b, h, hkv, hd, length in Q8_ROWS:
        prng = torch.Generator().manual_seed(7)
        if length is None:
            lens = torch.randint(16, 333, (b,), generator=prng)
            lens[0] = 332
            npp = 512 // PAGE
        else:
            lens = torch.full((b,), length)
            npp = length // PAGE
        tables, pages = paged_tables(torch, lens.tolist(), npp, prng)
        lens_d = lens.to("cuda", torch.int32)
        g = torch.Generator(device="cuda").manual_seed(8)
        kq, vq = (torch.randint(-127, 128, (pages, PAGE, hkv, hd), generator=g,
                                device="cuda", dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.rand((pages, 1, hkv, 1), generator=g, device="cuda") * 0.02 + 1e-3
                  for _ in range(2))
        q, kn, vn = rand((b, 1, h, hd), torch.float32), rand((b, hkv, hd), torch.float32), \
            rand((b, hkv, hd), torch.float32)
        live = int(lens.sum())
        live_pages = sum(-(-int(n) // PAGE) for n in lens)
        plan = _attn_plan.paged_plan(b, h, hkv, npp, PAGE, hd, 4, aligned=False)
        outs = {}
        for dtype, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            es = torch.tensor([], dtype=dt).element_size()
            args = [q.to(dt), kq, vq, ks, vs, tables, lens_d, kn.to(dt), vn.to(dt)]
            out = fk.paged_decode_attention_int8_cuda(*args)
            check(out.dtype == dt, f"paged_decode_int8 {arch} {dtype}: out is {out.dtype}")
            ref, tol = paged_decode_attention_int8_ref(*args), None
            if dtype == "bfloat16":
                # one rounding of the float32 result on the same (bfloat16) inputs
                ref = paged_decode_attention_int8_ref(*[
                    t.float() if t.dtype == dt else t for t in args])
                dev = (out.float() - ref).abs()
                check(bool((dev <= Q8_BF16_ATOL + Q8_BF16_RTOL * ref.abs()).all()),
                      f"paged_decode_int8 {arch} bf16: out beyond one bfloat16 rounding "
                      f"of the float32 result (max abs err {float(dev.max()):.3g})")
                tol = Q8_BF16_RTOL
            record("paged_decode_int8", [b, h, hkv, hd, PAGE], dtype, out, ref,
                   lambda i, a=args: fk.paged_decode_attention_int8_cuda(*a),
                   lambda i, a=args: paged_decode_attention_int8_ref(*a), None,
                   2 * (live - b) * hkv * hd + 2 * 4 * live_pages * hkv +
                   es * (2 * b * h * hd + 2 * b * hkv * hd) + 4 * (tables.numel() + b),
                   4 * hd * live * h, tol=tol, iters=30 if length is None else 10,
                   ops_dtype="float32",
                   extra={"arch": arch, "live_positions": live, "route": "int8",
                          "splits": plan.splits, "blocks": plan.blocks})
            outs[dtype] = (args, out)
        kq[0], vq[0], ks[0], vs[0] = 127, -127, float("nan"), float("nan")
        for i in range(b):
            last = int(tables[i, (int(lens[i]) - 1) // PAGE])
            kq[last, (int(lens[i]) - 1) % PAGE:] = 127
            vq[last, (int(lens[i]) - 1) % PAGE:] = -127
        for dtype, (args, out) in outs.items():
            poisoned = fk.paged_decode_attention_int8_cuda(*args)
            check(torch.equal(poisoned, out), f"paged_decode_int8 {arch} {dtype}: the null "
                  f"page or positions at or past length - 1 leaked into the output")
        print(f"[smoke] paged_decode_int8 {arch}: float32 and bfloat16 outputs unchanged "
              f"with the null page and positions at or past length - 1 poisoned", flush=True)
        del kq, vq, ks, vs, outs
    free(torch)


def nan_paged_rows(torch, rand) -> None:
    """paged_decode's pool routes with a NaN in a live page of slot 0 (its
    first page, every kv head): at smollm-135m's decode shape (4 slots,
    16-332 positions) the bfloat16 tensor-core route at its served split
    count and at one split (slots of at most 32 positions), the FMA route
    (float32, 32 / 8 heads of 80) and the int8 route (float32 q).  Cases:
    K only, V only, both (the int8 route: the page's K scale, V scale,
    both).  Slot 0's output must be non-finite on every head, as the
    plain version's is; the other slots' bits equal those of the clean
    call; and the null page and every position at or past each length
    poisoned with NaN (the int8 route: the null page's scales; its
    positions past a length hold codes, which cannot be NaN) must leave
    every slot's bits unchanged."""
    from repro_torch.kernels import _attn_plan
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import (paged_decode_attention_int8_ref,
                                                         paged_decode_attention_ref)

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    nan = float("nan")
    for route, dt, h, hkv, hd, npp, lo, hi in (
            ("tc", torch.bfloat16, H, HKV, HD, 512 // PAGE, 16, 332),
            ("tc", torch.bfloat16, H, HKV, HD, 2, 17, 32),
            ("fma", torch.float32, 32, 8, 80, 512 // PAGE, 16, 332),
            ("int8", torch.float32, H, HKV, HD, 512 // PAGE, 16, 332)):
        b = DECODE_N
        prng = torch.Generator().manual_seed(11)
        lens = torch.randint(lo, hi + 1, (b,), generator=prng)
        lens[0] = hi
        tables, pages = paged_tables(torch, lens.tolist(), npp, prng)
        lens_d = lens.to("cuda", torch.int32)
        q = rand((b, 1, h, hd), dt)
        es = 4 if route == "int8" else q.element_size()
        plan = _attn_plan.paged_plan(b, h, hkv, npp, PAGE, hd, es, sms=sms,
                                     aligned=route != "int8")
        check(plan.route == ("fma" if route == "int8" else route),
              f"nan rows: {route} planned as {plan.route}")
        if route == "int8":
            g = torch.Generator(device="cuda").manual_seed(12)
            kp, vp = (torch.randint(-127, 128, (pages, PAGE, hkv, hd), generator=g,
                                    device="cuda", dtype=torch.int8) for _ in range(2))
            ks, vs = (torch.rand((pages, 1, hkv, 1), generator=g, device="cuda") * 0.02
                      + 1e-3 for _ in range(2))
            kn, vn = rand((b, hkv, hd), dt), rand((b, hkv, hd), dt)
            parts = {"k": ks, "v": vs}
            args = (q, kp, vp, ks, vs, tables, lens_d, kn, vn)

            def kern():
                return fk.paged_decode_attention_int8_cuda(*args)

            def plain():
                return paged_decode_attention_int8_ref(*args)
        else:
            kp, vp = rand((pages, PAGE, hkv, hd), dt), rand((pages, PAGE, hkv, hd), dt)
            parts = {"k": kp, "v": vp}

            def kern():
                return fk.paged_decode_attention_cuda(q, kp, vp, tables, lens_d)

            def plain():
                return paged_decode_attention_ref(q, kp, vp, tables, lens_d)
        clean = kern()
        check(bool(torch.isfinite(clean).all()), f"nan rows {route}: clean call not finite")
        # masked: the null page and everything at or past each length
        saved = {k: t.clone() for k, t in parts.items()}
        for t in parts.values():
            t[0] = nan
        if route != "int8":
            for i in range(b):
                n_pos = int(lens[i])
                for pi in range(n_pos // PAGE, npp):
                    page = int(tables[i, pi])
                    if page:
                        for t in parts.values():
                            t[page, max(n_pos - pi * PAGE, 0):] = nan
        masked = kern()
        check(torch.equal(masked, clean), f"nan rows {route} splits {plan.splits}: a NaN "
              f"in the null page or past a length changed the output")
        for k, t in parts.items():
            t.copy_(saved[k])
        live = int(tables[0, 0])
        rows = {}
        for case in ("k", "v", "kv"):
            for k in case:
                parts[k][live] = nan
            out = kern()
            bad = (~torch.isfinite(out[:, 0].float())).any(-1)       # (B, H)
            ref_bad = (~torch.isfinite(plain()[:, 0].float())).any(-1)
            rows[case] = [int(bad[0].sum()), h]
            check(bool(bad[0].all()), f"nan rows {route} splits {plan.splits} {case}: "
                  f"slot 0 finite on {int((~bad[0]).sum())} of {h} heads")
            check(bool(ref_bad[0].all()), f"nan rows {route} {case}: plain version finite")
            check(torch.equal(out[1:], clean[1:]), f"nan rows {route} splits {plan.splits} "
                  f"{case}: another slot's output changed")
            for k, t in parts.items():
                t.copy_(saved[k])
        print(json.dumps({"nan_paged_row": {
            "route": route, "dtype": str(dt).removeprefix("torch."),
            "shape": [b, h, hkv, hd, PAGE], "splits": plan.splits,
            "nonfinite_heads_slot0": rows, "masked_nan_bits_unchanged": True,
            "other_slots_bits_unchanged": True}}), flush=True)
    free(torch)


def int8_e2e_phase(torch, n_layers: int = 4) -> None:
    """smollm-135m at full width, `n_layers` layers, float32, int8 KV: the
    pool route (kernel impls; the int8 paged_decode once a layer a decode
    step) and the gather route (plain impls: the JAX engine's
    dequantize, decode, requantize) serve one trace; greedy tokens must be
    equal."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.launch.serve import serve
    from repro_torch.models import api
    from repro_torch.serving.engine import Request, ServingEngine

    base = configs.get_config("smollm-135m").replace(
        n_layers=n_layers, dtype="float32", param_dtype="float32")
    params = api.init_params(base, 1, device="cuda")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, base.vocab, size=int(n)).astype(np.int32)
               for n in rng.integers(16, 301, size=8)]
    toks, launches = {}, {}
    for name, cfg in (("pool", base.replace(attn_impl="flash", mlp_impl="fused",
                                            norm_impl="fused")),
                      ("gather", base.replace(attn_impl="einsum", mlp_impl="dense",
                                              norm_impl="ref"))):
        eng = ServingEngine(cfg, params, max_batch=4, max_len=512, device="cuda",
                            kv_quant=True)
        check(eng.kv_quant_mode == "paged", f"int8 e2e {name}: mode {eng.kv_quant_mode}")
        reqs = [Request(rid=i, prompt=p, max_new_tokens=16) for i, p in enumerate(prompts)]
        before = fk.PAGED_INT8.launches
        st = serve(eng, reqs)
        launches[name] = (fk.PAGED_INT8.launches - before, st["decode_steps"])
        toks[name] = [r.out_tokens for r in reqs]
        check(st["nan_steps"] == 0, f"int8 e2e {name}: non-finite logits")
        del eng
    same = sum(a == b for a, b in zip(toks["pool"], toks["gather"]))
    print(f"[smoke] int8 KV e2e f32 {n_layers} layers full width: {same}/8 request "
          f"streams equal (pool route vs gather route); int8 paged_decode "
          f"launches (launches, decode steps) {launches}", flush=True)
    check(toks["pool"] == toks["gather"], "int8 e2e: the pool route changed greedy tokens")
    n, steps = launches["pool"]
    check(n == n_layers * steps and launches["gather"][0] == 0,
          f"int8 e2e: int8 paged_decode launches {launches}")
    free(torch)


def cluster_drill_phase(torch, n_layers: int = 4) -> None:
    """smollm-135m at full width, `n_layers` layers, float32, the kernel
    impls (paged decode from the pool): 2 replicas on the card serve 8
    requests through the scripted fault drill `DRILL` (watchdog
    stall_steps 5).  Every request's tokens must equal a fault-free single
    engine's; the watchdog must log one "nan" and one "stall" quarantine;
    requests must have been requeued and none left unrouted; after the
    three restarts the card may hold no more than two replicas' pools
    (the retired ones freed)."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.launch.serve import serve
    from repro_torch.models import api
    from repro_torch.serving import resilience
    from repro_torch.serving.cluster import ServingCluster
    from repro_torch.serving.engine import ServingEngine

    cfg = configs.get_config("smollm-135m").replace(
        n_layers=n_layers, dtype="float32", param_dtype="float32",
        attn_impl="flash", mlp_impl="fused", norm_impl="fused")
    params = api.init_params(cfg, 2, device="cuda")
    kw = dict(max_batch=4, max_len=512, device="cuda")
    ref = _requests(np.random.default_rng(6), cfg.vocab, 8, 16, 100, 24)
    serve(ServingEngine(cfg, params, **kw), ref)
    reqs = _requests(np.random.default_rng(6), cfg.vocab, 8, 16, 100, 24)
    free(torch)
    mem0 = torch.cuda.memory_allocated()
    cl = ServingCluster(cfg, params, n_replicas=2, **kw,
                        watchdog=resilience.Watchdog(2, stall_steps=DRILL_STALL_STEPS))
    pool_bytes = cl.replicas[0].pool.page_nbytes * cl.replicas[0].pool.num_pages
    drill = resilience.ChaosSchedule([resilience.ChaosEvent(*e) for e in DRILL])
    before = fk.PAGED.launches
    for r in reqs:
        cl.submit(r)
    cl.run(chaos=drill)
    # three restarts rebuilt engines: the old pools must be gone
    grown = torch.cuda.memory_allocated() - mem0 - 2 * pool_bytes
    agg = cl.metrics.summary(cl)["aggregate"]
    same = sum(a.out_tokens == b.out_tokens for a, b in zip(reqs, ref))
    reasons = sorted(why for _, _, why in cl.watchdog.events)
    print(f"[smoke] cluster drill f32 {n_layers} layers full width, 2 replicas: "
          f"{same}/8 request streams equal to a fault-free engine's; watchdog "
          f"{cl.watchdog.events}; nan events that found a live slot "
          f"{drill.poisoned}; requeued {agg['requeued']}, restarts "
          f"{agg['restarts']}, quarantined {agg['quarantined']}, unrouted "
          f"{agg['n_unrouted']}, {cl.stats['steps']} cluster steps; paged_decode "
          f"launches {fk.PAGED.launches - before}; device memory beyond two pools "
          f"of {pool_bytes / 1e6:.1f} MB after {agg['restarts']} restarts "
          f"{grown / 1e6:.2f} MB", flush=True)
    check(all(r.done and r.finish_reason == "max_new_tokens" for r in reqs),
          "cluster drill: a request did not finish with max_new_tokens")
    check(same == 8, "cluster drill: failover changed greedy tokens")
    check(reasons == ["nan", "stall"], f"cluster drill: watchdog log {cl.watchdog.events}")
    check(agg["requeued"] > 0 and agg["n_unrouted"] == 0,
          f"cluster drill: requeued {agg['requeued']}, unrouted {agg['n_unrouted']}")
    check(fk.PAGED.launches > before, "cluster drill: paged_decode never ran")
    check(grown < pool_bytes / 2, f"cluster drill: {grown} bytes beyond two pools "
          f"after the restarts (a retired pool kept alive?)")
    del cl
    free(torch)


def spec_e2e_phase(torch, n_layers: int = 4) -> None:
    """smollm-135m at full width, `n_layers` layers, float32, the kernel
    impls: a `SpecDecodeEngine` with a 1-layer shared-trunk draft (k 4)
    must emit the target-only dense engine's greedy tokens; so must one
    over `high_tar_pair` (1-layer draft), whose acceptance must be 1 --
    every iteration then takes the k - 1 drafts, so the verify rows past
    the first and the rewind past them are held token for token."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.launch.serve import serve
    from repro_torch.models import api
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.specdec import (SpecDecodeEngine, high_tar_pair,
                                             shared_trunk_draft)

    cfg = configs.get_config("smollm-135m").replace(
        n_layers=n_layers, dtype="float32", param_dtype="float32",
        attn_impl="flash", mlp_impl="fused", norm_impl="fused")
    params = api.init_params(cfg, 3, device="cuda")
    kw = dict(max_batch=4, max_len=512, device="cuda")
    ref = _requests(np.random.default_rng(8), cfg.vocab, 8, 16, 300, 24)
    serve(ServingEngine(cfg, params, paged=False, **kw), ref)
    dcfg, dparams = shared_trunk_draft(cfg, params, 1)
    eng = SpecDecodeEngine(cfg, params, dcfg, dparams, k=SPEC_K, **kw)
    reqs = _requests(np.random.default_rng(8), cfg.vocab, 8, 16, 300, 24)
    serve(eng, reqs)
    same = sum(a.out_tokens == b.out_tokens for a, b in zip(reqs, ref))
    st = eng.spec_stats
    print(f"[smoke] spec-decode f32 {n_layers} layers full width, 1-layer draft, "
          f"k {SPEC_K}: {same}/8 request streams equal to the target-only engine's; "
          f"acceptance {st.acceptance_rate:.3f}, tokens/iteration "
          f"{st.tokens_per_iteration:.3f}", flush=True)
    check(same == 8 and not eng.health["nan_detected"],
          "spec-decode f32: tokens differ from target-only greedy decoding")
    del eng
    tp, hcfg, hparams = high_tar_pair(cfg, params, 1)
    href = _requests(np.random.default_rng(8), cfg.vocab, 8, 16, 300, 24)
    serve(ServingEngine(cfg, tp, paged=False, **kw), href)
    hi = SpecDecodeEngine(cfg, tp, hcfg, hparams, k=SPEC_K, **kw)
    hreqs = _requests(np.random.default_rng(8), cfg.vocab, 8, 16, 300, 24)
    serve(hi, hreqs)
    hsame = sum(a.out_tokens == b.out_tokens for a, b in zip(hreqs, href))
    hst = hi.spec_stats
    print(f"[smoke] spec-decode f32 high_tar_pair (1-layer draft, k {SPEC_K}): "
          f"{hsame}/8 request streams equal to the target-only engine's on the same "
          f"target; acceptance {hst.acceptance_rate:.3f}, tokens/iteration "
          f"{hst.tokens_per_iteration:.3f} over {hst.iterations} slot-iterations",
          flush=True)
    check(hsame == 8 and not hi.health["nan_detected"],
          "spec-decode f32 high_tar_pair: tokens differ from target-only greedy decoding")
    check(hst.acceptance_rate == 1.0,
          f"spec-decode f32 high_tar_pair: acceptance {hst.acceptance_rate}, not 1")
    del hi, tp
    free(torch)


def kernel_names(torch, fn, want: str) -> list[str]:
    """The CUDA kernels three fn() calls launch, by the profiler (windows
    without a device event or without `want` taken again: `profiled`)."""
    fn()
    torch.cuda.synchronize()

    def calls():
        for _ in range(3):
            fn()

    return sorted(profiled(torch, calls, need=(want,)))


def e2e_phase(torch):
    """Plain impls vs kernel impls vs the dense KV state, full width, 4
    layers, float32; the first decode's logits by the pool route against
    the gather route."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.launch.serve import serve
    from repro_torch.models import api, transformer
    from repro_torch.serving import paged
    from repro_torch.serving.engine import Request, ServingEngine

    base = configs.get_config("smollm-135m").replace(
        n_layers=4, dtype="float32", param_dtype="float32")
    plain = base.replace(attn_impl="einsum", mlp_impl="dense", norm_impl="ref")
    kern = base.replace(attn_impl="flash", mlp_impl="fused", norm_impl="fused")
    params = api.init_params(base, 1, device="cuda")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, base.vocab, size=int(n)).astype(np.int32)
               for n in rng.integers(16, 301, size=8)]
    toks, paged_launches = {}, {}
    for name, cfg, kw in (("plain", plain, {}), ("kernels", kern, {}),
                          ("dense", kern, {"paged": False})):
        eng = ServingEngine(cfg, params, max_batch=4, max_len=512,
                            device="cuda", **kw)
        check(eng.state.kind == ("dense" if kw else "paged"),
              f"e2e {name}: state {eng.state.kind}")
        reqs = [Request(rid=i, prompt=p, max_new_tokens=16)
                for i, p in enumerate(prompts)]
        before = fk.PAGED.launches
        st = serve(eng, reqs)
        paged_launches[name] = (fk.PAGED.launches - before, st["decode_steps"])
        toks[name] = [r.out_tokens for r in reqs]
        check(all(r.finish_reason == "max_new_tokens" for r in reqs),
              f"e2e {name}: a request did not finish with max_new_tokens")
    same = sum(a == b for a, b in zip(toks["plain"], toks["kernels"]))
    p0 = torch.as_tensor(prompts[0], device="cuda").long()[None]
    lp = transformer.forward(plain, params, p0)[0, -1]
    lk = transformer.forward(kern, params, p0)[0, -1]
    diff = float((lp - lk).abs().max())
    # one decode step after the same paged prefill, by both routes
    first = {}
    plen = len(prompts[0])
    bucket = paged.bucket_for(plen, paged.prefill_buckets(512))
    for route, cfg in (("pool", plain.replace(attn_impl="flash")),
                       ("gather", plain)):
        pool = paged.PagePool(plain, 1, 512, page_size=PAGE, device="cuda")
        check(pool.ensure(0, plen + 1), "e2e: page pool too small")
        tp = torch.zeros((1, bucket), dtype=torch.long, device="cuda")
        tp[0, :plen] = p0[0]
        last = paged.paged_prefill(plain, params, tp, plen, pool.segments,
                                   pool.table_row(0, bucket // PAGE), PAGE)
        nxt = last[0, -1].argmax().view(1, 1)
        first[route] = paged.paged_decode(cfg, params, nxt, pool.segments,
                                          pool.tables[[0]],
                                          np.asarray([plen], np.int32))[0, -1]
    route_diff = float((first["pool"] - first["gather"]).abs().max())
    print(f"[smoke] e2e f32 4 layers full width: {same}/8 request streams "
          f"equal (kernels vs plain), dense KV state "
          f"{sum(a == b for a, b in zip(toks['dense'], toks['kernels']))}/8 "
          f"equal to paged; first-prefill logits max |diff| {diff:.3g}; first "
          f"decode logits pool route vs gather route max |diff| "
          f"{route_diff:.3g}; paged_decode launches (launches, decode steps) "
          f"{paged_launches}", flush=True)
    check(toks["plain"] == toks["kernels"],
          "e2e: kernel impls changed greedy tokens")
    check(toks["dense"] == toks["kernels"],
          "e2e: the dense KV state changed greedy tokens")
    check(diff <= 1e-3, f"e2e: first-prefill logits differ by {diff}")
    check(route_diff <= 1e-4, f"e2e: pool-route decode logits differ from "
          f"the gather route's by {route_diff}")
    n, steps = paged_launches["kernels"]
    check(n == base.n_layers * steps,
          f"e2e: paged_decode launched {n} times in {steps} decode steps of "
          f"{base.n_layers} layers")
    check(paged_launches["plain"][0] == 0 and paged_launches["dense"][0] == 0,
          f"e2e: paged_decode ran off the pool route: {paged_launches}")


def moe_e2e_phase(torch, n_layers: int = 2):
    """mixtral-8x7b at full width, `n_layers` layers, float32, the kernel
    impls: served on the card (kernels) and on the CPU (plain versions)
    from the same weights; 4 requests of 16-64 tokens, 8 new tokens."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.kernels.moe_mlp import kernel as ek
    from repro_torch.launch.serve import serve
    from repro_torch.models import api, transformer
    from repro_torch.serving.engine import Request, ServingEngine

    cfg = configs.get_config("mixtral-8x7b").replace(
        n_layers=n_layers, dtype="float32", param_dtype="float32",
        attn_impl="flash", mlp_impl="fused", norm_impl="fused")
    t0 = time.perf_counter()
    params = api.init_params(cfg, 1, device="cpu")
    draw_s = time.perf_counter() - t0
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).astype(np.int32)
               for n in rng.integers(16, 65, size=4)]
    real_route = transformer.route
    toks, first, secs, routes, moe_runs = {}, {}, {}, {}, {}
    for dev in ("cuda", "cpu"):
        eng = ServingEngine(cfg, params, max_batch=4, max_len=512, device=dev)
        check(eng.state.kind == "dense", f"e2e mixtral {dev}: not the dense state")
        reqs = [Request(rid=i, prompt=p, max_new_tokens=8)
                for i, p in enumerate(prompts)]
        before = ek.MOE.launches
        st = serve(eng, reqs)
        secs[dev] = st["seconds"]
        moe_runs[dev] = (ek.MOE.launches - before,
                         n_layers * (st["prefills"] + st["decode_steps"]))
        toks[dev] = [r.out_tokens for r in reqs]
        check(all(r.finish_reason == "max_new_tokens" for r in reqs),
              f"e2e mixtral {dev}: a request did not finish with max_new_tokens")
        log = []

        def recorded(c, p, xf, log=log):
            w, idx = real_route(c, p, xf)
            log.append(idx.cpu())
            return w, idx

        transformer.route = recorded
        try:
            p0 = torch.as_tensor(prompts[0], device=dev).long()[None]
            first[dev] = api.prefill(cfg, eng.params, {"tokens": p0}, 512)[0][0, -1].cpu()
        finally:
            transformer.route = real_route
        routes[dev] = log
        del eng
        free(torch)
    del params
    same = sum(a == b for a, b in zip(toks["cuda"], toks["cpu"]))
    diff = float((first["cuda"] - first["cpu"]).abs().max())
    decisions = sum(a.numel() for a in routes["cpu"])
    differ = sum(int((torch.sort(a, -1)[0] != torch.sort(b, -1)[0]).sum())
                 for a, b in zip(routes["cuda"], routes["cpu"]))
    print(f"[smoke] e2e mixtral-8x7b f32 {n_layers} layers full width, card vs "
          f"CPU: {same}/4 request streams equal, first-prefill logits max "
          f"|diff| {diff:.3g}, routing decisions of the first prefill that "
          f"differ: {differ} of {decisions}; moe_mlp launches on the card "
          f"(launches, layers x (prefills + decode steps)) {moe_runs['cuda']} "
          f"(weights drawn in {draw_s:.1f}s; served in {secs['cuda']:.1f}s on "
          f"the card, {secs['cpu']:.1f}s on the CPU)", flush=True)
    check(toks["cuda"] == toks["cpu"], "e2e mixtral: the kernels changed greedy tokens")
    check(diff <= 1e-3, f"e2e mixtral: first-prefill logits differ by {diff}")
    check(moe_runs["cuda"][0] == moe_runs["cuda"][1],
          f"e2e mixtral: moe_mlp launches {moe_runs['cuda']}")


def recurrent_e2e_phase(torch, arch: str, n_layers: int):
    """The card (kernels) against the CPU (plain versions): `arch` at full
    width, `n_layers` layers, float32, one 8-request trace on the same
    weights."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.launch.serve import serve
    from repro_torch.models import api
    from repro_torch.serving.engine import Request, ServingEngine

    cfg = configs.get_config(arch).replace(
        n_layers=n_layers, dtype="float32", param_dtype="float32")
    t0 = time.perf_counter()
    params = api.init_params(cfg, 1, device="cpu")
    draw_s = time.perf_counter() - t0
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).astype(np.int32)
               for n in rng.integers(16, 301, size=8)]
    toks, first, secs = {}, {}, {}
    for dev in ("cuda", "cpu"):
        eng = ServingEngine(cfg, params, max_batch=4, max_len=512, device=dev)
        check(eng.state.kind == "recurrent", f"e2e {arch}: not the recurrent state")
        reqs = [Request(rid=i, prompt=p, max_new_tokens=16)
                for i, p in enumerate(prompts)]
        secs[dev] = serve(eng, reqs)["seconds"]
        toks[dev] = [r.out_tokens for r in reqs]
        check(all(r.finish_reason == "max_new_tokens" for r in reqs),
              f"e2e {arch} {dev}: a request did not finish with max_new_tokens")
        p0 = torch.as_tensor(prompts[0], device=dev).long()[None]
        first[dev] = api.prefill(cfg, eng.params, {"tokens": p0}, 512)[0][0, -1].cpu()
        del eng
    same = sum(a == b for a, b in zip(toks["cuda"], toks["cpu"]))
    diff = float((first["cuda"] - first["cpu"]).abs().max())
    print(f"[smoke] e2e {arch} f32 {n_layers} layers full width, card vs CPU: "
          f"{same}/8 request streams equal, first-prefill logits max |diff| "
          f"{diff:.3g} (weights drawn in {draw_s:.1f}s; served in "
          f"{secs['cuda']:.1f}s on the card, {secs['cpu']:.1f}s on the CPU)",
          flush=True)
    check(toks["cuda"] == toks["cpu"], f"e2e {arch}: the kernels changed greedy tokens")
    check(diff <= 1e-3, f"e2e {arch}: first-prefill logits differ by {diff}")


def _requests(rng, vocab, n, lo, hi, max_new):
    import numpy as np

    from repro_torch.serving.engine import Request
    return [Request(rid=i, prompt=rng.integers(0, vocab, size=int(p))
                    .astype(np.int32), max_new_tokens=max_new)
            for i, p in enumerate(rng.integers(lo, hi + 1, size=n))]


def recurrent_path_phase(torch, arch: str, launchers, name: str):
    """The full `arch` (bfloat16, random weights from a seed) through the
    serve launcher's own functions; `name` is the kernel of its recurrent
    layers, which must launch once a layer a prefill and a decode step."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.launch.serve import build_engine, serve
    from repro_torch.models import rglru

    cfg = configs.get_config(arch)
    n_rec = cfg.n_layers if cfg.family == "rwkv6" else \
        sum(not rglru.is_attn_layer(cfg, i) for i in range(cfg.n_layers))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = build_engine(cfg, max_batch=4, max_len=512, seed=0, device="cuda",
                       log=lambda s: print(s, flush=True))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    check(eng.state.kind == "recurrent", f"{arch}: not the recurrent state")
    rng = np.random.default_rng(0)
    serve(eng, _requests(rng, cfg.vocab, 2, 16, 40, 4))   # warm-up
    for ln in launchers.values():
        ln.launches = 0
    reqs = _requests(rng, cfg.vocab, 8, 16, 300, 32)
    s = serve(eng, reqs)
    counts = {n: ln.launches for n, ln in launchers.items()}
    want = n_rec * (s["prefills"] + s["decode_steps"])
    print(f"[smoke] main path {arch} {cfg.n_layers}L bf16: {s['tokens_out']} "
          f"tokens, {s['prefills']} prefills, {s['decode_steps']} decode steps "
          f"in {s['seconds']:.3f}s = {s['tokens_per_s']:.1f} tok/s; TTFT p50 "
          f"{s['ttft_p50_ms']:.1f} ms, TPOT p50 {s['tpot_p50_ms']:.2f} ms; "
          f"launches {counts} ({name} expected {n_rec} x (prefills + decode "
          f"steps) = {want}); weights drawn and engine built in {build_s:.1f}s; "
          f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB",
          flush=True)
    print(json.dumps({"main_path": s, "arch": arch, "launches": counts,
                      "build_engine_s": build_s}), flush=True)
    check(all(r.finish_reason == "max_new_tokens" and len(r.out_tokens) == 32
              for r in reqs), f"{arch}: a request did not finish with 32 tokens")
    check(s["nan_steps"] == 0 and not eng.health["nan_detected"],
          f"{arch}: non-finite logits")
    check(counts[name] == want,
          f"{arch}: {name} launched {counts[name]} times, expected {want}")
    return eng, counts


def variant_rows(torch, record, rand, F) -> None:
    """Kernel rows at the shapes the variant archs' served paths give them,
    bfloat16: flash attention at qwen2-vl-2b's 12 / 2 heads of 128 (group
    6) over a 300-token prompt, and at h2o-danube-1.8b's 32 / 8 heads of
    80 over its two prompts past the window of 4096 (the rows past the
    window held to `window_rows_err`); paged decode at qwen2-vl-2b's heads
    over 4 slots of 16-332 positions (the int8 route's row is `Q8_ROWS`');
    the MLP tile at h2o-danube-1.8b's, qwen2-vl-2b's and deepseek-v3's
    widths (d 7168: the column-split route), at N 4 (a decode step) and
    at the N of each path's longest prompt; moe_mlp over deepseek-v3's
    256 experts (d 7168, F 2048) at a decode step's capacity (8) and a
    300-token prefill's (16), the latter's extra peak device memory held
    to MOE_EXTRA_MB.  The plain moe_mlp runs 32 experts a call (float32
    copies of all 256 experts' weights would take 45 GB); each expert's
    product is independent, so the result is the same function's."""
    from repro_torch.kernels import _mlp_plan as mplan
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.fused_mlp import kernel as mk
    from repro_torch.kernels.fused_mlp.ref import fused_mlp_ref
    from repro_torch.kernels.moe_mlp import kernel as ek
    from repro_torch.kernels.moe_mlp.ref import moe_mlp_ref

    bf, es = torch.bfloat16, 2
    sdpa = tuple(int(p) for p in torch.__version__.split(".")[:2]) >= (2, 5)
    h, hkv, hd = QVL_ATTN
    s = WIDE_FLASH_S
    q, k, v = rand((1, s, h, hd), bf), rand((1, s, hkv, hd), bf), rand((1, s, hkv, hd), bf)

    def lib(i):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True,
            enable_gqa=True)

    out = fk.flash_attention_cuda(q, k, v)
    record("flash_attention", [1, s, h, hkv, hd], "bfloat16", out,
           flash_attention_ref(q, k, v), lambda i: fk.flash_attention_cuda(q, k, v),
           lambda i: flash_attention_ref(q, k, v), lib if sdpa else None,
           (2 * s * h * hd + 2 * s * hkv * hd) * es, 4 * hd * s * (s + 1) // 2 * h,
           extra={"arch": "qwen2-vl-2b"})
    flash_other_plan(torch, q, k, v, None, out)
    del q, k, v, out
    h, hkv, hd, w, _ = DANUBE
    for s in DANUBE_LENS[-2:]:
        q, k, v = rand((1, s, h, hd), bf), rand((1, s, hkv, hd), bf), rand((1, s, hkv, hd), bf)
        pos = torch.arange(s, device="cuda")
        allowed = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - w)

        def wlib(i, q=q, k=k, v=v, allowed=allowed):
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=allowed,
                enable_gqa=True)

        out = fk.flash_attention_cuda(q, k, v, window=w)
        rel = window_rows_err(q, k, v, w, out)
        check(rel <= TOL["bfloat16"], f"flash {[1, s, h, hkv, hd, w]}: rows past the "
              f"window off by {rel:.3g} of their RMS (tol {TOL['bfloat16']})")
        pairs = w * (w + 1) // 2 + (s - w) * w
        record("flash_attention", [1, s, h, hkv, hd, w], "bfloat16", out,
               flash_attention_ref(q, k, v, window=w),
               lambda i, q=q, k=k, v=v: fk.flash_attention_cuda(q, k, v, window=w),
               lambda i, q=q, k=k, v=v: flash_attention_ref(q, k, v, window=w),
               wlib if sdpa else None, (2 * s * h * hd + 2 * s * hkv * hd) * es,
               4 * hd * pairs * h, iters=5,
               extra={"arch": "h2o-danube-1.8b", "window_rows_rms_err": rel})
        del q, k, v, out, allowed
    free(torch)
    h, hkv, hd = QVL_ATTN
    prng = torch.Generator().manual_seed(9)
    lens = torch.randint(16, 333, (DECODE_N,), generator=prng)
    tables, pages = paged_tables(torch, lens.tolist(), 512 // PAGE, prng)
    q = rand((DECODE_N, 1, h, hd), bf)
    kp, vp = rand((pages, PAGE, hkv, hd), bf), rand((pages, PAGE, hkv, hd), bf)
    paged_row(torch, record, "bfloat16", q, kp, vp, tables,
              lens.to("cuda", torch.int32), extra={"arch": "qwen2-vl-2b"})
    del q, kp, vp
    for arch, d, f, n_long in VARIANT_MLP:
        wg, wi, wo = rand((d, f), bf, d ** -0.5), rand((d, f), bf, d ** -0.5), \
            rand((f, d), bf, f ** -0.5)
        for n in (DECODE_N, n_long):
            plan = mplan.mlp_plan(1, n, d, f, "bfloat16")
            xm = rand((n, d), bf)
            record("fused_mlp", [n, d, f], "bfloat16", mk.fused_mlp_cuda(xm, wg, wi, wo),
                   fused_mlp_ref(xm, wg, wi, wo),
                   lambda i, xm=xm: mk.fused_mlp_cuda(xm, wg, wi, wo),
                   lambda i, xm=xm: fused_mlp_ref(xm, wg, wi, wo),
                   lambda i, xm=xm: (F.silu(xm @ wg) * (xm @ wi)) @ wo,
                   (2 * n * d + 3 * d * f) * es, 6 * n * d * f, iters=30 if n <= 512 else 10,
                   extra={"arch": arch, "column_groups": plan.groups,
                          "group_cols": plan.gcols})
            del xm
        del wg, wi, wo
    free(torch)
    e, d, f = DS_MOE
    ewg, ewi = (rand((e, d, f), bf, d ** -0.5) for _ in range(2))
    ewo = rand((e, f, d), bf, f ** -0.5)
    chunk = 32

    def plain(xe):
        return torch.cat([moe_mlp_ref(xe[j:j + chunk], ewg[j:j + chunk], ewi[j:j + chunk],
                                      ewo[j:j + chunk]) for j in range(0, e, chunk)])

    for cap in DS_CAPS:
        plan = mplan.launch_plan("moe_mlp", e, cap, d, f, "bfloat16", True)
        xe = rand((e, cap, d), bf)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = ek.moe_mlp_cuda(xe, ewg, ewi, ewo)
        torch.cuda.synchronize()
        extra_mb = (torch.cuda.max_memory_allocated() - base - out.numel() * es) / 1e6
        print(f"[smoke] moe_mlp deepseek-v3 E {e} C {cap}: plan {plan}; extra peak "
              f"device memory of one call {extra_mb:.3f} MB (limit {MOE_EXTRA_MB} MB)",
              flush=True)
        check(extra_mb <= MOE_EXTRA_MB, f"moe_mlp E {e} C {cap}: {extra_mb} MB of "
              f"device memory beside the output")
        record("moe_mlp", [e, cap, d, f], "bfloat16", out, plain(xe),
               lambda i, xe=xe: ek.moe_mlp_cuda(xe, ewg, ewi, ewo),
               lambda i, xe=xe: plain(xe),
               lambda i, xe=xe: torch.bmm(F.silu(torch.bmm(xe, ewg)) * torch.bmm(xe, ewi), ewo),
               (2 * e * cap * d + 3 * e * d * f) * es, 6 * e * cap * d * f, iters=3,
               extra={"arch": "deepseek-v3-671b", "extra_peak_mb": extra_mb,
                      "capacity_rule": f"{cap} slots for "
                                       f"{'a decode step of 4' if cap == DS_CAPS[0] else '300 tokens'}"})
        del xe, out
    del ewg, ewi, ewo
    free(torch)


def qwen2_vl_e2e_phase(torch, n_layers: int = 4) -> None:
    """qwen2-vl-2b at full width (M-RoPE, QKV bias, 12 / 2 heads of 128),
    `n_layers` layers, float32, weights drawn on the card: one 8-request
    trace through the plain impls (einsum attention, dense MLP, plain
    norms: decode by the gather route), the kernel impls (flash prefill,
    decode from the page pool, fused MLP and norms) and the kernel impls
    with einsum attention (the gather route beside the fused MLP and
    norms).  Greedy tokens must be equal, paged_decode must launch once
    a layer a decode step on the pool route and never on the others, and
    the first decode's logits by the pool route must be within 1e-4 of
    the gather route's after the same paged prefill."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.launch.serve import serve
    from repro_torch.models import api
    from repro_torch.serving import paged
    from repro_torch.serving.engine import Request, ServingEngine

    base = configs.get_config("qwen2-vl-2b").replace(
        n_layers=n_layers, dtype="float32", param_dtype="float32")
    kern = dict(mlp_impl="fused", norm_impl="fused")
    cfgs = {"plain": base.replace(attn_impl="einsum"),
            "kernels": base.replace(attn_impl="flash", **kern),
            "gather": base.replace(attn_impl="einsum", **kern)}
    params = api.init_params(base, 1, device="cuda")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, base.vocab, size=int(n)).astype(np.int32)
               for n in rng.integers(16, 301, size=8)]
    toks, launches = {}, {}
    for name, cfg in cfgs.items():
        eng = ServingEngine(cfg, params, max_batch=4, max_len=512, device="cuda")
        check(eng.paged, f"qwen2-vl e2e {name}: not paged")
        reqs = [Request(rid=i, prompt=p, max_new_tokens=16) for i, p in enumerate(prompts)]
        before = fk.PAGED.launches
        st = serve(eng, reqs)
        launches[name] = (fk.PAGED.launches - before, st["decode_steps"])
        toks[name] = [r.out_tokens for r in reqs]
        check(all(r.finish_reason == "max_new_tokens" for r in reqs),
              f"qwen2-vl e2e {name}: a request did not finish with max_new_tokens")
        del eng
    p0 = torch.as_tensor(prompts[0], device="cuda").long()[None]
    plen = len(prompts[0])
    bucket = paged.bucket_for(plen, paged.prefill_buckets(512))
    first = {}
    for route in ("kernels", "gather"):
        pool = paged.PagePool(base, 1, 512, page_size=PAGE, device="cuda")
        check(pool.ensure(0, plen + 1), "qwen2-vl e2e: page pool too small")
        tp = torch.zeros((1, bucket), dtype=torch.long, device="cuda")
        tp[0, :plen] = p0[0]
        last = paged.paged_prefill(cfgs["plain"], params, tp, plen, pool.segments,
                                   pool.table_row(0, bucket // PAGE), PAGE)
        nxt = last[0, -1].argmax().view(1, 1)
        first[route] = paged.paged_decode(cfgs[route], params, nxt, pool.segments,
                                          pool.tables[[0]],
                                          np.asarray([plen], np.int32))[0, -1]
    route_diff = float((first["kernels"] - first["gather"]).abs().max())
    same = {n: sum(a == b for a, b in zip(toks[n], toks["plain"])) for n in cfgs}
    print(f"[smoke] e2e qwen2-vl-2b f32 {n_layers} layers full width: request streams "
          f"equal to the plain impls' {same} of 8; first decode logits pool route vs "
          f"gather route max |diff| {route_diff:.3g}; paged_decode launches "
          f"(launches, decode steps) {launches}", flush=True)
    check(toks["kernels"] == toks["plain"] == toks["gather"],
          "qwen2-vl e2e: the kernels changed greedy tokens")
    check(route_diff <= 1e-4, f"qwen2-vl e2e: pool-route decode logits differ from "
          f"the gather route's by {route_diff}")
    n, steps = launches["kernels"]
    check(n == n_layers * steps and launches["plain"][0] == launches["gather"][0] == 0,
          f"qwen2-vl e2e: paged_decode launches {launches}")
    del params
    free(torch)


def danube_e2e_phase(torch, n_layers: int = 2) -> None:
    """h2o-danube-1.8b at full width (32 / 8 heads of 80, window 4096),
    `n_layers` layers, float32: one 4-request trace whose two longest
    prompts (`DANUBE_LENS`' last two) run past the window, 16 new tokens,
    through the plain impls (einsum attention, dense MLP, plain norms)
    and the kernel impls (windowed flash prefill, fused MLP and norms),
    both over the dense KV ring of the window.  Greedy tokens must be
    equal and flash must launch once a layer a prefill on the kernel
    impls only."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.launch.serve import serve
    from repro_torch.models import api
    from repro_torch.serving.engine import Request, ServingEngine

    base = configs.get_config("h2o-danube-1.8b").replace(
        n_layers=n_layers, dtype="float32", param_dtype="float32")
    cfgs = {"plain": base.replace(attn_impl="einsum", mlp_impl="dense", norm_impl="ref"),
            "kernels": base.replace(attn_impl="flash", mlp_impl="fused", norm_impl="fused")}
    params = api.init_params(base, 1, device="cuda")
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, base.vocab, size=int(n)).astype(np.int32)
               for n in (*rng.integers(16, 301, size=2), *DANUBE_LENS[-2:])]
    toks, launches = {}, {}
    for name, cfg in cfgs.items():
        eng = ServingEngine(cfg, params, max_batch=4, max_len=DANUBE_MAX_LEN, device="cuda")
        check(eng.state.kind == "dense" and eng.cache["segments"][0]["k"].shape[2] ==
              base.window, f"danube e2e {name}: not the dense KV ring of the window")
        reqs = [Request(rid=i, prompt=p, max_new_tokens=16) for i, p in enumerate(prompts)]
        before = fk.FLASH.launches
        st = serve(eng, reqs)
        launches[name] = (fk.FLASH.launches - before, st["prefills"])
        toks[name] = [r.out_tokens for r in reqs]
        check(all(r.finish_reason == "max_new_tokens" for r in reqs),
              f"danube e2e {name}: a request did not finish with max_new_tokens")
        del eng
    same = sum(a == b for a, b in zip(toks["plain"], toks["kernels"]))
    print(f"[smoke] e2e h2o-danube-1.8b f32 {n_layers} layers full width, prompts "
          f"{[len(p) for p in prompts]} (window {base.window}): {same}/4 request streams "
          f"equal; flash launches (launches, prefills) {launches}", flush=True)
    check(toks["kernels"] == toks["plain"], "danube e2e: the kernels changed greedy tokens")
    n, prefills = launches["kernels"]
    check(n == n_layers * prefills and launches["plain"][0] == 0,
          f"danube e2e: flash launches {launches}")
    del params
    free(torch)


def deepseek_e2e_phase(torch, n_layers: int = 2) -> None:
    """deepseek-v3-671b at full width (MLA, 256 experts top-8, a shared
    expert), cut to `n_layers` layers (one dense, the rest MoE), float32,
    weights drawn on the card (~57 GB): one 4-request trace (16-64
    tokens, 8 new) through the plain impls (einsum attention, dense MLP,
    batched expert products, plain norms) and the kernel impls (fused
    MLP, moe_mlp, fused norms; flash attention stays off: it refuses
    MLA's v, as JAX's does), both on the card over dense latent KV.
    Greedy tokens must be equal, the first prefill's logits within 1e-3,
    and moe_mlp must launch once a MoE layer a prefill and a decode step
    on the kernel impls only."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.kernels.moe_mlp import kernel as ek
    from repro_torch.launch.serve import serve
    from repro_torch.models import api
    from repro_torch.serving.engine import Request, ServingEngine

    base = configs.get_config("deepseek-v3-671b").replace(
        n_layers=n_layers, first_dense_layers=1, dtype="float32", param_dtype="float32")
    t0 = time.perf_counter()
    params = api.init_params(base, 1, device="cuda")
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, base.vocab, size=int(n)).astype(np.int32)
               for n in rng.integers(16, 65, size=4)]
    toks, first, moe_runs, secs = {}, {}, {}, {}
    for name, cfg in (("plain", base),
                      ("kernels", base.replace(mlp_impl="fused", norm_impl="fused"))):
        eng = ServingEngine(cfg, params, max_batch=4, max_len=128, device="cuda")
        check(eng.state.kind == "dense", f"deepseek e2e {name}: not the dense state")
        reqs = [Request(rid=i, prompt=p, max_new_tokens=8) for i, p in enumerate(prompts)]
        before = ek.MOE.launches
        st = serve(eng, reqs)
        secs[name] = st["seconds"]
        moe_runs[name] = (ek.MOE.launches - before,
                          (n_layers - 1) * (st["prefills"] + st["decode_steps"]))
        toks[name] = [r.out_tokens for r in reqs]
        check(all(r.finish_reason == "max_new_tokens" for r in reqs),
              f"deepseek e2e {name}: a request did not finish with max_new_tokens")
        p0 = torch.as_tensor(prompts[0], device="cuda").long()[None]
        first[name] = api.prefill(cfg, params, {"tokens": p0}, 128)[0][0, -1]
        del eng
    same = sum(a == b for a, b in zip(toks["plain"], toks["kernels"]))
    diff = float((first["plain"] - first["kernels"]).abs().max())
    print(f"[smoke] e2e deepseek-v3-671b f32 {n_layers} layers full width: {same}/4 "
          f"request streams equal (kernels vs plain), first-prefill logits max |diff| "
          f"{diff:.3g}; moe_mlp launches (launches, MoE layers x (prefills + decode "
          f"steps)) {moe_runs} (weights drawn on the card in {draw_s:.1f}s; served in "
          f"{secs['plain']:.1f}s plain, {secs['kernels']:.1f}s kernels)", flush=True)
    check(toks["plain"] == toks["kernels"], "deepseek e2e: the kernels changed greedy tokens")
    check(diff <= 1e-3, f"deepseek e2e: first-prefill logits differ by {diff}")
    check(moe_runs["plain"][0] == 0 and moe_runs["kernels"][0] == moe_runs["kernels"][1],
          f"deepseek e2e: moe_mlp launches {moe_runs}")
    del params, first
    free(torch)


def variant_path_phases(torch, launchers) -> dict:
    """The variant archs' served paths at full width in bfloat16, weights drawn on
    the card, through the serve launcher (`main_path_phase`):
    h2o-danube-1.8b (24 layers, dense KV ring of 4096) with 6 prompts of
    16-300 tokens and 2 of 4200-4600, so the ring wraps and the window
    cuts; qwen2-vl-2b (28 layers, the paged pool route), 8 prompts of
    16-300 tokens, then a short int8 KV run; deepseek-v3-671b cut to
    `DS_LAYERS` of 61 layers (its 3 dense layers and 1 MoE layer; flash
    off); each with its launch counts checked and a decode step broken
    down.  Then whisper-base (`whisper_path_phase`).  Returns the launch
    counts by path."""
    from repro_torch.kernels.flash_attention import kernel as fk

    paths = {}
    norms = {k: launchers[k] for k in ("fused_rmsnorm", "fused_rmsnorm_residual")}
    mlp = {"fused_mlp": launchers["fused_mlp"]}
    eng, counts, s = main_path_phase(
        torch, "h2o-danube-1.8b", dict(norms, **mlp, flash_attention=fk.FLASH), 8,
        lens=DANUBE_LENS, max_len=DANUBE_MAX_LEN)
    cfg = eng.mcfg
    check(eng.state.kind == "dense" and eng.cache["segments"][0]["k"].shape[2] == cfg.window,
          "h2o-danube-1.8b: not the dense KV ring of its window")
    check(counts["flash_attention"] == cfg.n_layers * s["prefills"],
          f"h2o-danube-1.8b: flash launched {counts['flash_attention']} times, "
          f"expected {cfg.n_layers} x {s['prefills']} prefills")
    paths["h2o-danube-1.8b"] = counts
    breakdown_phase(torch, eng, "h2o-danube-1.8b", need=("mlp_cluster_kernel",),
                    forbid=("mlp_partial_kernel",))
    prefill_breakdown_phase(torch, eng, "h2o-danube-1.8b", DANUBE_LENS[-1])
    del eng
    free(torch)
    eng, counts, s = main_path_phase(
        torch, "qwen2-vl-2b", dict(norms, **mlp, flash_attention=fk.FLASH,
                                   paged_decode=fk.PAGED), 8)
    check(eng.paged and counts["paged_decode"] == eng.mcfg.n_layers * s["decode_steps"],
          f"qwen2-vl-2b: paged_decode launched {counts['paged_decode']} times, expected "
          f"{eng.mcfg.n_layers} x {s['decode_steps']} decode steps")
    paths["qwen2-vl-2b"] = counts
    breakdown_phase(torch, eng, "qwen2-vl-2b",
                    need=("mlp_cluster_kernel", "paged_tc_kernel"),
                    forbid=("mlp_partial_kernel", "paged_split_kernel"))
    prefill_breakdown_phase(torch, eng, "qwen2-vl-2b", 300)
    del eng
    free(torch)
    before = fk.PAGED.launches
    eng, counts, s = main_path_phase(
        torch, "qwen2-vl-2b", dict(norms, **mlp, flash_attention=fk.FLASH,
                                   paged_decode_int8=fk.PAGED_INT8), 4,
        kv_quant=True)
    want = eng.mcfg.n_layers * s["decode_steps"]
    check(eng.kv_quant_mode == "paged" and counts["paged_decode_int8"] == want,
          f"qwen2-vl-2b int8: launches {counts}, int8 paged_decode expected {want}")
    check(fk.PAGED.launches == before, "qwen2-vl-2b int8: the bfloat16 paged_decode ran")
    paths["qwen2-vl-2b int8"] = counts
    del eng
    free(torch)
    eng, counts, s = main_path_phase(
        torch, "deepseek-v3-671b", dict(norms, **mlp, moe_mlp=launchers["moe_mlp"]), 8,
        n_layers=DS_LAYERS, flash=False)
    cfg = eng.mcfg
    n_moe = cfg.n_layers - cfg.first_dense_layers
    steps = s["prefills"] + s["decode_steps"]
    for name, want in (("moe_mlp", n_moe * steps),
                       ("fused_mlp", (cfg.first_dense_layers + n_moe) * steps)):
        check(counts[name] == want, f"deepseek-v3-671b: {name} launched {counts[name]} "
              f"times, expected {want}")
    check(eng.state.kind == "dense" and set(eng.cache["segments"][0]) == {"latent"},
          "deepseek-v3-671b: not the dense latent KV")
    paths["deepseek-v3-671b"] = counts
    breakdown_phase(torch, eng, "deepseek-v3-671b", need=("mlp_cluster_kernel",),
                    forbid=("mlp_partial_kernel",))
    prefill_breakdown_phase(torch, eng, "deepseek-v3-671b", 300, share="mlp_",
                            need=("mlp_cluster_kernel",),
                            forbid=("flash_tc_kernel", "flash_fwd_kernel"))
    del eng
    free(torch)
    paths["whisper-base"] = whisper_path_phase(torch, launchers)
    return paths


def whisper_path_phase(torch, launchers) -> dict:
    """whisper-base at full width (6 encoder and 6 decoder layers), bf16,
    weights drawn on the card, through the serve launcher with the
    three-flag policy (whisper has no hook for any: the policy only logs),
    an encoder window of `WHISPER_ENC` frames (30 s): 8 requests with
    `workload.synthetic_frames` of that many frames and prompts of 4-64
    tokens, 32 new tokens each.  No hand-written kernel may launch."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.launch.policy import load_policy
    from repro_torch.launch.serve import build_engine, serve
    from repro_torch.serving import workload
    from repro_torch.serving.engine import Request

    cfg = configs.get_config("whisper-base")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = build_engine(cfg, policy=load_policy(smoke_policy("whisper-base")), max_batch=4,
                       max_len=WHISPER_MAX_LEN, enc_len=WHISPER_ENC, seed=0, device="cuda",
                       log=lambda s: print(s, flush=True))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    check(eng.state.kind == "cross_attn" and eng.state.enc_len == WHISPER_ENC,
          "whisper-base: not the cross-attention state over its window")
    check((eng.mcfg.attn_impl, eng.mcfg.mlp_impl, eng.mcfg.norm_impl) ==
          ("auto", "dense", "ref"), "whisper-base: the policy changed an impl")
    rng = np.random.default_rng(0)

    def reqs(n, max_new):
        return [Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=int(p))
                        .astype(np.int32), max_new_tokens=max_new,
                        frames=workload.synthetic_frames(rng, WHISPER_ENC, cfg.d_model))
                for i, p in enumerate(rng.integers(4, 65, size=n))]

    serve(eng, reqs(2, 4))                                 # warm-up
    for ln in launchers.values():
        ln.launches = 0
    rs = reqs(8, 32)
    s = serve(eng, rs)
    counts = {name: ln.launches for name, ln in launchers.items()}
    print(f"[smoke] main path whisper-base {cfg.n_enc_layers}+{cfg.n_layers}L bf16 "
          f"(cross_attn state, enc_len "
          f"{WHISPER_ENC}): {s['tokens_out']} tokens, {s['prefills']} prefills, "
          f"{s['decode_steps']} decode steps in {s['seconds']:.3f}s = "
          f"{s['tokens_per_s']:.1f} tok/s; TTFT p50 {s['ttft_p50_ms']:.1f} ms, TPOT p50 "
          f"{s['tpot_p50_ms']:.2f} ms; launches {counts}; weights drawn and engine "
          f"built in {build_s:.1f}s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    print(json.dumps({"main_path": s, "arch": "whisper-base", "launches": counts,
                      "build_engine_s": build_s, "state": eng.state.kind}), flush=True)
    check(all(r.finish_reason == "max_new_tokens" and len(r.out_tokens) == 32 for r in rs),
          "whisper-base: a request did not finish with 32 tokens")
    check(s["nan_steps"] == 0 and not eng.health["nan_detected"], "whisper-base: non-finite logits")
    check(not any(counts.values()), f"whisper-base: a hand-written kernel launched: {counts}")
    breakdown_phase(torch, eng, "whisper-base", forbid=OWN_KERNELS)
    del eng
    free(torch)
    return counts


def _bits(torch, t):
    """t's raw bits as an integer tensor of its element size."""
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def _grad_gap(torch, got, want) -> float:
    """max |got - want| over max |want| (1 where want is all 0 and got
    is not)."""
    scale = float(want.abs().max())
    return float((got.float() - want.float()).abs().max()) / max(scale, 1e-30)


def grad_rows(torch) -> dict:
    """Each of the seven ops under autograd on the card (float32, TF32
    off): the forward launches its kernel once (its launcher's count) and
    the backward launches none; each output of the autograd route within
    the op's TOL_F32 of the plain version's on the same inputs.  The
    gradients are held against the plain version's autograd within
    GRAD_OP_TOL of each input's largest: a check of the route's plumbing
    (which inputs get a gradient, in which dtype), not of the kernel,
    since the backward recomputes the plain version.  The paged decode
    ops raise under grad.  Returns {row: {"out_err", "grad_gap"}}."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.fused_mlp import kernel as mk
    from repro_torch.kernels.fused_mlp import ops as mops
    from repro_torch.kernels.fused_mlp import ref as mref
    from repro_torch.kernels.fused_norm import kernel as nk
    from repro_torch.kernels.fused_norm import ops as nops
    from repro_torch.kernels.fused_norm import ref as nref
    from repro_torch.kernels.moe_mlp import kernel as ek
    from repro_torch.kernels.moe_mlp import ops as eops
    from repro_torch.kernels.moe_mlp import ref as eref
    from repro_torch.kernels.rglru_scan import kernel as gk
    from repro_torch.kernels.rglru_scan import ops as gops
    from repro_torch.kernels.rglru_scan import ref as gref
    from repro_torch.kernels.wkv6 import kernel as wk
    from repro_torch.kernels.wkv6 import ops as wops
    from repro_torch.kernels.wkv6 import ref as wref

    gen = torch.Generator(device="cuda").manual_seed(3)

    def t(*shape, grad=True, scale=1.0):
        x = torch.randn(shape, generator=gen, device="cuda") * scale
        return x.requires_grad_(grad)

    def scan_in():
        a = torch.sigmoid(t(2, 256, LRU_W, grad=False) + 2.0).requires_grad_(True)
        return [a, t(2, 256, LRU_W), t(2, LRU_W, grad=False)]

    def wkv_in(lead, u_shape, s_shape):
        logw = (-torch.exp(t(*lead, RWKV_D, grad=False) - 1.0)).requires_grad_(True)
        return [t(*lead, RWKV_D, scale=0.5), t(*lead, RWKV_D, scale=0.5),
                t(*lead, RWKV_D), logw, t(*u_shape, scale=0.1), t(*s_shape, scale=0.1)]

    cases = (
        ("fused_rmsnorm", nk.RMSNORM, nops.fused_rmsnorm, nref.fused_rmsnorm_ref,
         lambda: [t(64, D), t(D, scale=0.1)], {"eps": 1e-6}),
        ("fused_rmsnorm_residual", nk.RMSNORM_RESIDUAL, nops.fused_rmsnorm_residual,
         nref.fused_rmsnorm_residual_ref,
         lambda: [t(64, D), t(64, D), t(D, scale=0.1)], {"eps": 1e-6}),
        ("fused_mlp", mk.MLP, mops.fused_mlp, mref.fused_mlp_ref,
         lambda: [t(2, 128, D), t(D, F_FF, scale=D ** -0.5), t(D, F_FF, scale=D ** -0.5),
                  t(F_FF, D, scale=F_FF ** -0.5)], {"swiglu": True}),
        ("fused_mlp gelu", mk.MLP, mops.fused_mlp, mref.fused_mlp_ref,
         lambda: [t(2, 128, D), None, t(D, F_FF, scale=D ** -0.5),
                  t(F_FF, D, scale=F_FF ** -0.5)], {"swiglu": False}),
        ("flash_attention", fk.FLASH, fops.flash_attention, fref.flash_attention_ref,
         lambda: [t(2, 256, H, HD), t(2, 256, HKV, HD), t(2, 256, HKV, HD)],
         {"causal": True, "window": None}),
        ("flash_attention window, k/v no grad", fk.FLASH, fops.flash_attention,
         fref.flash_attention_ref,
         lambda: [t(2, 256, H, HD), t(2, 256, HKV, HD, grad=False),
                  t(2, 256, HKV, HD, grad=False)], {"causal": True, "window": 64}),
        ("moe_mlp", ek.MOE, eops.moe_mlp, eref.moe_mlp_ref,
         lambda: [t(8, 24, 512), t(8, 512, 1024, scale=512 ** -0.5),
                  t(8, 512, 1024, scale=512 ** -0.5), t(8, 1024, 512, scale=1024 ** -0.5)],
         {"swiglu": True}),
        ("moe_mlp gelu", ek.MOE, eops.moe_mlp, eref.moe_mlp_ref,
         lambda: [t(8, 24, 512), None, t(8, 512, 1024, scale=512 ** -0.5),
                  t(8, 1024, 512, scale=1024 ** -0.5)], {"swiglu": False}),
        ("rglru_scan", gk.SCAN, gops.rglru_scan, gref.rglru_scan_ref, scan_in, {}),
        ("wkv6_bshd", wk.WKV6, wops.wkv6_bshd, wref.wkv6_bshd_ref,
         lambda: wkv_in((1, 256, RWKV_H), (RWKV_H, RWKV_D), (1, RWKV_H, RWKV_D, RWKV_D)),
         {"chunk": 32}),
        ("wkv6", wk.WKV6, wops.wkv6, wref.wkv6_ref,
         lambda: wkv_in((8, 128), (8, 1, RWKV_D), (8, RWKV_D, RWKV_D)), {"chunk": 32}),
    )
    tol_of = {nk.RMSNORM: "fused_rmsnorm", nk.RMSNORM_RESIDUAL: "fused_rmsnorm_residual",
              mk.MLP: "fused_mlp", fk.FLASH: "flash_attention", ek.MOE: "moe_mlp",
              gk.SCAN: "rglru_scan", wk.WKV6: "wkv6"}
    gaps = {}
    for name, launcher, op, plain, make, kw in cases:
        inputs = make()
        wrt = [x for x in inputs if x is not None and x.requires_grad]
        before = launcher.launches
        out = op(*inputs, **kw)
        first = out[0] if isinstance(out, tuple) else out
        check(type(first.grad_fn).__name__ == "_KernelFunctionBackward",
              f"grad {name}: the forward did not take the kernel's autograd route")
        launched = launcher.launches - before
        outs = out if isinstance(out, tuple) else (out,)
        ws = [torch.randn(o.shape, generator=gen, device="cuda") for o in outs]

        def loss(res):
            res = res if isinstance(res, tuple) else (res,)
            return sum((o.float() * w).sum() for o, w in zip(res, ws))

        got = torch.autograd.grad(loss(out), wrt)
        torch.cuda.synchronize()
        check(launched == 1 and launcher.launches - before == 1,
              f"grad {name}: {launched} launches in the forward, "
              f"{launcher.launches - before - launched} in the backward (want 1, 0)")
        ref = plain(*inputs, **kw)
        tol = TOL_F32[tol_of[launcher]]
        out_err, ok = agreement(torch, tuple(o.detach() for o in outs),
                                tuple(r.detach() for r in
                                      (ref if isinstance(ref, tuple) else (ref,))), tol)
        check(ok, f"grad {name}: the autograd route's output differs from the plain "
              f"version's by {out_err:.3g} (tol {tol})")
        want = torch.autograd.grad(loss(ref), wrt)
        gap = max(_grad_gap(torch, g, w) for g, w in zip(got, want))
        check(all(g.dtype == x.dtype for g, x in zip(got, wrt)),
              f"grad {name}: a gradient is not in its input's dtype")
        check(gap <= GRAD_OP_TOL, f"grad {name}: gradients differ from the plain "
              f"version's by {gap:.3g} of the largest (tol {GRAD_OP_TOL})")
        gaps[name] = {"out_err": out_err, "grad_gap": gap}
    q = t(DECODE_N, 1, H, HD)
    pool = torch.zeros((3, PAGE, HKV, HD), device="cuda")
    tables = torch.ones((DECODE_N, 1), dtype=torch.int32, device="cuda")
    lens = torch.full((DECODE_N,), 4, dtype=torch.int32, device="cuda")
    for what, call in (
            ("paged_decode", lambda: fops.paged_decode_attention(q, pool, pool, tables,
                                                                 lens)),
            ("paged_decode_int8", lambda: fops.paged_decode_attention_int8(
                q, pool.to(torch.int8), pool.to(torch.int8),
                torch.ones((3, HKV), device="cuda"), torch.ones((3, HKV), device="cuda"),
                tables, lens, pool[0, :1].expand(DECODE_N, HKV, HD).contiguous(),
                pool[0, :1].expand(DECODE_N, HKV, HD).contiguous()))):
        try:
            call()
            raised = False
        except RuntimeError as e:
            raised = "no gradient" in str(e)
        check(raised, f"grad {what}: no RuntimeError under grad")
    print(f"[smoke] the ops under autograd (f32, TF32 off), max abs error of the "
          f"outputs against the plain version and worst gradient gap of the "
          f"largest: { {k: [float(f'{v:.3g}') for v in g.values()] for k, g in gaps.items()} }"
          f"; one launch a forward, none a backward; the paged decode ops raise "
          f"under grad", flush=True)
    return gaps


def grad_e2e_phase(torch) -> dict:
    """One value_and_grad step at full width and cut depth (GRAD_DEPTHS),
    float32, TF32 off, through the kernel route and through the plain
    route: smollm-135m both on the card (flash, fused MLP and norms
    against einsum, dense and the plain norm); rwkv6-3b, recurrentgemma-2b
    (two recurrent layers and one attention layer, with the fused norms and
    flash) and mixtral-8x7b (one MoE layer, all three flags) on the card
    against the CPU, whose ops run the plain versions, as the e2e phases
    reach theirs.  Every kernel of the path must launch in the forward
    (by its count); the losses within 1e-4; each gradient leaf within
    GRAD_TOL of the leaf's largest gradient.  Returns {arch: summary}."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.bridge import tree_paths, tree_to
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.fused_mlp import kernel as mk
    from repro_torch.kernels.fused_norm import kernel as nk
    from repro_torch.kernels.moe_mlp import kernel as ek
    from repro_torch.kernels.rglru_scan import kernel as gk
    from repro_torch.kernels.wkv6 import kernel as wk
    from repro_torch.models import api
    from repro_torch.training.loop import value_and_grad

    launchers = {"fused_rmsnorm": nk.RMSNORM, "fused_rmsnorm_residual": nk.RMSNORM_RESIDUAL,
                 "fused_mlp": mk.MLP, "flash_attention": fk.FLASH, "moe_mlp": ek.MOE,
                 "wkv6": wk.WKV6, "rglru_scan": gk.SCAN}
    flags = dict(attn_impl="flash", mlp_impl="fused", norm_impl="fused")
    summary = {}
    for arch, depth in GRAD_DEPTHS:
        base = configs.get_config(arch).replace(n_layers=depth, dtype="float32",
                                                param_dtype="float32")
        kern = base.replace(**flags) if base.family != "rwkv6" else base
        on_card = arch == "smollm-135m"
        plain = base.replace(attn_impl="einsum", mlp_impl="dense", norm_impl="ref") \
            if on_card else kern
        want = {"smollm-135m": dict(fused_rmsnorm=depth + 1, fused_rmsnorm_residual=depth,
                                    fused_mlp=depth, flash_attention=depth),
                "rwkv6-3b": dict(wkv6=depth),
                "recurrentgemma-2b": dict(fused_rmsnorm=2 * depth + 1, flash_attention=1,
                                          rglru_scan=depth - 1),
                "mixtral-8x7b": dict(fused_rmsnorm=depth + 1, fused_rmsnorm_residual=depth,
                                     flash_attention=depth, moe_mlp=depth)}[arch]
        t0 = time.perf_counter()
        params = api.init_params(base, 1, device="cuda" if on_card else "cpu")
        draw_s = time.perf_counter() - t0
        b, s = (2, 256) if on_card else (1, 128)
        rng = np.random.default_rng(1)
        batch = {k: torch.as_tensor(rng.integers(0, base.vocab, (b, s)).astype(np.int32))
                 for k in ("tokens", "labels")}
        for ln in launchers.values():
            ln.launches = 0
        loss_k, grads_k = value_and_grad(kern, tree_to(params, "cuda"),
                                         tree_to(batch, "cuda"))
        torch.cuda.synchronize()
        counts = {name: ln.launches for name, ln in launchers.items() if ln.launches}
        dev = "cuda" if on_card else "cpu"
        loss_p, grads_p = value_and_grad(plain, tree_to(params, dev), tree_to(batch, dev))
        gk_, gp_ = tree_paths(grads_k), tree_paths(grads_p)
        check([p for p, _ in gk_] == [p for p, _ in gp_], f"grad e2e {arch}: trees differ")
        gaps = {"/".join(map(str, p)): _grad_gap(torch, a.cpu(), b_.cpu())
                for (p, a), (_, b_) in zip(gk_, gp_)}
        worst = max(gaps, key=gaps.get)
        zero = [p for (p, a) in gk_ if not bool(a.abs().max() > 0)]
        loss_gap = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
        summary[arch] = {"layers": depth, "batch": [b, s], "plain_on": dev,
                         "loss": float(loss_k), "loss_rel_gap": loss_gap,
                         "worst_leaf": worst, "worst_gap": gaps[worst],
                         "leaves": len(gaps), "launches": counts}
        print(f"[smoke] grad e2e {arch} f32 {depth} layers full width, kernels on "
              f"the card vs plain on the {'card' if on_card else 'CPU'} (B {b} x S "
              f"{s}): loss {float(loss_k):.5f} vs {float(loss_p):.5f}, {len(gaps)} "
              f"leaves, worst gap {gaps[worst]:.3g} of the largest gradient "
              f"({worst}); launches in the forward {counts} (weights drawn in "
              f"{draw_s:.1f}s)", flush=True)
        check(counts == want, f"grad e2e {arch}: launches {counts}, want {want}")
        check(loss_gap <= 1e-4, f"grad e2e {arch}: losses differ by {loss_gap:.3g}")
        check(not zero, f"grad e2e {arch}: no gradient reached {zero[:4]}")
        check(gaps[worst] <= GRAD_TOL, f"grad e2e {arch}: leaf {worst} differs by "
              f"{gaps[worst]:.3g} of its largest gradient (tol {GRAD_TOL})")
        del params, grads_k, grads_p
        free(torch)
    return summary


def train_path_phase(torch, record, F) -> dict:
    """The main training path: smollm-135m at full width (30 layers, bf16,
    random weights from seed 0) with the fused norms, the fused MLP and
    flash, through `repro_torch.training.loop.train`: SyntheticLM
    batches of TRAIN_BATCH x TRAIN_SEQ tokens, AdamW at lr 3e-4 (10 warm-up
    steps, cosine to TRAIN_STEPS), a loss logged every step, checkpoints
    every 10 steps into build/train_ckpt.  Every loss finite, the last
    TRAIN_DROP nats below the first; the four kernels launched under
    autograd exactly as often as the steps imply (launch counts set to 0
    just before `train` and read just after); the final checkpoint
    restored on the card holds the trained weights bit for bit, and the
    whole restored (params, opt_state) saved and restored again is bit-
    equal.  train()'s own rate: tokens over the wall time between the
    logs of steps 10 and 19 (the data pipeline, the host-to-device copy
    and the optimizer inside, no checkpoint save), and over its whole
    run (warm-up and checkpoints too).

    Then one value_and_grad on the restored weights with every kernel
    call's inputs captured: each of the 121 calls (31 norms, 30 residual
    norms, 30 MLP tiles, 30 flash calls at B 8 x S 256) is held against
    its plain version at the bf16 TOL, and the first of each op is also
    a row (`record`: times, bound, library call).  The same step by the
    plain route (einsum attention, dense MLP, plain norm): the losses
    within TRAIN_BF16_LOSS_TOL of each other, the gradient trees within
    TRAIN_BF16_GRAD_TOL in relative L2 norm.  Then the step rate: ms a
    step by CUDA events over 10 steps on batches already on the card
    (no data pipeline, no host-to-device copy, no checkpoint) and the
    peak device memory of those steps, by the kernel route and by the
    plain route, and one profiled step of the kernel route.  Returns
    the summary."""
    import shutil

    from repro_torch import configs
    from repro_torch.bridge import tree_leaves, tree_paths
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.data.pipeline import DataConfig, DataPipeline
    from repro_torch.kernels import _grad
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.fused_mlp import kernel as mk
    from repro_torch.kernels.fused_norm import kernel as nk
    from repro_torch.training.loop import (TrainConfig, make_train_step, train,
                                           value_and_grad)
    from repro_torch.training.optimizer import OptimizerConfig, init_opt

    cfg = configs.get_config("smollm-135m").replace(
        attn_impl="flash", mlp_impl="fused", norm_impl="fused")
    plain_cfg = cfg.replace(attn_impl="einsum", mlp_impl="dense", norm_impl="ref")
    ocfg = OptimizerConfig(lr=3e-4, warmup_steps=10, total_steps=TRAIN_STEPS)
    ckpt_dir = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    tcfg = TrainConfig(steps=TRAIN_STEPS, log_every=1, ckpt_every=10,
                       ckpt_dir=str(ckpt_dir), seed=0)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, seed=0)
    launchers = {"fused_rmsnorm": nk.RMSNORM, "fused_rmsnorm_residual": nk.RMSNORM_RESIDUAL,
                 "fused_mlp": mk.MLP, "flash_attention": fk.FLASH}
    tokens = TRAIN_BATCH * TRAIN_SEQ
    logged = []                   # the wall clock at each logged step (log_every 1)
    torch.cuda.reset_peak_memory_stats()
    for ln in launchers.values():
        ln.launches = 0
    t0 = time.perf_counter()
    out = train(cfg, ocfg, tcfg, dcfg, device="cuda",
                log_fn=lambda line: logged.append(time.perf_counter()))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: ln.launches for name, ln in launchers.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [loss for _, loss in out["losses"]]
    L = cfg.n_layers
    want = {"fused_rmsnorm": (L + 1) * TRAIN_STEPS,
            "fused_rmsnorm_residual": L * TRAIN_STEPS,
            "fused_mlp": L * TRAIN_STEPS, "flash_attention": L * TRAIN_STEPS}
    check(all(math.isfinite(v) for v in losses), f"train: a loss is not finite: {losses}")
    check(len(losses) == TRAIN_STEPS and len(logged) == TRAIN_STEPS,
          f"train: {len(losses)} losses logged")
    check(losses[0] - losses[-1] >= TRAIN_DROP, f"train: the loss fell from "
          f"{losses[0]:.4f} to {losses[-1]:.4f}, less than {TRAIN_DROP}")
    check(counts == want, f"train: launches {counts}, want {want}")
    # train()'s rate between the checkpoints after steps 10 and 20: each
    # log follows the step's loss read back, so the window holds whole steps
    w0, w1 = tcfg.ckpt_every, 2 * tcfg.ckpt_every - 1
    window_ms = (logged[w1] - logged[w0]) * 1e3 / (w1 - w0)
    # the card's checkpoints: the last one holds the trained weights
    mgr = CheckpointManager(str(ckpt_dir))
    check(mgr.steps() == [10, 20, 30], f"train: checkpoints {mgr.steps()}")
    params = out["params"]
    (rp, ropt), meta = mgr.restore((params, {"inner": init_opt(ocfg, params)}))
    check(meta == {"next_step": TRAIN_STEPS}, f"train: checkpoint meta {meta}")

    def bit_equal(a_tree, b_tree):
        return all(a.device.type == "cuda" and a.dtype == b.dtype and
                   torch.equal(_bits(torch, a), _bits(torch, b))
                   for a, b in zip(tree_leaves(a_tree), tree_leaves(b_tree)))

    check(bit_equal(rp, params), "train: the restored weights differ from the trained")
    again_dir = ROOT / "build" / "train_ckpt_again"
    shutil.rmtree(again_dir, ignore_errors=True)
    again = CheckpointManager(str(again_dir))
    again.save(TRAIN_STEPS, (rp, ropt))
    back, _ = again.restore((rp, ropt))
    check(bit_equal(back, (rp, ropt)) and
          [p for p, _ in tree_paths(back)] == [p for p, _ in tree_paths((rp, ropt))],
          "train: a save and restore on the card changed the tree")
    shutil.rmtree(again_dir, ignore_errors=True)
    del out, params, back
    free(torch)

    # one step's own inputs to every kernel call, captured where the ops
    # hand them to the autograd route
    data = DataPipeline(dcfg)
    batches = [{k: torch.from_numpy(v).to("cuda") for k, v in
                data.batch(TRAIN_STEPS + i).items()} for i in range(10)]
    calls = []
    run = _grad.run

    def capture(kernel, plain, *inputs, **kw):
        calls.append((kernel, plain, [None if x is None else x.detach().clone()
                                      for x in inputs], kw))
        return run(kernel, plain, *inputs, **kw)

    _grad.run = capture
    try:
        loss_k, grads_k = value_and_grad(cfg, rp, batches[0])
    finally:
        _grad.run = run
    op_of = {"fused_rmsnorm_ref": "fused_rmsnorm",
             "fused_rmsnorm_residual_ref": "fused_rmsnorm_residual",
             "fused_mlp_ref": "fused_mlp", "flash_attention_ref": "flash_attention"}
    checked: dict = {}
    firsts = {}
    with torch.no_grad():
        for kernel, plain, inputs, kw in calls:
            name = op_of[plain.__name__]
            e, ok = agreement(torch, kernel(*inputs, **kw), plain(*inputs, **kw),
                              TOL["bfloat16"])
            check(ok, f"train: {name} call {checked.get(name, [0])[0]} of the step "
                  f"differs from its plain version on its own inputs (max abs err "
                  f"{e:.3g}, tol {TOL['bfloat16']})")
            n, worst = checked.get(name, (0, 0.0))
            checked[name] = (n + 1, max(worst, e))
            firsts.setdefault(name, (kernel, plain, inputs, kw))
    check({k: n for k, (n, _) in checked.items()} == {k: v // TRAIN_STEPS
                                                      for k, v in want.items()},
          f"train: kernel calls in one step {checked}")
    del calls
    sdpa_gqa = tuple(int(p) for p in torch.__version__.split(".")[:2]) >= (2, 5)
    rms_norm = getattr(F, "rms_norm", None)
    train_rows = []
    with torch.no_grad():
        for name, (kernel, plain, inputs, kw) in firsts.items():
            es = inputs[0].element_size()
            if name == "flash_attention":
                q, k, v = inputs
                b, sq, h, hd = q.shape
                hkv = k.shape[2]
                shape = [b, sq, h, hkv, hd]
                nbytes = (2 * b * sq * h * hd + 2 * b * sq * hkv * hd) * es
                flops = 4 * hd * (sq * (sq + 1) // 2) * h * b
                lib = None
                if sdpa_gqa and kw.get("window") is None:
                    def lib(i, q=q, k=k, v=v):
                        return F.scaled_dot_product_attention(
                            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                            is_causal=True, enable_gqa=True)
            elif name == "fused_mlp":
                x, wg, wi, wo = inputs
                d, f = wi.shape
                n = x.numel() // d
                shape = [n, d, f]
                nbytes, flops = (2 * n * d + 3 * d * f) * es, 6 * n * d * f

                def lib(i, x2=x.reshape(n, d), wg=wg, wi=wi, wo=wo):
                    return (F.silu(x2 @ wg) * (x2 @ wi)) @ wo
            else:
                d = inputs[0].shape[-1]
                n = inputs[0].numel() // d
                shape = [n, d]
                lib = None
                if name == "fused_rmsnorm":
                    nbytes, flops = (2 * n * d + d) * es, 4 * n * d
                    if rms_norm is not None:
                        x, sc = inputs

                        def lib(i, x=x, w1=(1.0 + sc.float()).to(sc.dtype), d=d,
                                eps=kw["eps"]):
                            return rms_norm(x, (d,), weight=w1, eps=eps)
                else:
                    nbytes, flops = (4 * n * d + d) * es, 5 * n * d
            row = record(name, shape, "bfloat16", kernel(*inputs, **kw),
                         plain(*inputs, **kw),
                         lambda i, a=inputs, kw=kw, kern=kernel: kern(*a, **kw),
                         lambda i, a=inputs, kw=kw, ref=plain: ref(*a, **kw), lib,
                         nbytes, flops, iters=20,
                         act="swiglu" if name == "fused_mlp" else None,
                         extra={"path": "train", "calls_checked": checked[name][0],
                                "calls_worst_err": checked[name][1]})
            train_rows.append({k: row[k] for k in (
                "name", "shape", "max_err", "tol", "kernel_ms", "plain_ms",
                "library_ms", "bound_ms", "bound_by", "calls_checked",
                "calls_worst_err")})
    del firsts
    # the same step by the plain route, on the same weights and batch
    loss_p, grads_p = value_and_grad(plain_cfg, rp, batches[0])
    pairs = list(zip(tree_paths(grads_k), tree_paths(grads_p)))
    diff2 = sum(float((a.float() - b_.float()).square().sum()) for (_, a), (_, b_) in pairs)
    norm2 = sum(float(b_.float().square().sum()) for _, (_, b_) in pairs)
    grad_rel = math.sqrt(diff2 / norm2)
    leaf_gaps = {"/".join(map(str, p)): _grad_gap(torch, a, b_)
                 for (p, a), (_, b_) in pairs}
    worst_leaf = max(leaf_gaps, key=leaf_gaps.get)
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    print(f"[smoke] train step bf16 30L, kernel route vs plain route on the same "
          f"weights and batch: loss {float(loss_k):.5f} vs {float(loss_p):.5f} "
          f"(rel {loss_rel:.3g}, tol {TRAIN_BF16_LOSS_TOL}); gradients' relative L2 "
          f"gap {grad_rel:.3g} (tol {TRAIN_BF16_GRAD_TOL}), worst leaf {worst_leaf} "
          f"{leaf_gaps[worst_leaf]:.3g} of its largest", flush=True)
    check(loss_rel <= TRAIN_BF16_LOSS_TOL, f"train: bf16 losses differ by {loss_rel:.3g}")
    check(grad_rel <= TRAIN_BF16_GRAD_TOL,
          f"train: bf16 gradients differ by {grad_rel:.3g} in relative L2")
    del grads_k, grads_p, pairs
    free(torch)

    # the step rate on batches already on the card, each route from the
    # restored state, and its peak device memory
    def step_rate(mcfg, profile):
        step_fn = make_train_step(mcfg, ocfg, tcfg)
        state = [rp, ropt]

        def one(i):
            state[0], state[1], _ = step_fn(state[0], state[1], batches[i % len(batches)])

        free(torch)
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(torch, one, iters=10, warmup=2)
        peak = torch.cuda.max_memory_allocated() / 1e9
        rec = profiled(torch, lambda: one(0), need=("flash_tc_kernel",)) if profile else None
        del state
        return ms, peak, rec

    ms, step_peak_gb, rec = step_rate(cfg, True)
    plain_ms, plain_peak_gb, _ = step_rate(plain_cfg, False)
    dev_ms = sum(t for t, _ in rec.values()) / 1e3 or None
    own_ms = sum(t for n, (t, _) in rec.items() if any(k in n for k in OWN_KERNELS)) / 1e3
    top = sorted(((round(t / 1e3, 3), n[:60]) for n, (t, _) in rec.items()),
                 reverse=True)[:6]
    card = card_line()
    summary = {"arch": "smollm-135m", "layers": L, "dtype": cfg.dtype,
               "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
               "optimizer": "adamw", "lr": ocfg.lr, "loss_first": losses[0],
               "loss_last": losses[-1], "losses": losses,
               "train_window_steps": [w0 + 1, w1], "train_window_ms_per_step": window_ms,
               "train_window_tokens_per_s": tokens * 1e3 / window_ms,
               "train_wall_s": wall, "train_wall_tokens_per_s": tokens * TRAIN_STEPS / wall,
               "train_peak_device_gb": peak_gb,
               "step_ms": ms, "step_tokens_per_s": tokens * 1e3 / ms,
               "step_peak_device_gb": step_peak_gb,
               "plain_step_ms": plain_ms, "plain_step_tokens_per_s": tokens * 1e3 / plain_ms,
               "plain_step_peak_device_gb": plain_peak_gb,
               "bf16_vs_plain": {"loss_rel_gap": loss_rel, "grad_rel_l2": grad_rel,
                                 "worst_leaf": worst_leaf,
                                 "worst_leaf_gap": leaf_gaps[worst_leaf]},
               "kernel_rows": train_rows,
               "device_ms_per_step": dev_ms,
               "device_busy": dev_ms / ms if dev_ms else None,
               "own_kernels_ms_per_step": own_ms,
               "kernels_per_step": sum(n for _, n in rec.values()),
               "top_kernels_ms": top, "launches": counts,
               "launches_per_step": {k: v // TRAIN_STEPS for k, v in counts.items()},
               "checkpoints": mgr.steps(), "card": card}
    print(f"[smoke] train path smollm-135m {L}L bf16 (fused norms, fused MLP, flash; "
          f"AdamW): {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens, loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; train() steps {w0 + 1}-{w1} "
          f"{window_ms:.2f} ms a step = {tokens * 1e3 / window_ms:.0f} tokens/s (data "
          f"pipeline and host-to-device copy inside), whole run {wall:.2f}s = "
          f"{tokens * TRAIN_STEPS / wall:.0f} tokens/s with warm-up and checkpoints, "
          f"peak device memory {peak_gb:.2f} GB; step rate on staged batches "
          f"(CUDA events) {ms:.2f} ms = {tokens * 1e3 / ms:.0f} tokens/s, peak "
          f"{step_peak_gb:.2f} GB; plain route {plain_ms:.2f} ms = "
          f"{tokens * 1e3 / plain_ms:.0f} tokens/s, peak {plain_peak_gb:.2f} GB; "
          f"device {'not measured' if dev_ms is None else f'{dev_ms:.2f}'} ms a "
          f"step ({own_ms:.2f} in our kernels, "
          f"{summary['kernels_per_step']} kernels; heaviest {top}); "
          f"launches {counts}; checkpoint restored bit-equal on the card; kernel "
          f"calls of one step checked on their own inputs {checked}; card {card}",
          flush=True)
    del rp, ropt, batches
    free(torch)
    return summary


def tp_rows(torch, record, rand, F) -> None:
    """Kernel rows at the local shapes tensor parallelism over 2 ranks
    gives the kernels (`tp_path_phase`), bfloat16, each against its plain
    version with its times and bound: the MLP tile at smollm-135m's F 768
    (N 4 and 300), h2o-danube-1.8b's F 3456, qwen2-vl-2b's F 4480 and
    deepseek-v3's shared expert (d 7168, F 1024) at N 4; flash attention
    at danube's 16 / 4 heads of 80 (window 4096), qwen2-vl's 6 / 1 of 128
    and mixtral-8x7b's 16 / 4 of 128 (window 4096), S 300; paged decode
    at qwen2-vl's 6 / 1 heads over 4 slots; moe_mlp at mixtral's E 4
    (capacity 8, a decode step) and deepseek-v3's E 128 (capacity 8).
    smollm's 9 / 3 heads do not split over 2: its attention runs whole on
    each rank, at the rows phase 2 already has."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.fused_mlp import kernel as mk
    from repro_torch.kernels.fused_mlp.ref import fused_mlp_ref
    from repro_torch.kernels.moe_mlp import kernel as ek
    from repro_torch.kernels.moe_mlp.ref import moe_mlp_ref

    bf, es = torch.bfloat16, 2
    sdpa = tuple(int(p) for p in torch.__version__.split(".")[:2]) >= (2, 5)
    tag = {"tp": TP}
    for arch, d, f, ns in TP_MLP:
        wg, wi, wo = rand((d, f), bf, d ** -0.5), rand((d, f), bf, d ** -0.5), \
            rand((f, d), bf, f ** -0.5)
        for n in ns:
            xm = rand((n, d), bf)
            record("fused_mlp", [n, d, f], "bfloat16", mk.fused_mlp_cuda(xm, wg, wi, wo),
                   fused_mlp_ref(xm, wg, wi, wo),
                   lambda i, xm=xm: mk.fused_mlp_cuda(xm, wg, wi, wo),
                   lambda i, xm=xm: fused_mlp_ref(xm, wg, wi, wo),
                   lambda i, xm=xm: (F.silu(xm @ wg) * (xm @ wi)) @ wo,
                   (2 * n * d + 3 * d * f) * es, 6 * n * d * f, extra=dict(tag, arch=arch))
            del xm
        del wg, wi, wo
    s = WIDE_FLASH_S
    for arch, h, hkv, hd, w in TP_FLASH:
        q, k, v = rand((1, s, h, hd), bf), rand((1, s, hkv, hd), bf), rand((1, s, hkv, hd), bf)

        def lib(i, q=q, k=k, v=v):
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True,
                enable_gqa=True)

        # S 300 lies inside every window: the windowed mask is the causal one
        record("flash_attention", [1, s, h, hkv, hd] + ([w] if w else []), "bfloat16",
               fk.flash_attention_cuda(q, k, v, window=w), flash_attention_ref(q, k, v, window=w),
               lambda i, q=q, k=k, v=v: fk.flash_attention_cuda(q, k, v, window=w),
               lambda i, q=q, k=k, v=v: flash_attention_ref(q, k, v, window=w),
               lib if sdpa else None, (2 * s * h * hd + 2 * s * hkv * hd) * es,
               4 * hd * s * (s + 1) // 2 * h, extra=dict(tag, arch=arch))
        del q, k, v
    h, hkv, hd = QVL_ATTN[0] // TP, QVL_ATTN[1] // TP, QVL_ATTN[2]
    prng = torch.Generator().manual_seed(9)
    lens = torch.randint(16, 333, (DECODE_N,), generator=prng)
    tables, pages = paged_tables(torch, lens.tolist(), 512 // PAGE, prng)
    q = rand((DECODE_N, 1, h, hd), bf)
    kp, vp = rand((pages, PAGE, hkv, hd), bf), rand((pages, PAGE, hkv, hd), bf)
    paged_row(torch, record, "bfloat16", q, kp, vp, tables,
              lens.to("cuda", torch.int32), extra=dict(tag, arch="qwen2-vl-2b"))
    del q, kp, vp
    free(torch)
    for arch, e, d, f, cap in TP_MOE:
        ewg, ewi = (rand((e, d, f), bf, d ** -0.5) for _ in range(2))
        ewo = rand((e, f, d), bf, f ** -0.5)
        chunk = 32

        def plain(xe, ewg=ewg, ewi=ewi, ewo=ewo):
            return torch.cat([moe_mlp_ref(xe[j:j + chunk], ewg[j:j + chunk], ewi[j:j + chunk],
                                          ewo[j:j + chunk]) for j in range(0, e, chunk)])

        xe = rand((e, cap, d), bf)
        record("moe_mlp", [e, cap, d, f], "bfloat16", ek.moe_mlp_cuda(xe, ewg, ewi, ewo),
               plain(xe), lambda i, xe=xe: ek.moe_mlp_cuda(xe, ewg, ewi, ewo),
               lambda i, xe=xe: plain(xe),
               lambda i, xe=xe: torch.bmm(F.silu(torch.bmm(xe, ewg)) * torch.bmm(xe, ewi), ewo),
               (2 * e * cap * d + 3 * e * d * f) * es, 6 * e * cap * d * f, iters=5,
               extra=dict(tag, arch=arch))
        del ewg, ewi, ewo, xe
        free(torch)
    from repro_torch.kernels.rglru_scan import kernel as gk
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
    from repro_torch.kernels.wkv6 import ops as wops
    from repro_torch.kernels.wkv6.ref import wkv6_bshd_ref

    f32, h, d = torch.float32, RWKV_H // TP, RWKV_D
    for b, s in ((DECODE_N, 1), (1, 256)):
        r, k, v = (rand((b, s, h * d), f32, 0.5).reshape(b, s, h, d) for _ in range(3))
        logw = torch.log(torch.exp(-torch.exp(rand((b, s, h * d), f32).clamp(-1.0, 1.0)))
                         .clamp(min=1e-12)).reshape(b, s, h, d)
        u, s0 = rand((h, d), f32, 0.1), rand((b, h, d, d), f32, 0.1)

        def wkern(i, r=r, k=k, v=v, logw=logw, u=u, s0=s0):
            return wops.wkv6_bshd(r, k, v, logw, u, s0, chunk=32)

        def wplain(i, r=r, k=k, v=v, logw=logw, u=u, s0=s0):
            return wkv6_bshd_ref(r, k, v, logw, u, s0, chunk=32)

        record("wkv6", [b, s, h, d], "float32", wkern(0), wplain(0), wkern, wplain, None,
               4 * (5 * b * h * s * d + h * d + 2 * b * h * d * d), 4 * b * h * s * d * d,
               extra=dict(tag, arch="rwkv6-3b"))
        del r, k, v, logw, u, s0
    w = LRU_W // TP
    for b, s in ((DECODE_N, 1), (1, 256)):
        a = torch.sigmoid(rand((b, s, w), f32))
        x, h0 = rand((b, s, w), f32), rand((b, w), f32)
        record("rglru_scan", [b, s, w], "float32", gk.rglru_scan_cuda(a, x, h0),
               rglru_scan_ref(a, x, h0), lambda i, a=a, x=x, h0=h0: gk.rglru_scan_cuda(a, x, h0),
               lambda i, a=a, x=x, h0=h0: rglru_scan_ref(a, x, h0), None,
               4 * (3 * b * s * w + b * w), 2 * b * s * w,
               extra=dict(tag, arch="recurrentgemma-2b"))
        del a, x, h0
    free(torch)


def kernel_shapes():
    """A context that records the shapes the port's kernel ops are called
    at, by wrapping each op in its module (the model code looks them up
    there at every call): flash (query heads, KV heads, hd), paged decode
    (query heads, KV heads, hd), the fused MLP (d, F), moe_mlp (E, d, F),
    wkv6 in the model's layout (heads, hd), rglru_scan (channels,).
    Yields {op: set of shapes}."""
    import contextlib

    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.fused_mlp import ops as mops
    from repro_torch.kernels.moe_mlp import ops as eops
    from repro_torch.kernels.rglru_scan import ops as sops
    from repro_torch.kernels.wkv6 import ops as wops

    taps = ((fops, "flash_attention", lambda a: (a[0].shape[2], a[1].shape[2], a[0].shape[3])),
            (fops, "paged_decode_attention",
             lambda a: (a[0].shape[2], a[1].shape[2], a[0].shape[3])),
            (mops, "fused_mlp", lambda a: tuple(a[2].shape)),
            (eops, "moe_mlp", lambda a: tuple(a[2].shape)),
            (wops, "wkv6_bshd", lambda a: (a[0].shape[2], a[0].shape[3])),
            (sops, "rglru_scan", lambda a: (a[0].shape[-1],)))

    @contextlib.contextmanager
    def ctx():
        seen = {name: set() for _, name, _ in taps}
        real = {name: getattr(mod, name) for mod, name, _ in taps}

        def tap(name, shape_of):
            def call(*a, **kw):
                seen[name].add(tuple(int(x) for x in shape_of(a)))
                return real[name](*a, **kw)
            return call

        for mod, name, shape_of in taps:
            setattr(mod, name, tap(name, shape_of))
        try:
            yield seen
        finally:
            for mod, name, _ in taps:
                setattr(mod, name, real[name])

    return ctx()


def forward_collectives(coll) -> dict:
    """The forward collectives counted since the last reset (a serving
    path runs no backward, whose counts live under their own keys)."""
    return {k: coll.COUNTS[k] for k in coll.FORWARD}


def _tp_launchers(recurrent: bool = False):
    """The launchers of the transformer's kernels (and with `recurrent`,
    of wkv6 and rglru_scan)."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.fused_mlp import kernel as mk
    from repro_torch.kernels.fused_norm import kernel as nk
    from repro_torch.kernels.moe_mlp import kernel as ek
    from repro_torch.kernels.rglru_scan import kernel as gk
    from repro_torch.kernels.wkv6 import kernel as wk
    out = {"fused_rmsnorm": nk.RMSNORM, "fused_rmsnorm_residual": nk.RMSNORM_RESIDUAL,
           "fused_mlp": mk.MLP, "flash_attention": fk.FLASH, "paged_decode": fk.PAGED,
           "moe_mlp": ek.MOE}
    return dict(out, wkv6=wk.WKV6, rglru_scan=gk.SCAN) if recurrent else out


def _tp_serve(torch, eng, reqs, recurrent: bool = False):
    """Serve `reqs` on `eng` with every launch count and collective set to
    0 just before and read just after, recording the kernels' shapes:
    (summary, launches, collectives, shapes)."""
    from repro_torch.launch.serve import serve
    from repro_torch.parallel import collectives as coll

    launchers = _tp_launchers(recurrent)
    for ln in launchers.values():
        ln.launches = 0
    coll.reset()
    with kernel_shapes() as seen:
        s = serve(eng, reqs)
    return (s, {k: ln.launches for k, ln in launchers.items()}, forward_collectives(coll),
            {k: sorted(v) for k, v in seen.items()})


def _tp_logits(torch, mesh, cfg, sharded, full, toks, steps: int, ref_cfg):
    """bfloat16 logits of the prefill of `toks` (B, S) and `steps` decode
    steps fed the `ref_cfg` route's greedy tokens: sharded (every rank,
    its blocks `sharded`) and unsharded (rank 0, the whole tree `full`),
    each against the `ref_cfg` route (rank 0) on the same weights.
    Returns the sharded run's collectives and rank 0's max |diff| of each
    route over all rows and positions (None on other ranks)."""
    from repro_torch.models import transformer
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel import sharding

    bsz, n = toks.shape

    def run(c, params, feed):
        last, cache = transformer.prefill(c, params, toks, n + steps + 1)
        out = [last[:, -1].float()]
        for t in feed:
            lg, cache = transformer.decode_step(c, params, t[:, None], cache)
            out.append(lg[:, -1].float())
        return torch.stack(out)

    feed = torch.zeros((steps, bsz), dtype=torch.long, device=mesh.device)
    if mesh.rank == 0:               # the reference route's greedy tokens
        last, cache = transformer.prefill(ref_cfg, full, toks, n + steps + 1)
        for i in range(steps):
            feed[i] = last[:, -1].argmax(-1)
            last, cache = transformer.decode_step(ref_cfg, full, feed[i][:, None], cache)
    feed = coll.broadcast(feed, mesh)
    coll.reset()
    with sharding.use_mesh(mesh):
        got = run(cfg, sharded, feed)
    out = {"collectives": forward_collectives(coll)}
    if mesh.rank != 0:
        return out
    ref, plain = run(ref_cfg, full, feed), run(cfg, full, feed)
    for x in (got, plain, ref):
        check(bool(torch.isfinite(x).all()), "tp logits: non-finite logits")
    return dict(out, sharded=float((got - ref).abs().max()),
                unsharded=float((plain - ref).abs().max()),
                sharded_vs_unsharded=float((got - plain).abs().max()))


def _tp_tokens(torch, mesh, name, cfg, prompts, max_new, want_equal=True, max_batch=4,
               **eng_kw):
    """`cfg` served on the mesh, each rank drawing its blocks of the seeded
    weights (`api.init_params(mesh=)`), and (rank 0, where `want_equal`)
    unsharded from the whole draw; returns rank 0's record: launches,
    collectives and kernel shapes of the sharded run, whether the token
    streams are equal (held equal)."""
    import torch.distributed as dist

    from repro_torch.serving.engine import Request, ServingEngine

    eng = ServingEngine(cfg, _draw_blocks(torch, mesh, cfg), max_batch=max_batch, mesh=mesh,
                        **eng_kw)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=max_new) for i, p in enumerate(prompts)]
    s, launches, colls, shapes = _tp_serve(torch, eng, reqs, cfg.family != "transformer")
    check(all(r.finish_reason == "max_new_tokens" for r in reqs) and s["nan_steps"] == 0,
          f"tp {name}: a request did not finish with {max_new} tokens")
    out = {"launches": launches, "collectives": colls, "shapes": shapes, "summary": s,
           "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9}
    del eng
    free(torch)
    if mesh.rank == 0 and want_equal:
        _, rreqs = _serve_unsharded(torch, mesh.device, cfg, prompts, max_new,
                                    max_batch=max_batch, **eng_kw)
        same = sum(a.out_tokens == b.out_tokens for a, b in zip(reqs, rreqs))
        out["equal_streams"] = f"{same}/{len(reqs)}"
        check(same == len(reqs), f"tp {name}: {same}/{len(reqs)} request streams equal "
                                 f"the unsharded engine's")
    dist.barrier()
    return out


def _draw_blocks(torch, mesh, cfg, hold: str = "tp"):
    """This rank's blocks of `cfg`'s weights from seed 1, held as `hold`,
    the ranks drawing one at a time (a rank's draw holds one layer's
    whole leaf, deepseek's expert leaf 15 GB in float32)."""
    import torch.distributed as dist

    from repro_torch.models import api

    params = None
    for r in range(mesh.size):
        if mesh.rank == r:
            params = api.init_params(cfg, 1, mesh=mesh, hold=hold)
            free(torch)
        dist.barrier()
    return params


def _serve_unsharded(torch, device, cfg, prompts, max_new, params=None, max_batch=4,
                     **eng_kw):
    """`cfg` served on `device` alone (no mesh) from the seeded weights (or
    `params`): ((summary, launches, collectives, shapes), the requests)."""
    from repro_torch.models import api
    from repro_torch.serving.engine import Request, ServingEngine

    if params is None:
        params = api.init_params(cfg, 1, device=device)
    eng = ServingEngine(cfg, params, max_batch=max_batch, device=device, **eng_kw)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=max_new) for i, p in enumerate(prompts)]
    got = _tp_serve(torch, eng, reqs)
    del eng, params
    free(torch)
    return got, reqs


def _tp_rank(rank: int, world: int, store: str, policy: str, out: str) -> None:
    """One rank of `tp_path_phase`: gloo over the one card, a (1, world)
    mesh; rank 0 writes the record."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.policy import load_policy
    from repro_torch.launch.serve import build_engine, serve
    from repro_torch.models import api
    from repro_torch.parallel import sharding

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=600))
    mesh = make_host_mesh(world, backend="gloo", device_type="cuda")
    rec = {}
    kern = dict(attn_impl="flash", mlp_impl="fused", norm_impl="fused")

    # full width: smollm-135m, `MESH_SMOLLM_LAYERS` of 30 layers, bf16, the
    # three flags, the main path's 12 requests through the paged engine
    cfg = configs.get_config("smollm-135m").replace(n_layers=MESH_SMOLLM_LAYERS)
    t0 = time.perf_counter()
    eng = build_engine(cfg, policy=load_policy(policy), max_batch=4, max_len=512, seed=0,
                       mesh=mesh, log=lambda s: None)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    check(eng.paged and eng.mcfg.attn_impl == "flash", "tp smollm: not the paged flash engine")
    # one gloo all_reduce of a decode step's activations between the ranks
    # (host clock around 50 calls ending in a synchronize)
    from repro_torch.parallel import collectives as coll
    act = torch.ones((DECODE_N, cfg.d_model), dtype=torch.bfloat16, device=mesh.device)
    for _ in range(5):
        coll.all_reduce(act, mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        coll.all_reduce(act, mesh)
    torch.cuda.synchronize()
    all_reduce_ms = (time.perf_counter() - t0) / 50 * 1e3
    rng = np.random.default_rng(0)
    serve(eng, _requests(rng, cfg.vocab, 2, 16, 40, 4))            # warm-up
    reqs = _requests(rng, cfg.vocab, 12, 16, 300, 32)
    s, launches, colls, shapes = _tp_serve(torch, eng, reqs)
    L = cfg.n_layers
    calls = s["prefills"] + s["decode_steps"]
    want = {"fused_rmsnorm": (L + 1) * calls, "fused_rmsnorm_residual": L * calls,
            "fused_mlp": L * calls, "flash_attention": L * s["prefills"],
            "paged_decode": L * s["decode_steps"], "moe_mlp": 0}
    check(launches == want, f"tp smollm rank {rank}: launches {launches}, expected {want}")
    # heads 9 / 3 do not split over 2 (replicated attention: no reduce);
    # the MLP (F 1536) and the vocab (49152) do
    cwant = {"all_reduce": (L + 1) * calls, "all_gather": calls, "all_to_all": 0,
             "broadcast": calls}
    print(f"[smoke] tp smollm rank {rank}: launches {launches}, collectives {colls}; a layer "
          f"a step: fused_mlp {launches['fused_mlp'] / calls / L:g}, all_reduce "
          f"{(colls['all_reduce'] - calls) / calls / L:g} (+1 a step for the embedding), "
          f"all_gather {colls['all_gather'] / calls:g} a step; kernel shapes {shapes}",
          flush=True)
    check(colls == cwant, f"tp smollm rank {rank}: collectives {colls}, expected {cwant}")
    check(shapes["fused_mlp"] == [(cfg.d_model, cfg.d_ff // world)] and
          shapes["flash_attention"] == [(9, 3, 64)] and
          shapes["paged_decode_attention"] == [(9, 3, 64)],
          f"tp smollm rank {rank}: kernel shapes {shapes}")
    check(all(r.finish_reason == "max_new_tokens" and len(r.out_tokens) == 32 for r in reqs)
          and s["nan_steps"] == 0, "tp smollm: a request did not finish with 32 tokens")
    full = api.init_params(eng.mcfg, 0, device=mesh.device) if rank == 0 else None
    toks = torch.as_tensor(np.random.default_rng(4).integers(0, cfg.vocab, (1, 300)),
                           device=mesh.device)
    ref32 = eng.mcfg.replace(dtype="float32", attn_impl="einsum", mlp_impl="dense",
                             norm_impl="ref")
    logits = _tp_logits(torch, mesh, eng.mcfg, eng.params, full, toks, 3, ref32)
    rec["smollm"] = {"n_layers": L, "all_reduce_ms": all_reduce_ms,
                     "summary": s, "launches": launches, "collectives": colls,
                     "shapes": shapes, "build_engine_s": build_s,
                     "per_layer_per_step": {"all_reduce": colls["all_reduce"] / calls,
                                            "fused_mlp": launches["fused_mlp"] / calls / L},
                     "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9}
    if rank == 0:
        slack, floor = TP_LOGITS_SLACK
        rec["smollm"]["logits"] = logits
        check(logits["sharded"] <= slack * logits["unsharded"] + floor,
              f"tp smollm: bf16 logits off the float32 route by {logits}")
    del eng, full
    free(torch)

    # token equality in float32 at cut depth: smollm-135m 4 layers (paged,
    # the pool route), h2o-danube-1.8b 2 layers (16 / 4 heads a rank)
    prng = np.random.default_rng(21)
    prompts = [prng.integers(0, 32000, size=int(n)).astype(np.int32)
               for n in prng.integers(16, 301, size=4)]
    f32 = dict(kern, dtype="float32", param_dtype="float32")
    rec["smollm_f32"] = _tp_tokens(
        torch, mesh, "smollm f32", configs.get_config("smollm-135m").replace(n_layers=4, **f32),
        prompts, 16, max_len=512)
    rec["danube_f32"] = _tp_tokens(
        torch, mesh, "danube f32",
        configs.get_config("h2o-danube-1.8b").replace(n_layers=2, **f32), prompts, 16,
        max_len=512)
    check(rec["danube_f32"]["shapes"]["flash_attention"] == [(16, 4, 80)] and
          rec["danube_f32"]["shapes"]["fused_mlp"] == [(2560, 3456)],
          f"tp danube: kernel shapes {rec['danube_f32']['shapes']}")
    # mixtral-8x7b with EP (4 experts a rank), float32, 2 layers: token-equal
    rec["mixtral_ep_f32"] = _tp_tokens(
        torch, mesh, "mixtral EP f32",
        configs.get_config("mixtral-8x7b").replace(n_layers=2, **f32), prompts, 8,
        max_len=512)
    check(rec["mixtral_ep_f32"]["shapes"]["moe_mlp"] == [(4, 4096, 14336)] and
          rec["mixtral_ep_f32"]["shapes"]["flash_attention"] == [(16, 4, 128)],
          f"tp mixtral EP: kernel shapes {rec['mixtral_ep_f32']['shapes']}")
    # deepseek-v3 (1 dense + 1 MoE layer, bf16, flash off) with the
    # shard_map dispatch: even prompts, so prefill and decode both split
    even = [p[: len(p) // 2 * 2] for p in prompts]
    dcfg = configs.get_config("deepseek-v3-671b").replace(
        n_layers=2, first_dense_layers=1, moe_shard_map=True, mlp_impl="fused",
        norm_impl="fused")
    ds = _tp_tokens(torch, mesh, "deepseek shard_map", dcfg, even, 8, want_equal=False,
                    max_len=512)
    dcalls = ds["summary"]["prefills"] + ds["summary"]["decode_steps"]
    check(ds["collectives"]["all_to_all"] == 2 * dcalls and
          ds["launches"]["moe_mlp"] == dcalls and
          ds["shapes"]["moe_mlp"] == [(128, 7168, 2048)],
          f"tp deepseek shard_map: {ds['collectives']}, {ds['launches']}, {ds['shapes']}")
    # its tokens are not the unsharded engine's: each rank's capacity
    # (cap_l, no floor of 8) drops other choices than the unsharded
    # buffers do.  With a capacity factor of E / k no choice is dropped on
    # either side, so the dispatch (the all_to_all's block order, the
    # gather) must give the unsharded logits: two rows of 64 tokens and 3
    # decode steps (every call splits over the ranks), within
    # `TP_LOGITS_SLACK` of the unsharded kernel route's distance from the
    # bf16 plain route (a float32 route would cast the 256 experts to
    # 45 GB).  The other ranks draw their blocks first; rank 0 then draws
    # the whole 27 GB tree and cuts its blocks out of it (`shard_params`:
    # the blocks `init_params(mesh=)` draws, without a second draw's
    # float32 transient)
    nd = dcfg.replace(capacity_factor=dcfg.n_experts / dcfg.top_k)
    local = full = None
    if rank != 0:
        local = api.init_params(nd, 1, mesh=mesh)
    dist.barrier()
    if rank == 0:
        full = api.init_params(nd, 1, device=mesh.device)
        local = sharding.shard_params(full, mesh, nd)
    free(torch)
    toks = torch.as_tensor(np.random.default_rng(5).integers(0, nd.vocab, (2, 64)),
                           device=mesh.device)
    dl = _tp_logits(torch, mesh, nd, local, full, toks, 3,
                    nd.replace(mlp_impl="dense", norm_impl="ref"))
    check(dl["collectives"]["all_to_all"] == 2 * 4,
          f"tp deepseek shard_map logits: collectives {dl['collectives']}, expected "
          f"2 all_to_all a call over 4 calls")
    ds["logits_no_drop"] = dl
    if rank == 0:
        slack, floor = TP_LOGITS_SLACK
        check(dl["sharded"] <= slack * dl["unsharded"] + floor,
              f"tp deepseek shard_map: bf16 logits off the plain route by {dl}")
    del local, full
    free(torch)
    rec["deepseek_shard_map"] = ds
    dist.barrier()
    if rank == 0:
        # mixtral-8x7b with moe_groups=4 on this one rank (no mesh): bf16 at
        # the config's capacity, then float32 with a capacity factor of
        # E / k (no choice dropped, per group or over all tokens) token-
        # equal to moe_groups=0 on the same weights
        gcfg = configs.get_config("mixtral-8x7b").replace(n_layers=2, moe_groups=4,
                                                          mlp_impl="fused", norm_impl="fused")
        four = [p[: len(p) // 4 * 4] for p in prompts]
        (gs, gl, _, gshapes), greqs = _serve_unsharded(torch, mesh.device, gcfg, four, 8,
                                                       max_len=512)
        gcalls = gs["prefills"] + gs["decode_steps"]
        check(gl["moe_mlp"] == 2 * gcalls and gs["nan_steps"] == 0 and
              all(r.finish_reason == "max_new_tokens" for r in greqs),
              f"mixtral moe_groups=4: launches {gl}, summary {gs}")
        g32 = gcfg.replace(capacity_factor=gcfg.n_experts / gcfg.top_k, **f32)
        params = api.init_params(g32, 1, device=mesh.device)
        _, g32reqs = _serve_unsharded(torch, mesh.device, g32, four, 8, params=params,
                                      max_len=512)
        _, refreqs = _serve_unsharded(torch, mesh.device, g32.replace(moe_groups=0), four, 8,
                                      params=params, max_len=512)
        del params
        free(torch)
        same = sum(a.out_tokens == b.out_tokens for a, b in zip(g32reqs, refreqs))
        check(same == len(four), f"mixtral moe_groups=4 f32: {same}/{len(four)} streams "
                                 f"equal moe_groups=0's")
        rec["mixtral_groups"] = {"summary": gs, "launches": gl, "shapes": gshapes,
                                 "equal_streams": f"{same}/{len(four)} (f32, no drops, "
                                                  f"against moe_groups=0)"}
        Path(out).write_text(json.dumps(rec))
    dist.barrier()
    dist.destroy_process_group()


def tp_path_phase(torch) -> dict:
    """Serving on a mesh: two ranks spawned on the one card, joined over
    gloo (NCCL takes one card a rank), a (1, 2) mesh (`_tp_rank`).  At
    full width smollm-135m (6 of 30 layers, bf16, the three flags) serves the
    main path's 12 requests through the paged engine with tensor
    parallelism: per rank, every kernel launch and collective per layer
    per step must be what the sharding implies (the MLP at F 768, the
    vocab split, smollm's 9 / 3 heads whole on each rank), and its bf16
    logits of a 300-token prefill and 3 decode steps must lie within
    `TP_LOGITS_SLACK` of the unsharded engine's distance from the float32
    plain route.  Then at cut depth: smollm-135m (4 layers) and
    h2o-danube-1.8b (2 layers, 16 / 4 heads of 80 a rank) in float32 and
    mixtral-8x7b with EP (2 layers, float32, moe_mlp at E 4) token-equal
    to the unsharded engine on the card; deepseek-v3 (2 layers, bf16)
    with the shard_map dispatch (two all_to_alls and moe_mlp at E 128 a
    MoE layer a step; with a capacity factor of E / k its bf16 logits of
    2 x 64 tokens and 3 decode steps within `TP_LOGITS_SLACK` of the
    unsharded kernel route's distance from the bf16 plain route); and
    mixtral-8x7b with moe_groups=4 on one rank (bf16 at its own
    capacity; float32 at E / k token-equal to moe_groups=0).
    Tokens/s, TTFT and TPOT are printed as what they are: two ranks
    sharing one card (no speed of parallelism is measured)."""
    import tempfile

    import torch.multiprocessing as mp

    free(torch)
    policy = smoke_policy("smollm-135m")
    tmp = Path(tempfile.mkdtemp(prefix="tp_smoke_"))
    out = tmp / "rank0.json"
    t0 = time.perf_counter()
    mp.start_processes(_tp_rank, args=(TP, str(tmp / "store"), str(policy), str(out)),
                       nprocs=TP, join=True, start_method="spawn")
    rec = json.loads(out.read_text())
    secs = time.perf_counter() - t0
    sm = rec["smollm"]
    s = sm["summary"]
    card = card_line()
    print(f"[smoke] tp path smollm-135m {sm['n_layers']}L bf16 on a (1, {TP}) mesh, two ranks share one "
          f"card ({card}): {s['tokens_out']} tokens, {s['prefills']} prefills, "
          f"{s['decode_steps']} decode steps in {s['seconds']:.3f}s = "
          f"{s['tokens_per_s']:.1f} tok/s (two ranks share one card); TTFT p50 "
          f"{s['ttft_p50_ms']:.1f} ms (two ranks share one card), TPOT p50 "
          f"{s['tpot_p50_ms']:.2f} ms (two ranks share one card); one gloo all_reduce of "
          f"{DECODE_N} x 576 bf16 {sm['all_reduce_ms']:.3f} ms", flush=True)
    print(f"[smoke] tp path rank 0 launches {sm['launches']}, collectives "
          f"{sm['collectives']}, per layer per step {sm['per_layer_per_step']}, kernel "
          f"shapes {sm['shapes']}; bf16 logits against the float32 plain route "
          f"{sm['logits']} (bound {TP_LOGITS_SLACK[0]} x unsharded + "
          f"{TP_LOGITS_SLACK[1]})", flush=True)
    for key in ("smollm_f32", "danube_f32", "mixtral_ep_f32", "deepseek_shard_map",
                "mixtral_groups"):
        r = rec[key]
        print(f"[smoke] tp {key}: equal streams {r.get('equal_streams', 'not compared')}, "
              f"launches {r['launches']}, collectives {r.get('collectives', 'one rank')}, "
              f"kernel shapes {r['shapes']}, {r['summary']['tokens_per_s']:.1f} tok/s",
              flush=True)
    print(json.dumps({"tp_path": dict(rec, seconds=secs, card=card)}), flush=True)
    return rec


def _fam_logits(torch, mesh, cfg, sharded, full, batch, steps: int, ref_cfg):
    """`_tp_logits` through `api` for any family: bfloat16 logits of the
    prefill of `batch` and `steps` decode steps fed the `ref_cfg` route's
    greedy tokens, sharded (every rank) and unsharded (rank 0), each
    against the `ref_cfg` route.  Returns the sharded run's collectives
    and rank 0's max |diff| of each route."""
    from repro_torch.models import api
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel import sharding

    bsz, n = batch["tokens"].shape
    max_len = n + steps + 1

    def run(c, params, feed):
        last, cache = api.prefill(c, params, batch, max_len)
        out = [last[:, -1].float()]
        for t in feed:
            lg, cache = api.decode_step(c, params, t[:, None], cache)
            out.append(lg[:, -1].float())
        return torch.stack(out)

    feed = torch.zeros((steps, bsz), dtype=torch.long, device=mesh.device)
    if mesh.rank == 0:
        last, cache = api.prefill(ref_cfg, full, batch, max_len)
        for i in range(steps):
            feed[i] = last[:, -1].argmax(-1)
            last, cache = api.decode_step(ref_cfg, full, feed[i][:, None], cache)
    feed = coll.broadcast(feed, mesh)
    coll.reset()
    with sharding.use_mesh(mesh):
        got = run(cfg, sharded, feed)
    out = {"collectives": forward_collectives(coll)}
    if mesh.rank != 0:
        return out
    ref, plain = run(ref_cfg, full, feed), run(cfg, full, feed)
    for x in (got, plain, ref):
        check(bool(torch.isfinite(x).all()), f"{cfg.name} tp logits: non-finite logits")
    return dict(out, sharded=float((got - ref).abs().max()),
                unsharded=float((plain - ref).abs().max()),
                sharded_vs_unsharded=float((got - plain).abs().max()))


def _fam_path(torch, mesh, arch: str) -> dict:
    """`arch` at full width (bfloat16, weights from seed 0, this rank's
    blocks; rwkv6-3b and recurrentgemma-2b `FAM_LAYERS` deep) through
    `launch.serve` on the mesh: 8 requests (whisper: 4-64
    token prompts over `WHISPER_ENC` frames), 32 new tokens each; every
    kernel launch and collective per layer per step as the sharding
    implies; the bf16 logits of a prefill and 3 decode steps within
    `TP_LOGITS_SLACK` of the unsharded engine's distance from the float32
    plain route."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.launch.serve import build_engine, serve
    from repro_torch.models import api, rglru
    from repro_torch.serving import workload
    from repro_torch.serving.engine import Request

    cfg = configs.get_config(arch)
    if arch in FAM_LAYERS:
        cfg = cfg.replace(n_layers=FAM_LAYERS[arch])
    if cfg.family == "rglru":
        cfg = cfg.replace(**RGLRU_KERNELS)
    whisper = cfg.family == "whisper"
    rng = np.random.default_rng(0)

    def reqs(n, lo, hi, max_new):
        if not whisper:
            return _requests(rng, cfg.vocab, n, lo, hi, max_new)
        return [Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=int(p)).astype(np.int32),
                        max_new_tokens=max_new,
                        frames=workload.synthetic_frames(rng, WHISPER_ENC, cfg.d_model))
                for i, p in enumerate(rng.integers(4, 65, size=n))]

    t0 = time.perf_counter()
    eng = build_engine(cfg, max_batch=4, max_len=WHISPER_MAX_LEN if whisper else 512,
                       enc_len=WHISPER_ENC if whisper else None, seed=0, mesh=mesh,
                       log=lambda x: None)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    serve(eng, reqs(2, 16, 40, 4))                                     # warm-up
    rs = reqs(8, 16, 300, 32)
    s, launches, colls, shapes = _tp_serve(torch, eng, rs, recurrent=True)
    L, calls, pre = cfg.n_layers, s["prefills"] + s["decode_steps"], s["prefills"]
    tp = mesh.shape["model"]
    zero = dict.fromkeys(launches, 0)
    if cfg.family == "rwkv6":
        lwant = dict(zero, wkv6=L * calls)
        cwant = {"all_reduce": calls * (1 + 2 * L), "all_gather": calls * (1 + L)}
        swant = {"wkv6_bshd": [(RWKV_H // tp, RWKV_D)]}
    elif cfg.family == "rglru":
        n_attn = sum(rglru.is_attn_layer(cfg, i) for i in range(L))
        n_rec = L - n_attn
        lwant = dict(zero, rglru_scan=n_rec * calls, flash_attention=n_attn * pre,
                     fused_rmsnorm=(2 * L + 1) * calls)
        # its 10 / 1 heads do not split over 2: the attention is replicated
        cwant = {"all_reduce": calls * (1 + n_rec + L), "all_gather": calls * (1 + n_rec)}
        swant = {"rglru_scan": [(LRU_W // tp,)],
                 "flash_attention": [(cfg.n_heads, cfg.kv_heads, cfg.hd)]}
    else:
        lwant = zero
        # vocab 51,865 does not split: no embedding reduce, no logits gather
        cwant = {"all_reduce": pre * 2 * cfg.n_enc_layers + calls * 3 * L, "all_gather": 0}
        swant = {}
    cwant.update(all_to_all=0, broadcast=calls)
    layers = L + (cfg.n_enc_layers if whisper else 0)
    print(f"[smoke] fam mesh {arch} rank {mesh.rank}: launches {launches}, collectives "
          f"{colls}; a layer a step: all_reduce {colls['all_reduce'] / calls / layers:.3f}, "
          f"all_gather {colls['all_gather'] / calls / layers:.3f}; kernel shapes "
          f"{ {k: v for k, v in shapes.items() if v} }", flush=True)
    check(launches == lwant, f"fam mesh {arch} rank {mesh.rank}: launches {launches}, "
                             f"expected {lwant}")
    check(colls == cwant, f"fam mesh {arch} rank {mesh.rank}: collectives {colls}, "
                          f"expected {cwant}")
    check(all(shapes[k] == v for k, v in swant.items()),
          f"fam mesh {arch} rank {mesh.rank}: kernel shapes {shapes}, expected {swant}")
    check(all(r.finish_reason == "max_new_tokens" and len(r.out_tokens) == 32 for r in rs)
          and s["nan_steps"] == 0, f"fam mesh {arch}: a request did not finish with 32 tokens")
    full = api.init_params(cfg, 0, device=mesh.device) if mesh.rank == 0 else None
    lrng = np.random.default_rng(4)
    batch = {"tokens": torch.as_tensor(lrng.integers(0, cfg.vocab, (1, 64 if whisper else 300)),
                                       device=mesh.device)}
    if whisper:
        batch["embeds"] = torch.as_tensor(workload.synthetic_frames(
            lrng, WHISPER_ENC, cfg.d_model)[None], device=mesh.device)
    ref32 = cfg.replace(dtype="float32", attn_impl="einsum", mlp_impl="dense",
                        norm_impl="ref")
    logits = _fam_logits(torch, mesh, eng.mcfg, eng.params, full, batch, 3, ref32)
    rec = {"n_layers": L, "summary": s, "launches": launches, "collectives": colls,
           "shapes": {k: v for k, v in shapes.items() if v}, "build_engine_s": build_s,
           "per_layer_per_step": {"all_reduce": colls["all_reduce"] / calls / layers,
                                  "all_gather": colls["all_gather"] / calls / layers},
           "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9}
    if mesh.rank == 0:
        slack, floor = TP_LOGITS_SLACK
        rec["logits"] = logits
        check(logits["sharded"] <= slack * logits["unsharded"] + floor,
              f"fam mesh {arch}: bf16 logits off the float32 route by {logits}")
    del eng, full
    free(torch)
    return rec


def _spec_mesh(torch, mesh, policy: str) -> dict:
    """Spec-decode on the mesh: smollm-135m (6 of 30 layers, bf16, the three
    flags) with the CLI's 7-layer shared-trunk draft, k `SPEC_K`, 8
    requests of 16-300 tokens, 32 new each, through `serve_specdec(mesh=)`
    (the target sharded, the draft whole on each rank), beside the
    one-card `SpecDecodeEngine` on the same weights (the share of equal
    streams and the acceptance, printed: the sharded MLP rounds its
    partial sums once more); then at `SPEC_F32_LAYERS` layers in float32
    (a 2-layer draft) tokens and acceptance counts equal to the one-card
    engine's."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.launch.policy import load_policy
    from repro_torch.launch.serve import configure, serve, serve_specdec
    from repro_torch.models import api
    from repro_torch.parallel import collectives as coll
    from repro_torch.serving.specdec import SpecDecodeEngine, shared_trunk_draft

    cfg, kw = configure(configs.get_config("smollm-135m").replace(n_layers=MESH_SMOLLM_LAYERS),
                        policy=load_policy(policy),
                        device=mesh.device, log=lambda x: None)
    out = {}
    for tag, c, max_new in (("bf16", cfg, 32),
                            ("f32", cfg.replace(n_layers=SPEC_F32_LAYERS, dtype="float32",
                                                param_dtype="float32"), 16)):
        full = api.init_params(c, 0, device=mesh.device)    # the draft is replicated

        def requests():
            return _requests(np.random.default_rng(9), c.vocab, 8, 16, 300, max_new)

        launchers = _tp_launchers()
        for ln in launchers.values():
            ln.launches = 0
        coll.reset()
        with kernel_shapes() as seen:
            reqs = requests()
            s = serve_specdec(c, full, reqs, k=SPEC_K, max_len=512, mesh=mesh,
                              log=lambda x: None, **kw)
        launches = {k: ln.launches for k, ln in launchers.items()}
        colls = forward_collectives(coll)
        eng = s.pop("engine")
        n_draft = eng.draft_cfg.n_layers
        pre, ver = s["prefills"], s["decode_steps"]
        stats = eng.spec_stats
        rec = {"summary": s, "launches": launches, "collectives": colls,
               "shapes": {k: sorted(v) for k, v in seen.items() if v},
               "draft_layers": n_draft,
               "spec_stats": [stats.iterations, stats.proposed, stats.accepted, stats.bonus]}
        del eng
        # every target call (prefills, verifies) reduces its MLPs and the
        # embedding and gathers the vocab; rank 0's first tokens, drafts and
        # accepted tokens are broadcast
        cwant = {"all_reduce": (pre + ver) * (1 + c.n_layers), "all_gather": pre + ver,
                 "all_to_all": 0, "broadcast": pre + 2 * ver}
        check(colls == cwant, f"spec mesh {tag}: collectives {colls}, expected {cwant}")
        check(launches["flash_attention"] == (c.n_layers + n_draft) * pre
              and launches["fused_mlp"] > 0
              and (c.d_model, c.d_ff // mesh.shape["model"]) in seen["fused_mlp"],
              f"spec mesh {tag}: launches {launches}, shapes {rec['shapes']}")
        check(all(r.finish_reason == "max_new_tokens" for r in reqs) and s["nan_steps"] == 0,
              f"spec mesh {tag}: a request did not finish")
        if mesh.rank == 0:
            dcfg, dparams = shared_trunk_draft(c, full, n_draft)
            one = SpecDecodeEngine(c, full, dcfg, dparams, k=SPEC_K, max_len=512, **kw)
            ref = requests()
            serve(one, ref)
            same = sum(a.out_tokens == b.out_tokens for a, b in zip(reqs, ref))
            ost = one.spec_stats
            rec.update(equal_streams=f"{same}/{len(reqs)}",
                       one_card_spec_stats=[ost.iterations, ost.proposed, ost.accepted,
                                            ost.bonus])
            if tag == "f32":
                check(same == len(reqs) and rec["spec_stats"] == rec["one_card_spec_stats"],
                      f"spec mesh f32: {same}/{len(reqs)} streams equal the one-card "
                      f"engine's, spec stats {rec['spec_stats']} vs "
                      f"{rec['one_card_spec_stats']}")
            del one
        out[tag] = rec
        del full
        free(torch)
    return out


def _fam_rank(rank: int, world: int, store: str, policy: str, out: str) -> None:
    """One rank of `family_mesh_phase`: gloo over the one card, a (1,
    world) mesh; rank 0 writes the record."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.launch.mesh import make_host_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=600))
    mesh = make_host_mesh(world, backend="gloo", device_type="cuda")
    rec = {arch: _fam_path(torch, mesh, arch)
           for arch in ("rwkv6-3b", "recurrentgemma-2b", "whisper-base")}
    prng = np.random.default_rng(21)
    prompts = [prng.integers(0, 32000, size=int(n)).astype(np.int32)
               for n in prng.integers(16, 301, size=4)]
    f32 = dict(dtype="float32", param_dtype="float32")
    for arch, n in FAM_F32_LAYERS:
        cfg = configs.get_config(arch).replace(n_layers=n, **f32)
        if cfg.family == "rglru":
            cfg = cfg.replace(**RGLRU_KERNELS)
        if cfg.family == "whisper":
            cfg = cfg.replace(n_enc_layers=n)
        rec[f"{arch}_f32"] = _tp_tokens(torch, mesh, f"{arch} f32", cfg, prompts, 16,
                                        max_len=512)
    check(rec["rwkv6-3b_f32"]["shapes"]["wkv6_bshd"] == [(RWKV_H // world, RWKV_D)] and
          rec["recurrentgemma-2b_f32"]["shapes"]["rglru_scan"] == [(LRU_W // world,)],
          f"fam mesh f32: kernel shapes {rec['rwkv6-3b_f32']['shapes']}, "
          f"{rec['recurrentgemma-2b_f32']['shapes']}")
    rec["spec"] = _spec_mesh(torch, mesh, policy)
    if rank == 0:
        Path(out).write_text(json.dumps(rec))
    dist.barrier()
    dist.destroy_process_group()


def _spawn(fn, world: int, policy: str, tag: str) -> dict:
    """`fn` on `world` ranks spawned on the one card (gloo through a file
    store); rank 0's record."""
    import tempfile

    import torch.multiprocessing as mp

    tmp = Path(tempfile.mkdtemp(prefix=f"{tag}_smoke_"))
    out = tmp / "rank0.json"
    mp.start_processes(fn, args=(world, str(tmp / "store"), policy, str(out)),
                       nprocs=world, join=True, start_method="spawn")
    return json.loads(out.read_text())


def family_mesh_phase(torch) -> dict:
    """Every family on a mesh: two ranks spawned on the one card over
    gloo, a (1, 2) mesh (`_fam_rank`).  At full width, bf16: rwkv6-3b (6
    of 32 layers, wkv6 at 20 of 40 heads, decode and chunked prefill),
    recurrentgemma-2b (4 of 26 layers, rglru_scan at 1280 of 2560 channels,
    flash and the fused norm; its 10 / 1 heads replicated) and
    whisper-base (6 + 6 layers, no kernel of the port), 8 requests each,
    every rank's launches and collectives per layer per step as the
    sharding implies and bf16 logits within `TP_LOGITS_SLACK` of the
    unsharded engine's distance from the float32 route; then rwkv6 and
    whisper at 2 layers and recurrentgemma at 3 (its attention layer) in
    float32 token-equal to the unsharded engine; then spec-decode
    (`_spec_mesh`).  Tokens/s, TTFT and TPOT are printed as what they
    are: two ranks sharing one card."""
    free(torch)
    t0 = time.perf_counter()
    rec = _spawn(_fam_rank, TP, str(smoke_policy("smollm-135m")), "fam")
    secs = time.perf_counter() - t0
    card = card_line()
    for arch in ("rwkv6-3b", "recurrentgemma-2b", "whisper-base"):
        r = rec[arch]
        s = r["summary"]
        print(f"[smoke] fam mesh {arch} {r['n_layers']}L bf16 on a (1, {TP}) mesh, two ranks "
              f"share one card ({card}): {s['tokens_out']} tokens, {s['prefills']} prefills, "
              f"{s['decode_steps']} decode steps in {s['seconds']:.3f}s = "
              f"{s['tokens_per_s']:.1f} tok/s (two ranks share one card); TTFT p50 "
              f"{s['ttft_p50_ms']:.1f} ms (two ranks share one card), TPOT p50 "
              f"{s['tpot_p50_ms']:.2f} ms (two ranks share one card); rank 0 collectives a "
              f"layer a step {r['per_layer_per_step']}, kernel shapes {r['shapes']}; bf16 "
              f"logits against the float32 route {r['logits']}", flush=True)
    for key in ("rwkv6-3b_f32", "recurrentgemma-2b_f32", "whisper-base_f32"):
        r = rec[key]
        print(f"[smoke] fam mesh {key}: equal streams {r['equal_streams']}, launches "
              f"{r['launches']}, collectives {r['collectives']}", flush=True)
    for tag, r in rec["spec"].items():
        s = r["summary"]
        print(f"[smoke] spec mesh {tag} smollm-135m target sharded over {TP}, draft "
              f"{r['draft_layers']} layers whole ({card}): {s['tokens_out']} tokens in "
              f"{s['seconds']:.3f}s = {s['tokens_per_s']:.1f} tok/s (two ranks share one "
              f"card), acceptance {s['acceptance']:.3f}; spec stats {r['spec_stats']} vs "
              f"one card {r['one_card_spec_stats']}, equal streams {r['equal_streams']}",
              flush=True)
    print(json.dumps({"family_mesh": dict(rec, seconds=secs, card=card)}), flush=True)
    return rec


def _cluster_mesh_rank(rank: int, world: int, store: str, policy: str, out: str) -> None:
    """One rank of `cluster_mesh_phase`: gloo over the one card, a
    `CLUSTER_MESH` mesh, 2 replicas of tp 2; rank 0 writes the record."""
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.policy import load_policy
    from repro_torch.launch.serve import configure, serve_cluster
    from repro_torch.models import api
    from repro_torch.parallel import collectives as coll
    from repro_torch.serving import cluster as cluster_mod
    from repro_torch.serving.engine import ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=600))
    mesh = make_host_mesh(CLUSTER_MESH[1], backend="gloo", device_type="cuda")
    cfg, kw = configure(configs.get_config("smollm-135m").replace(n_layers=MESH_SMOLLM_LAYERS),
                        policy=load_policy(policy),
                        device=mesh.device, log=lambda x: None)
    built = []                  # this rank's real engines, restarts included
    new_engine = cluster_mod.ServingCluster._new_engine

    def tap(self, i):
        eng = new_engine(self, i)
        if isinstance(eng, ServingEngine):
            built.append(eng)
        return eng

    cluster_mod.ServingCluster._new_engine = tap
    launchers = _tp_launchers()
    for ln in launchers.values():
        ln.launches = 0
    coll.reset()
    s = serve_cluster(cfg, lambda m: api.init_params(cfg, 0, mesh=m), n_replicas=2,
                      rate=CLUSTER_RATE, deadline_ms=CLUSTER_MESH_DEADLINE_MS,
                      n_requests=CLUSTER_REQUESTS, max_new=32, chaos_horizon=CLUSTER_HORIZON,
                      max_len=512, mesh=mesh, log=lambda x: None, **kw)
    counts = {k: ln.launches for k, ln in launchers.items()}
    colls = forward_collectives(coll)
    cl, reqs, agg, chaos = s["cluster"], s["requests"], s["aggregate"], s["chaos"]
    steps = sum(e.stats["decode_steps"] + e.stats["nan_steps"] for e in built)
    records = [(r.rid, r.out_tokens, r.finish_reason, r.done, r.requeues, r.admit_seq,
                r.t_submit, r.t_first, r.t_done) for r in reqs]
    every = [None] * world
    dist.all_gather_object(every, records)
    check(all(x == every[0] for x in every), "cluster mesh: the ranks' request records differ")
    check(len({r.rid for r in reqs}) == CLUSTER_REQUESTS and all(
        r.done and r.finish_reason in FINISH_REASONS and len(r.out_tokens) <= r.max_new_tokens
        for r in reqs), "cluster mesh: a request is lost or not done with a finish reason")
    check(agg["n_unrouted"] == 0 and not cl.pending_work,
          f"cluster mesh: {agg['n_unrouted']} requests unrouted at the end")
    check(steps > 0 and counts["paged_decode"] == cfg.n_layers * steps,
          f"cluster mesh rank {rank}: {counts['paged_decode']} paged_decode launches for "
          f"{steps} decode steps of its replica's engines")
    check(all(counts[k] > 0 for k in ("fused_rmsnorm", "fused_rmsnorm_residual", "fused_mlp",
                                      "flash_attention", "paged_decode")),
          f"cluster mesh rank {rank}: a kernel of the path never launched: {counts}")
    check(colls["all_gather"] >= cl.stats["steps"],
          f"cluster mesh rank {rank}: {colls['all_gather']} all_gathers for "
          f"{cl.stats['steps']} cluster steps")
    if chaos.poisoned:
        check("nan" in [why for _, _, why in cl.watchdog.events],
              f"cluster mesh: a live slot was poisoned at {chaos.poisoned} but the watchdog "
              f"logged {cl.watchdog.events}")
    rec = {"aggregate": {k: agg[k] for k in (
        "tokens_out", "ttft_p50_ms", "ttft_p99_ms", "tpot_p50_ms", "tpot_p99_ms",
        "goodput_tokens", "deadline_met", "deadline_missed", "shed", "poisoned",
        "quarantined", "restarts", "requeued", "n_unrouted")},
        "seconds": s["seconds"], "tokens_per_s": s["tokens_per_s"],
        "cluster_steps": cl.stats["steps"], "launches_rank0": counts,
        "collectives_rank0": colls, "decode_steps_rank0_engines": steps,
        "chaos_events": [(e.step, e.kind, e.replica) for e in chaos.events],
        "nan_events_on_live_slots": chaos.poisoned, "watchdog": cl.watchdog.events,
        "finish_reasons": {k: sum(r.finish_reason == k for r in reqs) for k in FINISH_REASONS},
        "records_equal_on_ranks": world, "n_layers": cfg.n_layers}
    del cl, s
    free(torch)
    # token-exact: float32 at cut depth, a burst (closed loop, no deadlines)
    # under the seed-0 chaos script, against the one-card 2-replica cluster
    c32 = cfg.replace(n_layers=CLUSTER_F32_LAYERS, dtype="float32", param_dtype="float32")
    args = dict(n_replicas=2, n_requests=CLUSTER_REQUESTS, max_new=16,
                chaos_horizon=CLUSTER_HORIZON, max_len=512, log=lambda x: None)
    got = serve_cluster(c32, lambda m: api.init_params(c32, 1, mesh=m), mesh=mesh, **args,
                        **kw)
    if rank == 0:
        cluster_mod.ServingCluster._new_engine = new_engine
        want = serve_cluster(c32, api.init_params(c32, 1, device=mesh.device), **args, **kw)
        a = {r.rid: (r.out_tokens, r.finish_reason) for r in got["requests"]}
        b = {r.rid: (r.out_tokens, r.finish_reason) for r in want["requests"]}
        same = sum(a[k] == b[k] for k in b)
        rec["f32"] = {"equal_streams": f"{same}/{len(b)}",
                      "requeued": got["aggregate"]["requeued"],
                      "quarantined": got["aggregate"]["quarantined"],
                      "restarts": got["aggregate"]["restarts"]}
        check(same == len(b) and got["aggregate"]["requeued"] == want["aggregate"]["requeued"],
              f"cluster mesh f32: {same}/{len(b)} request streams equal the one-card "
              f"cluster's")
        Path(out).write_text(json.dumps(rec))
    dist.barrier()
    dist.destroy_process_group()


def cluster_mesh_phase(torch) -> dict:
    """The serving cluster on per-replica meshes: four ranks spawned on the
    one card over gloo, a (2, 2) mesh, 2 replicas x tp 2
    (`_cluster_mesh_rank`).  smollm-135m (6 of 30 layers, bf16, the three
    flags) serves `CLUSTER_REQUESTS` `LoadGenerator` requests (Poisson at
    `CLUSTER_RATE` a second, `CLUSTER_MESH_DEADLINE_MS` deadlines) under
    the seed-0 chaos script over `CLUSTER_HORIZON` steps through
    `serve_cluster(mesh=)`: every rank ends with the same request records,
    every request done with a finish reason, none unrouted, paged_decode
    once a layer for every decode step of the rank's own replica's
    engines, a nan quarantine where a nan event found a live slot; then
    at `CLUSTER_F32_LAYERS` layers in float32, the same prompts as a
    burst under the chaos script token-equal to the one-card 2-replica
    cluster's.  Tokens/s, TTFT and TPOT are printed as four ranks sharing
    one card."""
    free(torch)
    t0 = time.perf_counter()
    rec = _spawn(_cluster_mesh_rank, CLUSTER_MESH[0] * CLUSTER_MESH[1],
                 str(smoke_policy("smollm-135m")), "cluster")
    secs = time.perf_counter() - t0
    card = card_line()
    a = rec["aggregate"]
    print(f"[smoke] cluster mesh smollm-135m {rec['n_layers']}L bf16, 2 replicas x tp 2 on a "
          f"{CLUSTER_MESH} "
          f"mesh, four ranks share one card ({card}): {a['tokens_out']} tokens in "
          f"{rec['seconds']:.3f}s = {rec['tokens_per_s']:.1f} tok/s (four ranks share one "
          f"card); TTFT p50 {a['ttft_p50_ms']:.1f} ms, TPOT p50 {a['tpot_p50_ms']:.2f} ms "
          f"(four ranks share one card); chaos {rec['chaos_events']}, watchdog "
          f"{rec['watchdog']}, finish {rec['finish_reasons']}; rank 0 launches "
          f"{rec['launches_rank0']}, collectives {rec['collectives_rank0']} over "
          f"{rec['cluster_steps']} cluster steps; float32 {CLUSTER_F32_LAYERS} layers "
          f"{rec['f32']}", flush=True)
    print(json.dumps({"cluster_mesh": dict(rec, seconds=secs, card=card)}), flush=True)
    return rec


def _kv_bytes(state, mesh) -> tuple[int, int]:
    """(this rank's bytes of a dense state's KV rectangles, their bytes at
    the KV-head placement alone, where every data rank holds every slot
    and position: `kv_head_specs` over the whole rectangles)."""
    import math

    from repro_torch.models import api
    from repro_torch.parallel import sharding

    whole = api.init_cache(state.mcfg, state.max_batch, state.max_len, device="meta")
    heads = sharding.kv_head_specs(mesh, whole["segments"], state.mcfg.kv_heads,
                                   n_heads=state.mcfg.n_heads)
    model_only = sum(math.prod(sharding.local_shape(tuple(t.shape), sseg[k], mesh))
                     * t.element_size()
                     for seg, sseg in zip(whole["segments"], heads) for k, t in seg.items())
    local = sum(t.nbytes for seg in state.cache["segments"] for t in seg.values())
    return local, model_only


def _data_logits(torch, mesh, cfg, sharded, full, prompts, steps: int, ref_cfg,
                 max_len: int) -> dict:
    """bfloat16 logits of a dense KV state placed on the mesh (its slots,
    or its one slot's length, over "data"; every rank, its blocks
    `sharded`) and unplaced (rank 0, the whole tree `full`), each against
    the `ref_cfg` route (rank 0, unplaced) on the same weights: each
    prompt prefilled into a slot of its own (the prefill's last logits),
    then `steps` full-width decode steps fed the `ref_cfg` route's greedy
    tokens.  Returns rank 0's max |diff| of each route over every slot
    and step (the other ranks: {})."""
    import numpy as np

    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel import sharding
    from repro_torch.serving.state import DenseKVState

    nb = len(prompts)

    def run(c, params, m, feed=None):
        st = DenseKVState(c, nb, max_len, decode_batch=nb, compact=True, device=mesh.device)
        if m is not None:
            st.place(m)
        with sharding.use_mesh(m):
            rows = [torch.stack([st.prefill(params, b, p)[0, -1].float()
                                 for b, p in enumerate(prompts)])]
            toks = []
            for i in range(steps):
                t = rows[-1].argmax(-1) if feed is None else feed[i]
                toks.append(t)
                lg, _ = st.decode(params, t.cpu().numpy()[:, None].astype(np.int64),
                                  list(range(nb)))
                rows.append(lg[:, -1].float())
        return torch.stack(rows), torch.stack(toks)

    feed = torch.zeros((steps, nb), dtype=torch.long, device=mesh.device)
    if mesh.rank == 0:
        ref, feed = run(ref_cfg, full, None)
    feed = coll.broadcast(feed, mesh)
    got, _ = run(cfg, sharded, mesh, feed)
    if mesh.rank != 0:
        return {}
    plain, _ = run(cfg, full, None, feed)
    for x in (got, plain, ref):
        check(bool(torch.isfinite(x).all()), "data mesh logits: non-finite logits")
    return {"sharded": float((got - ref).abs().max()),
            "unsharded": float((plain - ref).abs().max()),
            "sharded_vs_unsharded": float((got - plain).abs().max())}


def _data_serve(torch, mesh, name, cfg, reqs, split, parts=2, **eng_kw) -> dict:
    """`cfg` served from the rank's blocks (seed 1) on the mesh, its dense
    state split as `split` says: launches (each kernel of the path as
    often as the layers and calls imply), collectives a decode step, the
    state's KV bytes (1 / `parts` of those of the KV-head placement
    alone), tokens a second and TPOT p50 (ranks that share one card)."""
    from repro_torch.models import transformer
    from repro_torch.parallel import collectives as coll
    from repro_torch.serving.engine import ServingEngine

    eng = ServingEngine(cfg, _draw_blocks(torch, mesh, cfg), mesh=mesh, **eng_kw)
    check(eng.state.kind == "dense" and eng.state.split == split,
          f"data mesh {name}: state {eng.state.kind} split {eng.state.split}, not {split}")
    kv, model_only = _kv_bytes(eng.state, mesh)
    check(parts * kv == model_only, f"data mesh {name} rank {mesh.rank}: {kv} KV bytes, "
                                    f"not 1/{parts} of {model_only}")
    in_decode = dict.fromkeys(coll.FORWARD, 0)
    decode = eng.state.decode

    def counted(*a, **k):          # the collectives inside the state's decode calls
        before = forward_collectives(coll)
        out = decode(*a, **k)
        for key, v in forward_collectives(coll).items():
            in_decode[key] += v - before[key]
        return out

    eng.state.decode = counted
    s, launches, colls, shapes = _tp_serve(torch, eng, reqs)
    L = cfg.n_layers
    calls = s["prefills"] + s["decode_steps"]
    n_moe = sum(n for kind, n in transformer.layer_segments(cfg) if kind == "moe")
    want = {"fused_rmsnorm": (L + 1) * calls, "fused_rmsnorm_residual": L * calls,
            "fused_mlp": (L - n_moe + (n_moe if cfg.n_shared_experts else 0)) * calls,
            "flash_attention": L * s["prefills"] if cfg.attn_impl == "flash" else 0,
            "paged_decode": 0, "moe_mlp": n_moe * calls}
    check(launches == want, f"data mesh {name} rank {mesh.rank}: launches {launches}, "
                            f"expected {want}")
    check(all(r.finish_reason == "max_new_tokens" for r in reqs) and s["nan_steps"] == 0,
          f"data mesh {name}: a request did not finish with its max_new_tokens")
    out = {"summary": s, "launches": launches, "collectives": colls, "shapes": shapes,
           "kv_bytes": kv, "kv_bytes_heads_only": model_only,
           "collectives_per_decode_step": {k: v / s["decode_steps"]
                                           for k, v in in_decode.items()},
           "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9}
    del eng
    free(torch)
    return out


def _data_mesh_rank(rank: int, world: int, store: str, policy: str, out: str) -> None:
    """One rank of `data_mesh_phase`: gloo over the one card, a (2, world /
    2) mesh; rank 0 writes the record."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import configure
    from repro_torch.launch.policy import load_policy
    from repro_torch.models import api

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=600))
    mesh = make_host_mesh(world // 2, backend="gloo", device_type="cuda")
    kern = dict(attn_impl="flash", mlp_impl="fused", norm_impl="fused")
    slack, floor = TP_LOGITS_SLACK
    rec = {}

    # smollm-135m at full width, bf16, the three flags, dense KV: 4 slots,
    # 2 a data row
    cfg, kw = configure(configs.get_config("smollm-135m").replace(n_layers=MESH_SMOLLM_LAYERS),
                        policy=load_policy(policy),
                        device=mesh.device, log=lambda x: None)
    rng = np.random.default_rng(0)
    rec["smollm"] = _data_serve(torch, mesh, "smollm", cfg,
                                _requests(rng, cfg.vocab, 8, 16, 300, 32), "rows",
                                paged=False, max_len=512, **kw)
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).astype(np.int32)
               for n in (300, 120, 57, 200)]
    full = api.init_params(cfg, 1, device=mesh.device) if rank == 0 else None
    ref32 = cfg.replace(dtype="float32", attn_impl="einsum", mlp_impl="dense",
                        norm_impl="ref")
    rec["smollm"]["logits"] = lg = _data_logits(
        torch, mesh, cfg, _draw_blocks(torch, mesh, cfg), full, prompts, 3, ref32, 512)
    if rank == 0:
        check(lg["sharded"] <= slack * lg["unsharded"] + floor,
              f"data mesh smollm: bf16 logits off the float32 route by {lg}")
    del full
    free(torch)
    # float32 at full width, `DATA_F32_LAYERS` deep: token-equal to the
    # one-rank engine
    prng = np.random.default_rng(21)
    f32 = dict(kern, dtype="float32", param_dtype="float32")
    rec["smollm_f32"] = _tp_tokens(
        torch, mesh, "data smollm f32",
        configs.get_config("smollm-135m").replace(n_layers=DATA_F32_LAYERS, **f32),
        [prng.integers(0, 32000, size=int(n)).astype(np.int32)
         for n in prng.integers(16, 301, size=6)], 16, paged=False, max_len=512)

    if mesh.shape["model"] == 1:
        # h2o-danube-1.8b at full width, cut to `DATA_SP_LAYERS` layers: one
        # slot, a prompt past the 4096 ring, its length over "data" (SP)
        dcfg = configs.get_config("h2o-danube-1.8b").replace(n_layers=DATA_SP_LAYERS, **kern)
        drng = np.random.default_rng(23)
        long = [drng.integers(0, dcfg.vocab, size=DATA_SP_PROMPT).astype(np.int32)]
        max_len = DATA_SP_PROMPT + 64
        reqs = _requests(drng, dcfg.vocab, 1, DATA_SP_PROMPT, DATA_SP_PROMPT, 32)
        rec["danube_sp"] = _data_serve(torch, mesh, "danube sp", dcfg, reqs, "seq",
                                       max_batch=1, max_len=max_len)
        check(rec["danube_sp"]["shapes"]["flash_attention"] == [(32, 8, 80)],
              f"data mesh danube: kernel shapes {rec['danube_sp']['shapes']}")
        full = api.init_params(dcfg, 1, device=mesh.device) if rank == 0 else None
        lg = _data_logits(torch, mesh, dcfg, _draw_blocks(torch, mesh, dcfg), full, long, 3,
                          dcfg.replace(dtype="float32", attn_impl="einsum", mlp_impl="dense",
                                       norm_impl="ref"), max_len)
        rec["danube_sp"]["logits"] = lg
        if rank == 0:
            check(lg["sharded"] <= slack * lg["unsharded"] + floor,
                  f"data mesh danube sp: bf16 logits off the float32 route by {lg}")
        del full
        free(torch)
        rec["danube_sp_f32"] = _tp_tokens(
            torch, mesh, "data danube sp f32", dcfg.replace(dtype="float32",
                                                            param_dtype="float32"),
            long, 16, max_batch=1, max_len=max_len)
        # mixtral-8x7b, 2 MoE layers, float32, compacted to 2 of 4 slots:
        # each row's lanes routed over the batch gathered in lane order
        mcfg = configs.get_config("mixtral-8x7b").replace(n_layers=2, **f32)
        mx = rec["mixtral_f32"] = _tp_tokens(
            torch, mesh, "data mixtral f32", mcfg,
            [prng.integers(0, 32000, size=int(n)).astype(np.int32)
             for n in prng.integers(16, 301, size=5)], 8, max_len=512, decode_batch=2)
        calls = mx["summary"]["prefills"] + mx["summary"]["decode_steps"]
        check(mx["launches"]["moe_mlp"] == mcfg.n_layers * calls and
              mx["shapes"]["moe_mlp"] == [(8, 4096, 14336)],
              f"data mesh mixtral: launches {mx['launches']}, shapes {mx['shapes']}")
    if rank == 0:
        rec["mesh"] = dict(mesh.shape)
        Path(out).write_text(json.dumps(rec))
    dist.barrier()
    dist.destroy_process_group()


def data_mesh_phase(torch) -> dict:
    """Serving with the batch over "data": ranks spawned on the one card
    over gloo on a (2, 1) and then a (2, 2) mesh (`_data_mesh_rank`).
    smollm-135m at full width (6 of 30 layers, bf16, the three flags, dense
    KV, 4 slots: 2 a data row) serves 8 requests: every rank's state at
    half the KV bytes of the KV-head placement alone, each kernel of the
    path launched as the layers and calls imply, the collectives a decode
    step printed; its bf16 logits over 4 slots (a prefill and 3 decode
    steps) within `TP_LOGITS_SLACK` of the unsharded state's distance
    from the float32 plain route; then in float32 at full width,
    `DATA_F32_LAYERS` deep, token-equal to the one-rank engine.  On (2, 1) also h2o-danube-1.8b
    at full width cut to `DATA_SP_LAYERS` layers with one slot and a
    `DATA_SP_PROMPT`-token prompt past its 4096 ring, the ring's length
    over "data" (SP): the same checks, and float32 tokens equal to the
    one-rank engine's; and mixtral-8x7b at 2 layers in float32,
    compacted to 2 of 4 slots (its capacity route over the lanes
    gathered from both rows, `moe_mlp` once a layer a call), token-equal
    to the one-rank engine.  Tokens/s and TPOT are printed as what they
    are: ranks that share one card."""
    free(torch)
    t0 = time.perf_counter()
    policy = str(smoke_policy("smollm-135m"))
    rec = {f"(2, {w // 2})": _spawn(_data_mesh_rank, w, policy, f"data{w}")
           for w in DATA_MESH_WORLDS}
    secs = time.perf_counter() - t0
    card = card_line()
    for tag, r in rec.items():
        for key in ("smollm", "danube_sp"):
            if key not in r:
                continue
            x, s = r[key], r[key]["summary"]
            print(f"[smoke] data mesh {tag} {key} bf16 ({card}): rank 0 KV "
                  f"{x['kv_bytes']} bytes (KV-head placement alone "
                  f"{x['kv_bytes_heads_only']}), {s['tokens_out']} tokens, {s['prefills']} "
                  f"prefills, {s['decode_steps']} decode steps in {s['seconds']:.3f}s = "
                  f"{s['tokens_per_s']:.1f} tok/s, TPOT p50 {s['tpot_p50_ms']:.2f} ms (ranks "
                  f"share one card); collectives a decode step in the model call "
                  f"{x['collectives_per_decode_step']} (+1 broadcast of the tokens); "
                  f"launches {x['launches']}; kernel shapes {x['shapes']}; bf16 logits "
                  f"against the float32 route "
                  f"{x['logits']}", flush=True)
        for key in ("smollm_f32", "danube_sp_f32", "mixtral_f32"):
            if key in r:
                print(f"[smoke] data mesh {tag} {key}: equal streams "
                      f"{r[key]['equal_streams']}, launches {r[key]['launches']}, "
                      f"collectives {r[key]['collectives']}", flush=True)
    print(f"[smoke] data mesh phase {secs:.1f}s", flush=True)
    print(json.dumps({"data_mesh": dict(rec, seconds=secs, card=card)}), flush=True)
    return rec


def _train_mesh_rank(rank: int, world: int, store: str, policy: str, out: str) -> None:
    """One rank of `train_mesh_phase` (a) and (b): gloo over the one card,
    a `TRAIN_MESH` mesh; rank 0 writes the record."""
    import dataclasses
    import datetime
    import shutil

    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.bridge import tree_leaves, tree_paths
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.data.pipeline import DataConfig, DataPipeline
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel import sharding
    from repro_torch.training import loop
    from repro_torch.training.optimizer import OptimizerConfig, lr_at

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=600))
    mesh = make_host_mesh(TRAIN_MESH[1], backend="gloo", device_type="cuda")
    launchers = {k: v for k, v in _tp_launchers().items()
                 if k in ("fused_rmsnorm", "fused_rmsnorm_residual", "fused_mlp",
                          "flash_attention")}
    flags = dict(attn_impl="flash", mlp_impl="fused", norm_impl="fused")
    rec: dict = {"mesh": dict(mesh.shape)}

    def by_path(tree):
        return {"/".join(map(str, k)): t for k, t in tree_paths(tree)}

    # (a) float32, 4 layers: train(mesh=) against the unsharded train; each
    # run's state is checkpointed every step so the elements past 1e-5 can
    # be read with their gradients and Adam steps
    layers, steps, rows, seq = TRAIN_MESH_F32
    cfg = configs.get_config("smollm-135m").replace(n_layers=layers, dtype="float32",
                                                    param_dtype="float32", **flags)
    ocfg = OptimizerConfig(lr=1e-4, warmup_steps=1, total_steps=steps)
    f32_dir = ROOT / "build" / "train_mesh_f32"
    if rank == 0:
        shutil.rmtree(f32_dir, ignore_errors=True)
    dist.barrier()
    tcfg = loop.TrainConfig(steps=steps, log_every=1, ckpt_every=1, ckpt_keep=steps,
                            ckpt_dir=str(f32_dir / "mesh"), seed=0)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=rows, seed=0)
    for ln in launchers.values():
        ln.launches = 0
    with kernel_shapes() as seen:
        got = loop.train(cfg, ocfg, tcfg, dcfg, mesh=mesh, log_fn=lambda _: None)
    counts = {k: ln.launches for k, ln in launchers.items()}
    want = {"fused_rmsnorm": (layers + 1) * steps, "fused_rmsnorm_residual": layers * steps,
            "fused_mlp": layers * steps, "flash_attention": layers * steps}
    check(counts == want, f"train mesh f32 rank {rank}: launches {counts}, want {want} "
          f"(the forward only)")
    tp = mesh.shape["model"]
    ht = tp if sharding.tp_plan(cfg, mesh).attn else 1     # smollm's 9 / 3 heads stay whole
    check(seen["fused_mlp"] == {(cfg.d_model, cfg.d_ff // tp)} and
          seen["flash_attention"] == {(cfg.n_heads // ht, cfg.kv_heads // ht, cfg.hd)},
          f"train mesh f32 rank {rank}: kernel shapes {seen}")
    specs = loop.param_specs(cfg, mesh)
    mine = [(p, t.cpu()) for p, t in sharding.gather_tree(got["params"], specs, mesh)]
    if rank == 0:
        ref = loop.train(cfg, ocfg, dataclasses.replace(tcfg, ckpt_dir=str(f32_dir / "ref")),
                         dcfg, device=mesh.device, log_fn=lambda _: None)
        theirs = {p: t.cpu() for p, t in by_path(ref["params"]).items()}
        loss_gap = max(abs(a - b) / abs(b) for (_, a), (_, b) in zip(got["losses"],
                                                                   ref["losses"]))
        gaps = torch.cat([(t - theirs[p]).abs().flatten() for p, t in mine])
        param_gap, n_over = float(gaps.max()), int((gaps > 1e-5).sum())
        # each element past 1e-5 (the 16 first): both runs' gradient g_k
        # (from the first moments, mu_k = b1 mu_k-1 + (1 - b1) g_k) and
        # Adam direction (mu_k / c1) / (sqrt(nu_k / c2) + eps) at every
        # step k, read from the checkpoints, beside the step's lr
        flagged = []
        for p, t in mine:
            d = (t - theirs[p]).abs().flatten()
            flagged += [(p, i, float(d[i]), float(t.flatten()[i]),
                         float(theirs[p].flatten()[i]))
                        for i in torch.nonzero(d > 1e-5).flatten().tolist()]
        flagged = flagged[:16]
        tmpl = loop.init_train_state(cfg, ocfg, tcfg, "cpu")
        moments = {}
        for side in ("mesh", "ref"):
            mgr = CheckpointManager(str(f32_dir / side))
            moments[side] = []
            for k in range(1, steps + 1):
                o = mgr.restore(tmpl, step=k)[0][1]["inner"]
                mu, nu = by_path(o["mu"]), by_path(o["nu"])
                moments[side].append([(float(mu[p].flatten()[i]), float(nu[p].flatten()[i]))
                                      for p, i, *_ in flagged])
        over = []
        for j, (p, i, gap, a, b) in enumerate(flagged):
            e = {"path": p, "index": i, "gap": gap, "param": [a, b],
                 "lr": [float(lr_at(ocfg, k)) for k in range(1, steps + 1)]}
            for side, name in (("mesh", "mesh"), ("ref", "unsharded")):
                prev, gs, dirs = 0.0, [], []
                for k, row in enumerate(moments[side], 1):
                    mu, nu = row[j]
                    gs.append((mu - ocfg.b1 * prev) / (1 - ocfg.b1))
                    dirs.append(mu / (1 - ocfg.b1 ** k)
                                / (math.sqrt(nu / (1 - ocfg.b2 ** k)) + ocfg.eps))
                    prev = mu
                e[f"g_{name}"], e[f"adam_dir_{name}"] = gs, dirs
            over.append(e)
        rec["f32"] = {"layers": layers, "steps": steps, "losses": got["losses"],
                      "unsharded_losses": ref["losses"], "loss_rel_gap": loss_gap,
                      "param_max_gap": param_gap, "params_over_1e-5": n_over,
                      "over_1e-5": over, "params": int(gaps.numel()),
                      "launches_rank0": counts,
                      "shapes_rank0": {k: sorted(v) for k, v in seen.items() if v}}
        # test_torch_train_loop's tolerance: within 1e-5 save for at most 8
        # elements, those within 2 x 2 lr (an Adam step near a zero
        # gradient is sign-like, and a sign can flip between two sums)
        check(loss_gap <= 1e-4 and n_over <= 8 and param_gap <= 4 * ocfg.lr,
              f"train mesh f32: losses {got['losses']} vs {ref['losses']} (rel gap "
              f"{loss_gap:.3g}), parameters {param_gap:.3g} apart, {n_over} past 1e-5")
    dist.barrier()
    del got, mine
    free(torch)

    # (b) bfloat16 at full width, `TRAIN_MESH_BF16_LAYERS` deep: 6 steps,
    # checkpoints, the (4, 1) reshard
    steps, rows, seq, every = TRAIN_MESH_BF16
    cfg = configs.get_config("smollm-135m").replace(n_layers=TRAIN_MESH_BF16_LAYERS, **flags)
    ocfg = OptimizerConfig(lr=3e-4, warmup_steps=2, total_steps=steps)
    ckpt_dir = ROOT / "build" / "train_mesh_ckpt"
    if rank == 0:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    dist.barrier()
    tcfg = loop.TrainConfig(steps=steps, log_every=1, ckpt_every=every,
                            ckpt_dir=str(ckpt_dir), seed=0)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=rows, seed=0)
    logged: list = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    coll.reset()
    t0 = time.perf_counter()
    got = loop.train(cfg, ocfg, tcfg, dcfg, mesh=mesh,
                     log_fn=lambda line: logged.append(time.perf_counter()))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    colls = dict(coll.COUNTS)
    losses = [v for _, v in got["losses"]]
    check(len(losses) == steps and all(math.isfinite(v) for v in losses) and
          losses[-1] < losses[0], f"train mesh bf16 rank {rank}: losses {losses}")
    # steps 1 .. every - 1: whole steps, no checkpoint save inside
    step_ms = (logged[every - 1] - logged[1]) * 1e3 / (every - 2)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    specs = loop.param_specs(cfg, mesh)
    trained = [(p, t.cpu()) for p, t in sharding.gather_tree(got["params"], specs, mesh)]
    mgr = CheckpointManager(str(ckpt_dir))
    check(mgr.steps() == list(range(every, steps + 1, every)),
          f"train mesh bf16: checkpoints {mgr.steps()}")
    del got
    free(torch)
    flat = make_host_mesh(1, backend="gloo", device_type="cuda")
    params, opt = loop.init_train_state(cfg, ocfg, tcfg, mesh=flat)
    fspecs = loop.state_specs(cfg, flat, opt)
    (params, opt), meta = mgr.restore((params, opt), shardings=fspecs, mesh=flat)
    check(meta == {"next_step": steps}, f"train mesh bf16: restored meta {meta}")
    restored = dict(sharding.gather_tree(params, loop.param_specs(cfg, flat), flat))
    check(all(torch.equal(restored[p].cpu(), t) for p, t in trained),
          f"train mesh bf16 rank {rank}: the parameters restored on {dict(flat.shape)} "
          f"differ from the ones trained on {dict(mesh.shape)}")
    (wp, wo), _ = mgr.restore((params, opt))          # the leaves read whole
    check(all(torch.equal(a, b) for a, b in zip(tree_leaves((params, opt)),
                                                tree_leaves((wp, wo)))),
          f"train mesh bf16 rank {rank}: the resharded state differs from the saved leaves")
    del wp, wo
    step = loop.make_train_step(cfg, ocfg, tcfg, mesh=flat)
    batch = {k: torch.from_numpy(v).to(flat.device)
             for k, v in DataPipeline(dcfg).batch(steps).items()}
    _, _, m = step(params, opt, batch)
    resumed = float(m["loss"])
    check(math.isfinite(resumed), f"train mesh bf16: the step after the reshard gave {resumed}")
    if rank == 0:
        fwd = {k: colls[k] / steps for k in coll.FORWARD + ("shift",) if colls[k]}
        bwd = {k: colls[k] / steps for k in coll.BACKWARD if colls[k]}
        rec["bf16"] = {"layers": cfg.n_layers, "steps": steps, "losses": losses,
                       "step_ms": step_ms, "tokens_per_s": rows * seq / (step_ms / 1e3),
                       "wall_s": wall, "peak_gb_rank0": peak_gb,
                       "collectives_per_step_fwd": fwd, "collectives_per_step_bwd": bwd,
                       "checkpoints": mgr.steps(), "reshard_mesh": dict(flat.shape),
                       "resumed_loss": resumed}
        Path(out).write_text(json.dumps(rec))
    dist.barrier()
    dist.destroy_process_group()


def _pipe_rank(rank: int, world: int, store: str, policy: str, out: str) -> None:
    """One rank of `train_mesh_phase` (c): gloo over the one card, a
    ("pp",) mesh of `world` stages; rank 0 writes the record."""
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.bridge import tree_map, tree_paths
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import api, transformer
    from repro_torch.parallel import pipeline, sharding

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=600))
    pp = make_mesh((world,), ("pp",), backend="gloo", device_type="cuda")
    dev = pp.device
    n_micro, mb, seq = PIPE_MICRO
    flags = dict(attn_impl="flash", mlp_impl="fused", norm_impl="fused")
    launchers = {k: v for k, v in _tp_launchers().items()
                 if k in ("fused_rmsnorm", "fused_rmsnorm_residual", "fused_mlp",
                          "flash_attention")}
    rec: dict = {"stages": world}

    def run(cfg, grad: bool):
        stack = api.init_params(cfg, 0, device=dev)["segments"][0]["kind_dense"]
        mine = tree_map(lambda t: sharding.local_slice(t, ("pp",) + (None,) * t.dim(), pp),
                        pipeline.split_stages(stack, world))
        gen = torch.Generator(device=dev).manual_seed(5)
        x = torch.randn((n_micro, mb, seq, cfg.d_model), generator=gen, device=dev,
                        dtype=torch.float32).to(cfg.tdtype)
        pos = torch.arange(seq, device=dev)[None].expand(mb, seq)
        rope = transformer.rope_for(cfg, pos)

        def layer_fn(p, h):
            for lp in transformer._layers(p):
                h = transformer.layer_fwd(cfg, "dense", lp, h, rope)[0]
            return h

        if not grad:
            for ln in launchers.values():
                ln.launches = 0
            with torch.no_grad():
                y = pipeline.pipeline_apply(layer_fn, mine, x, mesh=pp)
            counts = {k: ln.launches for k, ln in launchers.items()}
            with torch.no_grad():
                ref = torch.stack([layer_fn(stack, x[i]) for i in range(n_micro)]) \
                    if rank == 0 else None
            return y, ref, counts
        c = torch.randn(x.shape, generator=gen, device=dev)
        leaves = tree_map(lambda t: t.requires_grad_(True), mine)
        xg = x.clone().requires_grad_(True)
        (pipeline.pipeline_apply(layer_fn, leaves, xg, mesh=pp) * c).sum().backward()
        grads = tree_map(lambda t: sharding.gather_whole(
            t.grad, ("pp",) + (None,) * (t.dim() - 1), pp).flatten(0, 1), leaves)
        if rank != 0:
            return grads, None, xg.grad
        wstack = tree_map(lambda t: t.detach().clone().requires_grad_(True), stack)
        xs = x.clone().requires_grad_(True)
        (torch.stack([layer_fn(wstack, xs[i]) for i in range(n_micro)]) * c).sum().backward()
        return grads, tree_map(lambda t: t.grad, wstack), (xg.grad, xs.grad)

    cfg = configs.get_config("smollm-135m").replace(**flags)
    t0 = time.perf_counter()
    y, ref, counts = run(cfg, grad=False)
    ticks = n_micro + world - 1
    per = cfg.n_layers // world
    want = {"fused_rmsnorm": per * ticks, "fused_rmsnorm_residual": per * ticks,
            "fused_mlp": per * ticks, "flash_attention": per * ticks}
    check(counts == want, f"pipeline rank {rank}: launches {counts}, want {want}")
    if rank == 0:
        err, ok = agreement(torch, y, ref, TOL["bfloat16"])
        rec["bf16"] = {"layers": cfg.n_layers, "microbatches": [n_micro, mb, seq],
                       "max_abs_err": err, "bit_equal": bool(torch.equal(y, ref)),
                       "launches_rank0": counts, "seconds": time.perf_counter() - t0}
        check(ok, f"pipeline bf16: {err:.4g} from the sequential stack")
    del y, ref
    free(torch)
    cfg = cfg.replace(n_layers=PIPE_F32_LAYERS, dtype="float32", param_dtype="float32")
    grads, want_g, gx = run(cfg, grad=True)
    if rank == 0:
        # each leaf's largest gap relative to its largest gradient
        gaps = {"/".join(map(str, p)): float((a - b).abs().max() / b.abs().max())
                for (p, a), (_, b) in zip(tree_paths(grads), tree_paths(want_g))}
        gaps["x"] = float((gx[0] - gx[1]).abs().max() / gx[1].abs().max())
        rec["f32"] = {"layers": cfg.n_layers, "grad_gaps": gaps}
        check(max(gaps.values()) <= PIPE_GRAD_TOL,
              f"pipeline f32: gradients {gaps} from the sequential stack's")
        Path(out).write_text(json.dumps(rec))
    dist.barrier()
    dist.destroy_process_group()


def train_mesh_phase(torch) -> dict:
    """Training on a mesh: four ranks spawned on the one card over gloo, a
    `TRAIN_MESH` ("data", "model") mesh (`_train_mesh_rank`).  (a) float32
    smollm-135m at 4 layers with the fused norms, the fused MLP (at F / 2
    = 768) and flash: 3 AdamW steps of `train(mesh=)` against 3 of the
    unsharded `train` on the card on the same batches, losses within
    rtol 1e-4 and parameters within 1e-5 (at most 8 elements within 2 x
    2 lr: `test_torch_train_loop`'s tolerance), each kernel launched in the
    forward only, as often as the layers and steps imply.  (b) bfloat16
    smollm-135m at full width (`TRAIN_MESH_BF16_LAYERS` of 30 layers): 6
    steps of `train(mesh=)` on SyntheticLM 8 x 256 (4 rows a data rank),
    checkpoints every 3 steps into build/; every loss finite and the last below the first; ms a
    step, tokens/s, the peak memory of a rank and the collectives a step
    each way printed; the final checkpoint restored through
    `restore(shardings=)` onto a (4, 1) mesh of the same ranks equal bit
    for bit to the trained parameters and to the saved leaves, and one
    step from it.  (c) `_pipe_rank`: two ranks of their own, a ("pp",)
    mesh: bf16 smollm-135m's 30 layers split 15 / 15 by `split_stages`,
    the port's dense layer with the kernel flags, 4 microbatches of 2 x
    256, the output within the bf16 rows' tolerance of the sequential
    stack on one rank; float32 at 4 layers under a randn cotangent, each
    leaf's (and x's) gradient within 1e-4 of the sequential stack's,
    relative to that leaf's largest.  All readings are of ranks that share one
    card."""
    free(torch)
    t0 = time.perf_counter()
    rec = _spawn(_train_mesh_rank, TRAIN_MESH[0] * TRAIN_MESH[1], "", "train_mesh")
    t1 = time.perf_counter()
    rec["pipeline"] = _spawn(_pipe_rank, 2, "", "pipe")
    secs = time.perf_counter() - t0
    card = card_line()
    a, b, c = rec["f32"], rec["bf16"], rec["pipeline"]
    print(f"[smoke] train mesh (a) smollm-135m {a['layers']}L f32 on a {TRAIN_MESH} mesh, "
          f"four ranks share one card ({card}): losses {a['losses']} vs unsharded "
          f"{a['unsharded_losses']} (rel gap {a['loss_rel_gap']:.3g}), parameters "
          f"{a['param_max_gap']:.3g} apart ({a['params_over_1e-5']} of {a['params']} past "
          f"1e-5), rank 0 launches {a['launches_rank0']}, shapes "
          f"{a['shapes_rank0']}", flush=True)
    print(f"[smoke] train mesh (b) smollm-135m {b['layers']}L bf16 on a {TRAIN_MESH} mesh, "
          f"four ranks share one card ({card}): losses {b['losses'][0]:.4f} -> "
          f"{b['losses'][-1]:.4f}; {b['step_ms']:.1f} ms a step = {b['tokens_per_s']:.0f} "
          f"tokens/s (four ranks share one card); peak {b['peak_gb_rank0']:.2f} GB on rank "
          f"0; collectives a step forward {b['collectives_per_step_fwd']}, backward "
          f"{b['collectives_per_step_bwd']}; checkpoints {b['checkpoints']} restored onto "
          f"{b['reshard_mesh']} bit-equal, next step's loss {b['resumed_loss']:.4f}",
          flush=True)
    print(f"[smoke] train mesh (c) pipeline {c['stages']} stages ({card}): bf16 "
          f"{c['bf16']['layers']}L {c['bf16']['microbatches']} max |err| "
          f"{c['bf16']['max_abs_err']:.3g} (bit-equal {c['bf16']['bit_equal']}), launches "
          f"{c['bf16']['launches_rank0']}; f32 {c['f32']['layers']}L gradient gaps max "
          f"{max(c['f32']['grad_gaps'].values()):.3g}", flush=True)
    print(f"[smoke] train mesh phase {secs:.1f}s ((a) + (b) {t1 - t0:.1f}s)", flush=True)
    print(json.dumps({"train_mesh": dict(rec, seconds=secs, card=card)}), flush=True)
    return rec


DRYRUN_CELLS = (("smollm-135m", "train_4k", "single", {}),
                ("smollm-135m", "prefill_32k", "single", {}),
                ("smollm-135m", "decode_32k", "single", {}),
                ("smollm-135m", "long_500k", "single", {}),
                ("mixtral-8x7b", "train_4k", "multi", {}),
                ("deepseek-v3-671b", "decode_32k", "single", {}),
                ("deepseek-v3-671b", "decode_32k", "multi", {}),
                ("internlm2-1.8b", "decode_32k", "single", {"cache_seq_shard": True}),
                ("rwkv6-3b", "decode_32k", "single", {}),
                ("whisper-base", "decode_32k", "single", {"cache_seq_shard": True}),
                ("recurrentgemma-2b", "long_500k", "single", {}))
# a rank's argument bytes under JAX's own specs (`cache_shardings`, the
# param table) for the cells whose layout follows JAX's: what
# tests/test_torch_dryrun.py holds the port's traced bytes to on the CPU
DRYRUN_ARG_BYTES = {("deepseek-v3-671b", "decode_32k", "single"): 8676761636,
                    ("deepseek-v3-671b", "decode_32k", "multi"): 8048779284,
                    ("internlm2-1.8b", "decode_32k", "single"): 1846939684,
                    ("rwkv6-3b", "decode_32k", "single"): 408622116,
                    ("whisper-base", "decode_32k", "single"): 318843940,
                    ("recurrentgemma-2b", "long_500k", "single"): 364011784}
DRYRUN_CARD = (8, 512)      # rows, seq of the smollm-135m step traced and run on the card
FSDP_MESH = (2, 2)
FSDP_LAYERS = 1             # mixtral-8x7b at full width (see fsdp_path_phase)
FSDP_STEPS = 2
FSDP_BATCH = (8, 128)       # rows, seq
FSDP_F32 = dict(n_layers=2, d_model=1024, n_heads=8, kv_heads=4, d_ff=2048)
FSDP_LOSS_RTOL = 1e-3       # bf16, FSDP against TP (see fsdp_path_phase)


def dryrun_start():
    """Start the dry run's cells (`DRYRUN_CELLS`) in a process of its own:
    it traces on the CPU (fake tensors, a fake process group), so it runs
    beside the card's phases.  Returns (the process, its output file)."""
    import tempfile

    out = Path(tempfile.mkdtemp(prefix="dryrun_smoke_")) / "records.jsonl"
    code = ("import json, sys\n"
            "import os\n"
            "import torch\n"
            "os.nice(19)\n"
            "torch.set_num_threads(1)\n"
            "from repro_torch.launch import dryrun\n"
            "with open(sys.argv[1], 'w') as f:\n"
            "    for a, s, m, o in json.loads(sys.argv[2]):\n"
            "        r = dryrun.run_cell(a, s, m, save=False, verbose=False, overrides=o)\n"
            "        f.write(json.dumps(r, default=float) + '\\n')\n"
            "        f.flush()\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.Popen([sys.executable, "-c", code, str(out), json.dumps(DRYRUN_CELLS)],
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, out


def dryrun_phase(torch, started) -> dict:
    """The dry run (`repro_torch.launch.dryrun`): the cells `dryrun_start`
    traced beside the card's phases (smollm-135m on the four shapes of a
    16 x 16 mesh, mixtral-8x7b train_4k on 2 x 16 x 16 with FSDP over 512
    ranks, deepseek-v3-671b decode_32k on both meshes, internlm2-1.8b
    decode_32k with `cache_seq_shard`, rwkv6-3b decode_32k, whisper-base
    decode_32k with `cache_seq_shard` (its self and cross KV's lengths
    over "model") and recurrentgemma-2b long_500k (its ring's length and
    `h` over "data")), each `ok`,
    with their roofline terms, bottleneck and model_flops_ratio printed
    (the terms divide by the H100's data-sheet peaks: derived, not
    measured), and the argument bytes of the cells whose layout follows
    JAX's equal to JAX's specs' (`DRYRUN_ARG_BYTES`).  Then one
    smollm-135m train step (AdamW, remat "dots", `DRYRUN_CARD` rows x
    tokens) on a (1, 1) mesh, traced by the dry run and run on the card:
    the traced argument bytes must equal the card step's inputs' bytes;
    the traced peak is printed beside `torch.cuda.max_memory_allocated`
    (the trace runs the plain route, the card the same config's)."""
    from repro_torch import configs
    from repro_torch.launch import analyze, dryrun
    from repro_torch.parallel.mesh import Mesh
    from repro_torch.training import loop
    from repro_torch.training.optimizer import OptimizerConfig

    proc, out = started
    try:
        log, _ = proc.communicate(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    check(proc.returncode == 0, f"dry run process exited {proc.returncode}: {log[-3000:]}")
    recs = [json.loads(line) for line in out.read_text().splitlines() if line.strip()]
    check(len(recs) == len(DRYRUN_CELLS), f"dry run: {len(recs)} records of {len(DRYRUN_CELLS)}")
    rows = []
    for r in recs:
        check(r["ok"], f"dry run {r['arch']} x {r['shape']} x {r['mesh']}: {r.get('error')}")
        rf, ma = r["roofline"], r["memory_analysis"]
        want = DRYRUN_ARG_BYTES.get((r["arch"], r["shape"], r["mesh"]))
        check(want is None or ma["argument_size_in_bytes"] == want,
              f"dry run {r['arch']} x {r['shape']} x {r['mesh']} {r['overrides']}: argument "
              f"bytes {ma['argument_size_in_bytes']}, JAX's specs {want}")
        row = {"cell": f"{r['arch']} x {r['shape']} x {r['mesh']}"
                       + "".join(f" {k}={v}" for k, v in r["overrides"].items()),
               "hold": r["hold"], "jax_arg_bytes": want,
               "trace_s": r["trace_s"], "t_compute": rf["t_compute"],
               "t_memory": rf["t_memory"], "t_collective": rf["t_collective"],
               "bottleneck": rf["bottleneck"], "model_flops_ratio": rf["model_flops_ratio"],
               "flops": rf["flops_per_device"], "bytes": rf["bytes_per_device"],
               "collective_bytes": rf["collective_bytes_per_device"],
               "arg_bytes": ma["argument_size_in_bytes"], "temp_bytes": ma["temp_size_in_bytes"]}
        rows.append(row)
        print(f"[smoke] dryrun {row['cell']} (hold {row['hold']}, traced in "
              f"{row['trace_s']:.1f}s): t_compute {row['t_compute']:.4g}s t_memory "
              f"{row['t_memory']:.4g}s t_collective {row['t_collective']:.4g}s -> "
              f"{row['bottleneck']}; model_flops_ratio {row['model_flops_ratio']:.4f}; "
              f"args {row['arg_bytes'] / 1e9:.3f} GB, temps {row['temp_bytes'] / 1e9:.3f} GB "
              f"a rank (H100 data-sheet peaks, derived)", flush=True)

    rows_n, seq = DRYRUN_CARD
    shape = configs.Shape("card_train", seq, rows_n, "train")
    cfg = dryrun.tune_config(configs.get_config("smollm-135m"), shape)
    groups = {("data",): None, ("model",): None, ("data", "model"): None}
    names, sizes = ("data", "model"), {"data": 1, "model": 1}
    counts, memory = dryrun.trace_cell(cfg, shape, Mesh(names, sizes, 0, torch.device("cpu"),
                                                        groups), "adamw", "jax")
    mesh = Mesh(names, sizes, 0, torch.device("cuda", 0), groups)
    ocfg, tcfg = OptimizerConfig(), loop.TrainConfig()
    free(torch)
    params, opt = loop.init_train_state(cfg, ocfg, tcfg, mesh=mesh, hold="jax")
    step = loop.make_train_step(cfg, ocfg, tcfg, mesh=mesh, hold="jax")
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab, (rows_n, seq), generator=gen, device="cuda",
                              dtype=torch.int32) for k in ("tokens", "labels")}
    card_args = analyze.storage_bytes((params, opt, batch))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    new_p, new_o, m = step(params, opt, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    loss = float(m["loss"])
    del params, opt, new_p, new_o
    free(torch)
    card = card_line()
    check(math.isfinite(loss), f"dryrun card step: loss {loss}")
    check(card_args == memory["argument_size_in_bytes"],
          f"dryrun card step: traced argument bytes {memory['argument_size_in_bytes']}, the "
          f"card step's inputs {card_args}")
    res = {"cells": rows, "card_step": {
        "rows_seq": [rows_n, seq], "arg_bytes": card_args,
        "traced_arg_bytes": memory["argument_size_in_bytes"],
        "traced_peak_bytes": memory["peak_size_in_bytes"],
        "card_max_memory_allocated": peak, "loss": loss,
        "traced_flops": counts["flops"], "card": card}}
    print(f"[smoke] dryrun card step smollm-135m {rows_n} x {seq} on (1, 1) ({card}): argument "
          f"bytes traced {memory['argument_size_in_bytes']} = on the card {card_args}; peak "
          f"traced {memory['peak_size_in_bytes'] / 1e9:.3f} GB (plain route, unfused) vs "
          f"torch.cuda.max_memory_allocated {peak / 1e9:.3f} GB; loss {loss:.4f}", flush=True)
    print(json.dumps({"dryrun": res}), flush=True)
    return res


def _fsdp_rank(rank: int, world: int, store: str, policy: str, out: str) -> None:
    """One rank of `fsdp_path_phase`: gloo over the one card, a `FSDP_MESH`
    mesh; rank 0 writes the record."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.launch import analyze
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel import sharding
    from repro_torch.training import loop
    from repro_torch.training.optimizer import OptimizerConfig

    # (b) compares bits: the index backward's accumulation (the embedding's
    # gradient) and cuBLAS in their deterministic modes
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    # four ranks' large blocks on one card: segments that grow, not fragment
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=600))
    mesh = make_host_mesh(FSDP_MESH[1], backend="gloo", device_type="cuda")
    launchers = {k: v for k, v in _tp_launchers().items()
                 if k in ("fused_rmsnorm", "fused_rmsnorm_residual", "flash_attention",
                          "moe_mlp")}
    flags = dict(attn_impl="flash", mlp_impl="fused", norm_impl="fused")
    rows, seq = FSDP_BATCH

    def batch_for(vocab):
        rng = np.random.default_rng(7)
        return {k: torch.from_numpy(rng.integers(0, vocab, (rows, seq)).astype(np.int32))
                .to(mesh.device) for k in ("tokens", "labels")}

    def run(cfg, ocfg, steps, hold, gather=False):
        tcfg = loop.TrainConfig(steps=steps, seed=0)
        free(torch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        params, opt = loop.init_train_state(cfg, ocfg, tcfg, mesh=mesh, hold=hold)
        pbytes, obytes = analyze.storage_bytes(params), analyze.storage_bytes(opt)
        step = loop.make_train_step(cfg, ocfg, tcfg, mesh=mesh, hold=hold)
        batch = batch_for(cfg.vocab)
        for ln in launchers.values():
            ln.launches = 0
        coll.reset()
        losses, t0 = [], time.perf_counter()
        with kernel_shapes() as seen:
            for _ in range(steps):
                params, opt, m = step(params, opt, batch)
                losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        got = {"losses": losses, "seconds": time.perf_counter() - t0,
               "param_bytes": pbytes, "opt_bytes": obytes,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "launches": {k: ln.launches for k, ln in launchers.items()},
               "shapes": {k: sorted(v) for k, v in seen.items() if v},
               "held_gathers_per_step": coll.COUNTS["hold"] / steps,
               "collective_bytes_per_step": {k: v / steps for k, v in
                                             coll.collective_bytes().items()}}
        if gather:
            got["params"] = {p: t.cpu() for p, t in sharding.gather_tree(
                params, loop.param_specs(cfg, mesh, hold), mesh)}
        del params, opt
        free(torch)
        return got

    # (a) bf16 at full width, Adafactor (factored: the state stays small)
    cfg = configs.get_config("mixtral-8x7b").replace(n_layers=FSDP_LAYERS, **flags)
    ocfg = OptimizerConfig(name="adafactor", lr=1e-5, warmup_steps=1, total_steps=FSDP_STEPS)
    bf16 = {hold: run(cfg, ocfg, FSDP_STEPS, hold) for hold in ("fsdp", "tp")}
    # (b) float32 at a reduced width, AdamW with a clip that does not bind
    cfg32 = configs.get_config("mixtral-8x7b").replace(dtype="float32", param_dtype="float32",
                                                     **FSDP_F32, **flags)
    ocfg32 = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=2, clip_norm=1e9)
    torch.use_deterministic_algorithms(True, warn_only=True)
    f32 = {hold: run(cfg32, ocfg32, 2, hold, gather=True) for hold in ("fsdp", "tp")}
    torch.use_deterministic_algorithms(False)
    bits = all(torch.equal(t, f32["tp"]["params"][p]) for p, t in f32["fsdp"]["params"].items())
    for r in f32.values():
        del r["params"]
    recs = [None] * world
    dist.all_gather_object(recs, {"rank": rank, "bf16": bf16, "f32": f32, "f32_bit_equal": bits})
    if rank == 0:
        Path(out).write_text(json.dumps({"ranks": recs, "mesh": dict(mesh.shape),
                                         "layers": FSDP_LAYERS, "batch": [rows, seq]}))
    dist.barrier()
    dist.destroy_process_group()


def fsdp_path_phase(torch) -> dict:
    """FSDP on the card: four ranks spawned on the one card over gloo, a
    `FSDP_MESH` ("data", "model") mesh (`_fsdp_rank`).  (a) bfloat16
    mixtral-8x7b at full width (d 4096, 8 experts of F 14336, 32 / 8 heads,
    vocab 32000), cut to `FSDP_LAYERS` layer: the TP run's state does not
    fit four ranks on one 80 GB card at two, every rank holding half the
    layers' weights, their gradients, the flattened float32 DP sum and
    the optimizer's float32 temporaries.  Adafactor (deepseek's policy;
    factored, so the state stays small), `FSDP_STEPS` steps on `FSDP_BATCH`
    with the weights held as FSDP's blocks (`hold="fsdp"`) and as the TP
    blocks, the fused norms, flash and moe_mlp on: the losses finite and
    falling, the first step's equal (the same blocks enter the same
    kernels), the later ones within rtol `FSDP_LOSS_RTOL` (Adafactor's
    row, column and RMS means sum each FSDP block before the all_reduce,
    another order of float32 sums than the TP blocks'; in bf16 a
    parameter then rounds apart now and then: on an H100 at lr 3e-4 the
    third step's loss moved 2.4e-3 apart), each kernel launched in both runs as often,
    at the same shapes (the FSDP layers gather their TP blocks first), a
    rank's parameter bytes about halved (the data size); each rank's
    parameter and optimizer bytes, peak memory and kernels printed.
    (b) float32 at `FSDP_F32` (2 layers), AdamW with a clip that does not
    bind, 2 steps each way: the losses and the gathered parameters equal
    bit for bit.  All readings are of ranks that share one card."""
    free(torch)
    t0 = time.perf_counter()
    rec = _spawn(_fsdp_rank, FSDP_MESH[0] * FSDP_MESH[1], "", "fsdp")
    secs = time.perf_counter() - t0
    card = card_line()
    for r in rec["ranks"]:
        a, b = r["bf16"], r["f32"]
        gap = max(abs(x - y) / abs(y) for x, y in zip(a["fsdp"]["losses"], a["tp"]["losses"]))
        check(all(math.isfinite(v) for h in a.values() for v in h["losses"]) and
              a["fsdp"]["losses"][0] == a["tp"]["losses"][0] and gap <= FSDP_LOSS_RTOL and
              all(h["losses"][-1] < h["losses"][0] for h in a.values()),
              f"fsdp rank {r['rank']}: losses {a['fsdp']['losses']} vs {a['tp']['losses']}")
        check(a["fsdp"]["launches"] == a["tp"]["launches"] and
              all(v > 0 for v in a["fsdp"]["launches"].values()) and
              a["fsdp"]["shapes"] == a["tp"]["shapes"],
              f"fsdp rank {r['rank']}: launches {a['fsdp']['launches']} vs "
              f"{a['tp']['launches']}, shapes {a['fsdp']['shapes']} vs {a['tp']['shapes']}")
        ratio = a["tp"]["param_bytes"] / a["fsdp"]["param_bytes"]
        check(ratio >= 1.9, f"fsdp rank {r['rank']}: parameter bytes {a['fsdp']['param_bytes']}"
              f" under FSDP vs {a['tp']['param_bytes']}")
        check(b["fsdp"]["losses"] == b["tp"]["losses"] and r["f32_bit_equal"],
              f"fsdp f32 rank {r['rank']}: losses {b['fsdp']['losses']} vs "
              f"{b['tp']['losses']}, parameters bit-equal {r['f32_bit_equal']}")
        for hold in ("fsdp", "tp"):
            h = a[hold]
            print(f"[smoke] fsdp (a) mixtral-8x7b {rec['layers']}L bf16 rank {r['rank']} hold "
                  f"{hold} ({card}): params {h['param_bytes'] / 1e9:.3f} GB, optimizer "
                  f"{h['opt_bytes'] / 1e9:.3f} GB, peak {h['peak_gb']:.2f} GB, losses "
                  f"{[round(v, 5) for v in h['losses']]}, {h['seconds']:.1f}s for "
                  f"{FSDP_STEPS} steps, launches {h['launches']}, held gathers a step "
                  f"{h['held_gathers_per_step']:.0f}", flush=True)
    r0 = rec["ranks"][0]
    print(f"[smoke] fsdp (b) mixtral-8x7b f32 {FSDP_F32}: losses {r0['f32']['fsdp']['losses']}"
          f" = {r0['f32']['tp']['losses']}, parameters bit-equal {r0['f32_bit_equal']}",
          flush=True)
    print(f"[smoke] fsdp phase {secs:.1f}s", flush=True)
    print(json.dumps({"fsdp": dict(rec, seconds=secs, card=card)}), flush=True)
    return rec


# a cache length over "model", the shard_map MoE on a pod mesh and a family
# held as JAX's and FSDP's blocks (see `length_mesh_phase`)
LEN_DS = dict(n_layers=2, first_dense_layers=1)    # deepseek-v3-671b: 1 dense + 1 MoE of 61
LEN_DS_F32_EXPERTS = 16     # of 256: four float32 ranks of 256 experts do not fit 80 GB
LEN_DS_MAX_LEN = 512
LEN_MIXTRAL = (3, 2, 1500)  # (model ranks, layers of 32, max_len): see length_mesh_phase
LEN_REQUESTS = (4, 16, 300, 16)     # requests, shortest and longest prompt, new tokens
POD_MESH = (2, 1, 2)        # ("pod", "data", "model")
POD_X = (4, 64)             # rows, seq of the MoE block's input
POD_TOL = 1e-4              # float32: |port - reference| <= POD_TOL x max |reference|
POD_TIMED = 10
HOLD_ARCH, HOLD_LAYERS = "rwkv6-3b", 2
HOLD_BATCH = (8, 128)
# recurrentgemma's and whisper's decode over a split cache length (see
# `_split_decode`): layers, (rows, prompt length), max_len, hold, parts
SPLIT_RG_LAYERS = 3         # of 26: two recurrent layers and one attention layer
SPLIT_RG = {"recurrentgemma seq_shard": ((4, 2100), 4096, "jax", 2),
            "recurrentgemma one sequence": ((1, 3000), 4096, "jax", 2)}
SPLIT_WHISPER = ((4, 32), 480, "tp", 3)     # 480 self KV positions and 1500 frames over 3
SPLIT_FRAMES = 1500
SPLIT_STEPS = 8


def _shard_map_reference(torch, cfg, p, x, n_tot: int):
    """JAX's `moe_block_shard_map` on one device, from its definition: the
    tokens cut into `n_tot` chunks, each routed into capacity buffers of
    max(1, ceil(nl k / E cf)) slots, every expert over every chunk's
    buffer (batched products), the choices combined; no shared expert."""
    from repro_torch.models import transformer

    bsz, s, d = x.shape
    k, e = cfg.top_k, cfg.n_experts
    nl = bsz * s // n_tot
    cap = max(1, int(math.ceil(nl * k / e * cfg.capacity_factor)))
    plain = cfg.replace(mlp_impl="dense")
    out = []
    for xl in x.reshape(n_tot, nl, d):
        w, idx = transformer.route(cfg, p, xl)
        flat = idx.reshape(-1)
        slot, keep = transformer._slots(cfg, flat, cap)
        buf = torch.zeros((e, cap, d), dtype=x.dtype, device=x.device)
        buf.index_put_((flat, slot), torch.where(keep[:, None], xl.repeat_interleave(k, dim=0),
                                                 0), accumulate=True)
        o = transformer.expert_mlp(plain, p, buf)
        g = torch.where(keep[:, None], o[flat, slot], 0)
        out.append((g.reshape(nl, k, d) * w[..., None]).sum(1))
    return torch.cat(out).reshape(bsz, s, d)


def _pod_moe(torch, mesh) -> dict:
    """mixtral-8x7b's MoE block at full width on the pod mesh, dispatched by
    `moe_block_shard_map`: float32 (rows whole, and rows split over
    ("pod", "data")) against `_shard_map_reference` on rank 0; then bf16
    calls timed by CUDA events, with the collectives and moe_mlp launches
    a call."""
    from repro_torch import configs
    from repro_torch.kernels.moe_mlp import kernel as ek
    from repro_torch.models import transformer
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel import sharding

    base = configs.get_config("mixtral-8x7b").replace(n_layers=1, moe_shard_map=True,
                                                     mlp_impl="fused")
    n_tot = mesh.size
    rec = {}
    for dt in ("float32", "bfloat16"):
        cfg = base.replace(dtype=dt, param_dtype=dt)
        gen = torch.Generator(device=mesh.device).manual_seed(5)
        tdt = cfg.tparam_dtype
        d, f, e = cfg.d_model, cfg.routed_ff, cfg.n_experts
        whole = {"router": torch.randn((d, e), generator=gen, device=mesh.device) * 0.02}
        for key, shape in (("experts_in", (e, d, f)), ("experts_gate", (e, d, f)),
                           ("experts_out", (e, f, d))):
            whole[key] = (torch.randn(shape, generator=gen, device=mesh.device,
                                      dtype=tdt) * 0.02)
        x = torch.randn((*POD_X, d), generator=gen, device=mesh.device).to(cfg.tdtype)
        ref = _shard_map_reference(torch, cfg, whole, x, n_tot) if \
            mesh.rank == 0 and dt == "float32" else None
        p = {k: (v if k == "router" else sharding.local_slice(v, ("model", None, None), mesh))
             for k, v in whole.items()}
        del whole
        free(torch)
        dp = sharding.dp_axes(mesh)
        for split in (False, True):
            xin = sharding.local_slice(x, (dp, None, None), mesh) if split else x
            ek.MOE.launches = 0
            coll.reset()
            with torch.no_grad(), sharding.use_mesh(mesh, data_split=split):
                y = transformer.moe_block(cfg, p, xin)
            counts = forward_collectives(coll)
            if split:
                y = coll.all_gather(y, mesh, dp, dim=0)
            tag = f"{dt}_{'rows' if split else 'whole'}"
            r = {"moe_mlp_launches": ek.MOE.launches, "collectives": counts}
            check(ek.MOE.launches == 1 and counts["all_to_all"] == 2,
                  f"pod moe {tag} rank {mesh.rank}: {r}")
            if ref is not None:
                err = float((y.float() - ref.float()).abs().max() / ref.float().abs().max())
                r["rel_err"] = err
                check(err <= POD_TOL, f"pod moe {tag}: relative error {err}")
            rec[tag] = r
        if dt == "bfloat16":
            with torch.no_grad(), sharding.use_mesh(mesh):
                transformer.moe_block(cfg, p, x)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(POD_TIMED):
                    transformer.moe_block(cfg, p, x)
                torch.cuda.synchronize()
            rec["bf16_ms_a_call"] = (time.perf_counter() - t0) * 1e3 / POD_TIMED
        del p, x
        free(torch)
    nl = POD_X[0] * POD_X[1] // n_tot
    rec["cap_l"] = max(1, int(math.ceil(nl * base.top_k / base.n_experts
                                        * base.capacity_factor)))
    return rec


def _held_family(torch, mesh) -> dict:
    """`HOLD_ARCH` at full width, `HOLD_LAYERS` layers, float32: one AdamW
    step (a clip that does not bind) from the same seed held as the TP
    blocks, as JAX's table and as FSDP's blocks, deterministic: the losses
    and the gathered parameters bit-equal; each hold's parameter bytes a
    rank and the wkv6 launches (at least one a layer, the same in every
    hold)."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.kernels.wkv6 import kernel as wk
    from repro_torch.launch import analyze
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel import sharding
    from repro_torch.training import loop
    from repro_torch.training.optimizer import OptimizerConfig

    cfg = configs.get_config(HOLD_ARCH).replace(n_layers=HOLD_LAYERS, dtype="float32",
                                                param_dtype="float32")
    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=2, clip_norm=1e9)
    tcfg = loop.TrainConfig(steps=1, seed=0)
    rows, seq = HOLD_BATCH
    rng = np.random.default_rng(9)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (rows, seq)).astype(np.int32))
             .to(mesh.device) for k in ("tokens", "labels")}
    torch.use_deterministic_algorithms(True, warn_only=True)
    out, whole = {}, {}
    for hold in ("tp", "jax", "fsdp"):
        params, opt = loop.init_train_state(cfg, ocfg, tcfg, mesh=mesh, hold=hold)
        pbytes = analyze.storage_bytes(params)
        step = loop.make_train_step(cfg, ocfg, tcfg, mesh=mesh, hold=hold)
        wk.WKV6.launches = 0
        coll.reset()
        params, opt, m = step(params, opt, batch)
        out[hold] = {"loss": float(m["loss"]), "param_bytes": pbytes,
                     "wkv6_launches": wk.WKV6.launches, "held_gathers": coll.COUNTS["hold"]}
        whole[hold] = dict(sharding.gather_tree(params, loop.param_specs(cfg, mesh, hold),
                                                mesh))
        del params, opt
        free(torch)
    torch.use_deterministic_algorithms(False)
    for hold in ("jax", "fsdp"):
        out[hold]["bit_equal"] = out[hold]["loss"] == out["tp"]["loss"] and all(
            torch.equal(t, whole["tp"][p]) for p, t in whole[hold].items())
        check(out[hold]["bit_equal"], f"held {HOLD_ARCH} {hold} rank {mesh.rank}: "
                                      f"{out[hold]} vs {out['tp']}")
    # over "model" 2 JAX's table is rwkv6's TP blocks; FSDP's blocks are not
    check(out["fsdp"]["held_gathers"] > 0, f"held {HOLD_ARCH} rank {mesh.rank}: {out}")
    check(len({h["wkv6_launches"] for h in out.values()}) == 1 and
          out["tp"]["wkv6_launches"] >= HOLD_LAYERS,
          f"held {HOLD_ARCH} rank {mesh.rank}: wkv6 launches {out}")
    check(out["fsdp"]["param_bytes"] < out["tp"]["param_bytes"],
          f"held {HOLD_ARCH} rank {mesh.rank}: parameter bytes {out}")
    return out


def _split_decode(torch, mesh, name, cfg, shape, max_len, hold, parts, ref=False) -> dict:
    """`cfg` prefilled on the mesh from this rank's blocks (seed 1, held as
    `hold`), the whole cache cut to the rank's blocks of JAX's
    `cache_specs` (`sharding.local_tree`), then `SPLIT_STEPS` greedy
    decode steps under the split those specs imply
    (`sharding.decode_split`; the rows over "data" where they divide).
    Checks a rank's KV bytes (1 / `parts` of its rows' KV at the whole
    length), finite logits and every launch (as the layers and calls
    imply); returns them with TPOT p50 (host clock, synced: ranks that
    share one card) and the collectives a decode step.  `ref` (float32):
    rank 0 decodes the whole draw alone, and the token streams must be
    equal."""
    import numpy as np
    import torch.distributed as dist

    from repro_torch import bridge
    from repro_torch.models import api
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel import sharding

    rows, plen = shape
    rng = np.random.default_rng(41)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (rows, plen)))
             .to(mesh.device)}
    if cfg.family == "whisper":
        batch["embeds"] = torch.from_numpy(rng.standard_normal(
            (rows, SPLIT_FRAMES, cfg.d_model)).astype(np.float32)).to(mesh.device)
    params = _draw_blocks(torch, mesh, cfg, hold)
    launchers = _tp_launchers(recurrent=True)
    for ln in launchers.values():
        ln.launches = 0
    with torch.no_grad(), sharding.use_mesh(mesh, hold=hold):
        last, cache = api.prefill(cfg, params, batch, max_len)

    def kv(tree):
        return sum(t.nbytes for p, t in bridge.tree_paths(tree) if p[-1] in sharding.KV_LEAVES)

    specs = sharding.cache_specs(mesh, cache, cfg.kv_heads, rows, cfg.cache_seq_shard,
                                 n_heads=cfg.n_heads)
    whole = kv(cache)
    cache = sharding.local_tree(cache, specs, mesh)
    dp = sharding.batch_spec(mesh, rows, 1)[0]
    row_parts = sharding.axis_size(mesh, dp) if dp else 1
    check(kv(cache) * parts * row_parts == whole,
          f"split {name} rank {mesh.rank}: {kv(cache)} KV bytes of {whole}, not 1/{parts} of "
          f"its rows' {whole // row_parts}")
    split = dict(data_split=dp is not None, **sharding.decode_split(mesh, specs))
    tok = last[:, -1].argmax(-1, keepdim=True)
    tokens, times = [tok], []
    coll.reset()
    for _ in range(SPLIT_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad(), sharding.use_mesh(mesh, hold=hold, **split):
            lg, cache = api.decode_step(cfg, params, sharding.local_slice(tok, (dp, None), mesh),
                                        cache)
        lg = coll.all_gather(lg, mesh, dp, dim=0) if dp else lg
        check(bool(torch.isfinite(lg).all()), f"split {name}: non-finite logits")
        tok = lg[:, -1].argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        tokens.append(tok)
    colls = {k: v / SPLIT_STEPS for k, v in forward_collectives(coll).items()}
    launches = {k: ln.launches for k, ln in launchers.items()}
    calls = 1 + SPLIT_STEPS
    n_rec = sum(1 for lc in cache["layers"] if "h" in lc) if cfg.family == "rglru" else 0
    fused_norm = cfg.norm_impl == "fused" and cfg.norm != "layernorm"
    want = dict.fromkeys(launchers, 0)
    want.update(fused_rmsnorm=(2 * cfg.n_layers + 1) * calls if fused_norm else 0,
                rglru_scan=n_rec * calls,
                flash_attention=(cfg.n_layers - n_rec) if cfg.attn_impl == "flash" else 0)
    check(launches == want, f"split {name} rank {mesh.rank}: launches {launches}, "
                            f"expected {want}")
    out = {"kv_bytes": kv(cache), "kv_bytes_whole": whole, "parts": parts * row_parts,
           "split": {k: sorted(v) if isinstance(v, frozenset) else v for k, v in split.items()},
           "tpot_p50_ms": float(np.median(times)), "collectives_per_decode_step": colls,
           "launches": launches, "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9}
    got = torch.cat(tokens, 1)
    del params, cache
    free(torch)
    if ref and mesh.rank == 0:
        full = api.init_params(cfg, 1, device=mesh.device)
        with torch.no_grad():
            last, cache = api.prefill(cfg, full, batch, max_len)
            want_tok = [last[:, -1].argmax(-1, keepdim=True)]
            for _ in range(SPLIT_STEPS):
                lg, cache = api.decode_step(cfg, full, want_tok[-1], cache)
                want_tok.append(lg[:, -1].argmax(-1, keepdim=True))
        same = sum(bool(torch.equal(a, b)) for a, b in zip(got, torch.cat(want_tok, 1)))
        out["equal_streams"] = f"{same}/{rows}"
        check(same == rows, f"split {name}: {same}/{rows} token streams equal the one-rank "
                            f"run's")
        del full, cache
        free(torch)
    dist.barrier()
    return out


def _length_mesh_rank(rank: int, world: int, store: str, policy: str, out: str) -> None:
    """One rank of `length_mesh_phase`: gloo over the one card; four ranks
    run deepseek on (2, 2), the pod MoE on (2, 1, 2), the held family and
    recurrentgemma's split ring on (2, 2), three ranks mixtral and
    whisper on (1, 3); rank 0 writes the record."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.launch.mesh import make_host_mesh, make_mesh

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=600))
    n, lo, hi, new = LEN_REQUESTS
    f32 = dict(dtype="float32", param_dtype="float32")
    rec = {}
    if world == 4:
        mesh = make_host_mesh(2, backend="gloo", device_type="cuda")
        pod = make_mesh(POD_MESH, ("pod", "data", "model"), backend="gloo",
                        device_type="cuda")
        # deepseek-v3 at full width: the latent's length over "model", the
        # 4 slots over "data" (MLA: flash stays off)
        kern = dict(mlp_impl="fused", norm_impl="fused")
        cfg = configs.get_config("deepseek-v3-671b").replace(**LEN_DS, **kern)
        rng = np.random.default_rng(31)
        rec["deepseek"] = _data_serve(torch, mesh, "deepseek latent", cfg,
                                      _requests(rng, cfg.vocab, n, lo, hi, new), "rows",
                                      parts=4, paged=False, max_len=LEN_DS_MAX_LEN)
        rec["deepseek_f32"] = _tp_tokens(
            torch, mesh, "deepseek latent f32",
            cfg.replace(n_experts=LEN_DS_F32_EXPERTS, **f32),
            [rng.integers(0, cfg.vocab, size=int(k)).astype(np.int32)
             for k in rng.integers(lo, hi + 1, size=n)], new, paged=False,
            max_len=LEN_DS_MAX_LEN)
        rec["pod_moe"] = _pod_moe(torch, pod)
        rec["held"] = _held_family(torch, mesh)
        # recurrentgemma at full width: the ring's length over "model" (the
        # slots over "data"), and one long sequence's ring and `h` over "data"
        rg = configs.get_config("recurrentgemma-2b").replace(
            n_layers=SPLIT_RG_LAYERS, attn_impl="flash", norm_impl="fused")
        for name, (shape, max_len, hold, parts) in SPLIT_RG.items():
            cfg = rg.replace(cache_seq_shard=shape[0] > 1)
            rec[name] = _split_decode(torch, mesh, name, cfg, shape, max_len, hold, parts)
            rec[f"{name} f32"] = _split_decode(torch, mesh, f"{name} f32",
                                               cfg.replace(**f32), shape, max_len, hold,
                                               parts, ref=True)
    else:
        # mixtral-8x7b with cache_seq_shard: its 8 KV heads do not split
        # over 3 ranks, so the ring's length does (max_len / 3 a rank)
        model, layers, max_len = LEN_MIXTRAL
        mesh = make_host_mesh(model, backend="gloo", device_type="cuda")
        kern = dict(attn_impl="flash", mlp_impl="fused", norm_impl="fused")
        cfg = configs.get_config("mixtral-8x7b").replace(n_layers=layers,
                                                        cache_seq_shard=True, **kern)
        rng = np.random.default_rng(32)
        rec["mixtral"] = _data_serve(torch, mesh, "mixtral seq_shard", cfg,
                                     _requests(rng, cfg.vocab, n, lo, hi, new), None,
                                     parts=model, paged=False, max_len=max_len)
        rec["mixtral_f32"] = _tp_tokens(
            torch, mesh, "mixtral seq_shard f32", cfg.replace(n_layers=1, **f32),
            [rng.integers(0, cfg.vocab, size=int(k)).astype(np.int32)
             for k in rng.integers(lo, hi + 1, size=n)], new, paged=False, max_len=max_len)
        # whisper-base at full width and depth: its 8 heads do not split over
        # 3, so the self and cross KV's lengths do (`cache_seq_shard`)
        shape, max_len, hold, parts = SPLIT_WHISPER
        cfg = configs.get_config("whisper-base").replace(cache_seq_shard=True)
        rec["whisper seq_shard"] = _split_decode(torch, mesh, "whisper seq_shard", cfg, shape,
                                                 max_len, hold, parts)
        rec["whisper seq_shard f32"] = _split_decode(
            torch, mesh, "whisper seq_shard f32", cfg.replace(**f32), shape, max_len, hold,
            parts, ref=True)
    if rank == 0:
        rec["mesh"] = dict(mesh.shape)
        Path(out).write_text(json.dumps(rec))
    dist.barrier()
    dist.destroy_process_group()


def length_mesh_phase(torch) -> dict:
    """A decode cache split along its length over "model", the shard_map
    MoE on a mesh with "pod", and a family held as JAX's blocks: ranks
    spawned on the one card over gloo (`_length_mesh_rank`).
    (a) deepseek-v3-671b at full width, 2 of 61 layers (1 dense, 1 MoE of
    256 experts), bf16, the fused MLP, moe_mlp and the fused norms (flash
    refuses MLA's v), dense state of 4 slots on a (2, 2) mesh: the slots
    over "data", the latent's length over "model" (JAX's
    `cache_shardings`), so a rank holds a quarter of the latent bytes;
    each kernel launched as the layers and calls imply; TPOT and the
    collectives a decode step printed; then in float32 with
    `LEN_DS_F32_EXPERTS` experts, token-equal to the one-rank engine.
    (b) mixtral-8x7b with `cache_seq_shard`, 2 of 32 layers, bf16, on a
    (1, 3) mesh: on (1, 2) its 8 KV heads split over "model" and the rule
    leaves the length whole; over 3 they do not, so the sliding-window
    ring's length does (`LEN_MIXTRAL`'s max_len below the 4096 window,
    divisible by 3: the ring does not wrap here; the CPU tests wrap it);
    a rank holds a third of the KV bytes; the same checks, then float32
    at 1 layer token-equal to the one-rank engine.  (c) mixtral's MoE
    block at full width on a (2, 1, 2) ("pod", "data", "model") mesh by
    `moe_block_shard_map`: float32 within `POD_TOL` of JAX's definition
    computed on one rank, rows whole and split over ("pod", "data"), one
    moe_mlp launch and two all_to_alls a call; bf16 ms a call.  (d)
    `HOLD_ARCH` at full width, `HOLD_LAYERS` layers, one float32 training
    step held as the TP blocks, as JAX's table and as FSDP's blocks:
    bit-equal, wkv6 launched once a layer in each.  (e) recurrentgemma-2b
    at full width, `SPLIT_RG_LAYERS` of 26 layers (two recurrent, one
    attention), bf16, fused norm and flash prefill, on (2, 2), held as
    JAX's table (`h` and the conv window whole on "model", moved to the
    recurrent block's channels around it): with `cache_seq_shard` 4 slots
    of 2100-token prompts (past the 2048 window) with the ring's length
    over "model" and the slots over "data", and one 3000-token sequence
    with the ring's length and `h`'s channels over "data"
    (`_split_decode`: the cache cut to JAX's `cache_specs`, a rank's KV
    bytes half its rows', launches as the layers imply); (f) whisper-base
    at full width and depth, bf16, `cache_seq_shard` on (1, 3): its 8
    heads do not split over 3, so the self KV (480) and cross KV (1500
    frames) lengths do, a third of the KV bytes a rank.  Each of (e) and
    (f) again in float32, token-equal to the one-rank run.  All readings
    are of ranks that share one card."""
    free(torch)
    t0 = time.perf_counter()
    rec = {"(2, 2)": _spawn(_length_mesh_rank, 4, "", "len4"),
           "(1, 3)": _spawn(_length_mesh_rank, LEN_MIXTRAL[0], "", "len3")}
    secs = time.perf_counter() - t0
    card = card_line()
    for tag, key in (("(2, 2)", "deepseek"), ("(1, 3)", "mixtral")):
        x, s = rec[tag][key], rec[tag][key]["summary"]
        print(f"[smoke] length mesh {tag} {key} bf16 ({card}): rank 0 KV {x['kv_bytes']} "
              f"bytes (KV-head placement alone {x['kv_bytes_heads_only']}), "
              f"{s['tokens_out']} tokens, {s['prefills']} prefills, {s['decode_steps']} decode "
              f"steps in {s['seconds']:.3f}s = {s['tokens_per_s']:.1f} tok/s, TPOT p50 "
              f"{s['tpot_p50_ms']:.2f} ms (ranks share one card); collectives a decode step "
              f"in the model call {x['collectives_per_decode_step']}; launches "
              f"{x['launches']}; kernel shapes {x['shapes']}; peak "
              f"{x['peak_device_gb']:.2f} GB", flush=True)
        r = rec[tag][f"{key}_f32"]
        print(f"[smoke] length mesh {tag} {key}_f32: equal streams {r['equal_streams']}, "
              f"launches {r['launches']}, collectives {r['collectives']}", flush=True)
    pm = rec["(2, 2)"]["pod_moe"]
    print(f"[smoke] pod moe {POD_MESH} mixtral-8x7b MoE block {POD_X} ({card}): cap_l "
          f"{pm['cap_l']}, float32 relative error rows whole {pm['float32_whole']['rel_err']:.3g}"
          f", rows over (pod, data) {pm['float32_rows']['rel_err']:.3g}; collectives a call "
          f"{pm['bfloat16_whole']['collectives']}; bf16 {pm['bf16_ms_a_call']:.3f} ms a call "
          f"(ranks share one card)", flush=True)
    h = rec["(2, 2)"]["held"]
    print(f"[smoke] held {HOLD_ARCH} {HOLD_LAYERS}L f32 on (2, 2) ({card}): parameter bytes a "
          f"rank tp {h['tp']['param_bytes']}, jax {h['jax']['param_bytes']}, fsdp "
          f"{h['fsdp']['param_bytes']}; bit-equal jax {h['jax']['bit_equal']} fsdp "
          f"{h['fsdp']['bit_equal']}; wkv6 launches {h['tp']['wkv6_launches']}", flush=True)
    for tag, names in (("(2, 2)", SPLIT_RG), ("(1, 3)", ("whisper seq_shard",))):
        for name in names:
            x, r = rec[tag][name], rec[tag][f"{name} f32"]
            print(f"[smoke] split length {tag} {name} bf16 ({card}): rank 0 KV "
                  f"{x['kv_bytes']} bytes of {x['kv_bytes_whole']} (1/{x['parts']}), split "
                  f"{x['split']}, TPOT p50 {x['tpot_p50_ms']:.2f} ms (ranks share one card), "
                  f"collectives a decode step {x['collectives_per_decode_step']}, launches "
                  f"{x['launches']}, peak {x['peak_device_gb']:.2f} GB; f32 equal streams "
                  f"{r['equal_streams']}", flush=True)
    print(f"[smoke] length mesh phase {secs:.1f}s", flush=True)
    print(json.dumps({"length_mesh": dict(rec, seconds=secs, card=card)}), flush=True)
    return rec


def free(torch) -> None:
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def smoke_policy(arch: str, flash: bool = True) -> Path:
    """A policy JSON for `arch` that turns the three fusion flags on (batch
    4, tp 1; `flash` False leaves the attention group unfused, so only
    fused_mlp and fused_norm are on), written under build/; returns its
    path."""
    pol = {"network": arch, "interval_s": 1e-3, "operators": [
        {"group": "norm1+qkv_proj+attention", "batch": 4, "tp": 1,
         "memory": "HBM3", "chiplet": "H100", "fused": flash},
        {"group": "norm2+mlp", "batch": 4, "tp": 1, "memory": "HBM3",
         "chiplet": "H100", "fused": True}]}
    path = ROOT / "build" / "smoke_policy.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(pol))
    return path


def main_path_phase(torch, arch: str, launchers, n_requests: int,
                    n_layers: int | None = None, kv_quant: bool = False,
                    bands=None, lens=None, flash: bool = True, max_len: int = 512):
    """`arch` (bfloat16, random weights from a seed; cut to `n_layers`
    layers where given) through the serve launcher's own functions, with
    a policy that turns the three fusion flags on (`flash` False: all but
    flash attention); every kernel in `launchers` must launch.
    `kv_quant`: the engine's int8 KV switch; `bands`: prompt-length bands
    of the port's Zipf workload generator, `lens`: the prompts' lengths
    (else `n_requests` prompts of 16-300 tokens).  Returns (engine, launch counts, summary)."""
    import resource

    import numpy as np

    from repro_torch import configs
    from repro_torch.launch.policy import load_policy
    from repro_torch.launch.serve import build_engine, serve
    from repro_torch.serving import workload

    from repro_torch.serving.engine import Request

    path = smoke_policy(arch, flash)
    cfg = configs.get_config(arch)
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = build_engine(cfg, policy=load_policy(path), max_batch=4, max_len=max_len,
                       seed=0, device="cuda", kv_quant=kv_quant,
                       log=lambda s: print(s, flush=True))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    host_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    check((eng.mcfg.attn_impl == "flash") == flash and eng.mcfg.mlp_impl == "fused"
          and eng.mcfg.norm_impl == "fused", "policy did not turn the kernels on")
    rng = np.random.default_rng(0)
    serve(eng, _requests(rng, cfg.vocab, 2, 16, 40, 4))   # warm-up: library handles
    if lens is not None:
        reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=int(n))
                        .astype(np.int32), max_new_tokens=32)
                for i, n in enumerate(lens)]
    elif bands is None:
        reqs = _requests(rng, cfg.vocab, n_requests, 16, 300, 32)
    else:
        reqs = workload.zipf_mix_requests(rng, n_requests, cfg.vocab, bands=bands,
                                          max_new_tokens=32)
    for ln in launchers.values():
        ln.launches = 0
    s = serve(eng, reqs)
    counts = {name: ln.launches for name, ln in launchers.items()}
    quant = f", int8 KV ({eng.kv_quant_mode})" if eng.kv_quant_mode else ""
    print(f"[smoke] main path {arch} {cfg.n_layers}L bf16 ({eng.state.kind} "
          f"state{quant}): {s['tokens_out']} tokens, {s['prefills']} prefills, "
          f"{s['decode_steps']} decode steps in {s['seconds']:.3f}s = "
          f"{s['tokens_per_s']:.1f} tok/s; TTFT p50 {s['ttft_p50_ms']:.1f} ms, "
          f"TPOT p50 {s['tpot_p50_ms']:.2f} ms; launches {counts}; weights "
          f"drawn and engine built in {build_s:.1f}s (process peak host "
          f"memory {host_gb:.1f} GB); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    print(json.dumps({"main_path": s, "arch": arch, "launches": counts,
                      "build_engine_s": build_s, "state": eng.state.kind,
                      "kv_quant": eng.kv_quant_mode,
                      "buckets": sorted({int(2 ** math.ceil(math.log2(max(16, len(r.prompt)))))
                                         for r in reqs})}), flush=True)
    check(all(r.finish_reason == "max_new_tokens" and len(r.out_tokens) == 32
              for r in reqs), f"{arch}: a request did not finish with 32 tokens")
    check(s["nan_steps"] == 0 and not eng.health["nan_detected"],
          f"{arch}: non-finite logits")
    check(all(c > 0 for c in counts.values()),
          f"{arch}: a kernel of the path was never launched: {counts}")
    return eng, counts, s


def int8_path_phase(torch, launchers):
    """The fifth main path: smollm-135m at full width (30 layers, bfloat16,
    pages of 16) with int8 KV on the pool route: 12 requests from the
    port's Zipf workload generator over bands that cross the 64 - 512
    prefill buckets.  Every kernel must launch, the int8 paged_decode once
    a layer a decode step and the bfloat16 one never; no non-finite
    logits.  Prints the int8 pool's pages per byte against a bfloat16
    pool's (`pages_for_byte_budget`, from shapes alone)."""
    from repro_torch import configs
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.serving import quant

    before = fk.PAGED.launches
    eng, counts, s = main_path_phase(torch, "smollm-135m", launchers, 12,
                                     kv_quant=True, bands=Q8_BANDS)
    check(eng.kv_quant_mode == "paged" and eng.pool.segments[0]["k"].dtype == torch.int8,
          "smollm-135m int8: the pool is not int8")
    want = eng.mcfg.n_layers * s["decode_steps"]
    check(counts["paged_decode_int8"] == want,
          f"smollm-135m int8: int8 paged_decode launched "
          f"{counts['paged_decode_int8']} times, expected {want} (a layer a decode step)")
    check(fk.PAGED.launches == before, "smollm-135m int8: the bfloat16 paged_decode ran")
    cfg = configs.get_config("smollm-135m")
    budget = 1 << 30
    per = {q: quant.kv_page_nbytes(cfg, PAGE, q) for q in (False, True)}
    pages = {q: quant.pages_for_byte_budget(cfg, budget, PAGE, q) for q in (False, True)}
    ratio = pages[True] / pages[False]
    print(json.dumps({"int8_pages_per_byte": {
        "page_bytes_bf16": per[False], "page_bytes_int8": per[True],
        "pages_in_1GiB_bf16": pages[False], "pages_in_1GiB_int8": pages[True],
        "ratio": ratio}}), flush=True)
    check(1.9 < ratio <= 2.0, f"smollm-135m int8: {ratio} pages per bf16 page")
    return eng, counts, s


def cluster_path_phase(torch, launchers):
    """The cluster path: smollm-135m at full width (bfloat16, the three
    fusion flags on), 2 replicas on the card sharing one set of weights,
    `CLUSTER_REQUESTS` requests from the `LoadGenerator` (Poisson at
    `CLUSTER_RATE` a second, `CLUSTER_DEADLINE_MS` deadlines) under the
    seed-0 chaos script over `CLUSTER_HORIZON` steps, through
    `launch.serve.serve_cluster`.  Gates: every request done with a JAX
    finish reason and at most its tokens, no request lost or twice in the
    trace, none unrouted at the end, every kernel of the path launched,
    every live engine (restarted ones too) on the one set of weight
    tensors, paged_decode launched once a layer for every decode step of
    every engine, retired ones included (NaN steps too: a step launches
    at most one a layer, so the total holds each engine), a "nan"
    quarantine where a nan event found a live slot.  Prints the share of
    requests whose tokens equal a fault-free engine's, and, for the
    host-loop question, the same requests served as one burst (rate 0,
    no chaos, no deadlines) by one engine and by the 2-replica cluster."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.launch.policy import load_policy
    from repro_torch.launch.serve import prepare, serve, serve_cluster
    from repro_torch.serving.engine import Request, ServingEngine

    cfg, params, kw = prepare(configs.get_config("smollm-135m"),
                              policy=load_policy(smoke_policy("smollm-135m")),
                              device="cuda", log=lambda x: None)
    for ln in launchers.values():
        ln.launches = 0
    s = serve_cluster(cfg, params, n_replicas=2, rate=CLUSTER_RATE,
                      deadline_ms=CLUSTER_DEADLINE_MS, n_requests=CLUSTER_REQUESTS,
                      max_new=32, chaos_horizon=CLUSTER_HORIZON, max_len=512,
                      log=lambda x: print(x, flush=True), **kw)
    counts = {name: ln.launches for name, ln in launchers.items()}
    cl, reqs, agg, chaos = s["cluster"], s["requests"], s["aggregate"], s["chaos"]
    shared = all(e.params["embed"].data_ptr() == params["embed"].data_ptr() and
                 e.params["segments"][0]["kind_dense"]["mlp"]["w_in"].data_ptr() ==
                 params["segments"][0]["kind_dense"]["mlp"]["w_in"].data_ptr()
                 for e in cl.replicas)
    steps = sum(e.stats[k] for e in cl.replicas for k in ("decode_steps", "nan_steps")) \
        + cl._retired["decode_steps"] + cl._retired["nan_steps"]
    # the fault-free run: one engine, the same prompts as one burst, no deadlines
    ref = [Request(rid=r.rid, prompt=r.prompt, max_new_tokens=r.max_new_tokens)
           for r in reqs]
    one = serve(ServingEngine(cfg, params, max_len=512, **kw), ref)
    full = [(a, b) for a, b in zip(reqs, ref) if a.finish_reason == "max_new_tokens"]
    same = sum(a.out_tokens == b.out_tokens for a, b in full)
    # the same prompts (the generator draws them before the arrivals) as
    # one burst through the 2-replica cluster
    burst = serve_cluster(cfg, params, n_replicas=2, n_requests=CLUSTER_REQUESTS,
                          max_new=32, max_len=512, log=lambda x: None, **kw)
    check([r.prompt.tolist() for r in burst["requests"]] ==
          [r.prompt.tolist() for r in reqs], "cluster burst: other prompts")
    reasons = [why for _, _, why in cl.watchdog.events]
    out = {k: agg[k] for k in (
        "tokens_out", "ttft_p50_ms", "ttft_p99_ms", "tpot_p50_ms", "tpot_p99_ms",
        "goodput_tokens", "deadline_met", "deadline_missed", "shed", "poisoned",
        "quarantined", "restarts", "requeued", "n_unrouted")}
    out.update(seconds=s["seconds"], tokens_per_s=s["tokens_per_s"],
               goodput_tokens_per_s=agg["goodput_tokens"] / max(s["seconds"], 1e-9),
               chaos_events=[(e.step, e.kind, e.replica) for e in chaos.events],
               nan_events_on_live_slots=chaos.poisoned,
               watchdog=cl.watchdog.events, cluster_steps=cl.stats["steps"],
               finish_reasons={k: sum(r.finish_reason == k for r in reqs)
                               for k in FINISH_REASONS},
               tokens_equal_fault_free=[same, len(full)],
               decode_steps_all_engines=steps,
               replicas_share_weight_tensors=shared,
               burst_one_engine={k: one[k] for k in (
                   "tokens_out", "seconds", "tokens_per_s", "tpot_p50_ms", "decode_steps")},
               burst_cluster={"tokens_out": burst["aggregate"]["tokens_out"],
                              "seconds": burst["seconds"],
                              "tokens_per_s": burst["tokens_per_s"],
                              "tpot_p50_ms": burst["aggregate"]["tpot_p50_ms"],
                              "cluster_steps": burst["cluster"].stats["steps"]},
               per_replica=[{k: row[k] for k in ("replica", "healthy", "tokens_out",
                                                 "decode_steps", "prefills", "preemptions",
                                                 "ttft_p50_ms", "tpot_p50_ms")}
                            for row in s["per_replica"]])
    print(json.dumps({"cluster_path": out, "arch": "smollm-135m", "replicas": 2,
                      "launches": counts}), flush=True)
    rids = [r.rid for r in reqs]
    check(len(reqs) == CLUSTER_REQUESTS and len(set(rids)) == len(rids)
          and sorted(r.rid for r in cl.requests) == sorted(rids),
          "cluster path: a request was lost or submitted twice")
    check(all(r.done and r.finish_reason in FINISH_REASONS
              and len(r.out_tokens) <= r.max_new_tokens for r in reqs),
          "cluster path: a request is not done with a finish reason")
    check(shared, "cluster path: a replica copied the weights")
    check(agg["n_unrouted"] == 0 and not cl.pending_work,
          f"cluster path: {agg['n_unrouted']} requests unrouted at the end")
    check(all(c > 0 for c in counts.values()),
          f"cluster path: a kernel of the path was never launched: {counts}")
    check(steps > 0 and counts["paged_decode"] == cfg.n_layers * steps,
          f"cluster path: {counts['paged_decode']} paged_decode launches for {steps} "
          f"decode steps of {cfg.n_layers} layers")
    if chaos.poisoned:
        check("nan" in reasons, f"cluster path: a live slot was poisoned at "
              f"{chaos.poisoned} but the watchdog logged {cl.watchdog.events}")
    check(all(r.done and r.finish_reason == "max_new_tokens" for r in burst["requests"])
          and burst["aggregate"]["n_unrouted"] == 0,
          "cluster burst: a request did not finish")
    del cl, s, burst
    free(torch)
    return counts


def spec_path_phase(torch, launchers):
    """The spec-decode path: smollm-135m at full width (30 layers,
    bfloat16, the three fusion flags on, dense KV) with the CLI's
    shared-trunk draft (a quarter of the layers), k `SPEC_K`, 8 requests
    of 16-300 tokens, 32 new each, through `launch.serve.serve_specdec`;
    then the target-only dense engine on the same requests (tokens/s, the
    share of equal token streams in bfloat16 and where the others leave
    it, with `verify_rounding`'s reading) and `high_tar_pair`'s
    acceptance and tokens/s on the same requests.  Every kernel of the
    path must launch.  Returns (the engine, launch counts)."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.launch.policy import load_policy
    from repro_torch.launch.serve import prepare, serve, serve_specdec
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.specdec import SpecDecodeEngine, high_tar_pair

    cfg, params, kw = prepare(configs.get_config("smollm-135m"),
                              policy=load_policy(smoke_policy("smollm-135m")),
                              device="cuda", log=lambda x: None)

    def requests(n, max_new):
        return _requests(np.random.default_rng(9), cfg.vocab, n, 16, 300, max_new)

    serve_specdec(cfg, params, requests(2, 4), k=SPEC_K, max_len=512,
                  log=lambda x: None, **kw)   # warm-up
    for ln in launchers.values():
        ln.launches = 0
    reqs = requests(8, 32)
    s = serve_specdec(cfg, params, reqs, k=SPEC_K, max_len=512,
                      log=lambda x: print(x, flush=True), **kw)
    counts = {name: ln.launches for name, ln in launchers.items()}
    eng = s.pop("engine")
    ref = requests(8, 32)
    t = serve(ServingEngine(cfg, params, paged=False, max_len=512, **kw), ref)
    same = sum(a.out_tokens == b.out_tokens for a, b in zip(reqs, ref))
    first_diff = [next(i for i, (x, y) in enumerate(zip(a.out_tokens, b.out_tokens))
                       if x != y) for a, b in zip(reqs, ref) if a.out_tokens != b.out_tokens]
    rounding = verify_rounding(torch, cfg, params, [r.prompt for r in requests(4, 1)])
    n_draft = eng.draft_cfg.n_layers
    tp, dcfg, dp = high_tar_pair(cfg, params, n_draft)
    hi = SpecDecodeEngine(cfg, tp, dcfg, dp, k=SPEC_K, max_len=512, **kw)
    h = serve(hi, requests(8, 32))
    out = {"tokens_out": s["tokens_out"], "seconds": s["seconds"],
           "tokens_per_s": s["tokens_per_s"], "tpot_p50_ms": s["tpot_p50_ms"],
           "tpot_p99_ms": s["tpot_p99_ms"], "ttft_p50_ms": s["ttft_p50_ms"],
           "verify_steps": s["decode_steps"], "acceptance": s["acceptance"],
           "tokens_per_iteration": s["tokens_per_iteration"],
           "target_only_tokens_per_s": t["tokens_per_s"],
           "target_only_tpot_p50_ms": t["tpot_p50_ms"],
           "bf16_streams_equal_target_only": [same, len(reqs)],
           "bf16_first_differing_token": first_diff,
           "verify_vs_decode_rounding": rounding,
           "high_tar_pair_acceptance": hi.spec_stats.acceptance_rate,
           "high_tar_pair_tokens_per_iteration": hi.spec_stats.tokens_per_iteration,
           "high_tar_pair_tokens_per_s": h["tokens_per_s"],
           "high_tar_pair_tpot_p50_ms": h["tpot_p50_ms"]}
    print(json.dumps({"spec_path": out, "arch": "smollm-135m", "k": SPEC_K,
                      "draft_layers": n_draft, "launches": counts}), flush=True)
    check(all(r.finish_reason == "max_new_tokens" and len(r.out_tokens) == 32
              for r in reqs), "spec path: a request did not finish with 32 tokens")
    check(s["nan_steps"] == 0 and not eng.health["nan_detected"],
          "spec path: non-finite logits")
    check(all(c > 0 for c in counts.values()),
          f"spec path: a kernel of the path was never launched: {counts}")
    del hi, tp
    free(torch)
    return eng, counts


def verify_rounding(torch, cfg, params, prompts, rounds: int = 4) -> dict:
    """How far the verify's logits round from target-only decode's: the
    same `rounds` windows of k random tokens scored by `decode_window`
    (N = w * k rows) and by k `decode_step`s (N = w, the target-only
    engine's call), each on its own copy of one prefilled dense cache.
    Returns the largest logit difference, the rows whose argmax differs
    and how many rows' top two decode logits lie within that difference
    (a near tie that rounding can flip)."""
    from repro_torch.models import api
    from repro_torch.serving.state import DenseKVState, gather_slots

    dev = torch.device("cuda")
    w = len(prompts)
    st = DenseKVState(cfg, w, 512, decode_batch=w, compact=True, device=dev)
    for b, p in enumerate(prompts):
        st.prefill(params, b, p)
    idx = torch.arange(w, device=dev)
    win, stp = gather_slots(st.cache, idx), gather_slots(st.cache, idx)
    g = torch.Generator(device=dev).manual_seed(0)
    d_max, flips, gaps = 0.0, 0, []
    for _ in range(rounds):
        window = torch.randint(0, cfg.vocab, (w, SPEC_K), generator=g, device=dev)
        lw, win = api.decode_window(cfg, params, window, win)
        ls = []
        for j in range(SPEC_K):
            logits, stp = api.decode_step(cfg, params, window[:, j:j + 1], stp)
            ls.append(logits[:, -1])
        lw, ls = lw.float(), torch.stack(ls, 1).float()
        d_max = max(d_max, float((lw - ls).abs().max()))
        flips += int((lw.argmax(-1) != ls.argmax(-1)).sum())
        top2 = ls.topk(2, -1).values
        gaps.append((top2[..., 0] - top2[..., 1]).flatten())
    gaps = torch.cat(gaps)
    return {"rows": int(gaps.numel()), "max_abs_logit_diff": d_max,
            "argmax_differs": flips, "top2_gap_median": float(gaps.median()),
            "top2_within_max_diff": int((gaps <= d_max).sum()),
            "top2_tied": int((gaps == 0).sum())}


def spec_breakdown_phase(torch, eng) -> None:
    """Where one propose/verify iteration's time goes (4 slots,
    100-token prompts): wall time of steady iterations, then one profiled
    iteration for device time, busy share and kernels; the verify must run
    the MLP's cluster tile and the norm kernels."""
    import numpy as np

    from repro_torch.serving.engine import Request

    rng = np.random.default_rng(2)
    for i in range(4):
        eng.submit(Request(rid=1000 + i, prompt=rng.integers(0, eng.mcfg.vocab, 100)
                           .astype(np.int32), max_new_tokens=200))
    for _ in range(3):
        eng.step()
    n = 8
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        eng.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / n * 1e3
    rec = profiled(torch, eng.step, need=("mlp_cluster_kernel", "rmsnorm"))
    by_name = {k: t for k, (t, _) in rec.items()}
    dev_ms = sum(by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    eng.run()
    out = {"iteration_ms": step_ms, "device_ms_per_iteration": dev_ms,
           "device_busy_share": dev_ms / step_ms,
           "kernels_per_iteration": sum(c for _, c in rec.values()),
           "top_kernels_ms": [[k[:60], v / 1e3] for k, v in top],
           "own_kernels_ms": {k: v / 1e3 for k in OWN_KERNELS
                              if (v := sum(t for name, t in by_name.items() if k in name))}}
    print(json.dumps({"spec_breakdown": out, "arch": "smollm-135m", "k": SPEC_K}),
          flush=True)
    check(dev_ms > 0, "spec breakdown: the profiler saw no device time")
    for k in ("mlp_cluster_kernel", "rmsnorm"):
        check(any(k in name for name in by_name), f"spec breakdown: no {k}")


def op_breakdown(torch, fn, n: int, top: int = 8) -> list:
    """The PyTorch ops with the most device time (of the kernels each
    launches itself) in one profiler window around fn(), `n` steps, by op
    and input shapes: [[op, shapes, device ms a step, calls a step], ...];
    empty when the window recorded no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages(group_by_input_shape=True):
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append([e.key, str(e.input_shapes)[:160], us / n / 1e3, e.count / n])
    return sorted(rows, key=lambda r: -r[2])[:top]


def breakdown_phase(torch, eng, arch: str, need=(), forbid=()):
    """Where a decode step's time goes: the wall time of steady decode
    steps (4 slots, 100-token prompts), then one profiled window for the
    device's busy time, kernel count and heaviest kernels a step, and one
    for the ops with the most device time (`op_breakdown`).  Every kernel
    named in `need` must show in the window, none in `forbid`."""
    import numpy as np

    from repro_torch.serving.engine import Request

    rng = np.random.default_rng(2)
    for i in range(4):
        eng.submit(Request(rid=i, prompt=rng.integers(0, eng.mcfg.vocab, 100)
                           .astype(np.int32), max_new_tokens=40))
    for _ in range(3):                 # admit all four, settle
        eng.step()
    n = 8
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        eng.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / n * 1e3
    n_prof = 4

    def steps():
        for _ in range(n_prof):
            eng.step()

    # at most PROFILE_TRIES windows and the ops' window: 11 + 4 * 6 steps,
    # within the 40 tokens
    rec = profiled(torch, steps, need=need)
    ops = op_breakdown(torch, steps, n_prof)
    by_name = {k: t for k, (t, _) in rec.items()}
    n_kern = sum(n for _, n in rec.values())
    dev_ms = sum(by_name.values()) / n_prof / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    ours = {k: sum(v for name, v in by_name.items() if k in name) / n_prof / 1e3
            for k in OWN_KERNELS}
    eng.run()
    out = {"decode_step_ms": step_ms, "device_ms_per_step": dev_ms,
           "device_busy_share": dev_ms / step_ms,
           "kernels_per_step": n_kern / n_prof,
           "top_kernels_ms_per_step": [[k[:60], v / n_prof / 1e3] for k, v in top],
           "own_kernels_ms_per_step": {k: v for k, v in ours.items() if v > 0},
           "top_ops_ms_per_step": ops}
    print(json.dumps({"breakdown": out, "arch": arch}), flush=True)
    check(dev_ms > 0, "breakdown: the profiler saw no device time")
    for k in need:
        check(any(k in name for name in by_name), f"breakdown {arch}: no {k}")
    for k in forbid:
        check(not any(k in name for name in by_name), f"breakdown {arch}: {k} ran")


def flash_logits_check(torch, eng, arch: str, n_tokens: int) -> None:
    """The served bfloat16 weights' last-position logits of one seeded
    `n_tokens` prompt through the flash route and through the einsum
    route, both bfloat16 on the card, each against the float32 plain
    route (einsum attention, dense MLP, plain norms) on the same weights.
    Rounding P to bfloat16 inside the flash tile must cost no more than
    the einsum route's own bfloat16 rounding allows."""
    import numpy as np

    from repro_torch.models import api

    cfg = eng.mcfg
    rng = np.random.default_rng(4)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, n_tokens),
                           device="cuda").long()[None]
    routes = {"flash": cfg, "einsum": cfg.replace(attn_impl="einsum"),
              "float32": cfg.replace(dtype="float32", attn_impl="einsum",
                                     mlp_impl="dense", norm_impl="ref")}
    logits = {r: api.forward(c, eng.params, {"tokens": toks})[0, -1].float()
              for r, c in routes.items()}
    diff = {r: float((logits[r] - logits["float32"]).abs().max())
            for r in ("flash", "einsum")}
    slack, floor = FLASH_E2E_SLACK
    print(f"[smoke] bf16 logits {arch} {cfg.n_layers}L, {n_tokens}-token prompt, "
          f"last position against the float32 plain route: flash route max "
          f"|diff| {diff['flash']:.4g}, einsum route {diff['einsum']:.4g} "
          f"(bound {slack} x einsum + {floor})", flush=True)
    check(all(bool(torch.isfinite(x).all()) for x in logits.values()),
          f"bf16 logits {arch}: non-finite logits")
    check(diff["flash"] <= slack * diff["einsum"] + floor,
          f"bf16 logits {arch}: the flash route is off by {diff['flash']}, "
          f"the einsum route by {diff['einsum']}")


def prefill_breakdown_phase(torch, eng, arch: str, plen: int, share: str = "flash_",
                            need=("flash_tc_kernel",),
                            forbid=("flash_fwd_kernel",)) -> None:
    """Where one prefill's time goes: a seeded `plen`-token prompt into
    slot 0 through the engine's state (smollm: bucket-padded into the page
    pool), timed by the host clock, then profiled once: device time, the
    share of the kernels whose names hold `share` (flash's, wkv6's), kernel
    count.  Every kernel in `need` must run (the transformers: the
    tensor-core flash tile), none in `forbid` (the float32 FMA kernel)."""
    import numpy as np

    seq = np.random.default_rng(5).integers(0, eng.mcfg.vocab, plen).astype(np.int32)

    def prefill():
        if eng.paged:
            check(eng.pool.ensure(0, plen + 1), f"prefill {arch}: pool too small")
        eng.state.prefill(eng.params, 0, seq)
        eng.state.release(0)

    prefill()                              # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rec = profiled(torch, prefill, need=need)
    by_name = {k: t for k, (t, _) in rec.items()}
    n = sum(c for _, c in rec.values())
    dev_ms = sum(by_name.values()) / 1e3
    share_ms = sum(v for k, v in by_name.items() if share in k) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    out = {"prefill_tokens": plen, "wall_ms": wall_ms, "device_ms": dev_ms,
           "device_busy_share": dev_ms / wall_ms, "share_of": share,
           "share_ms": share_ms,
           "share": share_ms / dev_ms if dev_ms else None, "kernels": n,
           "top_kernels_ms": [[k[:60], v / 1e3] for k, v in top],
           "own_kernels_ms": {k: v / 1e3 for k in OWN_KERNELS
                              if (v := sum(t for name, t in by_name.items() if k in name))}}
    print(json.dumps({"prefill_breakdown": out, "arch": arch}), flush=True)
    check(dev_ms > 0, f"prefill {arch}: the profiler saw no device time")
    for k in need:
        check(any(k in name for name in by_name), f"prefill {arch}: no {k}")
    for k in forbid:
        check(not any(k in name for name in by_name), f"prefill {arch}: {k} ran")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found: run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import torch.nn.functional as F

    from repro_torch.kernels import _build

    card = card_line()
    print(f"[smoke] card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    build_s = _build.build()
    print(f"[smoke] built {', '.join(_build.SOURCES)} in {build_s:.1f}s "
          f"(nvcc {' '.join(_build.NVCC_FLAGS)})", flush=True)
    ptxas_phase()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[smoke] allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}", flush=True)

    dryrun_started = dryrun_start()
    try:
        return _main(torch, F, build_s, dryrun_started)
    finally:
        if dryrun_started[0].poll() is None:
            dryrun_started[0].kill()
            dryrun_started[0].wait()


def _main(torch, F, build_s, dryrun_started) -> int:
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.fused_mlp import kernel as mk
    from repro_torch.kernels.fused_norm import kernel as nk
    from repro_torch.kernels.moe_mlp import kernel as ek
    from repro_torch.kernels.rglru_scan import kernel as gk
    from repro_torch.kernels.wkv6 import kernel as wk

    t_main = time.perf_counter()

    def mark(what: str) -> None:       # where the script's time goes, phase by phase
        print(f"[smoke] {time.perf_counter() - t_main:.1f}s into the checks: {what} done",
              flush=True)

    norm_trace(torch)
    rows, record = kernel_phase(torch, F)
    grad_gaps = grad_rows(torch)
    mark("kernel rows")
    e2e_phase(torch)
    moe_e2e_phase(torch, 2)
    free(torch)
    mark("float32 smollm and mixtral checks")
    recurrent_e2e_phase(torch, "rwkv6-3b", 2)
    recurrent_e2e_phase(torch, "recurrentgemma-2b", 3)
    mark("float32 recurrent checks (card against the host)")
    int8_e2e_phase(torch, 2)
    cluster_drill_phase(torch, 4)
    spec_e2e_phase(torch, 2)
    mark("float32 int8, drill and spec-decode checks")
    qwen2_vl_e2e_phase(torch, 2)
    danube_e2e_phase(torch, 2)
    deepseek_e2e_phase(torch, 2)
    mark("float32 qwen2-vl, danube and deepseek checks")
    grad_check = grad_e2e_phase(torch)
    mark("float32 end-to-end checks")
    norms = {"fused_rmsnorm": nk.RMSNORM,
             "fused_rmsnorm_residual": nk.RMSNORM_RESIDUAL}
    eng, counts, s = main_path_phase(
        torch, "smollm-135m", dict(norms, fused_mlp=mk.MLP,
                                   flash_attention=fk.FLASH,
                                   paged_decode=fk.PAGED), 12)
    want = eng.mcfg.n_layers * s["decode_steps"]
    check(counts["paged_decode"] == want,
          f"smollm-135m: paged_decode launched {counts['paged_decode']} "
          f"times, expected {want} (a layer a decode step)")
    breakdown_phase(torch, eng, "smollm-135m",
                    need=("mlp_cluster_kernel", "paged_tc_kernel", "paged_combine_kernel"),
                    forbid=("mlp_partial_kernel", "paged_split_kernel"))
    prefill_breakdown_phase(torch, eng, "smollm-135m", 400)     # bucket 512
    flash_logits_check(torch, eng, "smollm-135m", 300)
    del eng
    free(torch)
    mark("smollm-135m path")
    launchers = dict(norms, wkv6=wk.WKV6, rglru_scan=gk.SCAN)
    eng, path = recurrent_path_phase(torch, "rwkv6-3b", launchers, "wkv6")
    counts["wkv6"] = path["wkv6"]
    breakdown_phase(torch, eng, "rwkv6-3b", need=("wkv6_step_kernel",))
    prefill_breakdown_phase(torch, eng, "rwkv6-3b", 256, share="wkv6_",
                            need=("wkv6_prep_kernel", "wkv6_state_kernel",
                                  "wkv6_out_kernel"), forbid=())
    del eng
    free(torch)
    eng, path = recurrent_path_phase(torch, "recurrentgemma-2b", launchers,
                                     "rglru_scan")
    counts["rglru_scan"] = path["rglru_scan"]
    breakdown_phase(torch, eng, "recurrentgemma-2b", need=("rglru_step_kernel",))
    before = dict(gk.kernel_launches)
    prefill_breakdown_phase(torch, eng, "recurrentgemma-2b", 256, share="rglru_",
                            need=("rglru_scan_kernel",), forbid=("rglru_step_kernel",))
    ran = {k: n - before[k] for k, n in gk.kernel_launches.items()}
    check(ran["rglru_scan_kernel"] > 0 and ran["rglru_step_kernel"] == 0,
          f"prefill recurrentgemma-2b: the C entry reports {ran}")
    del eng
    free(torch)
    eng, path, s = main_path_phase(
        torch, "mixtral-8x7b", dict(norms, flash_attention=fk.FLASH,
                                    moe_mlp=ek.MOE), 8, n_layers=4)
    n_moe = eng.mcfg.n_layers
    for name, want in (("moe_mlp", n_moe * (s["prefills"] + s["decode_steps"])),
                       ("flash_attention", n_moe * s["prefills"])):
        check(path[name] == want, f"mixtral-8x7b: {name} launched "
              f"{path[name]} times, expected {want}")
    counts["moe_mlp"] = path["moe_mlp"]
    breakdown_phase(torch, eng, "mixtral-8x7b", need=("mlp_cluster_kernel",),
                    forbid=("mlp_partial_kernel",))
    prefill_breakdown_phase(torch, eng, "mixtral-8x7b", 300)
    flash_logits_check(torch, eng, "mixtral-8x7b", 300)
    del eng
    free(torch)
    eng, path, s = int8_path_phase(
        torch, dict(norms, fused_mlp=mk.MLP, flash_attention=fk.FLASH,
                    paged_decode_int8=fk.PAGED_INT8))
    counts["paged_decode_int8"] = path["paged_decode_int8"]
    breakdown_phase(torch, eng, "smollm-135m int8",
                    need=("mlp_cluster_kernel", "paged_split_kernel"),
                    forbid=("paged_tc_kernel", "mlp_partial_kernel"))
    del eng
    free(torch)
    mark("rwkv6, recurrentgemma, mixtral and int8 paths")
    cluster_path_phase(torch, dict(norms, fused_mlp=mk.MLP, flash_attention=fk.FLASH,
                                   paged_decode=fk.PAGED))
    eng, _ = spec_path_phase(torch, dict(norms, fused_mlp=mk.MLP,
                                         flash_attention=fk.FLASH))
    spec_breakdown_phase(torch, eng)
    del eng
    free(torch)
    variant_path_phases(torch, dict(norms, fused_mlp=mk.MLP, flash_attention=fk.FLASH,
                                    paged_decode=fk.PAGED, paged_decode_int8=fk.PAGED_INT8,
                                    moe_mlp=ek.MOE, wkv6=wk.WKV6, rglru_scan=gk.SCAN))
    mark("cluster, spec-decode and variant paths")
    train_summary = train_path_phase(torch, record, F)
    mark("training path")
    tp_path_phase(torch)
    mark("tp mesh")
    family_mesh_phase(torch)
    mark("family mesh")
    cluster_mesh_phase(torch)
    mark("cluster mesh")
    data_mesh_phase(torch)
    train_mesh_phase(torch)
    fsdp_path_phase(torch)
    mark("data, training and FSDP meshes")
    length_mesh_phase(torch)
    dryrun_phase(torch, dryrun_started)
    mark("length mesh and dry run")

    meta = {
        "fused_rmsnorm": ("fused_norm.cu", "fused_norm/kernel.py:51",
                          [DECODE_N, D], "bfloat16"),
        "fused_rmsnorm_residual": ("fused_norm.cu", "fused_norm/kernel.py:78",
                                   [DECODE_N, D], "bfloat16"),
        "fused_mlp": ("fused_mlp.cu", "fused_mlp/kernel.py:75",
                      [DECODE_N, D, F_FF], "bfloat16"),
        "flash_attention": ("flash_attention.cu", "flash_attention/kernel.py:80",
                            [1, 512, H, HKV, HD], "bfloat16"),
        "paged_decode": ("paged_decode.cu", "flash_attention/kernel.py:190",
                         [DECODE_N, H, HKV, HD, PAGE], "bfloat16"),
        "paged_decode_int8": ("paged_decode.cu", "flash_attention/kernel.py:190",
                              [DECODE_N, H, HKV, HD, PAGE], "bfloat16"),
        "moe_mlp": ("moe_mlp.cu", "moe_mlp/kernel.py:54",
                    [MOE_E, 8, MOE_D, MOE_F], "bfloat16"),
        "wkv6": ("wkv6.cu", "wkv6/kernel.py:73",
                 [DECODE_N, 1, RWKV_H, RWKV_D], "float32"),
        "rglru_scan": ("rglru_scan.cu", "rglru_scan/kernel.py:39",
                       [DECODE_N, 1, LRU_W], "float32"),
    }
    kernels = []
    for name, (source, replaces, shape, dtype) in meta.items():
        row = next(r for r in rows if r["name"] == name and r["shape"] == shape
                   and r["dtype"] == dtype and r.get("act", "swiglu") == "swiglu")
        kernels.append({"name": name, "route": "cuda",
                        "source": f"src/repro_torch/csrc/{source}",
                        "replaces": f"src/repro/kernels/{replaces}",
                        "launches": counts[name],
                        "max_abs_err": row["max_err"], "ms": row["kernel_ms"],
                        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"],
                        "library_device_ms": row["library_device_ms"],
                        "kernel_device_ms": row["kernel_device_ms"], "shape": shape,
                        "dtype": dtype, "build_s": build_s})
    print(json.dumps({"train_path": dict(train_summary, grad_check=grad_check,
                                         grad_rows=grad_gaps)}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
