"""Drive the PyTorch + CUDA port once on one NVIDIA GPU, through the
hand-written kernels: paged TinyGPT serving at full width, training the
reference MNIST CNN at its published widths, training TinyGPT (the
repository's 170M training workload, bench.py:141-199, at full width,
and the sort task of examples/train_tinylm.py at its defaults), training
ResNet-8 on CIFAR-10 (examples/train_cifar10_resnet.py), the reference's
XOR and MNIST-MLP examples, PTQ-quantized serving (int8 and int4
dequant-on-load, W8A8 prefill, examples/ptq_quantize.py), int8 KV caches
and the contiguous-cache engine (bench.py's bench_paged_decode), the
Trainer's checkpoints, and sliding-window and packed-sequence attention
(training a windowed model and bench_packing's packed batches, decoding
through ring caches, the opt-in backwards K10 and K11), and the rest of
the training step (the fused vocab-chunked loss at 16 x 2048 with remat,
dropout and the training helpers; an MoE model; Lion, Muon and
Adafactor), and generation (generate, multi-turn, chunked decode and beam
search on bench_multiturn's model; the BPE tokenizer, the byte LMs of
examples/train_bytelm.py and speculative decoding; the serving engine's
shared system prompt).

    python3 chip_smoke.py

Phases (each prints one line or more; any failure raises and exits
non-zero):
  1. the card: ``torch.cuda.is_available()`` and nvidia-smi's name and
     power limit;
  2. build the CUDA kernels from ``taper_tpu_torch/csrc``;
  3. each serving kernel against its plain PyTorch version at the serving
     slice's shapes, with the max error beside the stated tolerance and
     CUDA-event times of the kernel, the plain version and the library
     call (K8 at prefill on the arm the device picks and on the exact
     arm);
  4. the full-width serving model (random weights from a seed): prefill
     logits and one paged decode step on the card (bf16) against the same
     weights in f32 through the plain path on the CPU;
  5. serve 32 requests through ``ServingEngine``; every request must
     complete with its token count and every serving kernel must have
     launched;
  6. each CNN training kernel (GEMM mode nt with bias and epilogue, modes
     nn/tn, direct convolution forward and input gradient, convolution
     weight gradient, pooling) against its plain version at the CNN's f32
     shapes, batch 256, and the convolution kernels at ResNet-8's
     stride-1 shapes (the input gradient reads the forward's weights
     flipped, in the kernel);
  7. one CNN training step on the card against the same step on the CPU
     (loss within 1e-5 relative of an independent CPU run; every
     gradient within 1e-4 relative L2 of a CPU run whose backward sees the
     card's forward values, see ``phase7_step``, and within 1e-2 of the
     independent run);
  8. train the CNN with ``Trainer.fit_device`` for 2 epochs on the
     synthetic 60k/10k set: the best epoch's validation accuracy >= 0.95,
     exact launch counts; then a profile of 3 steps (device busy time and
     kernel time by family);
  9. the LM kernels against their plain versions at the 170M model's
     shapes in bf16 (batch 8 x 2048 tokens): K1 (wgmma) in modes nt/nn/tn
     at the
     three projection shapes of a layer, the flash forward K5 (with its
     lse) and K8 with its predicate forced to each arm, in both layouts,
     and the flash backward K6 and K7; K8, K6 and K7 through the route
     ``plan_fwd`` and ``plan_bwd`` give them (wgmma), K8 also
     timed without its bound pre-pass, two K6 and two K7 calls bit-equal;
     ``F.scaled_dot_product_attention`` forward and forward + backward are
     timed as the yardstick;
 10. one full-width 170M training step at batch 1 on the card against the
     same step on the CPU: in f32 (loss within 1e-5 relative, every
     gradient within 1e-4 relative L2), and with the card's trunk in bf16
     (within LM_BF16_LOSS_TOL and LM_BF16_GRAD_TOL of the f32 CPU step);
     then K5, K6 and K7 in f32 at the f32 step's attention shape (B 1, H
     8, S 2048, D 128, causal, [B, S, H*D]) against their plain versions,
     K6 and K7 twice each for the same bits, SDPA timed as the library
     call;
 11. train the 170M model: batch 8 x 2048 tokens, Adam(1e-4), 2 warm-up
     and 10 timed steps; ms per step, tokens/s, the model-FLOP share of 989
     TFLOP/s, peak memory, the loss at every step (finite), the exact
     launch counts per step, K1's, K8's, K6's and K7's calls per step by
     route against what ``plan``, ``plan_fwd`` and ``plan_bwd``
     predict, how
     many K8 launches took the bound arm; then
     2 profiled steps: device time by kernel and glue, wall against busy;
 12. the sort task at examples/train_tinylm.py's defaults in f32: its
     kernels against their plain versions at the task's shapes, then 600
     steps through the example's step function; the teacher-forced eval
     accuracy must reach 0.9, with exact launch counts per step; then
     SORT_SHORT steps each through the example with --opt lion, --opt
     muon, --opt adafactor and --experts 4, each loss falling, with exact
     launch counts per step;
 13. the elementwise kernel K2 (relu at ResNet-8's three activation
     shapes, each other op once) and the SGD update K17b (over the XOR
     model's and ResNet-8's parameters) against their plain versions,
     with times beside the bound, the plain version and a library call;
     the Adam update K17a is held the same way in phase 11 (the 170M
     model's gradients) and phase 14 (ResNet-8's);
 14. ResNet-8 at its published widths, batch 256, f32, AdamW(3e-3, wd
     5e-4) with a cosine schedule, on the synthetic 50k/10k CIFAR-10 set:
     one step on the card against the CPU (loss, every gradient on shared
     forward values, the new running statistics), K1 against its plain
     version at the patch-GEMM and head shapes (forward, dX, dW: the dW
     split over K), then fit_device for RESNET["epochs"] epochs: accuracy
     at or above RESNET_MIN_ACC, exact launch counts per step, one step's
     K1 routes, a profile;
 15. the examples through their entry points: XOR (XOR_STEPS SGD steps)
     must be solved with one K17b launch per step; the MNIST MLP through
     fit_device must stop early above 0.98 val accuracy within 10
     epochs; one epoch of the MLP through Trainer.fit over
     PrefetchLoader(DataLoader); the MLP at bench.py:48-80's settings
     (10 epochs, no early stop): final val accuracy at or above
     BENCH_r05's 0.993 less MLP_BENCH's batch-order allowance;
 16. the quantized kernels against their plain versions at the shapes of
     phases 17-19: K12/K13 (``linear_q8``/``linear_q4``) at decode (M=8),
     at M=4096 and K12 at the CNN's FC layers (M=2000), within 2e-4,
     each on the route ``ops.quant.plan_q`` names (checked taken: decode
     for K12 and K13 at M=8, wgmma at M=4096 and at the FC layers of N
     128 and 64, mma at the 10-way head), and the mma route at ragged K,
     codes 1 byte off and K 2,050 at M=4096 (on no path); one call of
     each route with a per-tensor scale and zero point allocates its
     output (and the wgmma route's workspace) and no copy; K14
     (``quantize_rows``), K15b (``matmul_int8``) and K15a
     (``matmul_int8_scaled``) exactly, K15 at the three W8A8 shapes on
     the route ``ops.quant.plan`` names (checked taken);
     ``torch._int_mm`` is K15b's library call, the others have none;
 17. PTQ serving of benchmarks/bench_serving.py:39-52's model (dim 2048,
     depth 6, 273M parameters, f32) with int8 and int4 weights in the
     paged engine (the bench's contiguous cache runs in phase 21): prefill
     and decode logits against the port's CPU path with the same
     weights, exactly 36 K12/K13 launches per decode step, each on the
     decode route, 8 requests of 200 new tokens served, tokens/s beside f32, a profile of the decode
     step in each format;
 18. bench.py:273-301's W8A8 prefill (dim 2048, depth 4, bf16, every 2-D
     leaf int8, 4 x 1024 tokens): TAPER_W8A8=1 runs 24 K14 and 24 K15a,
     the same weights through K12, the same dense weights in int4 through
     24 K13 launches, all on the wgmma route (its logits against the
     port's CPU path on one batch row), the bf16 dense model through K1;
     W8A8 logits against K12's, ms for each, and the W8A8, K12 and K13
     forwards' device time by kernel family (a profile of two forwards
     each);
 19. examples/ptq_quantize.py through its entry point with --epochs 1:
     int8 accuracy within 0.01 of f32, float16 within 0.001, three K12
     launches per eval batch of 2000, two on wgmma and the 10-way head's
     on mma;
 20. K16 over int8 pools (``paged_decode_int8``) against its plain
     version at bench_paged_decode's shapes (16 rows, 8 KV heads, G 1,
     D 128, block 128, 257/4033 positions, bf16 q), with all 16 rows at
     4033 (the worst case), at phase 5's serving mix and at phase 17's
     model shape (4 KV heads, G 4, f32 q), with the bound of the live
     int8 rows, their scales, q and o; the bf16 kernel at the mixed and
     the all-long lengths beside it; each call on the split
     ``ops.paged_attention.plan`` gives (checked taken), and a repeated
     split call of each kernel bit-equal;
 21. the 32-request mix of phase 5 through the contiguous bf16, paged
     int8 and contiguous int8 engines: every request completes, exact
     launches per decode step (48 K1 and 8 K16 int8; contiguous: 48 K1),
     paged int8 against contiguous int8 logits on the card and
     contiguous bf16 against the f32 CPU path, generated tokens/s and a
     profile of one decode block each;
 22. bench_paged_decode's four contenders (contig, paged_int8_mixed,
     contig_short, paged_short) through decode_step/decode_step_paged
     with argmax feedback: tokens/s, device time a step, and the bench's
     two ratios;
 23. the MNIST MLP through fit_device for 2 epochs with a checkpoint
     each epoch, against the same run cut after epoch 1 and resumed:
     bit-equal parameters and Adam moments;
 24. this slice's kernels against their plain versions, timed beside a
     bound over the band's live pairs and SDPA with the same boolean
     mask: K5/K6/K7 and K11 with a window of 512 at the windowed model's
     training shape (bf16, B 2, H 8, S 4096, D 128, [B, S, H*D]) and
     non-causal windowed in f32 at a small shape; K11 at GQA (8 query
     heads on 2 KV heads) in bf16 and f32, its group sum against K7; K5/K6/K7 with
     bench_packing's segment ids (bf16, 13 rows, H 8, S 1024, D 64); K6
     and K7 through their planned routes, two calls of each bit-equal; K8
     (both arms, also timed without its bound pre-pass), K6 and K7 at the
     padded batch's shape (bf16, 64 rows, H 8, S 1024, D 64, [B, H, S,
     D]), with SDPA beside them; K10 at the 170M shape through its planned
     route, raced against K6 + K7 and SDPA's backward;
 25. packed training at benchmarks/bench_packing.py's configuration: one
     packed step card vs CPU, a packed row's documents against themselves
     alone (f32 on the card), then the padded (64 rows, K8) and the packed
     (~13 rows, K5 with segment ids) step: real tokens/s, their ratio,
     exact launch counts, K8's, K6's and K7's calls by route against the
     plans;
 26. the windowed model (bench_serving.py:287-340, window 512) trained at
     2 x 4096: ms/step, tokens/s and MFU over the band's FLOPs, with K7
     and with K11 (K6's, K7's and K11's calls by route against the
     plans)
     under TAPER_ATTN_DKV_T=1, their gradients against each
     other, a profiled step against the full-causal model's (the
     windowed backward, K6 and K7 over the band, the cheaper), one step
     card vs CPU (depth cut to 2);
 27. windowed decode: a 1024-token prompt and 128 greedy steps at batch 8
     through the bf16 full cache, the bf16 ring, the int8 full cache and
     the int8 ring (each ring against its full cache at every step),
     tokens/s, device time a step, cache bytes; the windowed model
     through the contiguous engine;
 28. (run right after phase 11, on its model) the 170M step with
     TAPER_ATTN_FUSED_BWD=1 and with the split backward, in turns: ms/step
     each, 12 K10 calls and no K6/K7 a step, K8's, K6's, K7's and K10's
     calls by route in each, gradients against the split backward's;
 29. (run right after phase 9) K1 bit for bit: for each bf16 route
     (wgmma, realign, decode) and mode, the kernel writing bf16 equals its
     own f32 result cast to bf16; split-K calls (bf16 wgmma, f32) give the
     same bits twice; the realign route timed at a K of 1,001 (no TMA) in
     each mode and at a view 2 bytes off an aligned base, F.linear beside
     it;
 30. (run right after phase 28) the 170M model at 16 x 2048, past JAX's
     naive-loss limit, so through the fused vocab-chunked loss, with
     remat, dropout 0.1, z-loss, AdamW, clip_grad_norm, WarmupCosineLR
     and an EMA: the fused loss op and the model's fused loss and
     gradients against the naive branch on the card (dropout off), a
     plain step's ms and peak memory with each branch at 8 x 2048 and 16
     x 2048, then the timed run (ms/step, tokens/s, MFU, peak memory
     under the same step without remat, exact launches and K1/flash
     routes a step with remat's recompute), K17a's AdamW row, a profile
     of 2 steps;
 31. every FFN of the 170M model an 8-expert top-2 MoE at capacity factor
     1.25 (benchmarks/bench_moe.py's routing), batch 8 x 2048, Adam: K1 at
     the experts' M of 5,120 against its plain version, one MoE layer
     sparse with nothing dropped against dense at 1 x 2048, the
     dropped-slot share,
     the timed run with exact launches and K1 calls by route, a profile
     of 2 steps;
 32. the 170M model at 8 x 2048 through Lion, Muon and Adafactor: a few
     steps each, losses finite, exact launches (no K17), Muon's
     Newton-Schulz time beside its step's;
 33. generation on benchmarks/bench_serving.py:121's bench_multiturn
     model (vocab 4096, dim 2048, depth 6, 16 heads on 4 KV heads, RoPE,
     bf16, 0.28B parameters at random init): K1 at a decode step's (M 8),
     a chunk's (M 256) and the prefill's (M 8192) rows and K8 at the
     prefill against their plain versions; generate on 8 x 1024 + 64
     greedy (exact launches, K1 and K8 calls by route as plan predicts,
     one decode step's K1 routes), token-at-a-time, over an int8 cache,
     ragged and with eos, each token held by a teacher-forced forward
     (within GREEDY_TAU of its row's maximum); turn 1 with return_cache
     and turn 2 through generate_continued with a chunk of 32;
     decode_chunk's logits against a prefill of all 1,056 positions and
     its new tokens/s against re-prefilling; beam_search with 4 beams on
     2 prompts;
 34. the BPE tokenizer to vocab 512 on the repository's markdown (the
     native library and the Python loop give the same merges and ids;
     encode then decode gives the bytes back; both timed), the byte LMs of
     bench_serving.py:446's bench_speculative (target dim 512, depth 6,
     8 heads; draft dim 128, depth 2, 4 heads of 32; f32, RoPE) with their
     f32 kernels against the plain versions at their shapes, trained
     through examples/train_bytelm.py's code for 1,200 Adam steps each
     (exact launches per step), the target's sampled continuation; then
     speculative_generate (gamma 4, 64 + 128) at batch 1, 4 and 8, per row
     and in lockstep, against the target's own greedy generate (where a
     row parts, the two logits within SPEC_TAU), tokens a round and
     tokens/s beside plain decoding;
 35. the serving engine's shared system prompt on phase 5's model, pools
     and 32-request mix with a 256-token prefix: K16 over tables that
     alias the prefix blocks against its plain version; an admission's
     logits through prefill_paged_continued against prefill_paged of
     system + prompt; the engine's prefix blocks allocated once (the free
     count), K16 calls by route, and every greedy request's tokens held
     by the teacher-forced check beside an engine without a prefix run on
     system + prompt; generated tokens/s of both;
 36. the decode loops replayed as CUDA graphs (utils/graphs.py), each
     against chip_smoke's own eager loop on the card (decode_step,
     decode_chunk and argmax; a beam loop; per-row and lockstep
     speculative loops with host-side control) and against the same step
     functions called directly: on phase 33's model generate, ragged
     generate, generate_continued and beam_search; on phase 34's byte LMs
     speculative decoding per row and in lockstep at B 1, 4 and 8, and
     sampled generate and speculative decoding (a seed twice, another
     seed, the CPU forward's z, a generator carried through calls); phase
     5's paged bf16 and phase 21's contiguous int8 engines over the
     32-request mix (the eager engine's tokens, and the teacher-forced
     check); offline_serve over the same model and requests against the
     engine and standalone generate.  Greedy tokens bit-equal, launches
     and K1/K16 routes a step equal, the traced port kernels of the
     replayed and the eager steps equal name by name, wall, device span
     and busy ms a step (a block, a round) each way, and the bytes the
     graphs hold (freed with their model).
Every K1 row (phases 3, 6, 9, 12, 14) names the route and K split that
``ops.gemm.plan`` gives its operands (``via wgmma x2``) and checks that
the call took them (``backend.route_counts()``); phases 11 and 14 hold a
step's K1 calls by route to what ``plan`` predicts for its shapes.  Every
K8, K6, K7, K10 and K11 row names the route ``plan_fwd`` or ``plan_bwd``
gives it and checks that the call took it, as every K12 row does with
``ops.quant.plan_q``'s and every K15 row with ``ops.quant.plan``'s;
phases 11, 12, 25, 26 and 28 hold a step's flash calls by route to the
plans.
The line before the last is the kernel report (JSON), one entry per
kernel with its numbers per path under ``by_path``; K1's entries give
their route and K split (``k1_route``, ``splits``), K8's, K6's, K7's,
K10's and K11's their route (``flash_route``), K12's, K13's and K15's
theirs (``q8_route``, ``i8_route``), K16's its split (``k16_route``,
``splits``, ``chunk``), the top-level numbers
from the 170M model's (e, 4e) projection; the last line is
``{"ok": true, "device": {...}}``.
"""

import collections
import contextlib
import copy
import gc
import importlib
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from taper_tpu_torch import losses, optim
from taper_tpu_torch.data import (
    BPETokenizer, CIFAR10Dataset, MNISTDataset, pack_documents,
    packing_efficiency)
from taper_tpu_torch.data import native as bpe_native
from taper_tpu_torch.examples import (
    ptq_quantize, train_bytelm, train_cifar10_resnet, train_mnist,
    train_tinylm, train_xor)
from taper_tpu_torch.models import (
    TinyGPT, mnist_cnn, mnist_mlp, resnet8, xor_mlp)
from taper_tpu_torch.models.transformer import (
    FUSED_CHUNK, NAIVE_LOSS_MAX, _mask_after_eos)
from taper_tpu_torch.nn import transformer as NT
from taper_tpu_torch.nn.transformer import moe_capacity
from taper_tpu_torch.ops import _build, backend
from taper_tpu_torch.ops import conv_direct as CD
from taper_tpu_torch.ops import elementwise as EW
from taper_tpu_torch.ops import optim_kernels as OK
from taper_tpu_torch.ops import pool as PL
from taper_tpu_torch.ops import quant as Q
from taper_tpu_torch.ops.gemm import (
    gemm, gemm_reference, linear, linear_reference, plan, plan_for,
    streams, tile_shape)
from taper_tpu_torch.ops.paged_attention import (
    paged_decode_attention, paged_decode_reference)
from taper_tpu_torch.ops.paged_attention import plan as paged_plan
from taper_tpu_torch.quantization import (
    QuantizationConfig, QuantizationType, quantize, quantize_params,
    quantized_bytes)
from taper_tpu_torch.quantization.ptq import replace_leaf
from taper_tpu_torch.serve import ServingEngine, offline_serve
from taper_tpu_torch.train import Trainer
from taper_tpu_torch.utils import graphs

# the module itself: ops/__init__.py re-exports its function "attention"
# under the same name
A = importlib.import_module("taper_tpu_torch.ops.attention")

SEED = 0
MODEL = dict(vocab_size=4096, dim=1024, depth=8, num_heads=8, max_seq=4096,
             rope=True)                      # bench.py:214, ~105M params
ENGINE = dict(slots=16, block_size=128, prompt_pad=512, decode_block=16)
MAX_NEW = (16, 48, 128)                      # benchmarks/bench_serving.py
N_REQUESTS = 32
# The 170M training workload (bench.py:163-170): batch 8 x 2048, bf16 trunk,
# Adam(1e-4), loss = mean next-token NLL over all positions.
LM = dict(vocab_size=16384, dim=1024, depth=12, num_heads=8, max_seq=2048,
          rope=True)
LM_BATCH, LM_LR, LM_WARMUP, LM_STEPS = 8, 1e-4, 2, 10
# Tolerances on the card:
#  * GEMM: bf16 operands, f32 accumulation in both; products of bf16
#    values are exact in f32, so only the summation order differs.
#  * attention: the kernel rounds running-max-relative softmax weights to
#    bf16 where the plain version rounds the normalised ones, and the bf16
#    output keeps 8 bits; the lse is f32 from the same scores on both
#    sides (1e-3: the bound arm sums weights shifted far below 1).  In f32
#    the two differ in summation order only: 1e-4.
#  * flash backward, bf16: against the plain backward in f32 on the same
#    bf16 inputs; the kernels round p and ds to bf16 before their
#    products, as JAX does, and round dQ, dK, dV to bf16 (2^-9 relative
#    each).  The gradients are heavy-tailed along S (the first rows and
#    keys of a head are far larger than the rest), so a bound on the whole
#    tensor would not see a tile gone wrong: each (batch, head, 64-row
#    tile) is held to 1e-2 relative L2 of its own norm (plus 1e-5 per
#    entry, RMS, for a tile whose gradient is ~0).  delta is an f32 row
#    sum on both sides: 1e-4.
#  * model: a bf16 trunk (bf16 residual stream, weights and activations)
#    against exact f32 on the CPU, through 8 blocks: relative L2 error of
#    the logits within 3e-2 (about 2^-8 of rounding per residual add).
#  * training kernels, f32 in and out with f32 accumulation on both sides
#    (no TF32): only the summation order differs, over up to 1,152
#    products (convolution), 256 (GEMM) or 200,704 (weight gradient),
#    each term
#    rounded at 2^-24; 1e-4 * (1 + |ref|) leaves room for both.  The
#    weight gradient is held normwise, to 1e-4 of its largest |entry|:
#    an entry's rounding scales with its 200,704 terms, and an entry that
#    cancels to near 0 keeps it.  Pooling computes the same max or the
#    same sum of 4 to 49 values: 1e-6.
#  * the training step, card against CPU: the loss to 1e-5 relative, each
#    parameter's gradient to 1e-4 relative L2 (the same f32 arithmetic in
#    other orders, through 8 layers and the backward pass, with the
#    forward's ReLU decisions shared: phase7_step says why); against an
#    independent CPU step, whose ReLU decisions may differ, 1e-2 (the
#    worst of 8 seed/batch pairs was 7e-4, PERF.md).
TOL = {"linear": 2e-4, "flash_fwd": 2e-2, "flash_fwd_bound": 2e-2,
       "gemm_nn": 1e-4, "gemm_tn": 1e-4,
       "conv_fwd": 1e-4, "conv_dw": 1e-4, "pool": 1e-6,
       # the quantized kernels (reasons at QSERVE below)
       "linear_q8": 2e-4, "linear_q4": 2e-4, "quantize_rows": 0.0,
       "matmul_int8_scaled": 0.0, "matmul_int8": 0.0}
LINEAR_F32_TOL = 1e-4           # linear on the training path (f32 FMA)
# K16 (paged decode) against its plain version, by q's dtype: the tol and
# how of :func:`check_kernel`.  Both sides compute in f32 and round o to
# q's dtype once.  f32 q: 1e-4 (1 + |ref|).  bf16 q: one bf16 rounding of
# nearly the same f32 value, at most 2^-7 |ref| apart, so |out - ref| <=
# 8e-3 (|ref| + ULP_FLOOR).  A split dropped or misweighted in the merge
# moves o by about |o| / splits; at 4,033 positions a typical |o| is
# ~0.02, about the 2e-2 (1 + |ref|) this replaced.  Faults planted in the
# merge (tests/test_torch_cuda_kernels.py) cross that one 4x over, this
# one 2,700x or more (PERF.md).
K16_TOL = {torch.bfloat16: dict(tol=8e-3, how="ulp"),
           torch.float32: dict(tol=1e-4, how="each")}
ULP_FLOOR = 1e-3
BF16_GEMM_TOL = 2e-4
LSE_TOL, LSE_F32_TOL, FLASH_F32_TOL = 1e-3, 1e-4, 1e-4
BWD_BF16_TOL, DELTA_TOL = 1e-2, 1e-4
TILE, TILE_ATOL = 64, 1e-5      # the flash kernels' row tile
NORMWISE = ("conv_dw",)
MODEL_REL_TOL = 3e-2
STEP_LOSS_TOL, STEP_GRAD_TOL, STEP_GRAD_IND_TOL = 1e-5, 1e-4, 1e-2
# The full-width 170M step, card against CPU: in f32 the same arithmetic
# in other orders (1e-5 loss, 1e-4 gradients).  With a bf16 trunk against
# the f32 CPU step: bf16 keeps 8 bits, so every activation and every
# cotangent of the trunk is rounded at ~4e-3, and the gradients carry that
# through 12 blocks; the first chip run measured the loss at 1.7e-5 and
# the gradients at 1.1e-2 relative L2 (median leaf) and 2.4e-2 (worst
# leaf, a key bias), PERF.md.  The bounds are 1e-3 and twice the worst.
LM_LOSS_TOL, LM_GRAD_TOL = 1e-5, 1e-4
LM_BF16_LOSS_TOL, LM_BF16_GRAD_TOL = 1e-3, 5e-2
SORT_MIN_ACC = 0.9
#  * K2: relu, add, sub and mul do one f32 operation and one rounding on
#    both sides: bit-equal (tolerance 0).  sigmoid (expf against
#    PyTorch's exp), div and fma (rounded once on both sides, the plain
#    version through f64) within 2 ulp: 3e-7 (1 + |ref|).
#  * K17: the same f32 formulas, but nvcc contracts a*b + c into FMAs and
#    the plain _foreach ops order Adam's last product differently: within
#    1e-6 (1 + |ref|) in p, m and v after OPT_STEPS steps from random
#    moments (an update moves p by ~lr, 1e-4 to 0.1, so a kernel that
#    drops m, v or g is far outside it).
EW_TOL = {"relu": 0.0, "add": 0.0, "sub": 0.0, "mul": 0.0, "sigmoid": 3e-7,
          "div": 3e-7, "fma": 3e-7}
OPT_TOL = 1e-6
OPT_T0, OPT_STEPS = 11, 3
# K1's counters and their modes; a K1 row's source follows its route
K1_MODES = {"linear": "nt", "gemm_nn": "nn", "gemm_tn": "tn"}
K1_SOURCES = {"wgmma": "taper_tpu_torch/csrc/gemm_sm90.cu",
              "decode": "taper_tpu_torch/csrc/gemm_decode.cu",
              "realign": "taper_tpu_torch/csrc/gemm_realign.cu"}
# K15's routes (ops.quant.plan): a K15 row's source follows its route
I8_SOURCES = {"wgmma": "taper_tpu_torch/csrc/quant_sm90.cu",
              "mma": "taper_tpu_torch/csrc/quant.cu"}
I8_NAMES = ("matmul_int8", "matmul_int8_scaled")
# K12's and K13's routes (ops.quant.plan_q)
Q8_SOURCES = {"wgmma": "taper_tpu_torch/csrc/quant_sm90.cu",
              "decode": "taper_tpu_torch/csrc/quant_decode.cu",
              "mma": "taper_tpu_torch/csrc/quant_decode.cu"}
Q_NAMES = {"linear_q8": 8, "linear_q4": 4}
K16_NAMES = ("paged_decode", "paged_decode_int8")
# The flash kernels' routes (ops.attention.plan_fwd, plan_bwd): a flash
# row's source follows its route too; K10's "f32" keeps SOURCES'
# flash_bwd.cu, and K5's "exact" (f32) is flash_fwd.cu's
FLASH_SOURCES = {
    "wgmma": {"flash_fwd": "taper_tpu_torch/csrc/flash_sm90.cu",
              "flash_fwd_bound": "taper_tpu_torch/csrc/flash_sm90.cu",
              "flash_dq": "taper_tpu_torch/csrc/flash_bwd_sm90.cu",
              "flash_dkv": "taper_tpu_torch/csrc/flash_sm90.cu",
              "flash_dkv_t": "taper_tpu_torch/csrc/flash_sm90.cu",
              "flash_bwd_fused": "taper_tpu_torch/csrc/flash_sm90.cu"},
    "exact": {"flash_fwd": "taper_tpu_torch/csrc/flash_fwd.cu"},
    "f32": {"flash_dq": "taper_tpu_torch/csrc/flash_bwd_f32.cu",
            "flash_dkv": "taper_tpu_torch/csrc/flash_bwd_f32.cu",
            "flash_dkv_t": "taper_tpu_torch/csrc/flash_bwd_f32.cu"}}


def route_key(route, mode, splits):
    """The key of ``backend.route_counts()`` for one K1 call."""
    return f"{route} {mode}" + (" split" if splits > 1 else "")


SOURCES = {
    "linear": ("taper_tpu_torch/csrc/gemm.cu",
               "taper_tpu/ops/pallas/gemm.py:83"),
    "gemm_nn": ("taper_tpu_torch/csrc/gemm.cu",
                "taper_tpu/ops/pallas/gemm.py:83"),
    "gemm_tn": ("taper_tpu_torch/csrc/gemm.cu",
                "taper_tpu/ops/pallas/gemm.py:83"),
    # bf16 K5 (every path but the sort task's f32)
    "flash_fwd": ("taper_tpu_torch/csrc/flash_sm90.cu",
                  "taper_tpu/ops/pallas/attention.py:217"),
    "flash_fwd_bound": ("taper_tpu_torch/csrc/flash_sm90.cu",
                        "taper_tpu/ops/pallas/attention.py:357"),
    "flash_dq": ("taper_tpu_torch/csrc/flash_bwd_f32.cu",
                 "taper_tpu/ops/pallas/attention.py:487"),
    "flash_dkv": ("taper_tpu_torch/csrc/flash_bwd_f32.cu",
                  "taper_tpu/ops/pallas/attention.py:687"),
    "flash_dkv_t": ("taper_tpu_torch/csrc/flash_sm90.cu",
                    "taper_tpu/ops/pallas/attention.py:611"),
    "flash_bwd_fused": ("taper_tpu_torch/csrc/flash_bwd.cu",
                        "taper_tpu/ops/pallas/attention.py:826"),
    "paged_decode": ("taper_tpu_torch/csrc/paged_decode.cu",
                     "taper_tpu/ops/pallas/paged_attention.py:158"),
    "paged_decode_int8": ("taper_tpu_torch/csrc/paged_decode.cu",
                          "taper_tpu/ops/pallas/paged_attention.py:158"),
    "conv_fwd": ("taper_tpu_torch/csrc/conv_direct.cu",
                 "taper_tpu/ops/pallas/conv_direct.py:135"),
    "conv_dw": ("taper_tpu_torch/csrc/conv_direct.cu",
                "taper_tpu/ops/pallas/conv_direct.py:153"),
    "pool": ("taper_tpu_torch/csrc/pool.cu",
             "taper_tpu/ops/pallas/pool.py:43"),
    "adam": ("taper_tpu_torch/csrc/optim.cu",
             "taper_tpu/ops/pallas/optim_kernels.py:50"),
    "sgd": ("taper_tpu_torch/csrc/optim.cu",
            "taper_tpu/ops/pallas/optim_kernels.py:79"),
}
SOURCES.update({name: ("taper_tpu_torch/csrc/quant.cu",
                       f"taper_tpu/ops/pallas/quant.py:{line}")
                for name, line in (("linear_q8", 41), ("linear_q4", 159),
                                   ("quantize_rows", 460),
                                   ("matmul_int8_scaled", 324),
                                   ("matmul_int8", 292))})
SOURCES.update({op: ("taper_tpu_torch/csrc/elementwise.cu",
                     f"taper_tpu/ops/pallas/elementwise.py:{line}")
                for op, line in (("relu", 64), ("sigmoid", 68), ("add", 72),
                                 ("mul", 76), ("fma", 80), ("sub", 84),
                                 ("div", 88))})
# The kernels each path must launch.
SERVE_KERNELS = ("linear", "flash_fwd_bound", "paged_decode")
TRAIN_KERNELS = ("linear", "gemm_nn", "gemm_tn", "conv_fwd", "conv_dw",
                 "pool", "adam")
# Launches per training step, exactly (every other kernel: none), each
# with one fused optimizer update (K17, one launch for up to 256
# parameter tensors).  The CNN: 3 FC layers (each with its dX: the
# first one's input is an activation), 5 convs (forward + the input
# gradient of 4), 3 pools.  The 170M model: 6
# projections per layer x 12 layers, one attention per layer (bf16
# causal: K8).  The sort task: 6 x 2 layers, f32: K5.
CNN_PER_STEP = dict(linear=3, gemm_nn=3, gemm_tn=3, conv_fwd=9, conv_dw=5,
                    pool=3, adam=1)
LM_PER_STEP = dict(linear=72, gemm_nn=72, gemm_tn=72, flash_fwd_bound=12,
                   flash_dq=12, flash_dkv=12, adam=1)
SORT_PER_STEP = dict(linear=12, gemm_nn=12, gemm_tn=12, flash_fwd=2,
                     flash_dq=2, flash_dkv=2, adam=1)
# ResNet-8: 7 ReLUs (K2); 5 stride-1 3x3 convs (K3a forward, and the input
# gradient of the 4 whose input is an activation; K3b); 2 stride-2 convs,
# 2 1x1 projections and the head as patch GEMMs (K1 nt/nn/tn); the 8x8
# average pool (K4); one AdamW update.
RESNET_PER_STEP = dict(relu=7, linear=5, gemm_nn=5, gemm_tn=5, conv_fwd=9,
                       conv_dw=5, pool=1, adam=1)
# ResNet-8's K1 products at batch 256, (rows, K_in, N_out): the stride-2
# 3x3 convolutions 16->32 (32x32 -> 16x16) and 32->64 (-> 8x8) and the 1x1
# stride-2 projections as patch GEMMs, and the head
RESNET_GEMMS = ((65536, 144, 32), (65536, 16, 32), (16384, 288, 64),
                (16384, 32, 64), (256, 64, 10))
# The MLP: 3 FC layers (dX of the first is skipped: its input is data).
MLP_PER_STEP = dict(linear=3, gemm_nn=2, gemm_tn=3, adam=1)
XOR_PER_STEP = dict(linear=2, gemm_nn=1, gemm_tn=2, sgd=1)
# The CIFAR-10 run (examples/train_cifar10_resnet.py): batch 256, AdamW
# 3e-3 wd 5e-4, cosine to lr/100 over the epochs; 3 epochs, not the
# example's 20 (time limit).  The accuracy gate: the JAX example itself
# with --epochs 3 on the synthetic set (xla backend, on a CPU) reached
# RESNET_JAX_ACC, PERF.md; less 0.05 for another batch order and other
# kernels.
RESNET = dict(batch=256, lr=3e-3, weight_decay=5e-4, epochs=3,
              eval_batch=2000)
RESNET_JAX_ACC = 0.8636
RESNET_MIN_ACC = RESNET_JAX_ACC - 0.05
# XOR: the example's 50,000 steps take ~130 s on the card (2.0-2.6 ms a
# step, host bound: measured on an H100, PERF.md); 7,500 fit in ~20 s, and
# the loss crosses the solved line by step 5,000 (the port's
# examples/train_xor.py with --device cpu)
XOR_STEPS = 7_500
MLP_MIN_ACC, MLP_MAX_EPOCHS = 0.98, 10
# The reference CNN's training run (examples/train_mnist_cnn.py).  At
# the example's lr 3e-3 (no BatchNorm) the training spikes to chance for
# an epoch and recovers in some trajectories, in the JAX example on a CPU
# as in the port on a CPU and on the card (PERF.md); which epoch it hits
# depends on the rounding.  The gate is the best epoch's validation
# accuracy, as the example reports it ("best val acc").
CNN = dict(batch=256, lr=3e-3, weight_decay=1e-4, step_size=5, gamma=0.8,
           epochs=2, min_acc=0.95, eval_batch=2000)
# Peak rates of one H100 SXM (NVIDIA's data sheet): dense bf16 and int8
# tensor cores, f32 outside them, and device memory.
PEAK_FLOPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
PEAK_BYTES = 3.35e12


def bound(flops, nbytes, kind):
    """The least time the card could take: the larger of the operations
    over the peak rate of their type and the bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS[kind], nbytes / PEAK_BYTES
    return dict(bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def cuda_ms(fn, arg_sets, iters=30):
    """Mean CUDA-event time of ``fn(*args)``, cycling through ``arg_sets``
    (copies that together exceed the 50 MB L2 where the caller would find
    its operands cold).  The timed launches are queued behind a sleep
    kernel long enough to cover the host's time to issue them, so the
    events time the device's work and not the host's launch rate (a
    launch through Python and ctypes takes tens of us of host time, more
    than a small kernel runs)."""
    for args in arg_sets[:3]:
        fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()           # the host's time to issue a call
    fn(*arg_sets[0])
    issue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # at most 2 GHz, the H100's highest SM clock: never shorter than asked
    torch.cuda._sleep(int(min(1.0, 2 * iters * issue_s + 1e-3) * 2e9))
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def tile_norms(out, ref, tile=TILE):
    """L2 norms of the error and of the reference in each (batch, head,
    ``tile``-row tile) of ``[B, H, S, D]`` tensors."""
    b, h, s, d = ref.shape
    pad = (0, 0, 0, -s % tile)
    err = F.pad(out.float() - ref.float(), pad).reshape(b * h, -1, tile * d)
    ref = F.pad(ref.float(), pad).reshape(b * h, -1, tile * d)
    return err.norm(dim=-1), ref.norm(dim=-1)


def within(out, ref, tol, how="each"):
    """Max abs error, the statistic held to ``tol``, and whether it holds.
    ``how``: "each" |out - ref| <= tol * (1 + |ref|) entry by entry, the
    statistic is max |out - ref| / (1 + |ref|); "ulp" |out - ref| <= tol *
    (|ref| + ULP_FLOOR) entry by entry, the statistic is max |out - ref|
    / (|ref| + ULP_FLOOR); "max" |out - ref| <= tol * max |ref|, the
    statistic is max |out - ref| / max |ref|; "tiles" each
    64-row tile of a ``[B, H, S, D]`` tensor within ``tol`` relative L2 of
    its own norm, plus TILE_ATOL per entry (RMS) where that norm is ~0,
    the statistic is the worst tile's ratio."""
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    if how == "tiles":
        e, r = tile_norms(out, ref)
        floor = TILE_ATOL * (TILE * ref.shape[-1]) ** 0.5 / tol
        stat = float((e / (r + floor)).max())
    elif how == "ulp":
        stat = float((err / (ref.abs() + ULP_FLOOR)).max())
    elif how == "max":
        stat = float(err.max() / ref.abs().max().clamp_min(1e-30))
    else:
        stat = float((err / (1 + ref.abs())).max())
    return float(err.max()), stat, stat <= tol


def _tuple(x, n=None):
    return x if isinstance(x, tuple) else (x,) * (n or 1)


def check_kernel(name, shape, kernel_fn, plain_fn, arg_sets, phase=3,
                 tol=None, how=None, library_fn=None, work=None,
                 plain_ms=None, library_ms=None, flash_route=None):
    """Holds ``kernel_fn`` against ``plain_fn`` on the first argument set
    (each may return a tuple of tensors; ``tol`` and ``how`` may be tuples
    to match, see :func:`within`) and times the kernel over all the sets,
    the plain version (unless its time is given) and, where given, the
    library call (or takes its time).  ``work`` is ``(flops, bytes,
    kind)`` for the bound.  A K1 row (``name`` in K1_MODES, operands
    first) records the route and K split ``plan`` gives its operands, and
    checks that the call took them, as a K15 row does with
    ``ops.quant.plan``'s route and a K12 row with ``ops.quant.plan_q``'s;
    a K8, K6, K7, K10 or K11 row is given the route ``plan_fwd`` or
    ``plan_bwd`` gives (``flash_route``) and checks it the same way; a
    K13 row's route is ``plan_q``'s for int4 codes, and a K16 row
    (operands q, pools, tables first) records and checks the split
    ``ops.paged_attention.plan`` gives ("split" or "whole").  Returns the
    report row."""
    mode = K1_MODES.get(name)
    if mode is not None:
        route, splits = plan_for(*arg_sets[0][:2], mode)
    elif name in I8_NAMES:
        route = Q.plan_for(*arg_sets[0][:2])
    elif name in Q_NAMES:
        route = Q.plan_q_for(*arg_sets[0][:2], Q_NAMES[name])
    elif name in K16_NAMES:
        q, pool, _, tables = arg_sets[0][:4]
        splits, chunk = paged_plan(*q.shape, pool.shape[2], tables.shape[1],
                                   pool.dtype)
        route = "split" if splits > 1 else "whole"
    before = backend.route_counts()
    outs = _tuple(kernel_fn(*arg_sets[0]))
    torch.cuda.synchronize()
    taken = {k: c - before.get(k, 0)
             for k, c in backend.route_counts().items()
             if c != before.get(k, 0)}
    if mode is not None:
        assert taken == {route_key(route, mode, splits): 1}, (name, taken)
    elif name in I8_NAMES or name in Q_NAMES or name in K16_NAMES:
        assert taken == {f"{route} {name}": 1}, (name, taken)
    elif flash_route is not None:
        assert taken == {f"{flash_route} {name}": 1}, (name, taken)
    refs = _tuple(plain_fn(*arg_sets[0]))
    tols = _tuple(TOL[name] if tol is None else tol, len(outs))
    hows = _tuple(("max" if name in NORMWISE else "each") if how is None
                  else how, len(outs))
    errs = [within(o, r, t, hw) for o, r, t, hw in zip(outs, refs, tols,
                                                         hows)]
    err, ok = max(e for e, _, _ in errs), all(good for _, _, good in errs)
    held = ", ".join(f"{hw} {s:.3e} <= {t:.0e}"
                     for (_, s, _), t, hw in zip(errs, tols, hows))
    del outs, refs
    ms = cuda_ms(kernel_fn, arg_sets)
    if plain_ms is None:
        plain_ms = cuda_ms(plain_fn, arg_sets)
    lib_ms = (library_ms if library_fn is None
              else cuda_ms(library_fn, arg_sets))
    row = dict(at=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms,
               library_ms=lib_ms, **bound(*work))
    via = ""
    if mode is not None:
        row.update(k1_route=route, splits=splits)
        via = f" via {route} x{splits}"
        if route == "f32":   # the tile plan sized to the output
            a, b = arg_sets[0][:2]
            m, n, k = (a.shape[1 if mode == "tn" else 0],
                       b.shape[0 if mode == "nt" else 1],
                       a.shape[0 if mode == "tn" else 1])
            row["k1_tile"] = "x".join(map(str, tile_shape(route, m, n, k)))
            via += f" on a {row['k1_tile']} tile"
        if route == "realign":  # each operand's staging
            a, b = arg_sets[0][:2]
            row["k1_staging"] = " ".join(
                "stream" if streams(t) else "windows" for t in (a, b))
            via += f" (a, b: {row['k1_staging']})"
    elif name in I8_NAMES:
        row.update(i8_route=route)
        via = f" via {route}"
    elif name in Q_NAMES:
        row.update(q8_route=route)
        via = f" via {route}"
    elif name in K16_NAMES:
        row.update(k16_route=route, splits=splits, chunk=chunk)
        via = f" via {route} x{splits} of {chunk} table entries"
    elif flash_route is not None:
        row.update(flash_route=flash_route)
        via = f" via {flash_route}"
    lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
    print(f"phase {phase}: {name} {shape}{via}: max_abs_err {err:.3e} "
          f"({held}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms library "
          f"{lib} bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
          f"{len(arg_sets)} operand set(s)")
    assert ok, f"{name} {shape} disagrees with its plain version"
    return row


def headline(rows, pick=0):
    """A kernel's report for one path: the chosen row's numbers and the
    worst error over all its rows."""
    row = dict(rows[pick])
    row["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    return row


def copies_for(*tensors, cold_bytes=128e6):
    """Operand copies that together exceed the 50 MB L2."""
    return max(1, math.ceil(cold_bytes / nbytes(*tensors)))


def cold_sets(*tensors):
    """The argument set ``tensors`` and as many copies of it as take the
    sets together past the 50 MB L2."""
    return [tensors] + [tuple(t.clone() for t in tensors)
                        for _ in range(copies_for(*tensors) - 1)]


def gemm_work(m, n, k, kind, bias=False):
    """Bytes and operations of one product: operands read once, the f32
    result written once."""
    e = 2 if kind == "bf16" else 4
    return (2 * m * n * k, (m * k + n * k + (n if bias else 0)) * e
            + m * n * 4, kind)


def attn_work(b, h, hkv, s, d, kind, products, extra_bytes=0):
    """Causal attention: ``products`` matrix products of 2 S^2 D each over
    the lower triangle; q/k/v-sized tensors counted by the caller."""
    return (products * 2 * b * h * d * s * (s + 1) // 2, extra_bytes, kind)


def k8_alone(row, arg_sets, scale, heads, force, phase):
    """K8's time without its bound pre-pass (``bound_predicate``, plain
    PyTorch: norms of q and k and their maxima, several launches that
    the wrapper runs before the kernel), into ``row["kernel_alone_ms"]``:
    the C entry point called directly, each set's predicate computed
    once (``force`` None: the device's arm).  Its output is first held
    bit for bit to the wrapper's on the same inputs."""
    lib = _build.library()
    b, h, hkv, s, d = A._dims(*arg_sets[0], heads)
    sets = []
    for q, k, v in arg_sets:
        kn, pred = A.bound_predicate(q, k, scale=scale, heads=heads)
        if force is not None:
            pred = torch.full_like(pred, int(force))
        sets.append((q, k, v, torch.empty_like(q),
                     torch.empty(b * h, s, dtype=torch.float32,
                                 device=q.device), kn, pred))

    def kernel(q, k, v, o, lse, kn, pred):
        _build.check(lib.taper_flash_fwd_bound(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), kn.data_ptr(), pred.data_ptr(), None, b, h, hkv,
            s, d, float(scale), A._layout(heads), _build.stream(q)),
            "flash attention (bound)")

    kernel(*sets[0])
    o, lse = A.flash_fwd_bound(*arg_sets[0], scale=scale, heads=heads,
                               force_bound=force)
    assert torch.equal(sets[0][3], o) and torch.equal(sets[0][4], lse)
    row["kernel_alone_ms"] = cuda_ms(kernel, sets)
    print(f"phase {phase}: flash_fwd_bound {row['at']}: the kernel alone "
          f"(its bound pre-pass computed once) {row['kernel_alone_ms']:.4f} "
          f"ms, with the pre-pass {row['ms']:.4f} ms")


def repeats(kernel, args, kw, phase, label):
    """Two calls of K6, K7 or K11 (``kernel`` ``"flash_dq"``,
    ``"flash_dkv"`` or ``"flash_dkv_t"``) on the same inputs give the same
    bits (a fixed order of sums, no atomics)."""
    first = getattr(A, kernel)(*args, **kw)
    again = getattr(A, kernel)(*args, **kw)
    same = all(torch.equal(a, b) for a, b in zip(first, again))
    print(f"phase {phase}: {kernel} {label}: two calls bit-equal: {same}")
    assert same, (kernel, label)


def flash_routes(layers, dtype, mask, backward="split"):
    """The flash calls a step makes by route, as ``plan_fwd`` and
    ``plan_bwd`` predict them: one forward a layer (K8 where
    ``uses_bound``, else K5) and one backward: ``backward`` "split" K6 +
    K7, "dkv_t" K6 + K11, "fused" K10, None none."""
    fwd = "flash_fwd_bound" if A.uses_bound(dtype, mask) else "flash_fwd"
    want = {f"{A.plan_fwd(dtype, mask)} {fwd}": layers}
    if backward in ("split", "dkv_t"):
        want[f"{A.plan_bwd(dtype)} flash_dq"] = layers
    if backward == "split":
        want[f"{A.plan_bwd(dtype)} flash_dkv"] = layers
    if backward == "dkv_t":
        want[f"{A.plan_bwd(dtype)} flash_dkv_t"] = layers
    if backward == "fused":
        want[f"{A.plan_bwd(dtype)} flash_bwd_fused"] = layers
    return want


def flash_only(routes):
    """The flash kernels' entries of a route tally."""
    return {k: c for k, c in routes.items() if "flash" in k}


def phase3_kernels(dev):
    gen = torch.Generator().manual_seed(SEED)
    bf = torch.bfloat16
    report = {}

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(bf).to(dev)

    # linear at the decode (M=16) and prefill (M=512) shapes of the model
    rows = []
    for m in (16, 512):
        for k, n in ((1024, 1024), (1024, 4096), (4096, 1024)):
            copies = max(1, math.ceil(128e6 / (2 * (n * k + m * k))))
            sets = [(randn(m, k), randn(n, k, scale=k ** -0.5),
                     randn(n, scale=0.1)) for _ in range(copies)]
            rows.append(check_kernel(
                "linear", f"bf16 M={m} K={k} N={n} (+bias)", linear,
                linear_reference, sets, library_fn=F.linear,
                work=gemm_work(m, n, k, "bf16", bias=True)))
    # headline shape: the decode MLP up-projection
    report["linear"] = headline(rows, pick=1)

    # flash prefill: one padded prompt, 8 heads of 128, causal (bf16: K8)
    q, k, v = (randn(1, 8, 512, 128) for _ in range(3))
    report["flash_fwd_bound"] = check_kernel(
        "flash_fwd_bound", "bf16 B=1 H=8 S=512 D=128 causal",
        lambda q, k, v: A.attention(q, k, v, causal=True),
        lambda q, k, v: A.attention_reference(q, k, v, causal=True),
        [(q, k, v)],
        library_fn=lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, is_causal=True),
        work=attn_work(1, 8, 8, 512, 128, "bf16", 2,
                       4 * nbytes(q) + 4 * 8 * 512),
        flash_route=A.plan_fwd(bf, "causal"))
    k8_alone(report["flash_fwd_bound"], [(q, k, v)], 128 ** -0.5, None,
             None, 3)
    # the exact arm at the same shape, forced (the row above took the arm
    # the device predicate picks for these inputs)
    arm = int(A.bound_predicate(q, k, scale=128 ** -0.5)[1])
    print(f"phase 3: flash_fwd_bound prefill: the device predicate picks "
          f"the {'bound' if arm else 'exact'} arm")
    exact = check_kernel(
        "flash_fwd_bound", "bf16 B=1 H=8 S=512 D=128 causal exact arm",
        lambda q, k, v: A.flash_fwd_bound(q, k, v, scale=128 ** -0.5,
                                          force_bound=False),
        lambda q, k, v: A.attention_lse_reference(q, k, v, causal=True),
        [(q, k, v)], tol=(TOL["flash_fwd_bound"], LSE_TOL),
        library_fn=lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, is_causal=True),
        work=attn_work(1, 8, 8, 512, 128, "bf16", 2,
                       4 * nbytes(q) + 4 * 8 * 512),
        flash_route=A.plan_fwd(bf, "causal"))
    k8_alone(exact, [(q, k, v)], 128 ** -0.5, None, False, 3)

    # paged decode: 16 slots at mixed lengths in the engine's pool
    bs, slots = ENGINE["block_size"], ENGINE["slots"]
    mb = MODEL["max_seq"] // bs
    n_blocks = pool_blocks()
    lengths = torch.tensor(np.random.default_rng(SEED).integers(
        33, ENGINE["prompt_pad"] + max(MAX_NEW) + 1, slots),
        dtype=torch.int32, device=dev)
    perm = torch.randperm(n_blocks - 1, generator=gen) + 1
    tables = torch.zeros(slots, mb, dtype=torch.int32)
    tables[:, :5] = perm[:slots * 5].reshape(slots, 5)
    tables = tables.to(dev)
    scale = 128 ** -0.5
    sets = [(randn(slots, 8, 1, 128), randn(n_blocks, 8, bs, 128),
             randn(n_blocks, 8, bs, 128), tables, lengths)
            for _ in range(4)]
    tokens = int(lengths.sum())
    report["paged_decode"] = check_kernel(
        "paged_decode", f"bf16 B={slots} kvh=8 G=1 D=128 bs={bs} lengths "
        f"{lengths.min().item()}..{lengths.max().item()}",
        lambda *a: paged_decode_attention(*a, scale=scale),
        lambda *a: paged_decode_reference(*a, scale=scale), sets,
        **K16_TOL[sets[0][0].dtype],
        work=(4 * tokens * 8 * 128,
              2 * tokens * 8 * 128 * 2 + 2 * nbytes(sets[0][0])
              + nbytes(tables, lengths), "bf16"))
    return report


def pool_blocks():
    per_slot = -(-(ENGINE["prompt_pad"] + max(MAX_NEW))
                 // ENGINE["block_size"])
    return ENGINE["slots"] * per_slot + 1


def requests():
    rng = np.random.default_rng(SEED)
    lens = rng.integers(32, ENGINE["prompt_pad"] + 1, N_REQUESTS)
    out = []
    for i, n in enumerate(lens):
        sampling = {}
        if i % 8 == 7:          # a few sampled requests among greedy ones
            sampling = dict(temperature=0.8, top_k=50, top_p=0.9)
        out.append((rng.integers(0, MODEL["vocab_size"], n).tolist(),
                    MAX_NEW[i % len(MAX_NEW)], sampling))
    return out


def phase4_model(dev, prompt):
    """Full-width prefill + one decode step: card (bf16, kernels) against
    the same weights in f32 on the CPU (plain versions)."""
    gen = torch.Generator().manual_seed(SEED)
    cpu = TinyGPT(**MODEL)
    cpu.reset_parameters(gen)
    cpu.eval()
    card = copy.deepcopy(cpu).to(dev).cast_projections(torch.bfloat16)
    card.compute_dtype = torch.bfloat16
    n_params = sum(p.numel() for p in cpu.parameters())

    bs, pad = ENGINE["block_size"], ENGINE["prompt_pad"]
    padded = torch.zeros(1, pad, dtype=torch.int64)
    padded[0, :len(prompt)] = torch.tensor(prompt)
    table = torch.zeros(1, MODEL["max_seq"] // bs, dtype=torch.int32)
    table[0, :pad // bs + 1] = torch.arange(1, pad // bs + 2)
    pos = torch.tensor([len(prompt)], dtype=torch.int32)
    tok = torch.tensor([7])
    results = []
    with torch.no_grad():
        for model, d in ((cpu, "cpu"), (card, dev)):
            pools = model.init_paged_cache(pad // bs + 2, bs, device=d)
            pre = model.prefill_paged(padded.to(d), pools, table.to(d))
            step = model.decode_step_paged(tok.to(d), pos.to(d), pools,
                                           table.to(d))
            results.append((pre[0, :len(prompt)].float().cpu(),
                            step.float().cpu()))
    (pre_ref, step_ref), (pre_out, step_out) = results
    for what, out, ref in (("prefill", pre_out, pre_ref),
                           ("decode step", step_out, step_ref)):
        assert out.shape == ref.shape and torch.isfinite(out).all()
        rel = float((out - ref).norm() / ref.norm())
        err = float((out - ref).abs().max())
        print(f"phase 4: full-width {what} logits {tuple(out.shape)}, "
              f"{n_params / 1e6:.1f}M params: card bf16 vs cpu f32 rel L2 "
              f"err {rel:.3e} (tol {MODEL_REL_TOL:.0e}), max abs err "
              f"{err:.3e}")
        assert rel <= MODEL_REL_TOL, f"{what} logits disagree with f32"
    # the greedy first token, where the f32 top-2 margin is clear of the
    # bf16 error
    top2 = pre_ref[-1].topk(2).values
    clear = float(top2[0] - top2[1]) > 2 * float(
        (pre_out - pre_ref).abs().max())
    return card, int(pre_ref[-1].argmax()), clear


def serving_model(dev):
    """Phase 4's card model again (the same weights from SEED, projections
    cast to bf16, a bf16 trunk)."""
    model = TinyGPT(**MODEL)
    model.reset_parameters(torch.Generator().manual_seed(SEED))
    model.eval()
    model = model.to(dev).cast_projections(torch.bfloat16)
    model.compute_dtype = torch.bfloat16
    return model


def prefill_rate(model, dev, n=8):
    """Padded prompt tokens per second of one-row paged prefill."""
    bs, pad = ENGINE["block_size"], ENGINE["prompt_pad"]
    pools = model.init_paged_cache(pad // bs + 1, bs, device=dev)
    table = torch.zeros(1, MODEL["max_seq"] // bs, dtype=torch.int32,
                        device=dev)
    table[0, :pad // bs] = torch.arange(1, pad // bs + 1, device=dev)
    prompt = torch.randint(0, MODEL["vocab_size"], (1, pad), device=dev)
    with torch.no_grad():
        model.prefill_paged(prompt, pools, table)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            model.prefill_paged(prompt, pools, table)
        torch.cuda.synchronize()
    return n * pad / (time.perf_counter() - t0)


def phase5_serve(model, reqs, first_greedy, first_clear):
    eng = ServingEngine(model, pool_blocks=pool_blocks(), seed=SEED,
                        **ENGINE)
    ids = [eng.submit(p, m, **s) for p, m, s in reqs]
    torch.cuda.synchronize()
    backend.reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = backend.launch_counts()
    for rid, (_, max_new, _) in zip(ids, reqs):
        toks = out[rid]
        assert len(toks) == max_new, (rid, len(toks), max_new)
        assert all(0 <= t < MODEL["vocab_size"] for t in toks), rid
    if first_clear:
        assert out[ids[0]][0] == first_greedy, "first token != f32 argmax"
    assert all(counts[k] > 0 for k in SERVE_KERNELS), counts
    gen_tokens = sum(len(out[i]) for i in ids)
    st = eng.stats()
    return wall, gen_tokens, counts, st


# The stride-1 3x3 convolutions (pad 1, batch 256) as (C, O, H): the
# reference CNN's and ResNet-8's forward and weight gradient; their input
# gradients as K3a runs them, (channels of g, channels of dX, H): every
# layer's but each model's first, whose input is the data.
CNN_CONVS = ((1, 32, 28), (32, 32, 28), (32, 64, 14), (64, 64, 14),
             (64, 128, 7))
CNN_DX = ((32, 32, 28), (64, 32, 14), (64, 64, 14), (128, 64, 7))
RESNET_CONVS = ((3, 16, 32), (16, 16, 32), (32, 32, 16), (64, 64, 8))
RESNET_DX = ((16, 16, 32), (32, 32, 16), (64, 64, 8))


def conv_work(n, c, o, hw):
    """Operations and bytes of one 3x3 convolution, forward, input or
    weight gradient alike: each of the two activations and the weights
    read or written once."""
    return (2 * n * o * c * 9 * hw * hw,
            4 * (n * c * hw * hw + o * c * 9 + n * o * hw * hw), "f32")


def phase6_train_kernels(dev):
    """The training kernels at the CNN's f32 shapes (batch 256), and K3a
    and K3b at ResNet-8's stride-1 shapes.  Returns the CNN's rows and
    ResNet-8's convolution rows."""
    gen = torch.Generator().manual_seed(SEED)
    rows, resnet = {}, {}

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    def run(name, shape, kernel_fn, plain_fn, make, library_fn, work,
            tol=None, into=rows):
        first = make()
        sets = [first] + [make() for _ in range(copies_for(*first) - 1)]
        into.setdefault(name, []).append(check_kernel(
            name, shape, kernel_fn, plain_fn, sets, phase=6, tol=tol,
            library_fn=library_fn, work=work))

    n = CNN["batch"]
    # FC forward: y = act(X[n, K] . W[N, K]^T + b) (nt, the f32 kernel)
    for k, nout, act in ((128, 128, "relu"), (128, 64, "relu"),
                         (64, 10, "none")):
        run("linear", f"f32 {act}([{n},{k}].[{nout},{k}]^T + b)",
            lambda x, w, b, act=act: linear(x, w, b, act),
            lambda x, w, b, act=act: linear_reference(x, w, b, act),
            lambda k=k, nout=nout: (randn(n, k), randn(nout, k,
                                                       scale=k ** -0.5),
                                    randn(nout, scale=0.1)),
            F.linear, gemm_work(n, nout, k, "f32", bias=True),
            tol=LINEAR_F32_TOL)
    # FC backward: dX = g[n, N] . W[N, K] (nn), dW = g^T . X[n, K] (tn)
    for k, nout in ((128, 128), (128, 64), (64, 10)):
        run("gemm_nn", f"f32 [{n},{nout}].[{nout},{k}]",
            lambda a, b: gemm(a, b, "nn"),
            lambda a, b: gemm_reference(a, b, "nn"),
            lambda: (randn(n, nout), randn(nout, k)), torch.matmul,
            gemm_work(n, k, nout, "f32"))
        run("gemm_tn", f"f32 [{n},{nout}]^T.[{n},{k}]",
            lambda a, b: gemm(a, b, "tn"),
            lambda a, b: gemm_reference(a, b, "tn"),
            lambda: (randn(n, nout), randn(n, k)),
            lambda a, b: torch.matmul(a.t(), b),
            gemm_work(nout, k, n, "f32"))
    # K3a: each forward (bias + relu), then each input gradient (no bias;
    # the forward's weights [C_g, O, 3, 3] read flipped in the kernel),
    # 3x3, pad 1; the CNN's shapes first, then ResNet-8's; K3b: each
    # weight gradient
    def make_fwd(c, o, hw):
        return (randn(n, c, hw, hw), randn(o, c, 3, 3, scale=(9 * c) ** -0.5),
                randn(o, scale=0.1))

    def make_dx(c, o, hw):
        return (randn(n, c, hw, hw), randn(c, o, 3, 3, scale=(9 * c) ** -0.5))

    for convs, dxs, into in ((CNN_CONVS, CNN_DX, rows),
                             (RESNET_CONVS, RESNET_DX, resnet)):
        for c, o, hw in convs:
            run("conv_fwd", f"f32 fwd {c}->{o} {hw}x{hw}",
                lambda x, w, b: CD.conv_fwd(x, w, b, (1, 1), "relu"),
                lambda x, w, b: CD.conv2d_reference(x, w, b, (1, 1), "relu"),
                lambda c=c, o=o, hw=hw: make_fwd(c, o, hw),
                lambda x, w, b: F.conv2d(x, w, b, padding=1),
                conv_work(n, c, o, hw), into=into)
        for c, o, hw in dxs:
            run("conv_fwd", f"f32 dX {c}->{o} {hw}x{hw}",
                lambda g, w: CD.conv_fwd(g, w, None, (1, 1), flipped=True),
                lambda g, w: CD.conv2d_reference(g, CD.flip_weights(w), None,
                                                 (1, 1)),
                lambda c=c, o=o, hw=hw: make_dx(c, o, hw),
                lambda g, w, o=o, hw=hw: torch.nn.grad.conv2d_input(
                    (n, o, hw, hw), w, g, padding=1),
                conv_work(n, c, o, hw), into=into)
        for c, o, hw in convs:
            run("conv_dw", f"f32 {c}->{o} {hw}x{hw}",
                lambda x, g: CD.conv_dw(x, g, (3, 3), (1, 1)),
                lambda x, g: CD.conv_dw_reference(x, g, (3, 3), (1, 1)),
                lambda c=c, o=o, hw=hw: (randn(n, c, hw, hw),
                                         randn(n, o, hw, hw)),
                lambda x, g, o=o, c=c: torch.nn.grad.conv2d_weight(
                    x, (o, c, 3, 3), g, padding=1),
                conv_work(n, c, o, hw), into=into)
    # pools: max 2x2 at 28x28 and 14x14, global 7x7 average
    for shape, k, mode in (((n, 32, 28, 28), 2, "max"),
                           ((n, 64, 14, 14), 2, "max"),
                           ((n, 128, 7, 7), 7, "avg")):
        pool, ref, lib = ((PL.max_pool2d, PL.max_pool2d_reference,
                           F.max_pool2d) if mode == "max"
                          else (PL.avg_pool2d, PL.avg_pool2d_reference,
                                F.avg_pool2d))
        elems = math.prod(shape)
        run("pool", f"f32 {mode} {k}x{k} {list(shape)}",
            lambda x, k=k, pool=pool: pool(x, kernel=k),
            lambda x, k=k, ref=ref: ref(x, k, k),
            lambda shape=shape: (randn(*shape),),
            lambda x, k=k, lib=lib: lib(x, k),
            (elems, 4 * (elems + elems // (k * k)), "f32"))

    heads = {"linear": 0, "gemm_nn": 0, "gemm_tn": 0, "conv_fwd": 1,
             "conv_dw": 1, "pool": 0}
    # ResNet-8's headlines: its widest stride-1 layer, 16->16 at 32x32
    return ({name: headline(r, heads[name]) for name, r in rows.items()},
            {name: headline(r, 1) for name, r in resnet.items()})


def rel_l2(out, ref):
    out, ref = out.double().cpu(), ref.double().cpu()
    return float((out - ref).norm() / ref.norm().clamp_min(1e-30))


def _step(dev, x, y, forced=None):
    """One Trainer step of the CNN from the seeded init.  Returns the
    loss, each parameter's gradient and each layer's output (on the CPU).
    ``forced`` (layer outputs of another run) overwrites each layer's
    output in place as it is computed, so that the backward pass sees
    those values: its ReLU masks and max-pool choices are then the other
    run's."""
    tr = Trainer(mnist_cnn(), optim.Adam(CNN["lr"],
                                         weight_decay=CNN["weight_decay"]),
                 seed=SEED, device=dev)
    outs = {}

    def keep(i):
        def hook(module, inputs, out):
            if forced is not None:
                out.data.copy_(forced[i])
            outs[i] = out.detach().cpu()
        return hook
    hooks = [layer.register_forward_hook(keep(i))
             for i, layer in enumerate(tr.model)]
    loss, _ = tr.train_step(torch.as_tensor(x, device=dev),
                            torch.as_tensor(y, device=dev).long())
    for h in hooks:
        h.remove()
    grads = {k: p.grad.detach().cpu() for k, p in tr.model.named_parameters()}
    return float(loss), grads, outs


def phase7_step(dev, data):
    """One training step on the card against the same step on the CPU.

    The loss is held against an independent CPU run.  The gradients are
    held against a CPU run whose backward sees the card's forward values:
    ReLU is discontinuous at 0, and each step has a few pre-activations
    within f32 rounding (~1e-7) of 0 whose sign two summation orders
    decide differently; one such element passes or blocks a whole
    cotangent entry and moves early-layer gradients by 1e-6 to 1e-3
    relative (measured over 8 seed/batch pairs, PERF.md).  Sharing the
    forward decisions leaves the backward arithmetic (K1 nn/tn, K3a as dX,
    K3b, the pooling backward) to the comparison; the independent run's
    gradient gap and its ReLU flips are printed beside it."""
    x = data.images[:CNN["batch"]]
    y = data.labels[:CNN["batch"]]
    loss_card, g_card, out_card = _step(dev, x, y)
    loss_cpu, g_cpu, out_cpu = _step("cpu", x, y)
    _, g_shared, _ = _step("cpu", x, y, forced=out_card)
    relu = [i for i, layer in enumerate(mnist_cnn())
            if getattr(layer, "activation", None) == "relu"]
    flips = {i: int(((out_card[i] > 0) != (out_cpu[i] > 0)).sum())
             for i in relu}
    loss_rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
    rel_ind = {k: rel_l2(g_card[k], g_cpu[k]) for k in g_cpu}
    rel = {k: rel_l2(g_card[k], g_shared[k]) for k in g_cpu}
    worst, worst_ind = max(rel, key=rel.get), max(rel_ind, key=rel_ind.get)
    print(f"phase 7: one CNN step (batch {CNN['batch']}), card vs cpu: loss "
          f"{loss_card:.6f} vs {loss_cpu:.6f}, rel err {loss_rel:.3e} (tol "
          f"{STEP_LOSS_TOL:.0e}); grads vs the cpu backward on the card's "
          f"forward values: rel L2 max {rel[worst]:.3e} at {worst} (tol "
          f"{STEP_GRAD_TOL:.0e}) over {len(rel)} parameters; independent "
          f"cpu run: ReLU decisions that differ per layer {flips}, grads "
          f"rel L2 max {rel_ind[worst_ind]:.3e} at {worst_ind} (tol "
          f"{STEP_GRAD_IND_TOL:.0e})")
    assert loss_rel <= STEP_LOSS_TOL, "step loss disagrees with the CPU"
    assert all(torch.isfinite(g).all() for g in g_card.values())
    assert rel[worst] <= STEP_GRAD_TOL, f"{worst} grad disagrees"
    assert rel_ind[worst_ind] <= STEP_GRAD_IND_TOL, (
        f"{worst_ind} grad drifts from the independent CPU step")


def split_counts(fit_counts, counts, steps, epochs):
    """Launches per training step and per evaluation pass of a
    ``fit_device`` run of ``epochs`` x ``steps``: ``counts`` adds one
    final evaluation at the run's eval batch size to ``fit_counts``, and
    fit_device ran one such pass per epoch besides its steps (kernels
    that did not launch are left out)."""
    per_eval = {k: counts[k] - fit_counts[k] for k in backend.KERNELS}
    per_step = {k: (fit_counts[k] - epochs * per_eval[k]) / (steps * epochs)
                for k in backend.KERNELS}
    return ({k: v for k, v in per_step.items() if v},
            {k: v for k, v in per_eval.items() if v})


def phase8_train(dev, train, test, smi):
    trainer = Trainer(mnist_cnn(),
                      optim.Adam(CNN["lr"], weight_decay=CNN["weight_decay"]),
                      scheduler=optim.StepLR(CNN["lr"], CNN["step_size"],
                                             CNN["gamma"]),
                      seed=SEED, device=dev)
    steps = len(train) // CNN["batch"]
    torch.cuda.synchronize()
    backend.reset_launch_counts()
    t0 = time.perf_counter()
    m = trainer.fit_device(train.images, train.labels, test.images,
                           test.labels, CNN["epochs"],
                           batch_size=CNN["batch"], early_stop_acc=2.0,
                           verbose=False, eval_batch_size=CNN["eval_batch"])
    torch.cuda.synchronize()
    fit_counts = backend.launch_counts()
    ev = trainer.evaluate(test.images, test.labels,
                          batch_size=CNN["eval_batch"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = backend.launch_counts()
    assert len(m.epoch_times) == CNN["epochs"], m.epoch_times
    assert all(math.isfinite(v) for v in m.train_loss + m.val_loss)
    epoch_s = sum(m.epoch_times) / len(m.epoch_times)
    per_step, per_eval = split_counts(fit_counts, counts, steps,
                                      CNN["epochs"])
    print(f"phase 8: trained mnist_cnn {CNN['epochs']} epochs x {steps} "
          f"steps (batch {CNN['batch']}, synthetic {len(train)}/{len(test)}) "
          f"in {wall:.2f} s: epoch times {m.epoch_times} s, "
          f"{steps * CNN['batch'] / epoch_s:.1f} samples/s; train loss "
          f"{m.train_loss}, val acc {m.val_acc} (best {max(m.val_acc)}, "
          f"gate {CNN['min_acc']}); final evaluation on all {len(test)} "
          f"test images: loss {ev['loss']:.4f} acc {ev['acc']:.4f}; "
          f"launches {counts}, "
          f"per training step {per_step}, per evaluation pass of "
          f"{len(test)} images {per_eval}; on {smi}")
    assert max(m.val_acc) >= CNN["min_acc"], m.val_acc
    assert all(counts[k] > 0 for k in TRAIN_KERNELS), counts
    assert per_step == CNN_PER_STEP, per_step
    xd = torch.as_tensor(train.images[:CNN["batch"]], device=dev)
    yd = torch.as_tensor(train.labels[:CNN["batch"]], device=dev).long()
    prof = profile_steps(lambda: trainer.train_step(xd, yd), 3,
                         CONV_FAMILIES)
    print(f"phase 8: profiled 3 CNN steps: {prof['wall_ms']:.2f} ms of wall "
          f"per step (under the profiler) for {prof['busy_ms']:.2f} ms of "
          f"device busy time, {prof['device_ops']:.0f} device ops per step; "
          f"device ms per step by family {prof['ms']}; largest glue "
          f"{prof['glue_top']}")
    return counts


# -- the LM path ---------------------------------------------------------------

def gemm_rows(dev, shapes, dtype, phase, tol, gen):
    """K1 in modes nt, nn and tn at the products ``(t, K_in, N_out)`` of a
    layer with ``t`` rows: the forward, dX and dW."""
    kind = "bf16" if dtype == torch.bfloat16 else "f32"
    rows = {}

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dtype).to(dev)

    for t, k_in, n_out in shapes:
        x, w = randn(t, k_in), randn(n_out, k_in, scale=k_in ** -0.5)
        b = randn(n_out, scale=0.1)
        rows.setdefault("linear", []).append(check_kernel(
            "linear", f"{kind} [{t},{k_in}].[{n_out},{k_in}]^T + b",
            linear, linear_reference, cold_sets(x, w, b), phase=phase,
            tol=tol, library_fn=F.linear,
            work=gemm_work(t, n_out, k_in, kind, True)))
        g = randn(t, n_out)
        rows.setdefault("gemm_nn", []).append(check_kernel(
            "gemm_nn", f"{kind} dX [{t},{n_out}].[{n_out},{k_in}]",
            lambda a, b: gemm(a, b, "nn"),
            lambda a, b: gemm_reference(a, b, "nn"), cold_sets(g, w),
            phase=phase, tol=tol, library_fn=torch.matmul,
            work=gemm_work(t, k_in, n_out, kind)))
        g = randn(t, n_out, scale=t ** -0.5)
        rows.setdefault("gemm_tn", []).append(check_kernel(
            "gemm_tn", f"{kind} dW [{t},{n_out}]^T.[{t},{k_in}]",
            lambda a, b: gemm(a, b, "tn"),
            lambda a, b: gemm_reference(a, b, "tn"), cold_sets(g, x),
            phase=phase, tol=tol,
            library_fn=lambda a, b: torch.matmul(a.t(), b),
            work=gemm_work(n_out, k_in, t, kind)))
        del x, w, b, g
    return rows


def lm_flash_rows(dev, b, h, s, d, dtype, phase, gen, layouts, fwd_arms,
                  backward=True):
    """The flash kernels at one attention shape (causal, MHA) against the
    plain versions: the forward arms ``fwd_arms`` (of ``"exact"``,
    ``"bound"``, ``"bound_off"``) then, with ``backward``, K6 and K7, in
    each layout."""
    kind = "bf16" if dtype == torch.bfloat16 else "f32"
    f32 = dtype == torch.float32
    scale = d ** -0.5
    q, k, v, do = ((torch.randn(b, h, s, d, generator=gen)).to(dtype).to(dev)
                   for _ in range(4))
    io = nbytes(q)                          # one q/k/v/o-sized tensor
    rows_bytes = 4 * b * h * s              # one [B*H, S] f32 row vector
    plain_fwd = A.attention_lse_reference
    ref_o, ref_lse = plain_fwd(q, k, v, causal=True, scale=scale)
    if backward:
        ref = A.flash_bwd_reference(q, k, v, ref_o, ref_lse, do, True,
                                    scale)

    def sdpa(q4, k4, v4):
        return F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)

    def sdpa_fwd_bwd(q4, k4, v4, do4):
        leaves = [t.detach().requires_grad_(True) for t in (q4, k4, v4)]
        sdpa(*leaves).backward(do4)

    rows = {}
    label = f"{kind} B={b} H={h} S={s} D={d} causal"
    for layout in layouts:
        heads = None if layout == "bhsd" else h

        def to4(t, layout=layout):
            return t if layout == "bhsd" else A._to_bhsd(t, 1, d)

        def lay(t, layout=layout):
            return t if layout == "bhsd" else A._from_bhsd(t, 1).contiguous()

        args = tuple(lay(t) for t in (q, k, v))
        fwd_work = attn_work(b, h, h, s, d, kind, 2, 4 * io + rows_bytes)
        fsets = cold_sets(*args)
        for arm in fwd_arms:
            route = A.plan_fwd(dtype, "causal")
            if arm == "exact":
                name, fn = "flash_fwd", lambda *a, heads=heads: \
                    A.flash_fwd_exact(*a, causal=True, scale=scale,
                                      heads=heads)
            else:
                name = "flash_fwd_bound"
                fn = lambda *a, heads=heads, arm=arm: A.flash_fwd_bound(
                    *a, scale=scale, heads=heads,
                    force_bound=arm == "bound")
            rows.setdefault(name, []).append(check_kernel(
                name, f"{label} {layout} {arm} arm",
                lambda *a, fn=fn, to4=to4: (lambda o, l: (to4(o), l))(
                    *fn(*a)),
                lambda *a, to4=to4: plain_fwd(*(to4(t) for t in a),
                                              causal=True, scale=scale),
                fsets, phase=phase,
                tol=(FLASH_F32_TOL, LSE_F32_TOL) if f32
                else (TOL[name], LSE_TOL),
                library_fn=lambda *a, to4=to4: sdpa(*(to4(t) for t in a)),
                work=fwd_work, flash_route=route))
            if name == "flash_fwd_bound":
                k8_alone(rows[name][-1], fsets, scale, heads, arm == "bound",
                         phase)
        del fsets
        if not backward:
            continue
        bsets = cold_sets(*args, lay(ref_o), ref_lse, lay(do))
        plain_bwd = lambda q_, k_, v_, o_, l_, do_, to4=to4: \
            A.flash_bwd_reference(*(to4(t) for t in (q_, k_, v_, o_)), l_,
                                  to4(do_), True, scale)
        # the plain backward is one function for both kernels, and SDPA's
        # backward computes dQ, dK and dV together: each is timed once
        plain_ms = cuda_ms(plain_bwd, bsets, iters=5)
        lib_fwd = cuda_ms(lambda *a: sdpa(*(to4(t) for t in a[:3])), bsets)
        lib_bwd = cuda_ms(lambda *a: sdpa_fwd_bwd(
            *(to4(t) for t in a[:3]), to4(a[5])), bsets) - lib_fwd
        print(f"phase {phase}: flash backward {label} {layout}: plain "
              f"backward (both kernels' work) {plain_ms:.4f} ms; library "
              f"F.scaled_dot_product_attention forward {lib_fwd:.4f} ms, "
              f"backward {lib_bwd:.4f} ms (forward + backward less forward)")
        # bf16: each 64-row tile against its own norm (see TOL's notes)
        how = "each" if f32 else "tiles"
        rows.setdefault("flash_dq", []).append(check_kernel(
            "flash_dq", f"{label} {layout}",
            lambda q_, k_, v_, o_, l_, do_, heads=heads, to4=to4:
                (lambda dq, de: (to4(dq), de))(*A.flash_dq(
                    q_, k_, v_, o_, l_, do_, causal=True, scale=scale,
                    heads=heads)),
            lambda *a: (ref[0], ref[3]), bsets, phase=phase,
            tol=(FLASH_F32_TOL if f32 else BWD_BF16_TOL, DELTA_TOL),
            how=(how, "each"), plain_ms=plain_ms, library_ms=lib_bwd,
            work=attn_work(b, h, h, s, d, kind, 3,
                           6 * io + 2 * rows_bytes),
            flash_route=A.plan_bwd(dtype)))
        repeats("flash_dq", bsets[0], dict(causal=True, scale=scale,
                                            heads=heads), phase,
                f"{label} {layout}")
        _, delta = A.flash_dq(*bsets[0], causal=True, scale=scale,
                              heads=heads)
        dsets = cold_sets(*args, ref_lse, delta, lay(do))
        rows.setdefault("flash_dkv", []).append(check_kernel(
            "flash_dkv", f"{label} {layout}",
            lambda q_, k_, v_, l_, de, do_, heads=heads, to4=to4:
                tuple(to4(t) for t in A.flash_dkv(
                    q_, k_, v_, l_, de, do_, causal=True, scale=scale,
                    heads=heads)),
            lambda *a: (ref[1], ref[2]), dsets, phase=phase,
            tol=(FLASH_F32_TOL if f32 else BWD_BF16_TOL,) * 2,
            how=(how,) * 2, plain_ms=plain_ms, library_ms=lib_bwd,
            work=attn_work(b, h, h, s, d, kind, 4,
                           6 * io + 2 * rows_bytes),
            flash_route=A.plan_bwd(dtype)))
        repeats("flash_dkv", dsets[0], dict(causal=True, scale=scale,
                                             heads=heads), phase,
                f"{label} {layout}")
        del bsets, dsets, delta
    return rows


def phase9_lm_kernels(dev):
    """The LM kernels at the 170M model's full-width shapes in bf16."""
    gen = torch.Generator().manual_seed(SEED)
    t, e = LM_BATCH * LM["max_seq"], LM["dim"]
    rows = gemm_rows(dev, ((t, e, e), (t, e, 4 * e), (t, 4 * e, e)),
                     torch.bfloat16, 9, BF16_GEMM_TOL, gen)
    torch.cuda.empty_cache()
    rows.update(lm_flash_rows(
        dev, LM_BATCH, LM["num_heads"], LM["max_seq"],
        e // LM["num_heads"], torch.bfloat16, 9, gen, ("bhsd", "bshd"),
        ("exact", "bound", "bound_off")))
    torch.cuda.empty_cache()
    return rows


# K1's bitwise checks: each bf16 route and mode at a shape that takes it,
# (route, mode, M, N, K); and the split shapes called twice
K1_BIT_CASES = (("wgmma", "nt", 2048, 4096, 1024),
                ("wgmma", "nn", 2048, 1024, 4096),
                ("wgmma", "tn", 1024, 4096, 16384),
                ("wgmma", "tn", 1024, 1024, 16384),   # split in 2
                ("wgmma", "nt", 300, 264, 520),       # ragged, split
                ("wgmma", "nt", 300, 262, 520),       # direct stores
                ("realign", "nt", 33, 70, 130),
                ("realign", "nn", 33, 70, 130),
                ("realign", "tn", 33, 70, 130),
                ("realign", "tn", 9, 40, 264),        # M <= 16, streamed
                ("decode", "nt", 16, 1024, 1024),     # no cluster
                ("decode", "nt", 1, 4096, 1024), ("decode", "nt", 5, 19, 37),
                ("decode", "nt", 8, 8192, 2048),
                ("decode", "nt", 16, 1024, 4096),     # a cluster of 4
                ("decode", "nt", 4, 1024, 8192))      # a cluster of 8
K1_REPEAT_CASES = (("tn", 1024, 1024, 16384, torch.bfloat16),
                   ("nt", 16, 1024, 4096, torch.bfloat16),    # decode x4
                   ("nt", 5, 2048, 2048, torch.bfloat16),     # decode x2
                   ("tn", 128, 128, 8192, torch.float32),     # sort dW
                   ("tn", 32, 144, 65536, torch.float32))     # ResNet-8 dW


def k1_operands(mode, m, n, k, dtype, gen, dev):
    a = torch.randn(*((m, k) if mode != "tn" else (k, m)), generator=gen)
    b = torch.randn(*((n, k) if mode == "nt" else (k, n)),
                    generator=gen) * k ** -0.5
    return a.to(dtype).to(dev), b.to(dtype).to(dev)


def k1_call(a, b, mode, out_dtype=None):
    if mode == "nt":
        return linear(a, b, None, out_dtype=out_dtype)
    return gemm(a, b, mode, out_dtype=out_dtype)


# K1's decode route at every M it takes on the serving paths: the serving
# model's (K_in, N_out) and the quantized-serving baseline's bf16 up
# projection (M 8 N 8192 K 2048)
DECODE_MS = (1, 5, 8, 16)
DECODE_SHAPES = ((1024, 1024), (1024, 4096), (4096, 1024), (2048, 8192))


def decode_rows(dev, gen):
    """K1's decode route against its plain version at each M of
    DECODE_MS and shape of DECODE_SHAPES, with a bias and each epilogue
    in turn (2e-4: exact bf16 products summed in another order), its bf16
    output the f32 output cast, bit for bit, and two calls bit-equal; the
    route and cluster ``plan`` names are the ones taken.  Times the
    baseline's shape at M 8 against its plain version and F.linear;
    returns that row."""
    worst, acts = 0.0, ("none", "relu", "sigmoid")
    for i, (m, (k, n)) in enumerate((m, kn) for m in DECODE_MS
                                    for kn in DECODE_SHAPES):
        x = torch.randn(m, k, generator=gen).to(torch.bfloat16).to(dev)
        w = (torch.randn(n, k, generator=gen) * k ** -0.5).to(
            torch.bfloat16).to(dev)
        b = (torch.randn(n, generator=gen) * 0.1).to(torch.bfloat16).to(dev)
        act = acts[i % 3]
        route, splits = plan_for(x, w, "nt")
        assert route == "decode", (m, n, k, route)
        before = backend.route_counts()
        y = linear(x, w, b, act)
        torch.cuda.synchronize()
        taken = {key: c - before.get(key, 0)
                 for key, c in backend.route_counts().items()
                 if c != before.get(key, 0)}
        assert taken == {route_key(route, "nt", splits): 1}, taken
        _, stat, ok = within(y, linear_reference(x, w, b, act),
                             BF16_GEMM_TOL)
        y16 = linear(x, w, b, out_dtype=torch.bfloat16)
        same = (torch.equal(y, linear(x, w, b, act)) and torch.equal(
            y16, linear(x, w, b).to(torch.bfloat16)))
        worst = max(worst, stat)
        assert ok and same, (m, n, k, act, stat, same)
    print(f"phase 29: K1 decode at M {DECODE_MS} x (K, N) {DECODE_SHAPES}, "
          f"bias and {'/'.join(acts)} in turn: worst (err / (1 + |ref|)) "
          f"{worst:.3e} (tol {BF16_GEMM_TOL:.0e}); bf16 out equals the f32 "
          f"out cast and two calls are bit-equal at every one")
    k, n = DECODE_SHAPES[-1]
    x = torch.randn(8, k, generator=gen).to(torch.bfloat16).to(dev)
    w = (torch.randn(n, k, generator=gen) * k ** -0.5).to(
        torch.bfloat16).to(dev)
    b = (torch.randn(n, generator=gen) * 0.1).to(torch.bfloat16).to(dev)
    return check_kernel(
        "linear", f"bf16 M=8 K={k} N={n} (+bias; the quantized-serving "
        f"baseline's up projection)", linear, linear_reference,
        cold_sets(x, w, b), phase=29, tol=BF16_GEMM_TOL, library_fn=F.linear,
        work=gemm_work(8, n, k, "bf16", bias=True))


def misaligned(t, offset=1):
    """A copy of ``t`` as a contiguous view ``offset`` elements into a
    buffer of its own (2 bytes off the 16-byte grid for bf16)."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    buf[offset:].copy_(t.reshape(-1))
    return buf[offset:].view(t.shape)


def phase29_k1_bits(dev):
    """K1 on the card, bit for bit: (a) for each bf16 route and mode, the
    kernel writing bf16 equals its own f32 result cast to bf16 (one
    round-to-nearest-even of the same f32 value); (b) a split-K call (and
    a decode call split over a cluster) repeats its bits (the splits
    summed in a fixed order, no atomics).  Also times the realign route
    against its plain version and the library call (K_in 1,001 in each
    mode, and the serving prefill's (e, e) projection with x 2 bytes off
    its allocation's 16-byte grid), and holds the decode route at every M
    and serving shape (:func:`decode_rows`); returns the timed rows."""
    gen = torch.Generator().manual_seed(SEED)
    for route, mode, m, n, k in K1_BIT_CASES:
        a, b = k1_operands(mode, m, n, k, torch.bfloat16, gen, dev)
        got, splits = plan_for(a, b, mode)
        assert got == route, (route, mode, m, n, k, got)
        y32 = k1_call(a, b, mode)
        y16 = k1_call(a, b, mode, torch.bfloat16)
        same = torch.equal(y16, y32.to(torch.bfloat16))
        print(f"phase 29: K1 {route} x{splits} {mode} M={m} N={n} K={k}: "
              f"bf16 out equals the f32 out cast: {same}")
        assert y16.dtype == torch.bfloat16 and same, (route, mode)
    # the realign route's time (no path shape takes it: every path's
    # operands are TMA-aligned): K_in of 1,001
    t, k_in, n_out = 512, 1001, 1000
    x, w = k1_operands("nt", t, n_out, k_in, torch.bfloat16, gen, dev)
    g = k1_operands("nn", t, k_in, n_out, torch.bfloat16, gen, dev)[0]
    bias = torch.randn(n_out, generator=gen).to(torch.bfloat16).to(dev)
    rows = dict(
        linear=check_kernel(
            "linear", f"bf16 [{t},{k_in}].[{n_out},{k_in}]^T + b", linear,
            linear_reference, cold_sets(x, w, bias), phase=29,
            tol=BF16_GEMM_TOL, library_fn=F.linear,
            work=gemm_work(t, n_out, k_in, "bf16", True)),
        gemm_nn=check_kernel(
            "gemm_nn", f"bf16 dX [{t},{n_out}].[{n_out},{k_in}]",
            lambda a, b: gemm(a, b, "nn"),
            lambda a, b: gemm_reference(a, b, "nn"), cold_sets(g, w),
            phase=29, tol=BF16_GEMM_TOL, library_fn=torch.matmul,
            work=gemm_work(t, k_in, n_out, "bf16")),
        gemm_tn=check_kernel(
            "gemm_tn", f"bf16 dW [{t},{n_out}]^T.[{t},{k_in}]",
            lambda a, b: gemm(a, b, "tn"),
            lambda a, b: gemm_reference(a, b, "tn"), cold_sets(g, x),
            phase=29, tol=BF16_GEMM_TOL,
            library_fn=lambda a, b: torch.matmul(a.t(), b),
            work=gemm_work(n_out, k_in, t, "bf16")))
    # a misaligned view of an aligned shape: x [512, 1024] 2 bytes off
    # (every copy a view of its own), the weight and bias aligned
    e = MODEL["dim"]
    x = torch.randn(t, e, generator=gen).to(torch.bfloat16).to(dev)
    w = (torch.randn(e, e, generator=gen) * e ** -0.5).to(
        torch.bfloat16).to(dev)
    bias = torch.randn(e, generator=gen).to(torch.bfloat16).to(dev)
    sets = [(misaligned(x), w, bias)]
    sets += [(misaligned(x), w.clone(), bias.clone())
             for _ in range(copies_for(x, w, bias) - 1)]
    rows["linear_view"] = check_kernel(
        "linear", f"bf16 [{t},{e}] 2 bytes off.[{e},{e}]^T + b", linear,
        linear_reference, sets, phase=29, tol=BF16_GEMM_TOL,
        library_fn=F.linear, work=gemm_work(t, e, e, "bf16", True))
    assert all(r["k1_route"] == "realign" for r in rows.values()), rows
    assert rows["linear_view"]["k1_staging"] == "windows stream", rows
    rows["decode"] = decode_rows(dev, gen)
    for mode, m, n, k, dtype in K1_REPEAT_CASES:
        a, b = k1_operands(mode, m, n, k, dtype, gen, dev)
        route, splits = plan_for(a, b, mode)
        ys = [k1_call(a, b, mode) for _ in range(2)]
        same = torch.equal(ys[0], ys[1])
        print(f"phase 29: K1 {route} x{splits} {mode} M={m} N={n} K={k} "
              f"{dtype}: two calls bit-equal: {same}")
        assert splits > 1 and same, (mode, m, n, k, splits)
    torch.cuda.empty_cache()
    return rows


def lm_grads(model, *args, **kw):
    """One loss and backward at the model's current weights: ``(loss,
    {name: f32 gradient on the CPU})``; the gradients are cleared before
    and after."""
    model.zero_grad(set_to_none=True)
    loss, _ = model.loss(*args, **kw)
    loss.backward()
    grads = {k: (torch.zeros_like(p) if p.grad is None else p.grad)
             .detach().float().cpu() for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


def phase10_lm_step(dev):
    """One full-width 170M step at batch 1: card (f32, then a bf16 trunk)
    against the CPU in f32, same weights and tokens."""
    gen = torch.Generator().manual_seed(SEED)
    cpu = TinyGPT(**LM)
    cpu.reset_parameters(gen)
    toks = torch.randint(0, LM["vocab_size"], (1, LM["max_seq"]),
                         generator=gen)
    tgts, mask = toks.roll(-1, 1), torch.ones(LM["max_seq"])
    t0 = time.perf_counter()
    loss_ref, g_ref = lm_grads(cpu, toks, tgts, mask)
    cpu_s = time.perf_counter() - t0
    results = {}
    for trunk in ("f32", "bf16"):
        card = copy.deepcopy(cpu).to(dev)
        if trunk == "bf16":
            card.compute_dtype = torch.bfloat16
        loss, g = lm_grads(card, toks.to(dev), tgts.to(dev), mask.to(dev))
        del card
        torch.cuda.empty_cache()
        rel = {k: rel_l2(g[k], g_ref[k]) for k in g_ref}
        worst = max(rel, key=rel.get)
        loss_rel = abs(loss - loss_ref) / abs(loss_ref)
        results[trunk] = (loss_rel, rel[worst], worst)
        loss_tol, grad_tol = ((LM_LOSS_TOL, LM_GRAD_TOL) if trunk == "f32"
                              else (LM_BF16_LOSS_TOL, LM_BF16_GRAD_TOL))
        med = float(np.median(list(rel.values())))
        print(f"phase 10: one 170M step (batch 1 x {LM['max_seq']}), card "
              f"{trunk} trunk vs cpu f32 ({cpu_s:.1f} s on the cpu): loss "
              f"{loss:.6f} vs {loss_ref:.6f}, rel err {loss_rel:.3e} (tol "
              f"{loss_tol:.0e}); grads rel L2 max {rel[worst]:.3e} at "
              f"{worst}, median {med:.3e} over {len(rel)} parameters (tol "
              f"{grad_tol:.0e})")
        assert all(torch.isfinite(x).all() for x in g.values())
        assert loss_rel <= loss_tol, f"{trunk} step loss disagrees"
        assert rel[worst] <= grad_tol, f"{trunk} {worst} grad disagrees"
    # K5, K6 and K7 in f32 at the f32 step's attention shape
    h = LM["num_heads"]
    return results, lm_flash_rows(dev, 1, h, LM["max_seq"], LM["dim"] // h,
                                  torch.float32, 10, gen, ("bshd",),
                                  ("exact",))


# every K1 kernel: the wgmma route, the realign route, the decode route,
# the f32 tile, and the split-K reduce of wgmma and f32 (by symbol:
# cuBLAS's f32 kernels are named "...gemm_f32f32...")
K1_FAMILIES = (("K1 gemm", "gemm_wgmma"), ("K1 gemm", "gemm_realign"),
               ("K1 gemm", "gemm_decode"), ("K1 gemm", "gemm_f32_kernel"),
               ("K1 gemm", "splitk_reduce"))
OPT_FAMILY = ("K17 optimizer", "multi_tensor_kernel")
# the flash kernels by name: the FMA ones of flash_fwd.cu and
# flash_bwd_f32.cu and the wgmma ones of flash_sm90.cu and
# flash_bwd_sm90.cu (namespace taper::flash::sm90; K8 and K5 are
# fwd_kernel<D, MASKED>; K11 is K7's kernel in its per-head mode)
LM_FAMILIES = K1_FAMILIES + (OPT_FAMILY,
                             ("K8/K5 flash fwd", "flash_fwd_f32"),
                             ("K8/K5 flash fwd", "sm90::fwd_kernel"),
                             ("K6 flash dq", "dq_f32_kernel"),
                             ("K6 flash dq", "sm90::dq_kernel"),
                             ("K7 flash dkv", "dkv_f32_kernel"),
                             ("K7 flash dkv", "sm90::dkv_kernel"))
CONV_FAMILIES = K1_FAMILIES + (("K3a conv fwd/dX", "conv_fwd"),
                 ("K3b conv dW", "conv_dw"), ("K3b conv dW", "split_sum"),
                 ("K4 pool", "pool_"), ("K2 elementwise", "ew_kernel"),
                 OPT_FAMILY)


def release():
    """Free the card's memory of what was deleted: a model keeps its
    decode programs (utils/graphs.py), whose steps refer back to it, so
    the cycle goes at a collection."""
    gc.collect()
    torch.cuda.empty_cache()


# the profiler keeps only device activity inside its window, whose ends
# are taken on the host's clock: a margin on each side keeps a kernel at
# the window's edge in it
PROFILE_MARGIN_S = 0.01


def profile_steps(step, n, families=LM_FAMILIES, host=True):
    """Device time of ``n`` steps by kernel family, from a torch.profiler
    trace: the union of the device intervals (busy) against the host
    clock (wall), each family's summed kernel time, and the kernels
    launched by name (``kernels``, a count over the ``n`` steps; without
    the CUDA runtime's copy kernels, ``memcpy*``/``memset*``, which run a
    CUDA graph's copy nodes where an eager copy is a memcpy).
    ``host=False`` traces the device alone."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=([ProfilerActivity.CPU] if host else [])
                 + [ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_MARGIN_S)
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        time.sleep(PROFILE_MARGIN_S)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    spans, by_family, glue = [], {}, {}
    kernels = collections.Counter()
    for ev in events:
        if ev.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        if ev["cat"] == "kernel" and not ev["name"].startswith(
                ("memcpy", "memset")):
            kernels[ev["name"]] += 1
        spans.append((ev["ts"], ev["ts"] + ev["dur"]))
        fam = next((f for f, key in families if key in ev["name"]), None)
        if fam is None:
            glue[ev["name"][:60]] = glue.get(ev["name"][:60], 0) + ev["dur"]
            fam = "glue"
        by_family[fam] = by_family.get(fam, 0.0) + ev["dur"]
    busy, end = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    top = sorted(glue.items(), key=lambda kv: -kv[1])[:6]
    return dict(wall_ms=wall / n * 1e3, busy_ms=busy / n / 1e3,
                device_ops=len(spans) / n,
                ms={k: v / n / 1e3 for k, v in by_family.items()},
                glue_top={k: v / n / 1e3 for k, v in top}, kernels=kernels)


def per_step(counts, steps):
    return {k: c / steps for k, c in counts.items() if c}


def planned_routes(products, dtype):
    """K1 calls a step makes by route, as ``plan`` predicts them: the
    forward, dX and dW of each ``(t, K_in, N_out)`` product (operands
    TMA-aligned)."""
    want = {}
    for t, k_in, n_out in products:
        for mode, m, n, k in (("nt", t, n_out, k_in), ("nn", t, k_in, n_out),
                              ("tn", n_out, k_in, t)):
            route, splits = plan(m, n, k, dtype, mode, True)
            key = route_key(route, mode, splits)
            want[key] = want.get(key, 0) + 1
    return want


def phase11_lm_train(dev, smi):
    """Train the 170M model in bf16: batch 8 x 2048, Adam(1e-4)."""
    gen = torch.Generator().manual_seed(SEED)
    model = TinyGPT(**LM, compute_dtype=torch.bfloat16)
    model.reset_parameters(gen)
    model.to(dev)
    n_params = sum(p.numel() for p in model.parameters())
    opt = optim.Adam(LM_LR).init(model.parameters())
    toks = torch.randint(0, LM["vocab_size"], (LM_BATCH, LM["max_seq"]),
                         generator=gen).to(dev)
    tgts = toks.roll(-1, 1)
    mask = torch.ones(LM["max_seq"], device=dev)
    step = train_step(model, opt, toks, tgts, mask)
    torch.cuda.reset_peak_memory_stats()
    losses = [step() for _ in range(LM_WARMUP)]
    torch.cuda.synchronize()
    backend.reset_launch_counts()
    t0 = time.perf_counter()
    losses += [step() for _ in range(LM_STEPS)]
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / LM_STEPS
    counts = backend.launch_counts()
    routes = per_step(backend.route_counts(), LM_STEPS)
    bound_taken = backend.bound_arm_count()      # one read from the device
    peak = torch.cuda.max_memory_allocated()
    losses = torch.stack(losses).tolist()
    tokens = LM_BATCH * LM["max_seq"]
    # model FLOPs as bench.py:185-186 counts them: 6 P T plus causal
    # attention
    flops = 3 * (2 * n_params * tokens + LM["depth"] * 4 * LM_BATCH
                 * LM["max_seq"] ** 2 * LM["dim"] * 0.5)
    mfu = flops / step_s / PEAK_FLOPS["bf16"]
    print(f"phase 11: trained the 170M TinyGPT ({n_params / 1e6:.1f}M "
          f"params, bf16 trunk, batch {LM_BATCH} x {LM['max_seq']}, "
          f"Adam({LM_LR})): {LM_WARMUP} warm-up + {LM_STEPS} timed steps, "
          f"{step_s * 1e3:.1f} ms/step, {tokens / step_s:.0f} tokens/s, "
          f"model FLOPs {flops:.3e}/step = {mfu:.4f} of 989 TFLOP/s "
          f"(bf16 dense peak; card {smi}), peak memory "
          f"{peak / 2 ** 30:.2f} GiB; card clocks {card_clocks()}; loss per "
          f"step {losses}; launches per "
          f"step {per_step(counts, LM_STEPS)}; K8 launches that took the "
          f"bound arm: {bound_taken} of {counts['flash_fwd_bound']}")
    assert all(math.isfinite(x) for x in losses), losses
    assert per_step(counts, LM_STEPS) == LM_PER_STEP, counts
    # every projection through wgmma, dW at (e, e) split over K; K8, K6 and
    # K7 through wgmma
    e = LM["dim"]
    want = {k: v * LM["depth"] for k, v in planned_routes(
        ((tokens, e, e),) * 4 + ((tokens, e, 4 * e), (tokens, 4 * e, e)),
        torch.bfloat16).items()}
    want.update(flash_routes(LM["depth"], torch.bfloat16, "causal"))
    print(f"phase 11: K1, K8, K6 and K7 calls per step by route {routes} "
          f"(plan: {want})")
    assert routes == want, (routes, want)
    assert all(k.startswith("wgmma") for k in routes)
    assert routes.get("wgmma tn split"), routes
    params = list(model.parameters())
    adam_row = opt_row("adam", f"170M TinyGPT Adam({LM_LR})", params,
                       [p.grad for p in params],
                       dict(lr=LM_LR, wd=0.0, decoupled=False), 11)
    torch.cuda.empty_cache()
    prof = profile_steps(step, 2)
    print(f"phase 11: profiled 2 steps: {prof['wall_ms']:.1f} ms of wall "
          f"per step (under the profiler) for {prof['busy_ms']:.1f} ms of "
          f"device busy time, {prof['device_ops']:.0f} device ops per step; "
          f"device ms per step by family {prof['ms']}; largest glue "
          f"{prof['glue_top']}")
    # phase 28 goes on with this model and these tokens
    return counts, dict(step_ms=step_s * 1e3, tokens_s=tokens / step_s,
                        mfu=mfu, peak_gib=peak / 2 ** 30, losses=losses,
                        bound_taken=bound_taken, profile=prof,
                        adam=adam_row, state=(model, step,
                                              (toks, tgts, mask)))


def phase12_sort_task(dev, smi):
    """The sort task at examples/train_tinylm.py's defaults, f32: its
    kernels at the task's shapes, then 600 steps through the example's
    step function."""
    args = train_tinylm.parse_args(["--device", "cuda"])
    gen = torch.Generator().manual_seed(SEED)
    seq = 2 * args.length + 2
    t = args.batch * seq
    rows = gemm_rows(dev, ((t, args.dim, args.dim),
                           (t, args.dim, 4 * args.dim),
                           (t, 4 * args.dim, args.dim)),
                     torch.float32, 12, LINEAR_F32_TOL, gen)
    rows.update(lm_flash_rows(dev, args.batch, args.heads, seq,
                              args.dim // args.heads, torch.float32, 12,
                              gen, ("bhsd",), ("exact",)))
    model, opt = train_tinylm.build(args)
    step = train_tinylm.make_step(model, opt, args,
                                  torch.Generator(device=dev).manual_seed(1))
    eval_gen = torch.Generator(device=dev).manual_seed(2)
    totals, routes, accs = {}, {}, []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps // args.eval_every):
        backend.reset_launch_counts()
        for _ in range(args.eval_every):
            loss, _ = step()
        for k, c in backend.launch_counts().items():
            totals[k] = totals.get(k, 0) + c
        for k, c in flash_only(backend.route_counts()).items():
            routes[k] = routes.get(k, 0) + c
        accs.append(float(train_tinylm.evaluate(model, args, eval_gen)))
    wall = time.perf_counter() - t0
    print(f"phase 12: sort task (TinyGPT dim {args.dim}, depth "
          f"{args.depth}, {args.heads} heads, S {seq}, batch {args.batch}, "
          f"f32, Adam {train_tinylm.LR_DEFAULTS['adam']}) through the "
          f"example's step function: {args.steps} steps in {wall:.2f} s, "
          f"{wall / args.steps * 1e3:.2f} ms/step with the evaluations; "
          f"teacher-forced eval accuracy every {args.eval_every} steps "
          f"{accs} (gate {SORT_MIN_ACC} at the end); last loss "
          f"{float(loss):.4f}; launches per step "
          f"{per_step(totals, args.steps)}; flash calls per step by route "
          f"{per_step(routes, args.steps)}; on {smi}")
    assert per_step(totals, args.steps) == SORT_PER_STEP, totals
    assert per_step(routes, args.steps) == flash_routes(
        args.depth, torch.float32, "causal"), routes
    assert accs[-1] >= SORT_MIN_ACC, accs
    # short runs through the example's other optimizers and its dense MoE
    for extra, want in ((["--opt", "lion"], SORT_OPTS_PER_STEP),
                        (["--opt", "muon"], SORT_OPTS_PER_STEP),
                        (["--opt", "adafactor"], SORT_OPTS_PER_STEP),
                        (["--experts", "4"], SORT_MOE_PER_STEP)):
        args = train_tinylm.parse_args(["--device", "cuda", *extra])
        model, opt = train_tinylm.build(args)
        step = train_tinylm.make_step(
            model, opt, args, torch.Generator(device=dev).manual_seed(1))
        torch.cuda.synchronize()
        backend.reset_launch_counts()
        t0 = time.perf_counter()
        losses_ = torch.stack([step()[0] for _ in range(SORT_SHORT)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = backend.launch_counts()
        for k, c in counts.items():
            totals[k] += c
        first, last = (float(losses_[:20].mean()), float(losses_[-20:].mean()))
        print(f"phase 12: sort task through train_tinylm {' '.join(extra)} "
              f"(lr {train_tinylm.LR_DEFAULTS[args.opt]}): {SORT_SHORT} "
              f"steps in {wall:.2f} s, mean loss of the first 20 steps "
              f"{first:.4f}, of the last 20 {last:.4f}; launches per step "
              f"{per_step(counts, SORT_SHORT)}")
        assert torch.isfinite(losses_).all() and last < first, losses_
        assert per_step(counts, SORT_SHORT) == want, counts
    return totals, rows


# -- K2 and K17 at the paths' shapes ------------------------------------------

def ew_row(op, shape, dev, gen, phase=13):
    """K2 ``op`` at ``shape`` (f32) against its plain version, with the
    torch operator as the library call."""
    n = math.prod(shape)

    def make():
        xs = [torch.randn(*shape, generator=gen) * 3
              for _ in range(EW.ARITY[op])]
        if op == "div":
            xs[1] = torch.where(xs[1] < 0, -1.0, 1.0) * (0.5 + xs[1].abs())
        return tuple(x.to(dev) for x in xs)
    first = make()
    sets = [first] + [make() for _ in range(copies_for(*first) - 1)]
    library = {"relu": torch.relu, "sigmoid": torch.sigmoid,
               "add": torch.add, "mul": torch.mul, "sub": torch.sub,
               "div": torch.div,
               "fma": lambda a, b, c: torch.addcmul(c, a, b)}[op]
    return check_kernel(
        op, f"f32 {list(shape)}", lambda *a: EW.elementwise(op, *a),
        lambda *a: EW.elementwise_reference(op, *a), sets, phase=phase,
        tol=EW_TOL[op], library_fn=library,
        work=(n * (2 if op == "fma" else 1), 4 * n * (len(first) + 1),
              "f32"))


def opt_row(name, label, params, grads, hp, phase):
    """Fused updates (K17a ``adam`` or K17b ``sgd``) over the tensor lists
    ``params``/``grads`` (``None`` grads allowed) against the plain version
    from the same state, in p and the moments, after OPT_STEPS steps from
    random moments at step OPT_T0 (from zero moments at step 1, b1 m and
    b2 v vanish and a kernel that never read them would agree); then
    CUDA-event times of the kernel, the plain version and the nearest
    library call (``torch._fused_adam_``/``_fused_adamw_``, which move the
    same bytes but place eps differently, so compute another function;
    ``torch._fused_sgd_``, the same function), each on its own copy of the
    state."""
    adam = name == "adam"
    momentum = hp.get("momentum", 0.0)
    # moments at each tensor's gradient scale: m ~ s N(0, 1), v in
    # [0.5, 1.5] s^2, with s the gradient's RMS (1e-3 without a gradient)
    gen = torch.Generator(device=params[0].device).manual_seed(SEED + 17)
    scales = [1e-3 if g is None else max(float(g.float().square().mean()
                                               .sqrt()), 1e-12)
              for g in grads]
    m0 = ([torch.randn(p.shape, generator=gen, device=p.device) * s
           for p, s in zip(params, scales)] if adam or momentum else None)
    v0 = ([(torch.rand(p.shape, generator=gen, device=p.device) + 0.5)
           * s * s for p, s in zip(params, scales)] if adam else None)

    def state():
        p = [t.detach().clone() for t in params]
        g = [None if t is None else t.clone() for t in grads]
        m = None if m0 is None else [t.clone() for t in m0]
        v = None if v0 is None else [t.clone() for t in v0]
        return p, g, m, v

    lr = hp["lr"]
    if adam:
        def kw(t):
            return dict(lr=lr, step_size=lr * math.sqrt(1 - 0.999 ** t)
                        / (1 - 0.9 ** t), b1=0.9, b2=0.999, eps=1e-8,
                        wd=hp["wd"], decoupled=hp["decoupled"])
        kernel = lambda p, g, m, v, t=OPT_T0: OK.adam_update(p, g, m, v,
                                                             **kw(t))
        plain = lambda p, g, m, v, t=OPT_T0: OK.adam_reference(p, g, m, v,
                                                               **kw(t))
    else:
        kw = dict(lr=lr, momentum=momentum, wd=hp["wd"])
        kernel = lambda p, g, m, v, t=0: OK.sgd_update(p, g, m, **kw)
        plain = lambda p, g, m, v, t=0: OK.sgd_reference(p, g, m, **kw)
    a, b = state(), state()
    for t in range(OPT_T0, OPT_T0 + OPT_STEPS):
        kernel(*a, t=t)
        plain(*b, t=t)
    torch.cuda.synchronize()
    errs = [within(x, y, OPT_TOL) for xs, ys in zip(a, b)
            if xs is not None and xs is not a[1]
            for x, y in zip(xs, ys)]
    err, ok = max(e for e, _, _ in errs), all(g for _, _, g in errs)
    stat = max(st for _, st, _ in errs)
    ms, plain_ms = cuda_ms(kernel, [a], iters=20), cuda_ms(plain, [b],
                                                          iters=20)
    c = state()
    p, g, m, v = c
    g = [torch.zeros_like(t) if gr is None else gr for t, gr in zip(p, g)]
    if adam:
        fused = torch._fused_adamw_ if hp["decoupled"] else \
            torch._fused_adam_
        steps = [torch.full((), float(OPT_T0), device=t.device) for t in p]
        lib = lambda: fused(p, g, m, v, [], steps, lr=lr, beta1=0.9,
                            beta2=0.999, weight_decay=hp["wd"], eps=1e-8,
                            amsgrad=False, maximize=False)
    else:
        lib = lambda: torch._fused_sgd_(
            p, g, m if momentum else [], weight_decay=hp["wd"],
            momentum=momentum, lr=lr, dampening=0.0, nesterov=False,
            maximize=False, is_first_step=False)
    lib_ms = cuda_ms(lambda: lib(), [()], iters=20)
    n = sum(t.numel() for t in params)
    nulls = sum(t is None for t in grads)
    streams = (7 if adam else (5 if momentum else 3))
    nbytes_ = 4 * (streams * n - sum(t.numel() for t, gr in
                                     zip(params, grads) if gr is None))
    row = dict(at=label, max_abs_err=err, ms=ms, plain_ms=plain_ms,
               library_ms=lib_ms,
               **bound((15 if adam else 4) * n, nbytes_, "f32"))
    print(f"phase {phase}: {name} {label} ({len(params)} tensors, {n:,} "
          f"elements, {nulls} None grads; {OPT_STEPS} steps from random "
          f"moments at step {OPT_T0}): max_abs_err {err:.3e} (each "
          f"{stat:.3e} <= {OPT_TOL:.0e}) kernel {ms:.4f} ms plain "
          f"{plain_ms:.4f} ms library {lib_ms:.4f} ms"
          f"{' (nearest: another eps placement)' if adam else ''} bound "
          f"{row['bound_ms']:.4f} ms "
          f"({row['bound_by']}), {OK.TABLE} tensors per launch")
    assert ok, f"{name} {label} disagrees with its plain version"
    return row


def phase13_new_kernels(dev):
    """K2 at ResNet-8's activation shapes (relu) and once per other op,
    and K17b over the XOR model's and ResNet-8's parameter lists (the
    170M and ResNet-8 Adam rows are taken in phases 11 and 14, on their
    own gradients)."""
    gen = torch.Generator().manual_seed(SEED)
    rows = {"relu": [ew_row("relu", s, dev, gen)
                     for s in ((256, 16, 32, 32), (256, 32, 16, 16),
                               (256, 64, 8, 8))]}
    for op in ("sigmoid", "add", "mul", "fma", "sub", "div"):
        rows[op] = [ew_row(op, (256, 16, 32, 32), dev, gen)]
    sgd = []
    for model, label, hp in (
            (xor_mlp(), "XOR 2-4-1, SGD(0.1)",
             dict(lr=0.1, wd=0.0)),
            (resnet8(), "ResNet-8 params, SGD(0.1, momentum 0.9, wd 5e-4)",
             dict(lr=0.1, momentum=0.9, wd=5e-4))):
        ps = [p.detach().to(dev) for p in model.parameters()]
        gs = [torch.randn(p.shape, generator=gen).to(dev) for p in ps]
        sgd.append(opt_row("sgd", label, ps, gs, hp, 13))
    rows["sgd"] = sgd
    return {k: headline(r) for k, r in rows.items()}


# -- the ResNet-8 path --------------------------------------------------------

def resnet_trainer(dev, epochs=RESNET["epochs"]):
    args = train_cifar10_resnet.parse_args(
        ["--device", str(dev), "--epochs", str(epochs), "--batch-size",
         str(RESNET["batch"]), "--lr", str(RESNET["lr"])])
    return train_cifar10_resnet.build(args, seed=SEED)


def _resnet_step(dev, x, y, forced=None):
    """One Trainer step of ResNet-8 from the seeded init; returns the loss,
    the gradients, the new running statistics and every module's output
    (on the CPU).  ``forced`` (another run's outputs) overwrites each
    module's output as it is computed: with every convolution, BatchNorm,
    block and pool output shared, each ReLU (K2 inside the blocks, on a
    BatchNorm output or on a sum of shared values) makes the other run's
    decisions."""
    tr = resnet_trainer(dev)
    outs, hooks = {}, []

    def keep(name):
        def hook(module, inputs, out):
            if forced is not None:
                out.data.copy_(forced[name])
            outs[name] = out.detach().cpu()
        return hook
    for name, mod in tr.model.named_modules():
        if name:
            hooks.append(mod.register_forward_hook(keep(name)))
    loss, _ = tr.train_step(torch.as_tensor(x, device=dev),
                            torch.as_tensor(y, device=dev).long())
    for h in hooks:
        h.remove()
    grads = {k: p.grad.detach().cpu()
             for k, p in tr.model.named_parameters()}
    stats = {k: b.detach().cpu() for k, b in tr.model.named_buffers()}
    return float(loss), grads, stats, outs, tr


def phase14_resnet(dev, smi):
    """ResNet-8 on CIFAR-10 (synthetic v2), the example's run cut to
    RESNET["epochs"]: one step card vs CPU, the AdamW K17 row on that
    step's gradients, then fit_device with exact launch counts."""
    t0 = time.perf_counter()
    train, test = CIFAR10Dataset(train=True), CIFAR10Dataset(train=False)
    assert train.source == test.source == "synthetic"
    print(f"phase 14: rendered {len(train)}/{len(test)} synthetic CIFAR-10 "
          f"images in {time.perf_counter() - t0:.1f} s")
    x, y = train.images[:RESNET["batch"]], train.labels[:RESNET["batch"]]
    loss_card, g_card, s_card, out_card, tr = _resnet_step(dev, x, y)
    loss_cpu, g_cpu, s_cpu, out_cpu, _ = _resnet_step("cpu", x, y)
    _, g_sh, s_sh, _, _ = _resnet_step("cpu", x, y, forced=out_card)
    loss_rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
    rel = {k: rel_l2(g_card[k], g_sh[k]) for k in g_cpu}
    rel_ind = {k: rel_l2(g_card[k], g_cpu[k]) for k in g_cpu}
    stat = {k: within(s_card[k], s_sh[k], STEP_LOSS_TOL, "max")[1]
            for k in s_cpu}
    stat_ind = {k: within(s_card[k], s_cpu[k], STEP_LOSS_TOL, "max")[1]
                for k in s_cpu}
    worst, worst_ind = max(rel, key=rel.get), max(rel_ind, key=rel_ind.get)
    ws = max(stat, key=stat.get)
    print(f"phase 14: one ResNet-8 step (batch {RESNET['batch']}, AdamW), "
          f"card vs cpu: loss {loss_card:.6f} vs {loss_cpu:.6f}, rel err "
          f"{loss_rel:.3e} (tol {STEP_LOSS_TOL:.0e}); grads vs the cpu "
          f"backward on the card's forward values: rel L2 max "
          f"{rel[worst]:.3e} at {worst} (tol {STEP_GRAD_TOL:.0e}) over "
          f"{len(rel)} parameters; new running statistics: max err / max "
          f"|ref| {stat[ws]:.3e} at {ws} (tol {STEP_LOSS_TOL:.0e}) over "
          f"{len(stat)} buffers; independent cpu run: grads rel L2 max "
          f"{rel_ind[worst_ind]:.3e} at {worst_ind} (tol "
          f"{STEP_GRAD_IND_TOL:.0e}), statistics {max(stat_ind.values()):.3e}")
    assert loss_rel <= STEP_LOSS_TOL, "ResNet step loss disagrees"
    assert all(torch.isfinite(g).all() for g in g_card.values())
    assert rel[worst] <= STEP_GRAD_TOL, f"{worst} grad disagrees"
    assert rel_ind[worst_ind] <= STEP_GRAD_IND_TOL, worst_ind
    assert stat[ws] <= STEP_LOSS_TOL, f"{ws} running statistic disagrees"
    params = list(tr.model.parameters())
    adam_row = opt_row("adam", "ResNet-8 AdamW(3e-3, wd 5e-4)", params,
                       [p.grad for p in params],
                       dict(lr=RESNET["lr"], wd=RESNET["weight_decay"],
                            decoupled=True), 14)
    del tr
    # K1 at the patch-GEMM and head shapes: the forward, dX and dW (split
    # over K: a few output tiles over 16,384 or 65,536 rows)
    k1_rows = gemm_rows(dev, RESNET_GEMMS, torch.float32, 14,
                        LINEAR_F32_TOL, torch.Generator().manual_seed(SEED))
    torch.cuda.empty_cache()

    trainer = resnet_trainer(dev)
    steps = len(train) // RESNET["batch"]
    torch.cuda.synchronize()
    backend.reset_launch_counts()
    t0 = time.perf_counter()
    m = trainer.fit_device(train.images, train.labels, test.images,
                           test.labels, RESNET["epochs"],
                           batch_size=RESNET["batch"], early_stop_acc=0.93,
                           verbose=False,
                           eval_batch_size=RESNET["eval_batch"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fit_counts = backend.launch_counts()
    ev = trainer.evaluate(test.images, test.labels,
                          batch_size=RESNET["eval_batch"])
    torch.cuda.synchronize()
    counts = backend.launch_counts()
    epochs = len(m.epoch_times)
    per_step, per_eval = split_counts(fit_counts, counts, steps, epochs)
    epoch_s = sum(m.epoch_times) / epochs
    print(f"phase 14: trained ResNet-8 {epochs} epochs x {steps} steps "
          f"(batch {RESNET['batch']}, AdamW({RESNET['lr']}, wd "
          f"{RESNET['weight_decay']}), cosine to {RESNET['lr'] * 0.01:g}, "
          f"synthetic {len(train)}/{len(test)}) in {wall:.2f} s: epoch "
          f"times {m.epoch_times} s, {epoch_s:.3f} s/epoch, "
          f"{steps * RESNET['batch'] / epoch_s:.1f} samples/s; train loss "
          f"{m.train_loss}, val acc {m.val_acc}; final evaluation acc "
          f"{ev['acc']:.4f} (gate {RESNET_MIN_ACC:.4f}: the JAX example "
          f"reached {RESNET_JAX_ACC} after 3 epochs, less 0.05); launches "
          f"per training step {per_step}, per evaluation pass of "
          f"{len(test)} images {per_eval}; on {smi}")
    assert all(math.isfinite(v) for v in m.train_loss + m.val_loss)
    assert per_step == RESNET_PER_STEP, per_step
    assert ev["acc"] >= RESNET_MIN_ACC, ev
    xd = torch.as_tensor(x, device=dev)
    yd = torch.as_tensor(y, device=dev).long()
    backend.reset_launch_counts()
    trainer.train_step(xd, yd)
    torch.cuda.synchronize()
    routes, want = backend.route_counts(), planned_routes(RESNET_GEMMS,
                                                          torch.float32)
    print(f"phase 14: K1 calls of one ResNet-8 step by route {routes} "
          f"(plan: {want})")
    assert routes == want, (routes, want)
    prof = profile_steps(lambda: trainer.train_step(xd, yd), 3,
                         CONV_FAMILIES)
    print(f"phase 14: profiled 3 ResNet-8 steps: {prof['wall_ms']:.2f} ms "
          f"of wall per step (under the profiler) for {prof['busy_ms']:.2f} "
          f"ms of device busy time, {prof['device_ops']:.0f} device ops per "
          f"step; device ms per step by family {prof['ms']}; largest glue "
          f"{prof['glue_top']}")
    return fit_counts, dict(adam=adam_row, **{
        k: headline(r) for k, r in k1_rows.items()})


# -- the reference's examples -------------------------------------------------

def phase15_examples(dev, smi):
    """XOR and the MNIST MLP through their examples' entry points."""
    torch.cuda.synchronize()
    backend.reset_launch_counts()
    t0 = time.perf_counter()
    solved = train_xor.main(["--device", "cuda", "--steps",
                             str(XOR_STEPS)])
    torch.cuda.synchronize()
    xor_s = time.perf_counter() - t0
    xor_counts = backend.launch_counts()
    # every step's launches, and the forward of the final predictions
    want = {k: v * XOR_STEPS + (2 if k == "linear" else 0)
            for k, v in XOR_PER_STEP.items()}
    got = {k: c for k, c in xor_counts.items() if c}
    print(f"phase 15: XOR ({XOR_STEPS} SGD steps through "
          f"examples/train_xor.py) in {xor_s:.2f} s, "
          f"{xor_s / XOR_STEPS * 1e3:.4f} ms/step: solved {solved}; "
          f"launches per step {per_step(xor_counts, XOR_STEPS)}; on {smi}")
    assert solved, "XOR not solved"
    assert got == want, got

    backend.reset_launch_counts()
    t0 = time.perf_counter()
    ckpt_dir = tempfile.TemporaryDirectory()
    trainer = train_mnist.main(["--device", "cuda", "--checkpoint",
                                os.path.join(ckpt_dir.name, "mlp.npz")])
    torch.cuda.synchronize()
    mlp_s = time.perf_counter() - t0
    first_epoch_acc = trainer.metrics.val_acc[0]
    fit_counts = backend.launch_counts()
    test = MNISTDataset(train=False)
    trainer.evaluate(test.images, test.labels, batch_size=2000)
    torch.cuda.synchronize()
    m = trainer.metrics
    epochs = len(m.epoch_times)
    steps = 60000 // 256
    mlp_step, _ = split_counts(fit_counts, backend.launch_counts(), steps,
                               epochs)
    print(f"phase 15: MNIST MLP through examples/train_mnist.py "
          f"(fit_device, Adam 1e-3 wd 1e-4, batch 256): {epochs} epochs in "
          f"{mlp_s:.2f} s with the data, epoch times {m.epoch_times} s, val "
          f"acc {m.val_acc} (early stop above {MLP_MIN_ACC} within "
          f"{MLP_MAX_EPOCHS} epochs); launches per step {mlp_step}")
    assert m.val_acc[-1] > MLP_MIN_ACC and epochs <= MLP_MAX_EPOCHS, m
    assert mlp_step == MLP_PER_STEP, mlp_step

    backend.reset_launch_counts()
    t0 = time.perf_counter()
    trainer = train_mnist.main(["--device", "cuda", "--loader", "--epochs",
                                "1", "--checkpoint",
                                os.path.join(ckpt_dir.name, "mlp1.npz")])
    ckpt_dir.cleanup()
    torch.cuda.synchronize()
    loader_counts = backend.launch_counts()
    m = trainer.metrics
    print(f"phase 15: MNIST MLP, one epoch through Trainer.fit over "
          f"PrefetchLoader(DataLoader) in {time.perf_counter() - t0:.2f} s "
          f"with the data: epoch {m.epoch_times[0]:.3f} s, train loss "
          f"{m.train_loss[0]:.4f}, val acc {m.val_acc[0]:.4f} (fit_device's "
          f"first epoch: {first_epoch_acc:.4f}; gate: within 0.05, another "
          f"batch order); launches {per_step(loader_counts, steps)} per step")
    assert loader_counts["adam"] == steps, loader_counts
    assert abs(m.val_acc[0] - first_epoch_acc) <= 0.05, m

    # the MLP at bench.py:48-80's settings: 10 epochs, no early stop
    train, test = MNISTDataset(train=True), MNISTDataset(train=False)
    trainer = Trainer(mnist_mlp(), optim.Adam(1e-3, weight_decay=1e-4),
                      seed=SEED, device=dev)
    torch.cuda.synchronize()
    backend.reset_launch_counts()
    t0 = time.perf_counter()
    m = trainer.fit_device(train.images, train.labels, test.images,
                           test.labels, MLP_BENCH["epochs"], batch_size=256,
                           early_stop_acc=2.0, verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    bench_counts = backend.launch_counts()
    trainer.evaluate(test.images, test.labels, batch_size=2000)
    torch.cuda.synchronize()
    bench_step, _ = split_counts(bench_counts, backend.launch_counts(),
                                 steps, MLP_BENCH["epochs"])
    gate = MLP_BENCH["acc"] - MLP_BENCH["allowance"]
    print(f"phase 15: MNIST MLP at bench.py:48-80's settings (fit_device, "
          f"{MLP_BENCH['epochs']} epochs, Adam 1e-3 wd 1e-4, batch 256, "
          f"early_stop_acc=2.0) in {wall:.2f} s: val acc per epoch "
          f"{m.val_acc}; final {m.val_acc[-1]:.4f} (gate {gate:.4f}: "
          f"BENCH_r05's {MLP_BENCH['acc']} less the batch-order allowance "
          f"{MLP_BENCH['allowance']}); launches per step {bench_step}")
    assert len(m.val_acc) == MLP_BENCH["epochs"], m
    assert m.val_acc[-1] >= gate, m.val_acc
    assert bench_step == MLP_PER_STEP, bench_step
    return {k: xor_counts[k] + fit_counts[k] + loader_counts[k]
            + bench_counts[k] for k in backend.KERNELS}


# -- PTQ-quantized serving, W8A8 prefill and the PTQ example ------------------

# The quantized serving model of benchmarks/bench_serving.py:39-52: vocab
# 4096, dim 2048, depth 6, 16 heads of 128, 4 KV heads, RoPE, max_seq
# 256, f32, ~273M parameters from SEED; PTQ int8 and int4 per tensor,
# asymmetric, with tok and pos kept f32 as the bench keeps them.  The
# engine serves 8 requests of 8-token prompts and 200 greedy new tokens
# in paged mode (the contiguous engine runs in phase 21).
QSERVE = dict(vocab_size=4096, dim=2048, depth=6, num_heads=16,
              num_kv_heads=4, max_seq=256, rope=True)
QSERVE_ENGINE = dict(slots=8, prompt_pad=8, decode_block=16,
                     block_size=128)
QSERVE_REQUESTS, QSERVE_PROMPT, QSERVE_NEW = 8, 8, 200
# K12/K13 launches per decode step: 6 blocks x wq, wk, wv, wo, w1, w2
QSERVE_PER_STEP = 36
# The W8A8 prefill of bench.py:273-301: vocab 4096, dim 2048, depth 4, 16
# heads, max_seq 1024, bf16 trunk, every 2-D leaf int8
# (QuantizationConfig(qtype=INT8)), a forward of 4 x 1024 tokens.
W8A8 = dict(vocab_size=4096, dim=2048, depth=4, num_heads=16, max_seq=1024,
            rope=True)
W8A8_BATCH, W8A8_ITERS = 4, 5
# Tolerances (the kernels' in TOL):
#  * K12/K13 against their plain versions: 2e-4 (1 + |ref|), as the bf16
#    GEMM: both round the activations to bf16 and the int8/int4 codes are
#    exact in bf16, so every product is exact in f32 and only the
#    summation order differs (up to 8,192 terms).
#  * K14 (codes, scales, sums), K15b (int32) and K15a (the same integer
#    product, then the same f32 operations in the same order, no FMA
#    contraction): exact.
#  * quantized serving, card against the port's CPU path with the same
#    int8/int4 weights, both f32: relative L2 of the logits 1e-2.  The
#    kernels round the activations to bf16 on both sides; where the card's
#    f32 activation differs from the CPU's in the last bit (other
#    summation orders) the rounding of that element flips by 2^-8, at
#    dim 2048 for tens of elements a step, and the final LayerNorm of a
#    residual stream at init scale (std 0.02) amplifies each block's
#    output about 50-fold.
#  * W8A8 logits against the same int8 weights through K12, both bf16
#    trunks: relative L2 5e-2.  The difference is the activation rounding:
#    int8 per row (absmax / 127, up to 0.4% of the row's largest entry an
#    element) against bf16 (2^-9 relative), through 4 blocks.
#  * the PTQ example: int8 accuracy within 0.01 of f32, float16 within
#    0.001 (the JAX example's own table reports the drops; the reference's
#    PTQ goal is an int8 drop under 1%, BASELINE.md).
#  * phase 18's int4 logits, card against the port's CPU path with the
#    same int4 weights, both bf16 trunks, one batch row: relative L2 3e-2,
#    MODEL_REL_TOL as phase 4's bf16 logits.  The card's K8 rounds the
#    softmax weights to bf16 where the CPU's plain attention rounds its
#    output, a last-bit difference of an activation flips its bf16
#    rounding before the next K13 product, and the final LayerNorm at
#    init scale amplifies what four blocks carry about 50-fold.
QSERVE_REL_TOL, W8A8_REL_TOL = 1e-2, 5e-2
Q4_PREFILL_REL_TOL = MODEL_REL_TOL
PTQ_INT8_DROP, PTQ_F16_DROP = 0.01, 0.001
QUANT_FAMILIES = (("K12/K13 linear_q", "linear_q_mma_kernel"),
                  ("K12 linear_q8 wgmma", "q_wgmma_kernel<8>"),
                  ("K13 linear_q4 wgmma", "q_wgmma_kernel<4>"),
                  ("K12/K13 wgmma row pass", "qlinear::rows_kernel"),
                  ("K16 paged decode", "paged_decode")) + K1_FAMILIES + (
                  ("head sgemm", "gemm"),
                  ("K14 quantize_rows", "quantize_rows"),
                  ("K15 int8 product", "i8_wgmma"),
                  ("K15 int8 product", "matmul_int8"))
W8A8_FAMILIES = QUANT_FAMILIES + (("K8 flash fwd", "sm90::fwd_kernel"),)


def qweight(gen, n, k, bits, dev):
    """PTQ codes (per tensor, asymmetric, QuantizationConfig.int8/int4) of
    a random weight at init scale, on ``dev``."""
    cfg = (QuantizationConfig.int8() if bits == 8
           else QuantizationConfig.int4())
    return quantize(torch.randn(n, k, generator=gen) * 0.02, cfg).to(dev)


def qlinear_work(m, n, k, bits):
    """K12/K13: x f32 read once, the codes once, scale/zp/bias, y f32;
    the products at the bf16 tensor-core rate."""
    return (2 * m * n * k, 4 * m * k + n * k * bits // 8 + 12 * n
            + 4 * m * n, "bf16")


def per_tensor_uncopied(name, kern, args):
    """One call of K12/K13 with PTQ's per-tensor scale and zero point
    (0-d tensors on the card) allocates its output, and on the wgmma
    route the row pass's workspace, and nothing else: no [N] copy of the
    scale or the zero point, which a copy kernel would fill (the
    allocator's count of requests, before and after)."""
    assert args[2].dim() == 0 and args[3].dim() == 0, name
    torch.cuda.synchronize()
    before = backend.route_counts()
    count = torch.cuda.memory_stats()["allocation.all.allocated"]
    kern(*args)
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"] - count
    torch.cuda.synchronize()
    route = next(k for k, c in backend.route_counts().items()
                 if c != before.get(k, 0)).split()[0]
    want = 2 if route == "wgmma" else 1
    print(f"phase 16: {name} via {route} with a per-tensor scale and zero "
          f"point: {allocs} allocation(s) a call (the output"
          f"{' and the row pass' if want == 2 else ''}; no copies)")
    assert allocs == want, (name, route, allocs)


def phase16_quant_kernels(dev):
    """K12, K13, K14, K15a/b against their plain versions at the shapes of
    phases 17-19, each K12/K13 row on the route ``ops.quant.plan_q`` names
    (``decode`` at decode's M, ``wgmma`` at M 4,096 and at the FC layers'
    M of 2,000 with N 128 and 64, ``mma`` for the 10-way head, ragged K
    and codes off the grid) and K15a/b on their ``mma`` route, with the
    bound and the library call where one exists."""
    gen = torch.Generator().manual_seed(SEED)
    rows = {}

    def add(name, *args, **kw):
        rows.setdefault(name, []).append(check_kernel(
            name, *args, phase=16, **kw))

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen).to(dtype).to(dev)

    dq_note = []
    # K12 / K13 at the decode shapes of phase 17 (M = 8 rows: wq/wo, wk/wv,
    # w1, w2), K12 and K13 at the W8A8 prefill's M = 4096 (phase 18's K12
    # and K13 forwards) and K12 at the CNN's FC layers at an eval batch of
    # 2000 (phase 19: the 10-way head on the mma route)
    d = QSERVE["dim"]
    kv = d // QSERVE["num_heads"] * QSERVE["num_kv_heads"]
    decode = ((d, d), (kv, d), (4 * d, d), (d, 4 * d))
    pm, pd = W8A8_BATCH * W8A8["max_seq"], W8A8["dim"]
    prefill = ((pd, pd), (4 * pd, pd), (pd, 4 * pd))
    # each with the route plan_q must give it and, for the rows beside the
    # paths' headlines, the label they carry in the kernels line: K12 and
    # K13 at decode's M with ragged K (int8 rows not whole 16-byte units,
    # int4 rows not whole 32 codes), K13 at the FC layer's M > 16, and at
    # the prefill's M codes 1 byte off the 16-byte grid and a ragged K of
    # 2,050 (on no path)
    cases = ([(QSERVE_REQUESTS, n, k, bits, "decode", 0, None)
              for bits in (8, 4) for n, k in decode]
             + [(pm, n, k, bits, "wgmma", 0, None)
                for bits in (8, 4) for n, k in prefill]
             + [(2000, n, k, 8, "mma" if n == 10 else "wgmma", 0,
                 "mma 10-way head" if n == 10 else None)
                for n, k in ((128, 128), (64, 128), (10, 64))]
             + [(QSERVE_REQUESTS, d, d + 8, 8, "mma", 0, "mma ragged K"),
                (QSERVE_REQUESTS, d, d + 16, 4, "mma", 0, "mma ragged K"),
                (2000, 128, 128, 4, "wgmma", 0, "wgmma M > 16")]
             + [(pm, pd, pd, bits, "mma", 1, "mma q 1 byte off M > 16")
                for bits in (8, 4)]
             + [(pm, pd, pd + 2, bits, "mma", 0, "mma K 2050 M > 16")
                for bits in (8, 4)])
    for m, n, k, bits, want, off, label in cases:
        name = f"linear_q{bits}"
        act = "relu" if m == 2000 and n != 10 else "none"

        def make(m=m, n=n, k=k, bits=bits, off=off):
            w = qweight(gen, n, k, bits, dev)
            q = misaligned(w.values, off) if off else w.values
            return (randn(m, k), q, w.scale, w.zero_point, randn(n) * 0.1)
        first = make()
        sets = [first] + [make() for _ in range(copies_for(*first) - 1)]
        if bits == 8:
            kern = (lambda x, q, s, z, b, act=act:
                    Q.linear_q8(x, q, s, z, b, epilogue=act))
            plain = (lambda x, q, s, z, b, act=act:
                     Q.linear_q8_reference(x, q, s, z, b, act))
        else:
            kern = (lambda x, q, s, z, b, k=k, act=act:
                    Q.linear_q4(x, q, s, z, b, n_features=k, epilogue=act))
            plain = (lambda x, q, s, z, b, k=k, act=act:
                     Q.linear_q4_reference(x, q, s, z, b, n_features=k,
                                           epilogue=act))
        at = f"M={m} N={n} K={k} {act} (+bias)" + (
            f" q {off} byte off" if off else "")
        add(name, at, kern, plain, sets, work=qlinear_work(m, n, k, bits))
        assert rows[name][-1]["q8_route"] == want, (name, m, n, k, want)
        if label:
            rows[name][-1]["label"] = label
        if (m, n, k, off) in ((QSERVE_REQUESTS, 4 * d, d, 0),
                              (2000, 10, 64, 0), (pm, pd, pd, 0)):
            per_tensor_uncopied(name, kern, first)
        if m == QSERVE_REQUESTS and (n, k) == decode[2]:
            # information, not a yardstick: dequantize + F.linear
            qt = quantize(torch.randn(n, k, generator=gen) * 0.02,
                          QuantizationConfig.int8() if bits == 8
                          else QuantizationConfig.int4()).to(dev)
            x, b = randn(m, k), randn(n) * 0.1
            dq_note.append((bits, cuda_ms(
                lambda x, b: F.linear(x, qt.dequantize(), b), [(x, b)])))
    for bits, ms in dq_note:
        print(f"phase 16: dequantize + F.linear, int{bits} M="
              f"{QSERVE_REQUESTS} N={decode[2][0]} K={decode[2][1]} "
              f"(information, not a library call for the same function): "
              f"{ms:.4f} ms")

    # K14 at the W8A8 prefill's activations (bf16): the inputs of the
    # K = dim projections and of w2 (K = 4 dim)
    for k in (pd, 4 * pd):
        x = randn(pm, k, dtype=torch.bfloat16)
        got, want = Q.quantize_rows(x), Q.quantize_rows_reference(x)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), \
            "K14 is not exact"
        add("quantize_rows", f"bf16 M={pm} K={k}", Q.quantize_rows,
            Q.quantize_rows_reference, cold_sets(x),
            work=(4 * pm * k, pm * k * 3 + 8 * pm, "f32"))

    # K15b and K15a at the W8A8 prefill's shapes, and K15a at decode's M
    # beside K12 (ROADMAP Queue 3 records W8A8's engage rule); then both on
    # the mma route, which no path takes: K 2,050 (rows not whole 16-byte
    # units) and codes xq 1 byte off their allocation's 16-byte grid (every
    # copy a view of its own)
    for m, n, k, off in ([(pm, n, k, 0) for n, k in prefill]
                         + [(QSERVE_REQUESTS, pd, pd, 0), (pm, pd, pd + 2, 0),
                            (pm, pd, pd, 1)]):
        xq = torch.randint(-127, 128, (m, k), generator=gen,
                           dtype=torch.int8).to(dev)
        q = torch.randint(-128, 128, (n, k), generator=gen,
                          dtype=torch.int8).to(dev)
        at = f"M={m} N={n} K={k}" + (f" xq {off} byte off" if off else "")

        def sets(*args):
            """Cold copies, xq ``off`` bytes off the grid in each."""
            got = cold_sets(*args)
            return [(misaligned(a[0], off),) + a[1:] for a in got] if off \
                else got
        if off:
            xq = misaligned(xq, off)
        if m > 16:
            assert torch.equal(Q.matmul_int8(xq, q),
                               Q.matmul_int8_reference(xq, q)), \
                "K15b is not exact"
            add("matmul_int8", at, Q.matmul_int8,
                Q.matmul_int8_reference, sets(xq, q),
                # [K, N] in column-major: cuBLASLt's int8 layout; _int_mm
                # refuses K % 8 != 0, and is not timed on the view
                library_fn=(None if k % 8 or off else
                            lambda xq, q: torch._int_mm(xq, q.t())),
                work=(2 * m * n * k, m * k + n * k + 4 * m * n, "int8"))
        sx = torch.rand(m, generator=gen).to(dev) * 0.01
        corr = xq.float().sum(1)
        sw = torch.rand(n, generator=gen).to(dev) * 1e-3
        zw = torch.randint(-5, 5, (n,), generator=gen).float().to(dev)
        bias = randn(n) * 0.1
        args = (xq, q, sx, corr, sw, zw, bias)

        def k15a(*a):
            return Q.matmul_int8_scaled(*a, out_dtype=torch.bfloat16)

        def k15a_plain(*a):
            return Q.matmul_int8_scaled_reference(
                *a, out_dtype=torch.bfloat16)
        assert torch.equal(k15a(*args), k15a_plain(*args)), \
            "K15a is not exact"
        add("matmul_int8_scaled", f"{at} bf16 (+bias)", k15a,
            k15a_plain, sets(*args),
            work=(2 * m * n * k, m * k + n * k + 8 * m + 12 * n
                  + 2 * m * n, "int8"))
    for name in I8_NAMES:
        got = [r["i8_route"] for r in rows[name]]
        assert got.count("mma") == 2 and "wgmma" in got, (name, got)
    return rows


def restore_f32(qmodel, model, names):
    """Put the f32 parameters ``names`` of ``model`` back into its PTQ
    copy, as the bench keeps tok and pos f32."""
    for name in names:
        owner, _, attr = name.rpartition(".")
        replace_leaf(qmodel.get_submodule(owner), attr, torch.nn.Parameter(
            model.get_parameter(name).detach().clone()))
    return qmodel


def qserve_logits(model, dev, prompt):
    """One padded prefill row and one paged decode step of ``model`` on
    ``dev``: ``(prefill logits at the prompt, decode logits)`` on the
    CPU."""
    bs = QSERVE_ENGINE["block_size"]
    table = torch.arange(1, QSERVE["max_seq"] // bs + 1,
                         dtype=torch.int32)[None]
    with torch.no_grad():
        pools = model.init_paged_cache(QSERVE["max_seq"] // bs + 1, bs,
                                       device=dev)
        pre = model.prefill_paged(torch.tensor([prompt]).to(dev), pools,
                                  table.to(dev))
        step = model.decode_step_paged(
            torch.tensor([int(pre[0, -1].argmax())]).to(dev),
            torch.tensor([len(prompt)], dtype=torch.int32).to(dev), pools,
            table.to(dev))
    return pre[0].float().cpu(), step.float().cpu()


def qserve_run(model, prompts):
    """Serve ``prompts`` (QSERVE_NEW greedy tokens each) on the card: wall
    seconds, tokens, launch counts, engine stats and calls by route."""
    per = -(-(QSERVE_PROMPT + QSERVE_NEW) // QSERVE_ENGINE["block_size"])
    eng = ServingEngine(model, pool_blocks=QSERVE_ENGINE["slots"] * per + 1,
                        seed=SEED, **QSERVE_ENGINE)
    ids = [eng.submit(p, QSERVE_NEW) for p in prompts]
    torch.cuda.synchronize()
    backend.reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, routes = backend.launch_counts(), backend.route_counts()
    for rid in ids:
        assert len(out[rid]) == QSERVE_NEW, (rid, len(out[rid]))
        assert all(0 <= t < QSERVE["vocab_size"] for t in out[rid]), rid
    return (wall, sum(len(out[i]) for i in ids), counts, eng.stats(),
            routes)


def phase17_quant_serve(dev, smi):
    """PTQ int8 and int4 serving of the bench_serving model on the card:
    logits against the port's CPU path with the same weights, the exact
    K12/K13 launches per decode step, every request served, and
    generated tokens/s beside f32."""
    print("phase 17: the quantized model serves through the paged engine "
          "(the contiguous engine runs in phase 21)")
    model = TinyGPT(**QSERVE)
    model.reset_parameters(torch.Generator().manual_seed(SEED))
    model.eval()
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, QSERVE["vocab_size"],
                            QSERVE_PROMPT).tolist()
               for _ in range(QSERVE_REQUESTS)]
    variants = {"f32": model}
    for name, cfg in (("int8", QuantizationConfig.int8()),
                      ("int4", QuantizationConfig.int4())):
        variants[name] = restore_f32(quantize_params(model, cfg), model,
                                     ("tok.w", "pos.w"))
    out = {"params": n_params}
    for name, qm in variants.items():
        nbytes = quantized_bytes(qm)
        if name != "f32":
            ref = qserve_logits(qm, "cpu", prompts[0])
        variants[name] = card = qm.to(dev)
        if name != "f32":
            got = qserve_logits(card, dev, prompts[0])
            for what, o, r in zip(("prefill", "decode step"), got, ref):
                assert o.shape == r.shape and torch.isfinite(o).all()
                rel = rel_l2(o, r)
                print(f"phase 17: {name} {what} logits {tuple(o.shape)}, "
                      f"card vs the port's CPU path: rel L2 {rel:.3e} (tol "
                      f"{QSERVE_REL_TOL:.0e}), max abs err "
                      f"{float((o - r).abs().max()):.3e}")
                assert rel <= QSERVE_REL_TOL, f"{name} {what} logits"
        wall, toks, counts, st, routes = qserve_run(card, prompts)
        steps = st["decode_blocks"] * QSERVE_ENGINE["decode_block"]
        kern = {"int8": "linear_q8", "int4": "linear_q4"}.get(name)
        line = (f"phase 17: {name} served {QSERVE_REQUESTS} requests "
                f"({st['completed']} completed, {steps} decode steps) in "
                f"{wall:.2f} s: {toks / wall:.1f} generated tokens/s; "
                f"weights {nbytes / 2 ** 20:.1f} MiB")
        if kern is not None:
            per_step = (counts[kern] - QSERVE_PER_STEP * st["admitted"]) \
                / steps
            line += f"; {kern} launches per decode step {per_step:g}"
            assert per_step == QSERVE_PER_STEP, counts
            assert counts["linear"] == 0, counts
            # every call on the decode route: the decode steps' 8 rows and
            # the prefills' 8 padded tokens alike
            mine = {k: c for k, c in routes.items() if k.endswith(kern)}
            assert mine == {f"decode {kern}": counts[kern]}, routes
            on_route = (mine[f"decode {kern}"]
                        - QSERVE_PER_STEP * st["admitted"]) / steps
            line += f", {on_route:g} of them on the decode route"
            assert on_route == QSERVE_PER_STEP, routes
        print(line + f"; on {smi}")
        assert st["completed"] == QSERVE_REQUESTS, st
        out[name] = dict(tokens_s=toks / wall, bytes=nbytes, counts=counts,
                         wall_s=wall)
    # the profiles after every timed run: a profiled process may keep
    # some of the tracer's host cost
    for name, card in variants.items():
        out[name]["profile"] = qserve_profile(card, dev, name, prompts)
    return out


def qserve_profile(model, dev, name, prompts):
    """Device time of 4 decode steps at 8 rows: wall against busy and each
    kernel family's share."""
    bs = QSERVE_ENGINE["block_size"]
    n = len(prompts)
    mb = QSERVE["max_seq"] // bs
    tables = (torch.arange(n * mb, dtype=torch.int32).reshape(n, mb)
              + 1).to(dev)
    pools = model.init_paged_cache(n * mb + 1, bs, device=dev)
    tok = torch.zeros(n, dtype=torch.int64, device=dev)
    pos = torch.full((n,), 100, dtype=torch.int32, device=dev)

    def step():
        with torch.no_grad():
            model.decode_step_paged(tok, pos, pools, tables)
    step()
    prof = profile_steps(step, 4, QUANT_FAMILIES)
    print(f"phase 17: profiled 4 {name} decode steps (8 rows): "
          f"{prof['wall_ms']:.2f} ms of wall per step (under the profiler) "
          f"for {prof['busy_ms']:.3f} ms of device busy time, "
          f"{prof['device_ops']:.0f} device ops per step; device ms per "
          f"step by family {prof['ms']}; largest glue {prof['glue_top']}")
    return prof


def w8a8_forward(model, toks, iters=W8A8_ITERS):
    """Logits of one forward and the mean ms of ``iters`` more."""
    with torch.no_grad():
        logits = model(toks)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            model(toks)
        torch.cuda.synchronize()
    return logits, (time.perf_counter() - t0) / iters * 1e3


def phase18_w8a8(dev, smi):
    """bench.py:273-301's W8A8 prefill: the int8 model under TAPER_W8A8=1
    (K14 + K15a), the same weights through K12, the same dense weights in
    int4 through K13 (every 2-D leaf, as phase 17 quantizes; its logits
    against the port's CPU path on one batch row) and the bf16 dense model
    through K1; then a profile of the W8A8, K12 and K13 forwards by kernel
    family."""
    gen = torch.Generator().manual_seed(SEED)
    dense = TinyGPT(**W8A8, compute_dtype=torch.bfloat16)
    dense.reset_parameters(gen)
    qmodel = quantize_params(
        dense, QuantizationConfig(qtype=QuantizationType.INT8)).to(dev)
    q4model = quantize_params(dense, QuantizationConfig.int4())
    toks = torch.randint(0, W8A8["vocab_size"],
                         (W8A8_BATCH, W8A8["max_seq"]), generator=gen)
    t0 = time.perf_counter()
    with torch.no_grad():
        ref4 = q4model(toks[:1]).float()
    cpu_s = time.perf_counter() - t0
    q4model.to(dev)
    dense.to(dev)
    toks = toks.to(dev)
    n_lin = 6 * W8A8["depth"]
    runs = {}
    for name, model, w8a8, want in (
            ("w8a8", qmodel, "1", dict(quantize_rows=n_lin,
                                       matmul_int8_scaled=n_lin)),
            ("int8 K12", qmodel, "0", dict(linear_q8=n_lin)),
            ("int4 K13", q4model, "0", dict(linear_q4=n_lin)),
            ("bf16 dense", dense, "0", dict(linear=n_lin))):
        os.environ["TAPER_W8A8"] = w8a8
        try:
            torch.cuda.synchronize()
            backend.reset_launch_counts()
            with torch.no_grad():
                model(toks)
            torch.cuda.synchronize()
            counts = {k: c for k, c in backend.launch_counts().items() if c}
            routes = backend.route_counts()
            logits, ms = w8a8_forward(model, toks)
        finally:
            os.environ.pop("TAPER_W8A8")
        want.update(flash_fwd_bound=W8A8["depth"])
        assert counts == want, (name, counts)
        assert torch.isfinite(logits).all()
        runs[name] = dict(logits=logits.float().cpu(), ms=ms, counts=counts)
        print(f"phase 18: {name} forward of {W8A8_BATCH} x "
              f"{W8A8['max_seq']} tokens: {ms:.2f} ms; launches {counts}")
        if name == "int4 K13":
            # every K13 product on the wgmma route
            mine = {k: c for k, c in routes.items()
                    if k.endswith("linear_q4")}
            print(f"phase 18: int4 K13 calls by route {mine}")
            assert mine == {"wgmma linear_q4": n_lin}, routes
    rel = rel_l2(runs["w8a8"]["logits"], runs["int8 K12"]["logits"])
    rel_dense = rel_l2(runs["int8 K12"]["logits"],
                       runs["bf16 dense"]["logits"])
    rel4 = rel_l2(runs["int4 K13"]["logits"][:1], ref4)
    print(f"phase 18: W8A8 logits vs the same int8 weights through K12: "
          f"rel L2 {rel:.3e} (tol {W8A8_REL_TOL:.0e}, the activation "
          f"rounding); K12 vs bf16 dense {rel_dense:.3e} (the weight "
          f"rounding); int4 K13 logits {tuple(ref4.shape)} of batch row 0 "
          f"vs the port's CPU path ({cpu_s:.1f} s there): rel L2 "
          f"{rel4:.3e} (tol {Q4_PREFILL_REL_TOL:.0e}), max abs err "
          f"{float((runs['int4 K13']['logits'][:1] - ref4).abs().max()):.3e}"
          f"; W8A8 {runs['w8a8']['ms']:.2f} ms, K12 "
          f"{runs['int8 K12']['ms']:.2f} ms, K13 "
          f"{runs['int4 K13']['ms']:.2f} ms, bf16 dense "
          f"{runs['bf16 dense']['ms']:.2f} ms; on {smi}")
    assert rel <= W8A8_REL_TOL, rel
    assert runs["int4 K13"]["logits"][:1].shape == ref4.shape
    assert rel4 <= Q4_PREFILL_REL_TOL, rel4
    # where the W8A8, the K12 and the K13 forwards' device time goes
    for name, model, flag in (("W8A8", qmodel, "1"), ("K12", qmodel, "0"),
                              ("K13", q4model, "0")):
        def forward(model=model):
            with torch.no_grad():
                model(toks)
        os.environ["TAPER_W8A8"] = flag
        try:
            prof = profile_steps(forward, 2, W8A8_FAMILIES)
        finally:
            os.environ.pop("TAPER_W8A8")
        print(f"phase 18: profiled 2 {name} forwards: {prof['wall_ms']:.2f} "
              f"ms of wall each (under the profiler) for "
              f"{prof['busy_ms']:.3f} ms of device busy time; device ms by "
              f"family { {k: round(v, 4) for k, v in prof['ms'].items()} }; "
              f"largest glue {prof['glue_top']}")
    counts = dict.fromkeys(backend.KERNELS, 0)
    for r in runs.values():
        for k, c in r["counts"].items():
            counts[k] += c
    return counts, {k: dict(ms=r["ms"]) for k, r in runs.items()}


def phase19_ptq_example(dev, smi):
    """examples/ptq_quantize.py through its entry point, one epoch (from
    SEED the card's CNN spikes in epoch 2: phase 8)."""
    torch.cuda.synchronize()
    backend.reset_launch_counts()
    t0 = time.perf_counter()
    res = ptq_quantize.main(["--device", "cuda", "--epochs", "1"])
    torch.cuda.synchronize()
    counts, routes = backend.launch_counts(), backend.route_counts()
    # the int8 model: one diagnostic batch of 256 and the 10k test split
    # in 5 eval batches of 2000, three int8 FC layers each: the two of N
    # 128 and 64 on wgmma, the 10-way head (N % 4 != 0) on mma
    batches = 10000 // 2000
    per_batch = (counts["linear_q8"] - 3) / batches
    by_route = {r: (routes.get(f"{r} linear_q8", 0) - want) / batches
                for r, want in (("wgmma", 2), ("mma", 1))}
    f32 = res["f32"]["acc"]
    print(f"phase 19: examples/ptq_quantize.py --epochs 1 in "
          f"{time.perf_counter() - t0:.1f} s (the example's default of 2 "
          f"epochs meets the Adam spike from this seed on the card, phase "
          f"8): " + "; ".join(
              f"{k} acc {r['acc']:.4f} drop {f32 - r['acc']:+.4f} "
              f"{r['bytes'] / 1e6:.3f} MB eval {r['eval_s']:.3f} s max "
              f"logit diff {r['max_logit_diff']:.5f}"
              for k, r in res.items())
          + f"; K12 launches per eval batch of 2000: {per_batch:g} (by "
          f"route {by_route}); on {smi}")
    assert abs(res["int8"]["acc"] - f32) <= PTQ_INT8_DROP, res
    assert abs(res["float16"]["acc"] - f32) <= PTQ_F16_DROP, res
    assert per_batch == 3, counts
    assert by_route == {"wgmma": 2, "mma": 1}, routes
    assert sum(c for k, c in routes.items() if k.endswith("linear_q8")) \
        == counts["linear_q8"], routes
    return counts


# -- int8 KV caches and the contiguous-cache engine; checkpoints -------------

# bench.py:202-271 bench_paged_decode at its shapes: MODEL in bf16, 16
# rows, block 128, rows alternating 256 and 4032 tokens of context (so the
# first step attends 257 and 4033 positions), each table reserving
# ceil((len + 64) / 128) blocks; "short": every row at 256, 3 blocks.
BENCH = dict(batch=16, smax=MODEL["max_seq"], bs=128, short=256,
             long=MODEL["max_seq"] - 64, steps=30, warmup=3, rounds=2)
# K16 over int8 pools against its plain version: both compute in f32 from
# the same int8 codes and f32 scales (the kernel scales the score and the
# softmax weight, the plain version the gathered rows; other summation
# orders), and round o to q's dtype: K16_TOL.
# Launches per decode step of MODEL (8 layers x wq, wk, wv, wo, w1, w2):
# the paged int8 engine also launches K16's int8 branch once a layer, the
# contiguous engine no paged kernel (its decode attention is plain
# PyTorch, as JAX's is XLA).
INT8_PER_STEP = dict(linear=48, paged_decode_int8=8)
CONTIG_PER_STEP = dict(linear=48)
# Logits on the card, one prefill (512 padded tokens) and one decode step:
#  * paged int8 against contiguous int8: the same prefill stores the same
#    codes and scales (prefill logits bit-equal); the decode step's
#    attention is K16 int8 (o rounded to bf16 from f32) against the plain
#    contiguous version (f32, cast to bf16 after), so a bf16 rounding of
#    o flips here and there in each of 8 layers: 1e-2 relative L2;
#  * contiguous bf16 against the f32 CPU path: the bf16 trunk's rounding
#    through 8 blocks, MODEL_REL_TOL as phase 4.
INT8_PAGED_VS_CONTIG_TOL = 1e-2
# Phase 23: the MNIST MLP (examples/train_mnist.py's settings) for 2
# epochs, and the same run cut after epoch 1 and resumed.  Every kernel of
# that path is deterministic (K1's f32 modes and K17a sum in a fixed
# order, no atomics), so the two must end bit-equal.
CKPT_EPOCHS = 2
DECODE_FAMILIES = K1_FAMILIES + (("K16 paged decode", "paged_decode"),
                                 ("head sgemm", "gemm"))


def bench_tables(lens, mb, bs):
    """bench_paged_decode's tables: each row ceil((len + 64) / bs)
    consecutive blocks from block 1 (block 0 unused); and the pool's
    block count."""
    tables = np.zeros((len(lens), mb), np.int32)
    nxt = 1
    for i, n in enumerate(lens):
        nb = -(-(int(n) + 64) // bs)
        tables[i, :nb] = np.arange(nxt, nxt + nb)
        nxt += nb
    return tables, nxt


def int8_pools(gen, n_blocks, kvh, bs, d, dev):
    """int8 K/V pools with their per-position scales, as kv_quantize
    stores rows of std ~1: (k codes, k scales, v codes, v scales)."""
    out = []
    for _ in range(2):
        x = torch.randn(n_blocks, kvh, bs, d, generator=gen)
        scale = x.abs().amax(-1).clamp_min(1e-8) / 127.0
        out += [torch.round(x / scale[..., None]).to(torch.int8).to(dev),
                scale.to(dev)]
    return out


def int8_row(name, shape, q, pools, tables, lengths, phase=20):
    """K16 over int8 pools against its plain version; the bound is the
    bytes of the live rows, their scales, q and o."""
    kq, ks, vq, vs = pools
    d = q.shape[-1]
    sets = [(q, kq, vq, tables, lengths, ks, vs)]
    sets += [tuple(t.clone() for t in sets[0])
             for _ in range(copies_for(kq, vq, ks, vs) - 1)]

    def kernel(q, kq, vq, tb, ln, ks, vs):
        return paged_decode_attention(q, kq, vq, tb, ln, scale=d ** -0.5,
                                      k_scales=ks, v_scales=vs)

    def plain(q, kq, vq, tb, ln, ks, vs):
        return paged_decode_reference(q, kq, vq, tb, ln, scale=d ** -0.5,
                                      k_scales=ks, v_scales=vs)
    live = int(lengths.sum()) * q.shape[1]          # positions x kv heads
    return check_kernel(
        name, shape, kernel, plain, sets, phase=phase,
        **K16_TOL[q.dtype],
        work=(4 * live * q.shape[2] * d,
              2 * live * (d + 4) + 2 * nbytes(q), "f32"))


def bf16_paged_row(label, q, kp, vp, tables, lengths):
    """K16 over bf16 pools against its plain version; the bound is the
    bytes of the live rows, q and o."""
    tokens, kvh = int(lengths.sum()), q.shape[1]
    return check_kernel(
        "paged_decode", label,
        lambda *a: paged_decode_attention(*a, scale=128 ** -0.5),
        lambda *a: paged_decode_reference(*a, scale=128 ** -0.5),
        cold_sets(q, kp, vp, tables, lengths), phase=20,
        **K16_TOL[q.dtype],
        work=(4 * tokens * kvh * 128,
              2 * tokens * kvh * 128 * 2 + 2 * nbytes(q), "bf16"))


def split_repeats(q, pools, tables, lengths, label):
    """Two calls of K16 on the same inputs, split as ``plan`` says, give
    the same bits (the splits merge in a fixed order, no atomics)."""
    if len(pools) == 4:    # int8 codes and their scales
        kp, ks, vp, vs = pools
        sc = dict(k_scales=ks, v_scales=vs)
    else:
        (kp, vp), sc = pools, {}
    splits, _ = paged_plan(*q.shape, kp.shape[2], tables.shape[1], kp.dtype)
    with torch.no_grad():
        first, again = (paged_decode_attention(
            q, kp, vp, tables, lengths, scale=q.shape[-1] ** -0.5, **sc)
            for _ in range(2))
    same = torch.equal(first, again)
    print(f"phase 20: {label} split x{splits}: two calls bit-equal: {same}")
    assert splits > 1 and same, label


def phase20_int8_kernel(dev):
    """K16's int8 branch at bench_paged_decode's shapes (bf16 q), with
    every row at the long length, at the serving mix and at phase 17's
    model shape (kvh 4, G 4, f32 q), with the bf16 kernel at the mixed and
    the all-long lengths beside it, and a repeated split call of each."""
    gen = torch.Generator().manual_seed(SEED)
    b, bs = BENCH["batch"], BENCH["bs"]
    mb = BENCH["smax"] // bs
    kvh = MODEL["num_heads"]
    q = torch.randn(b, kvh, 1, 128, generator=gen).to(torch.bfloat16).to(dev)
    rows = {"paged_decode_int8": [], "paged_decode": []}
    for kind, lens in (("mixed", [BENCH["short"] if i % 2 == 0
                                  else BENCH["long"] for i in range(b)]),
                       ("all long", [BENCH["long"]] * b)):
        tables, n_blocks = bench_tables(lens, mb, bs)
        tables = torch.from_numpy(tables).to(dev)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev) + 1
        span = (f"lengths {BENCH['short'] + 1}/{BENCH['long'] + 1}"
                if kind == "mixed" else f"all {BENCH['long'] + 1}")
        pools = int8_pools(gen, n_blocks, kvh, bs, 128, dev)
        rows["paged_decode_int8"].append(int8_row(
            "paged_decode_int8", f"bf16 q B={b} kvh={kvh} G=1 D=128 "
            f"bs={bs} mb={mb} {span}", q, pools, tables, lengths))
        if kind == "mixed":
            split_repeats(q, pools, tables, lengths, f"paged_decode_int8 "
                          f"{span}")
        del pools
        kp, vp = (torch.randn(n_blocks, kvh, bs, 128, generator=gen).to(
            torch.bfloat16).to(dev) for _ in range(2))
        rows["paged_decode"].append(bf16_paged_row(
            f"bf16 B={b} kvh={kvh} G=1 D=128 bs={bs} {span}", q, kp, vp,
            tables, lengths))
        if kind == "mixed":
            split_repeats(q, (kp, vp), tables, lengths,
                          f"paged_decode {span}")
        del kp, vp
        torch.cuda.empty_cache()
    # phase 5's serving mix over int8 pools (the paged int8 engine's)
    slots = ENGINE["slots"]
    n_blocks = pool_blocks()
    lengths = torch.tensor(np.random.default_rng(SEED).integers(
        33, ENGINE["prompt_pad"] + max(MAX_NEW) + 1, slots),
        dtype=torch.int32, device=dev)
    perm = torch.randperm(n_blocks - 1, generator=gen) + 1
    tables = torch.zeros(slots, mb, dtype=torch.int32)
    tables[:, :5] = perm[:slots * 5].reshape(slots, 5)
    rows["paged_decode_int8"].append(int8_row(
        "paged_decode_int8", f"bf16 q B={slots} kvh={kvh} G=1 D=128 bs={bs} "
        f"lengths {int(lengths.min())}..{int(lengths.max())}", q,
        int8_pools(gen, n_blocks, kvh, bs, 128, dev), tables.to(dev),
        lengths))
    # phase 17's model: 8 slots, 16 query heads on 4 KV heads, f32, max_seq
    # 256 in two blocks of 128, lengths of 8-token prompts plus up to 200
    # new tokens
    qs, qbs = QSERVE_ENGINE["slots"], QSERVE_ENGINE["block_size"]
    qkvh, g = QSERVE["num_kv_heads"], QSERVE["num_heads"] // QSERVE[
        "num_kv_heads"]
    qmb = QSERVE["max_seq"] // qbs
    qlen = torch.linspace(QSERVE_PROMPT + 1, QSERVE_PROMPT + QSERVE_NEW,
                          qs).round().to(torch.int32).to(dev)
    qtab = (torch.arange(qs * qmb, dtype=torch.int32).reshape(qs, qmb)
            + 1).to(dev)
    rows["paged_decode_int8"].append(int8_row(
        "paged_decode_int8", f"f32 q B={qs} kvh={qkvh} G={g} D=128 "
        f"bs={qbs} lengths {int(qlen.min())}..{int(qlen.max())}",
        torch.randn(qs, qkvh, g, 128, generator=gen).to(dev),
        int8_pools(gen, qs * qmb + 1, qkvh, qbs, 128, dev), qtab, qlen))
    return rows


def decode_profile(step, n=2):
    prof = profile_steps(step, n, DECODE_FAMILIES)
    prof["busy_share"] = prof["busy_ms"] / prof["wall_ms"]
    return prof


def host_profile(step, n=5, top=10):
    """Where the host's time goes in ``step()``, by Python function, from
    cProfile over ``n`` calls (its hook on every call inflates small
    functions): the wall per call without the profiler and with it, in
    ms; the ``top`` functions by own time and, of the port's own, by time
    including callees, each ``(where, ms a call, calls a call)``; and own
    time summed by file."""
    import cProfile
    import pstats
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n * 1e3
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    prof.disable()
    wall_prof = (time.perf_counter() - t0) / n * 1e3
    stats = pstats.Stats(prof).stats
    # a Python function by its file's last two parts, a C one ("~") by
    # its own name
    rows = [("/".join(f.split("/")[-2:]) + f":{ln}({fn})" if f != "~"
             else fn, f if f != "~" else fn, nc / n, tt / n * 1e3,
             ct / n * 1e3) for (f, ln, fn), (_, nc, tt, ct, _) in
            stats.items()]
    own = sorted(rows, key=lambda r: -r[3])[:top]
    port = sorted((r for r in rows if "taper_tpu_torch" in r[1]),
                  key=lambda r: -r[4])[:top]
    by_file = {}
    for r in rows:
        key = "/".join(r[1].split("/")[-2:])
        by_file[key] = by_file.get(key, 0.0) + r[3]
    return dict(
        wall_ms=wall, wall_prof_ms=wall_prof,
        own=[(w, round(t, 3), c) for w, _, c, t, _ in own],
        port_cum=[(w, round(t, 3), c) for w, _, c, _, t in port],
        by_file={k: round(v, 3) for k, v in sorted(
            by_file.items(), key=lambda kv: -kv[1])[:top]})


def engine_logits(model, dev, prompt, paged, quant):
    """Prefill of one padded prompt and one decode step through the
    contiguous cache or paged pools of ``model`` on ``dev``: ``(prefill
    logits at the prompt, decode logits)`` on the CPU."""
    bs, pad = ENGINE["block_size"], ENGINE["prompt_pad"]
    padded = torch.zeros(1, pad, dtype=torch.int64)
    padded[0, :len(prompt)] = torch.tensor(prompt)
    pos = torch.tensor([len(prompt)], dtype=torch.int32, device=dev)
    tok = torch.tensor([7], device=dev)
    with torch.no_grad():
        if paged:
            table = torch.zeros(1, MODEL["max_seq"] // bs, dtype=torch.int32)
            table[0, :pad // bs + 1] = torch.arange(1, pad // bs + 2)
            table = table.to(dev)
            pools = model.init_paged_cache(pad // bs + 2, bs, device=dev,
                                           quantized=quant)
            pre = model.prefill_paged(padded.to(dev), pools, table)
            step = model.decode_step_paged(tok, pos, pools, table)
        else:
            caches = model.init_cache(1, quantized=quant, device=dev)
            pre = model.prefill(padded.to(dev), caches)
            step = model.decode_step(tok, pos, caches)
    return pre[0, :len(prompt)].float().cpu(), step.float().cpu()


def serve_mode(model, reqs, paged, quant):
    """The 32-request mix through one engine mode: wall, generated tokens,
    launch counts, stats, and a profile of one decode block with 16
    requests admitted."""
    kw = dict(ENGINE, pool_blocks=pool_blocks() if paged else None,
              quantized_cache=quant, seed=SEED)
    eng = ServingEngine(model, **kw)
    ids = [eng.submit(p, m, **s) for p, m, s in reqs]
    torch.cuda.synchronize()
    backend.reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = backend.launch_counts()
    for rid, (_, max_new, _) in zip(ids, reqs):
        assert len(out[rid]) == max_new, (rid, len(out[rid]), max_new)
        assert all(0 <= t < MODEL["vocab_size"] for t in out[rid]), rid
    st = eng.stats()
    assert st["completed"] == N_REQUESTS, st
    steps = st["decode_blocks"] * ENGINE["decode_block"]
    # the prefills' launches: 6 projections a layer and one K8
    per = {k: (c - (MODEL["depth"] * 6 * st["admitted"] if k == "linear"
                    else 0)) / steps
           for k, c in counts.items() if c and k != "flash_fwd_bound"}
    assert counts["flash_fwd_bound"] == MODEL["depth"] * st["admitted"], \
        counts
    want = INT8_PER_STEP if paged and quant else CONTIG_PER_STEP
    assert per == want, (per, want)
    del eng, out
    torch.cuda.empty_cache()
    # one decode block of 16 admitted requests (admission and its first
    # block through step(), then the block profiled)
    eng = ServingEngine(model, **kw)
    for p, m, s in reqs[:ENGINE["slots"]]:
        eng.submit(p, max(MAX_NEW), **s)
    eng.step()
    with torch.no_grad():
        eng._decode_block()           # its capture, outside the profile
        prof = decode_profile(eng._decode_block, 1)
    del eng
    torch.cuda.empty_cache()
    return dict(wall_s=wall, tokens=sum(m for _, m, _ in reqs),
                counts=counts, stats=st, per_step=per, profile=prof)


def phase21_serve_modes(card, dev, reqs, smi):
    """The 32-request mix through the contiguous bf16, paged int8 and
    contiguous int8 engines, with logits checks and profiles."""
    prompt = reqs[0][0]
    got = {name: engine_logits(card, dev, prompt, paged, quant)
           for name, paged, quant in (("paged_int8", True, True),
                                      ("contig_int8", False, True),
                                      ("contig_bf16", False, False))}
    (pp, ps), (cp, cs) = got["paged_int8"], got["contig_int8"]
    assert torch.equal(pp, cp), "paged and contiguous int8 prefill differ"
    rel = rel_l2(ps, cs)
    print(f"phase 21: paged int8 vs contiguous int8 on the card: prefill "
          f"logits {tuple(pp.shape)} bit-equal; decode step rel L2 "
          f"{rel:.3e} (tol {INT8_PAGED_VS_CONTIG_TOL:.0e}), max abs err "
          f"{float((ps - cs).abs().max()):.3e}")
    assert torch.isfinite(ps).all() and rel <= INT8_PAGED_VS_CONTIG_TOL
    cpu = TinyGPT(**MODEL)
    cpu.reset_parameters(torch.Generator().manual_seed(SEED))
    cpu.eval()
    ref = engine_logits(cpu, "cpu", prompt, False, False)
    del cpu
    for what, o, r in zip(("prefill", "decode step"), got["contig_bf16"],
                          ref):
        assert o.shape == r.shape and torch.isfinite(o).all()
        rel = rel_l2(o, r)
        print(f"phase 21: contiguous bf16 {what} logits {tuple(o.shape)}, "
              f"card vs the f32 CPU path: rel L2 {rel:.3e} (tol "
              f"{MODEL_REL_TOL:.0e})")
        assert rel <= MODEL_REL_TOL, f"contiguous {what} logits"
    out = {}
    for name, paged, quant in (("contig_bf16", False, False),
                               ("paged_int8", True, True),
                               ("contig_int8", False, True)):
        r = out[name] = serve_mode(card, reqs, paged, quant)
        st, prof = r["stats"], r["profile"]
        print(f"phase 21: {name} served {N_REQUESTS} requests "
              f"({st['completed']} completed, {st['decode_blocks']} decode "
              f"blocks) in {r['wall_s']:.2f} s: "
              f"{r['tokens'] / r['wall_s']:.1f} generated tokens/s; "
              f"launches per decode step {r['per_step']}; one decode block "
              f"of {ENGINE['decode_block']} steps ({ENGINE['slots']} rows) "
              f"profiled: "
              f"{prof['wall_ms']:.1f} ms of wall for {prof['busy_ms']:.2f} "
              f"ms of device busy ({prof['busy_share']:.3f}), "
              f"{prof['device_ops']:.0f} device ops; device ms by family "
              f"{prof['ms']}; largest glue {prof['glue_top']}; on {smi}")
    return out


def bench_contenders(model, dev):
    """bench_paged_decode's four contenders: (name, step, state)."""
    b, bs = BENCH["batch"], BENCH["bs"]
    mb = BENCH["smax"] // bs
    lens = [BENCH["short"] if i % 2 == 0 else BENCH["long"]
            for i in range(b)]
    tables, n_blocks = bench_tables(lens, mb, bs)
    short = np.zeros((b, mb), np.int32)
    short[:, :3] = np.arange(1, b * 3 + 1).reshape(b, 3)
    mixed_pos = torch.tensor(lens, dtype=torch.int32, device=dev)
    short_pos = torch.full((b,), BENCH["short"], dtype=torch.int32,
                           device=dev)

    def cstep(state):
        tok, pos, caches = state
        logits = model.decode_step(tok, pos, caches)
        return logits.argmax(-1), pos + 1, caches

    def pstep(tables):
        def step(state):
            tok, pos, pools = state
            logits = model.decode_step_paged(tok, pos, pools, tables)
            return logits.argmax(-1), pos + 1, pools
        return step
    tok0 = torch.zeros(b, dtype=torch.int64, device=dev)
    return [("contig", cstep, (tok0, mixed_pos, model.init_cache(b))),
            ("paged_int8_mixed", pstep(torch.from_numpy(tables).to(dev)),
             (tok0, mixed_pos, model.init_paged_cache(n_blocks, bs,
                                                      quantized=True))),
            ("contig_short", cstep, (tok0, short_pos, model.init_cache(b))),
            ("paged_short", pstep(torch.from_numpy(short).to(dev)),
             (tok0, short_pos, model.init_paged_cache(b * 3 + 1, bs)))]


def phase22_bench_decode(card, dev, smi):
    """bench_paged_decode's contenders on the card, argmax feedback as
    there: tokens/s (batch over the per-step time of BENCH["steps"] steps
    ended by a sync, the mean over BENCH["rounds"] rounds in turn) and the
    device time of a step (profiled), and the bench's two ratios."""
    cs = bench_contenders(card, dev)
    states = {name: state for name, _, state in cs}
    times = {name: [] for name, _, _ in cs}
    torch.cuda.synchronize()
    backend.reset_launch_counts()
    with torch.no_grad():
        for _ in range(BENCH["rounds"]):
            for name, step, _ in cs:
                st = states[name]
                for _ in range(BENCH["warmup"]):
                    st = step(st)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(BENCH["steps"]):
                    st = step(st)
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t0)
                                   / BENCH["steps"])
                # rewind the positions: every round times the same lengths
                states[name] = (st[0], states[name][1], st[2])
        counts = backend.launch_counts()
        out = {}
        for name, step, _ in cs:
            st = [states[name]]

            def one(step=step, st=st):
                st[0] = step(st[0])
            prof = decode_profile(one, 3)
            t = sum(times[name]) / len(times[name])
            out[name] = dict(step_ms=t * 1e3, tokens_s=BENCH["batch"] / t,
                             rounds_ms=[x * 1e3 for x in times[name]],
                             profile=prof)
            print(f"phase 22: {name}: {out[name]['tokens_s']:.1f} tokens/s "
                  f"({t * 1e3:.3f} ms a step of {BENCH['batch']} rows; "
                  f"rounds {[round(x * 1e3, 3) for x in times[name]]} ms), "
                  f"device busy {prof['busy_ms']:.3f} ms a step "
                  f"(profiled, {prof['wall_ms']:.2f} ms of wall), device ms "
                  f"by family {prof['ms']}")
    ratios = dict(
        paged_int8_mixed_speedup=out["contig"]["step_ms"]
        / out["paged_int8_mixed"]["step_ms"],
        paged_short_speedup=out["contig_short"]["step_ms"]
        / out["paged_short"]["step_ms"])
    print(f"phase 22: bench_paged_decode's ratios on the card: {ratios}; "
          f"launches {dict((k, c) for k, c in counts.items() if c)}; on "
          f"{smi}")
    assert counts["paged_decode_int8"] > 0 and counts["paged_decode"] > 0
    del cs, states
    torch.cuda.empty_cache()
    return counts, out, ratios


def phase23_checkpoints(dev, smi):
    """The MNIST MLP through fit_device for CKPT_EPOCHS epochs with a
    checkpoint every epoch, and the same run cut after epoch 1 and
    resumed: the same parameters and Adam moments at the end."""
    train, test = MNISTDataset(train=True), MNISTDataset(train=False)

    def trainer():
        return Trainer(mnist_mlp(), optim.Adam(1e-3, weight_decay=1e-4),
                       seed=SEED, device=dev)
    kw = dict(batch_size=256, early_stop_acc=2.0, verbose=False,
              save_every=1)
    args = (train.images, train.labels, test.images, test.labels)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        full = trainer()
        full.fit_device(*args, CKPT_EPOCHS,
                        checkpoint_path=os.path.join(tmp, "full.npz"), **kw)
        cut_path = os.path.join(tmp, "cut.npz")
        trainer().fit_device(*args, 1, checkpoint_path=cut_path, **kw)
        resumed = trainer()
        m = resumed.fit_device(*args, CKPT_EPOCHS, checkpoint_path=cut_path,
                               resume=True, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        size = os.path.getsize(cut_path)
    pairs = list(zip(full.model.parameters(), resumed.model.parameters()))
    pairs += list(zip(full.optimizer.m + full.optimizer.v,
                      resumed.optimizer.m + resumed.optimizer.v))
    with torch.no_grad():
        err = max(float((a - b).abs().max()) for a, b in pairs)
    print(f"phase 23: MNIST MLP fit_device {CKPT_EPOCHS} epochs with a "
          f"checkpoint each epoch ({size} bytes), against 1 epoch, a fresh "
          f"Trainer and resume=True: resumed epochs {len(m.val_acc)}, val "
          f"acc {full.metrics.val_acc[-1]:.4f} and {m.val_acc[-1]:.4f}; "
          f"max abs difference of the parameters and Adam moments {err:.3e}"
          f" (tol 0: deterministic kernels); {wall:.2f} s for the three "
          f"runs; on {smi}")
    assert len(m.val_acc) == CKPT_EPOCHS - 1
    assert resumed.optimizer.t == full.optimizer.t
    assert err == 0.0, "the resumed run does not end where the full one did"


# -- slice S5: sliding windows, packed segments, K10 and K11 -----------------

# The windowed model of benchmarks/bench_serving.py:287-340: MODEL with a
# sliding window of 512 (vocab 4096, dim 1024, depth 8, 8 heads of 128,
# max_seq 4096, RoPE, bf16).  Trained at batch 2 x 4096, Adam(1e-4)
# (phase 26); decoded at batch 8 after a 1024-token prompt (phase 27).
WMODEL = dict(MODEL, window=512)
WTRAIN = dict(batch=2, lr=1e-4, warmup=2, steps=5, cpu_depth=2)
WDECODE = dict(batch=8, prompt=1024, steps=128, requests=16)
# Packed training, benchmarks/bench_packing.py:37-90: TinyGPT vocab 4096,
# dim 512, depth 6, 8 heads of 64, max_seq 1024, RoPE, bf16 trunk,
# Adam(1e-4); 64 documents of geometric lengths (mean 192, clipped to
# 8..1024) from np.random.default_rng(0), padded (64 rows) or packed.
PACK = dict(model=dict(vocab_size=4096, dim=512, depth=6, num_heads=8,
                       max_seq=1024, rope=True),
            n_docs=64, mean_len=192, lr=1e-4, warmup=2, steps=5,
            cpu_rows=2)
# Launches per training step, exactly: 6 projections a layer in each of K1's
# three modes, one attention a layer (K5 with a window or segments, K8 for
# plain bf16 causal attention), K6 and K7 (K11 under TAPER_ATTN_DKV_T=1,
# K10 alone under TAPER_ATTN_FUSED_BWD=1), one Adam update.
PACKED_PER_STEP = dict(linear=36, gemm_nn=36, gemm_tn=36, flash_fwd=6,
                       flash_dq=6, flash_dkv=6, adam=1)
PADDED_PER_STEP = dict(linear=36, gemm_nn=36, gemm_tn=36, flash_fwd_bound=6,
                       flash_dq=6, flash_dkv=6, adam=1)
WINDOW_PER_STEP = dict(linear=48, gemm_nn=48, gemm_tn=48, flash_fwd=8,
                       flash_dq=8, flash_dkv=8, adam=1)
WINDOW_DKV_T_PER_STEP = dict(WINDOW_PER_STEP, flash_dkv=0, flash_dkv_t=8)
LM_FUSED_PER_STEP = dict(linear=72, gemm_nn=72, gemm_tn=72,
                         flash_fwd_bound=12, flash_bwd_fused=12, adam=1)
# Tolerances of this slice:
#  * the masked kernels as their unmasked selves (TOL's notes): bf16
#    forward 2e-2, gradients per 64-row tile 1e-2 of the tile's norm; K11's
#    f32 partials are sums of the same bf16-rounded products, held alike;
#  * K10 against K6 + K7 through the whole 170M step, and K11 against K7
#    through the windowed step: the same bf16-rounded products summed in
#    f32 in other orders (K10's dQ with atomics), each gradient rounded to
#    bf16, so the model's gradients agree to a rounding of bf16 (2^-9)
#    per layer: BWD_BF16_TOL relative L2 per parameter;
#  * a packed document's f32 logits on the card against the same document
#    alone: the same f32 arithmetic with the KV tiles aligned elsewhere,
#    1e-4 relative L2 (a leak across documents moves them by far more);
#  * ring against full cache decode logits, bf16: the same keys in another
#    slot order and a shorter cache, so the softmax and P.V sum in other
#    orders (another cuBLAS product for P.V) and bf16 roundings of the
#    attention output flip, which the random-weight model carries to its
#    logits as it carries any bf16 rounding: the bf16 tolerance of phase 4,
#    MODEL_REL_TOL (the first chip runs read 8.3e-3 median, 8.9e-3 worst
#    step, at the level of the card's bf16 against the CPU's f32, ~9.6e-3);
#    int8 ring against the int8 full cache: phase 21's 1e-2.
PACKED_ALONE_TOL = 1e-4
RING_TOL = MODEL_REL_TOL
# The MNIST MLP at bench.py:48-80's settings (10 epochs, Adam 1e-3 wd
# 1e-4, early_stop_acc=2.0): BENCH_r05's final val accuracy 0.993 less a
# batch-order allowance.  tools/jax_mlp_seed_spread.py ran the JAX
# package's fit_device at these settings on the CPU from seeds 0-7 (the
# seed sets the weights and the batch order): final accuracies 0.9851 to
# 0.9959, mean 0.9919, the largest shortfall from 0.993 0.0079 (seed 5,
# whose last epoch dipped from 0.9923); the allowance is that shortfall
# rounded up to 0.008 (PERF.md).
MLP_BENCH = dict(epochs=10, acc=0.993, allowance=0.008)


def band_pairs(s, causal, window):
    """Kept (row, col) pairs of one head of S rows under a causal mask and
    a window: the band's live pairs, which the FLOP count of a masked
    kernel and its bound read."""
    rows = np.arange(s)
    lo = np.zeros(s) if window is None else np.maximum(0, rows - window + 1)
    hi = rows + 1 if causal else np.full(s, s)
    return int((hi - lo).sum())


def segment_pairs(seg, causal):
    """Kept pairs of ``[B, S]`` segment ids whose documents are runs of
    equal ids (as pack_documents writes them), summed over the rows."""
    total = 0
    for row in np.asarray(seg):
        _, n = np.unique(row, return_counts=True)
        total += int((n * (n + 1) // 2 if causal else n * n).sum())
    return total


def sdpa_keep(s, dev, causal, window, seg):
    """The boolean ``attn_mask`` (True: attend) that gives
    F.scaled_dot_product_attention the same mask."""
    rows = torch.arange(s, device=dev)[:, None]
    cols = torch.arange(s, device=dev)[None, :]
    keep = torch.ones(s, s, dtype=torch.bool, device=dev)
    if causal:
        keep &= rows >= cols
    if window is not None:
        keep &= cols > rows - window
    if seg is not None:
        keep = keep & (seg[:, None, :, None] == seg[:, None, None, :])
    return keep


def masked_flash_rows(label, q, k, v, do, *, heads, causal, window, seg,
                      pairs, phase=24, dkv_t=False):
    """K5, K6 and K7 (and K11 with ``dkv_t``) under a window or segment
    ids against the plain versions, timed beside a bound over the band's
    live ``pairs`` (summed over the batch) and SDPA with the same boolean
    mask."""
    d = q.shape[-1] if heads is None else q.shape[-1] // heads
    b, h = q.shape[0], q.shape[1] if heads is None else heads
    s = q.shape[2] if heads is None else q.shape[1]
    kind = "f32" if q.dtype == torch.float32 else "bf16"
    scale = d ** -0.5
    mask = dict(window=window, segment_ids=seg)
    kw = dict(causal=causal, scale=scale, heads=heads, **mask)

    def to4(t):
        return t if heads is None else A._to_bhsd(t, heads, d)

    ref_o, ref_lse = A.attention_lse_reference(to4(q), to4(k), to4(v),
                                               causal=causal, scale=scale,
                                               **mask)
    o = ref_o if heads is None else A._from_bhsd(ref_o, heads).contiguous()
    ref = A.flash_bwd_reference(to4(q), to4(k), to4(v), ref_o, ref_lse,
                                to4(do), causal, scale, **mask)
    keep = sdpa_keep(s, q.device, causal, window, seg)

    def sdpa(q_, k_, v_):
        return F.scaled_dot_product_attention(to4(q_), to4(k_), to4(v_),
                                              attn_mask=keep)

    def sdpa_fwd_bwd(q_, k_, v_, do_):
        leaves = [t.detach().requires_grad_(True) for t in (q_, k_, v_)]
        sdpa(*leaves).backward(to4(do_))

    io, rows_b = nbytes(q), 4 * b * h * s
    f32 = kind == "f32"
    how = "each" if f32 else "tiles"
    gtol = FLASH_F32_TOL if f32 else BWD_BF16_TOL
    rows = {"flash_fwd": [check_kernel(
        "flash_fwd", label,
        lambda *a: (lambda o_, l_: (to4(o_), l_))(
            *A.flash_fwd_exact(*a, **kw)),
        lambda *a: A.attention_lse_reference(*(to4(t) for t in a),
                                             causal=causal, scale=scale,
                                             **mask),
        cold_sets(q, k, v), phase=phase,
        tol=(FLASH_F32_TOL, LSE_F32_TOL) if f32 else (TOL["flash_fwd"],
                                                      LSE_TOL),
        library_fn=sdpa, work=(2 * 2 * d * h * pairs, 4 * io + rows_b,
                               kind),
        flash_route=A.plan_fwd(q.dtype, A.mask_kind(causal, window, seg)))]}
    bsets = cold_sets(q, k, v, o, ref_lse, do)
    plain_ms = cuda_ms(lambda q_, k_, v_, o_, l_, do_: A.flash_bwd_reference(
        *(to4(t) for t in (q_, k_, v_, o_)), l_, to4(do_), causal, scale,
        **mask), bsets, iters=5)
    lib_fwd = cuda_ms(lambda *a: sdpa(*a[:3]), bsets)
    lib_bwd = cuda_ms(lambda *a: sdpa_fwd_bwd(*a[:3], a[5]), bsets) - lib_fwd
    print(f"phase {phase}: flash backward {label}: plain backward (every "
          f"backward kernel's work) {plain_ms:.4f} ms; library SDPA with the "
          f"boolean mask forward {lib_fwd:.4f} ms, backward {lib_bwd:.4f} "
          f"ms (forward + backward less forward)")
    rows["flash_dq"] = [check_kernel(
        "flash_dq", label,
        lambda *a: (lambda dq, de: (to4(dq), de))(*A.flash_dq(*a, **kw)),
        lambda *a: (ref[0], ref[3]), bsets, phase=phase,
        tol=(gtol, DELTA_TOL), how=(how, "each"), plain_ms=plain_ms,
        library_ms=lib_bwd,
        work=(3 * 2 * d * h * pairs, 6 * io + 2 * rows_b, kind),
        flash_route=A.plan_bwd(q.dtype))]
    repeats("flash_dq", bsets[0], kw, phase, label)
    _, delta = A.flash_dq(*bsets[0], **kw)
    dsets = cold_sets(q, k, v, ref_lse, delta, do)
    rows["flash_dkv"] = [check_kernel(
        "flash_dkv", label,
        lambda *a: tuple(to4(t) for t in A.flash_dkv(*a, **kw)),
        lambda *a: (ref[1], ref[2]), dsets, phase=phase, tol=(gtol,) * 2,
        how=(how,) * 2, plain_ms=plain_ms, library_ms=lib_bwd,
        work=(4 * 2 * d * h * pairs, 6 * io + 2 * rows_b, kind),
        flash_route=A.plan_bwd(q.dtype))]
    repeats("flash_dkv", dsets[0], kw, phase, label)
    if dkv_t:
        part = A.flash_bwd_reference(to4(q), to4(k), to4(v), ref_o, ref_lse,
                                     to4(do), causal, scale,
                                     per_query_head=True, **mask)
        rows["flash_dkv_t"] = [check_kernel(
            "flash_dkv_t", label + " (K11: per-head f32 partials)",
            lambda *a: A.flash_dkv_t(*a, causal=causal, scale=scale,
                                     heads=heads, window=window),
            lambda *a: (part[1], part[2]), dsets, phase=phase,
            tol=(gtol,) * 2, how=(how,) * 2, plain_ms=plain_ms,
            library_ms=lib_bwd,
            work=(4 * 2 * d * h * pairs,
                  4 * io + 2 * rows_b + 2 * 4 * b * h * s * d, kind),
            flash_route=A.plan_bwd(q.dtype))]
        repeats("flash_dkv_t", dsets[0], dict(
            causal=causal, scale=scale, heads=heads, window=window), phase,
            label)
        del part
    del ref, bsets, dsets
    torch.cuda.empty_cache()
    return rows


def dkv_t_gqa_row(label, q, k, v, do, *, causal, window, pairs, phase=24):
    """K11 at GQA (``[B, H, S, D]`` q, ``[B, Hkv, S, D]`` k and v) against
    the plain backward's per-head partials, timed beside its bound and the
    plain version (no one PyTorch call takes GQA's k and v as they are:
    no library time), two calls bit-equal, and its group sum against
    K7's."""
    b, h, s, d = q.shape
    kind = "f32" if q.dtype == torch.float32 else "bf16"
    scale = d ** -0.5
    kw = dict(causal=causal, scale=scale, window=window)
    ref_o, ref_lse = A.attention_lse_reference(q, k, v, **kw)
    o = ref_o.contiguous()
    part = A.flash_bwd_reference(q, k, v, o, ref_lse, do, causal, scale,
                                 window=window, per_query_head=True)
    _, delta = A.flash_dq(q, k, v, o, ref_lse, do, **kw)
    dsets = cold_sets(q, k, v, ref_lse, delta, do)
    plain_ms = cuda_ms(lambda q_, k_, v_, l_, de_, do_: A.flash_bwd_reference(
        q_, k_, v_, o, l_, do_, causal, scale, window=window,
        per_query_head=True), dsets[:1], iters=3)
    f32 = kind == "f32"
    row = check_kernel(
        "flash_dkv_t", label + " (K11: per-head f32 partials)",
        lambda *a: A.flash_dkv_t(*a, **kw), lambda *a: (part[1], part[2]),
        dsets, phase=phase,
        tol=((FLASH_F32_TOL,) if f32 else (BWD_BF16_TOL,)) * 2,
        how=("each" if f32 else "tiles",) * 2, plain_ms=plain_ms,
        work=(4 * 2 * d * h * pairs, 2 * nbytes(q) + 2 * nbytes(k)
              + 8 * b * h * s + 2 * 4 * b * h * s * d, kind),
        flash_route=A.plan_bwd(q.dtype))
    repeats("flash_dkv_t", dsets[0], kw, phase, label)
    parts = A.flash_dkv_t(*dsets[0], **kw)
    summed = [A.group_sum(p_, t) for p_, t in zip(parts, (k, v))]
    k7 = A.flash_dkv(*dsets[0], **kw)
    gs = max(rel_l2(a_, b_) for a_, b_ in zip(summed, k7))
    gs_tol = 1e-5 if f32 else 1e-2
    print(f"phase {phase}: flash_dkv_t {label}: group sum against K7's "
          f"dK/dV: rel L2 {gs:.3e} (tol {gs_tol:.0e}: the same products "
          f"summed in another order, rounded once)")
    assert gs <= gs_tol, (label, gs)
    del part, dsets, parts, summed, k7
    torch.cuda.empty_cache()
    return row


def packing_docs():
    """bench_packing's documents: ``(docs, real trainable tokens)``."""
    cfg = PACK["model"]
    rng = np.random.default_rng(0)
    lens = np.clip(rng.geometric(1.0 / PACK["mean_len"], PACK["n_docs"]),
                   8, cfg["max_seq"]).astype(int)
    docs = [list(rng.integers(1, cfg["vocab_size"], int(n))) for n in lens]
    return docs, int(sum(len(x) - 1 for x in docs))


def phase24_masked_kernels(dev):
    """This slice's kernels at its shapes against their plain versions:
    K5/K6/K7 and K11 windowed at the windowed model's training shape (and
    non-causal windowed in f32 and bf16 at a small one), K5/K6/K7 in bf16
    non-causal and at ragged S, K5/K6/K7 with segment ids at
    bench_packing's packed batch, and K10 at the 170M shape raced against
    K6 + K7 and SDPA's backward."""
    gen = torch.Generator().manual_seed(SEED)
    bf = torch.bfloat16
    rows = {}

    def randn(*shape, dtype=bf):
        return torch.randn(*shape, generator=gen).to(dtype).to(dev)

    b, h, s = WTRAIN["batch"], WMODEL["num_heads"], WMODEL["max_seq"]
    d, w = WMODEL["dim"] // h, WMODEL["window"]
    q, k, v, do = (randn(b, s, h * d) for _ in range(4))     # MHA's layout
    win = masked_flash_rows(
        f"bf16 B={b} H={h} S={s} D={d} causal window {w} bshd", q, k, v, do,
        heads=h, causal=True, window=w, seg=None,
        pairs=b * band_pairs(s, True, w), dkv_t=True)
    q, k, v, do = (randn(1, 4, 1024, 64, dtype=torch.float32)
                   for _ in range(4))
    small = masked_flash_rows(
        "f32 B=1 H=4 S=1024 D=64 non-causal window 256 bhsd", q, k, v, do,
        heads=None, causal=False, window=256, seg=None,
        pairs=band_pairs(1024, False, 256), dkv_t=True)
    for name, r in small.items():
        win[name] += r
    # K11 at GQA, 8 query heads on 2 KV heads, in bf16 (a causal window of
    # 512 at D 128) and f32 (non-causal, window 256, D 64)
    for label, dtype, s_, d_, causal, window in (
            ("bf16 B=1 H=8 Hkv=2 S=2048 D=128 causal window 512 bhsd",
             bf, 2048, 128, True, 512),
            ("f32 B=1 H=8 Hkv=2 S=1024 D=64 non-causal window 256 bhsd",
             torch.float32, 1024, 64, False, 256)):
        q, do = (randn(1, 8, s_, d_, dtype=dtype) for _ in range(2))
        k, v = (randn(1, 2, s_, d_, dtype=dtype) for _ in range(2))
        win["flash_dkv_t"].append(dkv_t_gqa_row(
            label, q, k, v, do, causal=causal, window=window,
            pairs=band_pairs(s_, causal, window)))
    # K5 in bf16 (wgmma) without causality, windowed at the f32 row's
    # shape and unmasked at an S that is not a multiple of 128, and under
    # a window and causality at a ragged S in [B, S, H*D]
    for label, shape, heads, causal, window in (
            ("bf16 B=1 H=4 S=1024 D=64 non-causal window 256 bhsd",
             (1, 4, 1024, 64), None, False, 256),
            ("bf16 B=1 H=8 S=1000 D=128 non-causal bhsd", (1, 8, 1000, 128),
             None, False, None),
            ("bf16 B=2 H=8 S=1000 D=64 causal window 300 bshd",
             (2, 1000, 512), 8, True, 300)):
        q, k, v, do = (randn(*shape) for _ in range(4))
        s_ = shape[2] if heads is None else shape[1]
        extra = masked_flash_rows(
            label, q, k, v, do, heads=heads, causal=causal, window=window,
            seg=None, pairs=shape[0] * band_pairs(s_, causal, window))
        for name, r in extra.items():
            win[name] += r
    rows["train_window"] = win

    cfg = PACK["model"]
    packed = pack_documents(packing_docs()[0], cfg["max_seq"])
    seg = torch.from_numpy(packed["segment_ids"]).to(dev)
    b, h, s = seg.shape[0], cfg["num_heads"], cfg["max_seq"]
    d = cfg["dim"] // h
    q, k, v, do = (randn(b, h, s, d) for _ in range(4))  # MHA's layout, D 64
    rows["train_packed"] = masked_flash_rows(
        f"bf16 B={b} H={h} S={s} D={d} causal, bench_packing's segment ids "
        f"bhsd", q, k, v, do, heads=None, causal=True, window=None, seg=seg,
        pairs=segment_pairs(packed["segment_ids"], True))
    del q, k, v, do
    torch.cuda.empty_cache()
    # the padded batch of the same documents (one a row, plain causal,
    # [B, H, S, D] at D 64): K8 on both arms, K6 and K7 with SDPA beside
    padded = lm_flash_rows(dev, len(packing_docs()[0]), h, s, d,
                           torch.bfloat16, 24, gen, ("bhsd",),
                           ("bound", "bound_off"))
    for name, r in padded.items():
        rows["train_packed"][name] = rows["train_packed"].get(name, []) + r
    del padded
    torch.cuda.empty_cache()

    # K10 against K6 + K7 at the 170M shape: the race ROADMAP asks for
    b, h, s = LM_BATCH, LM["num_heads"], LM["max_seq"]
    d = LM["dim"] // h
    q, k, v, do = (randn(b, s, h * d) for _ in range(4))
    scale = d ** -0.5

    def to4(t):
        return A._to_bhsd(t, h, d)

    ref_o, ref_lse = A.attention_lse_reference(to4(q), to4(k), to4(v),
                                               causal=True, scale=scale)
    ref = A.flash_bwd_reference(to4(q), to4(k), to4(v), ref_o, ref_lse,
                                to4(do), True, scale)
    o = A._from_bhsd(ref_o, h).contiguous()
    bsets = cold_sets(q, k, v, o, ref_lse, do)
    plain_ms = cuda_ms(lambda q_, k_, v_, o_, l_, do_: A.flash_bwd_reference(
        *(to4(t) for t in (q_, k_, v_, o_)), l_, to4(do_), True, scale),
        bsets, iters=5)
    split_ms = cuda_ms(lambda *a: A.flash_bwd(*a, causal=True, scale=scale,
                                              heads=h), bsets)

    def sdpa(q_, k_, v_):
        return F.scaled_dot_product_attention(to4(q_), to4(k_), to4(v_),
                                              is_causal=True)

    def sdpa_fwd_bwd(q_, k_, v_, do_):
        leaves = [t.detach().requires_grad_(True) for t in (q_, k_, v_)]
        sdpa(*leaves).backward(to4(do_))

    lib_fwd = cuda_ms(lambda *a: sdpa(*a[:3]), bsets)
    lib_bwd = cuda_ms(lambda *a: sdpa_fwd_bwd(*a[:3], a[5]), bsets) - lib_fwd
    io, rows_b = nbytes(q), 4 * b * h * s
    fused = check_kernel(
        "flash_bwd_fused", f"bf16 B={b} H={h} S={s} D={d} causal bshd",
        lambda *a: (lambda dq, dk, dv, de: (to4(dq), to4(dk), to4(dv), de))(
            *A.flash_bwd_fused(*a, causal=True, scale=scale, heads=h)),
        lambda *a: ref, bsets, tol=(BWD_BF16_TOL,) * 3 + (DELTA_TOL,),
        how=("tiles",) * 3 + ("each",), phase=24, plain_ms=plain_ms,
        library_ms=lib_bwd,
        work=(5 * 2 * b * h * d * s * (s + 1) // 2, 8 * io + 2 * rows_b,
              "bf16"), flash_route=A.plan_bwd(bf))
    winner = "K10" if fused["ms"] < split_ms else "K6 + K7"
    print(f"phase 24: the race at the 170M shape (bf16 B={b} H={h} S={s} "
          f"D={d} causal bshd): K10 {fused['ms']:.4f} ms against K6 + K7 "
          f"{split_ms:.4f} ms and SDPA's backward {lib_bwd:.4f} ms; faster: "
          f"{winner}; card clocks {card_clocks()}")
    fused["split_ms"] = split_ms
    rows["train_lm_fused"] = {"flash_bwd_fused": [fused]}
    del q, k, v, do, ref, bsets
    torch.cuda.empty_cache()
    return rows


def worst_rel(g, g_ref):
    rel = {k: rel_l2(g[k], g_ref[k]) for k in g_ref}
    worst = max(rel, key=rel.get)
    return rel[worst], worst, float(np.median(list(rel.values())))


def timed_steps(step, warmup, steps):
    """``warmup`` then ``steps`` timed steps with the launch counts reset
    just before them: ``(s/step, losses of all steps, counts)``."""
    losses = [step() for _ in range(warmup)]
    torch.cuda.synchronize()
    backend.reset_launch_counts()
    t0 = time.perf_counter()
    losses += [step() for _ in range(steps)]
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    counts = backend.launch_counts()
    losses = torch.stack(losses).tolist()
    assert all(math.isfinite(x) for x in losses), losses
    return step_s, losses, counts


def train_step(model, opt, *batch, **kw):
    def step():
        loss, _ = model.loss(*batch, **kw)
        opt.zero_grad()
        loss.backward()
        opt.step()
        return loss.detach()
    return step


def phase25_packed_training(dev, smi):
    """bench_packing's configuration on the card: one packed step against
    the CPU, a packed document against itself alone, then the padded and
    the packed step timed in real tokens/s with exact launch counts."""
    cfg, S = PACK["model"], PACK["model"]["max_seq"]
    docs, real = packing_docs()
    packed = pack_documents(docs, S)
    n = len(docs)
    pad = {name: np.zeros((n, S), dt) for name, dt in (
        ("tokens", np.int64), ("targets", np.int64),
        ("loss_mask", np.float32))}
    for i, x in enumerate(docs):
        pad["tokens"][i, :len(x)] = x
        pad["targets"][i, :len(x) - 1] = x[1:]
        pad["loss_mask"][i, :len(x) - 1] = 1.0

    def batch(arrays, rows=slice(None), device=dev):
        t = {k: torch.from_numpy(np.ascontiguousarray(v[rows])).to(device)
             for k, v in arrays.items()}
        args = (t["tokens"].long(), t["targets"].long(), t["loss_mask"])
        extra = ({} if "segment_ids" not in t else
                 dict(segment_ids=t["segment_ids"],
                      positions=t["positions"]))
        return args, extra

    cpu = TinyGPT(**cfg)
    cpu.reset_parameters(torch.Generator().manual_seed(SEED))
    # one packed step (its first rows), card bf16 trunk against CPU f32
    rows = slice(0, PACK["cpu_rows"])
    args, extra = batch(packed, rows, "cpu")
    t0 = time.perf_counter()
    loss_ref, g_ref = lm_grads(cpu, *args, **extra)
    cpu_s = time.perf_counter() - t0
    card = copy.deepcopy(cpu).to(dev)
    card.compute_dtype = torch.bfloat16
    args, extra = batch(packed, rows)
    loss, g = lm_grads(card, *args, **extra)
    loss_rel = abs(loss - loss_ref) / abs(loss_ref)
    rel, worst, med = worst_rel(g, g_ref)
    print(f"phase 25: one packed step ({PACK['cpu_rows']} packed rows x {S},"
          f" segment ids and positions), card bf16 trunk vs cpu f32 "
          f"({cpu_s:.1f} s on the cpu): loss {loss:.6f} vs {loss_ref:.6f}, "
          f"rel err {loss_rel:.3e} (tol {LM_BF16_LOSS_TOL:.0e}); grads rel "
          f"L2 max {rel:.3e} at {worst}, median {med:.3e} (tol "
          f"{LM_BF16_GRAD_TOL:.0e})")
    assert all(torch.isfinite(x).all() for x in g.values())
    assert loss_rel <= LM_BF16_LOSS_TOL and rel <= LM_BF16_GRAD_TOL

    # packed row 0 against its documents alone, one per row, in f32 on the
    # card (segment ids and positions against plain causal rows)
    f32 = copy.deepcopy(cpu).to(dev)
    seg0 = packed["segment_ids"][0]
    ids = [i for i in np.unique(seg0) if i > 0]
    starts = [int(np.argmax(seg0 == i)) for i in ids]
    lens = [int((seg0 == i).sum()) for i in ids]
    alone = np.zeros((len(ids), max(lens)), np.int64)
    for r, (a, m) in enumerate(zip(starts, lens)):
        alone[r, :m] = packed["tokens"][0, a:a + m]
    args, extra = batch(packed, slice(0, 1))
    with torch.no_grad():
        lp = f32(args[0], **extra)[0]
        la = f32(torch.from_numpy(alone).to(dev))
    worst_doc = max(rel_l2(lp[a:a + m].cpu(), la[r, :m].cpu())
                    for r, (a, m) in enumerate(zip(starts, lens)))
    print(f"phase 25: packed row 0 ({len(ids)} documents of {lens} tokens) "
          f"against the same documents alone, one per row, f32 on the card: "
          f"logits rel L2 worst document {worst_doc:.3e} (tol "
          f"{PACKED_ALONE_TOL:.0e})")
    assert worst_doc <= PACKED_ALONE_TOL
    del f32, card, cpu
    torch.cuda.empty_cache()

    model = TinyGPT(**cfg, compute_dtype=torch.bfloat16)
    model.reset_parameters(torch.Generator().manual_seed(SEED))
    model.to(dev)
    opt = optim.Adam(PACK["lr"]).init(model.parameters())
    out, counts_all = {}, {}
    for name, arrays, want in (("padded", pad, PADDED_PER_STEP),
                               ("packed", packed, PACKED_PER_STEP)):
        args, extra = batch(arrays)
        step_s, losses, counts = timed_steps(
            train_step(model, opt, *args, **extra), PACK["warmup"],
            PACK["steps"])
        routes = per_step(flash_only(backend.route_counts()), PACK["steps"])
        out[name] = dict(step_ms=step_s * 1e3, real_tokens_s=real / step_s,
                         rows=args[0].shape[0], losses=losses,
                         per_step=per_step(counts, PACK["steps"]),
                         routes=routes)
        for k_, c in counts.items():
            counts_all[k_] = counts_all.get(k_, 0) + c
        print(f"phase 25: {name} step ({args[0].shape[0]} rows x {S}, "
              f"{real} real tokens): {step_s * 1e3:.2f} ms/step, "
              f"{real / step_s:.0f} real tokens/s; loss per step {losses}; "
              f"launches per step {out[name]['per_step']}; flash calls per "
              f"step by route {routes}; on {smi}")
        assert out[name]["per_step"] == want, (name, counts)
        assert routes == flash_routes(
            cfg["depth"], torch.bfloat16,
            "segments" if extra else "causal"), (name, routes)
    ratio = out["packed"]["real_tokens_s"] / out["padded"]["real_tokens_s"]
    print(f"phase 25: packed / padded real tokens/s: {ratio:.3f} (packing "
          f"efficiency {packing_efficiency(packed):.4f})")
    out["ratio"] = ratio
    del model, opt
    torch.cuda.empty_cache()
    return counts_all, out


# phase 26's profile: the flash forward (K5, K8) apart from the backward
# (K6, K7, K11), whose kernels share one design in both models
ATTN_FAMILIES = (("attention forward", "flash_fwd_f32"),
                 ("attention forward", "sm90::fwd_kernel"),
                 ("attention backward", "flash")) + K1_FAMILIES + (
                     OPT_FAMILY,)


def phase26_window_training(dev, smi):
    """The windowed model trained at batch 2 x 4096: ms/step, tokens/s and
    MFU over the band's FLOPs, the same with K11, a profile against the
    full-causal model, and one step against the CPU."""
    gen = torch.Generator().manual_seed(SEED)
    model = TinyGPT(**WMODEL, compute_dtype=torch.bfloat16)
    model.reset_parameters(gen)
    model.to(dev)
    n_params = sum(p.numel() for p in model.parameters())
    b, s, w = WTRAIN["batch"], WMODEL["max_seq"], WMODEL["window"]
    toks = torch.randint(0, WMODEL["vocab_size"], (b, s), generator=gen
                         ).to(dev)
    batch = (toks, toks.roll(-1, 1), torch.ones(s, device=dev))
    opt = optim.Adam(WTRAIN["lr"]).init(model.parameters())
    step = train_step(model, opt, *batch)
    tokens = b * s
    pairs = band_pairs(s, True, w)
    # bench.py:185-186's model FLOPs with the band's pairs in place of
    # causal attention's S^2 / 2: 3 (2 P T + depth 4 B pairs dim)
    flops = 3 * (2 * n_params * tokens
                 + WMODEL["depth"] * 4 * b * pairs * WMODEL["dim"])
    runs, counts_all = {}, {}
    for name, flag, want in (("K7", None, WINDOW_PER_STEP),
                             ("K11", "TAPER_ATTN_DKV_T",
                              WINDOW_DKV_T_PER_STEP)):
        with env_flag(flag):
            step_s, losses, counts = timed_steps(step, WTRAIN["warmup"],
                                                 WTRAIN["steps"])
        routes = per_step(flash_only(backend.route_counts()),
                          WTRAIN["steps"])
        runs[name] = dict(step_ms=step_s * 1e3, tokens_s=tokens / step_s,
                          mfu=flops / step_s / PEAK_FLOPS["bf16"],
                          losses=losses)
        for k_, c in counts.items():
            counts_all[k_] = counts_all.get(k_, 0) + c
        print(f"phase 26: windowed TinyGPT ({n_params / 1e6:.1f}M params, "
              f"window {w}, bf16, batch {b} x {s}, Adam({WTRAIN['lr']})), "
              f"dK/dV by {name}: {step_s * 1e3:.1f} ms/step, "
              f"{tokens / step_s:.0f} tokens/s, model FLOPs {flops:.3e}/step "
              f"(3 (2 P T + depth 4 B pairs dim), {pairs} live pairs a row "
              f"of heads) = {runs[name]['mfu']:.4f} of 989 TFLOP/s; loss per "
              f"step {losses}; launches per step "
              f"{per_step(counts, WTRAIN['steps'])}; flash calls per step by "
              f"route {routes}; on {smi}")
        assert per_step(counts, WTRAIN["steps"]) == {
            k_: c for k_, c in want.items() if c}, counts
        assert routes == flash_routes(
            WMODEL["depth"], torch.bfloat16, "window",
            "dkv_t" if flag else "split"), routes
    # the two backwards on the same weights (after both runs' updates)
    with env_flag("TAPER_ATTN_DKV_T"):
        g11 = lm_grads(model, *batch)[1]
    g7 = lm_grads(model, *batch)[1]
    rel, worst, med = worst_rel(g11, g7)
    print(f"phase 26: one step's gradients with K11 against K7, same weights"
          f" and tokens: rel L2 max {rel:.3e} at {worst}, median {med:.3e} "
          f"(tol {BWD_BF16_TOL:.0e})")
    assert rel <= BWD_BF16_TOL
    prof_w = profile_steps(step, 1, ATTN_FAMILIES)
    del opt, step
    torch.cuda.empty_cache()
    full = TinyGPT(**MODEL, compute_dtype=torch.bfloat16)
    full.load_state_dict(model.state_dict())
    del model
    torch.cuda.empty_cache()
    full.to(dev)
    fopt = optim.Adam(WTRAIN["lr"]).init(full.parameters())
    fstep = train_step(full, fopt, *batch)
    fstep()
    prof_f = profile_steps(fstep, 1, ATTN_FAMILIES)
    del full, fopt, fstep
    torch.cuda.empty_cache()
    fam = ("attention forward", "attention backward")
    print(f"phase 26: one profiled step, windowed vs full causal at the same "
          f"shape: attention kernels forward, backward "
          f"{[round(prof_w['ms'].get(f, 0), 3) for f in fam]} vs "
          f"{[round(prof_f['ms'].get(f, 0), 3) for f in fam]} ms of device; "
          f"busy {prof_w['busy_ms']:.1f} vs {prof_f['busy_ms']:.1f} ms of "
          f"{prof_w['wall_ms']:.1f} vs {prof_f['wall_ms']:.1f} ms wall; by "
          f"family {prof_w['ms']} vs {prof_f['ms']}")
    # the band: the windowed attention, forward and backward, costs less
    # device time than the full-causal model's at the same shape (K5 and
    # K8 both on wgmma)
    attn_w, attn_f = (sum(p["ms"].get(f, 0) for f in fam)
                      for p in (prof_w, prof_f))
    print(f"phase 26: attention forward + backward a step, windowed vs full "
          f"causal: {attn_w:.3f} vs {attn_f:.3f} ms of device")
    assert attn_w < attn_f, (attn_w, attn_f)
    # the windowed backward (K6 and K7 visit the window's tiles only)
    # costs less than the full-causal one, both on their wgmma kernels
    assert prof_w["ms"]["attention backward"] < prof_f["ms"][
        "attention backward"]
    # and the windowed forward less than a full-causal forward on the same
    # kernel: K5 runs the whole triangle (no window) on the same inputs
    h, d = WMODEL["num_heads"], WMODEL["dim"] // WMODEL["num_heads"]
    fsets = cold_sets(*(torch.randn(b, s, h * d, generator=gen).to(
        torch.bfloat16).to(dev) for _ in range(3)))
    k5_ms = {}
    for name, win in (("window", w), ("full causal", None)):
        def k5(q_, k_, v_, win=win):
            return A.flash_fwd_exact(q_, k_, v_, causal=True,
                                     scale=d ** -0.5, heads=h, window=win)
        k5_ms[name] = cuda_ms(k5, fsets)
    del fsets
    print(f"phase 26: K5 at batch {b} x {s}, window {w} against the full "
          f"causal triangle, same inputs: {k5_ms['window']:.4f} vs "
          f"{k5_ms['full causal']:.4f} ms ({pairs} vs "
          f"{band_pairs(s, True, None)} live pairs a row of heads); on "
          f"{smi}")
    assert k5_ms["window"] < k5_ms["full causal"], k5_ms

    # one step at batch 1 against the CPU, depth cut to 2 (the CPU's time)
    cfg = dict(WMODEL, depth=WTRAIN["cpu_depth"])
    cpu = TinyGPT(**cfg)
    cpu.reset_parameters(torch.Generator().manual_seed(SEED))
    one = tuple(t[:1].cpu() if t.dim() == 2 else t.cpu() for t in batch)
    t0 = time.perf_counter()
    loss_ref, g_ref = lm_grads(cpu, *one)
    cpu_s = time.perf_counter() - t0
    card = copy.deepcopy(cpu).to(dev)
    card.compute_dtype = torch.bfloat16
    loss, g = lm_grads(card, *(t.to(dev) for t in one))
    del card, cpu
    torch.cuda.empty_cache()
    loss_rel = abs(loss - loss_ref) / abs(loss_ref)
    rel, worst, med = worst_rel(g, g_ref)
    print(f"phase 26: one windowed step at batch 1 x {s}, depth "
          f"{cfg['depth']} (cut from {WMODEL['depth']} for the cpu's time, "
          f"{cpu_s:.1f} s), card bf16 trunk vs cpu f32: loss rel err "
          f"{loss_rel:.3e} (tol {LM_BF16_LOSS_TOL:.0e}); grads rel L2 max "
          f"{rel:.3e} at {worst}, median {med:.3e} (tol "
          f"{LM_BF16_GRAD_TOL:.0e})")
    assert loss_rel <= LM_BF16_LOSS_TOL and rel <= LM_BF16_GRAD_TOL
    runs["profile"] = dict(window=prof_w, full=prof_f)
    runs["k5_ms"] = k5_ms
    return counts_all, runs


class env_flag:
    """Sets the environment flag ``name`` to "1" inside the block (None:
    nothing), as a user would before a run."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        if self.name:
            os.environ[self.name] = "1"

    def __exit__(self, *exc):
        if self.name:
            os.environ.pop(self.name)


def window_model(dev):
    model = TinyGPT(**WMODEL)
    model.reset_parameters(torch.Generator().manual_seed(SEED))
    model.eval()
    model = model.to(dev).cast_projections(torch.bfloat16)
    model.compute_dtype = torch.bfloat16
    return model


def phase27_window_decode(dev, smi):
    """bench_serving.py:323-340's three contenders: a 1024-token prompt
    (longer than the window, so the ring wraps in the prefill), then
    greedy decode steps through the bf16 full cache, the bf16 ring and
    the int8 ring (the int8 full cache as the int8 ring's reference),
    with every step's tokens from the bf16 full cache; and the windowed
    model through the contiguous engine."""
    model = window_model(dev)
    b, p, n = WDECODE["batch"], WDECODE["prompt"], WDECODE["steps"]
    gen = torch.Generator().manual_seed(SEED)
    prompt = torch.randint(0, WMODEL["vocab_size"], (b, p),
                           generator=gen).to(dev)
    out, counts_all, feed = {}, {}, None
    for name, kw in (("full_bf16", dict(dtype=torch.bfloat16)),
                     ("ring_bf16", dict(dtype=torch.bfloat16, ring=True)),
                     ("full_int8", dict(quantized=True)),
                     ("ring_int8", dict(quantized=True, ring=True))):
        caches = model.init_cache(b, **kw)
        with torch.no_grad():
            torch.cuda.synchronize()
            backend.reset_launch_counts()
            pre = model.prefill(prompt, caches)
            tok = pre[:, -1].argmax(-1) if feed is None else feed[0]
            torch.cuda.synchronize()
            pre_counts = backend.launch_counts()
            logits = []
            t0 = time.perf_counter()
            for i in range(n):
                lg = model.decode_step(tok, p + i, caches)
                logits.append(lg)
                tok = lg.argmax(-1) if feed is None else feed[i + 1]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = backend.launch_counts()
            prof = decode_profile(lambda: model.decode_step(tok, p + n,
                                                            caches), 2)
        if feed is None:
            feed = [pre[:, -1].argmax(-1)] + [x.argmax(-1) for x in logits]
        dec = {k_: c - pre_counts[k_] for k_, c in counts.items()}
        for k_, c in counts.items():
            counts_all[k_] = counts_all.get(k_, 0) + c
        per = {k_: c / n for k_, c in dec.items() if c}
        cache_bytes = sum(nbytes(*c.values()) for c in caches)
        out[name] = dict(tokens_s=b * n / wall, step_ms=wall / n * 1e3,
                         busy_ms=prof["busy_ms"], cache_bytes=cache_bytes,
                         logits=torch.stack(logits).float(),
                         prefill=pre[:, -1].float())
        launched = {k_: c for k_, c in pre_counts.items() if c}
        print(f"phase 27: {name}: prefill {b} x {p} (launches {launched}), "
              f"then {n} "
              f"decode steps in {wall:.3f} s: {b * n / wall:.1f} tokens/s, "
              f"{wall / n * 1e3:.2f} ms a step, {prof['busy_ms']:.3f} ms of "
              f"device busy a step (profiled), cache {cache_bytes} bytes; "
              f"launches per decode step {per}; on {smi}")
        assert pre_counts["flash_fwd"] == WMODEL["depth"], pre_counts
        assert pre_counts["flash_fwd_bound"] == 0, pre_counts
        assert per == CONTIG_PER_STEP, per
        assert torch.isfinite(out[name]["logits"]).all()
        del caches
    for ring, ref, tol in (("ring_bf16", "full_bf16", RING_TOL),
                           ("ring_int8", "full_int8",
                            INT8_PAGED_VS_CONTIG_TOL)):
        rels = [rel_l2(x.cpu(), y.cpu()) for x, y in
                zip(out[ring]["logits"], out[ref]["logits"])]
        pre_rel = rel_l2(out[ring]["prefill"].cpu(),
                         out[ref]["prefill"].cpu())
        print(f"phase 27: {ring} against {ref}: prefill logits rel L2 "
              f"{pre_rel:.3e}; decode logits rel L2 worst step "
              f"{max(rels):.3e} (step {int(np.argmax(rels))}), median "
              f"{float(np.median(rels)):.3e} (tol {tol:.0e} every step)")
        assert pre_rel <= tol and max(rels) <= tol, ring
    int8_vs_bf16 = max(rel_l2(x.cpu(), y.cpu()) for x, y in zip(
        out["ring_int8"]["logits"], out["full_bf16"]["logits"]))
    print(f"phase 27: ring_int8 against full_bf16 (information): worst step "
          f"rel L2 {int8_vs_bf16:.3e}")
    for r in out.values():
        del r["logits"], r["prefill"]
    torch.cuda.empty_cache()

    # the windowed model through the contiguous engine
    reqs = requests()[:WDECODE["requests"]]
    eng = ServingEngine(model, pool_blocks=None, seed=SEED, **ENGINE)
    ids = [eng.submit(pr, m, **sm) for pr, m, sm in reqs]
    torch.cuda.synchronize()
    backend.reset_launch_counts()
    t0 = time.perf_counter()
    res = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = backend.launch_counts()
    st = eng.stats()
    for rid, (_, m, _) in zip(ids, reqs):
        assert len(res[rid]) == m, (rid, len(res[rid]), m)
    assert st["completed"] == len(reqs), st
    assert counts["flash_fwd"] == WMODEL["depth"] * st["admitted"], counts
    assert counts["flash_fwd_bound"] == 0, counts
    gen_tokens = sum(m for _, m, _ in reqs)
    launched = {k_: c for k_, c in counts.items() if c}
    print(f"phase 27: the windowed model through the contiguous engine: "
          f"{len(reqs)} requests completed ({st['decode_blocks']} decode "
          f"blocks) in {wall:.2f} s, {gen_tokens / wall:.1f} generated "
          f"tokens/s; launches {launched}")
    for k_, c in counts.items():
        counts_all[k_] = counts_all.get(k_, 0) + c
    out["engine"] = dict(wall_s=wall, tokens_s=gen_tokens / wall)
    del eng, model
    release()
    return counts_all, out


def card_clocks():
    """The card's SM clock, its maximum, power draw and temperature as
    nvidia-smi reads them now (printed beside timings: a card that runs
    below its clock makes every time of the run longer)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"], capture_output=True,
        text=True, check=True, timeout=60).stdout.strip()


def phase28_fused_backward(dev, smi, lm):
    """The 170M step of phase 11 (its model and tokens) with
    TAPER_ATTN_FUSED_BWD=1 against the split backward, timed in turns
    (K10, K6 + K7, K6 + K7, K10; LM_STEPS / 2 steps each) so that a drift
    of the card's clock falls on both, each backward's ms/step the
    faster of its two rounds (a host stall, such as a garbage collection,
    lengthens one round): 12 K10 calls and no K6/K7 a step, and one
    step's gradients against the split backward's on the same weights."""
    model, step, batch = lm.pop("state")
    with env_flag("TAPER_ATTN_FUSED_BWD"):
        losses = [float(step()) for _ in range(LM_WARMUP)]
    times, counts, routes = {}, {}, {}
    for name, flag in (("K10", "TAPER_ATTN_FUSED_BWD"), ("K6 + K7", None),
                       ("K6 + K7", None), ("K10", "TAPER_ATTN_FUSED_BWD")):
        with env_flag(flag):
            step_s, ls, c = timed_steps(step, 0, LM_STEPS // 2)
        times.setdefault(name, []).append(step_s * 1e3)
        counts[name] = {k_: counts.get(name, {}).get(k_, 0) + n
                        for k_, n in c.items()}
        r = routes.setdefault(name, {})
        for k_, n in flash_only(backend.route_counts()).items():
            r[k_] = r.get(k_, 0) + n
        losses += ls
    with env_flag("TAPER_ATTN_FUSED_BWD"):
        g10 = lm_grads(model, *batch)[1]
    g67 = lm_grads(model, *batch)[1]
    per = {name: per_step(c, LM_STEPS) for name, c in counts.items()}
    ms = {name: min(t) for name, t in times.items()}
    rel, worst, med = worst_rel(g10, g67)
    winner = min(ms, key=ms.get)
    print(f"phase 28: the 170M step, K10 (TAPER_ATTN_FUSED_BWD=1) and K6 + "
          f"K7 in turns: {ms['K10']:.1f} against {ms['K6 + K7']:.1f} "
          f"ms/step (rounds {times}; faster: {winner}; phase 11's split "
          f"run {lm['step_ms']:.1f}); loss per step {losses}; launches per "
          f"step {per}; one step's gradients K10 vs K6 + K7 on the same "
          f"weights: rel L2 max {rel:.3e} at {worst}, median {med:.3e} (tol "
          f"{BWD_BF16_TOL:.0e}); card clocks {card_clocks()}; on {smi}")
    assert per["K10"] == LM_FUSED_PER_STEP, counts
    assert per["K6 + K7"] == LM_PER_STEP, counts
    want = {"K6 + K7": flash_routes(LM["depth"], torch.bfloat16, "causal"),
            "K10": flash_routes(LM["depth"], torch.bfloat16, "causal",
                                backward="fused")}
    got = {name: per_step(r, LM_STEPS) for name, r in routes.items()}
    print(f"phase 28: flash calls per step by route {got} (plan: {want})")
    assert got == want, (got, want)
    assert all(math.isfinite(x) for x in losses), losses
    assert rel <= BWD_BF16_TOL
    del model, step, batch
    torch.cuda.empty_cache()
    return counts["K10"], dict(step_ms=ms, winner=winner)


# -- the rest of the training step: fused loss, remat, dropout, MoE, the
# other optimizers (phases 30-32) ---------------------------------------------

# Phase 30: the 170M model at batch 16 x 2048, past JAX's naive-loss limit
# (B S V = 2^29 > 2^28), so TinyGPT.loss takes the fused vocab-chunked
# loss; remat, dropout 0.1, z-loss 1e-4, AdamW with clip_grad_norm(1.0)
# and a warmup-cosine lr stepped every step, an EMA updated every step.
LONG = dict(batch=16, dropout=0.1, z_loss=1e-4, lr=1e-4, wd=0.1, warmup=2,
            steps=6, clip=1.0, ema=0.999)
# remat recomputes each block's forward in the backward: 72 K1 nt and 12
# K8 launches again a step
LONG_PER_STEP = dict(linear=144, gemm_nn=72, gemm_tn=72, flash_fwd_bound=24,
                     flash_dq=12, flash_dkv=12, adam=1)
# the loss branches timed against each other (item 3 of the slice), per
# batch: 1 warm-up and 3 timed plain AdamW steps each (no remat, dropout
# off)
BRANCH_STEPS = 3
# Fused against naive on the card.  The loss op on the same f32 hidden
# states and head: both branches compute f32 logits by cuBLAS f32 (TF32
# off) and reduce them in other orders, so nll and lse are held to 1e-5 (1
# + |ref|) and dx, dhead to 1e-5 relative L2.  The model's loss to 1e-5
# relative; its gradients per leaf to LM_BF16_GRAD_TOL: the two dx differ
# in f32 rounding, which flips some bf16 roundings of the trunk's
# cotangent at the final norm (2^-8 each), carried through 12 blocks.
FUSED_OP_TOL, FUSED_LOSS_TOL = 1e-5, 1e-5
# Phase 31: every FFN of the 170M model swapped for bench_moe.py:29-37's
# routing (8 experts, top-2, capacity factor 1.25; ~0.87B parameters,
# ~14 GB of f32 weights, gradients and Adam moments), batch 8 x 2048:
# C = ceil(2 * 16384 / 8 * 1.25) = 5,120 tokens an expert.  Sparse with
# nothing dropped against dense, one full-width MoE layer on 1 x 2048
# bf16 inputs (through the whole model the two modes part: a last-bit
# difference upstream moves a token whose second and third gate logits
# nearly tie to another expert).  The same routing and the same per-row
# products: the output to one bf16 ulp (8e-3 (|ref| + 1e-3), as K16's
# bf16 rows); the gradients to 1e-2 relative L2 each, the weight
# gradients summing the same rows in another order in f32 before their
# bf16 rounding.
MOE = dict(n_experts=8, top_k=2, capacity_factor=1.25, batch=8, warmup=2,
           steps=5, check_batch=1)
MOE_OUT_TOL, MOE_GRAD_TOL = 8e-3, 1e-2
# 4 attention projections and 8 experts x 2 products a layer
MOE_PER_STEP = dict(linear=240, gemm_nn=240, gemm_tn=240,
                    flash_fwd_bound=12, flash_dq=12, flash_dkv=12, adam=1)
# Phase 32: the 170M at 8 x 2048 through Lion, Muon and Adafactor at
# examples/train_tinylm.py's default lr (plain PyTorch updates: no K17)
OPTS = dict(warmup=1, steps=3)
OPTS_PER_STEP = {k: v for k, v in LM_PER_STEP.items() if k != "adam"}
# the sort task's short runs through train_tinylm (phase 12): the mean
# loss of the last 20 steps under that of the first 20
SORT_SHORT = 200
SORT_OPTS_PER_STEP = {k: v for k, v in SORT_PER_STEP.items() if k != "adam"}
SORT_MOE_PER_STEP = dict(SORT_PER_STEP, linear=24, gemm_nn=24, gemm_tn=24)


def lm_flops(n_params, batch, s=LM["max_seq"]):
    """Model FLOPs of one 170M-width step as bench.py:185-186 counts
    them: 6 P T plus causal attention (a recompute is not model work)."""
    return 3 * (2 * n_params * batch * s + LM["depth"] * 4 * batch * s ** 2
                * LM["dim"] * 0.5)


def lm_products(tokens, experts=None):
    """A layer's K1 products ``(t, K_in, N_out)``: the four attention
    projections and the FFN's two, or each expert's two at its
    capacity ``experts = (n, C)``."""
    e = LM["dim"]
    ffn = ((tokens, e, 4 * e), (tokens, 4 * e, e))
    if experts is not None:
        n, cap = experts
        ffn = ((cap, e, 4 * e), (cap, 4 * e, e)) * n
    return ((tokens, e, e),) * 4 + ffn


def lm_step_routes(products, remat=False):
    """K1's and the flash kernels' calls a 170M-width step makes by route,
    as the plans predict them; remat runs each layer's forward twice."""
    want = {k: v * LM["depth"]
            for k, v in planned_routes(products, torch.bfloat16).items()}
    fwd = flash_routes(LM["depth"], torch.bfloat16, "causal")
    if remat:
        for t, k_in, n_out in products:
            route, splits = plan(t, n_out, k_in, torch.bfloat16, "nt", True)
            key = route_key(route, "nt", splits)
            want[key] += LM["depth"]
        key = next(k for k in fwd if "flash_fwd" in k)
        fwd[key] *= 2
    want.update(fwd)
    return want


def lm_model(dev, **kw):
    """The 170M-width TinyGPT (bf16 trunk) drawn from SEED on the CPU,
    then moved to ``dev``."""
    model = TinyGPT(**LM, compute_dtype=torch.bfloat16, **kw)
    model.reset_parameters(torch.Generator().manual_seed(SEED))
    return model.to(dev)


def lm_batch(gen, batch, dev):
    toks = torch.randint(0, LM["vocab_size"], (batch, LM["max_seq"]),
                         generator=gen).to(dev)
    return toks, toks.roll(-1, 1), torch.ones(LM["max_seq"], device=dev)


def fused_op_check(model, batch):
    """fused_linear_cross_entropy on the card against the naive loss (full
    f32 logits, autograd) on the same hidden states (f32, [B S, D]), head
    and targets: nll, lse, dx and dhead."""
    with torch.no_grad():
        x = model.hidden(batch[0]).reshape(-1, LM["dim"])
    head = model.tok.w.detach()
    tgt = batch[1].reshape(-1)
    gen = torch.Generator(device=x.device).manual_seed(SEED + 3)
    w_nll = torch.rand(x.shape[0], generator=gen, device=x.device)
    w_lse = torch.rand(x.shape[0], generator=gen, device=x.device) - 0.5
    out = {}
    for name in ("fused", "naive"):
        xx, hh = x.clone().requires_grad_(), head.clone().requires_grad_()
        if name == "fused":
            nll, _, lse = losses.fused_linear_cross_entropy(
                xx, hh, tgt, return_lse=True)
        else:
            logits = xx @ hh.t()
            lse = torch.logsumexp(logits, -1)
            nll = lse - logits.gather(1, tgt[:, None])[:, 0]
            del logits
        ((nll * w_nll).sum() + (lse * w_lse).sum()).backward()
        out[name] = (nll.detach(), lse.detach(), xx.grad, hh.grad)
        del xx, hh, nll, lse
    errs = {}
    for i, key in enumerate(("nll", "lse")):
        errs[key] = within(out["fused"][i], out["naive"][i], FUSED_OP_TOL)
    for i, key in ((2, "dx"), (3, "dhead")):
        rel = rel_l2(out["fused"][i], out["naive"][i])
        errs[key] = (rel, rel, rel <= FUSED_OP_TOL)
    del out
    torch.cuda.empty_cache()
    return errs


def branch_times(model, gen, dev):
    """ms/step and peak memory of a plain AdamW step (no remat, dropout
    off) with the naive and the fused loss, at 8 x 2048 (JAX's rule:
    naive) and 16 x 2048 (fused)."""
    opt = optim.AdamW(LONG["lr"], weight_decay=LONG["wd"]).init(
        model.named_parameters())
    out = {}
    for batch in (LM_BATCH, LONG["batch"]):
        data = lm_batch(gen, batch, dev)
        # the fused branch by JAX's rule where it applies, else forced
        past = batch * LM["max_seq"] * LM["vocab_size"] > NAIVE_LOSS_MAX
        for name, chunk in (("naive", 0),
                            ("fused", None if past else FUSED_CHUNK)):
            step = train_step(model, opt, *data, chunk=chunk)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            step_s, _, _ = timed_steps(step, 1, BRANCH_STEPS)
            out[f"{name} {batch}x{LM['max_seq']}"] = dict(
                ms=step_s * 1e3,
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        del data
    del opt
    torch.cuda.empty_cache()
    return out


def phase30_long_training(dev, smi):
    """The 170M model at 16 x 2048 through the fused loss, with remat,
    dropout, z-loss, AdamW, clip_grad_norm, WarmupCosineLR and an EMA."""
    gen = torch.Generator().manual_seed(SEED + 30)
    model = lm_model(dev, dropout=LONG["dropout"], remat=True)
    n_params = sum(p.numel() for p in model.parameters())
    batch = lm_batch(gen, LONG["batch"], dev)
    tokens = LONG["batch"] * LM["max_seq"]
    assert tokens * LM["vocab_size"] > NAIVE_LOSS_MAX

    # gate 2: fused against naive at the same weights, dropout off
    op = fused_op_check(model, batch)
    fused = lm_grads(model, *batch, z_loss=LONG["z_loss"])
    naive = lm_grads(model, *batch, z_loss=LONG["z_loss"], chunk=0)
    loss_rel = abs(fused[0] - naive[0]) / abs(naive[0])
    rel, worst, med = worst_rel(fused[1], naive[1])
    del fused, naive
    print(f"phase 30: fused against naive loss on the card ({LONG['batch']} "
          f"x {LM['max_seq']}, vocab {LM['vocab_size']}, chunk "
          f"{FUSED_CHUNK}): the op on the same f32 hidden states "
          + ", ".join(f"{k} {v[1]:.3e}" for k, v in op.items())
          + f" (tol {FUSED_OP_TOL:.0e}); the model's loss rel err "
          f"{loss_rel:.3e} (tol {FUSED_LOSS_TOL:.0e}), grads rel L2 max "
          f"{rel:.3e} at {worst}, median {med:.3e} (tol "
          f"{LM_BF16_GRAD_TOL:.0e})")
    assert all(ok for _, _, ok in op.values()), op
    assert loss_rel <= FUSED_LOSS_TOL and rel <= LM_BF16_GRAD_TOL

    # the loss branches timed (remat off, dropout off)
    model.remat = False
    branches = branch_times(model, gen, dev)
    print(f"phase 30: one plain AdamW step by loss branch, ms and peak GiB "
          f"(1 warm-up, {BRANCH_STEPS} timed): {branches}; on {smi}")

    # the training run: remat, dropout, z-loss, clip, schedule, EMA
    model.remat = True
    opt = optim.AdamW(LONG["lr"], weight_decay=LONG["wd"]).init(
        model.named_parameters())
    sched = optim.WarmupCosineLR(LONG["lr"], LONG["warmup"] + LONG["steps"],
                                 LONG["warmup"])
    ema = optim.EMA(LONG["ema"])
    shadow = ema.init(opt.params)
    drop_gen = torch.Generator().manual_seed(SEED + 31)
    norms = []

    def step():
        loss, _ = model.loss(*batch, z_loss=LONG["z_loss"], train=True,
                             generator=drop_gen)
        opt.zero_grad()
        loss.backward()
        norms.append(optim.clip_grad_norm([p.grad for p in opt.params],
                                          LONG["clip"])[1])
        opt.lr = sched.step()
        opt.step()
        ema.update(shadow, opt.params)
        return loss.detach()

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step_s, losses_, counts = timed_steps(step, LONG["warmup"],
                                          LONG["steps"])
    routes = per_step(backend.route_counts(), LONG["steps"])
    peak = torch.cuda.max_memory_allocated()
    # gate 3: the same step without remat
    model.remat = False
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    peak_plain = torch.cuda.max_memory_allocated()
    model.remat = True
    flops = lm_flops(n_params, LONG["batch"])
    mfu = flops / step_s / PEAK_FLOPS["bf16"]
    lrs = sched.schedule_array()[:LONG["warmup"] + LONG["steps"] + 1]
    print(f"phase 30: trained the 170M TinyGPT at {LONG['batch']} x "
          f"{LM['max_seq']} (fused loss, remat, dropout {LONG['dropout']}, "
          f"z-loss {LONG['z_loss']}, AdamW({LONG['lr']}, wd {LONG['wd']}), "
          f"clip_grad_norm({LONG['clip']}), WarmupCosineLR over "
          f"{LONG['warmup']} + {LONG['steps']} steps, EMA({LONG['ema']})): "
          f"{LONG['warmup']} warm-up + {LONG['steps']} timed steps, "
          f"{step_s * 1e3:.1f} ms/step, {tokens / step_s:.0f} tokens/s, "
          f"model FLOPs {flops:.3e}/step = {mfu:.4f} of 989 TFLOP/s (remat's "
          f"recompute not counted), peak memory {peak / 2 ** 30:.2f} GiB "
          f"with remat against {peak_plain / 2 ** 30:.2f} GiB without; loss "
          f"per step {losses_}; grad norms "
          f"{[round(float(n), 4) for n in norms]}; lr {lrs.tolist()}; "
          f"launches per step {per_step(counts, LONG['steps'])}; card clocks "
          f"{card_clocks()}; on {smi}")
    assert per_step(counts, LONG["steps"]) == LONG_PER_STEP, counts
    want = lm_step_routes(lm_products(tokens), remat=True)
    print(f"phase 30: K1, K8, K6 and K7 calls per step by route {routes} "
          f"(plan: {want})")
    assert routes == want, (routes, want)
    assert peak < peak_plain, (peak, peak_plain)
    assert all(torch.isfinite(s).all() for s in shadow)
    prof = profile_steps(step, 2)
    print(f"phase 30: profiled 2 steps: {prof['wall_ms']:.1f} ms of wall "
          f"per step (under the profiler) for {prof['busy_ms']:.1f} ms of "
          f"device busy time, {prof['device_ops']:.0f} device ops per step; "
          f"device ms per step by family {prof['ms']}; largest glue "
          f"{prof['glue_top']}")
    params = opt.params
    adamw_row = opt_row("adam", f"170M TinyGPT AdamW({LONG['lr']}, wd "
                        f"{LONG['wd']})", params, [p.grad for p in params],
                        dict(lr=LONG["lr"], wd=LONG["wd"], decoupled=True),
                        30)
    del model, opt, shadow, batch, params
    torch.cuda.empty_cache()
    return counts, dict(step_ms=step_s * 1e3, tokens_s=tokens / step_s,
                        mfu=mfu, peak_gib=peak / 2 ** 30,
                        peak_plain_gib=peak_plain / 2 ** 30,
                        branches=branches, adam=adamw_row, profile=prof)


def moe_layer_check(mlp, gen, dev):
    """One MoE layer, dense against sparse at a capacity of every token
    (nothing dropped), on the same bf16 inputs and cotangent: the
    output's error and each gradient's relative L2 error."""
    n, k = mlp.n_experts, mlp.top_k
    shape = (MOE["check_batch"], LM["max_seq"], LM["dim"])
    x = torch.randn(*shape, generator=gen).to(dev, torch.bfloat16)
    cot = torch.randn(*shape, generator=gen).to(dev, torch.bfloat16)
    out = {}
    for name, cf in (("dense", None), ("sparse", n / k)):
        mlp.capacity_factor = cf
        mlp.zero_grad(set_to_none=True)
        xx = x.clone().requires_grad_()
        y = mlp(xx)
        (y.float() * cot.float()).sum().backward()
        out[name] = (y.detach(), {"x": xx.grad, **{
            f"mlp.{key}": p.grad.clone()
            for key, p in mlp.named_parameters()}})
    mlp.capacity_factor = MOE["capacity_factor"]
    mlp.zero_grad(set_to_none=True)
    err = within(out["sparse"][0], out["dense"][0], MOE_OUT_TOL, "ulp")
    rel = {key: rel_l2(g, out["dense"][1][key])
           for key, g in out["sparse"][1].items()}
    return err, rel


def phase31_moe_training(dev, smi):
    """Every FFN of the 170M model an 8-expert top-2 MoE at capacity
    factor 1.25, batch 8 x 2048, Adam: K1 at the experts' shapes against
    its plain version, one layer sparse against dense where nothing
    drops, then the
    timed run with the experts' K1 calls by route against the plan."""
    gen = torch.Generator().manual_seed(SEED + 31)
    n, k = MOE["n_experts"], MOE["top_k"]
    tokens = MOE["batch"] * LM["max_seq"]
    cap = moe_capacity(tokens, n, k, MOE["capacity_factor"])
    e = LM["dim"]
    rows = gemm_rows(dev, ((cap, e, 4 * e), (cap, 4 * e, e)),
                     torch.bfloat16, 31, BF16_GEMM_TOL, gen)
    model = lm_model(dev, n_experts=n, top_k=k,
                     capacity_factor=MOE["capacity_factor"])
    n_params = sum(p.numel() for p in model.parameters())

    # gate 2: sparse with nothing dropped (C = T) against dense mode
    err, rel = moe_layer_check(model.blocks[0].mlp, gen, dev)
    worst = max(rel, key=rel.get)
    print(f"phase 31: one MoE layer, sparse at C = T (nothing dropped) "
          f"against dense at {MOE['check_batch']} x {LM['max_seq']} bf16: "
          f"output max_abs_err {err[0]:.3e} ({err[1]:.3e} <= "
          f"{MOE_OUT_TOL:.0e} (|ref| + {ULP_FLOOR:.0e})); grads rel L2 "
          f"{ {key: float(f'{v:.3e}') for key, v in rel.items()} } (tol "
          f"{MOE_GRAD_TOL:.0e})")
    assert err[2] and rel[worst] <= MOE_GRAD_TOL, (err, rel)

    # the dropped-slot share of one forward at the training batch
    batch = lm_batch(gen, MOE["batch"], dev)
    kept = []
    real = NT.moe_sparse_routing

    def spy(*args):
        out = real(*args)
        kept.append(out[3].float().mean())
        return out
    NT.moe_sparse_routing = spy
    try:
        with torch.no_grad():
            model.loss(*batch)
    finally:
        NT.moe_sparse_routing = real
    dropped = 1.0 - float(torch.stack(kept).mean())

    opt = optim.Adam(LM_LR).init(model.named_parameters())
    step = train_step(model, opt, *batch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step_s, losses_, counts = timed_steps(step, MOE["warmup"], MOE["steps"])
    routes = per_step(backend.route_counts(), MOE["steps"])
    peak = torch.cuda.max_memory_allocated()
    print(f"phase 31: trained the 170M-width MoE TinyGPT ({n_params / 1e6:.1f}"
          f"M params, {n} experts, top-{k}, capacity factor "
          f"{MOE['capacity_factor']}: C = {cap} of {tokens} tokens, bf16 "
          f"trunk, Adam({LM_LR})) at {MOE['batch']} x {LM['max_seq']}: "
          f"{MOE['warmup']} warm-up + {MOE['steps']} timed steps, "
          f"{step_s * 1e3:.1f} ms/step, {tokens / step_s:.0f} tokens/s, "
          f"dropped slots {dropped:.4f} of top-{k} slots, peak memory "
          f"{peak / 2 ** 30:.2f} GiB; loss per step {losses_}; launches per "
          f"step {per_step(counts, MOE['steps'])}; card clocks "
          f"{card_clocks()}; on {smi}")
    assert per_step(counts, MOE["steps"]) == MOE_PER_STEP, counts
    want = lm_step_routes(lm_products(tokens, (n, cap)))
    print(f"phase 31: K1, K8, K6 and K7 calls per step by route {routes} "
          f"(plan: {want})")
    assert routes == want, (routes, want)
    prof = profile_steps(step, 2)
    print(f"phase 31: profiled 2 steps: {prof['wall_ms']:.1f} ms of wall "
          f"per step (under the profiler) for {prof['busy_ms']:.1f} ms of "
          f"device busy time, {prof['device_ops']:.0f} device ops per step; "
          f"device ms per step by family {prof['ms']}; largest glue "
          f"{prof['glue_top']}")
    del model, opt, step, batch
    torch.cuda.empty_cache()
    return counts, dict(step_ms=step_s * 1e3, tokens_s=tokens / step_s,
                        dropped=dropped, peak_gib=peak / 2 ** 30,
                        rows=rows, profile=prof)


def phase32_optimizers(dev, smi):
    """The 170M model at 8 x 2048 through Lion, Muon and Adafactor: a few
    steps each, every loss finite, Muon's Newton-Schulz time a step beside
    its step's."""
    gen = torch.Generator().manual_seed(SEED + 32)
    model = lm_model(dev)
    batch = lm_batch(gen, LM_BATCH, dev)
    totals, out = dict.fromkeys(backend.KERNELS, 0), {}
    for name in ("lion", "muon", "adafactor"):
        opt = train_tinylm.OPTIMIZERS[name](train_tinylm.LR_DEFAULTS[name])
        opt.init(model.named_parameters())
        step = train_step(model, opt, *batch)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        step_s, losses_, counts = timed_steps(step, OPTS["warmup"],
                                              OPTS["steps"])
        peak = torch.cuda.max_memory_allocated()
        for k_, c in counts.items():
            totals[k_] += c
        out[name] = dict(step_ms=step_s * 1e3, peak_gib=peak / 2 ** 30,
                         losses=losses_)
        extra = ""
        if name == "muon":
            mats = [m.reshape(m.shape[0], -1)
                    for m, mat in zip(opt.m, opt.matrix) if mat]
            ns_ms = cuda_ms(lambda: [optim.newton_schulz_orthogonalize(
                u, opt.ns_steps) for u in mats], [()], iters=3)
            out[name]["ns_ms"] = ns_ms
            extra = (f", Newton-Schulz {ns_ms:.1f} ms of it over "
                     f"{len(mats)} matrices ({ns_ms / (step_s * 1e3):.3f} "
                     f"of the step)")
        print(f"phase 32: 170M TinyGPT ({LM_BATCH} x {LM['max_seq']}, bf16 "
              f"trunk) through {type(opt).__name__}"
              f"({train_tinylm.LR_DEFAULTS[name]}): {OPTS['warmup']} warm-up "
              f"+ {OPTS['steps']} timed steps, {step_s * 1e3:.1f} ms/step"
              f"{extra}, peak memory {peak / 2 ** 30:.2f} GiB; loss per "
              f"step {losses_}; launches per step "
              f"{per_step(counts, OPTS['steps'])}; on {smi}")
        assert per_step(counts, OPTS["steps"]) == OPTS_PER_STEP, counts
        del opt, step
    del model, batch
    torch.cuda.empty_cache()
    return totals, out


# -- the generation slice (phases 33-35) ---------------------------------------

# Phase 33: benchmarks/bench_serving.py:121-135's bench_multiturn model
# (0.28B parameters at random init from SEED), its context of 1,024 and its
# chunk of 32 new tokens on 8 rows (max_seq 1,088 = 1,024 + 2 x 32)
GEN = dict(vocab_size=4096, dim=2048, depth=6, num_heads=16, num_kv_heads=4,
           max_seq=1088, rope=True)
GEN_RUN = dict(batch=8, prompt=1024, max_new=64, chunk=32, beam_batch=2,
               beams=4, beam_new=32, reps=5, eos_at=10)
# a layer's six K1 products (K_in, N_out): q, k, v, o, the MLP's two
GEN_PRODUCTS = ((2048, 2048), (2048, 512), (2048, 512), (2048, 2048),
                (2048, 8192), (8192, 2048))
GEN_PER_STEP = dict(linear=6 * GEN["depth"])
# The teacher-forced check of a greedy token: a full forward over the
# output (bf16 trunk, flash prefill) gives each position's logits; the
# token chosen there must lie within GREEDY_TAU of its row's maximum.  The
# decode path and the forward round differently in bf16 (phase 4: 3e-3
# relative L2 against f32 at unit-scale logits), so a near-tie may resolve
# either way; tokens 4,096 Gaussian logits of std ~0.9 apart lie ~0.2 below
# the maximum at the second place and ~3 at a random one.  An int8 cache
# adds its rows' rounding (one part in 254 of a row's largest entry).
GREEDY_TAU = {"bf16": 0.05, "int8": 0.1}
# Phase 34: bench_serving.py:446-488's bench_speculative pair, f32 with
# RoPE, max_seq 272 = 64 + 192 + 16, trained as there: Adam(1e-3), 1,200
# steps of 32 random 128-byte windows of the repository's markdown; the
# bench generates 192 tokens, phase 34 128 (phases 33-35 within about two
# minutes: a speculative round is host bound at ~40 ms, PERF.md)
SPEC = dict(vocab_size=256, max_seq=272, rope=True, steps=1200, batch=32,
            seq=128, lr=1e-3, gamma=4, prompt=64, max_new=128,
            batches=(1, 4, 8), bpe_vocab=512, max_loss=3.0)
SPEC_TARGET = dict(dim=512, depth=6, num_heads=8)
SPEC_DRAFT = dict(dim=128, depth=2, num_heads=4)     # heads of 32
# greedy speculative decoding against the target's own greedy generate,
# both f32: the verify chunk's products (M = B * 5) and a decode step's (M
# = B) sum in other orders, last-bit apart; where the two outputs first
# part, the target's two logits must be that close.  The same tau holds
# every greedy token of both against a teacher-forced forward of the
# target on the CPU (plain PyTorch): f32 logits of unit scale that differ
# only by summation order agree to ~1e-5 (the f32 K1 rows' errors)
SPEC_TAU = 1e-3
# the sampled continuation (temperature 0.8) against the CPU forward's
# tempered distributions: its summed NLL at most this many standard
# deviations above the summed entropy (a draw from the right distribution
# has z ~ N(0, 1); a wrong cache or position gives tokens the model finds
# unlikely, tens of sigma above)
SAMPLE_Z = 4.0


def bytelm_per_step(depth):
    """Launches per training step of a byte LM: six K1 products a layer
    (forward, dX, dW), the f32 flash forward and backward, one Adam."""
    return dict(linear=6 * depth, gemm_nn=6 * depth, gemm_tn=6 * depth,
                flash_fwd=depth, flash_dq=depth, flash_dkv=depth, adam=1)


def gen_model(dev):
    """Phase 33's model: random weights from SEED, projections cast to
    bf16, a bf16 trunk."""
    model = TinyGPT(**GEN)
    model.reset_parameters(torch.Generator().manual_seed(SEED))
    model.eval()
    model = model.to(dev).cast_projections(torch.bfloat16)
    model.compute_dtype = torch.bfloat16
    return model


def step_routes(m, products, layers, dtype=torch.bfloat16):
    """K1 calls of one pass over ``m`` rows by route, as ``plan`` predicts
    them: each layer's ``products`` (K_in, N_out) in mode nt."""
    want = {}
    for k_in, n_out in products:
        route, splits = plan(m, n_out, k_in, dtype, "nt", True)
        key = route_key(route, "nt", splits)
        want[key] = want.get(key, 0) + layers
    return want


def add_routes(*tallies):
    out = {}
    for t, times in tallies:
        for k, c in t.items():
            out[k] = out.get(k, 0) + c * times
    return out


def greedy_gaps(model, tokens, starts, n):
    """Each of the ``n`` tokens from its row's start (``[B]`` ints): the
    row maximum of ``model``'s forward over the tokens, less the chosen
    token's logit, one position before (``[B, n]``)."""
    with torch.no_grad():
        lg = model(tokens[:, :-1])
    out = []
    for r, st in enumerate(starts):
        row = lg[r, st - 1:st - 1 + n].float()
        pick = row.gather(1, tokens[r, st:st + n, None])[:, 0]
        out.append(row.max(-1).values - pick)
    return torch.stack(out)


def counted(fn):
    """``fn()`` timed from a synced device, with its launches and routes."""
    torch.cuda.synchronize()
    backend.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0, backend.launch_counts(),
            backend.route_counts())


def gen_kernel_rows(dev, gen):
    """K1 at phase 33's three row counts (a decode step, a chunk, the
    prefill) and K8 at its prefill shape, against their plain versions."""
    bf = torch.bfloat16
    b, p, c = GEN_RUN["batch"], GEN_RUN["prompt"], GEN_RUN["chunk"]

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(bf).to(dev)

    rows = []
    for m in (b, b * c, b * p):
        for k, n in sorted(set(GEN_PRODUCTS)):
            x, w, bias = randn(m, k), randn(n, k, scale=k ** -0.5), \
                randn(n, scale=0.1)
            rows.append(check_kernel(
                "linear", f"bf16 M={m} K={k} N={n} (+bias)", linear,
                linear_reference, cold_sets(x, w, bias), phase=33,
                library_fn=F.linear,
                work=gemm_work(m, n, k, "bf16", bias=True)))
            del x, w, bias
    h, hkv, d = GEN["num_heads"], GEN["num_kv_heads"], GEN["dim"] // \
        GEN["num_heads"]
    q = randn(b, h, p, d)
    k, v = randn(b, hkv, p, d), randn(b, hkv, p, d)
    k8 = check_kernel(
        "flash_fwd_bound", f"bf16 B={b} H={h} Hkv={hkv} S={p} D={d} causal",
        lambda q, k, v: A.attention(q, k, v, causal=True),
        lambda q, k, v: A.attention_reference(q, k, v, causal=True),
        cold_sets(q, k, v),
        library_fn=lambda q, k, v: F.scaled_dot_product_attention(
            q, k.repeat_interleave(h // hkv, 1),
            v.repeat_interleave(h // hkv, 1), is_causal=True),
        work=attn_work(b, h, hkv, p, d, "bf16", 2,
                       2 * nbytes(q) + 2 * nbytes(k) + 4 * b * h * p),
        flash_route=A.plan_fwd(bf, "causal"), phase=33)
    return dict(linear=rows, flash_fwd_bound=[k8])


def phase33_generation(dev, smi):
    """Generation at full width on bench_multiturn's model: greedy
    ``generate`` (one-shot and token-at-a-time prefill, int8 cache, ragged
    prompts, eos), the multi-turn hand-off through ``generate_continued``,
    ``decode_chunk`` against re-prefilling, and ``beam_search``."""
    gen = torch.Generator().manual_seed(SEED + 33)
    rows = gen_kernel_rows(dev, gen)
    model = gen_model(dev)
    n_params = sum(t.numel() for t in model.parameters())
    b, p, n, c = (GEN_RUN[k] for k in ("batch", "prompt", "max_new",
                                       "chunk"))
    depth, v = GEN["depth"], GEN["vocab_size"]
    prompt = torch.randint(0, v, (b, p), generator=gen).to(dev)
    new = torch.randint(0, v, (b, c), generator=gen).to(dev)
    decode_r = step_routes(b, GEN_PRODUCTS, depth)
    prefill_r = step_routes(b * p, GEN_PRODUCTS, depth)
    totals = {}

    def tally(counts):
        for k_, c_ in counts.items():
            totals[k_] = totals.get(k_, 0) + c_

    def held(label, out, starts, kind="bf16"):
        gaps = greedy_gaps(model, out, starts, n)
        top = float((gaps == 0).float().mean())
        print(f"phase 33: {label}: teacher-forced check of {gaps.numel()} "
              f"tokens: worst gap below the row maximum {float(gaps.max()):.4f}"
              f" (tau {GREEDY_TAU[kind]}), {top:.4f} of them the forward's "
              f"own argmax")
        assert torch.isfinite(gaps).all() and gaps.max() <= GREEDY_TAU[kind]
        return top

    model.generate(prompt, 2)                 # first calls' set-up
    out, wall, counts, routes = counted(lambda: model.generate(prompt, n))
    tally(counts)
    # the prefill alone, for the decode rate
    with torch.no_grad():
        caches = model.init_cache(b)
        _, pre_s, _, _ = counted(lambda: model.prefill(prompt, caches))
    dec_ms = (wall - pre_s) / (n - 1) * 1e3
    want = {"linear": GEN_PER_STEP["linear"] * n, "flash_fwd_bound": depth}
    launched = {k_: c_ for k_, c_ in counts.items() if c_}
    planned = add_routes((prefill_r, 1), (decode_r, n - 1),
                         ({"wgmma flash_fwd_bound": depth}, 1))
    print(f"phase 33: TinyGPT vocab {v}, dim {GEN['dim']}, depth {depth}, "
          f"{GEN['num_heads']} heads on {GEN['num_kv_heads']} KV heads, "
          f"bf16, {n_params / 1e6:.1f}M params: generate {b} x {p} + {n} "
          f"greedy in {wall:.3f} s ({b * n / wall:.1f} tokens/s with the "
          f"prefill; prefill {pre_s * 1e3:.1f} ms, then {dec_ms:.2f} ms a "
          f"decode step, {b / dec_ms * 1e3:.1f} tokens/s); launches "
          f"{launched}; K1/flash calls by route {routes} (planned "
          f"{planned}); on {smi}")
    assert launched == want, (launched, want)
    assert routes == planned, (routes, planned)
    assert out.shape == (b, p + n) and torch.equal(out[:, :p], prompt)
    held("one-shot prefill", out, [p] * b)

    # one decode step's K1 calls, by route, and where its time goes
    at_p = torch.full((), p, dtype=torch.long, device=dev)
    with torch.no_grad():
        _, _, step_counts, step_r = counted(
            lambda: model.decode_step(out[:, p], at_p, caches))
        prof = decode_profile(lambda: model.decode_step(out[:, p], at_p,
                                                        caches), 2)
    print(f"phase 33: a decode step profiled: {prof['wall_ms']:.2f} ms of "
          f"wall (under the profiler), {prof['busy_ms']:.3f} ms of device "
          f"busy ({prof['busy_share']:.3f}), {prof['device_ops']:.0f} device "
          f"ops; by family {prof['ms']}; the largest glue {prof['glue_top']}")
    with torch.no_grad():
        host = host_profile(lambda: model.decode_step(out[:, p], at_p,
                                                      caches))
    print(f"phase 33: a decode step's host time: {host['wall_ms']:.2f} ms "
          f"a step, {host['wall_prof_ms']:.2f} ms under cProfile; own time "
          f"by file (ms a step) {host['by_file']}; the largest own times "
          f"(where, ms, calls a step) {host['own']}; the port's functions "
          f"by time with callees {host['port_cum']}")
    print(f"phase 33: one decode step at M={b}: launches "
          f"{ {k_: c_ for k_, c_ in step_counts.items() if c_} }, K1 by "
          f"route {step_r} (plan: {decode_r})")
    assert step_r == decode_r and step_counts["linear"] == \
        GEN_PER_STEP["linear"], step_r
    del caches

    seq, wall_s, counts, _ = counted(lambda: model.generate(
        prompt, n, one_shot_prefill=False))
    tally(counts)
    agree = float((seq == out).float().mean())
    print(f"phase 33: one_shot_prefill=False: {p + n - 1} decode steps in "
          f"{wall_s:.2f} s ({wall_s / (p + n - 1) * 1e3:.2f} ms a step), "
          f"{agree:.4f} of the tokens as the one-shot path's")
    assert counts["flash_fwd_bound"] == 0
    held("token-at-a-time prefill", seq, [p] * b)

    q8, wall_q, counts, _ = counted(lambda: model.generate(
        prompt, n, quantized_cache=True))
    tally(counts)
    print(f"phase 33: int8 cache: {b * n / wall_q:.1f} tokens/s with the "
          f"prefill, {float((q8 == out).float().mean()):.4f} of the tokens "
          f"as the bf16 cache's")
    held("int8 cache", q8, [p] * b, "int8")

    lens = torch.randint(p // 2, p + 1, (b,), generator=gen)
    rag, wall_r, counts, _ = counted(lambda: model.generate(
        prompt, n, prompt_lens=lens))
    tally(counts)
    print(f"phase 33: ragged prompts of {lens.tolist()} tokens: "
          f"{b * n / wall_r:.1f} tokens/s")
    held("ragged prompts", rag, lens.tolist())

    eos = int(out[0, p + GEN_RUN["eos_at"]])
    ended, wall_e, counts, _ = counted(lambda: model.generate(
        prompt, n, eos_token=eos, pad_token=0))
    tally(counts)
    rows_same = int((ended == _mask_after_eos(out, p, eos, 0)).all(1).sum())
    hit = (ended[:, p:] == eos).any(1)
    print(f"phase 33: eos {eos} (row 0's token {GEN_RUN['eos_at']}): "
          f"{int(hit.sum())} of {b} rows ended, "
          f"{counts['linear'] // GEN_PER_STEP['linear']} model passes, {rows_same} of {b} rows the greedy run's masked "
          f"output")
    for r in range(b):                     # pad after each row's first eos
        g = ended[r, p:]
        at = (g == eos).nonzero()
        if len(at):
            assert (g[int(at[0]) + 1:] == 0).all(), r
            g = g[:int(at[0]) + 1]
        gaps = greedy_gaps(model, ended[r:r + 1, :p + len(g)], [p], len(g))
        assert gaps.max() <= GREEDY_TAU["bf16"], (r, float(gaps.max()))

    # multi-turn: turn 1 fills [0, P), turn 2 brings a chunk of 32
    (t1, caches), wall_1, counts, _ = counted(lambda: model.generate(
        prompt, 1, return_cache=True))
    tally(counts)
    t2, wall_2, counts, routes = counted(lambda: model.generate_continued(
        new, c, caches, past_len=p))
    tally(counts)
    chunk_r = step_routes(b * c, GEN_PRODUCTS, depth)
    print(f"phase 33: multi-turn: turn 1 (prefill {p}) {wall_1 * 1e3:.1f} "
          f"ms, turn 2 (a chunk of {c} at {p}, then {c} tokens) "
          f"{wall_2 * 1e3:.1f} ms; turn 2's K1 by route {routes}")
    assert routes == add_routes((chunk_r, 1), (decode_r, c - 1)), routes
    full = torch.cat([prompt, t2], 1)
    gaps = greedy_gaps(model, full, [p + c] * b, c)
    print(f"phase 33: turn 2's {gaps.numel()} tokens: worst gap "
          f"{float(gaps.max()):.4f} (tau {GREEDY_TAU['bf16']})")
    assert gaps.max() <= GREEDY_TAU["bf16"]
    del caches

    # decode_chunk against re-prefilling P + 32 (bench_multiturn's race)
    with torch.no_grad():
        cache0 = model.init_cache(b)
        model.prefill(prompt, cache0)
        chunk_lg = model.decode_chunk(new, p, cache0)
        fresh = model.init_cache(b)
        ref = model.prefill(torch.cat([prompt, new], 1), fresh)[:, p:]
        rel = rel_l2(chunk_lg.float(), ref.float())
        print(f"phase 33: decode_chunk logits over [{p}, {p + c}) against "
              f"prefill of all {p + c}: rel L2 {rel:.3e} (tol "
              f"{MODEL_REL_TOL:.0e}), argmax agreement "
              f"{float((chunk_lg.argmax(-1) == ref.argmax(-1)).float().mean()):.4f}")
        assert rel <= MODEL_REL_TOL
        times = {}
        for name, fn in (("cache reuse", lambda: model.decode_chunk(
                new, p, cache0)), ("re-prefill", lambda: model.prefill(
                torch.cat([prompt, new], 1), fresh))):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(GEN_RUN["reps"]):
                fn()
            torch.cuda.synchronize()
            times[name] = (time.perf_counter() - t0) / GEN_RUN["reps"]
    print(f"phase 33: turn 2 new tokens/s ({b} x {c}): cache reuse "
          f"(decode_chunk) {b * c / times['cache reuse']:.1f} "
          f"({times['cache reuse'] * 1e3:.2f} ms), re-prefill "
          f"{b * c / times['re-prefill']:.1f} "
          f"({times['re-prefill'] * 1e3:.2f} ms): "
          f"{times['re-prefill'] / times['cache reuse']:.2f}x; on {smi}")
    del cache0, fresh, chunk_lg, ref

    # beam search: beams 4 over 2 prompts (a [8] decode batch)
    bb, w, bn = (GEN_RUN[k] for k in ("beam_batch", "beams", "beam_new"))
    (beams, scores), wall_b, counts, routes = counted(
        lambda: model.beam_search(prompt[:bb], bn, beams=w,
                                  return_all=True))
    tally(counts)
    planned = add_routes((step_routes(bb * p, GEN_PRODUCTS, depth), 1),
                         (step_routes(bb * w, GEN_PRODUCTS, depth), bn - 1),
                         ({"wgmma flash_fwd_bound": depth}, 1))
    greedy = out[:bb, :p + bn]
    with torch.no_grad():
        def logp(tokens):
            lg = torch.log_softmax(model(tokens[:, :-1]).float(), -1)
            return lg[:, p - 1:].gather(2, tokens[:, p:, None])[..., 0].sum(1)
        best, base = logp(beams[:, 0]), logp(greedy)
    print(f"phase 33: beam_search beams {w} on {bb} x {p} + {bn}: "
          f"{wall_b:.3f} s ({bb * bn / wall_b:.1f} tokens/s); scores "
          f"{scores.tolist()}; best beam's log p by the forward "
          f"{best.tolist()} against the greedy continuation's "
          f"{base.tolist()}; K1 by route {routes} (planned {planned})")
    assert routes == planned, (routes, planned)
    assert (scores[:, 1:] <= scores[:, :-1] + 1e-6).all()
    # scores are per-token means (length_penalty 1); the forward's log p
    # agrees within the bf16 trunk's rounding, and beam search finds at
    # least the greedy continuation's likelihood
    assert (best / bn - scores[:, 0]).abs().max() <= GREEDY_TAU["bf16"]
    assert (best >= base - bn * GREEDY_TAU["bf16"]).all()
    del model
    release()
    return totals, dict(rows=rows, tokens_s=b * n / wall,
                        decode_step_ms=dec_ms,
                        chunk_speedup=times["re-prefill"]
                        / times["cache reuse"])


def spec_models(dev):
    """bench_speculative's target and draft byte LMs (f32, RoPE) on the
    card, weights from SEED."""
    out = []
    for i, cfg in enumerate((SPEC_TARGET, SPEC_DRAFT)):
        model = TinyGPT(vocab_size=SPEC["vocab_size"], max_seq=SPEC["max_seq"],
                        rope=SPEC["rope"], **cfg)
        model.reset_parameters(torch.Generator().manual_seed(SEED + i))
        out.append(model.to(dev))
    return out


def bytelm_kernel_rows(dev, gen):
    """The byte LMs' training kernels against their plain versions at their
    shapes (f32): K1 in modes nt, nn, tn at each layer's products over
    32 x 128 tokens, K5, K6 and K7 at each model's attention shape."""
    t = SPEC["batch"] * SPEC["seq"]
    rows = {}
    for cfg in (SPEC_TARGET, SPEC_DRAFT):
        e = cfg["dim"]
        for k_, r in gemm_rows(dev, ((t, e, e), (t, e, 4 * e), (t, 4 * e, e)),
                               torch.float32, 34, LINEAR_F32_TOL,
                               gen).items():
            rows.setdefault(k_, []).extend(r)
        for k_, r in lm_flash_rows(dev, SPEC["batch"], cfg["num_heads"],
                                   SPEC["seq"], e // cfg["num_heads"],
                                   torch.float32, 34, gen, ("bhsd",),
                                   ("exact",)).items():
            rows.setdefault(k_, []).extend(r)
    return rows


def bytelm_gen_rows(dev, gen):
    """The kernels of phase 34's generation at their shapes (f32), against
    their plain versions, for each B of ``SPEC["batches"]``: K1 at each
    layer's three products at a decode step (M = B, both models), the
    target's verify chunk (M = (gamma + 1) B) and the prefill (M = P B,
    both models), and K5 at the prefill's ``[B, H, P, D]``.  The logits'
    head is a plain matmul (JAX's einsum), no K1."""
    p, v = SPEC["prompt"], SPEC["gamma"] + 1
    rows = {}

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    for cfg, chunk in ((SPEC_TARGET, True), (SPEC_DRAFT, False)):
        e, h = cfg["dim"], cfg["num_heads"]
        ms = sorted({m for b in SPEC["batches"]
                     for m in (b, p * b) + ((v * b,) if chunk else ())})
        for m in ms:
            for k_in, n_out in ((e, e), (e, 4 * e), (4 * e, e)):
                x, w = randn(m, k_in), randn(n_out, k_in, scale=k_in ** -0.5)
                bias = randn(n_out, scale=0.1)
                rows.setdefault("linear", []).append(check_kernel(
                    "linear", f"f32 [{m},{k_in}].[{n_out},{k_in}]^T + b "
                    f"(generation)", linear, linear_reference,
                    cold_sets(x, w, bias), phase=34, tol=LINEAR_F32_TOL,
                    library_fn=F.linear,
                    work=gemm_work(m, n_out, k_in, "f32", True)))
        for b in SPEC["batches"]:
            for k_, r in lm_flash_rows(dev, b, h, p, e // h, torch.float32,
                                       34, gen, ("bhsd",), ("exact",),
                                       backward=False).items():
                rows.setdefault(k_, []).extend(r)
    return rows


def tempered_z(model, ids, start, temperature):
    """A sampled continuation ``ids[start:]`` against ``model``'s forward
    over ``ids``: its NLL under the tempered distributions less their
    entropy, summed and over the sum's standard deviation, with the mean
    NLL and entropy per token."""
    with torch.no_grad():
        lg = model(torch.tensor([ids[:-1]]))[0, start - 1:].float()
    logp = torch.log_softmax(lg / temperature, -1)
    pr = logp.exp()
    nll = -logp.gather(1, torch.tensor(ids[start:])[:, None])[:, 0]
    ent = -(pr * logp).sum(-1)
    var = (pr * logp ** 2).sum(-1) - ent ** 2
    return (float((nll.sum() - ent.sum()) / var.sum().sqrt()),
            float(nll.mean()), float(ent.mean()))


def spec_first_split(target, out, ref):
    """Where a greedy speculative row first parts from the target's own
    greedy row: the two tokens' logits in the target's forward over the
    common prefix, as ``(row, position, |logit difference|)``."""
    parts = []
    for r in range(out.shape[0]):
        diff = (out[r] != ref[r]).nonzero()
        if not len(diff):
            continue
        t = int(diff[0])
        with torch.no_grad():
            lg = target(out[r:r + 1, :t])[0, -1].float()
        parts.append((r, t, float((lg[out[r, t]] - lg[ref[r, t]]).abs())))
    return parts


def phase34_bytelm_speculative(dev, smi):
    """The BPE tokenizer on the repository's markdown (native and Python
    merges equal, encode then decode gives the bytes back), the byte LMs
    of bench_speculative trained through train_bytelm's code, then
    speculative decoding against the target's own greedy generation."""
    corpus = train_bytelm.load_corpus()
    raw = bytes(corpus.astype(np.uint8))
    t0 = time.perf_counter()
    lib = bpe_native.load()            # make -C native on first use
    print(f"phase 34: native/libtaperdata.so loaded ({lib is not None}) in "
          f"{time.perf_counter() - t0:.2f} s (its build included, if the "
          f"checkout had none)")
    t0 = time.perf_counter()
    tok = BPETokenizer.train(raw, SPEC["bpe_vocab"])
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    tok_py = BPETokenizer.train(raw, SPEC["bpe_vocab"], use_native=False)
    t_py = time.perf_counter() - t0
    t0 = time.perf_counter()
    ids = tok.encode(raw)
    e_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    ids_py = tok_py.encode(raw, use_native=False)
    e_py = time.perf_counter() - t0
    print(f"phase 34: BPE to vocab {SPEC['bpe_vocab']} on {len(raw):,} bytes "
          f"of markdown: native library {bpe_native.available()}; train "
          f"native {t_native:.3f} s, Python {t_py:.3f} s; encode native "
          f"{e_native:.3f} s, Python {e_py:.3f} s; {len(raw) / len(ids):.2f} "
          f"bytes/token; merges equal {tok.merges == tok_py.merges}, ids "
          f"equal {ids == ids_py}")
    assert bpe_native.available(), "native/libtaperdata.so did not build"
    assert tok.merges == tok_py.merges and ids == ids_py
    assert tok.vocab_size == SPEC["bpe_vocab"]
    assert tok.decode_bytes(ids) == raw and tok.decode(ids) == raw.decode(
        "utf-8", errors="replace")

    gen = torch.Generator().manual_seed(SEED + 34)
    rows = bytelm_kernel_rows(dev, gen)
    for k_, r in bytelm_gen_rows(dev, gen).items():
        rows.setdefault(k_, []).extend(r)
    target, draft = spec_models(dev)
    corpus_t = torch.from_numpy(corpus).long().to(dev)
    totals, losses = {}, {}
    for name, model in (("target", target), ("draft", draft)):
        (losses[name], _), wall, counts, routes = counted(
            lambda: train_bytelm.train(
                model, corpus_t, SPEC["steps"], batch=SPEC["batch"],
                seq=SPEC["seq"], lr=SPEC["lr"], schedule=False,
                generator=torch.Generator(device=dev).manual_seed(SEED + 1)))
        for k_, c_ in counts.items():
            totals[k_] = totals.get(k_, 0) + c_
        per = per_step(counts, SPEC["steps"])
        print(f"phase 34: {name} byte LM (dim {model.dim}, depth "
              f"{model.depth}, f32, {sum(t.numel() for t in model.parameters()) / 1e6:.2f}M"
              f" params) through train_bytelm.train: {SPEC['steps']} Adam "
              f"steps of {SPEC['batch']} x {SPEC['seq']} in {wall:.1f} s "
              f"({wall / SPEC['steps'] * 1e3:.2f} ms/step), final loss "
              f"{losses[name]:.4f} nats/byte (gate < {SPEC['max_loss']}); "
              f"launches per step {per}; flash calls per step "
              f"{per_step(flash_only(routes), SPEC['steps'])}")
        assert per == bytelm_per_step(model.depth), per
        assert per_step(flash_only(routes), SPEC["steps"]) == flash_routes(
            model.depth, torch.float32, "causal")
        assert math.isfinite(losses[name]) and losses[name] < SPEC["max_loss"]
    params = list(target.parameters())
    rows["adam"] = [opt_row("adam", f"target byte LM Adam({SPEC['lr']})",
                            params, [t.grad for t in params],
                            dict(lr=SPEC["lr"], wd=0.0, decoupled=False),
                            34)]
    # the trained target on the CPU, plain PyTorch: the reference that
    # holds every token phase 34 generates on the card
    plain_target = copy.deepcopy(target).cpu()
    plen = len(train_bytelm.PROMPT)
    ids = train_bytelm.sample_ids(target, None, 118)
    z, nll, ent = tempered_z(plain_target, ids, plen, 0.8)
    print(f"phase 34: the target's sampled continuation (train_bytelm."
          f"sample_ids, temperature 0.8): "
          f"{bytes(ids).decode('utf-8', errors='replace')!r}; against the "
          f"CPU forward's tempered distributions: NLL {nll:.4f} nats/byte, "
          f"entropy {ent:.4f}, z {z:.2f} (gate <= {SAMPLE_Z})")
    assert len(ids) == plen + 118 and ids[:plen] == list(
        train_bytelm.PROMPT)
    assert math.isfinite(z) and z <= SAMPLE_Z, z

    start = int(len(corpus) * 0.92)
    stats = {}
    for b in SPEC["batches"]:
        pr = torch.from_numpy(np.stack(
            [corpus[start + i * 97:start + i * 97 + SPEC["prompt"]]
             for i in range(b)])).long().to(dev)
        ref, wall_p, counts, _ = counted(lambda: target.generate(
            pr, SPEC["max_new"]))
        for k_, c_ in counts.items():
            totals[k_] = totals.get(k_, 0) + c_

        def plain_gap(out):
            """The worst greedy token of ``out`` by the CPU forward."""
            return float(greedy_gaps(plain_target, out.cpu(),
                                     [SPEC["prompt"]] * b,
                                     SPEC["max_new"]).max())

        worst = plain_gap(ref)
        line = [f"plain greedy {b * SPEC['max_new'] / wall_p:.1f} tokens/s"
                f" (worst gap by the CPU forward {worst:.2e})"]
        assert worst <= SPEC_TAU, worst
        for per_row in (True, False):
            (out, st), wall_s, counts, _ = counted(
                lambda: target.speculative_generate(
                    draft, pr, SPEC["max_new"], gamma=SPEC["gamma"],
                    return_stats=True, per_row=per_row))
            for k_, c_ in counts.items():
                totals[k_] = totals.get(k_, 0) + c_
            parts = spec_first_split(target, out, ref)
            mode = "per row" if per_row else "lockstep"
            stats[(b, mode)] = dict(tokens_s=b * SPEC["max_new"] / wall_s,
                                    per_round=st["tokens_per_round"],
                                    rounds=st["rounds"])
            line.append(
                f"{mode} {b * SPEC['max_new'] / wall_s:.1f} tokens/s, "
                f"{st['tokens_per_round']:.2f} tokens a round over "
                f"{st['rounds']} rounds, accepted-draft histogram "
                f"{st['accept_hist'].tolist()}, rows parting from plain "
                f"(row, position, logit gap) {parts}")
            assert all(gap <= SPEC_TAU for _, _, gap in parts), parts
            assert out.shape == ref.shape
            worst = plain_gap(out)
            line[-1] += f", worst gap by the CPU forward {worst:.2e}"
            assert worst <= SPEC_TAU, worst
        print(f"phase 34: B={b}, gamma {SPEC['gamma']}, P {SPEC['prompt']} + "
              f"{SPEC['max_new']}: " + "; ".join(line) + f"; on {smi}")
    del corpus_t
    torch.cuda.empty_cache()
    # the trained pair (and the CPU copy) go on to phase 36
    return totals, dict(rows=rows, losses=losses, spec=stats,
                        models=(target, draft, plain_target, corpus))


SYSTEM_PROMPT = 256          # two blocks of 128: the shared prefix


def phase35_system_prompt(dev, smi):
    """The paged engine's shared system prompt on phase 5's model and
    request mix: admission logits through prefill_paged_continued against
    prefill_paged of system + prompt, the prefix blocks allocated once,
    K16 over tables that alias them, and the engine's greedy tokens held
    by the teacher-forced check beside an engine without a prefix run on
    system + prompt."""
    model = serving_model(dev)
    gen = torch.Generator().manual_seed(SEED + 35)
    v, bs = MODEL["vocab_size"], ENGINE["block_size"]
    e, heads = MODEL["dim"], MODEL["num_heads"]
    d = e // heads
    serve_products = ((e, e),) * 4 + ((e, 4 * e), (4 * e, e))
    n_pre = SYSTEM_PROMPT // bs
    system = torch.randint(0, v, (SYSTEM_PROMPT,), generator=gen).tolist()
    reqs = requests()

    # K16 over tables aliasing the prefix blocks, at the serving shape
    slots, mb = ENGINE["slots"], MODEL["max_seq"] // bs
    per_slot = -(-(ENGINE["prompt_pad"] + max(MAX_NEW)) // bs)
    n_blocks = n_pre + slots * per_slot + 1
    tables = torch.zeros(slots, mb, dtype=torch.int32)
    tables[:, :n_pre] = torch.arange(1, n_pre + 1)
    tables[:, n_pre:n_pre + per_slot] = (torch.randperm(
        slots * per_slot, generator=gen) + n_pre + 1).reshape(slots,
                                                              per_slot)
    lengths = torch.tensor([SYSTEM_PROMPT + len(pr) + m // 2
                            for pr, m, _ in reqs[:slots]], dtype=torch.int32)
    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(bf).to(dev)

    sets = [(randn(slots, heads, 1, d), randn(n_blocks, heads, bs, d),
             randn(n_blocks, heads, bs, d), tables.to(dev), lengths.to(dev))
            for _ in range(4)]
    # operations over every row's positions; bytes over the positions the
    # tables reference, the aliased prefix once
    tokens = int(lengths.sum())
    unique = tokens - (slots - 1) * SYSTEM_PROMPT
    row = check_kernel(
        "paged_decode", f"bf16 B={slots} kvh={heads} G=1 D={d} bs={bs}, "
        f"{n_pre} shared prefix blocks, lengths "
        f"{int(lengths.min())}..{int(lengths.max())}",
        lambda *a: paged_decode_attention(*a, scale=d ** -0.5),
        lambda *a: paged_decode_reference(*a, scale=d ** -0.5), sets,
        phase=35, **K16_TOL[bf],
        work=(4 * tokens * heads * d,
              2 * unique * heads * d * 2 + 2 * nbytes(sets[0][0])
              + nbytes(tables, lengths), "bf16"))
    del sets

    # admission: the chunk at offset 256 against a prefill of it all
    pad = ENGINE["prompt_pad"]
    pr = reqs[0][0]
    padded = torch.zeros(1, pad, dtype=torch.int64)
    padded[0, :len(pr)] = torch.tensor(pr)
    table = torch.arange(1, mb + 1, dtype=torch.int32)[None].to(dev)
    with torch.no_grad():
        pools = model.init_paged_cache(mb + 1, bs)
        model.prefill_paged(torch.tensor([system], device=dev), pools,
                            table[:, :n_pre])
        torch.cuda.synchronize()
        backend.reset_launch_counts()
        lg = model.prefill_paged_continued(padded.to(dev), pools, table,
                                           SYSTEM_PROMPT)
        torch.cuda.synchronize()
        adm = {k_: c_ for k_, c_ in backend.launch_counts().items() if c_}
        adm_r = backend.route_counts()
        whole = torch.cat([torch.tensor([system]), padded], 1).to(dev)
        fresh = model.init_paged_cache(mb + 1, bs)
        ref = model.prefill_paged(whole, fresh, table)[:, SYSTEM_PROMPT:]
        rel = rel_l2(lg[0, :len(pr)].float(), ref[0, :len(pr)].float())
        rows_rel = max(rel_l2(pools[i][name][1:1 + mb].float(),
                              fresh[i][name][1:1 + mb].float())
                       for i in range(MODEL["depth"]) for name in ("k", "v"))
    print(f"phase 35: admission of a {len(pr)}-token request (padded to "
          f"{pad}) at offset {SYSTEM_PROMPT}: logits against prefill_paged "
          f"of system + prompt rel L2 {rel:.3e} (tol {MODEL_REL_TOL:.0e}); "
          f"the pools' K/V rows rel L2 {rows_rel:.3e}; launches {adm}, K1 "
          f"by route {adm_r} (plan: "
          f"{step_routes(pad, serve_products, MODEL['depth'])})")
    assert rel <= MODEL_REL_TOL and rows_rel <= MODEL_REL_TOL
    assert adm_r == step_routes(pad, serve_products, MODEL["depth"]), adm_r
    del pools, fresh

    def serve(eng, prefix):
        ids = [eng.submit((prefix or []) + p_, m, **s)
               for p_, m, s in reqs]
        res, wall, counts, routes = counted(eng.run)
        for rid, (_, m, _) in zip(ids, reqs):
            assert len(res[rid]) == m, (rid, len(res[rid]), m)
        return [res[i] for i in ids], wall, counts, routes

    eng = ServingEngine(model, pool_blocks=pool_blocks() + n_pre,
                        system_prompt=system, seed=SEED, **ENGINE)
    free0 = eng.stats()["pool_blocks_free"]
    assert eng.stats()["pool_blocks_total"] == pool_blocks() - 1 == free0
    assert len(eng._prefix_blocks) == n_pre
    outs, wall, counts, routes = serve(eng, None)
    st = eng.stats()
    steps = st["decode_blocks"] * ENGINE["decode_block"]
    splits, _ = paged_plan(slots, heads, 1, d, bs, mb, bf)
    k16_route = f"{'split' if splits > 1 else 'whole'} paged_decode"
    gen_tokens = sum(len(o) for o in outs)
    print(f"phase 35: engine with a {SYSTEM_PROMPT}-token system prompt: "
          f"{len(reqs)} requests ({st['completed']} completed, "
          f"{st['decode_blocks']} decode blocks) in {wall:.2f} s, "
          f"{gen_tokens / wall:.1f} generated tokens/s; prefix blocks "
          f"{eng._prefix_blocks} allocated once, pool free "
          f"{free0} -> {st['pool_blocks_free']}; launches "
          f"{ {k_: c_ for k_, c_ in counts.items() if c_} }; K16 by route "
          f"{ {k_: c_ for k_, c_ in routes.items() if 'paged' in k_} }; "
          f"on {smi}")
    assert st["completed"] == len(reqs) and st["pool_blocks_free"] == free0
    assert counts["paged_decode"] == MODEL["depth"] * steps, counts
    assert routes.get(k16_route) == counts["paged_decode"], routes
    assert counts["flash_fwd_bound"] == 0 and counts["flash_fwd"] == 0

    plain = ServingEngine(model, pool_blocks=ENGINE["slots"] * -(-(
        SYSTEM_PROMPT + ENGINE["prompt_pad"] + max(MAX_NEW)) // bs) + 1,
        seed=SEED, **dict(ENGINE, prompt_pad=SYSTEM_PROMPT
                          + ENGINE["prompt_pad"]))
    outs_p, wall_p, counts_p, _ = serve(plain, system)
    same = sum(a == b_ for a, b_ in zip(outs, outs_p))
    worst = 0.0
    for (pr_, m, s), o, o_p in zip(reqs, outs, outs_p):
        if s:                                  # sampled requests
            continue
        for toks in (o, o_p):
            full = torch.tensor([system + pr_ + toks], device=dev)
            gaps = greedy_gaps(model, full, [SYSTEM_PROMPT + len(pr_)],
                               len(toks))
            worst = max(worst, float(gaps.max()))
    print(f"phase 35: the engine without a prefix on system + prompt "
          f"(prompt_pad {SYSTEM_PROMPT + ENGINE['prompt_pad']}): "
          f"{sum(len(o) for o in outs_p) / wall_p:.1f} generated tokens/s "
          f"against {gen_tokens / wall:.1f} with the prefix; {same} of "
          f"{len(reqs)} requests' tokens identical; teacher-forced check of "
          f"both engines' greedy tokens: worst gap {worst:.4f} (tau "
          f"{GREEDY_TAU['bf16']}); on {smi}")
    assert worst <= GREEDY_TAU["bf16"]
    del eng, plain, model
    release()
    return counts, dict(paged_decode=row, tokens_s=gen_tokens / wall,
                        tokens_s_plain=sum(len(o) for o in outs_p) / wall_p)


# Phase 36: the decode loops replayed as CUDA graphs (utils/graphs.py).
# Each path's greedy tokens must be bit-equal to chip_smoke's own eager
# loop on the same card (decode_step/decode_chunk and argmax, the beam
# loop and both speculative loops written below with host-side control),
# the engines' tokens must pass the teacher-forced check; a replayed step
# must count the launches and K1 routes of the same step called eagerly
# (the step functions called directly), and launch the same port kernels,
# name by name, in a device trace (race).  GRAPH_STEPS decode steps
# (engine: blocks) are timed each way, from the same state, and profiled
# for device busy time.
GRAPH_STEPS = 32
GRAPH_BLOCKS = 3
# steps (blocks) a profile takes for the busy time: a trace of eager
# steps is large to export and read, and the busy time a step is steady
PROFILED = 4
SPEC_SAMPLED_TEMP = 0.8


def port_kernels(names):
    """The port's kernels among traced kernel names (every kernel of
    taper_tpu_torch/csrc lives in namespace taper)."""
    return {k: c for k, c in names.items() if "taper::" in k}


def eager_steps():
    """The decode loops with every captured step called directly: the
    eager form of the same loops (the oracle of the graphs)."""
    return mock.patch.object(graphs.Step, "__call__",
                             lambda self: self.fn())


def graph_bytes(owner):
    """Bytes of ``owner``'s cached programs' graph pools and static
    buffers."""
    progs = graphs.programs(owner)
    return (sum(p.pool_bytes() for p in progs),
            sum(p.nbytes() for p in progs))


def eager_greedy(model, prompt, n, lens=None):
    """chip_smoke's own eager loop: prefill, then decode_step and argmax
    one step at a time at 0-d (or, ``lens``, per-row ``[B]``) device
    positions; the ``[B, n]`` new tokens."""
    b, p = prompt.shape
    with torch.no_grad():
        caches = model.init_cache(b)
        logits = model.prefill(prompt, caches)
        if lens is None:
            pos = torch.full((), p, dtype=torch.long, device=prompt.device)
            tok = logits[:, -1].argmax(-1)
        else:
            pos = lens.clone()
            tok = logits[torch.arange(b, device=prompt.device),
                         lens - 1].argmax(-1)
        out = [tok]
        for _ in range(n - 1):
            tok = model.decode_step(tok, pos, caches).argmax(-1)
            out.append(tok)
            pos = pos + 1
    return torch.stack(out, 1)


@torch.no_grad()
def eager_beam(model, prompt, n, w):
    """chip_smoke's own beam loop (no eos, length penalty 1): prefill,
    then at each step decode_step over the B * W rows, log_softmax, the
    top W of the W * V candidates, and the caches' rows gathered by
    parent beam; ``(tokens [B, W, P + n], scores / n)`` best first, as
    ``beam_search(return_all=True)`` returns them."""
    b, p = prompt.shape
    v, dev = model.vocab_size, prompt.device
    caches = model.init_cache(b)
    logp = torch.log_softmax(model.prefill(prompt, caches)[:, -1].float(),
                             -1)
    scores, tok = torch.topk(logp, w, dim=-1)
    caches = [{k: x.repeat_interleave(w, 0) for k, x in c.items()}
              for c in caches]
    new = tok[..., None]                                  # [B, W, steps]
    base = (torch.arange(b, device=dev) * w)[:, None]
    for j in range(n - 1):
        pos = torch.full((), p + j, dtype=torch.long, device=dev)
        logits = model.decode_step(tok.reshape(b * w), pos, caches)
        logp = torch.log_softmax(logits.float(), -1).reshape(b, w, v)
        scores, idx = torch.topk((scores[..., None] + logp).reshape(b, -1),
                                 w, dim=-1)
        parent, tok = idx // v, idx % v
        new = torch.cat([new.gather(1, parent[..., None].expand(
            -1, -1, new.shape[2])), tok[..., None]], 2)
        flat = (base + parent).reshape(-1)
        caches = [{k: x.index_select(0, flat) for k, x in c.items()}
                  for c in caches]
    norm = scores / torch.full_like(scores, n)
    order = torch.argsort(-norm, dim=1, stable=True)
    tokens = torch.cat([prompt[:, None].expand(b, w, p), new], 2)
    return (tokens.gather(1, order[..., None].expand(b, w, p + n)),
            norm.gather(1, order))


@torch.no_grad()
def eager_spec(target, draft, prompt, n, gamma, per_row):
    """chip_smoke's own greedy speculative loop, its control on the host:
    each round ``gamma`` draft decode_steps from ``cur - 1``, one target
    decode_chunk over the host slice ``tokens[cur - 1:cur + gamma]``, the
    run of drafts agreeing with the target's argmax (each row's, or the
    batch's least in lockstep), the target's token after it, and, only
    after a full acceptance, the draft's step over the last draft token,
    which its cache lacks.  ``(tokens [B, P + n], rounds, acceptance
    histogram)``."""
    b, p = prompt.shape
    dev, total = prompt.device, p + n
    tokens = torch.zeros(b, total + 2 * gamma, dtype=torch.long, device=dev)
    tokens[:, :p] = prompt
    ct, cd = target.init_cache(b), draft.init_cache(b)
    tokens[:, p] = target.prefill(prompt, ct)[:, -1].argmax(-1)
    draft.prefill(prompt, cd)
    cur = np.full(b, p + 1)                  # tokens[r, :cur[r]] are final
    hist = np.zeros(gamma + 1, np.int64)
    rows = torch.arange(b, device=dev)

    def at(x):
        """Positions on the card: [B] per row, 0-d in lockstep."""
        return torch.tensor(x if per_row else x[0], dtype=torch.long,
                            device=dev)
    rounds = 0
    while (cur < total).any():
        done = cur >= total
        for j in range(gamma):
            pos = at(cur - 1 + j)
            if per_row:
                nxt = draft.decode_step(tokens[rows, pos], pos, cd).argmax(-1)
                tokens[rows, pos + 1] = nxt
            else:
                c = int(cur[0]) - 1 + j
                tokens[:, c + 1] = draft.decode_step(tokens[:, c], pos,
                                                     cd).argmax(-1)
        chunk = torch.stack([tokens[r, c - 1:c + gamma]
                             for r, c in enumerate(cur)])
        tgt = target.decode_chunk(chunk, at(cur - 1), ct).argmax(-1).cpu()
        agree = (tgt[:, :gamma] == chunk[:, 1:].cpu()).numpy()
        n_acc = np.cumprod(agree, axis=1).sum(1)
        if not per_row:
            n_acc[:] = n_acc.min()
        n_acc[done] = 0
        live = np.flatnonzero(~done)
        for r in live:
            tokens[r, cur[r] + n_acc[r]] = tgt[r, n_acc[r]]
        np.add.at(hist, n_acc[live] if per_row else n_acc[:1], 1)
        full = n_acc == gamma
        if full.any():
            # rows short of a full acceptance rewrite cur + n_acc, as the
            # next round's first draft step does (one batched step)
            pb = cur + np.where(full, gamma - 1, n_acc)
            pos = at(pb)
            draft.decode_step(tokens[rows, pos] if per_row
                              else tokens[:, int(pb[0])], pos, cd)
        cur = np.where(done, cur, cur + n_acc + 1)
        rounds += 1
    return tokens[:, :total], rounds, torch.from_numpy(hist)


def timed_calls(fn, n, reset=None, profiled=PROFILED):
    """Wall ms a call of ``fn`` over ``n`` calls from a synced device
    (host clock), the device span a call between CUDA events around them,
    and the device busy ms a call from a profile of up to ``profiled``
    more calls; ``reset()`` before each run."""
    for run in (0, 1):
        if reset is not None:
            reset()
        torch.cuda.synchronize()
        if run:
            e0, e1 = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
            t0 = time.perf_counter()
            e0.record()
        for _ in range(n if run else 1):
            fn()
        if run:
            e1.record()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n * 1e3
    span = e0.elapsed_time(e1) / n
    if reset is not None:
        reset()
    prof = profile_steps(fn, min(n, profiled), DECODE_FAMILIES)
    return dict(wall_ms=wall, span_ms=span, busy_ms=prof["busy_ms"],
                device_ops=prof["device_ops"], kernels=prof["kernels"])


# K1's and K16's launches in a trace: one main kernel a wrapper call (K1's
# split-K reduce and K16's merge are second launches of the same call)
TRACE_LAUNCHES = (("linear", ("gemm_wgmma", "gemm_realign", "gemm_decode",
                              "gemm_f32_kernel"), ()),
                  ("paged_decode", ("paged_decode",), ("merge",)))


def traced_launches(kernels):
    """The wrapper launches of K1 (``linear``) and K16 (``paged_decode``,
    both pools) that the traced kernels by name stand for."""
    out = {}
    for name, keys, skip in TRACE_LAUNCHES:
        out[name] = sum(c for k, c in port_kernels(kernels).items()
                        if any(key in k for key in keys)
                        and not any(x in k for x in skip))
    return out


class KeptGraph(torch.cuda.CUDAGraph):
    """A CUDA graph that keeps its node list (the ``cudaGraph_t``,
    ``keep_graph=True``) past the capture, in debug mode, so that
    ``debug_dump`` prints it (PyTorch 2.11 prints only in debug mode, and
    in debug mode alone drops the node list at the capture's end); it is
    instantiated at its first replay, which a Step makes in the call
    that captures it."""

    def __new__(cls, keep_graph=True):
        return super().__new__(cls, True)

    def __init__(self, keep_graph=True):
        super().__init__(True)
        self.enable_debug_mode()


def kept_graphs():
    """The port's steps captured inside keep their node lists for
    :func:`graph_launches` (``graphs.Step`` builds ``torch.cuda.CUDAGraph``
    at its capture)."""
    return mock.patch.object(torch.cuda, "CUDAGraph", KeptGraph)


# a node's statement in the DOT print of a CUDA graph (an edge's second
# node is preceded by "->")
DOT_NODE = re.compile(r'"graph_[^"\n]*node[^"\n]*"\s*\[')


def graph_launches(step):
    """The K1 and K16 launches (as :func:`traced_launches` counts them) of
    one replay of ``step``'s graph, from the graph itself: the driver's
    DOT print of its nodes (``CUDAGraph.debug_dump``, through
    ``cudaGraphDebugDotPrint``), where each kernel node, which a replay
    launches once, stands once with its kernel's name.  A count that
    needs no profiler, which loses records.  The step must have been
    captured under :func:`kept_graphs`.  Returns
    the counts and the graph's node count."""
    assert isinstance(step.graph, KeptGraph), "captured outside kept_graphs"
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "graph.dot")
        step.graph.debug_dump(path)
        with open(path) as f:
            text = f.read()
    starts = [m for m in DOT_NODE.finditer(text)
              if "->" not in text[max(0, m.start() - 4):m.start()]]
    ends = [m.start() for m in starts[1:]] + [len(text)]
    nodes = [text[m.end():e] for m, e in zip(starts, ends)]
    out = {name: sum(1 for n in nodes if any(key in n for key in keys)
                     and not any(x in n for x in skip))
           for name, keys, skip in TRACE_LAUNCHES}
    return out, len(nodes)


def launch_families(counts):
    """Launch counts of the wrappers as :func:`traced_launches` groups
    them (K16's two pools one family)."""
    return {"linear": counts.get("linear", 0),
            "paged_decode": (counts.get("paged_decode", 0)
                             + counts.get("paged_decode_int8", 0))}


def audit_graphs(label, steps):
    """Each captured step's graph holds the K1 and K16 kernel nodes its
    capture counted (what every replay adds), and launches nothing else
    the wrappers count; each graph is audited once.  Returns the steps
    audited here."""
    done = []
    for step in steps:
        if step.graph is None or getattr(step.graph, "audited", False):
            continue
        delta = step._delta[0]
        assert set(delta) <= {"linear", "paged_decode",
                              "paged_decode_int8"}, (label, delta)
        nodes, total = graph_launches(step)
        step.graph.audited = True
        assert nodes == launch_families(delta), (label, nodes, delta, total)
        done.append((nodes, total))
    return done


def race(label, graph_fn, eager_fn, steps, rows, n, reset=None,
         unit="step", profiled=PROFILED):
    """One call of each counted (launches and routes equal), then both
    timed; the graphs of ``steps`` (the captured steps ``graph_fn``
    replays) must hold the K1 and K16 kernel nodes their replays count,
    and a trace of the replays the eager calls' port kernels by name
    (whether every device kernel matched in number too is printed);
    prints and returns the numbers."""
    got = {}
    for name, fn in (("graph", graph_fn), ("eager", eager_fn)):
        if reset is not None:
            reset()
        _, _, counts, routes = counted(fn)
        got[name] = ({k: c for k, c in counts.items() if c}, routes)
    assert got["graph"] == got["eager"], (label, got)
    t = {name: timed_calls(fn, n, reset, profiled) for name, fn in
         (("graph", graph_fn), ("eager", eager_fn))}
    traced = {name: t[name].pop("kernels") for name in t}
    calls = min(n, profiled)
    # the replays' launches from the graph's own node list, against the
    # counts they added; the trace's count printed beside them (the
    # profiler loses records: 767 of 768 kernels of an eager engine block,
    # 142 of 144 K1 launches of four replays, every time in one run); the
    # replays' port kernels the eager steps' by name
    per_call = got["graph"][0]
    audited = audit_graphs(label, steps)
    assert audited and any(s_._delta[0] == per_call for s_ in steps), label
    want = {k: c * calls for k, c in launch_families(per_call).items()}
    seen = traced_launches(traced["graph"])
    assert set(port_kernels(traced["graph"])) == set(
        port_kernels(traced["eager"])), (label, traced)
    assert set(per_call) <= {"linear", "paged_decode",
                             "paged_decode_int8"}, per_call
    ours = port_kernels(traced["graph"])
    same = traced["graph"] == traced["eager"]
    for v in t.values():
        v["tokens_s"] = rows / v["wall_ms"] * 1e3
    print(f"phase 36: {label}: a {unit} replayed {t['graph']['wall_ms']:.3f} "
          f"ms of wall ({t['graph']['span_ms']:.3f} ms device span, "
          f"{t['graph']['busy_ms']:.3f} ms busy, "
          f"{t['graph']['tokens_s']:.1f} tokens/s) against eager "
          f"{t['eager']['wall_ms']:.3f} ms ({t['eager']['span_ms']:.3f} span,"
          f" {t['eager']['busy_ms']:.3f} busy, "
          f"{t['eager']['tokens_s']:.1f} tokens/s): "
          f"{t['eager']['wall_ms'] / t['graph']['wall_ms']:.2f}x; launches "
          f"a {unit} {got['graph'][0]}, K1/K16 routes {got['graph'][1]}, "
          f"equal; the graph's kernel nodes (of {audited[0][1]} nodes) "
          f"{audited[0][0]} a replay, as counted; a trace of {calls} "
          f"replayed saw {seen} of {want} ({sum(ours.values())} port "
          f"kernels of {len(ours)} names, the eager calls' names), "
          f"{sum(traced['graph'].values())} device kernels in all; every "
          f"count equal to the eager trace's: {same} (a trace can miss a "
          f"record)")
    return dict(t, launches=got["graph"][0])


@torch.no_grad()
def phase36_gen_paths(dev, smi):
    """generate, ragged generate, generate_continued and beam_search on
    phase 33's model: graph tokens against the eager loops, a step raced."""
    gen = torch.Generator().manual_seed(SEED + 36)
    model = gen_model(dev)
    b, p, n, c = (GEN_RUN[k] for k in ("batch", "prompt", "max_new",
                                       "chunk"))
    v = GEN["vocab_size"]
    prompt = torch.randint(0, v, (b, p), generator=gen).to(dev)
    new = torch.randint(0, v, (b, c), generator=gen).to(dev)
    lens = torch.randint(p // 2, p + 1, (b,), generator=gen).to(dev)
    rows = torch.arange(b, device=dev)
    out, stats = {}, {}
    totals = {}

    def tally(counts):
        for k_, c_ in counts.items():
            totals[k_] = totals.get(k_, 0) + c_

    model.generate(prompt, n)              # the capture, program cached
    tokens, wall, counts, _ = counted(lambda: model.generate(prompt, n))
    tally(counts)
    ref = eager_greedy(model, prompt, n)
    assert torch.equal(tokens[:, p:], ref), "generate: graph != eager"
    prog = graphs.programs(model)[-1]
    stats["generate"] = race(
        f"generate, {sum(t.numel() for t in model.parameters()) / 1e6:.1f}"
        f"M bf16, B {b}, P {p} + {n} (the call {wall:.3f} s, "
        f"{b * n / wall:.1f} tokens/s with its prefill; tokens bit-equal "
        f"to the eager decode_step/argmax loop)", prog.step, prog.step.fn,
        [prog.step], b, GRAPH_STEPS, reset=lambda: prog.pos.fill_(p))
    out["generate"] = tokens

    tokens, wall, counts, _ = counted(lambda: model.generate(
        prompt, n, prompt_lens=lens))
    tally(counts)
    ref = eager_greedy(model, prompt, n, lens)
    got = torch.stack([tokens[rows, lens + j] for j in range(n)], 1)
    assert torch.equal(got, ref), "ragged generate: graph != eager"
    prog = graphs.programs(model)[-1]
    stats["ragged"] = race(
        f"ragged generate, prompts of {lens.tolist()} (tokens bit-equal to "
        f"the eager loop at per-row positions)", prog.step, prog.step.fn,
        [prog.step], b, GRAPH_STEPS, reset=lambda: prog.pos.copy_(lens))

    _, caches = model.generate(prompt, 1, return_cache=True)
    mirror = [{k_: x.clone() for k_, x in cc.items()} for cc in caches]
    t2, wall, counts, _ = counted(lambda: model.generate_continued(
        new, c, caches, past_len=p))
    tally(counts)
    with torch.no_grad():
        tok = model.decode_chunk(new, torch.full((), p, dtype=torch.long,
                                                 device=dev),
                                 mirror)[:, -1].argmax(-1)
        ref = [tok]
        for j in range(c - 1):
            tok = model.decode_step(tok, torch.full(
                (), p + c + j, dtype=torch.long, device=dev),
                mirror).argmax(-1)
            ref.append(tok)
    assert torch.equal(t2[:, c:], torch.stack(ref, 1)), \
        "generate_continued: graph != eager"
    again = [{k_: x.clone() for k_, x in cc.items()} for cc in mirror]
    with eager_steps():
        _, wall_e, counts_e, _ = counted(lambda: model.generate_continued(
            new, c, again, past_len=p))
    assert counts_e == counts
    print(f"phase 36: generate_continued, a chunk of {c} at {p} then {c} "
          f"tokens over the caller's cache (a step captured for the call): "
          f"tokens bit-equal to the eager decode_chunk/decode_step/argmax "
          f"loop; the call {wall * 1e3:.1f} ms (capture included) against "
          f"{wall_e * 1e3:.1f} ms eager, launches equal")
    stats["continued"] = dict(graph_ms=wall * 1e3, eager_ms=wall_e * 1e3)
    del caches, mirror, again

    bb, w, bn = (GEN_RUN[k] for k in ("beam_batch", "beams", "beam_new"))
    beam = lambda: model.beam_search(prompt[:bb], bn, beams=w,  # noqa: E731
                                     return_all=True)
    got, _, counts, _ = counted(beam)
    tally(counts)
    ref = eager_beam(model, prompt[:bb], bn, w)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), \
        "beam_search: graph != chip_smoke's eager beam loop"
    with eager_steps():
        ref, _, counts_e, _ = counted(beam)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert counts_e == counts
    prog = graphs.programs(model)[-1]
    stats["beam"] = race(
        f"beam_search, beams {w} on {bb} prompts (tokens and scores "
        f"bit-equal to the eager decode_step/topk beam loop)", prog.step,
        prog.step.fn, [prog.step], bb * w, GRAPH_STEPS - 1,
        reset=lambda: prog.pos.fill_(p))
    pool, held = graph_bytes(model)
    print(f"phase 36: phase 33's paths hold "
          f"{len(graphs.programs(model))} programs on the model: graph "
          f"pools {pool / 2 ** 20:.1f} MiB, static buffers and caches "
          f"{held / 2 ** 20:.1f} MiB; on {smi}")
    stats["bytes"] = dict(pool=pool, held=held)
    before = torch.cuda.memory_allocated()
    del model, prog
    release()
    freed = before - torch.cuda.memory_allocated()
    print(f"phase 36: deleting the model freed {freed / 2 ** 20:.1f} MiB "
          f"(its programs went with it)")
    assert freed >= held, (freed, held)
    return totals, stats


@torch.no_grad()
def phase36_spec_paths(dev, smi, target, draft, plain_target, corpus):
    """Speculative decoding on phase 34's trained byte LMs (f32): each
    mode's rounds replayed against its eager rounds at B 1, 4 and 8;
    sampled runs from seeded generators against the CPU forward."""
    # phase 34's programs go: every graph here is captured anew, inside
    # kept_graphs
    graphs.clear(target)
    graphs.clear(draft)
    start = int(len(corpus) * 0.92)
    stats, totals = {}, {}
    for b in SPEC["batches"]:
        pr = torch.from_numpy(np.stack(
            [corpus[start + i * 97:start + i * 97 + SPEC["prompt"]]
             for i in range(b)])).long().to(dev)
        for per_row in (True, False):
            mode = "per row" if per_row else "lockstep"
            run = lambda: target.speculative_generate(  # noqa: E731
                draft, pr, SPEC["max_new"], gamma=SPEC["gamma"],
                return_stats=True, per_row=per_row)
            run()                          # the capture
            (out, st), wall_g, counts, routes = counted(run)
            prof_g = profile_steps(run, 1, DECODE_FAMILIES)
            for k_, c_ in counts.items():
                totals[k_] = totals.get(k_, 0) + c_
            mine, rounds, hist = eager_spec(target, draft, pr,
                                            SPEC["max_new"], SPEC["gamma"],
                                            per_row)
            assert torch.equal(out, mine) and st["rounds"] == rounds \
                and torch.equal(st["accept_hist"].cpu(), hist), (b, mode)
            with eager_steps():
                (ref, st_e), wall_e, counts_e, routes_e = counted(run)
                # the eager rounds' busy time at B 1 (a round's kernels
                # are the graph's; a trace of eager rounds is slow to read)
                prof_e = (profile_steps(run, 1, DECODE_FAMILIES) if b == 1
                          else None)
            assert torch.equal(out, ref) and st["rounds"] == st_e["rounds"] \
                and torch.equal(st["accept_hist"], st_e["accept_hist"]), \
                (b, mode)
            assert counts == counts_e and routes == routes_e, (b, mode)
            # the round graphs hold the K1 launches they count
            audited = audit_graphs(f"speculative {mode}, B {b}", [
                st_ for pg in graphs.programs(target) for st_ in pg.steps()])
            assert audited, (b, mode)
            if prof_e is not None:
                # the same port kernels, by name, in both traces
                assert set(port_kernels(prof_g["kernels"])) == set(
                    port_kernels(prof_e["kernels"])), (b, mode)
            else:
                prof_e = dict(busy_ms=math.nan)
            t_g = dict(wall_ms=wall_g * 1e3, busy_ms=prof_g["busy_ms"])
            t_e = dict(wall_ms=wall_e * 1e3, busy_ms=prof_e["busy_ms"])
            r = st["rounds"]
            stats[(b, mode)] = dict(
                rounds=r, graph_round_ms=t_g["wall_ms"] / r,
                eager_round_ms=t_e["wall_ms"] / r,
                graph_busy_round_ms=t_g["busy_ms"] / r,
                eager_busy_round_ms=t_e["busy_ms"] / r,
                graph_tokens_s=b * SPEC["max_new"] / t_g["wall_ms"] * 1e3,
                eager_tokens_s=b * SPEC["max_new"] / t_e["wall_ms"] * 1e3)
            s = stats[(b, mode)]
            print(f"phase 36: speculative {mode}, B {b}, gamma "
                  f"{SPEC['gamma']}, {SPEC['prompt']} + {SPEC['max_new']}: "
                  f"tokens, rounds and acceptance bit-equal to chip_smoke's "
                  f"eager loop (host-side control, decode_step/decode_chunk"
                  f"/argmax) and to its eager rounds, launches and routes "
                  f"equal"
                  + f", the round graphs' K1 nodes as counted "
                  f"({[n_ for n_, _ in audited]})"
                  + (", traced port kernels equal by name" if b == 1
                     else "")
                  + f"; {r} rounds, a round "
                  f"{s['graph_round_ms']:.3f} ms of wall "
                  f"({s['graph_busy_round_ms']:.3f} busy) replayed against "
                  f"{s['eager_round_ms']:.3f} ("
                  + ("busy not profiled" if math.isnan(
                      s['eager_busy_round_ms'])
                     else f"{s['eager_busy_round_ms']:.3f} busy")
                  + f") eager, the prefills included: "
                  f"{s['graph_tokens_s']:.1f} against "
                  f"{s['eager_tokens_s']:.1f} tokens/s; on {smi}")
    # sampled: the target's generate and per-row speculative decoding,
    # each drawn twice from one seed and once from another
    plen = len(train_bytelm.PROMPT)
    pr = torch.tensor([list(train_bytelm.PROMPT)] * 4, device=dev)
    n = 118
    for label, fn in (
            ("generate", lambda g: target.generate(
                pr, n, temperature=SPEC_SAMPLED_TEMP, generator=g)),
            ("speculative per row", lambda g: target.speculative_generate(
                draft, pr, n, gamma=SPEC["gamma"],
                temperature=SPEC_SAMPLED_TEMP, generator=g))):
        a, b2, c2 = (fn(torch.Generator(dev).manual_seed(s))
                     for s in (SEED + 1, SEED + 1, SEED + 2))
        assert torch.equal(a, b2) and not torch.equal(a, c2), label
        zs = [tempered_z(plain_target, row.tolist(), plen,
                         SPEC_SAMPLED_TEMP)[0] for row in a.cpu()]
        print(f"phase 36: sampled {label} (4 rows, temperature "
              f"{SPEC_SAMPLED_TEMP}, graphs): one seed twice gives the same "
              f"tokens, another seed others; against the CPU forward's "
              f"tempered distributions z {[round(z, 2) for z in zs]} (gate "
              f"<= {SAMPLE_Z})")
        assert all(math.isfinite(z) and z <= SAMPLE_Z for z in zs), zs
    # two replays of one captured sampling step from the same state draw
    # different tokens: the registered generator advances
    g = torch.Generator(dev).manual_seed(SEED + 3)
    target.generate(pr, 4, temperature=SPEC_SAMPLED_TEMP, generator=g)
    prog = graphs.programs(target)[-1]
    draws = []
    for _ in range(2):
        prog.pos.fill_(plen)
        prog.step()
        draws.append(prog.tokens[:, plen + 1].clone())
    assert prog.step.graph is not None and not torch.equal(*draws), draws
    print(f"phase 36: two replays of the sampled step from one state drew "
          f"{draws[0].tolist()} and {draws[1].tolist()}")
    # a fresh generator every call: one program, its state carried in
    # and out (the caller's generator advanced as an eager loop would)
    g = torch.Generator(dev).manual_seed(SEED + 4)
    first = target.generate(pr, 8, temperature=SPEC_SAMPLED_TEMP,
                            generator=g)
    progs = graphs.programs(target)
    second = target.generate(pr, 8, temperature=SPEC_SAMPLED_TEMP,
                             generator=g)
    again = target.generate(pr, 8, temperature=SPEC_SAMPLED_TEMP,
                            generator=torch.Generator(dev).manual_seed(
                                SEED + 4))
    assert torch.equal(first, again) and not torch.equal(first, second)
    assert graphs.programs(target) == progs
    print("phase 36: a sampled generate from a fresh generator each call "
          "takes one program; one generator over two calls draws on, and "
          "its seed again gives the first call's tokens")
    graphs.clear(target)
    return totals, stats


def teacher_forced(model, reqs, outs, tau):
    """Every greedy request's tokens against a forward over its prompt and
    tokens: each within ``tau`` of its position's maximum logit; the
    sampled requests' tokens in the vocabulary.  The worst gap."""
    worst = 0.0
    dev = next(model.parameters()).device
    for (p, m, s), out in zip(reqs, outs):
        assert len(out) == m and all(0 <= t < model.vocab_size for t in out)
        if s.get("temperature"):
            continue
        seq = torch.tensor([p + out], device=dev)
        worst = max(worst, float(greedy_gaps(model, seq, [len(p)], m).max()))
    assert worst <= tau, (worst, tau)
    return worst


@torch.no_grad()
def engine_race(model, reqs, label, kw, smi, tau):
    """The 32-request mix through one engine, with graphs and eager (the
    same seed), tokens equal, the greedy ones passing the teacher-forced
    check at ``tau``; then a block of 16 admitted rows raced."""
    outs, counts = [], []
    for eager in (False, True):
        eng = ServingEngine(model, **kw)
        ids = [eng.submit(p, m, **s) for p, m, s in reqs]
        with (eager_steps() if eager else contextlib.nullcontext()):
            out, wall, cnt, routes = counted(eng.run)
        outs.append([out[i] for i in ids])
        counts.append((cnt, routes, wall, eng.stats()))
    assert outs[0] == outs[1], f"{label}: graph != eager"
    assert counts[0][:2] == counts[1][:2], label
    worst = teacher_forced(model, reqs, outs[0], tau)
    (cnt, _, wall, st), (_, _, wall_e, _) = counts
    tokens = sum(m for _, m, _ in reqs)
    eng = ServingEngine(model, **kw)
    for p, m, s in reqs[:ENGINE["slots"]]:
        eng.submit(p, max(MAX_NEW), **s)
    eng.step()                           # admissions and the warm-up block
    eng._decode_block()                  # the capture

    def eager_block():
        with eager_steps():
            eng._decode_block()
    r = race(f"{label} engine, {ENGINE['slots']} rows (the 32-request mix: "
             f"every request's tokens equal to the eager engine's, each "
             f"greedy token within {worst:.4f} of its position's maximum in "
             f"a teacher-forced forward (tau {tau}); "
             f"{tokens / wall:.1f} generated tokens/s against "
             f"{tokens / wall_e:.1f} eager, admissions and host work "
             f"included)", eng._decode_block, eager_block,
             list(eng._blocks.values()),
             ENGINE["slots"] * ENGINE["decode_block"], GRAPH_BLOCKS,
             unit=f"block of {ENGINE['decode_block']} steps", profiled=1)
    pools = sum(s.pool_bytes for s in eng._blocks.values())
    held = graphs.tensor_bytes(eng._caches)
    print(f"phase 36: {label} engine holds its block graphs' pools "
          f"{pools / 2 ** 20:.1f} MiB beside its cache {held / 2 ** 20:.1f} "
          f"MiB; on {smi}")
    return cnt, dict(r, tokens_s=tokens / wall, eager_tokens_s=tokens / wall_e,
                     pool=pools, cache=held)


@torch.no_grad()
def phase36_serve_paths(dev, smi, reqs):
    """Phase 5's paged bf16 engine and phase 21's contiguous int8 engine
    with their blocks replayed, and offline_serve over the same model and
    requests against standalone generate."""
    model = serving_model(dev)
    totals, stats = {}, {}
    for label, kw, tau in (
            ("paged bf16", dict(ENGINE, pool_blocks=pool_blocks(), seed=SEED),
             GREEDY_TAU["bf16"]),
            ("contiguous int8", dict(ENGINE, quantized_cache=True, seed=SEED),
             GREEDY_TAU["int8"])):
        cnt, stats[label] = engine_race(model, reqs, label, kw, smi, tau)
        for k_, c_ in cnt.items():
            totals[k_] = totals.get(k_, 0) + c_
        torch.cuda.empty_cache()
    pad = ENGINE["prompt_pad"]
    prompts = torch.zeros(len(reqs), pad, dtype=torch.long)
    for i, (p, _, _) in enumerate(reqs):
        prompts[i, :len(p)] = torch.tensor(p)
    lens = [len(p) for p, _, _ in reqs]
    budgets = [m for _, m, _ in reqs]
    kw = dict(slots=ENGINE["slots"])
    offline_serve(model, prompts, lens, budgets, **kw)    # the capture
    (out, n_tok), wall, cnt, _ = counted(lambda: offline_serve(
        model, prompts, lens, budgets, **kw))
    for k_, c_ in cnt.items():
        totals[k_] = totals.get(k_, 0) + c_
    assert n_tok.tolist() == budgets
    # offline_serve is an engine kept on the model; a contiguous bf16
    # engine built here serves the same requests greedily with the same
    # prefill (one padded row) and decode batch (the slots): the same
    # tokens, bit for bit
    (kept,) = graphs.programs(model)
    eng = ServingEngine(model, **dict(ENGINE, seed=SEED))
    ids = [eng.submit(p, m) for p, m, _ in reqs]
    by_engine = eng.run()
    del eng
    assert all(out[i, :m].tolist() == by_engine[rid] for i, (rid, m) in
               enumerate(zip(ids, budgets))), "offline_serve != the engine"
    # standalone generate prefills the unpadded prompt (M = its length,
    # not the padded 512) and decodes one row (M 1, not the slots): K1's
    # tiles and splits, so its roundings, follow M, and a bf16 near-tie
    # may resolve the other way.  Where a request parts, the two tokens'
    # logits in a forward over the common prefix must be that close, and
    # every token of every request passes the teacher-forced check
    parted, worst = [], 0.0
    for i, (p, m, _) in enumerate(reqs):
        ref = model.generate(torch.tensor([p], device=dev), m)[0, len(p):]
        got = out[i, :m].to(dev)
        seq = torch.cat([torch.tensor(p, device=dev), got])[None]
        worst = max(worst, float(greedy_gaps(model, seq, [len(p)], m).max()))
        if not torch.equal(got, ref):
            t = int((got != ref).nonzero()[0])
            lg = model(seq[:, :len(p) + t])[0, -1].float()
            parted.append((i, t, float((lg[got[t]] - lg[ref[t]]).abs())))
        assert not out[i, m:].any()
    assert worst <= GREEDY_TAU["bf16"], worst
    assert all(gap <= GREEDY_TAU["bf16"] for _, _, gap in parted), parted
    with eager_steps():
        _, wall_e, cnt_e, _ = counted(lambda: offline_serve(
            model, prompts, lens, budgets, **kw))
    assert cnt_e == cnt
    tokens = sum(budgets)
    print(f"phase 36: offline_serve of the {len(reqs)} requests "
          f"({kw['slots']} "
          f"slots, contiguous bf16 cache, blocks of "
          f"{kept.decode_block}): {tokens / wall:.1f} generated "
          f"tokens/s ({wall:.3f} s) against {tokens / wall_e:.1f} eager "
          f"(launches equal); every request's tokens bit-equal to the "
          f"contiguous bf16 engine's; against standalone generate "
          f"{len(reqs) - len(parted)} of {len(reqs)} requests equal, the "
          f"others parting at a near-tie (request, position, logit gap) "
          f"{parted}; every token within {worst:.4f} of its row's maximum "
          f"in the teacher-forced forward (tau {GREEDY_TAU['bf16']}); "
          f"launches { {k_: c_ for k_, c_ in cnt.items() if c_} }; on {smi}")
    stats["offline_serve"] = dict(tokens_s=tokens / wall,
                                  eager_tokens_s=tokens / wall_e,
                                  parted=parted)
    del model, kept
    release()
    return totals, stats


def kernel_report(paths, standalone, top=None, routes=None):
    """One entry per kernel: its launches and numbers on each path that
    launched it or measured it (``by_path``); the top-level numbers come
    from the path ``top`` names for it, else the first path with a row
    for it, else from ``standalone``.  K1's rows also give the route and
    K split their call took (``k1_route``, ``splits``; the f32 route's
    tile, ``k1_tile``).  ``routes`` maps a kernel to rows measured alone
    beside the paths' headlines, by label (``routes`` in its entry): the
    routes no path takes, and other shapes of K12's and K13's routes."""
    kernels = []
    for k in backend.KERNELS:
        by_path = {p: dict(launches=c[k], **rep.get(k, {}))
                   for p, (c, rep) in paths.items() if k in rep or c[k]}
        first = next((dict(rep[k]) for p, (_, rep) in paths.items()
                      if k in rep and p == (top or {}).get(k, p)),
                     standalone.get(k))
        extra = {key: first[key] for key in ("k1_route", "splits", "k1_tile",
                                             "k1_staging", "i8_route",
                                             "q8_route",
                                             "k16_route", "chunk")
                 if key in first}
        if "flash_route" in first:
            extra["flash_route"] = first["flash_route"]
        source = (K1_SOURCES.get(first.get("k1_route"))
                  or I8_SOURCES.get(first.get("i8_route"))
                  or Q8_SOURCES.get(first.get("q8_route"))
                  or FLASH_SOURCES.get(first.get("flash_route"), {}).get(k)
                  or SOURCES[k][0])
        kernels.append(dict(
            name=k, route="cuda", source=source,
            replaces=SOURCES[k][1], path="+".join(by_path) or "none",
            launches=sum(r["launches"] for r in by_path.values()),
            max_abs_err=max([r["max_abs_err"] for r in by_path.values()
                             if "max_abs_err" in r]
                            + [first["max_abs_err"]]),
            ms=first["ms"], plain_ms=first["plain_ms"],
            bound_ms=first["bound_ms"], bound_by=first["bound_by"],
            library_ms=first["library_ms"], at=first["at"], **extra,
            by_path=by_path, **({"routes": routes[k]}
                                if k in (routes or {}) else {})))
    return kernels


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)          # phase 1: the line exactly as nvidia-smi gives it
    name = torch.cuda.get_device_name(0)

    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    print(f"phase 2: built {path.name} in {time.perf_counter() - t0:.1f} s")

    serve_report = phase3_kernels(dev)

    reqs = requests()
    card, first_greedy, first_clear = phase4_model(dev, reqs[0][0])

    rate = prefill_rate(card, dev)
    wall, gen_tokens, serve_counts, st = phase5_serve(
        card, reqs, first_greedy, first_clear)
    print(f"phase 5: served {N_REQUESTS} requests ({st['completed']} "
          f"completed, {st['decode_blocks']} decode blocks, "
          f"{st['admission_deferrals']} deferrals) in {wall:.2f} s: "
          f"{gen_tokens / wall:.1f} generated tokens/s, prefill "
          f"{rate:.1f} tokens/s; launches {serve_counts}; on {smi}")
    del card
    torch.cuda.empty_cache()

    cnn_report, resnet_conv_report = phase6_train_kernels(dev)
    t0 = time.perf_counter()
    train, test = MNISTDataset(train=True), MNISTDataset(train=False)
    assert train.source == test.source == "synthetic"
    print(f"data: rendered {len(train)}/{len(test)} synthetic digits in "
          f"{time.perf_counter() - t0:.1f} s")
    phase7_step(dev, train)
    cnn_counts = phase8_train(dev, train, test, smi)
    del train, test

    lm_rows = phase9_lm_kernels(dev)
    realign_rows = phase29_k1_bits(dev)
    _, f32_170m = phase10_lm_step(dev)
    lm_counts, lm_stats = phase11_lm_train(dev, smi)
    fused_counts, _ = phase28_fused_backward(dev, smi, lm_stats)
    torch.cuda.empty_cache()
    long_counts, long_stats = phase30_long_training(dev, smi)
    moe_counts, moe_stats = phase31_moe_training(dev, smi)
    opts_counts, _ = phase32_optimizers(dev, smi)
    sort_counts, sort_rows = phase12_sort_task(dev, smi)
    torch.cuda.empty_cache()

    new_rows = phase13_new_kernels(dev)
    resnet_counts, resnet_rows = phase14_resnet(dev, smi)
    example_counts = phase15_examples(dev, smi)
    torch.cuda.empty_cache()

    quant_rows = phase16_quant_kernels(dev)
    qserve = phase17_quant_serve(dev, smi)
    torch.cuda.empty_cache()
    w8a8_counts, _ = phase18_w8a8(dev, smi)
    torch.cuda.empty_cache()
    ptq_counts = phase19_ptq_example(dev, smi)
    torch.cuda.empty_cache()

    int8_rows = phase20_int8_kernel(dev)
    card = serving_model(dev)
    modes = phase21_serve_modes(card, dev, reqs, smi)
    torch.cuda.empty_cache()
    bench_counts, _, _ = phase22_bench_decode(card, dev, smi)
    del card
    release()
    phase23_checkpoints(dev, smi)

    masked_rows = phase24_masked_kernels(dev)
    packed_counts, _ = phase25_packed_training(dev, smi)
    window_counts, _ = phase26_window_training(dev, smi)
    wdecode_counts, _ = phase27_window_decode(dev, smi)
    t0 = time.perf_counter()
    gen_counts, gen_stats = phase33_generation(dev, smi)
    t1 = time.perf_counter()
    spec_counts, spec_stats = phase34_bytelm_speculative(dev, smi)
    t2 = time.perf_counter()
    prefix_counts, prefix_stats = phase35_system_prompt(dev, smi)
    t3 = time.perf_counter()
    graph_counts = {}
    for part in (lambda: phase36_gen_paths(dev, smi),
                 lambda: phase36_spec_paths(dev, smi,
                                            *spec_stats.pop("models")),
                 lambda: phase36_serve_paths(dev, smi, reqs)):
        t_part = time.perf_counter()
        with kept_graphs():
            counts, _ = part()
        print(f"phase 36: that part took {time.perf_counter() - t_part:.1f} "
              f"s")
        for k_, c_ in counts.items():
            graph_counts[k_] = graph_counts.get(k_, 0) + c_
    print(f"phases 33-36: {t1 - t0:.1f}, {t2 - t1:.1f}, {t3 - t2:.1f} and "
          f"{time.perf_counter() - t3:.1f} s")

    # train_lm: the 170M run's kernels at its shapes (K8's headline: the
    # bound arm in [B, S, H*D], the layout and arm its training takes),
    # and K5 at the sort task's f32 shapes, which launches it
    lm_report = {k: headline(r, {"flash_fwd_bound": 2}.get(k, 1))
                 for k, r in lm_rows.items() if k != "flash_fwd"}
    lm_report["flash_fwd"] = headline(sort_rows["flash_fwd"]
                                      + f32_170m["flash_fwd"])
    # K6's and K7's numbers: the bf16 170M rows; their f32 rows (the sort
    # task's, the f32 step's D 128) listed beside them
    for k in ("flash_dq", "flash_dkv"):
        f32_rows = sort_rows[k] + f32_170m[k]
        lm_report[k] = dict(headline(lm_rows[k] + f32_rows, 1), f32=f32_rows)
    lm_report["adam"] = lm_stats["adam"]
    lm_launches = {k: lm_counts.get(k, 0) + sort_counts.get(k, 0)
                   for k in backend.KERNELS}

    # each path: its launch counts and its kernel rows; the newest path
    # comes first and gives the top-level numbers.  The K2 ops other than
    # relu are on no path (nor are they in the JAX package): their rows
    # come from phase 13 alone, with no launches; so is K15b, the JAX
    # package's exact-integer primitive (linear_w8a8 runs K15a)
    qserve_counts = {k: qserve["int8"]["counts"][k]
                     + qserve["int4"]["counts"][k] for k in backend.KERNELS}
    # headlines: K12/K13 at the decode up-projection (M=8 N=8192 K=2048),
    # K12 and K13 at M=4096 N=8192 on phase 18's path (its K12 and int4
    # forwards), K12 at the first FC on the CNN's;
    # K14 at K=2048, K15a at M=4096 N=K=2048
    # K16 int8's headline: bench_paged_decode's shape (the serving model,
    # bf16 q, 257/4033 positions); the contiguous engines launch no paged
    # kernel, their decode attention is plain PyTorch
    int8_head = int8_rows["paged_decode_int8"][0]
    contig_counts = {k: modes["contig_bf16"]["counts"][k]
                     + modes["contig_int8"]["counts"][k]
                     for k in backend.KERNELS}
    # the newest paths first: the 170M at 16 x 2048 (fused loss, remat;
    # its AdamW row), the MoE model (K1 at the experts' M), the other
    # optimizers; then K10 at the 170M shape, K5/K6/K7 and K11 windowed at
    # the windowed model's, K5/K6/K7 with segment ids at bench_packing's
    # packed batch
    # the generation slice's paths: bench_multiturn's model (K1 at a
    # decode step's, a chunk's and the prefill's rows, K8 at its prefill),
    # the byte LMs' training and speculative decoding (f32 K1, K5, K6,
    # K7, K17a), the engine's shared system prompt (K16 over aliased
    # tables)
    paths = {"graphs": (dict.fromkeys(backend.KERNELS, 0) | graph_counts,
                        {}),
             "serve_prefix": (prefix_counts, dict(
                 paged_decode=prefix_stats["paged_decode"])),
             "bytelm_spec": (spec_counts, {k: headline(r) for k, r in
                                           spec_stats["rows"].items()}),
             "generate": (gen_counts, {k: headline(r) for k, r in
                                       gen_stats["rows"].items()}),
             "train_lm_long": (long_counts, dict(adam=long_stats["adam"])),
             "train_moe": (moe_counts, {k: headline(r) for k, r in
                                        moe_stats["rows"].items()}),
             "train_opts": (opts_counts, {}),
             "train_lm_fused": (fused_counts, {
                 k: headline(r) for k, r in
                 masked_rows["train_lm_fused"].items()}),
             "train_window": (window_counts, {
                 k: headline(r) for k, r in
                 masked_rows["train_window"].items()}),
             "train_packed": (packed_counts, {
                 k: headline(r) for k, r in
                 masked_rows["train_packed"].items()}),
             "decode_window": (wdecode_counts, {}),
             "serve_int8": (modes["paged_int8"]["counts"], dict(
                 paged_decode_int8=headline(
                     int8_rows["paged_decode_int8"]))),
             "serve_contig": (contig_counts, {}),
             "bench_decode": (bench_counts, dict(
                 paged_decode_int8=int8_head,
                 paged_decode=headline(int8_rows["paged_decode"]))),
             "serve_quant": (qserve_counts, dict(
                 linear_q8=headline(quant_rows["linear_q8"], 2),
                 linear_q4=headline(quant_rows["linear_q4"], 2))),
             "prefill_w8a8": (w8a8_counts, dict(
                 linear_q8=headline(quant_rows["linear_q8"], 5),
                 linear_q4=headline(quant_rows["linear_q4"], 5),
                 quantize_rows=headline(quant_rows["quantize_rows"]),
                 matmul_int8_scaled=headline(
                     [r for r in quant_rows["matmul_int8_scaled"]
                      if r["i8_route"] == "wgmma"]))),
             "ptq_example": (ptq_counts, dict(
                 linear_q8=headline(quant_rows["linear_q8"], 7))),
             "train_resnet": (resnet_counts,
                              dict(relu=new_rows["relu"], **resnet_rows,
                                   **resnet_conv_report)),
             "examples": (example_counts, dict(sgd=new_rows["sgd"])),
             "train_lm": (lm_launches, lm_report),
             "train_cnn": (cnn_counts, cnn_report),
             "serve": (serve_counts, serve_report)}
    # routes no path takes, measured alone: K1's realign (phase 29), K15's
    # mma; K12's/K13's rows beside their headlines (phase 16): the mma route
    # at ragged K, misaligned codes and the 10-way head, K13's wgmma at the
    # FC layer's M
    off_path = {k: {"realign": realign_rows[k]} for k in K1_MODES}
    off_path["linear"]["realign view"] = realign_rows["linear_view"]
    off_path.update({k: {"mma": headline(
        [r for r in quant_rows[k] if r["i8_route"] == "mma"])}
        for k in I8_NAMES})
    off_path.update({k: {r["label"]: r for r in quant_rows[k]
                         if "label" in r} for k in Q_NAMES})
    # K1's top-level numbers: the 170M (e, 4e) projection, the main path's
    # largest; K8's: the 170M model's bound arm (train_packed also has a
    # K8 row, at the padded batch's shape); K6's and K7's: the 170M shape
    # in [B, S, H*D]; K3a's and K3b's: the CNN's 32->32 28x28 (ResNet-8's
    # rows stay under by_path)
    kernels = kernel_report(paths, dict(
        new_rows, matmul_int8=headline(
            [r for r in quant_rows["matmul_int8"]
             if r["i8_route"] == "wgmma"])),
        top=dict(dict.fromkeys(K1_MODES, "train_lm"),
                 flash_fwd_bound="train_lm", flash_dq="train_lm",
                 flash_dkv="train_lm", conv_fwd="train_cnn",
                 conv_dw="train_cnn", adam="train_lm",
                 flash_fwd="train_window", paged_decode="bench_decode"),
        routes=off_path)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
