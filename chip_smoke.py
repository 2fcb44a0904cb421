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
through ring caches, the opt-in backwards K10 and K11).

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
     accuracy must reach 0.9, with exact launch counts per step;
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
     phases 17-19: K12/K13 (``linear_q8``/``linear_q4``) at decode (M=8)
     and K12 at M=4096 and at the CNN's FC layers (M=2000), within 2e-4;
     K14 (``quantize_rows``), K15b (``matmul_int8``) and K15a
     (``matmul_int8_scaled``) exactly; ``torch._int_mm`` is K15b's
     library call, the others have none;
 17. PTQ serving of benchmarks/bench_serving.py:39-52's model (dim 2048,
     depth 6, 273M parameters, f32) with int8 and int4 weights in the
     paged engine (the bench's contiguous cache runs in phase 21): prefill
     and decode logits against the port's CPU path with the same
     weights, exactly 36 K12/K13 launches per decode step, 8 requests of
     200 new tokens served, tokens/s beside f32, a profile of the decode
     step in each format;
 18. bench.py:273-301's W8A8 prefill (dim 2048, depth 4, bf16, every 2-D
     leaf int8, 4 x 1024 tokens): TAPER_W8A8=1 runs 24 K14 and 24 K15a,
     the same weights through K12, the bf16 dense model through K1;
     W8A8 logits against K12's, ms for each;
 19. examples/ptq_quantize.py through its entry point with --epochs 1:
     int8 accuracy within 0.01 of f32, float16 within 0.001, three K12
     launches per eval batch of 2000;
 20. K16 over int8 pools (``paged_decode_int8``) against its plain
     version at bench_paged_decode's shapes (16 rows, 8 KV heads, G 1,
     D 128, block 128, 257/4033 positions, bf16 q) and at phase 17's
     model shape (4 KV heads, G 4, f32 q), with the bound of the live
     int8 rows, their scales, q and o; the bf16 kernel at the same mixed
     lengths beside it;
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
     non-causal windowed in f32 at a small shape; K5/K6/K7 with
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
     and with K11 (K6's and K7's calls by route against the plans)
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
     (wgmma, wmma, decode) and mode, the kernel writing bf16 equals its
     own f32 result cast to bf16; split-K calls (bf16 wgmma, f32) give the
     same bits twice; the wmma route timed at a K of 1,001 (no TMA).
Every K1 row (phases 3, 6, 9, 12, 14) names the route and K split that
``ops.gemm.plan`` gives its operands (``via wgmma x2``) and checks that
the call took them (``backend.route_counts()``); phases 11 and 14 hold a
step's K1 calls by route to what ``plan`` predicts for its shapes.  Every
K8, K6, K7 and K10 row names the route ``plan_fwd`` or ``plan_bwd``
gives it and checks that the call took it;
phases 11, 12, 25, 26 and 28 hold a step's flash calls by route to the
plans.
The line before the last is the kernel report (JSON), one entry per
kernel with its numbers per path under ``by_path``; K1's entries give
their route and K split (``k1_route``, ``splits``), K8's, K6's, K7's and
K10's their route (``flash_route``), the top-level numbers
from the 170M model's (e, 4e) projection; the last line is
``{"ok": true, "device": {...}}``.
"""

import copy
import importlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from taper_tpu_torch import optim
from taper_tpu_torch.data import (
    CIFAR10Dataset, MNISTDataset, pack_documents, packing_efficiency)
from taper_tpu_torch.examples import (
    ptq_quantize, train_cifar10_resnet, train_mnist, train_tinylm, train_xor)
from taper_tpu_torch.models import (
    TinyGPT, mnist_cnn, mnist_mlp, resnet8, xor_mlp)
from taper_tpu_torch.ops import _build, backend
from taper_tpu_torch.ops import conv_direct as CD
from taper_tpu_torch.ops import elementwise as EW
from taper_tpu_torch.ops import optim_kernels as OK
from taper_tpu_torch.ops import pool as PL
from taper_tpu_torch.ops import quant as Q
from taper_tpu_torch.ops.gemm import (
    gemm, gemm_reference, linear, linear_reference, plan, plan_for)
from taper_tpu_torch.ops.paged_attention import (
    paged_decode_attention, paged_decode_reference)
from taper_tpu_torch.quantization import (
    QuantizationConfig, QuantizationType, quantize, quantize_params,
    quantized_bytes)
from taper_tpu_torch.quantization.ptq import replace_leaf
from taper_tpu_torch.serve import ServingEngine
from taper_tpu_torch.train import Trainer

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
       "paged_decode": 2e-2, "gemm_nn": 1e-4, "gemm_tn": 1e-4,
       "conv_fwd": 1e-4, "conv_dw": 1e-4, "pool": 1e-6,
       # the quantized kernels (reasons at QSERVE below)
       "linear_q8": 2e-4, "linear_q4": 2e-4, "quantize_rows": 0.0,
       "matmul_int8_scaled": 0.0, "matmul_int8": 0.0}
LINEAR_F32_TOL = 1e-4           # linear on the training path (f32 FMA)
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
K1_SOURCES = {"wgmma": "taper_tpu_torch/csrc/gemm_sm90.cu"}
# The flash kernels' routes (ops.attention.plan_fwd, plan_bwd): a flash
# row's source follows its route too; "wmma" (f32) keeps SOURCES'
# flash_bwd.cu
FLASH_SOURCES = {
    "wgmma": {"flash_fwd_bound": "taper_tpu_torch/csrc/flash_sm90.cu",
              "flash_dq": "taper_tpu_torch/csrc/flash_bwd_sm90.cu",
              "flash_dkv": "taper_tpu_torch/csrc/flash_sm90.cu",
              "flash_bwd_fused": "taper_tpu_torch/csrc/flash_sm90.cu"}}


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
    "flash_fwd": ("taper_tpu_torch/csrc/flash_fwd.cu",
                  "taper_tpu/ops/pallas/attention.py:217"),
    "flash_fwd_bound": ("taper_tpu_torch/csrc/flash_sm90.cu",
                        "taper_tpu/ops/pallas/attention.py:357"),
    "flash_dq": ("taper_tpu_torch/csrc/flash_bwd.cu",
                 "taper_tpu/ops/pallas/attention.py:487"),
    "flash_dkv": ("taper_tpu_torch/csrc/flash_bwd.cu",
                  "taper_tpu/ops/pallas/attention.py:687"),
    "flash_dkv_t": ("taper_tpu_torch/csrc/flash_bwd.cu",
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
    statistic is max |out - ref| / (1 + |ref|); "max" |out - ref| <= tol *
    max |ref|, the statistic is max |out - ref| / max |ref|; "tiles" each
    64-row tile of a ``[B, H, S, D]`` tensor within ``tol`` relative L2 of
    its own norm, plus TILE_ATOL per entry (RMS) where that norm is ~0,
    the statistic is the worst tile's ratio."""
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    if how == "tiles":
        e, r = tile_norms(out, ref)
        floor = TILE_ATOL * (TILE * ref.shape[-1]) ** 0.5 / tol
        stat = float((e / (r + floor)).max())
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
    checks that the call took them; a K8, K6, K7 or K10 row is given the
    route ``plan_fwd`` or ``plan_bwd`` gives (``flash_route``) and checks
    it the same way.  Returns the report row."""
    mode = K1_MODES.get(name)
    if mode is not None:
        route, splits = plan_for(*arg_sets[0][:2], mode)
    before = backend.route_counts()
    outs = _tuple(kernel_fn(*arg_sets[0]))
    torch.cuda.synchronize()
    taken = {k: c - before.get(k, 0)
             for k, c in backend.route_counts().items()
             if c != before.get(k, 0)}
    if mode is not None:
        assert taken == {route_key(route, mode, splits): 1}, (name, taken)
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
    """Two calls of K6 or K7 (``kernel`` ``"flash_dq"`` or
    ``"flash_dkv"``) on the same inputs give the same bits (a fixed order
    of sums, no atomics)."""
    first = getattr(A, kernel)(*args, **kw)
    again = getattr(A, kernel)(*args, **kw)
    same = all(torch.equal(a, b) for a, b in zip(first, again))
    print(f"phase {phase}: {kernel} {label}: two calls bit-equal: {same}")
    assert same, (kernel, label)


def flash_routes(layers, dtype, mask, backward="split"):
    """The flash calls a step makes by route, as ``plan_fwd`` and
    ``plan_bwd`` predict them: one forward
    a layer (one that ``plan_fwd`` sends to K5 has no route) and one
    backward: ``backward`` "split" K6 + K7, "dkv_t" K6 + K11 (K11 has no
    route), "fused" K10, None none."""
    want = {}
    fwd = A.plan_fwd(dtype, mask)
    if fwd != "exact":
        want[f"{fwd} flash_fwd_bound"] = layers
    if backward in ("split", "dkv_t"):
        want[f"{A.plan_bwd(dtype)} flash_dq"] = layers
    if backward == "split":
        want[f"{A.plan_bwd(dtype)} flash_dkv"] = layers
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


def lm_flash_rows(dev, b, h, s, d, dtype, phase, gen, layouts, fwd_arms):
    """The flash kernels at one attention shape (causal, MHA) against the
    plain versions: the forward arms ``fwd_arms`` (of ``"exact"``,
    ``"bound"``, ``"bound_off"``) then K6 and K7, in each layout."""
    kind = "bf16" if dtype == torch.bfloat16 else "f32"
    f32 = dtype == torch.float32
    scale = d ** -0.5
    q, k, v, do = ((torch.randn(b, h, s, d, generator=gen)).to(dtype).to(dev)
                   for _ in range(4))
    io = nbytes(q)                          # one q/k/v/o-sized tensor
    rows_bytes = 4 * b * h * s              # one [B*H, S] f32 row vector
    plain_fwd = A.attention_lse_reference
    ref_o, ref_lse = plain_fwd(q, k, v, causal=True, scale=scale)
    ref = A.flash_bwd_reference(q, k, v, ref_o, ref_lse, do, True, scale)

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
            if arm == "exact":
                name, fn = "flash_fwd", lambda *a, heads=heads: \
                    A.flash_fwd_exact(*a, causal=True, scale=scale,
                                      heads=heads)
                route = None
            else:
                name = "flash_fwd_bound"
                fn = lambda *a, heads=heads, arm=arm: A.flash_fwd_bound(
                    *a, scale=scale, heads=heads,
                    force_bound=arm == "bound")
                route = A.plan_fwd(dtype, "causal")
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
            if route is not None:
                k8_alone(rows[name][-1], fsets, scale, heads, arm == "bound",
                         phase)
        del fsets
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
                ("wmma", "nt", 33, 70, 130), ("wmma", "nn", 33, 70, 130),
                ("wmma", "tn", 33, 70, 130),
                ("decode", "nt", 16, 1024, 1024))
K1_REPEAT_CASES = (("tn", 1024, 1024, 16384, torch.bfloat16),
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


def phase29_k1_bits(dev):
    """K1 on the card, bit for bit: (a) for each bf16 route and mode, the
    kernel writing bf16 equals its own f32 result cast to bf16 (one
    round-to-nearest-even of the same f32 value); (b) a split-K call
    repeats its bits (the splits summed in a fixed order, no atomics).
    Also times the wmma route against its plain version; returns its
    rows."""
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
    # the wmma route's time (no path shape takes it: every path's operands
    # are TMA-aligned): K_in of 1,001
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
    assert all(r["k1_route"] == "wmma" for r in rows.values()), rows
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
    return results


# every K1 kernel: the wgmma route, the WMMA tiles (wmma, decode), the f32
# tile, and the split-K reduce of both
K1_FAMILIES = (("K1 gemm", "gemm_wgmma"), ("K1 gemm", "gemm_bf16_kernel"),
               ("K1 gemm", "gemm_f32"), ("K1 gemm", "splitk_reduce"))
OPT_FAMILY = ("K17 optimizer", "multi_tensor_kernel")
# the flash kernels by name: the WMMA/FMA ones of flash_fwd.cu and
# flash_bwd.cu and the wgmma ones of flash_sm90.cu and flash_bwd_sm90.cu
# (namespace taper::flash::sm90)
LM_FAMILIES = K1_FAMILIES + (OPT_FAMILY,
                             ("K8/K5 flash fwd", "flash_fwd_kernel"),
                             ("K8/K5 flash fwd", "sm90::fwd_bound_kernel"),
                             ("K6 flash dq", "flash_dq_kernel"),
                             ("K6 flash dq", "sm90::dq_kernel"),
                             ("K7 flash dkv", "flash_dkv_kernel"),
                             ("K7 flash dkv", "sm90::dkv_kernel"))
CONV_FAMILIES = K1_FAMILIES + (("K3a conv fwd/dX", "conv_fwd"),
                 ("K3b conv dW", "conv_dw"), ("K3b conv dW", "split_sum"),
                 ("K4 pool", "pool_"), ("K2 elementwise", "ew_kernel"),
                 OPT_FAMILY)


def profile_steps(step, n, families=LM_FAMILIES):
    """Device time of ``n`` steps by kernel family, from a torch.profiler
    trace: the union of the device intervals (busy) against the host
    clock (wall), and each family's summed kernel time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    spans, by_family, glue = [], {}, {}
    for ev in events:
        if ev.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
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
                glue_top={k: v / n / 1e3 for k, v in top})


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
QSERVE_REL_TOL, W8A8_REL_TOL = 1e-2, 5e-2
PTQ_INT8_DROP, PTQ_F16_DROP = 0.01, 0.001
QUANT_FAMILIES = (("K12/K13 linear_q", "linear_q_kernel"),
                  ("K16 paged decode", "paged_decode")) + K1_FAMILIES + (
                  ("head sgemm", "gemm"),
                  ("K14 quantize_rows", "quantize_rows"),
                  ("K15 int8 mma", "matmul_int8"))


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


def phase16_quant_kernels(dev):
    """K12, K13, K14, K15a/b against their plain versions at the shapes of
    phases 17-19, with the bound and the library call where one exists."""
    gen = torch.Generator().manual_seed(SEED)
    rows = {}

    def add(name, *args, **kw):
        rows.setdefault(name, []).append(check_kernel(
            name, *args, phase=16, **kw))

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen).to(dtype).to(dev)

    dq_note = []
    # K12 / K13 at the decode shapes of phase 17 (M = 8 rows: wq/wo, wk/wv,
    # w1, w2), K12 at the W8A8 prefill's M = 4096 (phase 18's K12 run) and
    # at the CNN's FC layers at an eval batch of 2000 (phase 19)
    d = QSERVE["dim"]
    kv = d // QSERVE["num_heads"] * QSERVE["num_kv_heads"]
    decode = ((d, d), (kv, d), (4 * d, d), (d, 4 * d))
    pm, pd = W8A8_BATCH * W8A8["max_seq"], W8A8["dim"]
    prefill = ((pd, pd), (4 * pd, pd), (pd, 4 * pd))
    cases = ([(QSERVE_REQUESTS, n, k, bits) for bits in (8, 4)
              for n, k in decode]
             + [(pm, n, k, 8) for n, k in prefill]
             + [(2000, n, k, 8) for n, k in ((128, 128), (64, 128),
                                             (10, 64))])
    for m, n, k, bits in cases:
        name = f"linear_q{bits}"
        act = "relu" if m == 2000 and n != 10 else "none"

        def make(m=m, n=n, k=k, bits=bits):
            w = qweight(gen, n, k, bits, dev)
            return (randn(m, k), w.values, w.scale, w.zero_point,
                    randn(n) * 0.1)
        first = make()
        sets = [first] + [make() for _ in range(copies_for(*first) - 1)]
        if bits == 8:
            kern = (lambda x, q, s, z, b, act=act:
                    Q.linear_q8(x, q, s, z, b, epilogue=act))
            plain = (lambda x, q, s, z, b, act=act:
                     Q.linear_q8_reference(x, q, s, z, b, act))
        else:
            kern = (lambda x, q, s, z, b, k=k:
                    Q.linear_q4(x, q, s, z, b, n_features=k))
            plain = (lambda x, q, s, z, b, k=k:
                     Q.linear_q4_reference(x, q, s, z, b, n_features=k))
        add(name, f"M={m} N={n} K={k} {act} (+bias)", kern, plain, sets,
            work=qlinear_work(m, n, k, bits))
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
    # beside K12 (ROADMAP Queue 3 records W8A8's engage rule)
    for m, n, k in ([(pm, n, k) for n, k in prefill]
                    + [(QSERVE_REQUESTS, pd, pd)]):
        xq = torch.randint(-127, 128, (m, k), generator=gen,
                           dtype=torch.int8).to(dev)
        q = torch.randint(-128, 128, (n, k), generator=gen,
                          dtype=torch.int8).to(dev)
        if m > 16:
            assert torch.equal(Q.matmul_int8(xq, q),
                               Q.matmul_int8_reference(xq, q)), \
                "K15b is not exact"
            add("matmul_int8", f"M={m} N={n} K={k}", Q.matmul_int8,
                Q.matmul_int8_reference, cold_sets(xq, q),
                # [K, N] in column-major: cuBLASLt's int8 layout
                library_fn=lambda xq, q: torch._int_mm(xq, q.t()),
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
        add("matmul_int8_scaled", f"M={m} N={n} K={k} bf16 (+bias)", k15a,
            k15a_plain, cold_sets(*args),
            work=(2 * m * n * k, m * k + n * k + 8 * m + 12 * n
                  + 2 * m * n, "int8"))
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
    seconds, tokens, launch counts and engine stats."""
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
    counts = backend.launch_counts()
    for rid in ids:
        assert len(out[rid]) == QSERVE_NEW, (rid, len(out[rid]))
        assert all(0 <= t < QSERVE["vocab_size"] for t in out[rid]), rid
    return wall, sum(len(out[i]) for i in ids), counts, eng.stats()


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
        wall, toks, counts, st = qserve_run(card, prompts)
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
    (K14 + K15a), the same weights through K12, and the bf16 dense model
    through K1."""
    gen = torch.Generator().manual_seed(SEED)
    dense = TinyGPT(**W8A8, compute_dtype=torch.bfloat16)
    dense.reset_parameters(gen)
    qmodel = quantize_params(
        dense, QuantizationConfig(qtype=QuantizationType.INT8)).to(dev)
    dense.to(dev)
    toks = torch.randint(0, W8A8["vocab_size"],
                         (W8A8_BATCH, W8A8["max_seq"]), generator=gen)
    toks = toks.to(dev)
    n_lin = 6 * W8A8["depth"]
    runs = {}
    for name, model, w8a8, want in (
            ("w8a8", qmodel, "1", dict(quantize_rows=n_lin,
                                       matmul_int8_scaled=n_lin)),
            ("int8 K12", qmodel, "0", dict(linear_q8=n_lin)),
            ("bf16 dense", dense, "0", dict(linear=n_lin))):
        os.environ["TAPER_W8A8"] = w8a8
        try:
            torch.cuda.synchronize()
            backend.reset_launch_counts()
            with torch.no_grad():
                model(toks)
            torch.cuda.synchronize()
            counts = {k: c for k, c in backend.launch_counts().items() if c}
            logits, ms = w8a8_forward(model, toks)
        finally:
            os.environ.pop("TAPER_W8A8")
        want.update(flash_fwd_bound=W8A8["depth"])
        assert counts == want, (name, counts)
        assert torch.isfinite(logits).all()
        runs[name] = dict(logits=logits.float().cpu(), ms=ms, counts=counts)
        print(f"phase 18: {name} forward of {W8A8_BATCH} x "
              f"{W8A8['max_seq']} tokens: {ms:.2f} ms; launches {counts}")
    rel = rel_l2(runs["w8a8"]["logits"], runs["int8 K12"]["logits"])
    rel_dense = rel_l2(runs["int8 K12"]["logits"],
                       runs["bf16 dense"]["logits"])
    print(f"phase 18: W8A8 logits vs the same int8 weights through K12: "
          f"rel L2 {rel:.3e} (tol {W8A8_REL_TOL:.0e}, the activation "
          f"rounding); K12 vs bf16 dense {rel_dense:.3e} (the weight "
          f"rounding); W8A8 {runs['w8a8']['ms']:.2f} ms, K12 "
          f"{runs['int8 K12']['ms']:.2f} ms, bf16 dense "
          f"{runs['bf16 dense']['ms']:.2f} ms; on {smi}")
    assert rel <= W8A8_REL_TOL, rel
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
    counts = backend.launch_counts()
    # the int8 model: one diagnostic batch of 256 and the 10k test split
    # in 5 eval batches of 2000, three int8 FC layers each
    batches = 10000 // 2000
    per_batch = (counts["linear_q8"] - 3) / batches
    f32 = res["f32"]["acc"]
    print(f"phase 19: examples/ptq_quantize.py --epochs 1 in "
          f"{time.perf_counter() - t0:.1f} s (the example's default of 2 "
          f"epochs meets the Adam spike from this seed on the card, phase "
          f"8): " + "; ".join(
              f"{k} acc {r['acc']:.4f} drop {f32 - r['acc']:+.4f} "
              f"{r['bytes'] / 1e6:.3f} MB eval {r['eval_s']:.3f} s max "
              f"logit diff {r['max_logit_diff']:.5f}"
              for k, r in res.items())
          + f"; K12 launches per eval batch of 2000: {per_batch:g}; on "
          f"{smi}")
    assert abs(res["int8"]["acc"] - f32) <= PTQ_INT8_DROP, res
    assert abs(res["float16"]["acc"] - f32) <= PTQ_F16_DROP, res
    assert per_batch == 3, counts
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
# orders), and round o to q's dtype: 2e-2 (1 + |ref|) with bf16 q (8
# bits), 1e-4 with f32 q.
INT8_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
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
        tol=INT8_TOL[q.dtype],
        work=(4 * live * q.shape[2] * d,
              2 * live * (d + 4) + 2 * nbytes(q), "f32"))


def phase20_int8_kernel(dev):
    """K16's int8 branch at bench_paged_decode's shapes (bf16 q) and at
    phase 17's model shape (kvh 4, G 4, f32 q), with the bf16 kernel at
    the same mixed lengths beside it."""
    gen = torch.Generator().manual_seed(SEED)
    b, bs = BENCH["batch"], BENCH["bs"]
    mb = BENCH["smax"] // bs
    lens = [BENCH["short"] if i % 2 == 0 else BENCH["long"]
            for i in range(b)]
    tables, n_blocks = bench_tables(lens, mb, bs)
    tables = torch.from_numpy(tables).to(dev)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev) + 1
    kvh = MODEL["num_heads"]
    q = torch.randn(b, kvh, 1, 128, generator=gen).to(torch.bfloat16).to(dev)
    span = f"lengths {BENCH['short'] + 1}/{BENCH['long'] + 1}"
    rows = {"paged_decode_int8": [int8_row(
        "paged_decode_int8", f"bf16 q B={b} kvh={kvh} G=1 D=128 bs={bs} "
        f"mb={mb} {span}", q, int8_pools(gen, n_blocks, kvh, bs, 128, dev),
        tables, lengths)]}
    kp, vp = (torch.randn(n_blocks, kvh, bs, 128, generator=gen).to(
        torch.bfloat16).to(dev) for _ in range(2))
    tokens = int(lengths.sum())
    rows["paged_decode"] = check_kernel(
        "paged_decode", f"bf16 B={b} kvh={kvh} G=1 D=128 bs={bs} {span}",
        lambda *a: paged_decode_attention(*a, scale=128 ** -0.5),
        lambda *a: paged_decode_reference(*a, scale=128 ** -0.5),
        cold_sets(q, kp, vp, tables, lengths), phase=20,
        work=(4 * tokens * kvh * 128,
              2 * tokens * kvh * 128 * 2 + 2 * nbytes(q), "bf16"))
    del kp, vp
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
                               kind))]}
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
                  4 * io + 2 * rows_b + 2 * 4 * b * h * s * d, kind))]
        del part
    del ref, bsets, dsets
    torch.cuda.empty_cache()
    return rows


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
    non-causal windowed in f32 at a small one), K5/K6/K7 with segment ids
    at bench_packing's packed batch, and K10 at the 170M shape raced
    against K6 + K7 and SDPA's backward."""
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
ATTN_FAMILIES = (("attention forward", "flash_fwd_kernel"),
                 ("attention forward", "fwd_bound_kernel"),
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
    # the band: the windowed backward (K6 and K7 visit the window's tiles
    # only) costs less than the full-causal one, both on their wgmma
    # kernels
    assert prof_w["ms"]["attention backward"] < prof_f["ms"][
        "attention backward"]
    # and the windowed forward less than a full-causal forward on the same
    # kernel: the full-causal model's forward is K8, of another design, so
    # K5 runs the whole triangle (no window) on the same inputs
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
    torch.cuda.empty_cache()
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


def kernel_report(paths, standalone, top=None):
    """One entry per kernel: its launches and numbers on each path that
    launched it or measured it (``by_path``); the top-level numbers come
    from the path ``top`` names for it, else the first path with a row
    for it, else from ``standalone``.  K1's rows also give the route and
    K split their call took (``k1_route``, ``splits``)."""
    kernels = []
    for k in backend.KERNELS:
        by_path = {p: dict(launches=c[k], **rep.get(k, {}))
                   for p, (c, rep) in paths.items() if k in rep or c[k]}
        first = next((dict(rep[k]) for p, (_, rep) in paths.items()
                      if k in rep and p == (top or {}).get(k, p)),
                     standalone.get(k))
        extra = ({} if "k1_route" not in first else
                 dict(k1_route=first["k1_route"], splits=first["splits"]))
        if "flash_route" in first:
            extra["flash_route"] = first["flash_route"]
        source = (K1_SOURCES.get(first.get("k1_route"))
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
            by_path=by_path))
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
    phase29_k1_bits(dev)
    phase10_lm_step(dev)
    lm_counts, lm_stats = phase11_lm_train(dev, smi)
    fused_counts, _ = phase28_fused_backward(dev, smi, lm_stats)
    torch.cuda.empty_cache()
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
    torch.cuda.empty_cache()
    phase23_checkpoints(dev, smi)

    masked_rows = phase24_masked_kernels(dev)
    packed_counts, _ = phase25_packed_training(dev, smi)
    window_counts, _ = phase26_window_training(dev, smi)
    wdecode_counts, _ = phase27_window_decode(dev, smi)

    # train_lm: the 170M run's kernels at its shapes (K8's headline: the
    # bound arm in [B, S, H*D], the layout and arm its training takes),
    # and K5 at the sort task's f32 shapes, which launches it
    lm_report = {k: headline(r, {"flash_fwd_bound": 2}.get(k, 1))
                 for k, r in lm_rows.items() if k != "flash_fwd"}
    lm_report["flash_fwd"] = headline(sort_rows["flash_fwd"])
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
    # K12 at M=4096 N=8192 on the W8A8 path, at the first FC on the CNN's;
    # K14 at K=2048, K15a at M=4096 N=K=2048
    # K16 int8's headline: bench_paged_decode's shape (the serving model,
    # bf16 q, 257/4033 positions); the contiguous engines launch no paged
    # kernel, their decode attention is plain PyTorch
    int8_head = int8_rows["paged_decode_int8"][0]
    contig_counts = {k: modes["contig_bf16"]["counts"][k]
                     + modes["contig_int8"]["counts"][k]
                     for k in backend.KERNELS}
    # this slice's paths first: K10 at the 170M shape, K5/K6/K7 and K11
    # windowed at the windowed model's, K5/K6/K7 with segment ids at
    # bench_packing's packed batch
    paths = {"train_lm_fused": (fused_counts, {
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
                 paged_decode=int8_rows["paged_decode"])),
             "serve_quant": (qserve_counts, dict(
                 linear_q8=headline(quant_rows["linear_q8"], 2),
                 linear_q4=headline(quant_rows["linear_q4"], 2))),
             "prefill_w8a8": (w8a8_counts, dict(
                 linear_q8=headline(quant_rows["linear_q8"], 5),
                 quantize_rows=headline(quant_rows["quantize_rows"]),
                 matmul_int8_scaled=headline(
                     quant_rows["matmul_int8_scaled"]))),
             "ptq_example": (ptq_counts, dict(
                 linear_q8=headline(quant_rows["linear_q8"], 7))),
             "train_resnet": (resnet_counts,
                              dict(relu=new_rows["relu"], **resnet_rows,
                                   **resnet_conv_report)),
             "examples": (example_counts, dict(sgd=new_rows["sgd"])),
             "train_lm": (lm_launches, lm_report),
             "train_cnn": (cnn_counts, cnn_report),
             "serve": (serve_counts, serve_report)}
    # K1's top-level numbers: the 170M (e, 4e) projection, the main path's
    # largest; K8's: the 170M model's bound arm (train_packed also has a
    # K8 row, at the padded batch's shape); K6's and K7's: the 170M shape
    # in [B, S, H*D]; K3a's and K3b's: the CNN's 32->32 28x28 (ResNet-8's
    # rows stay under by_path)
    kernels = kernel_report(paths, dict(
        new_rows, matmul_int8=headline(quant_rows["matmul_int8"])),
        top=dict(dict.fromkeys(K1_MODES, "train_lm"),
                 flash_fwd_bound="train_lm", flash_dq="train_lm",
                 flash_dkv="train_lm", conv_fwd="train_cnn",
                 conv_dw="train_cnn"))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
