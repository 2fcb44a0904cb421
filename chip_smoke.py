"""Drive the PyTorch + CUDA port once on one NVIDIA GPU, through the
hand-written kernels: paged TinyGPT serving at full width, then training
the reference MNIST CNN at its published widths.

    python3 chip_smoke.py

Phases (each prints one line or more; any failure raises and exits
non-zero):
  1. the card: ``torch.cuda.is_available()`` and nvidia-smi's name and
     power limit;
  2. build the CUDA kernels from ``taper_tpu_torch/csrc``;
  3. each serving kernel against its plain PyTorch version at the serving
     slice's shapes, with the max error beside the stated tolerance and
     CUDA-event times of both;
  4. the full-width model (random weights from a seed): prefill logits and
     one paged decode step on the card (bf16) against the same weights in
     f32 through the plain path on the CPU;
  5. serve 32 requests through ``ServingEngine``; every request must
     complete with its token count and every serving kernel must have
     launched;
  6. each training kernel (GEMM mode nt with bias and epilogue, modes
     nn/tn, direct convolution forward and input gradient, convolution
     weight gradient, pooling) against its plain version at the CNN's f32
     shapes, batch 256;
  7. one CNN training step on the card against the same step on the CPU
     (same initial weights, same batch): loss within 1e-5 relative of an
     independent CPU run; every parameter's gradient within 1e-4 relative
     L2 of a CPU run whose backward sees the card's forward values (the
     same ReLU and max-pool decisions; see ``phase7_step``), and within
     1e-2 of the independent CPU run;
  8. train the CNN with ``Trainer.fit_device`` for 2 epochs on the
     synthetic 60k/10k set (Adam 3e-3, wd 1e-4, StepLR(5, 0.8), batch
     256), evaluate on all 10k test images: accuracy >= 0.95, and every
     training kernel must have launched.
The line before the last is the kernel report (JSON), one entry per
kernel with its numbers per path under ``by_path``; the last line is
``{"ok": true, "device": {...}}``.
"""

import copy
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from taper_tpu_torch import optim
from taper_tpu_torch.data import MNISTDataset
from taper_tpu_torch.models import TinyGPT, mnist_cnn
from taper_tpu_torch.ops import _build, backend
from taper_tpu_torch.ops import conv_direct as CD
from taper_tpu_torch.ops import pool as PL
from taper_tpu_torch.ops.attention import attention, attention_reference
from taper_tpu_torch.ops.gemm import (
    gemm, gemm_reference, linear, linear_reference)
from taper_tpu_torch.ops.paged_attention import (
    paged_decode_attention, paged_decode_reference)
from taper_tpu_torch.serve import ServingEngine
from taper_tpu_torch.train import Trainer

SEED = 0
MODEL = dict(vocab_size=4096, dim=1024, depth=8, num_heads=8, max_seq=4096,
             rope=True)                      # bench.py:214, ~105M params
ENGINE = dict(slots=16, block_size=128, prompt_pad=512, decode_block=16)
MAX_NEW = (16, 48, 128)                      # benchmarks/bench_serving.py
N_REQUESTS = 32
# Tolerances on the card:
#  * GEMM: bf16 operands, f32 accumulation in both; products of bf16
#    values are exact in f32, so only the summation order differs.
#  * attention: the kernel rounds running-max-relative softmax weights to
#    bf16 where the plain version rounds the normalised ones, and the bf16
#    output keeps 8 bits.
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
TOL = {"linear": 2e-4, "flash_fwd": 2e-2, "paged_decode": 2e-2,
       "gemm_nn": 1e-4, "gemm_tn": 1e-4, "conv_fwd": 1e-4, "conv_dw": 1e-4,
       "pool": 1e-6}
LINEAR_F32_TOL = 1e-4           # linear on the training path (f32 FMA)
NORMWISE = ("conv_dw",)
MODEL_REL_TOL = 3e-2
STEP_LOSS_TOL, STEP_GRAD_TOL, STEP_GRAD_IND_TOL = 1e-5, 1e-4, 1e-2
SOURCES = {
    "linear": ("taper_tpu_torch/csrc/gemm.cu",
               "taper_tpu/ops/pallas/gemm.py:83"),
    "gemm_nn": ("taper_tpu_torch/csrc/gemm.cu",
                "taper_tpu/ops/pallas/gemm.py:83"),
    "gemm_tn": ("taper_tpu_torch/csrc/gemm.cu",
                "taper_tpu/ops/pallas/gemm.py:83"),
    "flash_fwd": ("taper_tpu_torch/csrc/flash_fwd.cu",
                  "taper_tpu/ops/pallas/attention.py:217"),
    "paged_decode": ("taper_tpu_torch/csrc/paged_decode.cu",
                     "taper_tpu/ops/pallas/paged_attention.py:158"),
    "conv_fwd": ("taper_tpu_torch/csrc/conv_direct.cu",
                 "taper_tpu/ops/pallas/conv_direct.py:135"),
    "conv_dw": ("taper_tpu_torch/csrc/conv_direct.cu",
                "taper_tpu/ops/pallas/conv_direct.py:153"),
    "pool": ("taper_tpu_torch/csrc/pool.cu",
             "taper_tpu/ops/pallas/pool.py:43"),
}
# The kernels each path must launch.
SERVE_KERNELS = ("linear", "flash_fwd", "paged_decode")
TRAIN_KERNELS = ("linear", "gemm_nn", "gemm_tn", "conv_fwd", "conv_dw",
                 "pool")
# The reference CNN's training run (examples/train_mnist_cnn.py)
CNN = dict(batch=256, lr=3e-3, weight_decay=1e-4, step_size=5, gamma=0.8,
           epochs=2, min_acc=0.95, eval_batch=2000)


def cuda_ms(fn, arg_sets, iters=30):
    """Mean CUDA-event time of ``fn(*args)``, cycling through ``arg_sets``
    (copies that together exceed the 50 MB L2 where the caller would find
    its operands cold)."""
    for args in arg_sets[:3]:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def within(out, ref, tol, normwise=False):
    """Max abs error, and whether |out - ref| <= tol * (1 + |ref|), or
    with ``normwise`` <= tol * max |ref|."""
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    bound = tol * (ref.abs().max() if normwise else 1 + ref.abs())
    return float(err.max()), bool((err <= bound).all())


def check_kernel(name, shape, kernel_fn, plain_fn, arg_sets, phase=3,
                 tol=None):
    tol = TOL[name] if tol is None else tol
    out = kernel_fn(*arg_sets[0])
    torch.cuda.synchronize()
    err, ok = within(out, plain_fn(*arg_sets[0]), tol,
                     normwise=name in NORMWISE)
    ms = cuda_ms(kernel_fn, arg_sets)
    plain_ms = cuda_ms(plain_fn, arg_sets)
    scale = "max |ref|" if name in NORMWISE else "(1 + |ref|)"
    print(f"phase {phase}: {name} {shape}: max_abs_err {err:.3e} "
          f"(tol {tol:.0e} * {scale}) kernel {ms:.4f} ms "
          f"plain {plain_ms:.4f} ms")
    assert ok, f"{name} {shape} disagrees with its plain version"
    return err, ms, plain_ms


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
            rows.append(((m, k, n), check_kernel(
                "linear", f"M={m} K={k} N={n}", linear, linear_reference,
                sets)))
    # headline shape: the decode MLP up-projection
    head = dict(rows)[(16, 1024, 4096)]
    report["linear"] = dict(
        at="bf16 M=16 K=1024 N=4096 (+bias)",
        max_abs_err=max(r[1][0] for r in rows), ms=head[1], plain_ms=head[2])

    # flash prefill: one padded prompt, 8 heads of 128, causal
    sets = [tuple(randn(1, 8, 512, 128) for _ in range(3))]
    err, ms, plain_ms = check_kernel(
        "flash_fwd", "B=1 H=8 S=512 D=128 causal",
        lambda q, k, v: attention(q, k, v, causal=True),
        lambda q, k, v: attention_reference(q, k, v, causal=True), sets)
    report["flash_fwd"] = dict(at="bf16 B=1 H=8 S=512 D=128 causal",
                               max_abs_err=err, ms=ms, plain_ms=plain_ms)

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
    err, ms, plain_ms = check_kernel(
        "paged_decode", f"B={slots} kvh=8 G=1 D=128 bs={bs} "
        f"lengths {lengths.min().item()}..{lengths.max().item()}",
        lambda *a: paged_decode_attention(*a, scale=scale),
        lambda *a: paged_decode_reference(*a, scale=scale), sets)
    report["paged_decode"] = dict(
        at=f"bf16 B={slots} kvh=8 G=1 D=128 bs={bs} mixed lengths",
        max_abs_err=err, ms=ms, plain_ms=plain_ms)
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


def copies_for(*tensors, cold_bytes=128e6):
    """Operand copies that together exceed the 50 MB L2."""
    size = sum(t.numel() * t.element_size() for t in tensors
               if t is not None)
    return max(1, math.ceil(cold_bytes / size))


def phase6_train_kernels(dev):
    """The training kernels at the CNN's f32 shapes (batch 256)."""
    gen = torch.Generator().manual_seed(SEED)
    rows = {}

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    def run(name, shape, kernel_fn, plain_fn, make, tol=None):
        first = make()
        sets = [first] + [make() for _ in range(copies_for(*first) - 1)]
        rows.setdefault(name, []).append((shape, check_kernel(
            name, shape, kernel_fn, plain_fn, sets, phase=6, tol=tol)))

    n = CNN["batch"]
    # FC forward: y = act(X[n, K] . W[N, K]^T + b) (nt, the f32 kernel)
    for k, nout, act in ((128, 128, "relu"), (128, 64, "relu"),
                         (64, 10, "none")):
        run("linear", f"{act}([{n},{k}].[{nout},{k}]^T + b)",
            lambda x, w, b, act=act: linear(x, w, b, act),
            lambda x, w, b, act=act: linear_reference(x, w, b, act),
            lambda k=k, nout=nout: (randn(n, k), randn(nout, k,
                                                       scale=k ** -0.5),
                                    randn(nout, scale=0.1)),
            tol=LINEAR_F32_TOL)
    # FC backward: dX = g[n, N] . W[N, K] (nn), dW = g^T . X[n, K] (tn)
    for k, nout in ((128, 128), (128, 64), (64, 10)):
        run("gemm_nn", f"[{n},{nout}].[{nout},{k}]",
            lambda a, b: gemm(a, b, "nn"),
            lambda a, b: gemm_reference(a, b, "nn"),
            lambda: (randn(n, nout), randn(nout, k)))
        run("gemm_tn", f"[{n},{nout}]^T.[{n},{k}]",
            lambda a, b: gemm(a, b, "tn"),
            lambda a, b: gemm_reference(a, b, "tn"),
            lambda: (randn(n, nout), randn(n, k)))
    # conv forward (bias + relu) and the input gradients of layers 2-5
    # (no bias, flipped weights), 3x3, pad 1
    fwd = [(1, 32, 28), (32, 32, 28), (32, 64, 14), (64, 64, 14),
           (64, 128, 7)]
    dx = [(32, 32, 28), (64, 32, 14), (64, 64, 14), (128, 64, 7)]
    for (c, o, hw), what in ([(f, "fwd") for f in fwd]
                             + [(d, "dX") for d in dx]):
        act = "relu" if what == "fwd" else "none"

        def make(c=c, o=o, hw=hw, what=what):
            b = randn(o, scale=0.1) if what == "fwd" else None
            return (randn(n, c, hw, hw), randn(o, c, 3, 3,
                                               scale=(9 * c) ** -0.5), b)
        run("conv_fwd", f"{what} {c}->{o} {hw}x{hw}",
            lambda x, w, b, act=act: CD.conv_fwd(x, w, b, (1, 1), act),
            lambda x, w, b, act=act: CD.conv2d_reference(x, w, b, (1, 1),
                                                         act),
            make)
    # weight gradients of the 5 convs
    for c, o, hw in fwd:
        run("conv_dw", f"{c}->{o} {hw}x{hw}",
            lambda x, g: CD.conv_dw(x, g, (3, 3), (1, 1)),
            lambda x, g: CD.conv_dw_reference(x, g, (3, 3), (1, 1)),
            lambda c=c, o=o, hw=hw: (randn(n, c, hw, hw),
                                     randn(n, o, hw, hw)))
    # pools: max 2x2 at 28x28 and 14x14, global 7x7 average
    for shape, k, mode in (((n, 32, 28, 28), 2, "max"),
                           ((n, 64, 14, 14), 2, "max"),
                           ((n, 128, 7, 7), 7, "avg")):
        pool, ref = ((PL.max_pool2d, PL.max_pool2d_reference)
                     if mode == "max"
                     else (PL.avg_pool2d, PL.avg_pool2d_reference))
        run("pool", f"{mode} {k}x{k} {list(shape)}",
            lambda x, k=k, pool=pool: pool(x, kernel=k),
            lambda x, k=k, ref=ref: ref(x, k, k),
            lambda shape=shape: (randn(*shape),))

    heads = {"linear": 0, "gemm_nn": 0, "gemm_tn": 0, "conv_fwd": 1,
             "conv_dw": 1, "pool": 0}
    report = {}
    for name, results in rows.items():
        shape, (_, ms, plain_ms) = results[heads[name]]
        report[name] = dict(at=f"f32 {shape}",
                            max_abs_err=max(r[1][0] for r in results),
                            ms=ms, plain_ms=plain_ms)
    return report


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
    # the final evaluation is one validation pass at the same batch size;
    # fit_device ran one per epoch besides its training steps
    per_eval = {k: counts[k] - fit_counts[k] for k in TRAIN_KERNELS}
    per_step = {k: (fit_counts[k] - CNN["epochs"] * per_eval[k])
                / (steps * CNN["epochs"]) for k in TRAIN_KERNELS}
    print(f"phase 8: trained mnist_cnn {CNN['epochs']} epochs x {steps} "
          f"steps (batch {CNN['batch']}, synthetic {len(train)}/{len(test)}) "
          f"in {wall:.2f} s: epoch times {m.epoch_times} s, "
          f"{steps * CNN['batch'] / epoch_s:.1f} samples/s; train loss "
          f"{m.train_loss}, val acc {m.val_acc}; final evaluation on all "
          f"{len(test)} test images: loss {ev['loss']:.4f} acc "
          f"{ev['acc']:.4f} (gate {CNN['min_acc']}); launches {counts}, "
          f"per training step {per_step}, per evaluation pass of "
          f"{len(test)} images {per_eval}; on {smi}")
    assert ev["acc"] >= CNN["min_acc"], ev
    assert all(counts[k] > 0 for k in TRAIN_KERNELS), counts
    return counts


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
    wall, gen_tokens, counts, st = phase5_serve(card, reqs, first_greedy,
                                                first_clear)
    print(f"phase 5: served {N_REQUESTS} requests ({st['completed']} "
          f"completed, {st['decode_blocks']} decode blocks, "
          f"{st['admission_deferrals']} deferrals) in {wall:.2f} s: "
          f"{gen_tokens / wall:.1f} generated tokens/s, prefill "
          f"{rate:.1f} tokens/s; launches {counts}; on {smi}")
    del card
    torch.cuda.empty_cache()

    train_report = phase6_train_kernels(dev)
    t0 = time.perf_counter()
    train, test = MNISTDataset(train=True), MNISTDataset(train=False)
    assert train.source == test.source == "synthetic"
    print(f"data: rendered {len(train)}/{len(test)} synthetic digits in "
          f"{time.perf_counter() - t0:.1f} s")
    phase7_step(dev, train)
    train_counts = phase8_train(dev, train, test, smi)

    # each path: its kernels, their launch counts and their phase report
    paths = {"serve": (SERVE_KERNELS, counts, serve_report),
             "train": (TRAIN_KERNELS, train_counts, train_report)}
    kernels = []
    for k in backend.KERNELS:
        by_path = {p: dict(launches=c[k], **rep[k])
                   for p, (ks, c, rep) in paths.items() if k in ks}
        # the top-level times are the first path's headline shape; the
        # error is the worst over every path
        first = next(iter(by_path.values()))
        kernels.append(dict(
            name=k, route="cuda", source=SOURCES[k][0],
            replaces=SOURCES[k][1], path="+".join(by_path),
            launches=sum(r["launches"] for r in by_path.values()),
            max_abs_err=max(r["max_abs_err"] for r in by_path.values()),
            ms=first["ms"], plain_ms=first["plain_ms"], at=first["at"],
            by_path=by_path))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
