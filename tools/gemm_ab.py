"""Times K1 (the GEMM of ``taper_tpu_torch/ops/gemm.py``) at the shapes of
the port's paths, and K15 (the int8 product of ``ops/quant.py``), in one
checkout, on an NVIDIA GPU:

    python tools/gemm_ab.py [CHECKOUT] [--only LABEL ...]

The shapes: the 170M model's projections (bf16, 16,384 tokens, (K_in,
N_out) = (e, e), (e, 4e), (4e, e)), the sort task's (f32, 8,192 tokens),
ResNet-8's patch GEMMs and head (f32, 65,536 / 16,384 / 256 rows), the
reference CNN's FC layers (f32, batch 256), each in modes nt (forward,
with bias), nn (dX) and tn (dW); serving's decode (M = 1, 8 and 16) and
prefill (M = 512) projections and the quantized-serving baseline's bf16
up projection (M = 8, K_in 2,048, N_out 8,192) (bf16, nt); one bf16
product whose K_in of 1,001 is not a multiple of 8 (no TMA: the realign
route); and K15b (``matmul_int8``, int32 out) and K15a
(``matmul_int8_scaled``, bf16 out with a bias) at the W8A8 prefill's
three shapes (M 4,096; (N, K) = (2,048, 2,048), (8,192, 2,048), (2,048,
8,192)) and at K 2,050 (no TMA: the mma route); and K12 (``linear_q8``,
f32 activations, int8 codes, f32 out with a bias) and K13 (``linear_q4``,
int4 codes) at the same three shapes, on the kernel its checkout picks
("K12", "K13"); the odd shapes of K12/K13 (the PTQ example's 10-way head
at M 2,000, its FC layer's shape in int4, ragged K at M 8 and 4,096, and
codes 1 byte off at M 4,096: "odd", timed where the checkout takes them,
"refused" where it raises); then phase 18's K12 and K13 forwards
(chip_smoke's W8A8 model, int8 through K12 with TAPER_W8A8=0, and the
same dense weights in int4 through K13: ms a forward by the host clock,
and its device busy ms and K12's or K13's share of them from a profile of
two forwards).  It calls only ``linear(x, w, b)``, ``gemm(a, b, mode)``,
``matmul_int8(xq, q)``, ``matmul_int8_scaled(...)``, ``linear_q8(...)``
and ``linear_q4(...)``, which every version of the port with the
quantized kernels has.  ``--only`` keeps the shapes whose label starts
with one of the given words (``--only serve`` times the serving shapes
alone, ``--only realign int8`` the realign route and K15, ``--only q8``
K12 and its forward, ``--only q4`` K13 and its forward, ``--only odd``
the odd shapes).

CHECKOUT (default: this one) is the root of a checkout of the repository
(for example a parent commit unpacked with ``git archive`` into a
directory that .gitignore lists); its kernels are built there on first
use.  Each shape is timed three times with chip_smoke.cuda_ms over operand
copies past the L2.  The last line of the output is one JSON object:
``{"root", "device", "ms": {shape: [three times]}}``.  To compare two
commits, run both in one machine in turns: parent, change, change,
parent.
"""

import argparse
import json
import os
import sys
from pathlib import Path

ARGS = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ARGS.add_argument("checkout", nargs="?",
                  default=str(Path(__file__).resolve().parents[1]))
ARGS.add_argument("--only", nargs="+", default=None)
OPTS = ARGS.parse_args()
ROOT = Path(OPTS.checkout).resolve()
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
from taper_tpu_torch.ops import _build  # noqa: E402
from taper_tpu_torch.ops.gemm import gemm, linear  # noqa: E402
from taper_tpu_torch.ops.quant import (  # noqa: E402
    linear_q4, linear_q8, matmul_int8, matmul_int8_scaled)

BF, F32 = torch.bfloat16, torch.float32
E, SORT_E = 1024, 128
# (label, dtype, rows, K_in, N_out, modes)
SHAPES = (
    [(f"170M ({k},{n})", BF, 16384, k, n, "nt nn tn")
     for k, n in ((E, E), (E, 4 * E), (4 * E, E))]
    + [(f"sort ({k},{n})", F32, 8192, k, n, "nt nn tn")
       for k, n in ((SORT_E, SORT_E), (SORT_E, 4 * SORT_E),
                    (4 * SORT_E, SORT_E))]
    + [(f"resnet ({k},{n})", F32, t, k, n, "nt nn tn")
       for t, k, n in ((65536, 144, 32), (65536, 16, 32), (16384, 288, 64),
                       (16384, 32, 64), (256, 64, 10))]
    + [(f"cnn ({k},{n})", F32, 256, k, n, "nt nn tn")
       for k, n in ((128, 128), (128, 64), (64, 10))]
    + [(f"serve M={m} ({k},{n})", BF, m, k, n, "nt")
       for m in (1, 8, 16, 512) for k, n in ((E, E), (E, 4 * E), (4 * E, E))]
    + [("serve M=8 baseline (2048,8192)", BF, 8, 2048, 8192, "nt")]
    + [("realign K_in 1001 (1001,1000)", BF, 512, 1001, 1000, "nt nn tn")])
# K15: (label, M, N, K); modes "b" (K15b, int32) and "a" (K15a, bf16 + bias)
INT8_SHAPES = [(f"int8 M=4096 (N,K)=({n},{k})", 4096, n, k)
               for n, k in ((2048, 2048), (8192, 2048), (2048, 8192),
                            (2048, 2050))]
# K12 and K13: (label, bits, M, N, K, the codes' offset in bytes)
Q_SHAPES = ([(f"q{b} M=4096 (N,K)=({n},{k})", b, 4096, n, k, 0)
             for b in (8, 4)
             for n, k in ((2048, 2048), (8192, 2048), (2048, 8192))]
            + [("odd q8 PTQ head M=2000 (N,K)=(10,64)", 8, 2000, 10, 64, 0),
               ("odd q4 M=2000 (N,K)=(128,128)", 4, 2000, 128, 128, 0)]
            + [(f"odd q{b} ragged M={m} (N,K)=(2048,{k})", b, m, 2048, k, 0)
               for b, m, k in ((8, 8, 2056), (4, 8, 2064), (8, 4096, 2050),
                               (4, 4096, 2050))]
            + [(f"odd q{b} q 1 byte off M=4096 (N,K)=(2048,2048)", b, 4096,
                2048, 2048, 1) for b in (8, 4)])


def operands(dtype, t, k_in, n_out, mode, gen):
    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * scale).to(dtype)

    if mode == "nt":
        return (randn(t, k_in), randn(n_out, k_in, scale=k_in ** -0.5),
                randn(n_out, scale=0.1))
    if mode == "nn":
        return randn(t, n_out), randn(n_out, k_in, scale=n_out ** -0.5)
    return randn(t, n_out, scale=t ** -0.5), randn(t, k_in)


def int8_operands(m, n, k, gen):
    """Codes, the W8A8 row vectors and a bias, on the card."""
    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=gen,
                             device="cuda", dtype=torch.int8)

    xq, q = codes(m, k), codes(n, k)
    sx = torch.rand(m, generator=gen, device="cuda") * 0.01
    sw = torch.rand(n, generator=gen, device="cuda") * 1e-3
    zw = torch.randint(-5, 5, (n,), generator=gen, device="cuda").float()
    bias = torch.randn(n, generator=gen, device="cuda") * 0.1
    return xq, q, sx, xq.float().sum(1), sw, zw, bias


def k15a(xq, q, sx, corr, sw, zw, bias):
    return matmul_int8_scaled(xq, q, sx, corr, sw, zw, bias,
                              out_dtype=torch.bfloat16)


def q_operands(bits, m, n, k, off, gen):
    """f32 activations, random int8 codes [N, K] or packed int4 codes [N K
    / 2] (``off`` bytes off the 16-byte grid), a per-channel scale and
    zero point as [N] vectors (every version passes them as they are),
    and a bias, on the card."""
    x = torch.randn(m, k, generator=gen, device="cuda")
    if bits == 8:
        q = torch.randint(-128, 128, (n, k), generator=gen, device="cuda",
                          dtype=torch.int8)
    else:
        q = torch.randint(0, 256, (n * k // 2,), generator=gen,
                          device="cuda", dtype=torch.uint8)
    if off:
        q = C.misaligned(q, off)
    scale = torch.full((n,), 2e-4, device="cuda")
    zp = torch.full((n,), -3.0, device="cuda")
    return x, q, scale, zp, torch.randn(n, generator=gen, device="cuda") * 0.1


def q_forward(bits):
    """Phase 18's K12 (``bits`` 8) or K13 (4) forward: ms a forward by the
    host clock, three times, and the device busy ms and K12's or K13's ms
    of a profiled forward (the families whose names hold "K12" or
    "K13")."""
    gen = torch.Generator().manual_seed(C.SEED)
    dense = C.TinyGPT(**C.W8A8, compute_dtype=BF)
    dense.reset_parameters(gen)
    qmodel = C.quantize_params(dense, C.QuantizationConfig(
        qtype=C.QuantizationType.INT8 if bits == 8
        else C.QuantizationType.INT4)).cuda()
    del dense
    toks = torch.randint(0, C.W8A8["vocab_size"],
                         (C.W8A8_BATCH, C.W8A8["max_seq"]),
                         generator=gen).cuda()
    os.environ["TAPER_W8A8"] = "0"
    wall = [round(C.w8a8_forward(qmodel, toks)[1], 3) for _ in range(3)]

    def forward():
        with torch.no_grad():
            qmodel(toks)
    prof = C.profile_steps(forward, 2, C.W8A8_FAMILIES)
    key = "K12" if bits == 8 else "K13"
    mine = sum(v for f, v in prof["ms"].items() if key in f)
    return wall, round(prof["busy_ms"], 4), round(mine, 4)


def main():
    _build.library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    calls = {"nt": lambda x, w, b: linear(x, w, b),
             "nn": lambda a, b: gemm(a, b, "nn"),
             "tn": lambda a, b: gemm(a, b, "tn")}
    ms = {}
    for label, dtype, t, k_in, n_out, modes in SHAPES:
        if OPTS.only and not any(label.startswith(w) for w in OPTS.only):
            continue
        for mode in modes.split():
            sets = C.cold_sets(*operands(dtype, t, k_in, n_out, mode, gen))
            ms[f"{label} {mode}"] = [round(C.cuda_ms(calls[mode], sets), 4)
                                     for _ in range(3)]
            del sets
        torch.cuda.empty_cache()
    for label, m, n, k in INT8_SHAPES:
        if OPTS.only and not any(label.startswith(w) for w in OPTS.only):
            continue
        args = int8_operands(m, n, k, gen)
        for name, fn, sets in (
                ("K15b", matmul_int8, C.cold_sets(*args[:2])),
                ("K15a", k15a, C.cold_sets(*args))):
            ms[f"{label} {name}"] = [round(C.cuda_ms(fn, sets), 4)
                                     for _ in range(3)]
            del sets
        del args
        torch.cuda.empty_cache()
    for label, bits, m, n, k, off in Q_SHAPES:
        if OPTS.only and not any(label.startswith(w) for w in OPTS.only):
            continue
        args = q_operands(bits, m, n, k, off, gen)
        sets = [args] + [tuple(t.clone() for t in args)
                         for _ in range(C.copies_for(*args) - 1)]
        if off:   # each copy's codes off the grid too
            sets = [args] + [a[:1] + (C.misaligned(a[1], off),) + a[2:]
                             for a in sets[1:]]
        fn = linear_q8 if bits == 8 else (
            lambda x, q, s, z, b, k=k: linear_q4(x, q, s, z, b, n_features=k))
        name = f"{label} K1{2 if bits == 8 else 3}"
        try:
            fn(*sets[0])
        except ValueError as e:   # a checkout whose K12/K13 refuse it
            ms[name] = f"refused: {e}"
            continue
        ms[name] = [round(C.cuda_ms(fn, sets), 4) for _ in range(3)]
        del sets, args
        torch.cuda.empty_cache()
    for bits in (8, 4):
        label = f"q{bits} forward"
        if not OPTS.only or any(label.startswith(w) for w in OPTS.only):
            wall, busy, mine = q_forward(bits)
            ms[label] = wall
            ms[f"{label} busy"] = [busy]
            ms[f"{label} K1{2 if bits == 8 else 3}"] = [mine]
    print(json.dumps({"root": str(ROOT),
                      "device": torch.cuda.get_device_name(0),
                      "ms": ms}), flush=True)


if __name__ == "__main__":
    main()
