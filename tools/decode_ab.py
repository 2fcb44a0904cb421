"""Times the decode kernels K16 (paged decode attention) and K12/K13 (the
int8/int4 weight-only products) at the shapes of the port's decode
paths, in one checkout, on an NVIDIA GPU:

    python tools/decode_ab.py [CHECKOUT] [--only LABEL ...]
                              [--set NAME=VALUE ...]

The shapes: K16 at bench_paged_decode's pools (16 rows, 8 KV heads, D 128,
block size 128, 32 table entries) with rows of 257 and 4,033 positions in
turn ("mixed") and all at 4,033 ("long"), over bf16 pools (bf16 q) and
int8 pools with their scales (bf16 q); at serving's mix (16 slots of
33..640 positions, bf16, phase 3's pools); and at the quantized model's
f32 shape (8 rows, G 4 on 4 KV heads, 9..208 positions, f32 q over int8
pools).  K12 and K13 at decode's M 8 on the quantized model's
projections (dim 2,048: N = K = 2,048; N 512; N 8,192; K 8,192), scale
and zero point as [N] vectors and a bias, and at N = K = 2,048 with a
per-tensor scale and zero point (0-d tensors, as PTQ stores them: "pt").
Then phase 17's decode step ("step int8", "step int4": chip_smoke's
quantized model, 4 steps at 8 rows profiled by its ``qserve_profile``):
device busy ms a step, device ops a step, the glue's ms and K12/K13's.
It calls only ``paged_decode_attention``, ``linear_q8`` and
``linear_q4``, which every version of the port with the int8 KV cache
has.  ``--only`` keeps the
shapes whose label starts with one of the given words (``--only paged``
times K16 alone).  ``--set`` overrides a constant of the split plans
before the first call (a sweep needs no rebuild): ``SPLIT_WAVES`` and
``MIN_SPLIT_BYTES`` of ``ops.paged_attention.plan``, ``DECODE_MIN_BYTES``
and ``DECODE_MAX_RANKS`` of ``ops.quant.decode_splits``.

CHECKOUT (default: this one) is the root of a checkout of the repository
(for example a parent commit unpacked with ``git archive`` into a
directory that .gitignore lists); its kernels are built there on first
use.  Each shape is timed three times with chip_smoke.cuda_ms over
operand copies past the L2.  The last line of the output is one JSON
object: ``{"root", "device", "set", "plan", "ms": {shape: [three
times]}}``, ``plan`` each shape's (splits, chunk) or cluster size.  To compare
two commits, run both in one machine in turns: parent, change, change,
parent.
"""

import argparse
import json
import sys
from pathlib import Path

ARGS = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ARGS.add_argument("checkout", nargs="?",
                  default=str(Path(__file__).resolve().parents[1]))
ARGS.add_argument("--only", nargs="+", default=None)
ARGS.add_argument("--set", nargs="+", default=[], metavar="NAME=VALUE")
OPTS = ARGS.parse_args()
ROOT = Path(OPTS.checkout).resolve()
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
from taper_tpu_torch.ops import _build  # noqa: E402
from taper_tpu_torch.ops import paged_attention as PA  # noqa: E402
from taper_tpu_torch.ops import quant as Q  # noqa: E402
from taper_tpu_torch.ops.paged_attention import (  # noqa: E402
    paged_decode_attention)
from taper_tpu_torch.ops.quant import linear_q4, linear_q8  # noqa: E402

BF, F32 = torch.bfloat16, torch.float32
B, KVH, D, BS, MB = 16, 8, 128, 128, 32
SHORT, LONG = 257, 4033
# (label, q dtype, pools int8, lengths)
PAGED = [(f"paged {kind} {'int8' if quant else 'bf16'}", BF, quant, lens)
         for kind, lens in (("mixed", [SHORT, LONG] * (B // 2)),
                            ("long", [LONG] * B))
         for quant in (False, True)]
# (label, N, K, bits, per-tensor scale and zero point)
QDECODE = ([(f"q{bits} M=8 (N,K)=({n},{k})", n, k, bits, False)
            for bits in (8, 4)
            for n, k in ((2048, 2048), (512, 2048), (8192, 2048),
                         (2048, 8192))]
           + [(f"q{bits} M=8 (N,K)=(2048,2048) pt", 2048, 2048, bits, True)
              for bits in (8, 4)])


# the constants --set may override, by the module that reads them
KNOBS = {"SPLIT_WAVES": PA, "MIN_SPLIT_BYTES": PA, "DECODE_MIN_BYTES": Q,
         "DECODE_MAX_RANKS": Q}
SET = {}
for item in OPTS.set:
    knob, _, value = item.partition("=")
    if knob not in KNOBS:
        ARGS.error(f"--set {item}: not one of {sorted(KNOBS)}")
    SET[knob] = int(value)
    setattr(KNOBS[knob], knob, SET[knob])


def keep(label):
    return not OPTS.only or any(label.startswith(w) for w in OPTS.only)


def tables_for(lens, mb, gen):
    """Each row's ceil(length / BS) blocks, distinct and shuffled, and
    the pool's block count (block 0 unused)."""
    need = [-(-n // BS) for n in lens]
    perm = torch.randperm(sum(need), generator=gen) + 1
    tables = torch.zeros(len(lens), mb, dtype=torch.int32)
    at = 0
    for i, nb in enumerate(need):
        tables[i, :nb] = perm[at:at + nb]
        at += nb
    return tables.cuda(), at + 1


def pools_for(n_blocks, kvh, d, quant, gen):
    """(k pool, v pool, scales) on the card: bf16 rows, or int8 codes with
    their per-position scales as kv_quantize stores rows of std ~1."""
    if not quant:
        return [torch.randn(n_blocks, kvh, BS, d, generator=gen).to(BF)
                .cuda() for _ in range(2)] + [{}]
    out = []
    for _ in range(2):
        x = torch.randn(n_blocks, kvh, BS, d, generator=gen)
        sc = x.abs().amax(-1).clamp_min(1e-8) / 127.0
        out += [torch.round(x / sc[..., None]).to(torch.int8).cuda(),
                sc.cuda()]
    return [out[0], out[2], dict(k_scales=out[1], v_scales=out[3])]


PLAN = {}


def paged_ms(label, q, kp, vp, tables, lengths, sc):
    scale = q.shape[-1] ** -0.5
    PLAN[label] = PA.plan(*q.shape, kp.shape[2], tables.shape[1], kp.dtype)

    def call(q, kp, vp, tables, lengths, *scales):
        kw = dict(zip(("k_scales", "v_scales"), scales))
        return paged_decode_attention(q, kp, vp, tables, lengths,
                                      scale=scale, **kw)
    sets = C.cold_sets(q, kp, vp, tables, lengths,
                       *[sc[k] for k in ("k_scales", "v_scales") if k in sc])
    with torch.no_grad():
        return [round(C.cuda_ms(call, sets), 4) for _ in range(3)]


def step_profile(bits, ms):
    """Phase 17's decode step of the int8 or int4 model, profiled by the
    checkout's own ``qserve_profile`` (4 steps at 8 rows)."""
    name = f"int{bits}"
    model = C.TinyGPT(**C.QSERVE)
    model.reset_parameters(torch.Generator().manual_seed(C.SEED))
    model.eval()
    cfg = (C.QuantizationConfig.int8() if bits == 8
           else C.QuantizationConfig.int4())
    card = C.restore_f32(C.quantize_params(model, cfg), model,
                         ("tok.w", "pos.w")).cuda()
    del model
    prof = C.qserve_profile(card, "cuda", name, [None] * C.QSERVE_REQUESTS)
    ms[f"step {name} busy"] = [round(prof["busy_ms"], 4)]
    ms[f"step {name} device ops"] = [prof["device_ops"]]
    ms[f"step {name} glue"] = [round(prof["ms"].get("glue", 0.0), 4)]
    ms[f"step {name} K12/K13"] = [round(sum(
        v for f, v in prof["ms"].items() if "K12" in f or "K13" in f), 4)]
    del card
    torch.cuda.empty_cache()


def main():
    _build.library()
    gen = torch.Generator().manual_seed(C.SEED)
    ms = {}
    for label, dtype, quant, lens in PAGED:
        if not keep(label):
            continue
        tables, n_blocks = tables_for(lens, MB, gen)
        kp, vp, sc = pools_for(n_blocks, KVH, D, quant, gen)
        q = torch.randn(B, KVH, 1, D, generator=gen).to(dtype).cuda()
        lengths = torch.tensor(lens, dtype=torch.int32).cuda()
        ms[label] = paged_ms(label, q, kp, vp, tables, lengths, sc)
        del kp, vp, sc
        torch.cuda.empty_cache()
    if keep("paged serve bf16"):
        # phase 3's serving mix: 16 slots of 33..640 positions, 5 blocks
        # each from the engine's pool
        lens = np.random.default_rng(C.SEED).integers(33, 641, B)
        tables, _ = tables_for([5 * BS] * B, MB, gen)
        kp, vp, sc = pools_for(B * 5 + 1, KVH, D, False, gen)
        q = torch.randn(B, KVH, 1, D, generator=gen).to(BF).cuda()
        ms["paged serve bf16"] = paged_ms(
            "paged serve bf16", q, kp, vp, tables,
            torch.tensor(lens, dtype=torch.int32).cuda(), sc)
        del kp, vp
        torch.cuda.empty_cache()
    if keep("paged f32 G4 int8"):
        # the quantized model: 8 slots, 16 query heads on 4 KV heads, f32
        # q, 256 positions in two blocks, 9..208 of them live
        lens = torch.linspace(9, 208, 8).round().int().tolist()
        tables, n_blocks = tables_for([2 * BS] * 8, 2, gen)
        kp, vp, sc = pools_for(n_blocks, 4, D, True, gen)
        q = torch.randn(8, 4, 4, D, generator=gen).cuda()
        ms["paged f32 G4 int8"] = paged_ms(
            "paged f32 G4 int8", q, kp, vp, tables,
            torch.tensor(lens, dtype=torch.int32).cuda(), sc)
        del kp, vp, sc
        torch.cuda.empty_cache()
    for label, n, k, bits, pt in QDECODE:
        if not keep(label):
            continue

        def make():
            x = torch.randn(8, k, generator=gen).cuda()
            if bits == 8:
                q = torch.randint(-128, 128, (n, k), generator=gen,
                                  dtype=torch.int8).cuda()
            else:
                q = torch.randint(0, 256, (n, k // 2), generator=gen,
                                  dtype=torch.uint8).cuda()
            shape = () if pt else (n,)
            return (x, q, torch.full(shape, 2e-4).cuda(),
                    torch.full(shape, -3.0).cuda(),
                    (torch.randn(n, generator=gen) * 0.1).cuda())
        first = make()
        sets = [first] + [make() for _ in range(C.copies_for(*first) - 1)]
        fn = (linear_q8 if bits == 8 else
              lambda x, q, s, z, b, k=k: linear_q4(x, q, s, z, b,
                                                   n_features=k))
        PLAN[label] = Q.decode_splits(n, k, bits)
        ms[label] = [round(C.cuda_ms(fn, sets), 4) for _ in range(3)]
        del sets, first
        torch.cuda.empty_cache()
    for bits in (8, 4):
        if keep(f"step int{bits}"):
            step_profile(bits, ms)
    print(json.dumps({"root": str(ROOT),
                      "device": torch.cuda.get_device_name(0),
                      "set": SET, "plan": PLAN, "ms": ms}), flush=True)


if __name__ == "__main__":
    main()
