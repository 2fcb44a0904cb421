"""Times the flash kernels at the shapes of the port's paths, in one
checkout, on an NVIDIA GPU:

    python tools/flash_ab.py [CHECKOUT] [--only LABEL ...]

The shapes (bf16): the 170M model's attention (B 8, H 8, S 2048, D 128,
[B, S, H*D]: K8 on both arms, K5, K6, K7, K10), bench_packing's padded
batch (B 64, H 8, S 1024, D 64, [B, H, S, D]: K8, K6, K7), serving
prefill (B 1, H 8, S 512, D 128, [B, H, S, D]: K8), the windowed model's
training step (B 2, H 8, S 4096, D 128, window 512, [B, S, H*D]: K5, K6,
K7, K11) and bench_packing's packed batch (13 rows, H 8, S 1024, D 64, its
segment ids: K5, K6, K7); and K5, K6 and K7 in f32 at the f32 paths'
shapes: the sort task (B 64, H 2, S 128, D 64, causal, [B, H, S, D]), a
non-causal window of 256 (B 1, H 4, S 1024, D 64, [B, H, S, D]; K11 too)
and the f32 170M step (B 1, H 8, S 2048, D 128, causal, [B, S, H*D]).
K11 (the opt-in per-head dK/dV) is timed without its group sum.  K8's
times include its bound pre-pass (``bound_predicate``), as a caller sees
them, and K10's its delta pre-pass and dQ epilogue.  It calls only
``flash_fwd_bound``, ``flash_fwd_exact``, ``flash_dq``, ``flash_dkv``,
``flash_dkv_t`` and ``flash_bwd_fused`` (with their window and
segment-id arguments), which every version of the port with packed and
windowed training has.  ``--only`` keeps the shapes whose label starts
with one of the given words (``--only f32`` times the f32 kernels alone).

CHECKOUT (default: this one) is the root of a checkout of the repository
(for example a parent commit unpacked with ``git archive`` into a
directory that .gitignore lists); its kernels are built there on first
use.  Each kernel is timed three times with chip_smoke.cuda_ms over
operand copies past the L2.  The last line of the output is one JSON
object: ``{"root", "device", "ms": {"shape kernel": [three times]}}``.
To compare two commits, run both in one machine in turns: parent,
change, change, parent.
"""

import argparse
import importlib
import json
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
from taper_tpu_torch.data import pack_documents  # noqa: E402
from taper_tpu_torch.ops import _build  # noqa: E402

A = importlib.import_module("taper_tpu_torch.ops.attention")

BF, F32 = torch.bfloat16, torch.float32
# (label, B, H, S, D, layout, window, segment ids, kernels, dtype, causal)
SHAPES = (
    ("170M", 8, 8, 2048, 128, "bshd", None, False,
     ("K8", "K8 exact arm", "K5", "K6", "K7", "K10"), BF, True),
    ("padded", 64, 8, 1024, 64, "bhsd", None, False, ("K8", "K6", "K7"), BF,
     True),
    ("prefill", 1, 8, 512, 128, "bhsd", None, False, ("K8",), BF, True),
    ("window", 2, 8, 4096, 128, "bshd", 512, False,
     ("K5", "K6", "K7", "K11"), BF, True),
    ("packed", None, 8, 1024, 64, "bhsd", None, True, ("K5", "K6", "K7"), BF,
     True),
    ("f32 sort", 64, 2, 128, 64, "bhsd", None, False, ("K5", "K6", "K7"),
     F32, True),
    ("f32 window", 1, 4, 1024, 64, "bhsd", 256, False,
     ("K5", "K6", "K7", "K11"), F32, False),
    ("f32 170M", 1, 8, 2048, 128, "bshd", None, False, ("K5", "K6", "K7"),
     F32, True),
)


def shape_times(label, b, h, s, d, layout, window, segments, names, dtype,
                causal):
    gen = torch.Generator().manual_seed(0)
    seg = None
    if segments:
        packed = pack_documents(C.packing_docs()[0], s)
        seg = torch.from_numpy(packed["segment_ids"]).cuda()
        b = seg.shape[0]
    heads = h if layout == "bshd" else None
    shape = (b, s, h * d) if layout == "bshd" else (b, h, s, d)
    q, k, v, do = (torch.randn(*shape, generator=gen).to(dtype).cuda()
                   for _ in range(4))
    kw = dict(causal=causal, scale=d ** -0.5, heads=heads, window=window,
              segment_ids=seg)
    o, lse = A.flash_fwd_exact(q, k, v, **kw)
    sets = C.cold_sets(q, k, v, o, lse, do)
    kernels = {
        "K8": lambda *a: A.flash_fwd_bound(
            *a[:3], scale=kw["scale"], heads=heads, force_bound=True),
        "K8 exact arm": lambda *a: A.flash_fwd_bound(
            *a[:3], scale=kw["scale"], heads=heads, force_bound=False),
        "K5": lambda *a: A.flash_fwd_exact(*a[:3], **kw),
        "K6": lambda *a: A.flash_dq(*a, **kw),
        "K10": lambda *a: A.flash_bwd_fused(*a, **kw)}
    ms = {}
    for name in names:
        arg_sets = sets
        if name in ("K7", "K11"):
            _, delta = A.flash_dq(*sets[0], **kw)
            arg_sets = C.cold_sets(q, k, v, lse, delta, do)
            kernels["K7"] = lambda *a: A.flash_dkv(*a, **kw)
            kernels["K11"] = lambda *a: A.flash_dkv_t(
                *a, causal=causal, scale=kw["scale"], heads=heads,
                window=window)
        ms[f"{label} {name}"] = [round(C.cuda_ms(kernels[name], arg_sets), 4)
                                 for _ in range(3)]
    return ms


def main():
    _build.library()
    ms = {}
    for shape in SHAPES:
        if OPTS.only and not any(shape[0].startswith(w) for w in OPTS.only):
            continue
        ms.update(shape_times(*shape))
        torch.cuda.empty_cache()
    print(json.dumps({"root": str(ROOT),
                      "device": torch.cuda.get_device_name(0), "ms": ms}),
          flush=True)


if __name__ == "__main__":
    main()
