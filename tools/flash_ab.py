"""Times the flash kernels at the shapes of the port's paths, in one
checkout, on an NVIDIA GPU:

    python tools/flash_ab.py [CHECKOUT]

The shapes (bf16): the 170M model's attention (B 8, H 8, S 2048, D 128,
[B, S, H*D]: K8 on both arms, K5, K6, K7), bench_packing's padded batch
(B 64, H 8, S 1024, D 64, [B, H, S, D]: K8, K6, K7), serving prefill (B 1,
H 8, S 512, D 128, [B, H, S, D]: K8), the windowed model's training step
(B 2, H 8, S 4096, D 128, window 512, [B, S, H*D]: K5, K6, K7) and
bench_packing's packed batch (13 rows, H 8, S 1024, D 64, its segment ids:
K5, K6, K7).  K8's times include its bound pre-pass (``bound_predicate``),
as a caller sees them.  It calls only ``flash_fwd_bound``,
``flash_fwd_exact``, ``flash_dq`` and ``flash_dkv`` (with their window and
segment-id arguments), which every version of the port with packed and
windowed training has.

CHECKOUT (default: this one) is the root of a checkout of the repository
(for example a parent commit unpacked with ``git archive`` into a
directory that .gitignore lists); its kernels are built there on first
use.  Each kernel is timed three times with chip_smoke.cuda_ms over
operand copies past the L2.  The last line of the output is one JSON
object: ``{"root", "device", "ms": {"shape kernel": [three times]}}``.
To compare two commits, run both in one machine in turns: parent,
change, change, parent.
"""

import importlib
import json
import sys
from pathlib import Path

ROOT = Path(sys.argv[1] if len(sys.argv) > 1 else
            Path(__file__).resolve().parents[1]).resolve()
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
from taper_tpu_torch.data import pack_documents  # noqa: E402
from taper_tpu_torch.ops import _build  # noqa: E402

A = importlib.import_module("taper_tpu_torch.ops.attention")

# (label, B, H, S, D, layout, window, segment ids, kernels)
SHAPES = (
    ("170M", 8, 8, 2048, 128, "bshd", None, False,
     ("K8", "K8 exact arm", "K5", "K6", "K7")),
    ("padded", 64, 8, 1024, 64, "bhsd", None, False, ("K8", "K6", "K7")),
    ("prefill", 1, 8, 512, 128, "bhsd", None, False, ("K8",)),
    ("window", 2, 8, 4096, 128, "bshd", 512, False, ("K5", "K6", "K7")),
    ("packed", None, 8, 1024, 64, "bhsd", None, True, ("K5", "K6", "K7")),
)


def shape_times(label, b, h, s, d, layout, window, segments, names):
    gen = torch.Generator().manual_seed(0)
    seg = None
    if segments:
        packed = pack_documents(C.packing_docs()[0], s)
        seg = torch.from_numpy(packed["segment_ids"]).cuda()
        b = seg.shape[0]
    heads = h if layout == "bshd" else None
    shape = (b, s, h * d) if layout == "bshd" else (b, h, s, d)
    q, k, v, do = (torch.randn(*shape, generator=gen).to(torch.bfloat16)
                   .cuda() for _ in range(4))
    kw = dict(causal=True, scale=d ** -0.5, heads=heads, window=window,
              segment_ids=seg)
    o, lse = A.flash_fwd_exact(q, k, v, **kw)
    sets = C.cold_sets(q, k, v, o, lse, do)
    _, delta = A.flash_dq(*sets[0], **kw)
    dsets = C.cold_sets(q, k, v, lse, delta, do)
    kernels = {
        "K8": (lambda *a: A.flash_fwd_bound(
            *a[:3], scale=kw["scale"], heads=heads, force_bound=True), sets),
        "K8 exact arm": (lambda *a: A.flash_fwd_bound(
            *a[:3], scale=kw["scale"], heads=heads, force_bound=False),
            sets),
        "K5": (lambda *a: A.flash_fwd_exact(*a[:3], **kw), sets),
        "K6": (lambda *a: A.flash_dq(*a, **kw), sets),
        "K7": (lambda *a: A.flash_dkv(*a, **kw), dsets)}
    return {f"{label} {name}": [round(C.cuda_ms(*kernels[name]), 4)
                                for _ in range(3)] for name in names}


def main():
    _build.library()
    ms = {}
    for shape in SHAPES:
        ms.update(shape_times(*shape))
        torch.cuda.empty_cache()
    print(json.dumps({"root": str(ROOT),
                      "device": torch.cuda.get_device_name(0), "ms": ms}),
          flush=True)


if __name__ == "__main__":
    main()
