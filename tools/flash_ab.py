"""Times the unmasked flash kernels K8 (bound arm), K5, K6 and K7 at the
170M model's attention shape (bf16, B 8, H 8, S 2048, D 128, [B, S, H*D])
in one checkout, on an NVIDIA GPU:

    python tools/flash_ab.py [CHECKOUT]

CHECKOUT (default: this one) is the root of a checkout of the repository
(for example a parent commit unpacked with ``git archive`` into a
directory that .gitignore lists); its kernels are built there on first
use.  Each kernel is timed three times with chip_smoke.cuda_ms over
operand copies past the L2.  To compare two commits, run both in one
machine in turns: parent, change, change, parent.
"""

import importlib
import sys
from pathlib import Path

ROOT = Path(sys.argv[1] if len(sys.argv) > 1 else
            Path(__file__).resolve().parents[1]).resolve()
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
from taper_tpu_torch.ops import _build  # noqa: E402

A = importlib.import_module("taper_tpu_torch.ops.attention")


def main():
    _build.library()
    gen = torch.Generator().manual_seed(0)
    b, h, s, d = 8, 8, 2048, 128
    scale = d ** -0.5
    q, k, v, do = (torch.randn(b, s, h * d, generator=gen)
                   .to(torch.bfloat16).cuda() for _ in range(4))
    o, lse = A.flash_fwd_exact(q, k, v, causal=True, scale=scale, heads=h)
    sets = C.cold_sets(q, k, v, o, lse, do)
    _, delta = A.flash_dq(*sets[0], causal=True, scale=scale, heads=h)
    dsets = C.cold_sets(q, k, v, lse, delta, do)
    kernels = {
        "K8": (lambda *a: A.flash_fwd_bound(*a[:3], scale=scale, heads=h,
                                            force_bound=True), sets),
        "K5": (lambda *a: A.flash_fwd_exact(*a[:3], causal=True,
                                            scale=scale, heads=h), sets),
        "K6": (lambda *a: A.flash_dq(*a, causal=True, scale=scale,
                                     heads=h), sets),
        "K7": (lambda *a: A.flash_dkv(*a, causal=True, scale=scale,
                                      heads=h), dsets)}
    ms = {name: [round(C.cuda_ms(fn, args), 4) for _ in range(3)]
          for name, (fn, args) in kernels.items()}
    print(ROOT, torch.cuda.get_device_name(0), ms, flush=True)


if __name__ == "__main__":
    main()
