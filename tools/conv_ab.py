"""Times K3a and K3b (the direct convolution of
``taper_tpu_torch/ops/conv_direct.py``) at the shapes of the port's
paths, in one checkout, on an NVIDIA GPU:

    python tools/conv_ab.py [CHECKOUT]

The shapes: the stride-1 3x3 convolutions (pad 1, f32, batch 256) of the
reference CNN (1->32 and 32->32 at 28x28, 32->64 and 64->64 at 14x14,
64->128 at 7x7) and of ResNet-8 (3->16 and 16->16 at 32x32, 32->32 at
16x16, 64->64 at 8x8): each one's forward with bias and ReLU (K3a), its
weight gradient (K3b), and its input gradient (K3a on the output
gradient) where the path takes one, as the backward of that version runs
it: ``conv_fwd(g, w, flipped=True)`` where ``conv_fwd`` has the flag,
else ``conv_fwd(g, flip_weights(w))``, the flipped copy included.  It
calls only ``conv_fwd``, ``flip_weights`` and ``conv_dw``, which every
version of the port has.

CHECKOUT (default: this one) is the root of a checkout of the repository
(for example a parent commit unpacked with ``git archive`` into a
directory that .gitignore lists); its kernels are built there on first
use.  Each call is timed three times with that checkout's
chip_smoke.cuda_ms over operand copies past the L2.  The last line of the
output is one JSON object: ``{"root", "device", "ms": {shape: [three
times]}}``.  To compare two commits, run both in one machine in turns:
parent, change, change, parent.
"""

import inspect
import json
import sys
from pathlib import Path

ROOT = Path(sys.argv[1] if len(sys.argv) > 1 else
            Path(__file__).resolve().parents[1]).resolve()
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
from taper_tpu_torch.ops import _build  # noqa: E402
from taper_tpu_torch.ops import conv_direct as CD  # noqa: E402

N = 256
# (label, C, O, H, input gradient taken)
SHAPES = ([("cnn", 1, 32, 28, False), ("cnn", 32, 32, 28, True),
           ("cnn", 32, 64, 14, True), ("cnn", 64, 64, 14, True),
           ("cnn", 64, 128, 7, True)]
          + [("resnet", 3, 16, 32, False), ("resnet", 16, 16, 32, True),
             ("resnet", 32, 32, 16, True), ("resnet", 64, 64, 8, True)])


def main():
    _build.library()
    has_flag = "flipped" in inspect.signature(CD.conv_fwd).parameters
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    if has_flag:
        def dx(g, w):
            return CD.conv_fwd(g, w, None, (1, 1), flipped=True)
    else:
        def dx(g, w):
            return CD.conv_fwd(g, CD.flip_weights(w), None, (1, 1))

    ms = {}

    def time(key, fn, *tensors):
        sets = C.cold_sets(*tensors)
        ms[key] = [round(C.cuda_ms(fn, sets), 4) for _ in range(3)]
        del sets

    for label, c, o, hw, takes_dx in SHAPES:
        at = f"{label} {c}->{o} {hw}x{hw}"
        x, g = randn(N, c, hw, hw), randn(N, o, hw, hw)
        w = randn(o, c, 3, 3, scale=(9 * c) ** -0.5)
        time(f"{at} fwd", lambda x, w, b: CD.conv_fwd(x, w, b, (1, 1),
                                                      "relu"),
             x, w, randn(o, scale=0.1))
        if takes_dx:
            time(f"{at} dX", dx, g, w)
        time(f"{at} dW", lambda x, g: CD.conv_dw(x, g, (3, 3), (1, 1)),
             x, g)
        del x, g, w
        torch.cuda.empty_cache()
    print(json.dumps({"root": str(ROOT),
                      "device": torch.cuda.get_device_name(0),
                      "ms": ms}), flush=True)


if __name__ == "__main__":
    main()
