"""Times the LM training steps of chip_smoke.py in one checkout, on an
NVIDIA GPU:

    python tools/steps_ab.py [CHECKOUT]

It runs that checkout's chip_smoke.py phases 11 (the 170M model, batch 8
x 2048), 25 (bench_packing's padded and packed batches) and 26 (the
windowed model at 2 x 4096, dK/dV by K7 and by K11) through their own
functions, with every check they hold, and prints their ms per step.
CHECKOUT (default: this one) is the root of a checkout of the repository
(for example a parent commit unpacked with ``git archive`` into a
directory that .gitignore lists); its kernels are built there on first
use.  The last line of the output is one JSON object: ``{"root",
"device", "ms": {"step": ms per step}}``.  To compare two commits, run
both in one machine in turns: parent, change, change, parent.
"""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(sys.argv[1] if len(sys.argv) > 1 else
            Path(__file__).resolve().parents[1]).resolve()
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
from taper_tpu_torch.ops import _build  # noqa: E402


def main():
    _build.library()
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    _, lm = C.phase11_lm_train(dev, smi)
    ms = {"170M": lm["step_ms"]}
    del lm
    torch.cuda.empty_cache()
    _, packed = C.phase25_packed_training(dev, smi)
    ms.update({"padded": packed["padded"]["step_ms"],
               "packed": packed["packed"]["step_ms"]})
    _, window = C.phase26_window_training(dev, smi)
    ms.update({"windowed K7": window["K7"]["step_ms"],
               "windowed K11": window["K11"]["step_ms"]})
    print(json.dumps({"root": str(ROOT), "device": smi, "ms": ms}),
          flush=True)


if __name__ == "__main__":
    main()
