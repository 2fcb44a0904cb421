"""The spread over seeds of the MNIST MLP's final validation accuracy at
bench.py:48-80's settings (10 epochs, Adam 1e-3 with weight decay 1e-4,
batch 256, early_stop_acc=2.0, the synthetic 60k/10k set), through the
JAX package's ``Trainer.fit_device`` on the CPU (XLA backend).

    python tools/jax_mlp_seed_spread.py [--seeds 0 1 2 3] [--epochs 10]

The seed sets the initial weights and the batch order.  Prints each
seed's per-epoch accuracies, then the final accuracies' mean, min, max
and the largest distance of any of them below BENCH_r05's 0.993: the
batch-order allowance that chip_smoke.py's phase 15 grants the port's
run at these settings.  No download is tried (``allow_download=False``).
"""

import argparse
import json
import sys
import time
from pathlib import Path

import jax

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))   # the repo

jax.config.update("jax_platforms", "cpu")

from taper_tpu import models, ops, optim  # noqa: E402
from taper_tpu.data import MNISTDataset  # noqa: E402
from taper_tpu.train import Trainer  # noqa: E402

BENCH_ACC = 0.993          # BENCH_r05.json mlp_test_acc_final


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--epochs", type=int, default=10)
    args = ap.parse_args(argv)
    ops.set_backend("xla")
    train = MNISTDataset(train=True, allow_download=False)
    test = MNISTDataset(train=False, allow_download=False)
    finals = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        trainer = Trainer(models.mnist_mlp(),
                          optim.Adam(1e-3, weight_decay=1e-4), seed=seed)
        m = trainer.fit_device(train.images, train.labels, test.images,
                               test.labels, args.epochs, batch_size=256,
                               early_stop_acc=2.0, verbose=False)
        finals.append(float(m.val_acc[-1]))
        print(json.dumps({"seed": seed, "source": train.source,
                          "val_acc": [round(float(a), 4)
                                      for a in m.val_acc],
                          "seconds": round(time.perf_counter() - t0, 1)}),
              flush=True)
    print(json.dumps({
        "final_mean": sum(finals) / len(finals), "final_min": min(finals),
        "final_max": max(finals),
        "largest_shortfall_from_0.993": max(BENCH_ACC - a for a in finals)}))


if __name__ == "__main__":
    main()
