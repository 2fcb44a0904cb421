"""CIFAR-10 ResNet-8 with AdamW and a cosine schedule: port of
``examples/train_cifar10_resnet.py`` (the BASELINE.json stretch
workload): batch 256, AdamW lr 3e-3 wd 5e-4, ``CosineAnnealingLR`` down
to lr/100 over the epochs, 20 epochs, early stop above 93% val accuracy.

    python -m taper_tpu_torch.examples.train_cifar10_resnet [--device cuda]

The flags are the JAX example's, with ``--device`` (default ``cuda``) in
place of ``--backend``.  The dataset reads local binary batches under
``data/cifar10`` or renders the synthetic v2 set (no download).  The
trained state is saved where the JAX example saves it,
``checkpoints/cifar10_resnet8.npz`` (``--checkpoint`` moves it).
"""

from __future__ import annotations

import argparse
import time

from taper_tpu_torch import models, optim
from taper_tpu_torch.data import CIFAR10Dataset
from taper_tpu_torch.train import Trainer


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--checkpoint",
                    default="checkpoints/cifar10_resnet8.npz",
                    help="where the trained state is saved (the JAX "
                         "example's path)")
    return ap.parse_args(argv)


def build(args, seed: int = 0) -> Trainer:
    """ResNet-8 in a Trainer with the example's optimizer and schedule."""
    sched = optim.CosineAnnealingLR(args.lr, t_max=args.epochs,
                                    min_lr=args.lr * 0.01)
    return Trainer(models.resnet8(), optim.AdamW(args.lr, weight_decay=5e-4),
                   scheduler=sched, seed=seed, device=args.device)


def main(argv=None) -> Trainer:
    args = parse_args(argv)
    print("loading CIFAR-10…")
    train_ds = CIFAR10Dataset(train=True)
    test_ds = CIFAR10Dataset(train=False)
    print(f"  train={len(train_ds)} test={len(test_ds)} "
          f"source={train_ds.source}")
    trainer = build(args)
    print(f"params: {sum(p.numel() for p in trainer.model.parameters()):,}")

    t0 = time.perf_counter()
    trainer.fit_device(train_ds.images, train_ds.labels,
                       test_ds.images, test_ds.labels, args.epochs,
                       batch_size=args.batch_size, early_stop_acc=0.93)
    total = time.perf_counter() - t0
    trainer.metrics.plot_summary()
    n_epochs = len(trainer.metrics.epoch_times)
    print(f"{total / n_epochs:.2f}s/epoch avg (device={args.device})")
    trainer.save_checkpoint(args.checkpoint)
    print(f"checkpoint saved to {args.checkpoint}")
    return trainer


if __name__ == "__main__":
    main()
