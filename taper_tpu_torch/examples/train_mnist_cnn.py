"""MNIST CNN training: port of ``examples/train_mnist_cnn.py`` (the
reference's ``examples/train_mnist_cnn.rs``): the reference CNN, batch
256, Adam lr 3e-3 wd 1e-4, lr x0.8 every 5 epochs, up to 50 epochs,
early stop above 99.5% val accuracy.

    python -m taper_tpu_torch.examples.train_mnist_cnn [--device cuda]

The flags are the JAX example's, with ``--device`` (default ``cuda``) in
place of ``--backend``; ``--fused`` (``fit_device_fused``) is not ported
and exits with an error.  The trained state is saved where the JAX
example saves it, ``checkpoints/mnist_cnn.npz`` (``--checkpoint`` moves
it).
"""

from __future__ import annotations

import argparse
import time

from taper_tpu_torch import data, models, optim
from taper_tpu_torch.train import Trainer


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--data-dir", default="data/mnist")
    ap.add_argument("--checkpoint", default="checkpoints/mnist_cnn.npz",
                    help="where the trained state is saved (the JAX "
                         "example's path)")
    ap.add_argument("--fused", action="store_true",
                    help="Trainer.fit_device_fused (not ported: exits)")
    args = ap.parse_args(argv)
    if args.fused:
        ap.error("--fused: Trainer.fit_device_fused is not ported to "
                 "taper_tpu_torch yet (ROADMAP.md, Queue 1)")
    return args


def main(argv=None) -> Trainer:
    args = parse_args(argv)
    print("loading MNIST…")
    train_ds = data.MNISTDataset(train=True, data_dir=args.data_dir)
    test_ds = data.MNISTDataset(train=False, data_dir=args.data_dir)
    print(f"  train={len(train_ds)} test={len(test_ds)} "
          f"source={train_ds.source}")

    model = models.mnist_cnn()
    sched = optim.StepLR(args.lr, step_size=5, gamma=0.8)
    trainer = Trainer(model, optim.Adam(args.lr, weight_decay=1e-4),
                      scheduler=sched, device=args.device)
    print(f"params: {sum(p.numel() for p in model.parameters()):,}")

    t0 = time.perf_counter()
    trainer.fit_device(train_ds.images, train_ds.labels,
                       test_ds.images, test_ds.labels, args.epochs,
                       batch_size=args.batch_size, early_stop_acc=0.995)
    total = time.perf_counter() - t0
    trainer.metrics.plot_summary()
    n_epochs = len(trainer.metrics.epoch_times)
    n_seen = n_epochs * (len(train_ds) // args.batch_size) * args.batch_size
    print(f"throughput: {n_seen / total:,.0f} samples/s "
          f"({total / n_epochs:.2f}s/epoch, device={args.device})")
    trainer.save_checkpoint(args.checkpoint)
    print(f"checkpoint saved to {args.checkpoint}")
    return trainer


if __name__ == "__main__":
    main()
