"""MNIST MLP training: port of ``examples/train_mnist.py`` (the
reference's ``examples/train_mnist.rs``): the 784-128-64-10 ReLU MLP,
batch 256, Adam lr 1e-3 wd 1e-4, 10 epochs, early stop above 98% val
accuracy.

    python -m taper_tpu_torch.examples.train_mnist [--device cuda] [--loader]

The flags are the JAX example's, with these differences:

* ``--device`` (default ``cuda``) chooses where the model runs; there is
  no ``--backend`` (the port has no backend switch);
* ``--loader`` trains through ``Trainer.fit`` over
  ``PrefetchLoader(DataLoader(...))`` (batches staged from the host each
  step) instead of ``fit_device`` (the dataset resident on the device);
* ``--fused`` (``fit_device_fused``) is not ported and exits with an
  error; ``--profile`` writes a torch.profiler chrome trace of one epoch;
* the trained state is saved where the JAX example saves it,
  ``checkpoints/mnist_mlp.npz`` (``--checkpoint`` moves it).
"""

from __future__ import annotations

import argparse
import os
import time

from taper_tpu_torch import data, models, optim
from taper_tpu_torch.train import Trainer


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--data-dir", default="data/mnist")
    ap.add_argument("--checkpoint", default="checkpoints/mnist_mlp.npz",
                    help="where the trained state is saved (the JAX "
                         "example's path)")
    ap.add_argument("--loader", action="store_true",
                    help="Trainer.fit over PrefetchLoader(DataLoader)")
    ap.add_argument("--fused", action="store_true",
                    help="Trainer.fit_device_fused (not ported: exits)")
    ap.add_argument("--profile", default="",
                    help="write a torch.profiler chrome trace of one more "
                         "epoch into this directory")
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

    model = models.mnist_mlp()
    trainer = Trainer(model, optim.Adam(args.lr, weight_decay=1e-4),
                      device=args.device)
    print(f"params: {sum(p.numel() for p in model.parameters()):,}")

    t0 = time.perf_counter()
    if args.loader:
        loader = data.PrefetchLoader(
            data.DataLoader(train_ds, args.batch_size, seed=0),
            device=args.device)
        trainer.fit(loader, test_ds.images, test_ds.labels, args.epochs,
                    early_stop_acc=0.98)
    else:
        trainer.fit_device(train_ds.images, train_ds.labels,
                           test_ds.images, test_ds.labels, args.epochs,
                           batch_size=args.batch_size, early_stop_acc=0.98)
    total = time.perf_counter() - t0

    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        os.makedirs(args.profile, exist_ok=True)
        acts = [ProfilerActivity.CPU]
        if trainer.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            trainer.fit_device(train_ds.images, train_ds.labels,
                               test_ds.images, test_ds.labels, 1,
                               batch_size=args.batch_size,
                               early_stop_acc=2.0, verbose=False)
        path = os.path.join(args.profile, "trace.json")
        prof.export_chrome_trace(path)
        print(f"trace written to {path}")
    trainer.metrics.plot_summary()
    n_seen = (len(trainer.metrics.epoch_times)
              * (len(train_ds) // args.batch_size) * args.batch_size)
    print(f"throughput: {n_seen / total:,.0f} samples/s "
          f"(device={args.device}, {'fit' if args.loader else 'fit_device'})")
    trainer.save_checkpoint(args.checkpoint)
    print(f"checkpoint saved to {args.checkpoint}")
    return trainer


if __name__ == "__main__":
    main()
