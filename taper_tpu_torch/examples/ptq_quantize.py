"""Post-training quantization walkthrough: port of
``examples/ptq_quantize.py`` (the reference's ``examples/ptq_quantize.rs``):
train the CNN briefly, quantize it to int8, float16 and fp8_e4m3, then
compare the logits, the full-test-set accuracy, the evaluation time and
the model size.

    python -m taper_tpu_torch.examples.ptq_quantize [--device cuda]
        [--epochs N]

The flags are the JAX example's, with ``--device`` (default ``cuda``) in
place of ``--backend``.  On the card the int8 model's FC layers run the
dequant-on-load kernel K12; its convolutions, and every layer of the
other formats, dequantize their weights and run the f32 kernels.
"""

from __future__ import annotations

import argparse
import time

import torch

from taper_tpu_torch import data, models, optim
from taper_tpu_torch.quantization import (
    QuantizationConfig, QuantizedModel, quantize_model, quantized_bytes)
from taper_tpu_torch.train import Trainer

FORMATS = (("int8", QuantizationConfig.int8()),
           ("float16", QuantizationConfig.float16()),
           ("fp8_e4m3", QuantizationConfig.fp8_e4m3()))


def evaluate_quantized(model, images, labels, device, batch=2000):
    """Accuracy over the whole batches of a split, and the seconds the
    forward passes took (the split is on the device first; one host sync
    at the end)."""
    n = len(labels) - len(labels) % batch
    x = torch.from_numpy(images[:n]).to(device)
    y = torch.from_numpy(labels[:n]).to(device).long()
    correct = torch.zeros((), dtype=torch.int64, device=device)
    if x.is_cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(0, n, batch):
        logits = model(x[s:s + batch])
        correct += (logits.argmax(-1) == y[s:s + batch]).sum()
    acc = correct.item() / n
    return acc, time.perf_counter() - t0


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--data-dir", default="data/mnist")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Runs the walkthrough; returns ``{format: {"acc", "eval_s",
    "bytes", "max_logit_diff"}}`` with ``"f32"`` for the trained model."""
    args = parse_args(argv)
    print("=== PTQ: train -> quantize -> compare (reference "
          "ptq_quantize.rs)")
    train_ds = data.MNISTDataset(train=True, data_dir=args.data_dir)
    test_ds = data.MNISTDataset(train=False, data_dir=args.data_dir)

    model = models.mnist_cnn()
    # 3e-3, not the reference's 0.01: the JAX example's deviation
    trainer = Trainer(model, optim.Adam(3e-3, weight_decay=1e-4),
                      device=args.device)
    trainer.fit_device(train_ds.images, train_ds.labels, test_ds.images,
                       test_ds.labels, args.epochs, early_stop_acc=2.0)
    dev = trainer.device
    f32_bytes = quantized_bytes(model)
    qmodels = {name: quantize_model(model, cfg) for name, cfg in FORMATS}

    # output-difference diagnostic (ptq_quantize.rs:249-278)
    base = QuantizedModel(model)
    x = torch.from_numpy(test_ds.images[:256]).to(dev)
    ref = base(x)
    results = {"f32": {"max_logit_diff": 0.0}}
    for name, qm in qmodels.items():
        diff = float((qm(x) - ref).abs().max())
        results[name] = {"max_logit_diff": diff}
        print(f"max |{name} - f32| logit diff over 256 samples: "
              f"{diff:.5f}")

    # full-test-set accuracy, timing and size (:281-411)
    base_acc, base_dt = evaluate_quantized(base, test_ds.images,
                                           test_ds.labels, dev)
    results["f32"].update(acc=base_acc, eval_s=base_dt, bytes=f32_bytes)
    print(f"\n{'model':10s} {'accuracy':>9s} {'drop':>7s} "
          f"{'size':>10s} {'ratio':>6s} {'eval_s':>7s}")
    print(f"{'f32':10s} {base_acc * 100:8.2f}% {0.0:6.2f}% "
          f"{f32_bytes / 1e6:8.2f}MB {1.0:5.1f}x {base_dt:7.2f}")
    for name, qm in qmodels.items():
        acc, dt = evaluate_quantized(qm, test_ds.images, test_ds.labels,
                                     dev)
        nbytes = quantized_bytes(qm.module)
        results[name].update(acc=acc, eval_s=dt, bytes=nbytes)
        print(f"{name:10s} {acc * 100:8.2f}% {(base_acc - acc) * 100:6.2f}% "
              f"{nbytes / 1e6:8.2f}MB {f32_bytes / nbytes:5.1f}x {dt:7.2f}")
    return results


if __name__ == "__main__":
    main()
