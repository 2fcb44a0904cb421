"""XOR training: port of ``examples/train_xor.py`` (the reference's
``src/main.rs``): a 2-4-1 sigmoid MLP, BCE loss, SGD lr 0.1, 50,000
steps on the four points, weights from seed 42.

    python -m taper_tpu_torch.examples.train_xor [--device cuda] [--steps N]

The JAX example runs its steps as one ``lax.scan`` program; here they are
a Python loop of eager steps (forward and backward through K1, the SGD
update through K17b on the card).  ``--device`` (default ``cuda``) and
``--steps`` are the port's additions.  The host reads the loss twice,
at the first and the last step.
"""

from __future__ import annotations

import argparse
import time

import torch

from taper_tpu_torch import losses, models, optim

SEED, LR = 42, 0.1       # main.rs:33, the JAX example's PRNGKey(42)
POINTS = [[0.0, 0.0], [0.0, 1.0], [1.0, 0.0], [1.0, 1.0]]
TARGETS = [[0.0], [1.0], [1.0], [0.0]]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    ap.add_argument("--steps", type=int, default=50_000)
    return ap.parse_args(argv)


def train(args):
    """Train from ``args``; returns the model, the first and last loss
    (floats) and the predictions on the four points."""
    dev = torch.device(args.device)
    model = models.xor_mlp()
    model.reset_parameters(torch.Generator().manual_seed(SEED))
    model.to(dev)
    x = torch.tensor(POINTS, device=dev)
    y = torch.tensor(TARGETS, device=dev)
    opt = optim.SGD(LR).init(model.parameters())
    first = last = None
    for i in range(args.steps):
        loss = losses.bce_loss(model(x), y)
        opt.zero_grad()
        loss.backward()
        opt.step()
        if i == 0:
            first = loss.detach()
        last = loss.detach()
    with torch.no_grad():
        preds = model(x)
    return model, float(first), float(last), preds.cpu()


def main(argv=None) -> bool:
    args = parse_args(argv)
    t0 = time.perf_counter()
    _, first, last, preds = train(args)
    dt = time.perf_counter() - t0
    print(f"loss: {first:.4f} → {last:.4f} ({args.steps} steps in "
          f"{dt:.2f} s, device={args.device})")
    for (a, b), (t,), (p,) in zip(POINTS, TARGETS, preds.tolist()):
        print(f"  {int(a)} XOR {int(b)} = {p:.3f} (target {int(t)})")
    solved = bool(((preds > 0.5) == (torch.tensor(TARGETS) > 0.5)).all())
    print("XOR solved!" if solved else "XOR NOT solved")
    return solved


if __name__ == "__main__":
    main()
