"""Trains the reference CNN in both packages on the CPU, in lock step, to
compare how often each spikes to chance at the example's lr 3e-3:

    python tools/cnn_spike_ab.py --seeds 0 1 2 --epochs 3 --out runs.jsonl

For each seed, the JAX package's Trainer (xla backend) draws the
parameters; the port's Trainer (``device="cpu"``) loads them by name
(``load_jax_params``).  Each epoch's batch order is one numpy permutation
from the seed, and both Trainers take the same batches, one step each in
turn: Adam(3e-3, wd 1e-4), batch 256 (``examples/train_mnist_cnn.py``;
its StepLR first lowers lr after epoch 5, so 3 epochs run at 3e-3).  The
data is the port's synthetic MNIST (``taper_tpu_torch.data.MNISTDataset``),
fed to both.

A third run is the witness that tells rounding from a formula
difference: JAX again, from the same parameters, on the same batches
with each batch's rows in another order (one numpy permutation a step,
from a generator of its own, so the batch order is the same with or
without the witness).  The CNN has no dropout and no batch statistics, so
that run computes the same function of the same data, and only the
order of the sums over the batch differs.  Where JAX and the port part
as early, and spike as differently, as JAX and its permuted self, the
port's formulas need not differ.

Each step's losses are kept.  The first step whose losses differ
by more than ``--part`` relative (f32 rounding of two summation orders
stays near 1e-7; the repo holds a step's loss to 1e-5) is where two
trajectories part; the first ``FIRST`` steps' relative gaps are kept.
At the first step each run's loss and gradients are also held against
a plain f64 evaluation of the same network from the same parameters
(``torch.nn.functional`` in float64, code of neither package), as is
``jax_where``: JAX's xla backend with the ReLU gradient of its pallas
backend.  The xla backend's ReLU is ``jnp.maximum(x, 0)``, whose
gradient at exactly 0 is 1/2; the pallas backend's ``conv2d_direct``
(``_conv_direct_bwd``), which the port follows, passes no gradient
there.  Exact zeros are common at the first step (zero biases over the
images' zero background).  With ``--where`` that variant also trains
beside the others, so the parting step of it and the port shows what
is left once the two take the same rule.  With ``--port-threads N``
the port trains a second time, ``port_threads``, its steps on N CPU
threads: the same code, with oneDNN's convolutions rounding in another
order than on one thread (the port's own witness, for the forward
pass's rounding).  After each epoch each run evaluates the 10k test
split.  A run spikes where a 20-step mean of its training loss climbs
back above 2.0 (chance is ln 10 = 2.30) after it has been below 1.0.

One JSON line per epoch and one summary line per seed are appended to
``--out`` as they finish, so a cut run keeps what it finished.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from taper_tpu import models as jmodels  # noqa: E402
from taper_tpu import ops as jops  # noqa: E402
from taper_tpu import optim as jopt  # noqa: E402
from taper_tpu.ops import xla as jxla  # noqa: E402
from taper_tpu import train as jtrain  # noqa: E402
from taper_tpu_torch import optim  # noqa: E402
from taper_tpu_torch.data import MNISTDataset  # noqa: E402
from taper_tpu_torch.models import mnist_cnn  # noqa: E402
from taper_tpu_torch.train import Trainer  # noqa: E402
from taper_tpu_torch.utils.convert import load_jax_params  # noqa: E402

LR, WD, BATCH = 3e-3, 1e-4, 256
WINDOW, LOW, HIGH = 20, 1.0, 2.0
FIRST = 10
PAIRS = (("jax", "port"), ("jax", "jax_perm"), ("jax_where", "port"),
         ("port", "port_threads"))


def spike_step(losses):
    """First step at which the WINDOW-step mean of ``losses`` is above
    HIGH after an earlier mean below LOW, else None."""
    means = np.convolve(losses, np.ones(WINDOW) / WINDOW, "valid")
    low = np.nonzero(means < LOW)[0]
    if not len(low):
        return None
    high = np.nonzero(means[low[0]:] > HIGH)[0]
    return None if not len(high) else int(low[0] + high[0] + WINDOW - 1)


def f64_loss(params, x, y):
    """The reference CNN (``models.mnist_cnn``) in plain float64, from
    the port's parameters by name."""
    h = x.reshape(-1, 1, 28, 28)
    for i in ("1", "2", "4", "5", "7"):
        h = F.relu(F.conv2d(h, params[f"{i}.w"], params[f"{i}.b"], padding=1))
        if i in ("2", "5"):
            h = F.max_pool2d(h, 2)
    h = h.mean((2, 3))
    for i in ("10", "11", "12"):
        h = F.linear(h, params[f"{i}.w"], params[f"{i}.b"])
        h = h if i == "12" else F.relu(h)
    return F.cross_entropy(h, y)


@contextlib.contextmanager
def pallas_relu_rule(on=True):
    """While on, the xla backend's ReLU is ``jax.nn.relu``: the same
    values, and no gradient at exactly 0 (``jnp.where(y > 0, g, 0)``, as
    the pallas backend's ``_conv_direct_bwd``).  A step traced inside
    keeps the rule."""
    old = jxla.relu
    if on:
        jxla.relu = jax.nn.relu
    try:
        yield
    finally:
        jxla.relu = old


def first_step_errors(jt, pt, x, y, perm):
    """Each run's first-step loss and gradients against ``f64_loss``:
    the relative loss error, and the largest normwise error of a
    parameter's gradient with that parameter's name."""
    names = [n for n, _ in pt.model.named_parameters()]
    ref = {n: p.detach().double().requires_grad_()
           for n, p in pt.model.named_parameters()}
    yt = torch.from_numpy(y).long()
    truth = f64_loss(ref, torch.from_numpy(x).double(), yt)
    truth.backward()

    def loss_of(p, x, y):
        return jt.loss_fn(jt.model.apply(p, x, train=True), y)

    runs = {}
    for r, rows in (("jax", slice(None)), ("jax_perm", perm),
                    ("jax_where", slice(None))):
        with jops.use_backend("xla"), pallas_relu_rule(r == "jax_where"):
            loss, g = jax.value_and_grad(loss_of)(
                jt.params, jnp.asarray(x[rows]), jnp.asarray(y[rows]))
        as_port = mnist_cnn()
        load_jax_params(as_port, jax.tree.map(np.asarray, g))
        runs[r] = float(loss), dict(as_port.named_parameters())
    pt.model.zero_grad()
    loss = pt.loss_fn(pt.model(torch.from_numpy(x)), yt)
    loss.backward()
    runs["port"] = (float(loss.detach()),
                    {n: p.grad for n, p in pt.model.named_parameters()})
    pt.model.zero_grad()
    out = {}
    for r, (loss, grads) in runs.items():
        errs = {n: float((grads[n].detach().double() - ref[n].grad).norm()
                         / ref[n].grad.norm()) for n in names}
        worst = max(errs, key=errs.get)
        out[r] = dict(loss=abs(loss - truth.item()) / truth.item(),
                      grad=errs[worst], worst=worst)
    return out


def gap(a, b):
    return abs(a - b) / abs(a)


def run_seed(seed, epochs, train, test, part, out, where=False,
             max_steps=None, port_threads=0):
    runs = (("jax", "port", "jax_perm") + (("jax_where",) if where else ())
            + (("port_threads",) if port_threads else ()))
    pairs = [pair for pair in PAIRS if set(pair) <= set(runs)]
    # one JAX Trainer a run: each traces its own step (the jax_where one
    # under pallas_relu_rule)
    jts = {}
    for r in runs:
        if r.startswith("jax"):
            with jops.use_backend("xla"):
                jts[r] = jtrain.Trainer(
                    jmodels.mnist_cnn(), jopt.Adam(LR, weight_decay=WD),
                    seed=seed)
    jt = jts["jax"]
    pt = Trainer(mnist_cnn(), optim.Adam(LR, weight_decay=WD), seed=seed,
                 device="cpu")
    load_jax_params(pt.model, jax.tree.map(np.asarray, jt.params))
    pt2 = Trainer(mnist_cnn(), optim.Adam(LR, weight_decay=WD), seed=seed,
                  device="cpu")
    load_jax_params(pt2.model, jax.tree.map(np.asarray, jt.params))
    threads = torch.get_num_threads()
    # the step donates its arguments: each run keeps buffers of its own
    jstate = {r: jax.tree.map(jnp.copy, (jt.params, jt.opt_state))
              for r in jts}
    rng = np.random.default_rng(seed)
    rows = np.random.default_rng([seed, 1])
    steps = len(train.labels) // BATCH
    steps = steps if max_steps is None else min(steps, max_steps)
    losses = {r: [] for r in runs}
    parted = {f"{a}_{b}": None for a, b in pairs}

    def jax_step(run, x, y):
        params, state = jstate[run]
        with jops.use_backend("xla"), pallas_relu_rule(run == "jax_where"):
            params, state, loss, _ = jts[run]._train_step(
                params, state, jnp.asarray(x), jnp.asarray(y),
                jax.random.PRNGKey(0))
        jstate[run] = params, state
        return float(loss)

    def evaluate(run):
        if run.startswith("port"):
            t = pt if run == "port" else pt2
            return float(t.evaluate(test.images, test.labels,
                                    batch_size=2000)["acc"])
        t = jts[run]
        t.params, t.opt_state = jstate[run]
        with jops.use_backend("xla"):
            return float(t.evaluate(test.images, test.labels,
                                    batch_size=2000)["acc"])

    f64 = None
    for e in range(epochs):
        t0 = time.perf_counter()
        order = rng.permutation(len(train.labels))
        for s in range(steps):
            idx = order[s * BATCH:(s + 1) * BATCH]
            perm = rows.permutation(BATCH)
            shuffled = idx[perm]
            x, y = train.images[idx], train.labels[idx]
            if f64 is None:
                f64 = first_step_errors(jt, pt, x, y, perm)
            losses["jax"].append(jax_step("jax", x, y))
            losses["jax_perm"].append(jax_step(
                "jax_perm", train.images[shuffled], train.labels[shuffled]))
            if where:
                losses["jax_where"].append(jax_step("jax_where", x, y))
            loss, _ = pt.train_step(torch.from_numpy(x),
                                    torch.from_numpy(y).long())
            losses["port"].append(float(loss))
            if port_threads:
                torch.set_num_threads(port_threads)
                loss, _ = pt2.train_step(torch.from_numpy(x),
                                         torch.from_numpy(y).long())
                torch.set_num_threads(threads)
                losses["port_threads"].append(float(loss))
            for a, b in pairs:
                la, lb = losses[a][-1], losses[b][-1]
                if parted[f"{a}_{b}"] is None and gap(la, lb) > part:
                    parted[f"{a}_{b}"] = dict(step=len(losses[a]) - 1,
                                              **{a: la, b: lb})
        line = dict(seed=seed, epoch=e, seconds=time.perf_counter() - t0,
                    **{f"{r}_val_acc": evaluate(r) for r in runs},
                    **{f"{r}_train_loss": float(np.mean(losses[r][-steps:]))
                       for r in runs},
                    parted=parted)
        print(json.dumps(line), flush=True)
        with open(out, "a") as f:
            f.write(json.dumps(line) + "\n")
    summary = dict(
        seed=seed, epochs=epochs, parted=parted, f64=f64,
        **{f"{r}_spike_step": spike_step(losses[r]) for r in runs},
        first_gaps={f"{a}_{b}": [gap(la, lb) for la, lb in zip(
            losses[a][:FIRST], losses[b][:FIRST])] for a, b in pairs})
    print(json.dumps(summary), flush=True)
    with open(out, "a") as f:
        f.write(json.dumps(summary) + "\n")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=list(range(8)))
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--part", type=float, default=1e-5)
    ap.add_argument("--threads", type=int, default=1)
    ap.add_argument("--where", action="store_true",
                    help="also train jax_where (see the module docstring)")
    ap.add_argument("--port-threads", type=int, default=0,
                    help="also train port_threads on this many threads")
    ap.add_argument("--steps", type=int, default=None,
                    help="at most this many steps an epoch")
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    train, test = MNISTDataset(train=True), MNISTDataset(train=False)
    for seed in args.seeds:
        run_seed(seed, args.epochs, train, test, args.part, args.out,
                 args.where, args.steps, args.port_threads)


if __name__ == "__main__":
    main()
