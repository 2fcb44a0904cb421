"""The Trainer (taper_tpu_torch/train.py) against the JAX package's
(taper_tpu/train.py): the same parameters (JAX's init, moved by name) and
the same explicit batches through ``train_step`` and JAX's jitted
``_train_step``, and ``fit_device``'s bookkeeping.

JAX runs the pallas backend in all-kernels mode, Pallas interpreted on the
CPU.  The model is a small CNN built from the same layers as the MNIST
CNN (conv + relu, max pool, global average pool, linear).  Tolerance 1e-4
of each tensor's largest entry; the loss to 1e-5.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taper_tpu import nn as jnn
from taper_tpu import ops as jops
from taper_tpu import optim as jopt
from taper_tpu import train as jtrain
from taper_tpu_torch import nn, optim
from taper_tpu_torch.models import mnist_mlp
from taper_tpu_torch.train import Metrics, Trainer
from taper_tpu_torch.utils.convert import load_jax_params

torch.set_num_threads(1)


def _layers(m):
    return [m.Conv2dReLU(1, 4, 3, padding=1), m.MaxPool2d.new_2x2(),
            m.Conv2dReLU(4, 6, 3, padding=1), m.AdaptiveAvgPool2d.global_(),
            m.Flatten(), m.Linear(6, 5)]


def _close(out, ref, tol=1e-4):
    out, ref = np.asarray(out), np.asarray(ref)
    np.testing.assert_allclose(out, ref, rtol=tol,
                               atol=tol * max(float(np.abs(ref).max()), 1e-30))


def _batches(n_steps, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.random((4, 1, 8, 8)).astype(np.float32),
             rng.integers(0, 5, 4).astype(np.int32)) for _ in range(n_steps)]


def _run_both(make_opt, batches, monkeypatch):
    monkeypatch.setenv("TAPER_CONV", "direct")
    monkeypatch.setenv("TAPER_POOL", "pallas")
    with jops.use_backend("pallas"):
        jt = jtrain.Trainer(jnn.Sequential(*_layers(jnn)), make_opt(jopt),
                            seed=0)
        pt = Trainer(nn.Sequential(*_layers(nn)), make_opt(optim), seed=0,
                     device="cpu")
        load_jax_params(pt.model, jax.tree.map(np.asarray, jt.params))
        params, state = jt.params, jt.opt_state
        losses = []
        for i, (x, y) in enumerate(batches):
            params, state, jloss, jacc = jt._train_step(
                params, state, jnp.asarray(x), jnp.asarray(y),
                jax.random.PRNGKey(i))
            loss, acc = pt.train_step(torch.from_numpy(x),
                                      torch.from_numpy(y).long())
            losses.append((float(loss), float(jloss), float(acc),
                           float(jacc)))
    return pt, params, losses


def test_sgd_momentum_trajectory_matches_jax(monkeypatch):
    """Parameters after 5 SGD-with-momentum steps on the same batches."""
    pt, params, losses = _run_both(
        lambda m: m.SGD(0.1, momentum=0.9, weight_decay=1e-3), _batches(5),
        monkeypatch)
    for loss, jloss, acc, jacc in losses:
        np.testing.assert_allclose(loss, jloss, rtol=1e-5)
        assert acc == jacc
    ported = dict(pt.model.named_parameters())
    for i, layer in enumerate(params):
        for k, v in layer.items():
            _close(ported[f"{i}.{k}"].detach().numpy(), v)


def test_adam_step_matches_jax_on_the_loss(monkeypatch):
    """One Adam step, then the loss of the updated model on a second batch
    (Adam's first update is sign-like, so parameters are held through the
    loss they give rather than element by element)."""
    _, _, losses = _run_both(lambda m: m.Adam(3e-3, weight_decay=1e-4),
                             _batches(2, seed=1), monkeypatch)
    for loss, jloss, _, _ in losses:
        np.testing.assert_allclose(loss, jloss, rtol=1e-5)


def _synthetic(n, seed):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 10, n).astype(np.int32)
    x = rng.random((n, 784)).astype(np.float32) * 0.1
    x[np.arange(n), y * 70] = 1.0          # a learnable marker per class
    return x, y


def test_fit_device_records_metrics_steps_scheduler_and_stops_early():
    tx, ty = _synthetic(256, 0)
    vx, vy = _synthetic(100, 1)
    sched = optim.StepLR(0.01, step_size=1, gamma=0.5)
    tr = Trainer(mnist_mlp(), optim.Adam(0.01), scheduler=sched, seed=0,
                 device="cpu")
    m = tr.fit_device(tx, ty, vx, vy, epochs=3, batch_size=64,
                      early_stop_acc=2.0, verbose=False)
    assert isinstance(m, Metrics) and len(m.val_acc) == 3
    assert tr.optimizer.lr == pytest.approx(0.01 * 0.5 ** 3)
    assert m.train_loss[-1] < m.train_loss[0]
    assert m.val_acc[-1] > 0.5
    ev = tr.evaluate(vx, vy, batch_size=32)
    assert ev["acc"] == pytest.approx(m.val_acc[-1])
    assert ev["loss"] == pytest.approx(m.val_loss[-1], rel=1e-5)

    tr = Trainer(mnist_mlp(), optim.Adam(0.01), seed=0, device="cpu")
    m = tr.fit_device(tx, ty, vx, vy, epochs=5, batch_size=64,
                      early_stop_acc=-1.0, verbose=False)
    assert len(m.val_acc) == 1               # stopped after one epoch


def test_fit_device_is_reproducible_from_the_seed():
    tx, ty = _synthetic(128, 2)
    runs = []
    for _ in range(2):
        tr = Trainer(mnist_mlp(), optim.SGD(0.05, momentum=0.9), seed=4,
                     device="cpu")
        runs.append(tr.fit_device(tx, ty, tx, ty, epochs=2, batch_size=32,
                                  verbose=False).train_loss)
    assert runs[0] == runs[1]


def test_trainer_raises_on_what_is_not_ported():
    for kw in (dict(mesh=object()), dict(zero1=True),
               dict(tensor_parallel=True), dict(augment=lambda b, k: b)):
        with pytest.raises(NotImplementedError, match="not ported"):
            Trainer(mnist_mlp(), optim.SGD(0.1), device="cpu", **kw)
    tr = Trainer(mnist_mlp(), optim.SGD(0.1), device="cpu")
    x, y = _synthetic(8, 3)
    with pytest.raises(NotImplementedError, match="checkpoint"):
        tr.fit_device(x, y, x, y, 1, batch_size=8, checkpoint_path="c.npz")


def test_training_path_imports_no_jax():
    code = ("import sys, taper_tpu_torch.train, taper_tpu_torch.data, "
            "taper_tpu_torch.models, taper_tpu_torch.nn, chip_smoke; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'taper_tpu')); assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=Path(__file__).resolve().parents[1])
