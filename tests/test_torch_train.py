"""The Trainer (taper_tpu_torch/train.py) against the JAX package's
(taper_tpu/train.py): the same parameters (JAX's init, moved by name) and
the same explicit batches through ``train_step`` and JAX's jitted
``_train_step``, and ``fit_device``'s bookkeeping.

JAX runs the pallas backend in all-kernels mode, Pallas interpreted on the
CPU.  The model is a small CNN built from the same layers as the MNIST
CNN (conv + relu, max pool, global average pool, linear).  Tolerance 1e-4
of each tensor's largest entry; the loss to 1e-5.
"""

import json
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
from taper_tpu_torch.utils.checkpoint import CheckpointManager
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


def test_adam_step_matches_jax_from_a_trained_state(monkeypatch):
    """The port trains 20 Adam steps; JAX then takes the next step from the
    port's parameters, moments and step count, on the same batch as the
    port's own step.  Past the first steps Adam's update is smooth in the
    gradient, so each parameter's new value must agree to 1e-3 of the
    step's size (relative L2): the same step, in other rounding."""
    monkeypatch.setenv("TAPER_CONV", "direct")
    monkeypatch.setenv("TAPER_POOL", "pallas")
    batches = _batches(21, seed=2)
    with jops.use_backend("pallas"):
        jt = jtrain.Trainer(jnn.Sequential(*_layers(jnn)),
                            jopt.Adam(3e-3, weight_decay=1e-4), seed=0)
        pt = Trainer(nn.Sequential(*_layers(nn)),
                     optim.Adam(3e-3, weight_decay=1e-4), seed=0,
                     device="cpu")
        for x, y in batches[:-1]:
            pt.train_step(torch.from_numpy(x), torch.from_numpy(y).long())
        opt = pt.optimizer
        slot = {id(p): j for j, p in enumerate(opt.params)}
        named = dict(pt.model.named_parameters())
        before = {k: p.detach().numpy().copy() for k, p in named.items()}

        def tree(get):
            return [{k: jnp.asarray(get(named[f"{i}.{k}"], f"{i}.{k}"))
                     for k in layer} for i, layer in enumerate(jt.params)]

        params = tree(lambda p, name: before[name])
        state = {**jt.opt_state,
                 "m": tree(lambda p, _: opt.m[slot[id(p)]].numpy().copy()),
                 "v": tree(lambda p, _: opt.v[slot[id(p)]].numpy().copy()),
                 "step": jnp.asarray(opt.t, jnp.int32)}
        x, y = batches[-1]
        params, _, jloss, _ = jt._train_step(
            params, state, jnp.asarray(x), jnp.asarray(y),
            jax.random.PRNGKey(0))
        loss, _ = pt.train_step(torch.from_numpy(x),
                                torch.from_numpy(y).long())
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for i, layer in enumerate(params):
        for k, v in layer.items():
            name = f"{i}.{k}"
            step = np.linalg.norm(np.asarray(v) - before[name])
            err = np.linalg.norm(named[name].detach().numpy() - np.asarray(v))
            assert err <= 1e-3 * step, (name, err, step)


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


def test_trainer_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """device=None means the card; without one the Trainer raises and
    says how to train on the CPU, instead of quietly using it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Trainer(mnist_mlp(), optim.SGD(0.1))
    assert Trainer(mnist_mlp(), optim.SGD(0.1), device="cpu").device.type \
        == "cpu"


def test_training_path_imports_no_jax():
    code = ("import sys, taper_tpu_torch.train, taper_tpu_torch.data, "
            "taper_tpu_torch.models, taper_tpu_torch.nn, chip_smoke; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'taper_tpu')); assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=Path(__file__).resolve().parents[1])


class _MNISTSubset:
    """n synthetic MNIST digits, rendered by the port's copy of the JAX
    renderer (the same numpy code)."""

    def __init__(self, n, seed):
        from taper_tpu_torch.data import synthesize_images_numpy
        self.labels = np.random.default_rng(seed).integers(
            0, 10, n).astype(np.int32)
        self.images = synthesize_images_numpy(self.labels, seed=seed)

    def __len__(self):
        return len(self.labels)

    def get_batch(self, idx):
        idx = np.asarray(idx)
        return self.images[idx], self.labels[idx]


def test_fit_over_a_dataloader_matches_jax_fit():
    """One epoch of the MLP with Adam through ``Trainer.fit`` over the
    port's DataLoader, against the JAX Trainer's ``fit`` over JAX's
    DataLoader (the same batch order for the same seed, test_torch_loader)
    from JAX's parameters.  Parameters within 1e-4 relative L2 after 16
    steps; the epoch's metrics within 1e-5."""
    from taper_tpu import models as jmodels
    from taper_tpu.data import loader as jloader
    from taper_tpu_torch.data import DataLoader

    train, val = _MNISTSubset(1024, 0), _MNISTSubset(256, 1)
    jt = jtrain.Trainer(jmodels.mnist_mlp(), jopt.Adam(1e-3,
                                                       weight_decay=1e-4),
                        seed=0)
    pt = Trainer(mnist_mlp(), optim.Adam(1e-3, weight_decay=1e-4), seed=0,
                 device="cpu")
    load_jax_params(pt.model, jax.tree.map(np.asarray, jt.params))
    jm = jt.fit(jloader.DataLoader(train, 64, seed=5), val.images,
                val.labels, epochs=1, verbose=False)
    pm = pt.fit(DataLoader(train, 64, seed=5), val.images, val.labels,
                epochs=1, verbose=False)
    for name in ("train_loss", "train_acc", "val_loss", "val_acc"):
        np.testing.assert_allclose(getattr(pm, name), getattr(jm, name),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    ported = dict(pt.model.named_parameters())
    for i, layer in enumerate(jt.params):
        for k, v in layer.items():
            out = ported[f"{i}.{k}"].detach().numpy().astype(np.float64)
            ref = np.asarray(v, np.float64)
            assert np.linalg.norm(out - ref) <= 1e-4 * np.linalg.norm(ref)


def test_fit_logs_json_lines_and_reset_starts_over(tmp_path):
    from taper_tpu_torch.data import DataLoader

    train = _MNISTSubset(128, 2)
    log = tmp_path / "log.jsonl"
    sched = optim.StepLR(0.01, step_size=1, gamma=0.5)
    tr = Trainer(mnist_mlp(), optim.Adam(0.01), scheduler=sched, seed=0,
                 device="cpu", log_path=str(log))
    first = [p.detach().clone() for p in tr.model.parameters()]
    m = tr.fit(DataLoader(train, 32, seed=0), train.images, train.labels,
               epochs=2, early_stop_acc=2.0, verbose=False)
    lines = [json.loads(s) for s in log.read_text().splitlines()]
    assert [ln["epoch"] for ln in lines] == [1, 2]
    assert lines[1]["val_acc"] == pytest.approx(m.val_acc[1])
    assert tr.optimizer.lr == pytest.approx(0.0025)
    tr.reset_parameters(0)
    assert len(tr.metrics.val_acc) == 0 and tr.optimizer.lr == 0.01
    assert all(torch.equal(a, b) for a, b in zip(first,
                                                 tr.model.parameters()))
    # fit's checkpoints: one per epoch, under the global epoch index
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=1)
    tr.fit(DataLoader(train, 32), train.images, train.labels, 2,
           early_stop_acc=2.0, verbose=False, ckpt_manager=mgr)
    assert mgr.all_steps() == [2]


def test_xor_example_loss_falls_on_the_cpu():
    from taper_tpu_torch.examples import train_xor

    args = train_xor.parse_args(["--device", "cpu", "--steps", "2000"])
    _, first, last, preds = train_xor.train(args)
    assert last < first - 0.1
    assert preds.shape == (4, 1) and torch.isfinite(preds).all()
