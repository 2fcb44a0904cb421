"""Port of the checkpoints (taper_tpu_torch/utils/checkpoint.py,
utils/safetensors_io.py, and the Trainer's ``save_checkpoint``,
``load_checkpoint``, ``restore``, ``fit(ckpt_manager=)`` and
``fit_device(checkpoint_path=, save_every=, resume=)``) against the JAX
package's file formats and behaviour.

Parameters come from JAX's ``init``; data from numpy with a fixed seed.
Files move between the packages bit for bit, and a resumed run on the CPU
ends exactly where the uninterrupted run does (the same f32 arithmetic in
the same order): every comparison here is exact.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from taper_tpu import models as jmodels
from taper_tpu.utils import checkpoint as jckpt
from taper_tpu_torch import models, optim
from taper_tpu_torch.data import DataLoader
from taper_tpu_torch.models import TinyGPT, mnist_mlp
from taper_tpu_torch.train import Trainer
from taper_tpu_torch.utils import checkpoint as ckpt
from taper_tpu_torch.utils.convert import load_jax_params

torch.set_num_threads(1)

CFG = dict(vocab_size=31, dim=32, depth=2, num_heads=4, max_seq=16,
           rope=True)


def _equal(tree, ref):
    """Every leaf of the port's tree equals JAX's at the same path."""
    leaves = dict(ckpt.flatten(tree))
    ref_leaves = {jckpt._path_str(p): np.asarray(v) for p, v in
                  jax.tree_util.tree_flatten_with_path(ref)[0]}
    assert leaves.keys() == ref_leaves.keys()
    for k, v in leaves.items():
        np.testing.assert_array_equal(torch.as_tensor(v).detach().numpy(),
                                      ref_leaves[k], err_msg=k)


@pytest.mark.parametrize("which", ["tinygpt", "resnet8"])
def test_params_files_cross_load_between_the_packages(tmp_path, which):
    """A params file JAX's save_checkpoint wrote loads into the port's
    model (BatchNorm's running statistics included), and one the port
    wrote loads into JAX's tree."""
    if which == "tinygpt":
        jmodel, model = jmodels.TinyGPT(**CFG), TinyGPT(**CFG)
    else:
        jmodel, model = jmodels.resnet8(), models.resnet8()
    params = jax.tree.map(lambda a: a + 0.5,
                          jmodel.init(jax.random.PRNGKey(1)))
    path = str(tmp_path / "jax.npz")
    jckpt.save_checkpoint(path, params, metadata={"epochs": 3})
    tree, meta = ckpt.load_checkpoint(path, ckpt.params_tree(model))
    assert meta == {"epochs": 3}
    ckpt.copy_tree_(ckpt.params_tree(model), tree)
    _equal(ckpt.params_tree(model), params)

    with torch.no_grad():
        for p in model.parameters():
            p.mul_(2.0)
    path = str(tmp_path / "port.npz")
    ckpt.save_checkpoint(path, ckpt.params_tree(model))
    back, _ = jckpt.load_checkpoint(path, params)
    _equal(ckpt.params_tree(model), back)


def test_load_checkpoint_checks_leaves_and_shapes(tmp_path):
    model = TinyGPT(**CFG)
    path = str(tmp_path / "m.npz")
    ckpt.save_checkpoint(path, ckpt.params_tree(model))
    wider = TinyGPT(**dict(CFG, dim=64))
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.load_checkpoint(path, ckpt.params_tree(wider))
    deeper = TinyGPT(**dict(CFG, depth=3))
    with pytest.raises(KeyError, match="blocks/2"):
        ckpt.load_checkpoint(path, ckpt.params_tree(deeper))
    with pytest.raises(NotImplementedError, match="shardings"):
        ckpt.load_checkpoint(path, ckpt.params_tree(model), shardings={})
    assert not os.path.exists(path + ".tmp")


@pytest.mark.parametrize("async_save", [False, True])
def test_manager_rotation_keep_best_and_manifest_match_jax(tmp_path,
                                                           async_save):
    """The same saves through both managers leave the same manifest and
    the same files: the newest two steps plus the best one by a max
    metric."""
    metrics = [0.3, 0.9, 0.5, 0.4, 0.6]
    mgrs = [cls(str(tmp_path / name), max_to_keep=2, keep_best=1,
                mode="max", async_save=async_save)
            for cls, name in ((ckpt.CheckpointManager, "port"),
                              (jckpt.CheckpointManager, "jax"))]
    for step, m in enumerate(metrics, start=1):
        tree = {"w": np.full((2, 3), step, np.float32)}
        for mgr in mgrs:
            mgr.save(step, tree, metadata={"epochs": step}, metric=m)
    for mgr in mgrs:
        mgr.wait()
    manifests = [json.loads((tmp_path / name / "manifest.json").read_text())
                 for name in ("port", "jax")]
    assert manifests[0] == manifests[1]
    assert mgrs[0].all_steps() == [2, 4, 5] and mgrs[0].best_step() == 2
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "jax"))
    tree, meta = mgrs[0].restore({"w": np.zeros((2, 3), np.float32)},
                                 step=2)
    assert meta["epochs"] == 2 and (tree["w"] == 2).all()
    # a reopened directory resumes from the manifest
    again = ckpt.CheckpointManager(str(tmp_path / "port"))
    assert again.latest_step() == 5
    with pytest.raises(KeyError, match="not in manifest"):
        again.restore({"w": np.zeros((2, 3), np.float32)}, step=1)


def test_async_save_snapshots_the_tree_when_called(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path), async_save=True)
    t = torch.ones(4)
    mgr.save(1, {"t": t})
    t.add_(5.0)                       # after the call: not in the file
    mgr.wait()
    tree, _ = mgr.restore({"t": torch.zeros(4)})
    assert torch.equal(tree["t"], torch.ones(4))


def _mnist(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.random((n, 784)).astype(np.float32)
    y = (x[:, :10].argmax(1)).astype(np.int64)
    return x, y


class _Split:
    def __init__(self, n, seed):
        self.images, self.labels = _mnist(n, seed)

    def __len__(self):
        return len(self.labels)

    def get_batch(self, idx):
        return self.images[idx], self.labels[idx]


@pytest.mark.parametrize("sched", ["step", "plateau"])
def test_trainer_restore_gives_params_moments_and_schedule(tmp_path, sched):
    """fit with a CheckpointManager for two epochs; a fresh Trainer
    restored from it holds the same parameters, Adam moments, step count
    and learning rate.  StepLR's lr is recomputed from the epoch count;
    ReduceLROnPlateau keeps the loaded, decayed lr (its metric history
    cannot be replayed)."""
    def make():
        s = (optim.StepLR(0.01, step_size=1, gamma=0.5) if sched == "step"
             else optim.ReduceLROnPlateau(0.01, mode="max", factor=0.5,
                                          patience=0))
        return Trainer(mnist_mlp(), optim.Adam(0.01), scheduler=s, seed=0,
                       device="cpu")
    split = _Split(128, 1)
    tr = make()
    mgr = ckpt.CheckpointManager(str(tmp_path / "ck"))
    tr.fit(DataLoader(split, 32, seed=0), split.images, split.labels, 2,
           early_stop_acc=2.0, verbose=False, ckpt_manager=mgr)
    assert tr.optimizer.lr == pytest.approx(0.0025 if sched == "step"
                                            else 0.005)
    other = make()
    assert other.restore(mgr) == 2
    for (n, a), b in zip(tr.model.named_parameters(),
                         other.model.parameters()):
        assert torch.equal(a, b), n
    for a, b in zip(tr.optimizer.m + tr.optimizer.v,
                    other.optimizer.m + other.optimizer.v):
        assert torch.equal(a, b)
    assert other.optimizer.t == tr.optimizer.t == 8
    assert other.optimizer.lr == tr.optimizer.lr
    assert other.scheduler.epoch == 2
    # one more epoch through fit continues the global numbering
    other.fit(DataLoader(split, 32, seed=0), split.images, split.labels, 1,
              early_stop_acc=2.0, verbose=False, ckpt_manager=mgr)
    assert mgr.latest_step() == 3


def test_fit_device_resumed_ends_where_the_uninterrupted_run_does(tmp_path):
    """Two epochs in one run, against one epoch, a fresh process's Trainer
    and ``resume=True``: the same parameters, moments and lr, bit for
    bit (each epoch's batch order comes from the seed and the epoch)."""
    tx, ty = _mnist(256, 2)
    vx, vy = _mnist(64, 3)

    def make():
        return Trainer(mnist_mlp(), optim.Adam(0.01, weight_decay=1e-4),
                       scheduler=optim.StepLR(0.01, step_size=1, gamma=0.5),
                       seed=5, device="cpu")
    kw = dict(batch_size=32, early_stop_acc=2.0, verbose=False)
    full = make()
    full.fit_device(tx, ty, vx, vy, 2, checkpoint_path=str(tmp_path / "a"),
                    **kw)
    cut = make()
    path = str(tmp_path / "b.npz")
    cut.fit_device(tx, ty, vx, vy, 1, checkpoint_path=path, save_every=1,
                   **kw)
    resumed = make()
    m = resumed.fit_device(tx, ty, vx, vy, 2, checkpoint_path=path,
                           resume=True, **kw)
    assert len(m.val_acc) == 1
    assert m.val_acc[0] == full.metrics.val_acc[1]
    for a, b in zip(full.model.parameters(), resumed.model.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(full.optimizer.v, resumed.optimizer.v):
        assert torch.equal(a, b)
    assert resumed.optimizer.lr == full.optimizer.lr == 0.0025
    # both runs' files hold the same state; save_every=2 skips epoch 1
    for p, t in ckpt.flatten(ckpt.load_checkpoint(
            path, resumed._state_tree())[0]):
        assert torch.equal(t, dict(ckpt.flatten(resumed._state_tree()))[p])
    skip = make()
    skip.fit_device(tx, ty, vx, vy, 1, checkpoint_path=str(tmp_path / "c"),
                    save_every=2, **kw)
    assert not os.path.exists(tmp_path / "c")


def test_safetensors_files_cross_load(tmp_path):
    pytest.importorskip("safetensors")
    from taper_tpu.utils import safetensors_io as jsio
    from taper_tpu_torch.utils import safetensors_io as sio

    jmodel = jmodels.TinyGPT(**CFG)
    params = jmodel.init(jax.random.PRNGKey(2))
    path = str(tmp_path / "jax.safetensors")
    jsio.save_params(path, params)
    model = TinyGPT(**CFG)
    tree = sio.load_params(path, model)
    ckpt.copy_tree_(ckpt.params_tree(model), tree)
    _equal(ckpt.params_tree(model), params)
    assert set(sio.load_flat(path)) == {n for n, _ in
                                        model.named_parameters()}
    path = str(tmp_path / "port.safetensors")
    assert sio.save_params(path, model) == len(jax.tree.leaves(params))
    back = jsio.load_params(path, params)
    _equal(ckpt.params_tree(model), back)
    with pytest.raises(ValueError, match="shape"):
        sio.load_params(path, TinyGPT(**dict(CFG, dim=64)))


def test_reference_model_loads_through_load_jax_params_too(tmp_path):
    """A JAX file, read by the port's loader, gives the same model as
    ``load_jax_params`` on JAX's tree."""
    jmodel = jmodels.TinyGPT(**CFG)
    params = jmodel.init(jax.random.PRNGKey(4))
    path = str(tmp_path / "p.npz")
    jckpt.save_checkpoint(path, params)
    a = TinyGPT(**CFG)
    ckpt.copy_tree_(ckpt.params_tree(a), ckpt.load_checkpoint(
        path, ckpt.params_tree(a))[0])
    b = load_jax_params(TinyGPT(**CFG), jax.tree.map(np.asarray, params))
    for x, y in zip(a.parameters(), b.parameters()):
        assert torch.equal(x, y)


class _Images:
    """A small stand-in for the examples' datasets: ``n`` random images of
    ``shape`` (no rendering of the 60k/50k synthetic sets)."""

    def __init__(self, n, shape, seed):
        rng = np.random.default_rng(seed)
        self.images = rng.random((n,) + shape).astype(np.float32)
        self.labels = rng.integers(0, 10, n).astype(np.int64)
        self.source = "synthetic"

    def __len__(self):
        return len(self.labels)

    def get_batch(self, idx):
        return self.images[idx], self.labels[idx]


@pytest.mark.parametrize("example", ["train_mnist", "train_mnist_cnn",
                                     "train_cifar10_resnet"])
def test_examples_save_a_checkpoint(tmp_path, monkeypatch, example):
    """Each example saves its trained state where the JAX example does
    (here moved by ``--checkpoint``), and the file restores it."""
    import importlib
    from taper_tpu_torch import data
    mod = importlib.import_module(f"taper_tpu_torch.examples.{example}")
    shape = (3, 32, 32) if example == "train_cifar10_resnet" else (784,)
    fake = lambda train=True, **kw: _Images(256 if train else 64, shape,  # noqa
                                            int(train))
    monkeypatch.setattr(data, "MNISTDataset", fake)
    monkeypatch.setattr(mod, "CIFAR10Dataset", fake, raising=False)
    path = str(tmp_path / "ckpt.npz")
    trainer = mod.main(["--device", "cpu", "--epochs", "1", "--checkpoint",
                        path])
    state = trainer._state_tree()
    tree, meta = ckpt.load_checkpoint(path, state)
    assert meta == {"epochs": 1}
    for p, t in ckpt.flatten(tree):
        assert torch.equal(t, dict(ckpt.flatten(state))[p]), p
