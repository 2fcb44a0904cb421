"""ResNet-8 (taper_tpu_torch/models/resnet.py) against the JAX package's
(taper_tpu/models/resnet.py) at its full widths, batch 8, 3x32x32: JAX
initialises the parameters and running statistics, ``load_jax_params``
moves them into the port by name (the statistics into BatchNorm's
buffers), and both packages take one train-mode step.

JAX runs the pallas backend in all-kernels mode (``TAPER_CONV=direct``,
``TAPER_POOL=pallas``), Pallas interpreted on the CPU.  Tolerances: the
loss 1e-5 relative; every gradient 1e-4 relative L2 (f32 sums in other
orders through 8 layers, BatchNorm's statistics and their backward);
the new running statistics and the eval-mode logits after the step
1e-5 and 1e-4 of the largest |entry|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taper_tpu import losses as jlosses
from taper_tpu import models as jmodels
from taper_tpu import ops as jops
from taper_tpu import optim as jopt
from taper_tpu import train as jtrain
from taper_tpu_torch import losses, models, optim
from taper_tpu_torch.train import Trainer
from taper_tpu_torch.utils.convert import _flatten, load_jax_params

torch.set_num_threads(1)


@pytest.fixture
def pallas(monkeypatch):
    monkeypatch.setenv("TAPER_CONV", "direct")
    monkeypatch.setenv("TAPER_POOL", "pallas")
    with jops.use_backend("pallas"):
        yield


def _batch(seed=0, n=8):
    rng = np.random.default_rng(seed)
    return (rng.random((n, 3, 32, 32)).astype(np.float32),
            rng.integers(0, 10, n).astype(np.int32))


def _flat(tree):
    return dict(_flatten(jax.tree.map(np.asarray, tree)))


def _rel_l2(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(out - ref) / max(np.linalg.norm(ref), 1e-30)


def _close_max(out, ref, tol):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=tol,
                               atol=tol * max(float(np.abs(ref).max()), 1e-30))


def test_train_step_gradients_running_stats_and_eval_match_jax(pallas):
    x, y = _batch()
    jmodel = jmodels.resnet8()
    params = jmodel.init(jax.random.PRNGKey(0))

    def loss_of(p):
        logits, new_p = jmodel.apply_train(p, jnp.asarray(x))
        return jlosses.cross_entropy_loss(logits, jnp.asarray(y)), new_p

    (jloss, new_params), jgrads = jax.value_and_grad(
        loss_of, has_aux=True)(params)
    jeval = jmodel.apply(new_params, jnp.asarray(x), train=False)

    model = models.resnet8()
    load_jax_params(model, jax.tree.map(np.asarray, params))
    model.train()
    loss = losses.cross_entropy_loss(model(torch.from_numpy(x)),
                                     torch.from_numpy(y).long())
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5)

    grads, stats = _flat(jgrads), _flat(new_params)
    named = dict(model.named_parameters())
    assert named.keys() == {k for k in grads
                            if ".running_" not in k}
    for k, p in named.items():
        assert _rel_l2(p.grad.numpy(), grads[k]) <= 1e-4, k
    buffers = dict(model.named_buffers())
    assert len(buffers) == 14
    for k, b in buffers.items():
        _close_max(b.numpy(), stats[k], 1e-5)
        assert not np.allclose(stats[k], _flat(params)[k]), k

    model.eval()
    with torch.no_grad():
        logits = model(torch.from_numpy(x))
    _close_max(logits.numpy(), jeval, 1e-4)


def test_trainer_step_with_adamw_matches_jax(pallas):
    """One Trainer.train_step with AdamW (the CIFAR example's optimizer)
    against the JAX Trainer's jitted step on the same batch, from JAX's
    parameters: every parameter and running statistic within 1e-5.

    Adam's first update is ``lr g / (|g| + 3.2e-7)`` (eps 1e-8 after the
    bias corrections), as steep as ``lr / 3.2e-7 ~ 1e4`` near g = 0: an
    entry whose gradient lies within the two packages' f32 rounding of 0
    (~1e-8 here, 1e-6 of the gradients' RMS) moves by up to 2 lr on one
    side and not the other.  Entries with ``|g| <= 1e-6`` (under 1% of
    the 78k) are held to that bound, 2 lr;
    every other entry to 1e-5."""
    x, y = _batch(seed=1)
    make = lambda m: m.AdamW(3e-3, weight_decay=5e-4)    # noqa: E731
    jt = jtrain.Trainer(jmodels.resnet8(), make(jopt), seed=0)
    pt = Trainer(models.resnet8(), make(optim), seed=0, device="cpu")
    load_jax_params(pt.model, jax.tree.map(np.asarray, jt.params))
    params, state, jloss, jacc = jt._train_step(
        jt.params, jt.opt_state, jnp.asarray(x), jnp.asarray(y),
        jax.random.PRNGKey(0))
    # JAX's gradient from its first moment, m = (1 - b1) g
    grads = {k: m / 0.1 for k, m in _flat(state["m"]).items()}
    loss, acc = pt.train_step(torch.from_numpy(x),
                              torch.from_numpy(y).long())
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert float(acc) == float(jacc)
    ref = _flat(params)
    ported = dict(pt.model.named_parameters())
    ported.update(pt.model.named_buffers())
    assert ported.keys() == ref.keys()
    steep = 0
    for k, t in ported.items():
        err = np.abs(t.detach().numpy() - ref[k])
        flat = np.abs(grads[k]) <= 1e-6 if k in grads else np.zeros(
            err.shape, bool)
        steep += int(flat.sum())
        assert (err[~flat] <= 1e-5 * (1 + np.abs(ref[k][~flat]))).all(), k
        assert (err[flat] <= 2 * 3e-3).all(), k
    assert steep <= 1e-2 * sum(a.size for a in ref.values())


def test_load_jax_params_raises_on_a_missing_or_extra_buffer_leaf():
    model = models.resnet8()
    tree = jax.tree.map(np.asarray,
                        jmodels.resnet8().init(jax.random.PRNGKey(0)))
    load_jax_params(model, tree)
    missing = jax.tree.map(lambda a: a, tree)
    del missing[0]["bn"]["running_var"]
    with pytest.raises(KeyError, match="running_var"):
        load_jax_params(model, missing)
    extra = jax.tree.map(lambda a: a, tree)
    extra[1]["bn1"]["running_extra"] = np.zeros(16, np.float32)
    with pytest.raises(KeyError, match="running_extra"):
        load_jax_params(model, extra)
    bad = jax.tree.map(lambda a: a, tree)
    bad[3]["bn2"]["running_mean"] = np.zeros(7, np.float32)
    with pytest.raises(ValueError, match="running_mean"):
        load_jax_params(model, bad)


def test_resnet8_counts_and_modes():
    """The JAX model's parameter count (its tree holds the running
    statistics too), and BatchNorm's two modes: train moves the running
    statistics, eval reads them and moves nothing."""
    model = models.resnet8()
    n_params = sum(p.numel() for p in model.parameters())
    n_stats = sum(b.numel() for b in model.buffers())
    jp = jmodels.resnet8().init(jax.random.PRNGKey(0))
    assert n_params + n_stats == sum(a.size for a in jax.tree.leaves(jp))
    x = torch.from_numpy(_batch(seed=2)[0])
    before = [b.clone() for b in model.buffers()]
    model.eval()
    with torch.no_grad():
        model(x)
    assert all(torch.equal(a, b) for a, b in zip(before, model.buffers()))
    model.train()
    with torch.no_grad():
        model(x)
    assert not torch.equal(before[0], next(model.buffers()))
