"""The MNIST models (taper_tpu_torch/models/mnist.py) against the JAX
package's (taper_tpu/models/mnist.py): JAX initialises the parameters,
``load_jax_params`` moves them into the port by name, and both packages
give the same logits, loss and gradient of every parameter.

JAX runs the pallas backend in all-kernels mode (``TAPER_CONV=direct``,
``TAPER_POOL=pallas``), Pallas interpreted on the CPU.  Tolerance 1e-4 of
each tensor's largest entry for logits and gradients, 1e-5 for the loss:
both sides sum f32 products in other orders through up to 8 layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taper_tpu import losses as jlosses
from taper_tpu import models as jmodels
from taper_tpu import ops as jops
from taper_tpu_torch import losses, models
from taper_tpu_torch.nn import Sequential
from taper_tpu_torch.utils.convert import load_jax_params

torch.set_num_threads(1)


def _close(out, ref, tol=1e-4):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=tol,
                               atol=tol * max(float(np.abs(ref).max()), 1e-30))


def _compare(name, x, y, loss_name, monkeypatch):
    monkeypatch.setenv("TAPER_CONV", "direct")
    monkeypatch.setenv("TAPER_POOL", "pallas")
    jmodel = getattr(jmodels, name)()
    params = jmodel.init(jax.random.PRNGKey(0))
    jloss_fn = getattr(jlosses, loss_name)

    def loss_of(p):
        logits = jmodel.apply(p, jnp.asarray(x))
        return jloss_fn(logits, jnp.asarray(y)), logits

    with jops.use_backend("pallas"):
        (jloss, jlogits), jgrads = jax.value_and_grad(
            loss_of, has_aux=True)(params)

    model = getattr(models, name)()
    load_jax_params(model, jax.tree.map(np.asarray, params))
    logits = model(torch.from_numpy(x))
    loss = getattr(losses, loss_name)(logits, torch.from_numpy(y))
    loss.backward()

    _close(logits.detach().numpy(), jlogits)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    grads = dict(model.named_parameters())
    n = 0
    for i, layer in enumerate(jgrads):
        for k, g in layer.items():
            _close(grads[f"{i}.{k}"].grad.numpy(), g)
            n += 1
    assert n == len(grads)


def test_mnist_cnn_logits_loss_and_grads_match_jax(monkeypatch):
    rng = np.random.default_rng(0)
    x = rng.random((2, 784)).astype(np.float32)
    y = np.array([3, 7], np.int32)
    _compare("mnist_cnn", x, y, "cross_entropy_loss", monkeypatch)


def test_mnist_mlp_logits_loss_and_grads_match_jax(monkeypatch):
    rng = np.random.default_rng(1)
    x = rng.random((4, 784)).astype(np.float32)
    y = np.array([0, 9, 4, 4], np.int32)
    _compare("mnist_mlp", x, y, "cross_entropy_loss", monkeypatch)


def test_xor_mlp_logits_loss_and_grads_match_jax(monkeypatch):
    x = np.array([[0, 0], [0, 1], [1, 0], [1, 1]], np.float32)
    y = np.array([[0], [1], [1], [0]], np.float32)
    _compare("xor_mlp", x, y, "bce_loss", monkeypatch)


def test_cnn_parameter_names_and_count_match_jax():
    params = jmodels.mnist_cnn().init(jax.random.PRNGKey(0))
    model = models.mnist_cnn()
    names = [f"{i}.{k}" for i, layer in enumerate(params) for k in layer]
    assert [n for n, _ in model.named_parameters()] == names
    assert sum(p.numel() for p in model.parameters()) == \
        jmodels.mnist_cnn().param_count(params)


def test_init_bounds_and_generator():
    """Linear weights in +-sqrt(2/fan_in), conv weights in
    +-sqrt(2/fan_in)*sqrt(3), zero biases; one seed, one draw."""
    a, b = models.mnist_cnn(), models.mnist_cnn()
    a.reset_parameters(torch.Generator().manual_seed(3))
    b.reset_parameters(torch.Generator().manual_seed(3))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    conv, fc = a[2].w.detach(), a[10].w.detach()
    assert float(conv.abs().max()) <= np.sqrt(2 / 288) * np.sqrt(3)
    assert float(conv.abs().max()) > 0.9 * np.sqrt(2 / 288) * np.sqrt(3)
    assert float(fc.abs().max()) <= np.sqrt(2 / 128)
    assert not a[2].b.any()
    assert isinstance(a, Sequential) and len(Sequential([a[10]])) == 1
