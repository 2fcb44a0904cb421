"""Dropout and remat in the port (taper_tpu_torch/nn/layers.py
``Dropout``, ``TransformerBlock``'s dropout, ``TinyGPT(dropout=,
remat=)``, the Trainer's ``train_uses_rng``) against the JAX package where
the two can agree, and by statistics where they cannot.

The port draws dropout masks from ``torch.Generator``s, whose bits are
not ``jax.random``'s, so JAX is held at p = 0 (train or not) and with
dropout off outside training; the masks themselves are held by their keep
rate and scale.  Tolerances: the model's loss to 1e-5 and each gradient to
1e-4 relative L2 against JAX (tests/test_torch_lm.py's); remat against no
remat within the port, bit for bit (the recompute repeats the forward's
arithmetic and its masks on the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taper_tpu import models as jmodels
from taper_tpu import nn as jnn
from taper_tpu_torch import nn as tnn
from taper_tpu_torch import optim
from taper_tpu_torch.models import TinyGPT
from taper_tpu_torch.train import Trainer, stream_seed
from taper_tpu_torch.utils.convert import _flatten, load_jax_params

torch.set_num_threads(1)

CFG = dict(vocab_size=32, dim=32, depth=2, num_heads=2, max_seq=16)


def test_dropout_at_p0_and_outside_training_matches_jax():
    x = np.random.default_rng(0).standard_normal((4, 8)).astype(np.float32)
    for p, train in ((0.0, True), (0.5, False)):
        ref = jnn.Dropout(p).apply({}, jnp.asarray(x), train=train,
                                   rng=jax.random.PRNGKey(0))
        out = tnn.Dropout(p)(torch.from_numpy(x), train=train,
                             generator=torch.Generator())
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_dropout_keep_rate_scale_and_errors():
    """Over 40,000 elements at p = 0.3 the kept share is 0.7 within 0.01
    (4.4 standard deviations); kept values are x / 0.7, the rest 0; bf16
    stays bf16; training without a generator raises, as JAX's does
    without rng; the mode follows model.train()/eval() by default."""
    drop = tnn.Dropout(0.3)
    x = torch.ones(200, 200)
    y = drop(x, train=True, generator=torch.Generator().manual_seed(0))
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.01
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.7),
                               rtol=0, atol=0)
    yb = drop(x.bfloat16(), train=True,
              generator=torch.Generator().manual_seed(0))
    assert yb.dtype == torch.bfloat16
    assert torch.equal(yb != 0, kept)
    with pytest.raises(ValueError, match="generator"):
        drop(x, train=True)
    drop.train()
    with pytest.raises(ValueError, match="generator"):
        drop(x)
    drop.eval()
    assert drop(x) is x
    with pytest.raises(ValueError):
        tnn.Dropout(1.0)


def test_dropout_inside_sequential_gets_the_generator():
    model = tnn.Sequential(tnn.Linear(8, 8), tnn.Dropout(0.5),
                           tnn.Linear(8, 2))
    x = torch.ones(4, 8)

    def run(seed):
        return model(x, train=True,
                     generator=torch.Generator().manual_seed(seed))

    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))
    model.eval()
    assert torch.equal(model(x), model(x))


def _jax_case(seed, **cfg):
    cfg = dict(CFG, rope=True, **cfg)
    jmodel = jmodels.TinyGPT(**cfg)
    params = jmodel.init(jax.random.PRNGKey(seed))
    model = load_jax_params(TinyGPT(**cfg), jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 32, (2, 16))
    mask = (rng.random((2, 16)) < 0.8).astype(np.float32)
    return jmodel, params, model, (toks, np.roll(toks, -1, 1), mask)


@pytest.mark.parametrize("dropout,train,remat", [
    (0.0, True, False), (0.1, False, False), (0.0, True, True)],
    ids=["p0-train", "p0.1-eval", "p0-remat"])
def test_tinygpt_with_dropout_or_remat_matches_jax(dropout, train, remat):
    """Where no mask is drawn (p = 0, or outside training) the port's
    TinyGPT(dropout=, remat=) gives JAX's loss and gradients."""
    jmodel, params, model, batch = _jax_case(3, dropout=dropout,
                                             remat=remat)
    toks, tgts, mask = (jnp.asarray(a) for a in batch)
    (loss_ref, _), g_ref = jax.value_and_grad(
        lambda p: jmodel.loss(p, toks, tgts, mask, train=train,
                              rng=jax.random.PRNGKey(1)), has_aux=True)(
        params)
    g_ref = dict(_flatten(jax.tree.map(np.asarray, g_ref)))
    loss, _ = model.loss(*(torch.from_numpy(a) for a in batch), train=train,
                         generator=torch.Generator().manual_seed(1))
    loss.backward()
    assert abs(loss.item() - float(loss_ref)) <= 1e-5 * abs(float(loss_ref))
    for k, p in model.named_parameters():
        ref = g_ref[k]
        if np.linalg.norm(ref) > 0:
            rel = np.linalg.norm(p.grad.numpy() - ref) / np.linalg.norm(ref)
            assert rel <= 1e-4, (k, rel)


def _grads(model, batch, seed, **kw):
    model.zero_grad(set_to_none=True)
    loss, _ = model.loss(*batch, train=True,
                         generator=torch.Generator().manual_seed(seed), **kw)
    loss.backward()
    return loss.detach(), {k: p.grad.clone()
                           for k, p in model.named_parameters()
                           if p.grad is not None}


@pytest.mark.parametrize("extra", [{}, dict(n_experts=4)],
                         ids=["mlp", "moe"])
def test_remat_gradients_equal_no_remat_with_dropout(extra):
    """Dropout 0.2 on: remat's recompute draws each block's masks again
    from the seed fixed before the checkpointed call, so its loss and
    gradients equal the plain backward's bit for bit; another generator
    seed gives other masks."""
    model = TinyGPT(**CFG, dropout=0.2, **extra)
    model.reset_parameters(torch.Generator().manual_seed(0))
    toks = torch.randint(0, 32, (2, 16),
                         generator=torch.Generator().manual_seed(1))
    batch = (toks, toks.roll(-1, 1), torch.ones(16))
    loss, grads = _grads(model, batch, 5)
    model.remat = True
    loss_r, grads_r = _grads(model, batch, 5)
    assert torch.equal(loss, loss_r)
    assert grads.keys() == grads_r.keys()
    for k in grads:
        assert torch.equal(grads[k], grads_r[k]), k
    other, _ = _grads(model, batch, 6)
    assert not torch.equal(loss, other)
    model.remat = False
    with torch.no_grad():                   # outside training: no masks
        a, _ = model.loss(*batch)
        b, _ = model.loss(*batch, generator=torch.Generator())
    assert torch.equal(a, b)


def test_block_dropout_raises_without_a_generator_in_training():
    model = TinyGPT(**CFG, dropout=0.1)
    toks = torch.zeros(1, 16, dtype=torch.int64)
    with pytest.raises(ValueError, match="generator"):
        model.loss(toks, toks, torch.ones(16), train=True)


def _dropout_mlp():
    return tnn.Sequential(tnn.Linear(32, 16, activation="relu"),
                          tnn.Dropout(0.3), tnn.Linear(16, 4))


def test_trainer_with_train_uses_rng_trains_a_dropout_model():
    """JAX's test_dropout_model_trains_with_rng: the Trainer hands each
    step its generator, the loss falls; two runs from one seed agree,
    and a model with dropout but no generator raises in training, as
    JAX's Trainer does without train_uses_rng."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((128, 32)).astype(np.float32)
    y = (x[:, :4].argmax(1)).astype(np.int64)
    runs = []
    for _ in range(2):
        tr = Trainer(_dropout_mlp(), optim.Adam(1e-2), device="cpu",
                     train_uses_rng=True)
        before = tr.evaluate(x, y)
        tr.fit_device(x, y, x, y, epochs=2, batch_size=32, verbose=False,
                      early_stop_acc=2.0)
        after = tr.evaluate(x, y)
        assert after["loss"] < before["loss"]
        runs.append(tr.metrics.train_loss)
    assert runs[0] == runs[1]
    tr = Trainer(_dropout_mlp(), optim.Adam(1e-2), device="cpu")
    with pytest.raises(ValueError, match="generator"):
        tr.train_step(torch.from_numpy(x[:8]), torch.from_numpy(y[:8]))


def test_trainer_dropout_streams_come_from_seed_and_counters():
    """fit_device's step i of epoch e and train_epoch's global step n draw
    from generators seeded by (seed, counters) alone: a resumed run sees
    the interrupted run's masks."""
    tr = Trainer(_dropout_mlp(), optim.SGD(0.1), seed=3, device="cpu",
                 train_uses_rng=True)
    g1 = tr._dropout_generator(1, 2)
    g2 = tr._dropout_generator(1, 2)
    assert g1.initial_seed() == g2.initial_seed() == stream_seed(
        3, 0xD809, 1, 2)
    assert tr._dropout_generator(2, 1).initial_seed() != g1.initial_seed()
    assert stream_seed(4, 0xD809, 1, 2) != g1.initial_seed()
    assert Trainer(_dropout_mlp(), optim.SGD(0.1), device="cpu") \
        ._dropout_generator(1) is None
