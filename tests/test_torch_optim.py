"""Optimizers and LR schedulers (taper_tpu_torch/optim.py) against the JAX
package's (taper_tpu/optim.py): the same numpy parameters and gradients
(kept away from 0) go through 5 updates of each, and the schedulers
through the same epochs and metrics.  Tolerance 1e-6: the same f32
formulas, with the Adam step size computed in double on the port's side.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taper_tpu import optim as jopt
from taper_tpu_torch import optim

TOL = 1e-6
SHAPES = {"w": (6, 5), "b": (5,)}


def _arrays(seed):
    rng = np.random.default_rng(seed)
    out = {}
    for k, shape in SHAPES.items():
        mag = rng.uniform(0.5, 1.5, shape)
        out[k] = (mag * rng.choice([-1.0, 1.0], shape)).astype(np.float32)
    return out


@pytest.mark.parametrize("make", [
    lambda m: m.SGD(0.1),
    lambda m: m.SGD(0.05, momentum=0.9, weight_decay=1e-2),
    lambda m: m.Adam(3e-3, weight_decay=1e-4),
    lambda m: m.Adam(1e-2, betas=(0.8, 0.99), eps=1e-6),
    lambda m: m.AdamW(3e-3, weight_decay=0.1),
], ids=["sgd", "sgd_momentum_wd", "adam_wd", "adam_betas", "adamw"])
def test_optimizer_matches_jax_over_five_steps(make):
    params = _arrays(0)
    jo = make(jopt)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = jo.init(jp)
    po = make(optim)
    tp = {k: torch.from_numpy(v.copy()).requires_grad_()
          for k, v in params.items()}
    po.init(tp.values())
    for step in range(5):
        grads = _arrays(step + 1)
        jp, state = jo.update({k: jnp.asarray(v) for k, v in grads.items()},
                              state, jp)
        for k, p in tp.items():
            p.grad = torch.from_numpy(grads[k])
        po.step()
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=TOL, atol=TOL)


def test_optimizer_lr_is_a_field_and_step_needs_grads():
    """A parameter without a gradient steps on a zero one, as JAX's
    unused leaf does: plain SGD leaves it, L2 decay still moves it."""
    p = torch.ones(3, requires_grad=True)
    opt = optim.SGD(0.5).init([p])
    opt.lr = 0.25
    p.grad = torch.ones(3)
    opt.step()
    assert torch.equal(p, torch.full((3,), 0.75))
    opt.zero_grad()
    assert p.grad is None
    opt.step()
    assert torch.equal(p, torch.full((3,), 0.75))
    q = torch.ones(3, requires_grad=True)
    optim.SGD(0.5, weight_decay=0.1).init([q]).step()
    torch.testing.assert_close(q, torch.full((3,), 0.95))


def test_adam_steps_an_unused_leaf_as_jax_does():
    """A rope TinyGPT builds its position table and never reads it: the
    port's backward leaves its .grad None, JAX's value_and_grad gives it
    zeros.  Two Adam steps with L2 decay from the same JAX tree and the
    same gradients (JAX's, so that the update is compared, not the
    gradient) move every leaf alike, pos.w included."""
    import jax

    from taper_tpu import models as jmodels
    from taper_tpu_torch.models import TinyGPT
    from taper_tpu_torch.utils.convert import _flatten, load_jax_params

    cfg = dict(vocab_size=16, dim=32, depth=1, num_heads=2, max_seq=8,
               rope=True)
    jmodel = jmodels.TinyGPT(**cfg)
    jp = jmodel.init(jax.random.PRNGKey(0))
    model = load_jax_params(TinyGPT(**cfg), jax.tree.map(np.asarray, jp))
    jo, po = jopt.Adam(1e-3, weight_decay=1e-2), optim.Adam(
        1e-3, weight_decay=1e-2)
    state = jo.init(jp)
    po.init(model.parameters())
    rng = np.random.default_rng(1)
    for _ in range(2):
        toks = rng.integers(0, 16, (2, 8))
        tgts, mask = np.roll(toks, -1, 1), np.ones(8, np.float32)
        grads = jax.grad(lambda p: jmodel.loss(
            p, jnp.asarray(toks), jnp.asarray(tgts), jnp.asarray(mask))[0])(jp)
        jp, state = jo.update(grads, state, jp)
        po.zero_grad()
        model.loss(*map(torch.from_numpy, (toks, tgts, mask)))[0].backward()
        assert model.pos.w.grad is None
        flat = dict(_flatten(jax.tree.map(np.asarray, grads)))
        for k, p in model.named_parameters():
            if p.grad is not None:
                p.grad = torch.from_numpy(flat[k].copy())
        po.step()
    ref = dict(_flatten(jax.tree.map(np.asarray, jp)))
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[k], rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    assert not np.array_equal(ref["pos.w"], np.asarray(
        jmodel.init(jax.random.PRNGKey(0))["pos"]["w"]))


@pytest.mark.parametrize("make", [
    lambda m: m.StepLR(3e-3, 5, 0.8),
    lambda m: m.ExponentialLR(0.1, 0.9),
    lambda m: m.CosineAnnealingLR(0.1, 7, min_lr=1e-3),
    lambda m: m.ReduceLROnPlateau(0.1, factor=0.5, patience=1),
    lambda m: m.ReduceLROnPlateau(0.1, mode="max", patience=0),
], ids=["step", "exponential", "cosine", "plateau_min", "plateau_max"])
def test_scheduler_matches_jax(make):
    metrics = [1.0, 0.9, 0.95, 0.97, 0.8, 0.8, 0.81, 0.5, 0.6, 0.6, 0.6,
               0.4]
    js, ps = make(jopt), make(optim)
    for m in metrics:
        assert ps.step(m) == pytest.approx(js.step(m), rel=1e-12)
    ps.reset()
    js.reset()
    assert ps.get_lr() == js.get_lr() and ps.epoch == 0
