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
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    po.init(tp.values())
    for step in range(5):
        grads = _arrays(step + 1)
        jp, state = jo.update({k: jnp.asarray(v) for k, v in grads.items()},
                              state, jp)
        for k, p in tp.items():
            p.grad = torch.from_numpy(grads[k])
        po.step()
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=TOL, atol=TOL)


def test_optimizer_lr_is_a_field_and_step_needs_grads():
    p = torch.ones(3)
    opt = optim.SGD(0.5).init([p])
    opt.lr = 0.25
    p.grad = torch.ones(3)
    opt.step()
    assert torch.equal(p, torch.full((3,), 0.75))
    opt.zero_grad()
    assert p.grad is None
    with pytest.raises(RuntimeError, match="gradient"):
        opt.step()


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
