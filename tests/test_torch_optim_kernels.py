"""The fused optimizer updates (taper_tpu_torch/ops/optim_kernels.py,
K17a/K17b; their plain versions on the CPU) against the JAX package's
Pallas kernels (taper_tpu/ops/pallas/optim_kernels.py, interpreted on the
CPU): the same numpy parameters and gradients (kept away from 0) go
through 5 updates of each, the port's as a list of tensors, JAX's as one
raveled vector.  JAX's masked variant is held against the port leaving the
frozen tensor out of its lists, and a None gradient against JAX's zeros.
Tolerance 1e-6: the same f32 formulas; the port computes the Adam step
size in double, JAX in f32.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taper_tpu.ops.pallas import optim_kernels as J
from taper_tpu_torch import optim
from taper_tpu_torch.ops import optim_kernels as K

TOL = 1e-6
SHAPES = [(6, 5), (5,), (3, 2, 4)]


def _arrays(seed):
    rng = np.random.default_rng(seed)
    out = []
    for shape in SHAPES:
        mag = rng.uniform(0.5, 1.5, shape)
        out.append((mag * rng.choice([-1.0, 1.0], shape)).astype(np.float32))
    return out


def _flat(arrays):
    return np.concatenate([a.reshape(-1) for a in arrays])


ADAM = [dict(lr=3e-3, wd=1e-2, decoupled=False),
        dict(lr=3e-3, wd=0.1, decoupled=True),
        dict(lr=1e-2, wd=0.0, decoupled=False)]
SGD = [dict(lr=0.1, momentum=0.0, wd=0.0),
       dict(lr=0.05, momentum=0.9, wd=1e-2),
       dict(lr=0.05, momentum=0.9, wd=0.0),
       dict(lr=0.1, momentum=0.0, wd=1e-2)]


def _run(alg, hp, frozen=None, no_grad=None, steps=5):
    """5 updates on both sides; tensor ``frozen`` is masked out of JAX's
    update and left out of the port's lists, tensor ``no_grad`` gets a
    zero gradient in JAX and None on the port."""
    params = _arrays(0)
    ps = [torch.from_numpy(a.copy()) for a in params]
    keep = [i for i in range(len(ps)) if i != frozen]
    ms = [torch.zeros_like(ps[i]) for i in keep]
    vs = [torch.zeros_like(ps[i]) for i in keep]
    p = jnp.asarray(_flat(params))
    m, v = jnp.zeros_like(p), jnp.zeros_like(p)
    mask = None
    if frozen is not None:
        mask = jnp.asarray(_flat([np.full(s, 0.0 if i == frozen else 1.0,
                                          np.float32)
                                  for i, s in enumerate(SHAPES)]))
    b1, b2, eps = 0.9, 0.999, 1e-8
    for t in range(1, steps + 1):
        grads = _arrays(t)
        if no_grad is not None:
            grads[no_grad] = np.zeros(SHAPES[no_grad], np.float32)
        g = jnp.asarray(_flat(grads))
        tg = [None if i == no_grad else torch.from_numpy(grads[i])
              for i in keep]
        lr = jnp.asarray(hp["lr"], jnp.float32)
        if alg == "adam":
            p, m, v = J.adam_update_flat(
                p, g, m, v, mask, lr, jnp.asarray(float(t)), b1=b1, b2=b2,
                eps=eps, wd=hp["wd"], decoupled=hp["decoupled"])
            step_size = (hp["lr"] * math.sqrt(1 - b2 ** t)
                         / (1 - b1 ** t))
            K.adam_update([ps[i] for i in keep], tg, ms, vs, lr=hp["lr"],
                          step_size=step_size, b1=b1, b2=b2, eps=eps,
                          wd=hp["wd"], decoupled=hp["decoupled"])
        else:
            p, m = J.sgd_update_flat(p, g, m, mask, lr,
                                     momentum=hp["momentum"], wd=hp["wd"])
            K.sgd_update([ps[i] for i in keep], tg,
                         ms if hp["momentum"] else None, lr=hp["lr"],
                         momentum=hp["momentum"], wd=hp["wd"])
    ref = np.asarray(p)
    out = _flat([t.numpy() for t in ps])
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)
    if frozen is not None:
        np.testing.assert_array_equal(ps[frozen].numpy(), params[frozen])
    if alg == "adam" or hp["momentum"]:
        mref = np.asarray(m)
        sizes = np.cumsum([0] + [math.prod(s) for s in SHAPES])
        for j, i in enumerate(keep):
            np.testing.assert_allclose(ms[j].numpy().reshape(-1),
                                       mref[sizes[i]:sizes[i + 1]],
                                       rtol=TOL, atol=TOL)


@pytest.mark.parametrize("hp", ADAM, ids=["adam_l2", "adamw", "adam"])
def test_adam_matches_the_jax_kernel(hp):
    _run("adam", hp)


@pytest.mark.parametrize("hp", SGD, ids=["sgd", "sgd_momentum_wd",
                                         "sgd_momentum", "sgd_wd"])
def test_sgd_matches_the_jax_kernel(hp):
    _run("sgd", hp)


@pytest.mark.parametrize("alg,hp", [("adam", ADAM[0]), ("adam", ADAM[1]),
                                    ("sgd", SGD[1])],
                         ids=["adam_l2", "adamw", "sgd_momentum_wd"])
def test_masked_kernel_matches_leaving_the_frozen_tensor_out(alg, hp):
    _run(alg, hp, frozen=1)


@pytest.mark.parametrize("alg,hp", [("adam", ADAM[1]), ("sgd", SGD[1])],
                         ids=["adamw", "sgd_momentum_wd"])
def test_a_none_gradient_is_a_zero_gradient(alg, hp):
    _run(alg, hp, no_grad=2)


def test_optimizers_leave_out_parameters_that_need_no_grad():
    """requires_grad=False is the port's mask: such a tensor is not bound
    and never moves, whatever its .grad."""
    w = torch.ones(4, requires_grad=True)
    frozen = torch.ones(4)
    for opt in (optim.SGD(0.1, momentum=0.9, weight_decay=0.1),
                optim.Adam(0.1, weight_decay=0.1),
                optim.AdamW(0.1, weight_decay=0.1)):
        opt.init([w, frozen])
        assert len(opt.params) == 1 and opt.params[0] is w
        frozen.grad = torch.ones(4)
        w.grad = torch.ones(4)
        opt.step()
        assert torch.equal(frozen, torch.ones(4))
    assert not torch.equal(w.detach(), torch.ones(4))


def test_sgd_update_wants_buffers_exactly_with_momentum():
    p = [torch.ones(3)]
    with pytest.raises(ValueError, match="momentum"):
        K.sgd_update(p, [None], None, lr=0.1, momentum=0.9, wd=0.0)
    with pytest.raises(ValueError, match="momentum"):
        K.sgd_update(p, [None], [torch.zeros(3)], lr=0.1, momentum=0.0,
                     wd=0.0)
