"""Mixed-precision policies and loss scaling (taper_tpu_torch/utils/amp.py)
against the JAX package's (taper_tpu/utils/amp.py).

The policies' dtypes and casts, ``all_finite``, the static scale, and
``DynamicLossScale``'s transitions over a sequence of finite and planted
non-finite gradients are compared exactly (the same decisions on the same
powers of two).  ``scaled_grad_step`` on the same f16 model: the unscaled
gradients to 1e-3 relative (f16 keeps 11 bits, and the two packages round
the f16 products in other orders), the finiteness decision and the new
scale exactly; ``apply_if_finite`` holds the parameters and the
optimizer's state on a non-finite gradient, bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taper_tpu.utils import amp as jamp
from taper_tpu_torch import optim
from taper_tpu_torch.utils import amp

JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
              torch.float16: jnp.float16, torch.float64: jnp.float64}


@pytest.mark.parametrize("spec", [
    "params=float32,compute=bfloat16,output=float32", "p=f32,c=f16,o=bf16",
    "c=bf16", ""])
def test_policy_from_string_matches_jax(spec):
    p, j = amp.Policy.from_string(spec), jamp.Policy.from_string(spec)
    assert [JAX_DTYPES[d] for d in p] == list(j)


def test_tpu_bf16_policy_and_casts():
    pol = amp.tpu_bf16_policy()
    assert tuple(pol) == (torch.float32, torch.bfloat16, torch.float32)
    assert list(jamp.tpu_bf16_policy()) == [JAX_DTYPES[d] for d in pol]
    tree = {"w": torch.ones(2), "n": [torch.arange(3), (torch.ones(1),)],
            "k": 7}
    out = pol.cast_to_compute(tree)
    assert out["w"].dtype == torch.bfloat16
    assert out["n"][0].dtype == torch.int64           # integers pass
    assert out["n"][1][0].dtype == torch.bfloat16 and out["k"] == 7
    assert pol.cast_to_output(out)["w"].dtype == torch.float32
    assert pol.cast_to_param(out)["n"][1][0].dtype == torch.float32


def test_all_finite_matches_jax():
    cases = [[np.ones(3, np.float32), np.arange(2)],
             [np.array([1.0, np.inf], np.float32)],
             [np.array([np.nan], np.float32), np.ones(2, np.float32)],
             [np.arange(3)]]
    for leaves in cases:
        want = bool(jamp.all_finite([jnp.asarray(a) for a in leaves]))
        got = amp.all_finite([torch.from_numpy(a) for a in leaves])
        assert got.dtype == torch.bool and bool(got) == want


def test_static_scale_scales_and_unscales():
    ls = amp.StaticLossScale(1024.0)
    st = ls.init()
    assert float(ls.scale_loss(torch.tensor(0.5), st)) == 512.0
    g = ls.unscale([torch.full((2,), 2048.0, dtype=torch.float16),
                    torch.arange(2)], st)
    assert g[0].dtype == torch.float16 and g[0].tolist() == [2.0, 2.0]
    assert g[1].tolist() == [0, 1]
    assert ls.adjust(st, False) is st


def test_dynamic_scale_transitions_match_jax():
    """Halve on overflow (not below 1), double after growth_interval
    finite steps in a row (not above max_scale), the count reset on
    either: the same states as JAX's over a planted sequence."""
    kw = dict(initial=8.0, factor=2.0, growth_interval=3, max_scale=32.0)
    ls, jls = amp.DynamicLossScale(**kw), jamp.DynamicLossScale(**kw)
    st, jst = ls.init(), jls.init()
    seq = [True] * 7 + [False] * 6 + [True, True, False, True, True, True]
    for fin in seq:
        st, jst = ls.adjust(st, fin), jls.adjust(jst, jnp.asarray(fin))
        assert float(st.scale) == float(jst.scale)
        assert int(st.good_steps) == int(jst.good_steps)
        assert st.scale.dtype == torch.float32
        assert st.good_steps.dtype == torch.int32


def _f16_case():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((4, 3)).astype(np.float16)
    x = rng.standard_normal((5, 4)).astype(np.float16)
    return w, x


@pytest.mark.parametrize("plant", [False, True], ids=["finite", "inf"])
def test_scaled_grad_step_and_apply_if_finite(plant):
    """One scaled f16 step as JAX takes it; with an inf planted in the
    input the gradients are non-finite, the scale halves and
    apply_if_finite leaves the parameters and the Adam moments as they
    were."""
    w, x = _f16_case()
    if plant:
        x[0, 0] = np.inf
    ls, jls = amp.DynamicLossScale(1024.0), jamp.DynamicLossScale(1024.0)

    def jloss(p, xx):
        return jnp.mean((xx @ p).astype(jnp.float32) ** 2)

    jg, jl, _, jfin, jst = jamp.scaled_grad_step(
        jloss, jnp.asarray(w), jls, jls.init(), jnp.asarray(x))
    tw = torch.from_numpy(w).float().requires_grad_()
    xt = torch.from_numpy(x)

    def loss(xx):
        return ((xx @ tw.half()).float() ** 2).mean()

    g, l, _, fin, st = amp.scaled_grad_step(loss, [tw], ls, ls.init(), xt)
    opt = optim.Adam(1e-2).init([tw])
    tw.grad = torch.ones_like(tw)
    opt.step()                                    # some state to hold
    before = (tw.detach().clone(), opt.m[0].clone(), opt.v[0].clone(),
              opt.t)
    assert bool(fin) == bool(jfin) == (not plant)
    assert float(st.scale) == float(jst.scale)
    assert int(st.good_steps) == int(jst.good_steps)
    stepped = amp.apply_if_finite(opt, g, fin)
    assert stepped == (not plant)
    if plant:
        assert torch.equal(tw.detach(), before[0])
        assert torch.equal(opt.m[0], before[1])
        assert torch.equal(opt.v[0], before[2]) and opt.t == before[3]
    else:
        np.testing.assert_allclose(float(l), float(jl), rtol=1e-3)
        np.testing.assert_allclose(g[0].numpy(),
                                   np.asarray(jg).astype(np.float32),
                                   rtol=1e-3, atol=1e-4)
        assert not torch.equal(tw.detach(), before[0])
