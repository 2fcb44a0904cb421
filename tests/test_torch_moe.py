"""The mixture-of-experts FFN (taper_tpu_torch/nn/transformer.py
``MoEMLP``, ``moe_capacity``, ``moe_sparse_routing``,
``moe_sparse_dispatch``) and TinyGPT with MoE blocks against the JAX
package's (taper_tpu/nn/transformer.py:891-1058), the weights drawn by JAX
and carried across by ``load_jax_params`` (the stacked ``gate`` and
``experts.*`` leaves under the same names).

``torch.topk`` does not promise ``jax.lax.top_k``'s lower-index choice on
tied gate logits, so every input here is a continuous draw, and each test
checks that no token's k-th and (k+1)-th gate logits tie.  Tolerances:
outputs and gradients in f32 to 1e-5 relative (1e-6 absolute for entries
near 0): the same f32 arithmetic in other summation orders.  The routing
decisions (experts, positions, kept slots) exactly.  Sparse with nothing
dropped against dense, within the port: 1e-5 (the same products, summed
in another order).  The model's loss to 1e-5 and each gradient to 1e-4
relative L2, as tests/test_torch_lm.py holds the dense FFN.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taper_tpu import models as jmodels
from taper_tpu.nn import transformer as JT
from taper_tpu_torch.models import TinyGPT
from taper_tpu_torch.nn import transformer as T
from taper_tpu_torch.utils.convert import _flatten, load_jax_params

torch.set_num_threads(1)

TOL, ATOL = 1e-5, 1e-6
DIM, N_EXP = 16, 4


def _no_ties(gate, x2, k):
    logits = np.asarray(x2, np.float64) @ np.asarray(gate, np.float64).T
    srt = np.sort(logits, axis=1)[:, ::-1]
    if k < logits.shape[1]:
        assert np.min(srt[:, k - 1] - srt[:, k]) > 1e-5, "tied gate logits"


def _moe_case(seed, top_k, capacity_factor, b=2, s=8):
    jm = JT.MoEMLP(DIM, N_EXP, ratio=2, top_k=top_k,
                   capacity_factor=capacity_factor)
    params = jm.init(jax.random.PRNGKey(seed))
    pm = T.MoEMLP(DIM, N_EXP, ratio=2, top_k=top_k,
                  capacity_factor=capacity_factor)
    load_jax_params(pm, jax.tree.map(np.asarray, params))
    x = np.random.default_rng(seed).standard_normal(
        (b, s, DIM)).astype(np.float32)
    _no_ties(params["gate"], x.reshape(-1, DIM), top_k)
    return jm, params, pm, x


def _jax_out_and_grads(jm, params, x, cot):
    def f(p, xx):
        y = jm.apply(p, xx)
        return jnp.sum(y * cot), y

    (_, y), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    return np.asarray(y), np.asarray(gx), dict(
        _flatten(jax.tree.map(np.asarray, gp)))


def _port_out_and_grads(pm, x, cot):
    xt = torch.from_numpy(x).requires_grad_()
    y = pm(xt)
    (y * torch.from_numpy(cot)).sum().backward()
    return (y.detach().numpy(), xt.grad.numpy(),
            {k: p.grad.numpy() for k, p in pm.named_parameters()})


@pytest.mark.parametrize("top_k,cf", [(2, None), (1, None), (2, 0.5),
                                      (1, 0.75), (2, 4.0)],
                         ids=["dense-k2", "dense-k1", "sparse-k2-drops",
                              "sparse-k1-drops", "sparse-k2-all"])
def test_moe_matches_jax(top_k, cf):
    """Dense mode, and sparse at capacities that drop slots (C = 4 and 3
    of 32 tokens' 64 and 32 slots over 4 experts) and that drop none."""
    jm, params, pm, x = _moe_case(top_k * 10 + int(4 * (cf or 0)), top_k,
                                  cf)
    cot = np.random.default_rng(99).standard_normal(x.shape).astype(
        np.float32)
    y_ref, gx_ref, gp_ref = _jax_out_and_grads(jm, params, x, cot)
    y, gx, gp = _port_out_and_grads(pm, x, cot)
    np.testing.assert_allclose(y, y_ref, rtol=TOL, atol=ATOL)
    np.testing.assert_allclose(gx, gx_ref, rtol=TOL, atol=ATOL)
    assert gp.keys() == gp_ref.keys()
    for k in gp_ref:
        np.testing.assert_allclose(gp[k], gp_ref[k], rtol=TOL, atol=ATOL,
                                   err_msg=k)


def test_sparse_routing_matches_jax_and_drops():
    """moe_capacity and moe_sparse_routing's decisions, exactly: experts,
    exclusive running positions in token order, kept slots; the gate
    weights to 1e-5.  At C = 4 some slots drop."""
    _, params, pm, x = _moe_case(3, 2, 0.5)
    x2 = x.reshape(-1, DIM)
    t = x2.shape[0]
    cap = T.moe_capacity(t, N_EXP, 2, 0.5)
    assert cap == JT.moe_capacity(t, N_EXP, 2, 0.5) == 4
    assert T.moe_capacity(t, N_EXP, 2, 100.0) == t
    ref = JT.moe_sparse_routing(params["gate"], jnp.asarray(x2), N_EXP, 2,
                                cap)
    out = T.moe_sparse_routing(pm.gate, torch.from_numpy(x2), N_EXP, 2, cap)
    np.testing.assert_allclose(out[0].detach().numpy(), np.asarray(ref[0]),
                               rtol=TOL)
    for a, b in zip(out[1:], ref[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert not out[3].all()                    # slots dropped


def test_sparse_with_nothing_dropped_equals_dense():
    """At a capacity of every token, sparse dispatch computes what dense
    mode does (JAX's oracle property), outputs and gradients."""
    torch.manual_seed(0)
    dense = T.MoEMLP(DIM, N_EXP, ratio=2, top_k=2)
    dense.reset_parameters(torch.Generator().manual_seed(4))
    sparse = T.MoEMLP(DIM, N_EXP, ratio=2, top_k=2, capacity_factor=4.0)
    sparse.load_state_dict(dense.state_dict())
    x = np.random.default_rng(4).standard_normal((2, 8, DIM)).astype(
        np.float32)
    _no_ties(dense.gate.detach().numpy(), x.reshape(-1, DIM), 2)
    cot = np.random.default_rng(5).standard_normal(x.shape).astype(
        np.float32)
    for a, b in zip(_port_out_and_grads(dense, x, cot)[:2],
                    _port_out_and_grads(sparse, x, cot)[:2]):
        np.testing.assert_allclose(b, a, rtol=TOL, atol=ATOL)


def test_dispatch_keeps_the_trash_row_out():
    """Every dropped slot writes the one trash row past the buffers; no
    result reads it: a token whose slots all drop gets exactly 0."""
    x2 = torch.randn(4, DIM, generator=torch.Generator().manual_seed(1))
    expert = torch.tensor([0, 0, 0, 0])           # k = 1, one expert
    pos = torch.tensor([0, 1, 2, 3])
    keep = pos < 2
    w = torch.ones(4, 1)
    ident = [(None,)]
    y = T.moe_sparse_dispatch(x2, expert, pos, keep, w, 2, 1, 0,
                              lambda rows, _: rows * 2.0, ident)
    torch.testing.assert_close(y[:2], 2.0 * x2[:2])
    assert not y[2:].any()


def _lm_case(seed, **cfg):
    cfg = dict(vocab_size=32, dim=32, depth=2, num_heads=2, max_seq=16,
               n_experts=N_EXP, **cfg)
    jmodel = jmodels.TinyGPT(**cfg)
    params = jmodel.init(jax.random.PRNGKey(seed))
    model = load_jax_params(TinyGPT(**cfg), jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 32, (2, 16))
    return jmodel, params, model, (toks, np.roll(toks, -1, 1),
                                   np.ones((2, 16), np.float32))


@pytest.mark.parametrize("cf", [None, 0.75], ids=["dense", "sparse"])
def test_tinygpt_moe_matches_jax(cf):
    jmodel, params, model, batch = _lm_case(7, capacity_factor=cf,
                                            rope=True)
    assert {k for k, _ in model.named_parameters()} >= {
        "blocks.0.mlp.gate", "blocks.0.mlp.experts.w1",
        "blocks.1.mlp.experts.b2"}
    toks, tgts, mask = (jnp.asarray(a) for a in batch)
    (loss_ref, _), g_ref = jax.value_and_grad(
        lambda p: jmodel.loss(p, toks, tgts, mask), has_aux=True)(params)
    g_ref = dict(_flatten(jax.tree.map(np.asarray, g_ref)))
    loss, _ = model.loss(*(torch.from_numpy(a) for a in batch))
    loss.backward()
    assert abs(loss.item() - float(loss_ref)) <= TOL * abs(float(loss_ref))
    for k, p in model.named_parameters():
        ref = g_ref[k]
        if np.linalg.norm(ref) > 0:
            rel = np.linalg.norm(p.grad.numpy() - ref) / np.linalg.norm(ref)
            assert rel <= 1e-4, (k, rel)
