"""The vocab-chunked fused loss and the smoothed cross-entropy
(taper_tpu_torch/losses.py) against the JAX package's
(taper_tpu/losses.py), and ``TinyGPT.loss``'s fused branch against JAX's
and against the port's own naive branch.

Inputs come from numpy seeds; JAX runs on the CPU.  Tolerances: the fused
loss in f32 to 1e-5 relative (the same f32 arithmetic on both sides, in
other summation orders), with an absolute floor of 1e-6 for gradient
entries that cancel to ~0; the argmax exactly (the inputs are continuous
draws, so no two logits of a row tie).  With bf16 ``x`` both sides upcast
it exactly and compute in f32, then round dx to bf16: one bf16 ulp,
2^-8 relative.  The model's loss to 1e-5 and each gradient to 1e-4
relative L2, as tests/test_torch_lm.py holds the naive branch; the
port's fused branch against its naive branch to 1e-6 (the same model, the
loss reduced in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taper_tpu import losses as jlosses
from taper_tpu import models as jmodels
from taper_tpu_torch import losses
from taper_tpu_torch.models import TinyGPT
from taper_tpu_torch.models import transformer as T
from taper_tpu_torch.utils.convert import _flatten, load_jax_params

torch.set_num_threads(1)

TOL, ATOL = 1e-5, 1e-6
N, D, V = 24, 16, 50


def _inputs(seed, v=V):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, D)).astype(np.float32)
    head = (rng.standard_normal((v, D)) * 0.5).astype(np.float32)
    tgt = rng.integers(0, v, N)
    w = rng.uniform(0.5, 1.5, N).astype(np.float32)    # nll's cotangent
    wl = rng.uniform(-1.0, 1.0, N).astype(np.float32)  # lse's cotangent
    return x, head, tgt, w, wl


def _jax_fused(x, head, tgt, w, wl, chunk, with_lse):
    def f(xx, hh):
        nll, pred, lse = jlosses.fused_linear_cross_entropy(
            xx, hh, jnp.asarray(tgt), chunk=chunk, return_lse=True)
        out = jnp.sum(nll * w) + (jnp.sum(lse * wl) if with_lse else 0.0)
        return out, (nll, pred, lse)

    (_, (nll, pred, lse)), (dx, dh) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(jnp.asarray(x), jnp.asarray(head))
    return [np.asarray(a) for a in (nll, pred, lse, dx, dh)]


def _port_fused(x, head, tgt, w, wl, chunk, with_lse, x_dtype=None):
    xt = torch.from_numpy(x)
    if x_dtype is not None:
        xt = xt.to(x_dtype)
    xt.requires_grad_()
    ht = torch.from_numpy(head).requires_grad_()
    nll, pred, lse = losses.fused_linear_cross_entropy(
        xt, ht, torch.from_numpy(tgt), chunk=chunk, return_lse=True)
    out = (nll * torch.from_numpy(w)).sum()
    if with_lse:
        out = out + (lse * torch.from_numpy(wl)).sum()
    out.backward()
    return (nll.detach().numpy(), pred.numpy(), lse.detach().numpy(),
            xt.grad.float().numpy(), ht.grad.numpy())


@pytest.mark.parametrize("chunk", [16, 7, 64], ids=["c16", "c7", "c64"])
@pytest.mark.parametrize("with_lse", [False, True], ids=["nll", "nll+lse"])
def test_fused_ce_matches_jax(chunk, with_lse):
    """V = 50 is no multiple of 16 or 7 (padded rows masked), and a chunk
    of 64 holds the whole vocab in one padded chunk."""
    args = _inputs(chunk + 7 * with_lse)
    ref = _jax_fused(*args, chunk, with_lse)
    out = _port_fused(*args, chunk, with_lse)
    for name, a, b in zip(("nll", "pred", "lse", "dx", "dhead"), out, ref):
        if name == "pred":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=TOL, atol=ATOL,
                                       err_msg=name)


def test_fused_ce_without_lse_return_and_ties_take_the_first_chunk():
    """``return_lse=False`` gives ``(nll, pred)``; a row whose maximum
    sits in two chunks predicts the earlier one, as JAX's strict ``>``
    keeps it (and within a chunk the first index)."""
    x = torch.ones(2, 4)
    head = torch.zeros(10, 4)
    head[[3, 8]] = 1.0                 # rows 3 and 8 tie, in chunks 0 and 1
    out = losses.fused_linear_cross_entropy(x, head, torch.tensor([3, 8]),
                                            chunk=5)
    assert len(out) == 2
    assert out[1].tolist() == [3, 3]
    ref = jlosses.fused_linear_cross_entropy(
        jnp.ones((2, 4)), jnp.asarray(head.numpy()), jnp.asarray([3, 8]),
        chunk=5)
    assert np.asarray(ref[1]).tolist() == [3, 3]
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), rtol=TOL)


def test_fused_ce_bf16_activations_match_jax():
    """bf16 x against an f32 head: both packages promote the product to
    f32; dx comes back in bf16."""
    x, head, tgt, w, wl = _inputs(3)
    xb = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    ref = _jax_fused(jnp.asarray(xb, jnp.bfloat16), head, tgt, w, wl, 16,
                     True)
    out = _port_fused(xb, head, tgt, w, wl, 16, True,
                      x_dtype=torch.bfloat16)
    for name, a, b in zip(("nll", "pred", "lse", "dx", "dhead"), out, ref):
        if name == "pred":
            np.testing.assert_array_equal(a, b)
        elif name == "dx":
            np.testing.assert_allclose(a, b.astype(np.float32),
                                       rtol=2 ** -8, atol=1e-5)
        else:
            np.testing.assert_allclose(a, b, rtol=TOL, atol=ATOL,
                                       err_msg=name)


@pytest.mark.parametrize("smoothing", [0.0, 0.1, 0.3])
def test_smoothed_ce_matches_jax(smoothing):
    rng = np.random.default_rng(11)
    logits = rng.standard_normal((16, 12)).astype(np.float32) * 3
    y = rng.integers(0, 12, 16)
    lt = torch.from_numpy(logits).requires_grad_()
    loss = losses.cross_entropy_loss_smoothed(lt, torch.from_numpy(y),
                                              smoothing)
    loss.backward()
    ref, gref = jax.value_and_grad(
        lambda z: jlosses.cross_entropy_loss_smoothed(
            z, jnp.asarray(y), smoothing))(jnp.asarray(logits))
    np.testing.assert_allclose(loss.item(), float(ref), rtol=TOL)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(gref), rtol=TOL,
                               atol=ATOL)
    if smoothing == 0.0:
        plain = losses.cross_entropy_loss(lt, torch.from_numpy(y))
        np.testing.assert_allclose(loss.item(), plain.item(), rtol=1e-6)


def _lm_case(seed, **cfg):
    cfg = dict(vocab_size=37, dim=32, depth=2, num_heads=2, max_seq=16,
               **cfg)
    jmodel = jmodels.TinyGPT(**cfg)
    params = jmodel.init(jax.random.PRNGKey(seed))
    model = load_jax_params(TinyGPT(**cfg), jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg["vocab_size"], (2, 16))
    mask = (rng.random((2, 16)) < 0.8).astype(np.float32)
    return jmodel, params, model, (toks, np.roll(toks, -1, 1), mask)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_tinygpt_fused_branch_matches_jax_and_naive(tied):
    """An explicit chunk of 8 over a vocab of 37 (5 chunks, the last
    padded) with z-loss, through JAX's fused branch and the port's."""
    jmodel, params, model, batch = _lm_case(5 + tied, tied_head=tied,
                                            rope=True)
    toks, tgts, mask = batch

    def jloss(p):
        return jmodel.loss(p, jnp.asarray(toks), jnp.asarray(tgts),
                           jnp.asarray(mask), chunk=8, z_loss=1e-2)

    (loss_ref, acc_ref), g_ref = jax.value_and_grad(jloss, has_aux=True)(
        params)
    g_ref = dict(_flatten(jax.tree.map(np.asarray, g_ref)))
    tt = [torch.from_numpy(a) for a in batch]
    results = {}
    for chunk in (8, 0):
        model.zero_grad(set_to_none=True)
        loss, acc = model.loss(*tt, chunk=chunk, z_loss=1e-2)
        loss.backward()
        results[chunk] = (loss.item(), acc.item(), {
            k: (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
            for k, p in model.named_parameters()})
    loss, acc, grads = results[8]
    assert abs(loss - float(loss_ref)) <= TOL * abs(float(loss_ref))
    assert abs(acc - float(acc_ref)) <= 1.0 / mask.sum()
    for k, ref in g_ref.items():
        if np.linalg.norm(ref) > 0:
            assert _rel_l2(grads[k], ref) <= 1e-4, k
    naive_loss, naive_acc, naive_grads = results[0]
    assert abs(loss - naive_loss) <= 1e-6 * abs(naive_loss)
    assert acc == naive_acc
    for k in grads:
        if np.linalg.norm(naive_grads[k]) > 0:
            assert _rel_l2(grads[k], naive_grads[k]) <= 1e-5, k


def test_loss_branch_rule(monkeypatch):
    """JAX's rule: chunk=None is naive up to B*S*V = NAIVE_LOSS_MAX logits
    and fused beyond (the fused call gets FUSED_CHUNK rows a chunk); an
    explicit chunk forces fused; chunk=0 forces naive."""
    calls = []
    real = T.fused_linear_cross_entropy

    def spy(*args, **kw):
        calls.append(kw["chunk"])
        return real(*args, **kw)

    monkeypatch.setattr(T, "fused_linear_cross_entropy", spy)
    model = TinyGPT(vocab_size=37, dim=32, depth=1, num_heads=2, max_seq=16)
    toks = torch.zeros(2, 16, dtype=torch.int64)
    mask = torch.ones(16)
    monkeypatch.setattr(T, "NAIVE_LOSS_MAX", 2 * 16 * 37)
    model.loss(toks, toks, mask)
    assert calls == []
    monkeypatch.setattr(T, "NAIVE_LOSS_MAX", 2 * 16 * 37 - 1)
    model.loss(toks, toks, mask)
    model.loss(toks, toks, mask, chunk=0)
    model.loss(toks, toks, mask, chunk=9)
    assert calls == [T.FUSED_CHUNK, 9]
