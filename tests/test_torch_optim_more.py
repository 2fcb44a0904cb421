"""Adafactor, Lion, Muon with ``newton_schulz_orthogonalize``,
``WarmupCosineLR``, ``clip_grad_norm``, ``accumulate_gradients`` and
``EMA`` (taper_tpu_torch/optim.py) against the JAX package's
(taper_tpu/optim.py:267-775), on the same numpy parameters and gradients,
and a resumed Trainer bit-equal for each new optimizer's state.

The parameter tree has ``tok``/``pos`` leaves (Muon leaves them to its
Adam), an attention matrix and bias, and a rank-3 stacked MoE weight
(Muon flattens it to ``[experts, rest]``, as JAX does).  Tolerance 1e-5
relative (1e-6 absolute) after five steps: the same f32 formulas, with
the step sizes and schedules computed in double on the port's side and
Newton-Schulz's matrix products summed in other orders.  Resumed runs are
compared bit for bit (the same arithmetic in the same order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taper_tpu import optim as jopt
from taper_tpu_torch import optim
from taper_tpu_torch.models import mnist_mlp
from taper_tpu_torch.train import Trainer
from taper_tpu_torch.utils import checkpoint as ckpt
from taper_tpu_torch.utils.convert import _flatten

torch.set_num_threads(1)

TOL, ATOL = 1e-5, 1e-6
TREE = {"tok": {"w": (10, 6)}, "pos": {"w": (8, 6)},
        "blocks": [{"attn": {"wq": (6, 6), "bq": (6,)},
                    "mlp": {"experts": {"w1": (3, 8, 6)}}}]}


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)

    def leaf(shape):
        mag = rng.uniform(0.5, 1.5, shape)
        return (scale * mag * rng.choice([-1.0, 1.0], shape)).astype(
            np.float32)
    return jax.tree.map(leaf, TREE, is_leaf=lambda x: isinstance(x, tuple))


def _run_both(make, steps=5, grad_scale=1.0):
    params = _tree(0)
    jo = make(jopt)
    jp = jax.tree.map(jnp.asarray, params)
    state = jo.init(jp)
    po = make(optim)
    named = {k: torch.from_numpy(np.array(v)).requires_grad_()
             for k, v in _flatten(params)}
    po.init(named.items())
    for step in range(steps):
        grads = _tree(step + 1, grad_scale)
        jp, state = jo.update(jax.tree.map(jnp.asarray, grads), state, jp)
        for k, g in _flatten(grads):
            named[k].grad = torch.from_numpy(np.array(g))
        po.step()
    return dict(_flatten(jax.tree.map(np.asarray, jp))), named, state, po


@pytest.mark.parametrize("make", [
    lambda m: m.Adafactor(),
    lambda m: m.Adafactor(0.01, beta1=0.9, weight_decay=0.1,
                          relative_step=False, clip_threshold=0.5),
    lambda m: m.Lion(3e-3, weight_decay=0.1),
    lambda m: m.Lion(1e-2, betas=(0.8, 0.9)),
    lambda m: m.Muon(0.02, weight_decay=0.05),
    lambda m: m.Muon(0.05, nesterov=False, ns_steps=3, adam_lr=1e-3),
], ids=["adafactor", "adafactor_m_wd", "lion_wd", "lion_betas", "muon_wd",
        "muon_plain"])
def test_optimizer_matches_jax_over_five_steps(make):
    ref, got, state, po = _run_both(make)
    for k, p in got.items():
        np.testing.assert_allclose(p.detach().numpy(), ref[k], rtol=TOL,
                                   atol=ATOL, err_msg=k)
    # the state under JAX's slot names, at JAX's values
    tree = po.state_tree(list(got))
    for slot in ("m", "v"):
        if slot not in state:
            continue
        want = dict(_flatten(jax.tree.map(np.asarray, state[slot])))
        have = dict(ckpt.flatten(tree[slot], sep="."))
        assert want.keys() == have.keys(), slot
        for k in want:
            np.testing.assert_allclose(have[k].numpy(), want[k], rtol=TOL,
                                       atol=ATOL, err_msg=f"{slot} {k}")


def test_muon_needs_names_and_splits_by_them():
    """Matrices outside tok/pos/emb take Newton-Schulz (v a 0-d
    placeholder); the rest the internal Adam (v full).  Bare tensors
    raise."""
    _, got, _, po = _run_both(lambda m: m.Muon(), steps=1)
    shapes = {n: tuple(v.shape) for n, v in zip(po.names, po.v)}
    assert shapes["tok.w"] == (10, 6) and shapes["blocks.0.attn.bq"] == (6,)
    assert shapes["blocks.0.attn.wq"] == ()
    assert shapes["blocks.0.mlp.experts.w1"] == ()
    with pytest.raises(ValueError, match="named_parameters"):
        optim.Muon().init([torch.zeros(2, 2, requires_grad=True)])


@pytest.mark.parametrize("shape", [(6, 10), (12, 5), (3, 48)])
def test_newton_schulz_matches_jax(shape):
    x = np.random.default_rng(shape[0]).standard_normal(shape).astype(
        np.float32)
    ref = jopt.newton_schulz_orthogonalize(jnp.asarray(x))
    out = optim.newton_schulz_orthogonalize(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL,
                               atol=ATOL)


@pytest.mark.parametrize("args", [(1e-3, 20, 5), (1e-3, 20, 0, 1e-5),
                                  (0.1, 7, 6)])
def test_warmup_cosine_matches_jax(args):
    js, ps = jopt.WarmupCosineLR(*args), optim.WarmupCosineLR(*args)
    got = [ps.step() for _ in range(args[1] + 3)]
    want = [js.step() for _ in range(args[1] + 3)]
    np.testing.assert_allclose(got, want, rtol=1e-12)
    np.testing.assert_allclose(ps.schedule_array().numpy(),
                               np.asarray(js.schedule_array()), rtol=1e-7)
    with pytest.raises(ValueError):
        optim.WarmupCosineLR(1e-3, 5, 5)


@pytest.mark.parametrize("max_norm", [1.0, 1e3], ids=["clips", "keeps"])
def test_clip_grad_norm_matches_jax(max_norm):
    grads = _tree(3)
    ref, ref_norm = jopt.clip_grad_norm(jax.tree.map(jnp.asarray, grads),
                                        max_norm)
    ts = [torch.from_numpy(np.array(g)) for _, g in _flatten(grads)]
    out, norm = optim.clip_grad_norm(ts + [None], max_norm)
    assert out[-1] is None and out[0] is ts[0]        # in place
    np.testing.assert_allclose(norm.item(), float(ref_norm), rtol=TOL)
    for t, (_, r) in zip(ts, _flatten(jax.tree.map(np.asarray, ref))):
        np.testing.assert_allclose(t.numpy(), r, rtol=TOL, atol=ATOL)


@pytest.mark.parametrize("has_aux", [False, True])
def test_accumulate_gradients_matches_jax(has_aux):
    rng = np.random.default_rng(7)
    w = rng.standard_normal((5, 3)).astype(np.float32)
    b = rng.standard_normal(3).astype(np.float32)
    xs = rng.standard_normal((4, 6, 5)).astype(np.float32)   # 4 micro
    ys = rng.standard_normal((4, 6, 3)).astype(np.float32)

    def jloss(p, batch):
        x, y = batch
        err = x @ p["w"] + p["b"] - y
        loss = jnp.mean(err ** 2)
        return (loss, jnp.max(err)) if has_aux else loss

    jout = jopt.accumulate_gradients(
        jloss, {"w": jnp.asarray(w), "b": jnp.asarray(b)},
        (jnp.asarray(xs), jnp.asarray(ys)), has_aux=has_aux)
    tw = torch.from_numpy(w).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()

    def loss_fn(batch):
        x, y = batch
        err = x @ tw + tb - y
        loss = (err ** 2).mean()
        return (loss, err.max().detach()) if has_aux else loss

    out = optim.accumulate_gradients(
        loss_fn, [tw, tb], (torch.from_numpy(xs), torch.from_numpy(ys)),
        has_aux=has_aux)
    np.testing.assert_allclose(out[0].item(), float(jout[0]), rtol=TOL)
    np.testing.assert_allclose(out[1][0].numpy(), np.asarray(jout[1]["w"]),
                               rtol=TOL, atol=ATOL)
    np.testing.assert_allclose(out[1][1].numpy(), np.asarray(jout[1]["b"]),
                               rtol=TOL, atol=ATOL)
    assert tw.grad is None
    if has_aux:
        np.testing.assert_allclose(out[2].numpy(), np.asarray(jout[2]),
                                   rtol=TOL)


def test_ema_matches_jax_with_an_f32_shadow():
    params = [_tree(s) for s in range(4)]
    je, pe = jopt.EMA(0.9), optim.EMA(0.9)
    jshadow = je.init(jax.tree.map(
        lambda a: jnp.asarray(a, jnp.bfloat16), params[0]))
    leaves = lambda t: [torch.from_numpy(np.array(v)).bfloat16()
                        for _, v in _flatten(t)]
    shadow = pe.init(leaves(params[0]))
    assert all(s.dtype == torch.float32 for s in shadow)
    for t in params[1:]:
        jshadow = je.update(jshadow, jax.tree.map(
            lambda a: jnp.asarray(a, jnp.bfloat16), t))
        pe.update(shadow, leaves(t))
    for s, (_, r) in zip(shadow, _flatten(jax.tree.map(np.asarray,
                                                       jshadow))):
        np.testing.assert_allclose(s.numpy(), r, rtol=TOL, atol=ATOL)
    cast = optim.EMA.as_params(shadow, leaves(params[0]))
    assert all(c.dtype == torch.bfloat16 for c in cast)


def _mnist(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.random((n, 784)).astype(np.float32)
    return x, (x[:, :10].argmax(1)).astype(np.int64)


@pytest.mark.parametrize("make", [
    lambda: optim.Adafactor(beta1=0.9), lambda: optim.Lion(1e-3),
    lambda: optim.Muon(0.02)], ids=["adafactor", "lion", "muon"])
def test_trainer_resume_is_bit_equal(tmp_path, make):
    """Two epochs in one run against one epoch, a fresh Trainer and
    resume=True: the same parameters and optimizer state, bit for bit,
    through the checkpoint's ``opt_state`` under JAX's slot names."""
    tx, ty = _mnist(128, 2)
    kw = dict(batch_size=32, early_stop_acc=2.0, verbose=False)

    def trainer():
        return Trainer(mnist_mlp(), make(), seed=5, device="cpu")
    full = trainer()
    full.fit_device(tx, ty, tx[:32], ty[:32], 2, **kw)
    path = str(tmp_path / "cut.npz")
    trainer().fit_device(tx, ty, tx[:32], ty[:32], 1, checkpoint_path=path,
                         **kw)
    resumed = trainer()
    resumed.fit_device(tx, ty, tx[:32], ty[:32], 2, checkpoint_path=path,
                       resume=True, **kw)
    a = dict(ckpt.flatten(full._state_tree()))
    b = dict(ckpt.flatten(resumed._state_tree()))
    assert a.keys() == b.keys()
    assert any(k.startswith("opt_state/v") or k.startswith("opt_state/m")
               for k in a)
    for k in a:
        assert torch.equal(a[k], b[k]), k
