"""TinyGPT training (taper_tpu_torch/models/transformer.py ``TinyGPT.loss``
and every parameter's gradient through the port's autograd Functions)
against the JAX package's ``TinyGPT.loss`` and ``jax.value_and_grad``, on
the pallas backend with ``TAPER_FLASH_MIN=128``, so that JAX's Pallas GEMM
and flash kernels run (interpreted on the CPU).

JAX draws the parameters; they reach the port through numpy and
``load_jax_params``, and the gradients are compared under the same dotted
names.  Models of depth 2 cover both attention layouts: dim 256 with 2
heads (head dim 128, the transpose-free ``[B, S, H*D]`` path) and dim 128
with 2 heads (head dim 64, the transposed path), with and without RoPE, and
GQA.  Tolerances (ROADMAP.md, port conventions): in f32 the loss to 1e-5
and each gradient to 1e-4 relative L2 (exact f32 on both sides, in other
summation orders); with a bf16 trunk the loss to 1e-2 (bf16 rounds the
activations to 8 bits at other points in the two packages).  Without
RoPE the key biases' gradient is zero in exact arithmetic (a key bias then
shifts every score of a row alike, which the softmax ignores), so both
sides hold rounding noise there (~1e-10); it is held to 1e-6 of the whole
gradient's norm on both sides instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taper_tpu import models as jmodels
from taper_tpu import ops as jops
from taper_tpu_torch.models import TinyGPT
from taper_tpu_torch.utils.convert import _flatten, load_jax_params

torch.set_num_threads(1)

VOCAB = 32
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4


def _case(seed, s, **cfg):
    cfg = dict(vocab_size=VOCAB, depth=2, num_heads=2, max_seq=s, **cfg)
    jmodel = jmodels.TinyGPT(**cfg)
    params = jmodel.init(jax.random.PRNGKey(seed))
    if cfg.get("compute_dtype") is not None:
        cfg["compute_dtype"] = torch.bfloat16
    model = load_jax_params(TinyGPT(**cfg),
                            jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, VOCAB, (2, s))
    tgts = np.roll(toks, -1, axis=1)
    mask = (rng.random((2, s)) < 0.8).astype(np.float32)
    return jmodel, params, model, (toks, tgts, mask)


def _jax_loss_and_grads(jmodel, params, batch, z_loss=0.0):
    toks, tgts, mask = (jnp.asarray(a) for a in batch)

    def loss_of(p):
        return jmodel.loss(p, toks.astype(jnp.int32), tgts.astype(jnp.int32),
                           mask, z_loss=z_loss)

    with jops.use_backend("pallas"):
        (loss, acc), grads = jax.value_and_grad(loss_of, has_aux=True)(
            params)
    return float(loss), float(acc), dict(_flatten(
        jax.tree.map(np.asarray, grads)))


def _port_loss_and_grads(model, batch, z_loss=0.0):
    toks, tgts, mask = (torch.from_numpy(a) for a in batch)
    loss, acc = model.loss(toks, tgts, mask, z_loss=z_loss)
    loss.backward()
    # a parameter the loss does not reach has no .grad; JAX's is zero
    grads = {k: (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
             for k, p in model.named_parameters()}
    return loss.item(), acc.item(), grads


def _worst_rel_l2(grads, refs, rope):
    """The worst leaf's relative L2 error and its name; without RoPE the
    key biases are held to be zero instead (see the module docstring)."""
    total = np.sqrt(sum(np.sum(np.square(r)) for r in refs.values()))
    rel = {}
    for k, ref in refs.items():
        if k.endswith("attn.bk") and not rope:
            assert max(np.linalg.norm(grads[k]),
                       np.linalg.norm(ref)) <= 1e-6 * total, k
        else:
            rel[k] = float(np.linalg.norm(grads[k] - ref)
                           / max(np.linalg.norm(ref), 1e-30))
    worst = max(rel, key=rel.get)
    return rel[worst], worst


@pytest.mark.parametrize("dim,s,cfg", [
    (256, 128, dict(rope=True)),
    (256, 256, dict(rope=False, tied_head=False)),
    (256, 128, dict(rope=True, num_kv_heads=1)),
    (128, 256, dict(rope=True)),
    (128, 128, dict(rope=False)),
], ids=["d128-s128-rope", "d128-s256-untied", "d128-s128-gqa",
        "d64-s256-rope", "d64-s128"])
def test_loss_and_grads_match_jax(monkeypatch, dim, s, cfg):
    monkeypatch.setenv("TAPER_FLASH_MIN", "128")
    jmodel, params, model, batch = _case(dim + s, s, dim=dim, **cfg)
    z = 1e-3 if dim == 128 else 0.0
    loss_ref, acc_ref, g_ref = _jax_loss_and_grads(jmodel, params, batch, z)
    loss, acc, grads = _port_loss_and_grads(model, batch, z)
    assert abs(loss - loss_ref) <= LOSS_TOL * abs(loss_ref)
    # an argmax between two logits within rounding may flip: one position
    assert abs(acc - acc_ref) <= 1.0 / batch[2].sum()
    assert grads.keys() == g_ref.keys()
    rel, worst = _worst_rel_l2(grads, g_ref, cfg["rope"])
    assert rel <= GRAD_TOL, (worst, rel)
    if cfg.get("rope"):
        assert not np.any(grads["pos.w"])   # built, never read


def test_bf16_trunk_loss_matches_jax(monkeypatch):
    monkeypatch.setenv("TAPER_FLASH_MIN", "128")
    jmodel, params, model, batch = _case(3, 128, dim=256, rope=True,
                                         compute_dtype=jnp.bfloat16)
    loss_ref, _, _ = _jax_loss_and_grads(jmodel, params, batch)
    loss, _, grads = _port_loss_and_grads(model, batch)
    assert abs(loss - loss_ref) <= 1e-2 * abs(loss_ref)
    assert all(np.isfinite(g).all() for g in grads.values())


def test_loss_takes_the_naive_branch_only():
    """chunk=0 takes the naive branch; an explicit chunk takes the fused
    vocab-chunked branch (ported: tests/test_torch_fused_ce.py holds it
    against JAX), which gives the naive branch's loss and accuracy."""
    model = TinyGPT(vocab_size=VOCAB, dim=32, depth=1, num_heads=2,
                    max_seq=16)
    toks = torch.zeros(1, 16, dtype=torch.int64)
    loss, acc = model.loss(toks, toks, torch.ones(16), chunk=0)
    assert loss.dim() == 0 and acc.dim() == 0
    fused, facc = model.loss(toks, toks, torch.ones(16), chunk=8)
    torch.testing.assert_close(fused, loss, rtol=1e-6, atol=0)
    assert float(facc) == float(acc)


@pytest.mark.parametrize("kw", [dict(dropout=0.1), dict(window=8),
                                dict(n_experts=4), dict(top_k=1),
                                dict(capacity_factor=1.25),
                                dict(remat=True)])
def test_unported_options_raise(kw):
    """Every option here is ported now, so each builds a model that
    trains: dropout, MoE and remat (held against JAX in
    tests/test_torch_moe.py and tests/test_torch_regularize.py; top_k and
    capacity_factor without experts change nothing, as in JAX) give a
    finite loss and gradient.  A window builds a model whose rows see the
    last 8 keys only: the last row's output is that of the model on the
    last 8 tokens alone (RoPE makes attention depend on relative
    positions only)."""
    if "window" in kw:
        model = TinyGPT(vocab_size=VOCAB, dim=32, depth=1, num_heads=2,
                        rope=True, max_seq=16, **kw)
        model.reset_parameters(torch.Generator().manual_seed(0))
        toks = torch.randint(0, VOCAB, (1, 16),
                             generator=torch.Generator().manual_seed(1))
        with torch.no_grad():
            full = model(toks)[0, -1]
            alone = model(toks[:, -8:])[0, -1]
        torch.testing.assert_close(full, alone, rtol=1e-5, atol=1e-5)
        return
    model = TinyGPT(vocab_size=VOCAB, dim=32, depth=1, num_heads=2,
                    max_seq=16, **kw)
    toks = torch.randint(0, VOCAB, (2, 16),
                         generator=torch.Generator().manual_seed(1))
    loss, _ = model.loss(toks, toks.roll(-1, 1), torch.ones(16),
                         train=True, generator=torch.Generator())
    loss.backward()
    assert torch.isfinite(loss)
    assert all(torch.isfinite(p.grad).all() for p in model.parameters()
               if p.grad is not None)
