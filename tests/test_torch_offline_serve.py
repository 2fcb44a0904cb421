"""Port of ``offline_serve`` (taper_tpu_torch/serve.py) against the JAX
package's (``taper_tpu/serve.py:68``) on the CPU, f32.

JAX draws the weights (``TinyGPT`` of ``tests/test_serve.py``: vocab 32,
dim 32, depth 2, RoPE); they reach the port through
``utils/convert.py::load_jax_params``.  Prompts, lengths and budgets come
from numpy with fixed seeds.  Greedy tokens and ``n_tokens`` must be
equal exactly: the seeds leave no near-tied argmax at f32 (the logits
agree to 1e-4, test_torch_transformer.py).  The port serves through a
``ServingEngine``, which decodes in blocks of ``decode_block`` steps; the
cases run at 3 (slots free and refill inside a request's life, blocks end
mid-request) and at the engine's default, 16.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taper_tpu import models as jmodels
from taper_tpu import serve as jserve
from taper_tpu_torch import serve
from taper_tpu_torch.models import TinyGPT
from taper_tpu_torch.utils.convert import load_jax_params

torch.set_num_threads(1)

CFG = dict(vocab_size=32, dim=32, depth=2, num_heads=4, max_seq=64,
           rope=True)
BLOCKS = (3, 16)


def _models(seed):
    jmodel = jmodels.TinyGPT(**CFG)
    params = jmodel.init(jax.random.PRNGKey(seed))
    model = load_jax_params(TinyGPT(**CFG), jax.tree.map(np.asarray, params))
    return jmodel, params, model


def _workload(seed, n=6, p_pad=8, budget_hi=8):
    """``tests/test_serve.py:74``'s mix: lengths in [3, 8], budgets in
    [1, 8)."""
    rng = np.random.default_rng(seed)
    prompts = np.zeros((n, p_pad), np.int32)
    lens, budgets = [], []
    for i in range(n):
        length = int(rng.integers(3, p_pad + 1))
        prompts[i, :length] = rng.integers(0, 32, length)
        lens.append(length)
        budgets.append(int(rng.integers(1, budget_hi)))
    return prompts, lens, budgets


def _blocks_of(monkeypatch, block):
    """offline_serve's engines decode in blocks of ``block`` steps."""
    monkeypatch.setattr(serve, "ServingEngine", functools.partial(
        serve.ServingEngine, decode_block=block))


def _both(jmodel, params, model, prompts, lens, budgets, **kw):
    out, n_tok = serve.offline_serve(model, prompts, lens, budgets,
                                     device="cpu", **kw)
    jout, jn = jserve.offline_serve(jmodel, params, prompts, lens, budgets,
                                    **kw)
    return (out.numpy(), n_tok.numpy(), np.asarray(jout),
            np.asarray(jn))


@pytest.mark.parametrize("block", BLOCKS)
def test_offline_serve_matches_jax_and_standalone_generate(monkeypatch,
                                                           block):
    """Mixed lengths and budgets at slots < N: JAX's tokens and counts
    exactly, and each row standalone ``generate``'s greedy tokens (JAX's
    contract)."""
    _blocks_of(monkeypatch, block)
    jmodel, params, model = _models(3)
    prompts, lens, budgets = _workload(3)
    out, n_tok, jout, jn = _both(jmodel, params, model, prompts, lens,
                                 budgets, slots=2)
    np.testing.assert_array_equal(n_tok, jn)
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(n_tok, budgets)
    for i, (length, m) in enumerate(zip(lens, budgets)):
        ref = model.generate(torch.from_numpy(prompts[i:i + 1, :length]), m)
        assert out[i, :m].tolist() == ref[0, length:].tolist(), i
        assert not out[i, m:].any()


@pytest.mark.parametrize("block", BLOCKS)
def test_offline_serve_eos_matches_jax(monkeypatch, block):
    """``tests/test_serve.py:98``: an eos that fires early for some rows;
    the counts include the eos, zeros after it."""
    _blocks_of(monkeypatch, block)
    jmodel, params, model = _models(4)
    rng = np.random.default_rng(4)
    prompts = rng.integers(0, 32, (4, 5)).astype(np.int32)
    probe = model.generate(torch.from_numpy(prompts[:1]), 8)[0, 5:]
    eos = int(probe[1])
    out, n_tok, jout, jn = _both(jmodel, params, model, prompts, [5] * 4,
                                 [10] * 4, slots=2, eos_token=eos)
    np.testing.assert_array_equal(n_tok, jn)
    np.testing.assert_array_equal(out, jout)
    assert (n_tok < 10).any()
    for i in range(4):
        k = int(n_tok[i])
        ref = model.generate(torch.from_numpy(prompts[i:i + 1]), 10,
                             eos_token=eos)[0, 5:5 + k]
        assert out[i, :k].tolist() == ref.tolist(), i
        assert not out[i, k:].any()


@pytest.mark.parametrize("slots", (1, 3))
def test_offline_serve_int8_cache_matches_jax(slots):
    """``quantized_cache=True``: int8 K/V rows with per-position scales,
    the same tokens as JAX's int8 cache."""
    jmodel, params, model = _models(5)
    prompts, lens, budgets = _workload(5, n=5)
    out, n_tok, jout, jn = _both(jmodel, params, model, prompts, lens,
                                 budgets, slots=slots, quantized_cache=True)
    np.testing.assert_array_equal(n_tok, jn)
    np.testing.assert_array_equal(out, jout)


def test_offline_serve_max_out_caps_the_budgets():
    """``max_out`` below the largest budget: the output has ``max_out``
    columns and every budget is capped there, as JAX does."""
    jmodel, params, model = _models(6)
    prompts, lens, budgets = _workload(6, n=5, budget_hi=12)
    cap = 5
    assert max(budgets) > cap
    out, n_tok, jout, jn = _both(jmodel, params, model, prompts, lens,
                                 budgets, slots=2, max_out=cap)
    assert out.shape == (5, cap)
    np.testing.assert_array_equal(n_tok, np.minimum(budgets, cap))
    np.testing.assert_array_equal(n_tok, jn)
    np.testing.assert_array_equal(out, jout)


def test_offline_serve_sampled_shapes_budgets_and_zero_fill():
    """Sampled rows (temperature 0.9, top-k 8): the shapes, each row's
    count at its budget, tokens in the vocab, zeros past the count, and
    the same tokens again from the same generator seed (the default
    generator is seeded 0 every call)."""
    _, _, model = _models(7)
    prompts, lens, budgets = _workload(7, n=5)
    kw = dict(slots=2, temperature=0.9, top_k=8, device="cpu")
    out, n_tok = serve.offline_serve(model, prompts, lens, budgets, **kw)
    assert out.shape == (5, max(budgets)) and out.dtype == torch.int64
    assert n_tok.tolist() == budgets
    for i, m in enumerate(budgets):
        assert ((out[i, :m] >= 0) & (out[i, :m] < CFG["vocab_size"])).all()
        assert not out[i, m:].any()
    again, _ = serve.offline_serve(model, prompts, lens, budgets, **kw)
    assert torch.equal(out, again)
    gen = torch.Generator().manual_seed(11)
    other, _ = serve.offline_serve(model, prompts, lens, budgets,
                                   generator=gen, **kw)
    assert not torch.equal(out, other)


def test_offline_serve_contracts():
    """Run on the card unless asked for the CPU; JAX's asserts raise
    ``ValueError``; the entry point is exported as JAX exports it."""
    import taper_tpu_torch
    _, _, model = _models(8)
    prompts, lens, budgets = _workload(8, n=3)
    assert taper_tpu_torch.offline_serve is serve.offline_serve
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            serve.offline_serve(model, prompts, lens, budgets)
    with pytest.raises(ValueError, match="exceeds max_seq"):
        serve.offline_serve(model, prompts, lens, budgets, max_out=60,
                            device="cpu")
    with pytest.raises(ValueError, match="lens must be in"):
        serve.offline_serve(model, prompts, [0, 3, 3], budgets,
                            device="cpu")
    with pytest.raises(ValueError, match="one entry per prompt"):
        serve.offline_serve(model, prompts, lens[:2], budgets, device="cpu")
    out, n_tok = serve.offline_serve(model, prompts[:0], [], [],
                                     device="cpu")
    assert out.shape == (0, 0) and n_tok.shape == (0,)
