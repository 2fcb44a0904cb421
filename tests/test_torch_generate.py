"""Port of ``TinyGPT.generate`` (taper_tpu_torch/models/transformer.py)
against the JAX package's: one-shot and token-at-a-time prefill, ragged
prompts, eos and padding, the ``ValueError`` contracts, int8 and ring
caches, and sampled generation by distribution (the random streams
differ: a ``torch.Generator`` against JAX's keys).

JAX draws the parameters; they reach the port through numpy
(``load_jax_params``).  Prompts come from seeded numpy.  Greedy tokens
must be equal: the seeds below were checked to leave no near-tied argmax
at f32 (the teacher-forced logits agree to 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taper_tpu import models as jmodels
from taper_tpu.models.transformer import _filter_logits as jfilter
from taper_tpu.models.transformer import _mask_after_eos as jmask
from taper_tpu_torch.models import TinyGPT
from taper_tpu_torch.models import transformer as MT
from taper_tpu_torch.utils.convert import load_jax_params

torch.set_num_threads(1)

LOGIT_TOL = 1e-4


def _models(seed=0, **cfg):
    cfg = dict(dict(vocab_size=12, dim=32, depth=2, num_heads=2,
                    max_seq=32), **cfg)
    jmodel = jmodels.TinyGPT(**cfg)
    params = jmodel.init(jax.random.PRNGKey(seed))
    model = load_jax_params(TinyGPT(**cfg), jax.tree.map(np.asarray,
                                                         params))
    return jmodel, params, model


def _prompt(shape, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape)


def _np(x):
    return np.asarray(x.cpu() if torch.is_tensor(x) else x)


CONFIGS = [dict(), dict(rope=True, num_kv_heads=1), dict(window=5),
           dict(rope=True, num_heads=4, num_kv_heads=2, norm="rms",
                mlp_act="swiglu")]


@pytest.mark.parametrize("cfg", CONFIGS)
def test_generate_matches_jax_one_shot_and_sequential(cfg):
    """Greedy tokens equal JAX's on both prefill paths; the first
    generated token is the argmax of the full forward at the prompt's
    last position, and the teacher-forced logits of the output agree
    with JAX's to 1e-4."""
    jmodel, params, model = _models(0, **cfg)
    prompt = _prompt((2, 7), 12)
    ref = _np(jmodel.generate(params, jnp.asarray(prompt), 8))
    fast = model.generate(torch.from_numpy(prompt), 8)
    slow = model.generate(torch.from_numpy(prompt), 8,
                          one_shot_prefill=False)
    np.testing.assert_array_equal(_np(fast), ref)
    np.testing.assert_array_equal(_np(slow), ref)
    assert fast.dtype == torch.int64 and fast.shape == (2, 15)
    with torch.no_grad():
        logits = model(fast[:, :-1])
    np.testing.assert_allclose(
        logits.numpy(), _np(jmodel.apply(params, jnp.asarray(ref[:, :-1]))),
        atol=LOGIT_TOL)
    np.testing.assert_array_equal(_np(fast[:, 7]),
                                  _np(logits[:, 6].argmax(-1)))


def test_generate_max_new_zero_and_prefill_only_cache():
    jmodel, params, model = _models(0, depth=1, max_seq=16)
    prompt = _prompt((2, 6), 12)
    for one_shot in (True, False):
        out = model.generate(torch.from_numpy(prompt), 0,
                             one_shot_prefill=one_shot)
        np.testing.assert_array_equal(_np(out), prompt)
    toks, caches = model.generate(torch.from_numpy(prompt), 0,
                                  return_cache=True)
    _, jcaches = jmodel.generate(params, jnp.asarray(prompt), 0,
                                 return_cache=True)
    np.testing.assert_array_equal(_np(toks), prompt)
    for c, jc in zip(caches, jcaches):
        for name in ("k", "v"):
            np.testing.assert_allclose(c[name].numpy(), _np(jc[name]),
                                       atol=1e-5)


@pytest.mark.parametrize("one_shot", [True, False])
def test_generate_eos_early_stop_and_padding(one_shot):
    """Tokens up to each row's first eos are the no-eos run's, the rest
    pad, as JAX's; the loop stops early without changing a token."""
    jmodel, params, model = _models(0, depth=1)
    prompt = _prompt((3, 6), 12)
    ref = _np(model.generate(torch.from_numpy(prompt), 12))
    eos = int(ref[0, 8])                   # row 0 emits it early
    out = _np(model.generate(torch.from_numpy(prompt), 12, eos_token=eos,
                             pad_token=0, one_shot_prefill=one_shot))
    want = _np(jmodel.generate(params, jnp.asarray(prompt), 12,
                               eos_token=eos, pad_token=0,
                               one_shot_prefill=one_shot))
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(
        out, _np(jmask(jnp.asarray(ref), 6, eos, 0)))


def test_generate_eos_stops_the_loop(monkeypatch):
    """The loop ends at the first look at ``done`` after every row has
    emitted eos (one every ``EOS_BLOCK`` steps, the first before any
    step): no decode step when the prefill's token is eos on every row,
    and k steps rounded up to a whole block when a row's first eos is its
    k-th decoded token."""
    _, _, model = _models(0, depth=1)
    prompt = torch.from_numpy(_prompt((2, 6), 12))
    first = model.generate(prompt, 1)[:, 6]
    if first[0] != first[1]:
        prompt = prompt[:1]
    calls = []
    real = model.decode_step
    monkeypatch.setattr(model, "decode_step",
                        lambda *a: calls.append(1) or real(*a))
    out = model.generate(prompt, 20, eos_token=int(first[0]), pad_token=0)
    assert len(calls) == 0                # done after the prefill
    assert (out[:, 7:] == 0).all()
    one = torch.from_numpy(_prompt((1, 6), 12, seed=4))   # 11, 11, 5, ...
    row = model.generate(one, 20)[0, 6:].tolist()
    k = next(i for i in range(1, 20) if row[i] not in row[:i])
    calls.clear()
    out = model.generate(one, 20, eos_token=row[k], pad_token=0)
    block = MT.EOS_BLOCK
    assert len(calls) == min(-(-k // block) * block, 19)
    assert out[0, 6:7 + k].tolist() == row[:k + 1]
    assert (out[0, 7 + k:] == 0).all()


def test_generate_eos_ragged():
    jmodel, params, model = _models(0, depth=1)
    prompt = _prompt((2, 6), 12)
    lens = np.array([4, 6])
    ref = _np(model.generate(torch.from_numpy(prompt), 10,
                             prompt_lens=lens))
    eos = int(ref[0, 5])                   # row 0's 2nd generated token
    out = _np(model.generate(torch.from_numpy(prompt), 10,
                             prompt_lens=torch.from_numpy(lens),
                             eos_token=eos, pad_token=0))
    want = _np(jmodel.generate(params, jnp.asarray(prompt), 10,
                               prompt_lens=jnp.asarray(lens),
                               eos_token=eos, pad_token=0))
    np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("cfg", [dict(), dict(rope=True, num_kv_heads=1,
                                              window=6)])
def test_ragged_generate_matches_jax_and_per_row(cfg):
    """Right-padded rows with ``prompt_lens``: JAX's tokens, and each
    row's continuation equals generating it alone (the pad region is
    poisoned and must not leak)."""
    jmodel, params, model = _models(0, **cfg)
    full = _prompt((3, 7), 12)
    lens = np.array([7, 4, 2])
    poison = np.where(np.arange(7)[None] < lens[:, None], full, 11)
    out = _np(model.generate(torch.from_numpy(poison), 5,
                             prompt_lens=lens))
    want = _np(jmodel.generate(params, jnp.asarray(poison), 5,
                               prompt_lens=jnp.asarray(lens)))
    np.testing.assert_array_equal(out, want)
    for r, n in enumerate(lens):
        solo = _np(model.generate(torch.from_numpy(full[r:r + 1, :n]), 5))
        np.testing.assert_array_equal(out[r, :n + 5], solo[0])


def test_generate_contracts():
    """JAX's ValueErrors, and its assertions as ValueErrors."""
    _, _, model = _models(0, depth=1, max_seq=16, window=4)
    prompt = torch.from_numpy(_prompt((2, 6), 12))
    lens = torch.tensor([3, 6])
    with pytest.raises(ValueError, match="partially filled"):
        model.generate(prompt, 4, eos_token=3, return_cache=True)
    with pytest.raises(ValueError, match="one-shot prefill"):
        model.generate(prompt, 4, one_shot_prefill=False, prompt_lens=lens)
    with pytest.raises(ValueError, match="ragged"):
        model.generate(prompt, 4, prompt_lens=lens, return_cache=True)
    with pytest.raises(ValueError, match="ring_cache"):
        model.generate(prompt, 4, prompt_lens=lens, ring_cache=True)
    with pytest.raises(ValueError, match="prompt_lens"):
        model.generate(prompt, 4, prompt_lens=torch.tensor([0, 6]))
    with pytest.raises(ValueError, match="prompt_lens"):
        model.generate(prompt, 4, prompt_lens=[3, 7])
    with pytest.raises(ValueError, match="max_seq"):
        model.generate(prompt, 11)
    with pytest.raises(ValueError, match="ring"):
        TinyGPT(12, 32, 1, 2, max_seq=16).generate(prompt, 4,
                                                   ring_cache=True)


@pytest.mark.parametrize("cfg", [dict(rope=True, num_kv_heads=1),
                                 dict(rope=False)])
def test_quantized_cache_generate_matches_jax(cfg):
    jmodel, params, model = _models(2, **cfg)
    prompt = _prompt((2, 7), 12, seed=3)
    out = model.generate(torch.from_numpy(prompt), 10,
                         quantized_cache=True)
    want = jmodel.generate(params, jnp.asarray(prompt), 10,
                           quantized_cache=True)
    np.testing.assert_array_equal(_np(out), _np(want))


@pytest.mark.parametrize("kv,quant", [(None, False), (2, True)])
def test_ring_cache_generate_matches_full_cache_and_jax(kv, quant):
    """A window-8 model generating far past W: the ring cache's tokens
    equal the full cache's and JAX's ring generation."""
    cfg = dict(vocab_size=32, dim=32, depth=2, num_heads=4,
               num_kv_heads=kv, max_seq=64, rope=True, window=8)
    jmodel, params, model = _models(0, **cfg)
    prompt = _prompt((3, 12), 32)
    full = model.generate(torch.from_numpy(prompt), 30,
                          quantized_cache=quant)
    ring = model.generate(torch.from_numpy(prompt), 30,
                          quantized_cache=quant, ring_cache=True)
    want = jmodel.generate(params, jnp.asarray(prompt), 30,
                           quantized_cache=quant, ring_cache=True)
    np.testing.assert_array_equal(_np(ring), _np(full))
    np.testing.assert_array_equal(_np(ring), _np(want))


def test_gqa_rope_decode_steps_match_forward_and_generate():
    """MQA with RoPE: 16 decode steps equal the full forward (2e-5, as
    JAX's test), and the port's generation JAX's."""
    jmodel, params, model = _models(0, depth=1, num_heads=4,
                                    num_kv_heads=1, rope=True, max_seq=16)
    toks = torch.from_numpy(_prompt((2, 16), 12))
    caches = model.init_cache(2)
    assert caches[0]["k"].shape[1] == 1
    with torch.no_grad():
        full = model(toks)
        steps = torch.stack([model.decode_step(toks[:, t], t, caches)
                             for t in range(16)], 1)
    np.testing.assert_allclose(steps.numpy(), full.numpy(), atol=2e-5)
    out = model.generate(toks[:, :4], 6)
    np.testing.assert_array_equal(
        _np(out), _np(jmodel.generate(params, jnp.asarray(toks[:, :4]), 6)))


@pytest.mark.parametrize("kw", [dict(temperature=1.0),
                                dict(temperature=0.7, top_k=5),
                                dict(temperature=1.3, top_p=0.6)])
def test_sampled_generate_draws_jax_distribution(kw):
    """Sampled tokens follow the distribution JAX samples from: the
    first generated token over 4,000 rows of one prompt against the
    softmax of JAX's filtered logits (4-sigma band), and no token
    outside the filter's support at either step."""
    jmodel, params, model = _models(4, vocab_size=8, dim=16, depth=1)
    prompt = _prompt((1, 5), 8)
    n = 4000
    out = model.generate(torch.from_numpy(np.repeat(prompt, n, 0)), 2,
                         generator=torch.Generator().manual_seed(0), **kw)
    lg = jmodel.apply(params, jnp.asarray(prompt))[:, -1]
    temp = kw["temperature"]
    p = _np(jax.nn.softmax(jfilter(lg, temp, kw.get("top_k"),
                                   kw.get("top_p")), -1))[0]
    freq = np.bincount(_np(out[:, 5]), minlength=8) / n
    band = 4 * np.sqrt(p * (1 - p) / n) + 1e-3
    assert np.all(np.abs(freq - p) <= band), (freq, p)
    assert np.all(freq[p == 0] == 0)
    if "top_k" in kw:                      # at most k distinct second tokens
        for t in range(8):
            rows = _np(out[:, 5]) == t
            if rows.sum():
                assert len(np.unique(_np(out[rows, 6]))) <= kw["top_k"]


def test_sampled_generate_is_reproducible_from_its_generator():
    _, _, model = _models(4)
    prompt = torch.from_numpy(_prompt((3, 5), 12))
    a = model.generate(prompt, 6, temperature=1.0,
                       generator=torch.Generator().manual_seed(5))
    b = model.generate(prompt, 6, temperature=1.0,
                       generator=torch.Generator().manual_seed(5))
    c = model.generate(prompt, 6, temperature=1.0)     # a seed-0 default
    d = model.generate(prompt, 6, temperature=1.0)
    assert torch.equal(a, b) and torch.equal(c, d)


def test_mask_after_eos_matches_jax():
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 4, (5, 12))
    for starts in (3, np.array([0, 2, 5, 7, 11])):
        got = MT._mask_after_eos(torch.from_numpy(toks),
                                 torch.as_tensor(starts), 2, 9)
        np.testing.assert_array_equal(
            _np(got), _np(jmask(jnp.asarray(toks), jnp.asarray(starts), 2,
                                9)))


@pytest.mark.parametrize("name", ["generate", "generate_continued",
                                  "decode_chunk", "prefill_paged_continued",
                                  "beam_search", "speculative_generate"])
def test_port_takes_every_jax_argument(name):
    """Every argument of JAX's method but its functional state (params,
    keys: the port takes a ``generator``)."""
    import inspect
    want = set(inspect.signature(getattr(jmodels.TinyGPT, name)).parameters)
    got = set(inspect.signature(getattr(TinyGPT, name)).parameters)
    assert want - {"self", "params", "draft_params", "key"} <= got
    assert "key" not in want or "generator" in got
