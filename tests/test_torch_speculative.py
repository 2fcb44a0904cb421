"""Port of speculative decoding (taper_tpu_torch/models/transformer.py
``_spec_accept``, ``_spec_accept_rows``, ``TinyGPT.speculative_generate``)
against the JAX package's and against the target's own generation.

Greedy: the output is exactly the target's greedy tokens (and JAX's), per
row and in lockstep, with eos and int8 caches.  Sampled: the random
streams differ (a ``torch.Generator`` against JAX's keys), so the two
rejection-sampling lemmas and the end-to-end distribution are checked
statistically against the exact target distribution (4-sigma bands).
The statistics count tokens up to ``P + max_new``: JAX's over-count on
the final round (``models/transformer.py:1054``) is not repeated, so
``tokens_per_round`` differs from JAX's there by design.

JAX draws the parameters; they reach the port through numpy.  The seeds
were checked to leave no near-tied argmax at f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taper_tpu import models as jmodels
from taper_tpu_torch.models import TinyGPT
from taper_tpu_torch.models.transformer import (_spec_accept,
                                                _spec_accept_rows)
from taper_tpu_torch.utils.convert import load_jax_params

torch.set_num_threads(1)


def _pair(vocab=12, max_seq=64, tseed=0, dseed=7, **kw):
    tcfg = dict(vocab_size=vocab, dim=32, depth=2, num_heads=2,
                max_seq=max_seq, **kw)
    dcfg = dict(vocab_size=vocab, dim=16, depth=1, num_heads=2,
                max_seq=max_seq, **kw)
    out = []
    for cfg, seed in ((tcfg, tseed), (dcfg, dseed)):
        jm = jmodels.TinyGPT(**cfg)
        params = jm.init(jax.random.PRNGKey(seed))
        out.append((jm, params, load_jax_params(
            TinyGPT(**cfg), jax.tree.map(np.asarray, params))))
    return out


def _np(x):
    return np.asarray(x.cpu() if torch.is_tensor(x) else x)


def _prompt(shape, vocab, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, vocab, shape))


@pytest.mark.parametrize("per_row", [True, False])
@pytest.mark.parametrize("gamma", [1, 3, 4])
def test_greedy_speculative_equals_target_greedy(per_row, gamma):
    (jt, pt, target), (jd, pd, draft) = _pair()
    prompt = _prompt((2, 6), 12)
    ref = target.generate(prompt, 12)
    out = target.speculative_generate(draft, prompt, 12, gamma=gamma,
                                      per_row=per_row)
    np.testing.assert_array_equal(_np(out), _np(ref))
    want = jt.speculative_generate(pt, jd, pd, jnp.asarray(prompt.numpy()),
                                   12, gamma=gamma, per_row=per_row)
    np.testing.assert_array_equal(_np(out), _np(want))


def test_self_draft_accepts_every_round():
    """The target as its own draft: each round commits gamma + 1 tokens,
    rounds = ceil(11 / 4) = 3; 11 tokens after the first over 3 rounds
    (JAX counts 12, the final round's overshoot)."""
    (_, _, model), _ = _pair()
    prompt = _prompt((2, 6), 12)
    ref = model.generate(prompt, 12)
    for per_row in (True, False):
        out, st = model.speculative_generate(model, prompt, 12, gamma=3,
                                             return_stats=True,
                                             per_row=per_row)
        np.testing.assert_array_equal(_np(out), _np(ref))
        assert st["rounds"] == 3
        assert st["tokens_per_round"] == pytest.approx(11 / 3)
        assert _np(st["accept_hist"]).tolist() == (
            [0, 0, 0, 6] if per_row else [0, 0, 0, 3])
        assert (st["row_tokens"] is None if not per_row else
                _np(st["row_tokens"]).tolist() == [11, 11])


def test_full_acceptance_backfill_path():
    """Self-draft at 29 tokens of vocab, RoPE: every round accepts all
    gamma drafts, so the draft cache's hole at cur + gamma - 1 must be
    backfilled; the output is plain greedy."""
    (_, _, model), _ = _pair(vocab=29, max_seq=96, rope=True)
    prompt = _prompt((2, 6), 29)
    out, st = model.speculative_generate(model, prompt, 17, gamma=3,
                                         return_stats=True)
    np.testing.assert_array_equal(_np(out), _np(model.generate(prompt, 17)))
    assert st["rounds"] <= -(-17 // 4) + 1


def test_speculative_eos_as_jax():
    (jt, pt, target), (jd, pd, draft) = _pair()
    prompt = _prompt((2, 6), 12)
    ref = _np(target.generate(prompt, 12))
    eos = int(ref[0, 8])
    for per_row in (True, False):
        out = target.speculative_generate(draft, prompt, 12, gamma=3,
                                          eos_token=eos, pad_token=0,
                                          per_row=per_row)
        want = target.generate(prompt, 12, eos_token=eos, pad_token=0)
        np.testing.assert_array_equal(_np(out), _np(want))
    want = jt.speculative_generate(pt, jd, pd, jnp.asarray(prompt.numpy()),
                                   12, gamma=3, eos_token=eos, pad_token=0)
    np.testing.assert_array_equal(_np(out), _np(want))


def test_per_row_no_slower_than_lockstep_and_quantized():
    """Eight rows: per-row acceptance takes no more rounds than
    lockstep-min; both emit the target's greedy tokens, also over int8
    caches (against JAX's)."""
    (jt, pt, target), (jd, pd, draft) = _pair(vocab=24, max_seq=128)
    prompt = _prompt((8, 6), 24)
    ref = target.generate(prompt, 24)
    out_r, st_r = target.speculative_generate(draft, prompt, 24, gamma=3,
                                              return_stats=True)
    out_l, st_l = target.speculative_generate(draft, prompt, 24, gamma=3,
                                              per_row=False,
                                              return_stats=True)
    np.testing.assert_array_equal(_np(out_r), _np(ref))
    np.testing.assert_array_equal(_np(out_l), _np(ref))
    assert st_r["rounds"] <= st_l["rounds"]
    assert _np(st_r["row_tokens"]).max() <= 23
    q = target.speculative_generate(draft, prompt, 24, gamma=3,
                                    quantized_cache=True)
    want = jt.speculative_generate(pt, jd, pd, jnp.asarray(prompt.numpy()),
                                   24, gamma=3, quantized_cache=True)
    np.testing.assert_array_equal(_np(q), _np(want))
    np.testing.assert_array_equal(
        _np(q), _np(target.generate(prompt, 24, quantized_cache=True)))


def _lemma_dists(v=8):
    q = torch.softmax(torch.arange(v, dtype=torch.float32) * 0.4, 0)
    p = torch.softmax(-torch.arange(v, dtype=torch.float32) * 0.3, 0)
    bonus = torch.full((v,), 1.0 / v)
    return q, p, torch.stack([p, bonus])[None]          # [1, 2, V]


def test_spec_accept_rows_rejection_sampling_lemma():
    """Per row: the emitted token (the accepted draft, else the residual
    sample) is distributed as p, over 20,000 independent rows."""
    v, n = 8, 20000
    q, p, pfull = _lemma_dists(v)
    gen = torch.Generator().manual_seed(0)
    d = torch.multinomial(q, n, replacement=True, generator=gen)[:, None]
    n_acc, nxt = _spec_accept_rows(gen, d, q.expand(n, 1, v),
                                   pfull.expand(n, 2, v))
    toks = torch.where(n_acc == 1, d[:, 0], nxt)
    freq = np.bincount(_np(toks), minlength=v) / n
    pn = p.numpy()
    assert np.all(np.abs(freq - pn) <= 4 * np.sqrt(pn * (1 - pn) / n))


def test_spec_accept_rejection_sampling_lemma():
    """Lockstep (one row a round, so the batch minimum is that row's):
    the emitted token is distributed as p, over 8,000 rounds."""
    v, n = 8, 8000
    q, p, pfull = _lemma_dists(v)
    gen = torch.Generator().manual_seed(1)
    toks = []
    for _ in range(n):
        d = torch.multinomial(q, 1, generator=gen)[None]
        n_acc, nxt = _spec_accept(gen, d, q[None, None], pfull)
        toks.append(int(d[0, 0]) if int(n_acc) == 1 else int(nxt[0]))
    freq = np.bincount(toks, minlength=v) / n
    pn = p.numpy()
    assert np.all(np.abs(freq - pn) <= 4 * np.sqrt(pn * (1 - pn) / n))


def test_sampled_self_draft_accepts_every_round():
    (_, _, model), _ = _pair()
    prompt = _prompt((2, 6), 12)
    out, st = model.speculative_generate(
        model, prompt, 12, gamma=3, temperature=1.0,
        generator=torch.Generator().manual_seed(3), return_stats=True)
    assert out.shape == (2, 18) and st["rounds"] == 3
    np.testing.assert_array_equal(_np(out[:, :6]), _np(prompt))


@pytest.mark.parametrize("per_row", [True, False])
def test_sampled_speculative_draws_the_target_distribution(per_row):
    """The joint distribution of the two tokens after the prompt under
    sampled speculative decoding (an independent draft, gamma 2) against
    the target's exact one, p(a) p(b | a) from its forward; rows are
    independent in per-row mode (one call of 3,000 rows), one row a call
    in lockstep (600 calls)."""
    v = 8
    (_, _, target), (_, _, draft) = _pair(vocab=v, max_seq=16, dseed=9)
    prompt = torch.tensor([[1, 5, 2]])
    with torch.no_grad():
        pa = torch.softmax(target(prompt)[0, -1], -1)
        ext = torch.cat([prompt.expand(v, 3), torch.arange(v)[:, None]], 1)
        pb = torch.softmax(target(ext)[:, -1], -1)
    exact = (pa[:, None] * pb).reshape(-1).numpy()
    gen = torch.Generator().manual_seed(2)
    if per_row:
        n = 3000
        out = target.speculative_generate(draft, prompt.expand(n, 3), 2,
                                          gamma=2, temperature=1.0,
                                          generator=gen)[:, 3:]
    else:
        n = 600
        out = torch.cat([target.speculative_generate(
            draft, prompt, 2, gamma=2, temperature=1.0, generator=gen,
            per_row=False)[:, 3:] for _ in range(n)])
    freq = np.bincount(_np(out[:, 0] * v + out[:, 1]), minlength=v * v) / n
    band = 4 * np.sqrt(exact * (1 - exact) / n) + 2e-3
    assert np.all(np.abs(freq - exact) <= band)


def test_speculative_contracts():
    (_, _, target), (_, _, draft) = _pair()
    prompt = _prompt((1, 6), 12)
    out, st = target.speculative_generate(draft, prompt, 0,
                                          return_stats=True)
    assert torch.equal(out, prompt) and st == {"rounds": 0}
    with pytest.raises(ValueError, match="max_seq"):
        target.speculative_generate(draft, prompt, 56, gamma=4)
    other = TinyGPT(13, 16, 1, 2, max_seq=64)
    with pytest.raises(ValueError, match="vocab"):
        target.speculative_generate(other, prompt, 4)
