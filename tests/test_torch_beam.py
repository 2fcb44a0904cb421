"""Port of ``TinyGPT.beam_search`` (taper_tpu_torch/models/transformer.py)
against the JAX package's: beam 1 is greedy, the exhaustive oracle, the
likelihood against greedy, the eos freeze, ``length_penalty``,
``return_all`` and the int8 cache.

JAX draws the parameters; they reach the port through numpy.  Prompts
come from seeded numpy.  Tokens must be equal and scores within 1e-4:
the seeds were checked to leave no near-tied candidate at f32.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taper_tpu import models as jmodels
from taper_tpu_torch.models import TinyGPT
from taper_tpu_torch.utils.convert import load_jax_params

torch.set_num_threads(1)

SCORE_TOL = 1e-4


def _models(seed=0, **cfg):
    cfg = dict(dict(vocab_size=12, dim=32, depth=2, num_heads=2,
                    max_seq=32), **cfg)
    jmodel = jmodels.TinyGPT(**cfg)
    params = jmodel.init(jax.random.PRNGKey(seed))
    model = load_jax_params(TinyGPT(**cfg), jax.tree.map(np.asarray,
                                                         params))
    return jmodel, params, model


def _np(x):
    return np.asarray(x.cpu() if torch.is_tensor(x) else x)


def _prompt(shape, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape)


def test_beam1_equals_greedy():
    _, _, model = _models(0)
    prompt = torch.from_numpy(_prompt((2, 5), 12))
    np.testing.assert_array_equal(_np(model.beam_search(prompt, 8, beams=1)),
                                  _np(model.generate(prompt, 8)))


@pytest.mark.parametrize("kw", [
    dict(beams=4), dict(beams=3, length_penalty=0.0),
    dict(beams=4, length_penalty=2.0, quantized_cache=True)])
def test_beam_search_matches_jax(kw):
    """Every beam's tokens and its normalised score, best first."""
    jmodel, params, model = _models(0, vocab_size=16, rope=True,
                                    num_kv_heads=1)
    prompt = _prompt((2, 5), 16)
    out, scores = model.beam_search(torch.from_numpy(prompt), 8,
                                    return_all=True, **kw)
    jout, jscores = jmodel.beam_search(params, jnp.asarray(prompt), 8,
                                       return_all=True, **kw)
    np.testing.assert_array_equal(_np(out), _np(jout))
    np.testing.assert_allclose(_np(scores), _np(jscores), atol=SCORE_TOL)
    best = model.beam_search(torch.from_numpy(prompt), 8, **kw)
    np.testing.assert_array_equal(_np(best), _np(out)[:, 0])


def test_beam_search_exhaustive_oracle():
    """W = V with max_new = 2 keeps every first token alive, so the best
    beam is the argmax two-token continuation, found by brute force."""
    v = 5
    _, _, model = _models(0, vocab_size=v, dim=16, depth=1, max_seq=16)
    prompt = torch.tensor([[2, 0, 3]])
    best, best_seq = -np.inf, None
    with torch.no_grad():
        for a, b in itertools.product(range(v), repeat=2):
            seq = torch.cat([prompt, torch.tensor([[a, b]])], 1)
            lp = torch.log_softmax(model(seq), -1)[0]
            sc = float(lp[2, a] + lp[3, b])
            if sc > best:
                best, best_seq = sc, [a, b]
    out, scores = model.beam_search(prompt, 2, beams=v, return_all=True)
    assert _np(out[0, 0, 3:]).tolist() == best_seq
    assert np.all(np.diff(_np(scores[0])) <= 1e-6)
    np.testing.assert_allclose(float(scores[0, 0]), best / 2, rtol=1e-5)


def test_beam_search_beats_or_matches_greedy_likelihood():
    _, _, model = _models(0, vocab_size=16)
    prompt = torch.from_numpy(_prompt((2, 5), 16))

    def seq_logp(tokens):
        with torch.no_grad():
            lg = torch.log_softmax(model(tokens)[:, :-1], -1)
        pick = lg.gather(2, tokens[:, 1:, None])[..., 0]
        return _np(pick[:, 4:].sum(1))

    greedy = model.generate(prompt, 8)
    beam = model.beam_search(prompt, 8, beams=4)
    assert np.all(seq_logp(beam) >= seq_logp(greedy) - 1e-4)


def test_beam_search_eos_freezes_beams_as_jax():
    jmodel, params, model = _models(0, depth=1)
    prompt = _prompt((2, 5), 12)
    ref = _np(model.beam_search(torch.from_numpy(prompt), 10, beams=3))
    eos = int(ref[0, 7])
    out, scores = model.beam_search(torch.from_numpy(prompt), 10, beams=3,
                                    eos_token=eos, pad_token=0,
                                    return_all=True)
    jout, jscores = jmodel.beam_search(params, jnp.asarray(prompt), 10,
                                       beams=3, eos_token=eos, pad_token=0,
                                       return_all=True)
    out = _np(out)
    np.testing.assert_array_equal(out, _np(jout))
    np.testing.assert_allclose(_np(scores), _np(jscores), atol=SCORE_TOL)
    assert out.shape == (2, 3, 15) and scores.shape == (2, 3)
    for row in out.reshape(6, 15):
        hit = np.where(row[5:] == eos)[0]
        if hit.size:
            assert np.all(row[5 + hit[0] + 1:] == 0), row


def test_beam_search_reorders_the_cache_in_place():
    """The caches' storage is reused step to step (``index_select`` copied
    back), and a bad width raises as JAX asserts."""
    _, _, model = _models(0)
    prompt = torch.from_numpy(_prompt((1, 5), 12))
    seen = []
    real = model.decode_step

    def spy(tok, pos, caches):
        seen.append(caches[0]["k"].data_ptr())
        return real(tok, pos, caches)

    model.decode_step = spy
    model.beam_search(prompt, 6, beams=3)
    assert len(seen) == 5 and len(set(seen)) == 1
    with pytest.raises(ValueError, match="beams"):
        model.beam_search(prompt, 4, beams=13)
