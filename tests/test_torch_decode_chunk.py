"""Port of chunked decode (taper_tpu_torch/nn/transformer.py
``_decode_attention(q_offsets=)``, per-row chunks of ``_cache_write``,
``MultiHeadAttention.chunk``; models/transformer.py ``decode_chunk``,
``generate_continued``) against the JAX package's.

JAX draws the parameters; they reach the port through numpy.  Inputs
come from seeded numpy.  Tolerances: f32 attention outputs and cache
rows 1e-5 (exact f32 on both sides, other summation orders); logits
1e-4; int8 caches hold codes at most one step apart on under 1% of the
entries (both packages quantize K/V that differ in the last f32 bit;
JAX's serving functions run under ``jit``, where XLA folds
``kv_quantize``'s ``/ 127`` as the port does).  Greedy tokens must be
equal: the seeds were checked to leave no near-tied argmax.
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
from taper_tpu_torch.utils.convert import load_jax_params

torch.set_num_threads(1)


def _models(seed=0, **cfg):
    cfg = dict(dict(vocab_size=32, dim=32, depth=2, num_heads=4,
                    max_seq=64, rope=True), **cfg)
    jmodel = jmodels.TinyGPT(**cfg)
    params = jmodel.init(jax.random.PRNGKey(seed))
    model = load_jax_params(TinyGPT(**cfg), jax.tree.map(np.asarray,
                                                         params))
    return jmodel, params, model


def _np(x):
    return np.asarray(x.cpu() if torch.is_tensor(x) else x)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _check_caches(mine, ref, quant):
    for c, jc in zip(mine, ref):
        for name in c:
            got, want = c[name].float().numpy(), _np(jc[name]).astype(
                np.float32)
            if quant and name in ("k", "v"):
                diff = np.abs(got - want)
                assert diff.max() <= 1 and (diff > 0).mean() < 0.01
            else:
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rows", [False, True])
@pytest.mark.parametrize("quant,window", [(False, None), (True, None),
                                          (False, 5)])
def test_decode_attention_q_offsets_matches_jax(rows, quant, window):
    """GQA's folded queries (2 KV heads, groups of 3, a chunk of 4: the
    offsets tiled) against a cache of 16, at a scalar or per-row start."""
    rng = np.random.default_rng(0)
    b, h, c, d, s = 2, 2, 4, 8, 16
    q = rng.standard_normal((b, h, 3 * c, d)).astype(np.float32)
    offs = np.tile(np.arange(c), 3)
    pos = np.array([3, 9]) if rows else 6
    if quant:
        kc = rng.integers(-127, 128, (b, h, s, d)).astype(np.int8)
        vc = rng.integers(-127, 128, (b, h, s, d)).astype(np.int8)
        ks = rng.random((b, h, s)).astype(np.float32) * 0.01
        vs = rng.random((b, h, s)).astype(np.float32) * 0.01
        sc = dict(k_scale=ks, v_scale=vs)
    else:
        kc, vc = (rng.standard_normal((b, h, s, d)).astype(np.float32)
                  for _ in range(2))
        sc = {}
    got = T._decode_attention(_t(q), _t(kc), _t(vc),
                              _t(pos) if rows else pos, d ** -0.5, window,
                              q_offsets=_t(offs),
                              **{k: _t(v) for k, v in sc.items()})
    want = JT._decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                jnp.asarray(vc), jnp.asarray(pos),
                                d ** -0.5, window, q_offsets=offs,
                                **{k: jnp.asarray(v) for k, v in sc.items()})
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("c,smax", [(4, 16), (3, 4096)])
def test_cache_write_per_row_chunks_matches_jax(quant, c, smax):
    """Row b's C rows land at [pos[b], pos[b] + C), in place; JAX's small
    cache takes its masked-select write, its large one the vmapped
    dynamic_update_slice (one result)."""
    rng = np.random.default_rng(1)
    b, h, d = 3, 2, 8
    k, v = (rng.standard_normal((b, h, c, d)).astype(np.float32)
            for _ in range(2))
    pos = np.array([0, 5, smax - c])
    shape = (b, h, smax, d)
    jcache = JT.mha_init_cache(
        type("M", (), dict(num_kv_heads=h, num_heads=h, head_dim=d,
                           window=None))(), b, smax, quantized=quant)
    cache = T._zero_cache(shape, torch.float32, quant, None)
    T._cache_write(cache, _t(k), _t(v), _t(pos))
    want = jax.jit(JT._cache_write)(jcache, jnp.asarray(k), jnp.asarray(v),
                                    jnp.asarray(pos))
    _check_caches([cache], [want], quant)
    for r in range(b):                      # nothing else was touched
        keep = np.ones(smax, bool)
        keep[pos[r]:pos[r] + c] = False
        assert not cache["k"][r, :, keep].float().abs().sum()


def test_cache_write_per_row_chunk_refuses_a_ring():
    cache = T._zero_cache((2, 1, 4, 8), torch.float32, False, None)
    x = torch.zeros(2, 1, 3, 8)
    with pytest.raises(ValueError, match="ring"):
        T._cache_write(cache, x, x, torch.tensor([1, 2]), ring=True)


@pytest.mark.parametrize("cfg,rows,quant", [
    (dict(num_kv_heads=2), True, False),
    (dict(num_kv_heads=2), False, True),
    (dict(rope=False), True, True),
    (dict(rope=False, num_kv_heads=1), False, False),
    (dict(window=6, num_kv_heads=2), True, False)])
def test_decode_chunk_matches_jax_and_prefill(cfg, rows, quant):
    """A prefill of 8 (rows at 8 and 5 when per-row), then a chunk of 5
    per row: logits 1e-4 and caches against JAX's ``decode_chunk``
    (under ``jit``); the chunk's logits also equal a prefill of the
    whole row (1e-4)."""
    jmodel, params, model = _models(3, **cfg)
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, 32, (2, 8))
    chunk = rng.integers(0, 32, (2, 5))
    pos = np.array([8, 5]) if rows else 8
    caches = model.init_cache(2, quantized=quant)
    with torch.no_grad():
        model.prefill(_t(prompt), caches)
        got = model.decode_chunk(_t(chunk), _t(pos) if rows else pos,
                                 caches)
    jc = jmodel.init_cache(2, quantized=quant)
    _, jc = jax.jit(jmodel.prefill)(params, jnp.asarray(prompt), jc)
    want, jc = jax.jit(jmodel.decode_chunk)(params, jnp.asarray(chunk),
                                            jnp.asarray(pos), jc)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-4)
    _check_caches(caches, jc, quant)
    if not quant:
        for r in range(2):
            p = int(pos[r]) if rows else pos
            whole = np.concatenate([prompt[r, :p], chunk[r]])[None]
            with torch.no_grad():
                ref = model(_t(whole))[0, p:]
            np.testing.assert_allclose(got[r].numpy(), ref.numpy(),
                                       atol=1e-4)


def test_attention_chunk_matches_jax_mha_apply_chunk():
    """One attention layer's chunk (GQA 4 on 2, RoPE) at per-row starts:
    its output and cache against ``mha_apply_chunk``."""
    mha = JT.MultiHeadAttention(32, 4, num_kv_heads=2, rope=True,
                                max_seq=32)
    params = mha.init(jax.random.PRNGKey(5))
    mine = T.MultiHeadAttention(32, 4, num_kv_heads=2, rope=True,
                                max_seq=32)
    load_jax_params(mine, jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 4, 32)).astype(np.float32)
    pos = np.array([3, 10])
    cache = mine.init_cache(2, 32)
    with torch.no_grad():
        y = mine.chunk(_t(x), cache, _t(pos))
    jy, jc = JT.mha_apply_chunk(mha, params, jnp.asarray(x),
                                JT.mha_init_cache(mha, 2, 32),
                                jnp.asarray(pos))
    np.testing.assert_allclose(y.numpy(), _np(jy), atol=1e-5)
    _check_caches([cache], [jc], False)


def test_chunk_refuses_ring_caches():
    _, _, model = _models(0, window=4, max_seq=32)
    caches = model.init_cache(1, ring=True)
    with pytest.raises(ValueError, match="ring"):
        model.decode_chunk(torch.zeros(1, 3, dtype=torch.long), 2, caches)


def test_generate_continued_matches_one_shot_and_jax():
    """Turn 1 prefills half the prompt; ``generate_continued`` takes the
    rest: the full prompt's generation, as in JAX."""
    jmodel, params, model = _models(0)
    p0 = np.random.default_rng(1).integers(0, 32, (3, 8))
    ref = model.generate(_t(p0), 6)
    _, caches = model.generate(_t(p0[:, :4]), 1, return_cache=True)
    t2 = model.generate_continued(_t(p0[:, 4:]), 6, caches, past_len=4)
    np.testing.assert_array_equal(_np(torch.cat([_t(p0[:, :4]), t2], 1)),
                                  _np(ref))
    _, jc = jmodel.generate(params, jnp.asarray(p0[:, :4]), 1,
                            return_cache=True)
    want = jmodel.generate_continued(params, jnp.asarray(p0[:, 4:]), 6, jc,
                                     past_len=4)
    np.testing.assert_array_equal(_np(t2), _np(want))


def test_generate_continued_chained_turns_quantized_cache():
    """Three chained turns through one int8 cache equal one long
    generation, and JAX's chain."""
    jmodel, params, model = _models(2, num_kv_heads=2)
    p0 = np.random.default_rng(3).integers(0, 32, (2, 8))

    def chain(gen, cont, start):
        t1, c = gen(start, 4)
        t2, c = cont(t1[:, -1:], 3, c, t1.shape[1] - 1, True)
        cur = np.concatenate([_np(t1), _np(t2)[:, 1:]], 1)
        t3 = cont(t2[:, -1:], 3, c, cur.shape[1] - 1, False)
        return np.concatenate([cur, _np(t3)[:, 1:]], 1)

    got = chain(lambda p, n: model.generate(_t(p), n, quantized_cache=True,
                                            return_cache=True),
                lambda p, n, c, past, rc: model.generate_continued(
                    p, n, c, past_len=past, return_cache=rc), p0)
    want = chain(lambda p, n: jmodel.generate(
        params, jnp.asarray(p), n, quantized_cache=True, return_cache=True),
        lambda p, n, c, past, rc: jmodel.generate_continued(
            params, p, n, c, past_len=past, return_cache=rc), p0)
    full = model.generate(_t(p0), 10, quantized_cache=True)
    np.testing.assert_array_equal(got, _np(full))
    np.testing.assert_array_equal(got, want)


def test_generate_continued_eos_and_contracts():
    """An eos never emitted changes nothing; an emitted one pads after
    it, as JAX; return_cache with eos and empty turns raise."""
    jmodel, params, model = _models(4, vocab_size=16, depth=1,
                                    num_heads=2, max_seq=48, rope=False)
    rng = np.random.default_rng(5)
    p0 = rng.integers(1, 16, (2, 6))
    nxt = rng.integers(1, 16, (2, 2))

    def turn(**kw):
        _, c = model.generate(_t(p0), 1, return_cache=True)
        return _np(model.generate_continued(_t(nxt), 5, c, past_len=6,
                                            **kw))

    plain = turn()
    np.testing.assert_array_equal(turn(eos_token=0), plain)
    eos = int(plain[0, 3])
    _, jc = jmodel.generate(params, jnp.asarray(p0), 1, return_cache=True)
    want = jmodel.generate_continued(params, jnp.asarray(nxt), 5, jc,
                                     past_len=6, eos_token=eos, pad_token=1)
    np.testing.assert_array_equal(turn(eos_token=eos, pad_token=1),
                                  _np(want))
    _, c = model.generate(_t(p0), 1, return_cache=True)
    with pytest.raises(ValueError, match="partially filled"):
        model.generate_continued(_t(nxt), 4, c, past_len=6, eos_token=3,
                                 return_cache=True)
    with pytest.raises(ValueError, match="max_new"):
        model.generate_continued(_t(nxt), 0, c, past_len=6)
    with pytest.raises(ValueError, match="max_seq"):
        model.generate_continued(_t(nxt), 41, c, past_len=6)
