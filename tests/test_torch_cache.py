"""Port of the contiguous KV cache (taper_tpu_torch/models/transformer.py
``init_cache``/``prefill``/``decode_step``, nn/transformer.py
``_cache_write``/``_decode_attention``) against the JAX package's, in f32,
bf16 and int8, with scalar and per-row positions, MHA and GQA, RoPE and
learned positions.

JAX draws the parameters; they reach the port through numpy.  JAX's
prefill and decode run under ``jit`` with the pallas backend, as its
serving engine runs them (``kv_quantize`` follows ``jit``, see
test_torch_kv_quant.py).  Tolerances: f32 logits 1e-4 and cache rows
1e-5 (exact f32 on both sides, other summation orders); bf16 2e-2 (8
bits); int8 logits 1e-3: both packages quantize K/V that differ in the
last f32 bit, so a code at a rounding tie may land one step apart (held:
at most one step, on under 1% of the codes; scales within 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taper_tpu import models as jmodels
from taper_tpu import ops as jops
from taper_tpu_torch.models import TinyGPT
from taper_tpu_torch.nn import transformer as T
from taper_tpu_torch.utils.convert import load_jax_params

torch.set_num_threads(1)

CFG = dict(vocab_size=48, dim=32, depth=2, num_heads=4, max_seq=24)
P = 8
LOGIT_TOL = {"f32": 1e-4, "bf16": 2e-2, "int8": 1e-3}


def _models(seed, kind, **kw):
    cfg = dict(CFG, **kw)
    bf16 = kind == "bf16"
    jmodel = jmodels.TinyGPT(**cfg, compute_dtype=jnp.bfloat16 if bf16
                             else None)
    params = jmodel.init(jax.random.PRNGKey(seed))
    model = load_jax_params(TinyGPT(**cfg), jax.tree.map(np.asarray,
                                                         params))
    if bf16:
        model.compute_dtype = torch.bfloat16
    return jmodel, params, model


def _check_caches(mine, ref, kind):
    for c, jc in zip(mine, ref):
        assert set(c) == set(jc)
        for name in c:
            got = c[name].float().numpy()
            want = np.asarray(jc[name].astype(jnp.float32))
            if name.endswith("scale"):
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
            elif kind == "int8":
                assert c[name].dtype == torch.int8
                diff = np.abs(got - want)
                assert diff.max() <= 1 and (diff > 0).mean() < 0.01
            else:
                tol = 2e-2 if kind == "bf16" else 1e-5
                np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("kind,kw,rows", [
    ("f32", dict(rope=True, num_kv_heads=2), True),
    ("f32", dict(rope=False), False),
    ("bf16", dict(rope=True), False),
    ("bf16", dict(rope=False, num_kv_heads=2), True),
    ("int8", dict(rope=True, num_kv_heads=2), True),
    ("int8", dict(rope=False), False)])
@torch.no_grad()
def test_prefill_and_decode_steps_match_jax(kind, kw, rows):
    """A two-row prefill, then three decode steps with argmax feedback;
    ``rows``: per-row positions (the rows' prompts end at 8 and 5),
    else one scalar position for both."""
    jmodel, params, model = _models(3, kind, **kw)
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, 48, (2, P))
    quant = kind == "int8"
    with jops.use_backend("pallas"):
        jcaches = jmodel.init_cache(2, quantized=quant)
        ref, jcaches = jax.jit(jmodel.prefill)(
            params, jnp.asarray(prompt, jnp.int32), jcaches)
        caches = model.init_cache(2, quantized=quant)
        out = model.prefill(torch.from_numpy(prompt), caches)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                                   rtol=LOGIT_TOL[kind],
                                   atol=LOGIT_TOL[kind])
        _check_caches(caches, jcaches, kind)
        pos = np.array([P, 5], np.int32) if rows else P
        tok = np.asarray(ref)[np.arange(2), np.array([P - 1, 4]) if rows
                              else P - 1].argmax(-1)
        step = jax.jit(jmodel.decode_step)
        for i in range(3):
            ref, jcaches = step(params, jnp.asarray(tok, jnp.int32),
                                jnp.asarray(pos, jnp.int32), jcaches)
            # a scalar position as an int, then as a 0-d tensor
            out = model.decode_step(
                torch.from_numpy(tok), torch.from_numpy(pos) if rows
                else (pos if i == 0 else torch.tensor(pos)), caches)
            np.testing.assert_allclose(out.detach().numpy(),
                                       np.asarray(ref),
                                       rtol=LOGIT_TOL[kind],
                                       atol=LOGIT_TOL[kind])
            tok, pos = np.asarray(ref).argmax(-1), pos + 1
    _check_caches(caches, jcaches, kind)


@pytest.mark.parametrize("quant", [False, True])
@torch.no_grad()
def test_a_row_stepping_past_max_seq(quant):
    """A frozen serving row keeps stepping after it finished: its position
    reaches and passes ``max_seq``.  The port clamps the write (XLA's
    ``dynamic_update_slice`` does the same), so the step neither raises
    nor writes out of bounds, and the other row is untouched: its logits
    and cache equal JAX's."""
    jmodel, params, model = _models(5, "int8" if quant else "f32",
                                    rope=True, num_kv_heads=2)
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, 48, (2, P))
    smax = CFG["max_seq"]
    with jops.use_backend("pallas"):
        jcaches = jmodel.init_cache(2, quantized=quant)
        _, jcaches = jax.jit(jmodel.prefill)(
            params, jnp.asarray(prompt, jnp.int32), jcaches)
        caches = model.init_cache(2, quantized=quant)
        model.prefill(torch.from_numpy(prompt), caches)
        step = jax.jit(jmodel.decode_step)
        tok = np.array([3, 4])
        for pos in ([smax - 3, smax - 1], [smax - 2, smax],
                    [smax - 1, smax + 5]):
            pos = np.asarray(pos, np.int32)
            ref, jcaches = step(params, jnp.asarray(tok, jnp.int32),
                                jnp.asarray(pos), jcaches)
            out = model.decode_step(torch.from_numpy(tok),
                                    torch.from_numpy(pos), caches)
            assert torch.isfinite(out).all()
            tol = LOGIT_TOL["int8" if quant else "f32"]
            np.testing.assert_allclose(out[0].numpy(), np.asarray(ref)[0],
                                       rtol=tol, atol=tol)
    kind = "int8" if quant else "f32"
    _check_caches([{k: v[:1] for k, v in c.items()} for c in caches],
                  [{k: v[:1] for k, v in c.items()} for c in jcaches], kind)


def test_cache_layer_functions_match_jax():
    """``_cache_write`` at a scalar start (prefill rows) and at per-row
    positions, and ``_decode_attention`` over f32 and int8 caches with
    GQA folded into the query dim."""
    from taper_tpu.nn import transformer as JT
    rng = np.random.default_rng(9)
    b, kvh, s, d = 2, 2, 12, 16
    for quant in (False, True):
        mha = JT.MultiHeadAttention(64, 4, num_kv_heads=kvh, max_seq=s)
        jc = JT.mha_init_cache(mha, b, s, quantized=quant)
        c = T.MultiHeadAttention(64, 4, num_kv_heads=kvh,
                                 max_seq=s).init_cache(b, s, quantized=quant)
        k, v = (rng.standard_normal((b, kvh, 5, d)).astype(np.float32)
                for _ in range(2))
        jc = jax.jit(JT._cache_write)(jc, jnp.asarray(k), jnp.asarray(v),
                                      jnp.int32(3))
        T._cache_write(c, torch.from_numpy(k), torch.from_numpy(v), 3)
        k1, v1 = (rng.standard_normal((b, kvh, 1, d)).astype(np.float32)
                  for _ in range(2))
        pos = np.array([8, 2], np.int32)
        jc = jax.jit(JT._cache_write)(jc, jnp.asarray(k1), jnp.asarray(v1),
                                      jnp.asarray(pos))
        T._cache_write(c, torch.from_numpy(k1), torch.from_numpy(v1),
                       torch.from_numpy(pos))
        for name in c:           # the same inputs: bit for bit
            np.testing.assert_array_equal(c[name].numpy(),
                                          np.asarray(jc[name]))
        q = rng.standard_normal((b, kvh, 2, d)).astype(np.float32)
        sc = {"k_scale": jc["k_scale"], "v_scale": jc["v_scale"]} \
            if quant else {}
        ref = JT._decode_attention(jnp.asarray(q), jc["k"], jc["v"],
                                   jnp.asarray(pos), 0.25, **sc)
        out = T._decode_attention(torch.from_numpy(q), c["k"], c["v"],
                                  torch.from_numpy(pos), 0.25,
                                  k_scale=c.get("k_scale"),
                                  v_scale=c.get("v_scale"))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)
    # a window masks the keys at or before pos - window too; a ring cache
    # (tests/test_torch_window_model.py) needs a window model
    ref = JT._decode_attention(jnp.asarray(q), jc["k"], jc["v"],
                               jnp.asarray(pos), 0.25, window=4, **sc)
    out = T._decode_attention(torch.from_numpy(q), c["k"], c["v"],
                              torch.from_numpy(pos), 0.25, window=4,
                              k_scale=c.get("k_scale"),
                              v_scale=c.get("v_scale"))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ValueError, match="window"):
        TinyGPT(**CFG).init_cache(1, ring=True)
    assert TinyGPT(**CFG, window=5).init_cache(1, ring=True)[0]["k"].shape[
        2] == 5
