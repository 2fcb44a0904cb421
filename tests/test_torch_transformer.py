"""Port of the transformer layers and TinyGPT's serving paths
(taper_tpu_torch/nn/transformer.py, models/transformer.py,
utils/convert.py) against the JAX package, with the pallas backend (its
kernels interpreted on the CPU).

JAX draws the parameters (``init``); they reach the port through numpy
and ``load_jax_params``.  Token ids and activations come from numpy with
a fixed seed.  Tolerances: 1e-5 for single layers, 1e-4 for logits
(both packages run exact f32 on the CPU and differ in summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taper_tpu import models as jmodels
from taper_tpu import ops as jops
from taper_tpu.nn import transformer as JT
from taper_tpu_torch.models import TinyGPT
from taper_tpu_torch.nn import transformer as T
from taper_tpu_torch.utils.convert import load_jax_params

torch.set_num_threads(1)

TOL = 1e-5
LOGIT_TOL = 1e-4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _check(out, ref, tol=TOL):
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("norm", ["layer", "rms"])
def test_norms_match_jax(norm):
    jmod = JT.LayerNorm(16) if norm == "layer" else JT.RMSNorm(16)
    params = {k: v * 1.5 + 0.1 for k, v in jmod.init(None).items()}
    mod = T.LayerNorm(16) if norm == "layer" else T.RMSNorm(16)
    load_jax_params(mod, _np_tree(params))
    x = _x((3, 5, 16)) * 3 + 1
    _check(mod(torch.from_numpy(x)), jmod.apply(params, jnp.asarray(x)))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    out = mod(xb)
    assert out.dtype == torch.bfloat16
    ref = jmod.apply(params, jnp.asarray(x, jnp.bfloat16))
    _check(out, ref, tol=1e-2)


def test_embedding_matches_jax():
    jmod = JT.Embedding(11, 8)
    params = jmod.init(jax.random.PRNGKey(0))
    mod = load_jax_params(T.Embedding(11, 8), _np_tree(params))
    ids = np.random.default_rng(0).integers(0, 11, (2, 6))
    _check(mod(torch.from_numpy(ids)), jmod.apply(params, jnp.asarray(ids)))


def test_rope_matches_jax_at_scalar_and_per_row_offsets():
    cos, sin = T.rope_angles(8, 32)
    jcos, jsin = JT.rope_angles(8, 32)
    _check(cos, jcos)
    x = _x((2, 3, 5, 8))
    _check(T.apply_rope(torch.from_numpy(x), cos, sin, 4),
           JT.apply_rope(jnp.asarray(x), jcos, jsin, offset=4))
    x1 = _x((3, 2, 1, 8), seed=1)
    pos = np.array([0, 7, 31], np.int32)
    _check(T.apply_rope(torch.from_numpy(x1), cos, sin, torch.from_numpy(pos)),
           JT.apply_rope(jnp.asarray(x1), jcos, jsin, offset=jnp.asarray(pos)))


@pytest.mark.parametrize("kv_heads", [4, 2])
def test_attention_layer_matches_jax(kv_heads):
    jmod = JT.MultiHeadAttention(32, 4, rope=True, max_seq=16,
                                 num_kv_heads=kv_heads)
    params = jmod.init(jax.random.PRNGKey(kv_heads))
    mod = load_jax_params(
        T.MultiHeadAttention(32, 4, rope=True, max_seq=16,
                             num_kv_heads=kv_heads), _np_tree(params))
    x = _x((2, 9, 32), seed=kv_heads)
    with jops.use_backend("pallas"):
        ref = jmod.apply(params, jnp.asarray(x))
    _check(mod(torch.from_numpy(x)), ref)


@pytest.mark.parametrize("mlp_act", ["gelu", "swiglu"])
def test_mlp_and_block_match_jax(mlp_act):
    jblk = JT.TransformerBlock(32, 4, rope=True, max_seq=16,
                               num_kv_heads=2, mlp_act=mlp_act)
    params = jblk.init(jax.random.PRNGKey(3))
    blk = load_jax_params(
        T.TransformerBlock(32, 4, rope=True, max_seq=16, num_kv_heads=2,
                           mlp_act=mlp_act), _np_tree(params))
    x = _x((2, 7, 32), seed=3)
    with jops.use_backend("pallas"):
        ref_mlp = jblk.mlp.apply(params["mlp"], jnp.asarray(x))
        ref_blk = jblk.apply(params, jnp.asarray(x))
    _check(blk.mlp(torch.from_numpy(x)), ref_mlp)
    _check(blk(torch.from_numpy(x)), ref_blk)


CFG = dict(vocab_size=48, dim=32, depth=2, num_heads=4, max_seq=32)


def _models(seed=0, **kw):
    cfg = dict(CFG, **kw)
    jmodel = jmodels.TinyGPT(**cfg)
    params = jmodel.init(jax.random.PRNGKey(seed))
    model = load_jax_params(TinyGPT(**cfg), _np_tree(params))
    return jmodel, params, model


@pytest.mark.parametrize("kw", [dict(rope=True, num_kv_heads=2),
                                dict(rope=False, tied_head=False)])
def test_tinygpt_logits_match_jax(kw):
    jmodel, params, model = _models(**kw)
    toks = np.random.default_rng(1).integers(0, 48, (2, 11))
    with jops.use_backend("pallas"):
        ref = jmodel.apply(params, jnp.asarray(toks, jnp.int32))
    _check(model(torch.from_numpy(toks)), ref, LOGIT_TOL)


def test_prefill_logits_and_cache_match_jax():
    jmodel, params, model = _models(seed=2, rope=True, num_kv_heads=2)
    toks = np.random.default_rng(2).integers(0, 48, (1, 12))
    with jops.use_backend("pallas"):
        ref, caches = jmodel.prefill(params, jnp.asarray(toks, jnp.int32),
                                     jmodel.init_cache(1))
    mine = model.init_cache(1)
    logits = model.prefill(torch.from_numpy(toks), mine)
    _check(logits, ref, LOGIT_TOL)
    for c, jc in zip(mine, caches):
        _check(c["k"], jc["k"])
        _check(c["v"], jc["v"])


@pytest.mark.parametrize("kw", [dict(rope=True, num_kv_heads=2),
                                dict(rope=False)])
def test_paged_prefill_and_decode_logits_match_jax(kw):
    """prefill_paged into fragmented tables, then three decode steps with
    the rows at different positions, against JAX's pallas paged path."""
    jmodel, params, model = _models(seed=4, **kw)
    rng = np.random.default_rng(4)
    bs, n_blocks, slots = 8, 11, 2
    mb = -(-CFG["max_seq"] // bs)
    tables = rng.permutation(n_blocks)[:slots * mb].reshape(slots, mb)
    tables = tables.astype(np.int32)
    prompts = rng.integers(0, 48, (slots, 16))
    lens = np.array([16, 9], np.int32)
    pools = model.init_paged_cache(n_blocks, bs)
    jpools = jmodel.init_paged_cache(n_blocks, bs)
    with jops.use_backend("pallas"):
        prefill = jax.jit(jmodel.prefill_paged)
        decode = jax.jit(jmodel.decode_step_paged)
        for i in range(slots):
            ref, jpools = prefill(
                params, jnp.asarray(prompts[i:i + 1], jnp.int32), jpools,
                jnp.asarray(tables[i:i + 1]))
            out = model.prefill_paged(torch.from_numpy(prompts[i:i + 1]),
                                      pools, torch.from_numpy(tables[i:i + 1]))
            _check(out, ref, LOGIT_TOL)
        pos, tok = lens.copy(), rng.integers(0, 48, slots)
        for _ in range(3):
            ref, jpools = decode(
                params, jnp.asarray(tok, jnp.int32), jnp.asarray(pos),
                jpools, jnp.asarray(tables))
            out = model.decode_step_paged(
                torch.from_numpy(tok), torch.from_numpy(pos), pools,
                torch.from_numpy(tables))
            _check(out, ref, LOGIT_TOL)
            tok, pos = np.asarray(ref).argmax(-1), pos + 1
    for pool, jpool in zip(pools, jpools):
        _check(pool["k"], jpool["k"])
        _check(pool["v"], jpool["v"])


def test_bf16_trunk_logits_match_jax():
    """compute_dtype=bfloat16: the same rounding points as JAX (bf16
    activations and weights, f32 accumulation, f32 norms and logits);
    bf16 keeps 8 bits, hence 2e-2."""
    jmodel, params, model = _models(seed=5, rope=True,
                                    compute_dtype=jnp.bfloat16)
    model.compute_dtype = torch.bfloat16
    toks = np.random.default_rng(5).integers(0, 48, (1, 10))
    with jops.use_backend("pallas"):
        ref, _ = jmodel.prefill(params, jnp.asarray(toks, jnp.int32),
                                jmodel.init_cache(1))
    logits = model.prefill(torch.from_numpy(toks), model.init_cache(1))
    _check(logits, ref, 2e-2)


def test_cast_projections_keeps_the_numbers():
    _, _, model = _models(seed=6, rope=True, compute_dtype=None)
    model.compute_dtype = torch.bfloat16
    toks = torch.from_numpy(np.random.default_rng(6).integers(0, 48, (1, 7)))
    before = model(toks)
    model.cast_projections(torch.bfloat16)
    assert model.blocks[0].attn.wq.dtype == torch.bfloat16
    assert model.tok.w.dtype == torch.float32
    assert torch.equal(model(toks), before)


def test_modules_reject_bad_shapes():
    with pytest.raises(ValueError, match="divide"):
        T.MultiHeadAttention(30, 4)
    with pytest.raises(ValueError, match="divide"):
        T.MultiHeadAttention(32, 4, num_kv_heads=3)
    with pytest.raises(ValueError, match="mlp_act"):
        T.TransformerBlock(32, 4, mlp_act="relu")
    cos, sin = T.rope_angles(8, 16)
    with pytest.raises(ValueError, match="single-token"):
        T.apply_rope(torch.zeros(2, 1, 3, 8), cos, sin, torch.zeros(2))
    _, _, model = _models(seed=8)
    with pytest.raises(ValueError, match="max_seq"):
        model(torch.zeros(1, CFG["max_seq"] + 1, dtype=torch.int64))


def test_load_jax_params_rejects_mismatched_trees():
    _, params, model = _models(seed=7)
    tree = _np_tree(params)
    tree["ln_f"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="extra"):
        load_jax_params(model, tree)
    tree = _np_tree(params)
    tree["tok"]["w"] = tree["tok"]["w"][:, :4]
    with pytest.raises(ValueError, match="tok.w"):
        load_jax_params(model, tree)
