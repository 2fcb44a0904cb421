"""Port of the paged engine's shared system prompt
(taper_tpu_torch/serve.py ``ServingEngine(system_prompt=)`` over
models/transformer.py ``prefill_paged_continued``) against the JAX
package's.

JAX draws the weights; they reach the port through numpy.  Prompts come
from seeded numpy.  Tolerances: logits 1e-4 and f32 pool rows 1e-5
(exact f32 on both sides); int8 pool codes at most one step apart on
under 1% of the entries (JAX runs under ``jit``, where XLA folds
``kv_quantize``'s ``/ 127`` as the port does).  Greedy tokens must be
equal: the seeds were checked to leave no near-tied argmax at f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taper_tpu import models as jmodels
from taper_tpu import ops as jops
from taper_tpu import serve as jserve
from taper_tpu_torch.models import TinyGPT
from taper_tpu_torch.serve import ServingEngine
from taper_tpu_torch.utils.convert import load_jax_params

torch.set_num_threads(1)

CFG = dict(vocab_size=32, dim=32, depth=2, num_heads=4, num_kv_heads=2,
           max_seq=48, rope=True)


def _models(seed=0, **kw):
    cfg = dict(CFG, **kw)
    jmodel = jmodels.TinyGPT(**cfg)
    params = jmodel.init(jax.random.PRNGKey(seed))
    model = load_jax_params(TinyGPT(**cfg), jax.tree.map(np.asarray,
                                                         params))
    return jmodel, params, model


def _np(x):
    return np.asarray(x.cpu() if torch.is_tensor(x) else x)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("rope", [True, False])
def test_prefill_paged_continued_matches_jax_and_prefill_paged(quant, rope):
    """A 16-token prefix prefilled into 2 blocks of 8; two rows' tables
    alias them and own 2 blocks each; a chunk of 7 at offset 16: logits
    and pools against JAX's (under ``jit``), the logits also against
    ``prefill_paged`` of prefix + chunk, and the prefix blocks
    untouched."""
    jmodel, params, model = _models(1, rope=rope)
    rng = np.random.default_rng(1)
    prefix = rng.integers(0, 32, (1, 16))
    chunk = rng.integers(0, 32, (2, 7))
    tables = np.array([[0, 1, 2, 3, 9, 9], [0, 1, 4, 5, 9, 9]], np.int32)
    pools = model.init_paged_cache(10, 8, quantized=quant)
    jpools = jmodel.init_paged_cache(10, 8, quantized=quant)
    with torch.no_grad():
        model.prefill_paged(torch.from_numpy(prefix), pools,
                            torch.tensor([[0, 1]], dtype=torch.int32))
        before = [{k: v[:2].clone() for k, v in p.items()} for p in pools]
        got = model.prefill_paged_continued(torch.from_numpy(chunk), pools,
                                            torch.from_numpy(tables), 16)
    _, jpools = jax.jit(jmodel.prefill_paged)(
        params, jnp.asarray(prefix), jpools, jnp.asarray([[0, 1]]))
    want, jpools = jax.jit(jmodel.prefill_paged_continued,
                           static_argnums=4)(
        params, jnp.asarray(chunk), jpools, jnp.asarray(tables), 16)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-4)
    for p, jp, b in zip(pools, jpools, before):
        for name in p:
            g, w = p[name][:6].float().numpy(), _np(jp[name][:6]).astype(
                np.float32)
            if quant and name in ("k", "v"):
                diff = np.abs(g - w)
                assert diff.max() <= 1 and (diff > 0).mean() < 0.01
            else:
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
            assert torch.equal(p[name][:2], b[name])     # shared, unwritten
    if not quant:
        for r in range(2):
            fresh = model.init_paged_cache(10, 8)
            with torch.no_grad():
                ref = model.prefill_paged(
                    torch.from_numpy(np.concatenate([prefix[0], chunk[r]])
                                     [None]), fresh,
                    torch.from_numpy(tables[r:r + 1]))
            np.testing.assert_allclose(got[r].numpy(), ref[0, 16:].numpy(),
                                       atol=1e-4)


@pytest.mark.parametrize("quant", [False, True])
def test_engine_with_system_prompt_matches_jax_engine(quant):
    """The prefix blocks are allocated once and aliased by every slot;
    the tokens equal JAX's engine with the same system prompt (pallas
    backend) and the port's own generation of system + request."""
    jmodel, params, model = _models(6)
    rng = np.random.default_rng(6)
    system = list(rng.integers(0, 32, 16))      # 2 blocks of 8
    users = [list(rng.integers(0, 32, rng.integers(2, 8)))
             for _ in range(5)]
    kw = dict(slots=2, prompt_pad=8, decode_block=3, pool_blocks=12,
              block_size=8, system_prompt=system, quantized_cache=quant)
    eng = ServingEngine(model, device="cpu", **kw)
    assert eng._alloc.available == 9 and len(eng._prefix_blocks) == 2
    ids = [eng.submit(u, max_new=6) for u in users]
    out = eng.run()
    with jops.use_backend("pallas"):
        jeng = jserve.ServingEngine(jmodel, params, **kw)
        jids = [jeng.submit(u, max_new=6) for u in users]
        jout = jeng.run()
    for rid, jid, u in zip(ids, jids, users):
        assert out[rid] == jout[jid]
        ref = model.generate(torch.tensor([system + u]), 6,
                             quantized_cache=quant)
        assert out[rid] == _np(ref[0, len(system) + len(u):]).tolist()
    assert eng._alloc.available == 9
    st = eng.stats()
    assert st["pool_blocks_total"] == st["pool_blocks_free"] == 9


def test_engine_system_prompt_contracts():
    """JAX's assertions as ValueErrors: the prefix's alignment, the paged
    mode, the reach past max_seq, a request that can never fit past the
    prefix's blocks."""
    _, _, model = _models(0)
    kw = dict(slots=2, prompt_pad=8, decode_block=2, pool_blocks=12,
              block_size=8, device="cpu")
    with pytest.raises(ValueError, match="multiple of block_size"):
        ServingEngine(model, system_prompt=[1, 2, 3], **kw)
    with pytest.raises(ValueError, match="paged"):
        ServingEngine(model, system_prompt=[1] * 8, device="cpu")
    with pytest.raises(ValueError, match="max_seq"):
        ServingEngine(model, system_prompt=[1] * 48, **kw)
    eng = ServingEngine(model, system_prompt=[1] * 16,
                        **dict(kw, block_size=4))
    assert eng._alloc.available == 12 - 1 - 4
    with pytest.raises(ValueError, match="max_seq"):
        eng.submit([1] * 8, max_new=25)
    small = ServingEngine(model, system_prompt=[1] * 16,
                          **dict(kw, block_size=4, pool_blocks=9))
    with pytest.raises(ValueError, match="never be admitted"):
        small.submit([1] * 8, max_new=20)      # 9 blocks past the prefix
