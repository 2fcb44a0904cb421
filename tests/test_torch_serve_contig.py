"""Port of the serving engine's contiguous-cache mode and its int8 KV
caches (taper_tpu_torch/serve.py, ``pool_blocks=None`` and
``quantized_cache=True``) against the JAX package's ``ServingEngine``
with the pallas backend (its kernels interpreted on the CPU).

JAX draws the weights; they reach the port through numpy.  Prompts come
from numpy with a fixed seed.  Greedy tokens must be equal (logits agree
to 1e-4 in f32 and 1e-3 over int8 caches, test_torch_cache.py; the seeds
leave no near-tied argmax).  One request runs to ``max_seq``, so its
frozen row steps past it inside the last decode block.
"""

import jax
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
ENGINE = dict(slots=2, prompt_pad=16, decode_block=3)
PAGED = dict(pool_blocks=12, block_size=8)


def _models(seed=0):
    jmodel = jmodels.TinyGPT(**CFG)
    params = jmodel.init(jax.random.PRNGKey(seed))
    model = load_jax_params(TinyGPT(**CFG),
                            jax.tree.map(np.asarray, params))
    return jmodel, params, model


def _requests(seed=0):
    rng = np.random.default_rng(seed)
    prompts = [list(rng.integers(0, 32, n)) for n in (5, 16, 9, 12, 3)]
    return prompts, [4, 32, 9, 1, 7]


def _serve(engine, prompts, max_new):
    ids = [engine.submit(p, m) for p, m in zip(prompts, max_new)]
    out = engine.run()
    return [out[i] for i in ids]


@pytest.mark.parametrize("quant,paged", [(False, False), (True, False),
                                         (True, True)])
def test_engine_matches_jax_engine(quant, paged):
    jmodel, params, model = _models(seed=1)
    prompts, max_new = _requests(seed=1)
    kw = dict(ENGINE, quantized_cache=quant, **(PAGED if paged else {}))
    eng = ServingEngine(model, device="cpu", **kw)
    out = _serve(eng, prompts, max_new)
    with jops.use_backend("pallas"):
        ref = _serve(jserve.ServingEngine(jmodel, params, **kw), prompts,
                     max_new)
    assert out == ref
    assert [len(t) for t in out] == max_new
    st = eng.stats()
    assert st["completed"] == st["admitted"] == len(prompts)
    assert ("pool_blocks_free" in st) == paged


def test_paged_int8_equals_contiguous_int8():
    """The port's two int8 caches hold the same codes and scales and
    attend the same way (tests/test_paged_model.py holds this in JAX)."""
    _, _, model = _models(seed=2)
    prompts, max_new = _requests(seed=2)
    outs = [_serve(ServingEngine(model, device="cpu", quantized_cache=True,
                                 **ENGINE, **kw), prompts, max_new)
            for kw in (PAGED, {})]
    assert outs[0] == outs[1]


def test_engine_caches_are_int8_with_scales():
    _, _, model = _models(seed=3)
    for kw in (PAGED, {}):
        eng = ServingEngine(model, device="cpu", quantized_cache=True,
                            **ENGINE, **kw)
        cache = eng._caches[0]
        assert cache["k"].dtype == cache["v"].dtype == torch.int8
        assert cache["k_scale"].dtype == torch.float32
        assert cache["k_scale"].shape == cache["k"].shape[:3]
        if not kw:
            assert cache["k"].shape == (2, 2, CFG["max_seq"], 8)
