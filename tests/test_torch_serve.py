"""Port of the paged serving engine (taper_tpu_torch/serve.py) against the
JAX package's ``ServingEngine(pool_blocks=...)`` with the pallas backend
(its GEMM and paged-decode kernels interpreted on the CPU).

JAX draws the weights; they reach the port through numpy.  Prompts come
from numpy with a fixed seed.  Greedy tokens must be equal: the seeds
were checked to leave no near-tied argmax at f32 (logits agree to 1e-4,
test_torch_transformer.py).
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taper_tpu import models as jmodels
from taper_tpu import ops as jops
from taper_tpu import serve as jserve
from taper_tpu.models.transformer import _filter_logits as jfilter
from taper_tpu_torch.models import TinyGPT
from taper_tpu_torch.models.transformer import _filter_logits, _sample
from taper_tpu_torch.serve import (BlockAllocator, ServingEngine,
                                   offline_serve)
from taper_tpu_torch.utils.convert import load_jax_params

torch.set_num_threads(1)

CFG = dict(vocab_size=32, dim=32, depth=2, num_heads=4, num_kv_heads=2,
           max_seq=48, rope=True)
ENGINE = dict(slots=2, prompt_pad=16, decode_block=3, block_size=8)


def _models(seed=0):
    jmodel = jmodels.TinyGPT(**CFG)
    params = jmodel.init(jax.random.PRNGKey(seed))
    model = load_jax_params(TinyGPT(**CFG),
                            jax.tree.map(np.asarray, params))
    return jmodel, params, model


def _requests(n=5, seed=0):
    rng = np.random.default_rng(seed)
    prompts = [list(rng.integers(0, 32, rng.integers(3, 17)))
               for _ in range(n)]
    max_new = [(4, 9, 1)[i % 3] for i in range(n)]
    return prompts, max_new


def _serve(engine, prompts, max_new, **kw):
    ids = [engine.submit(p, m, **kw) for p, m in zip(prompts, max_new)]
    out = engine.run()
    return [out[i] for i in ids]


def test_engine_matches_jax_engine():
    """Greedy tokens, eos retirement, admission deferral (a pool that
    holds one long request at a time) and slot reuse, in one run of
    each engine."""
    jmodel, params, model = _models()
    prompts, max_new = _requests()
    probe = _serve(ServingEngine(model, pool_blocks=12, device="cpu",
                                 **ENGINE), prompts, max_new)
    eos = probe[1][4]           # ends request 1 early (9 tokens asked)
    kw = dict(ENGINE, pool_blocks=6, eos_token=eos)
    eng = ServingEngine(model, device="cpu", **kw)
    out = _serve(eng, prompts, max_new)
    with jops.use_backend("pallas"):
        ref = _serve(jserve.ServingEngine(jmodel, params, **kw), prompts,
                     max_new)
    assert out == ref
    assert len(out[1]) < 9 and out[1][-1] == eos
    assert [len(t) for t in out] == [
        len(t) if eos not in t else t.index(eos) + 1 for t in probe]
    st = eng.stats()
    assert st["completed"] == st["admitted"] == 5
    assert st["admission_deferrals"] > 0
    assert st["pool_blocks_free"] == st["pool_blocks_total"] == 5
    assert st["active_slots"] == 0 and st["queued"] == 0


def test_sampled_rows_mix_with_greedy_rows():
    """top_k=1 or top_p=0 sampling can only draw the argmax, so those
    rows reproduce the greedy tokens while a free sampler shares the
    batch; the free sampler stays in the vocabulary and its budget."""
    _, _, model = _models(seed=1)
    prompts, max_new = _requests(4, seed=1)
    greedy = _serve(ServingEngine(model, pool_blocks=12, device="cpu",
                                  **ENGINE), prompts, max_new)
    eng = ServingEngine(model, pool_blocks=12, seed=3, device="cpu",
                        **ENGINE)
    ids = [eng.submit(prompts[0], max_new[0], temperature=0.7, top_k=1),
           eng.submit(prompts[1], max_new[1], temperature=1.3, top_p=0.0),
           eng.submit(prompts[2], max_new[2]),
           eng.submit(prompts[3], max_new[3], temperature=1.0, top_k=5,
                      top_p=0.9)]
    out = eng.run()
    assert [out[i] for i in ids[:3]] == greedy[:3]
    free = out[ids[3]]
    assert len(free) == max_new[3] and all(0 <= t < 32 for t in free)


def test_filter_logits_matches_jax():
    logits = np.random.default_rng(2).standard_normal((3, 32)).astype(
        np.float32)
    for kw in (dict(top_k=4), dict(top_p=0.6), dict(top_k=6, top_p=0.3),
               dict(top_p=0.0)):
        ref = np.asarray(jfilter(jnp.asarray(logits), 0.8, **kw))
        out = _filter_logits(torch.from_numpy(logits), 0.8, **kw).numpy()
        np.testing.assert_array_equal(np.isinf(out), np.isinf(ref))
        keep = ~np.isinf(ref)
        np.testing.assert_allclose(out[keep], ref[keep], rtol=1e-6)
    gen = torch.Generator().manual_seed(0)
    t = torch.from_numpy(logits)
    assert torch.equal(_sample(t, gen), t.argmax(-1))
    assert torch.equal(_sample(t, gen, temperature=2.0, top_k=1),
                       t.argmax(-1))


def test_block_allocator():
    a = BlockAllocator(5)
    ids = a.alloc(3)
    assert sorted(ids) == [0, 1, 2] and a.available == 2
    a.free(ids[:2])
    assert a.available == 4
    with pytest.raises(RuntimeError, match="exhausted"):
        a.alloc(5)
    assert a.available == 4            # a failed alloc takes nothing


def test_engine_validates_requests_and_unported_modes():
    _, _, model = _models(seed=2)
    eng = ServingEngine(model, pool_blocks=4, device="cpu", **ENGINE)
    with pytest.raises(ValueError, match="prompt length"):
        eng.submit(list(range(17)), 2)
    with pytest.raises(ValueError, match="max_seq"):
        eng.submit([1, 2], 40)
    with pytest.raises(ValueError, match="never be admitted"):
        eng.submit([1, 2], 30)
    with pytest.raises(NotImplementedError, match="lora"):
        ServingEngine(model, lora=object(), lora_bank=object(),
                      device="cpu")
    # system_prompt is ported: a prefix off the block grid is refused
    # (JAX asserts; tests/test_torch_serve_prefix.py holds the rest)
    with pytest.raises(ValueError, match="multiple of block_size"):
        ServingEngine(model, pool_blocks=4, system_prompt=[1] * 5,
                      device="cpu", **ENGINE)
    # offline_serve is ported (tests/test_torch_offline_serve.py): it
    # refuses what JAX asserts, here a prompt and budget past max_seq
    with pytest.raises(ValueError, match="exceeds max_seq"):
        offline_serve(model, np.zeros((2, 8), np.int64), [8, 8],
                      [model.max_seq, 1], device="cpu")


def test_engine_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """device=None means the card, and the engine moves the model there;
    without a card it raises and says how to serve on the CPU, instead of
    quietly serving on the CPU where the model happens to live."""
    _, _, model = _models(seed=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ServingEngine(model, pool_blocks=4, **ENGINE)
    eng = ServingEngine(model, pool_blocks=4, device="cpu", **ENGINE)
    assert eng.device.type == "cpu"
    assert next(eng.model.parameters()).device.type == "cpu"


def test_import_leaves_jax_out():
    code = ("import sys, taper_tpu_torch, taper_tpu_torch.serve, "
            "taper_tpu_torch.models, taper_tpu_torch.utils.convert; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'taper_tpu')); assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
