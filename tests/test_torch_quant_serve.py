"""PTQ-quantized TinyGPT serving through the port (taper_tpu_torch:
quantized weights in nn/transformer.py, models/transformer.py and
serve.py) against the JAX package with the same quantized weights.

JAX draws the parameters and quantizes them (``ptq.quantize_params``);
``load_jax_params`` installs its codes in the port bit for bit.  JAX runs
the pallas backend with ``taper_tpu.ops._Q8_KERNEL`` set to ``"1"`` (a
module attribute, monkeypatched), so it runs K12/K13 at every M, as the
port does; Pallas is interpreted on the CPU.

Tolerances.  Where the two packages' f32 activations differ in the last
bit (other summation orders), the bf16 rounding of K12/K13, or the int8
rounding of W8A8, can land on the other side of a rounding boundary for a
few elements; the final LayerNorm of a residual stream at its init scale
(std 0.02) amplifies such a flip about 50-fold.  So logits are held to
relative L2 errors: 1e-3 on the K12/K13 paths (measured up to 9e-5) and
1e-2 under W8A8, where one flipped int8 code of an activation moves its
row by a whole code step (measured 3e-3 for one flip; 0 without).  The
kernels' functions themselves are held exactly or to 1e-5
(test_torch_quant_ops.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import taper_tpu.ops as jops_module
from taper_tpu import models as jmodels
from taper_tpu import ops as jops
from taper_tpu import serve as jserve
from taper_tpu.quantization import config as JC
from taper_tpu.quantization import ptq as jptq
from taper_tpu_torch.models import TinyGPT
from taper_tpu_torch.ops import quant as Q
from taper_tpu_torch.quantization import QuantizedTensor
from taper_tpu_torch.serve import ServingEngine
from taper_tpu_torch.utils.convert import load_jax_params

torch.set_num_threads(1)

CFG = dict(vocab_size=48, dim=64, depth=2, num_heads=4, num_kv_heads=2,
           max_seq=48, rope=True)
ENGINE = dict(slots=2, prompt_pad=16, decode_block=3, block_size=8)
LOGIT_TOL, W8A8_TOL = 1e-3, 1e-2


@pytest.fixture(autouse=True)
def _jax_runs_the_quant_kernels(monkeypatch):
    monkeypatch.setattr(jops_module, "_Q8_KERNEL", "1")
    monkeypatch.delenv("TAPER_W8A8", raising=False)


def _models(name, seed=0, **cfg):
    """JAX's TinyGPT with its 1-D leaves (biases, norm gains) moved off
    their init values, so every bias path counts, then PTQ'd; the port's
    model with the same quantized weights."""
    cfg = dict(CFG, **cfg)
    jmodel = jmodels.TinyGPT(**cfg)
    params = jmodel.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: a + rng.normal(0, 0.02, a.shape).astype(np.float32)
        if a.ndim == 1 else a, params)
    qparams = jptq.quantize_params(
        params, getattr(JC.QuantizationConfig, name)())
    model = load_jax_params(TinyGPT(**cfg), qparams)
    return jmodel, qparams, model


def _check(out, ref, tol=LOGIT_TOL):
    out = out.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape and np.isfinite(out).all()
    rel = np.linalg.norm(out - ref) / np.linalg.norm(ref)
    assert rel <= tol, rel


@pytest.mark.parametrize("name", ["int8", "int4"])
def test_quantized_paged_prefill_and_decode_match_jax(name):
    jmodel, qparams, model = _models(name, seed=4)
    assert isinstance(model.blocks[0].attn.wq, QuantizedTensor)
    assert isinstance(model.tok.w, QuantizedTensor)
    rng = np.random.default_rng(4)
    bs, n_blocks, slots = 8, 13, 2
    mb = -(-CFG["max_seq"] // bs)
    tables = rng.permutation(n_blocks)[:slots * mb].reshape(slots, mb)
    tables = tables.astype(np.int32)
    prompts = rng.integers(0, 48, (slots, 16))
    pools = model.init_paged_cache(n_blocks, bs)
    jpools = jmodel.init_paged_cache(n_blocks, bs)
    with jops.use_backend("pallas"), torch.no_grad():
        prefill = jax.jit(jmodel.prefill_paged)
        decode = jax.jit(jmodel.decode_step_paged)
        for i in range(slots):
            ref, jpools = prefill(
                qparams, jnp.asarray(prompts[i:i + 1], jnp.int32), jpools,
                jnp.asarray(tables[i:i + 1]))
            out = model.prefill_paged(torch.from_numpy(prompts[i:i + 1]),
                                      pools, torch.from_numpy(tables[i:i + 1]))
            _check(out, ref)
        pos = np.array([16, 9], np.int32)
        tok = rng.integers(0, 48, slots)
        for _ in range(2):
            ref, jpools = decode(
                qparams, jnp.asarray(tok, jnp.int32), jnp.asarray(pos),
                jpools, jnp.asarray(tables))
            out = model.decode_step_paged(
                torch.from_numpy(tok), torch.from_numpy(pos), pools,
                torch.from_numpy(tables))
            _check(out, ref)
            tok, pos = np.asarray(ref).argmax(-1), pos + 1


@pytest.mark.parametrize("name", ["int8", "int4"])
def test_quantized_engine_matches_jax_engine(name):
    jmodel, qparams, model = _models(name)
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(0, 48, rng.integers(3, 17)))
               for _ in range(4)]
    max_new = [5, 9, 2, 7]
    kw = dict(ENGINE, pool_blocks=12)
    eng = ServingEngine(model, device="cpu", **kw)
    ids = [eng.submit(p, m) for p, m in zip(prompts, max_new)]
    out = eng.run()
    with jops.use_backend("pallas"):
        jeng = jserve.ServingEngine(jmodel, qparams, **kw)
        jids = [jeng.submit(p, m) for p, m in zip(prompts, max_new)]
        ref = jeng.run()
    assert [out[i] for i in ids] == [ref[i] for i in jids]
    assert [len(out[i]) for i in ids] == max_new


def test_w8a8_forward_matches_jax(monkeypatch):
    """Under TAPER_W8A8=1 every projection of a 2 x 128-token forward
    (256 rows) takes K14 + K15a on both sides; the predicate is read at
    call time."""
    jmodel, qparams, model = _models("int8", seed=2, max_seq=128)
    toks = np.random.default_rng(2).integers(0, 48, (2, 128))
    calls = []
    spy = Q.linear_w8a8

    def counting(*a, **k):
        calls.append(a[0].shape)
        return spy(*a, **k)

    monkeypatch.setattr(Q, "linear_w8a8", counting)
    monkeypatch.setenv("TAPER_W8A8", "1")
    with torch.no_grad():
        out = model(torch.from_numpy(toks))
    with jops.use_backend("pallas"):
        ref = jmodel.apply(qparams, jnp.asarray(toks, jnp.int32))
    assert len(calls) == 6 * CFG["depth"]
    assert all(s == (256, s[1]) for s in calls)
    _check(out, ref, W8A8_TOL)
    monkeypatch.setenv("TAPER_W8A8", "0")
    with torch.no_grad():
        model(torch.from_numpy(toks[:, :64]))
    assert len(calls) == 6 * CFG["depth"]
