"""Post-training quantization of a module (taper_tpu_torch/quantization/
ptq.py) and the qparams loader of utils/convert.py against the JAX
package's ``ptq`` on the reference CNN: JAX initialises the parameters,
``load_jax_params`` moves them into the port, both quantize.  Codes,
scales and zero points must be equal bit for bit (as in
test_torch_quantization.py), dequantized values within 1e-6.
"""

import jax
import numpy as np
import pytest
import torch

from taper_tpu import models as jmodels
from taper_tpu.quantization import config as JC
from taper_tpu.quantization import ptq as jptq
from taper_tpu.quantization import qtensor as JQ
from taper_tpu_torch import models
from taper_tpu_torch.quantization import (
    QuantizationConfig, QuantizedModel, QuantizedTensor, dequantize_params,
    quantize_model, quantize_params, quantized_bytes)
from taper_tpu_torch.utils.convert import load_jax_params

torch.set_num_threads(1)


def _bits(a):
    a = np.asarray(a)
    if a.dtype.kind in "iub":
        return a
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.itemsize])


def _torch_bits(t):
    if t.dtype in (torch.bfloat16, torch.float16):
        return t.view(torch.int16).numpy().view(np.uint16)
    if t.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        return t.view(torch.uint8).numpy()
    return _bits(t.numpy())


def _same(tq, jq):
    assert tq.qtype.value == jq.qtype.value
    assert tq.schema.value == jq.schema.value
    assert tq.shape == tuple(jq.shape)
    for t, j in ((tq.values, jq.values), (tq.scale, jq.scale),
                 (tq.zero_point, jq.zero_point)):
        assert tuple(t.shape) == tuple(np.shape(j))
        np.testing.assert_array_equal(_torch_bits(t), _bits(j))


def _cnn_pair(seed=0):
    jmodel = jmodels.mnist_cnn()
    params = jmodel.init(jax.random.PRNGKey(seed))
    model = load_jax_params(models.mnist_cnn(),
                            jax.tree.map(np.asarray, params))
    return jmodel, params, model


def _leaves(jq):
    flat = jax.tree_util.tree_flatten_with_path(
        jq, is_leaf=lambda x: isinstance(x, JQ.QuantizedTensor))[0]
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf for path, leaf in flat}


@pytest.mark.parametrize("name", ["int8", "int4", "nf4", "fp8_e4m3",
                                  "bfloat16"])
def test_quantize_params_matches_jax(name):
    """The same leaves are quantized (ndim >= 2, size >= 64, floating) to
    the same codes, and ``quantized_bytes`` counts the same bytes; the
    original module is left untouched."""
    jmodel, params, model = _cnn_pair()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    cfg = getattr(QuantizationConfig, name)()
    qmodel = quantize_params(model, cfg)
    jq = jptq.quantize_params(params, getattr(JC.QuantizationConfig,
                                              name)())
    quantized = {k for k, m in qmodel.named_modules()
                 if isinstance(m, QuantizedTensor)}
    jleaves = _leaves(jq)
    assert quantized == {k for k, v in jleaves.items()
                         if isinstance(v, JQ.QuantizedTensor)}
    assert quantized == {"1.w", "2.w", "4.w", "5.w", "7.w", "10.w",
                         "11.w", "12.w"}
    for k in quantized:
        _same(qmodel.get_submodule(k), jleaves[k])
    assert quantized_bytes(qmodel) == jptq.quantized_bytes(jq)
    assert quantized_bytes(model) == jptq.quantized_bytes(params)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k])
    assert isinstance(model[1].w, torch.nn.Parameter)


def test_dequantize_params_inverts_quantize_params():
    _, params, model = _cnn_pair()
    qmodel = quantize_params(model, QuantizationConfig.int8())
    deq = dequantize_params(qmodel)
    jdeq = jptq.dequantize_params(jptq.quantize_params(
        params, JC.QuantizationConfig.int8()))
    assert not any(isinstance(m, QuantizedTensor) for m in deq.modules())
    for k, p in deq.named_parameters():
        layer, leaf = k.split(".")
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(jdeq[int(layer)][leaf]),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["int8", "int4", "fp8_e5m2", "bfloat16",
                                  "nf4"])
def test_load_jax_qparams_installs_the_codes_bit_for_bit(name):
    jmodel, params, _ = _cnn_pair(1)
    jq = jptq.quantize_params(params, getattr(JC.QuantizationConfig,
                                              name)())
    model = load_jax_params(models.mnist_cnn(), jq)
    jleaves = _leaves(jq)
    for k, leaf in jleaves.items():
        if isinstance(leaf, JQ.QuantizedTensor):
            _same(model.get_submodule(k), leaf)
        else:
            np.testing.assert_array_equal(
                model.get_parameter(k).detach().numpy(), np.asarray(leaf))
    # and back: a plain tree over a quantized model restores parameters
    load_jax_params(model, jax.tree.map(np.asarray, params))
    assert not any(isinstance(m, QuantizedTensor) for m in model.modules())


def test_load_jax_qparams_rejects_a_misshaped_leaf():
    _, params, _ = _cnn_pair()
    jq = jptq.quantize_params(params, JC.QuantizationConfig.int8())
    bad = models.mnist_cnn()
    bad[1] = models.mnist_cnn()[2]          # 32 -> 32 where 1 -> 32 is due
    with pytest.raises(ValueError, match="1.w"):
        load_jax_params(bad, jq)


def test_quantized_model_runs_the_copy_without_grad():
    _, _, model = _cnn_pair()
    qm = quantize_model(model, QuantizationConfig.float16())
    assert isinstance(qm, QuantizedModel) and not qm.module.training
    x = torch.from_numpy(np.random.default_rng(0).random(
        (3, 784)).astype(np.float32))
    out = qm(x)
    assert out.shape == (3, 10) and not out.requires_grad
    ref = dequantize_params(qm.module).eval()(x)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
