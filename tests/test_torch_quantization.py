"""The port's quantized tensor formats (taper_tpu_torch/quantization:
config and qtensor) against the JAX package's (taper_tpu/quantization);
PTQ of a module and the qparams loader are in test_torch_ptq.py.

The same numpy inputs go through both ``quantize``s: codes, scales and
zero points must be equal bit for bit in every format and schema, and the
dequantized values within 1e-6 (both compute ``(q - zp) * scale`` in f32;
the bound leaves room for a differently fused multiply).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taper_tpu.quantization import config as JC
from taper_tpu.quantization import qtensor as JQ
from taper_tpu_torch.quantization import (
    QuantizationConfig, QuantizationSchema, QuantizationType, quantize)
from taper_tpu_torch.quantization.qtensor import pack_nibbles, unpack_int4

torch.set_num_threads(1)

SHAPES = [(37, 29), (8, 3, 3, 3), (64, 128), (5, 7)]


def _jcfg(cfg):
    return JC.QuantizationConfig(JC.QuantizationType(cfg.qtype.value),
                                 JC.QuantizationSchema(cfg.schema.value),
                                 cfg.symmetric)


def _bits(a):
    """Array bits as an integer view (fp8/bf16/fp16 compare bit for bit)."""
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


def _weights(shape, seed):
    rng = np.random.default_rng(seed)
    per_row = rng.uniform(0.01, 3.0, (shape[0],) + (1,) * (len(shape) - 1))
    return (rng.standard_normal(shape) * per_row + 0.1).astype(np.float32)


def _same(tq, jq):
    assert tq.qtype.value == jq.qtype.value
    assert tq.schema.value == jq.schema.value
    assert tq.shape == tuple(jq.shape)
    for t, j in ((tq.values, jq.values), (tq.scale, jq.scale),
                 (tq.zero_point, jq.zero_point)):
        assert tuple(t.shape) == tuple(np.shape(j))
        np.testing.assert_array_equal(_torch_bits(t), _bits(j))


@pytest.mark.parametrize("qtype", list(QuantizationType),
                         ids=lambda t: t.value)
@pytest.mark.parametrize("schema", list(QuantizationSchema),
                         ids=lambda s: s.value)
@pytest.mark.parametrize("symmetric", [False, True])
def test_quantize_matches_jax_bit_for_bit(qtype, schema, symmetric):
    cfg = QuantizationConfig(qtype, schema, symmetric)
    for i, shape in enumerate(SHAPES):
        x = _weights(shape, i)
        tq = quantize(torch.from_numpy(x), cfg)
        jq = JQ.quantize(jnp.asarray(x), _jcfg(cfg))
        _same(tq, jq)
        np.testing.assert_allclose(tq.dequantize().numpy(),
                                   np.asarray(jq.dequantize()), rtol=1e-6,
                                   atol=1e-6)
        assert tq.nbytes() == jq.nbytes()
        assert tq.compression_ratio() == pytest.approx(
            jq.compression_ratio())


def test_quantize_edge_values_match_jax():
    """A constant tensor (zero range), exact zeros, and values on the
    rounding midpoints of the int8 grid."""
    cases = [np.full((8, 16), 0.5, np.float32),
             np.zeros((4, 32), np.float32),
             (np.arange(-128, 128, dtype=np.float32) * 0.5 + 0.25
              ).reshape(4, 64)]
    for x in cases:
        for qtype in QuantizationType:
            for schema in QuantizationSchema:
                cfg = QuantizationConfig(qtype, schema)
                _same(quantize(torch.from_numpy(x), cfg),
                      JQ.quantize(jnp.asarray(x), _jcfg(cfg)))


@pytest.mark.parametrize("n", [1, 2, 7, 64, 129])
def test_nibbles_pack_as_jax_and_unpack_signed(n):
    codes = np.random.default_rng(n).integers(-8, 8, n).astype(np.int8)
    packed = pack_nibbles(torch.from_numpy(codes))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(JQ._pack_nibbles(
                                      jnp.asarray(codes))))
    assert packed.numel() == -(-n // 2)
    np.testing.assert_array_equal(unpack_int4(packed, (n,)).numpy(), codes)


def test_config_helpers_match_jax():
    for qtype in QuantizationType:
        cfg = QuantizationConfig(qtype)
        jcfg = _jcfg(cfg)
        assert cfg.compute_range() == jcfg.compute_range()
        assert cfg.bit_width() == jcfg.bit_width()
    for name in ("int8", "int4", "float16", "bfloat16", "nf4", "fp8_e4m3",
                 "fp8_e5m2"):
        cfg = getattr(QuantizationConfig, name)(symmetric=True)
        jcfg = getattr(JC.QuantizationConfig, name)(symmetric=True)
        assert cfg.qtype.value == jcfg.qtype.value and cfg.symmetric
    args = (-1.3, 2.1, -128, 127)
    assert QuantizationConfig.compute_scale(*args) == \
        JC.QuantizationConfig.compute_scale(*args)
    for mn, scale in ((-1.3, 0.01333), (0.2, 0.0), (-0.5, 0.004)):
        assert QuantizationConfig.compute_zero_point(mn, scale, -128) == \
            JC.QuantizationConfig.compute_zero_point(mn, scale, -128)


def test_quantized_tensor_moves_but_never_casts():
    x = torch.from_numpy(_weights((16, 8), 3))
    for name in ("int8", "int4", "fp8_e4m3", "float16", "nf4"):
        qt = quantize(x, getattr(QuantizationConfig, name)())
        dtypes = [t.dtype for t in (qt.values, qt.scale, qt.zero_point)]
        wrapper = torch.nn.Sequential(qt)
        wrapper.to(torch.float64)
        wrapper.half()
        wrapper.to("cpu")
        assert [t.dtype for t in (qt.values, qt.scale,
                                  qt.zero_point)] == dtypes
        torch.testing.assert_close(qt.dequantize(),
                                   quantize(x, getattr(
                                       QuantizationConfig, name)())
                                   .dequantize(), rtol=0, atol=0)
    assert "int8" in repr(quantize(x, QuantizationConfig.int8()))
