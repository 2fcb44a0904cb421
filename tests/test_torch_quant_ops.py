"""The plain versions of the quantized kernels (taper_tpu_torch/ops/quant.py:
K12 ``linear_q8``, K13 ``linear_q4``, K14 ``quantize_rows``, K15b
``matmul_int8``, K15a ``matmul_int8_scaled``, and ``linear_w8a8`` over K14
and K15a) against the JAX package's Pallas functions
(taper_tpu/ops/pallas/quant.py), interpreted on the CPU as its own tests
run them, with the same numpy inputs.

Tolerances:
  * K14 and K15b: exact (the same f32 operations; integer products);
  * K15a and W8A8: exact without a bias and a sigmoid; with a bias, XLA's
    CPU backend contracts the epilogue's last multiply and the bias add
    into an FMA, and jax.nn.sigmoid and torch.sigmoid may round apart:
    1e-6 of (1 + |ref|) in f32, one bf16 ulp (2^-8) in bf16;
  * K12 and K13: 1e-5 of (1 + |ref|): both round the activations to bf16,
    so every product is exact in f32 and the sums differ in order only
    (JAX accumulates over K blocks of 256 or 512, and K13 in its permuted
    column order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taper_tpu.ops.pallas import quant as JQ
from taper_tpu.quantization import config as JC
from taper_tpu.quantization import qtensor as JT
from taper_tpu_torch import ops
from taper_tpu_torch.ops import backend
from taper_tpu_torch.ops import quant as Q
from taper_tpu_torch.quantization import (
    QuantizationConfig, QuantizationSchema, QuantizationType, quantize)

torch.set_num_threads(1)

LINEAR_TOL = 1e-5
EPILOGUE_TOL = 1e-6


def _rng(seed):
    return np.random.default_rng(seed)


def _close(out, ref, tol):
    out = out.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=tol, atol=tol)


def _weight(n, k, bits, per_channel, symmetric, seed):
    """JAX's PTQ codes of a random weight, and the port's from the same
    numpy array (equal bit for bit: test_torch_quantization.py)."""
    w = (_rng(seed).standard_normal((n, k)) * 0.05
         * _rng(seed + 1).uniform(0.2, 3.0, (n, 1)) + 0.01).astype(
             np.float32)
    schema = "per_channel" if per_channel else "uniform"
    qtype = "int8" if bits == 8 else "int4"
    jcfg = JC.QuantizationConfig(JC.QuantizationType(qtype),
                                 JC.QuantizationSchema(schema), symmetric)
    cfg = QuantizationConfig(QuantizationType(qtype),
                             QuantizationSchema(schema), symmetric)
    return JT.quantize(jnp.asarray(w), jcfg), quantize(torch.from_numpy(w),
                                                       cfg)


def _epilogue_tol(rounds_apart, dtype):
    if not rounds_apart:
        return 0.0
    return EPILOGUE_TOL if dtype == "float32" else 2 ** -8


CASES = [(False, False, True, "none"), (True, False, False, "relu"),
         (False, True, True, "sigmoid"), (True, True, True, "relu"),
         (False, False, False, "sigmoid"), (True, False, True, "none")]


@pytest.mark.parametrize("per_channel,symmetric,bias,epilogue", CASES)
@pytest.mark.parametrize("m,n,k", [(8, 40, 300), (20, 130, 64)])
def test_linear_q8_plain_matches_jax(m, n, k, per_channel, symmetric, bias,
                                     epilogue):
    jq, tq = _weight(n, k, 8, per_channel, symmetric, m + n)
    x = _rng(k).standard_normal((m, k)).astype(np.float32)
    b = _rng(n).standard_normal(n).astype(np.float32) * 0.1 if bias \
        else None
    ref = JQ.linear_q8(jnp.asarray(x), jq.values, jq.scale, jq.zero_point,
                       None if b is None else jnp.asarray(b),
                       epilogue=epilogue, has_bias=bias)
    out = Q.linear_q8(torch.from_numpy(x), tq.values, tq.scale,
                      tq.zero_point, None if b is None
                      else torch.from_numpy(b), epilogue=epilogue)
    _close(out, ref, LINEAR_TOL)


@pytest.mark.parametrize("per_channel,symmetric,bias,epilogue", CASES)
@pytest.mark.parametrize("m,n,k", [(8, 40, 300), (3, 17, 512),
                                   (20, 130, 64), (64, 96, 256)])
def test_linear_q4_plain_matches_jax(m, n, k, per_channel, symmetric, bias,
                                     epilogue):
    jq, tq = _weight(n, k, 4, per_channel, symmetric, m + n + 1)
    x = _rng(k + 1).standard_normal((m, k)).astype(np.float32)
    b = _rng(n).standard_normal(n).astype(np.float32) * 0.1 if bias \
        else None
    ref = JQ.linear_q4(jnp.asarray(x), jq.values, jq.scale, jq.zero_point,
                       None if b is None else jnp.asarray(b),
                       n_features=k, epilogue=epilogue, has_bias=bias)
    out = Q.linear_q4(torch.from_numpy(x), tq.values, tq.scale,
                      tq.zero_point, None if b is None
                      else torch.from_numpy(b), n_features=k,
                      epilogue=epilogue)
    _close(out, ref, LINEAR_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k", [(34, 192), (256, 2048), (5, 37), (1, 8)])
def test_quantize_rows_plain_matches_jax_exactly(m, k, dtype):
    x = (_rng(m * k).standard_normal((m, k)) * 2.0).astype(np.float32)
    x[0, :3] = 0.0
    if m == 1:
        x[:] = 0.0                       # an all-zero row: the 1e-8 floor
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    for out, ref in zip(Q.quantize_rows(tx), JQ.quantize_rows(jx)):
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
        assert str(out.dtype).split(".")[1] == str(ref.dtype)


@pytest.mark.parametrize("m,n,k", [(37, 53, 100), (128, 256, 640),
                                   (3, 5, 7)])
def test_matmul_int8_plain_matches_jax_exactly(m, n, k):
    rng = _rng(m + n + k)
    xq = rng.integers(-127, 128, (m, k), dtype=np.int8)
    q = rng.integers(-128, 128, (n, k), dtype=np.int8)
    ref = JQ.matmul_int8(jnp.asarray(xq), jnp.asarray(q))
    out = Q.matmul_int8(torch.from_numpy(xq), torch.from_numpy(q))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("bias,relu,out_dtype", [
    (True, False, "float32"), (False, True, "float32"),
    (True, True, "bfloat16"), (False, False, "bfloat16")])
def test_matmul_int8_scaled_plain_matches_jax(bias, relu, out_dtype):
    m, n, k = 40, 70, 200
    rng = _rng(11)
    xq = rng.integers(-127, 128, (m, k), dtype=np.int8)
    q = rng.integers(-128, 128, (n, k), dtype=np.int8)
    sx = rng.uniform(1e-3, 2e-2, m).astype(np.float32)
    corr = xq.sum(1).astype(np.float32)
    sw = rng.uniform(1e-4, 1e-2, n).astype(np.float32)
    zw = rng.integers(-9, 9, n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32) if bias else None
    ref = JQ.matmul_int8_scaled(
        *map(jnp.asarray, (xq, q, sx, corr, sw, zw)),
        bias=None if b is None else jnp.asarray(b), relu=relu,
        out_dtype=getattr(jnp, out_dtype))
    out = Q.matmul_int8_scaled(
        *map(torch.from_numpy, (xq, q, sx, corr, sw, zw)),
        bias=None if b is None else torch.from_numpy(b), relu=relu,
        out_dtype=getattr(torch, out_dtype))
    assert out.dtype == getattr(torch, out_dtype)
    _close(out, np.asarray(ref, np.float32), _epilogue_tol(bias, out_dtype))


@pytest.mark.parametrize("per_channel,symmetric,bias,epilogue", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linear_w8a8_plain_matches_jax(per_channel, symmetric, bias,
                                       epilogue, dtype):
    m, n, k = 48, 96, 160
    jq, tq = _weight(n, k, 8, per_channel, symmetric, 5)
    x = _rng(6).standard_normal((m, k)).astype(np.float32)
    b = _rng(7).standard_normal(n).astype(np.float32) * 0.1 if bias \
        else None
    ref = JQ.linear_w8a8(jnp.asarray(x).astype(dtype), jq.values, jq.scale,
                         jq.zero_point,
                         None if b is None else jnp.asarray(b),
                         epilogue=epilogue)
    out = Q.linear_w8a8(torch.from_numpy(x).to(getattr(torch, dtype)),
                        tq.values, tq.scale, tq.zero_point,
                        None if b is None else torch.from_numpy(b),
                        epilogue=epilogue)
    assert str(out.dtype).split(".")[1] == str(ref.dtype)
    _close(out, ref, _epilogue_tol(bias or epilogue == "sigmoid", dtype))


def test_linear_dispatches_a_quantized_weight_as_jax(monkeypatch):
    """``ops.linear`` with a QuantizedTensor: int8 runs K12's function at
    every M, int4 with an even K K13's, W8A8 from 256 rows under
    TAPER_W8A8=1 (read at call time), other formats the dequantized dense
    product; a quantized bias dequantizes.  JAX on the pallas backend with
    ``_Q8_KERNEL = "1"`` takes the same branches."""
    from taper_tpu import ops as jops
    import taper_tpu.ops as jops_module

    monkeypatch.setattr(jops_module, "_Q8_KERNEL", "1")
    monkeypatch.delenv("TAPER_W8A8", raising=False)
    w = (_rng(0).standard_normal((48, 64)) * 0.05).astype(np.float32)
    b = (_rng(1).standard_normal(48) * 0.1).astype(np.float32)
    x = _rng(2).standard_normal((300, 64)).astype(np.float32)
    for name in ("int8", "int4", "nf4", "fp8_e4m3", "float16"):
        qt = quantize(torch.from_numpy(w), getattr(QuantizationConfig,
                                                   name)())
        jqt = JT.quantize(jnp.asarray(w), getattr(JC.QuantizationConfig,
                                                  name)())
        for rows, w8a8 in ((5, "0"), (256, "0"), (256, "1"), (255, "1")):
            monkeypatch.setenv("TAPER_W8A8", w8a8)
            out = ops.linear(torch.from_numpy(x[:rows]), qt,
                             torch.from_numpy(b), activation="relu")
            with jops.use_backend("pallas"):
                ref = jops.linear(jnp.asarray(x[:rows]), jqt,
                                  jnp.asarray(b), activation="relu")
            _close(out, ref, LINEAR_TOL)
    # a quantized bias (float16 storage) dequantizes on both sides
    qb = quantize(torch.from_numpy(b), QuantizationConfig.float16())
    jqb = JT.quantize(jnp.asarray(b), JC.QuantizationConfig.float16())
    out = ops.linear(torch.from_numpy(x[:7]), qt, qb)
    with jops.use_backend("pallas"):
        ref = jops.linear(jnp.asarray(x[:7]), jqt, jqb)
    _close(out, ref, LINEAR_TOL)


def test_quantized_plain_versions_stay_on_the_cpu():
    """On CPU tensors the wrappers run the plain versions and count no
    launch."""
    jq, tq = _weight(16, 64, 8, False, False, 0)
    x = torch.from_numpy(_rng(0).standard_normal((256, 64)).astype(
        np.float32))
    backend.reset_launch_counts()
    Q.linear_q8(x, tq.values, tq.scale, tq.zero_point)
    Q.linear_w8a8(x, tq.values, tq.scale, tq.zero_point)
    Q.matmul_int8(tq.values, tq.values)
    assert not any(backend.launch_counts().values())
    with pytest.raises(ValueError, match="epilogue"):
        Q.linear_q8(x, tq.values, tq.scale, tq.zero_point, epilogue="gelu")
    with pytest.raises(ValueError, match="even"):
        Q.linear_q4(x[:, :63], tq.values, tq.scale, tq.zero_point,
                    n_features=63)
