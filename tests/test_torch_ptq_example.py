"""The PTQ'd reference CNN (taper_tpu_torch/quantization/ptq.py through
the layers: int8 FC weights on K12's function, quantized convolutions
dequantized) against the JAX package's ``QuantizedModel.apply``, and the
PTQ walkthrough (taper_tpu_torch/examples/ptq_quantize.py) end to end on
the CPU.

JAX runs the pallas backend with ``taper_tpu.ops._Q8_KERNEL`` set to
``"1"`` (a module attribute, monkeypatched), so its int8 FC layers run
K12 (interpreted) as the port's do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import taper_tpu.ops as jops_module
from taper_tpu import models as jmodels
from taper_tpu import ops as jops
from taper_tpu.quantization import config as JC
from taper_tpu.quantization import ptq as jptq
from taper_tpu_torch import models
from taper_tpu_torch.examples import ptq_quantize
from taper_tpu_torch.quantization import QuantizationConfig, quantize_model
from taper_tpu_torch.utils.convert import load_jax_params

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["int8", "fp8_e4m3"])
def test_ptq_cnn_logits_match_jax_quantized_model(name, monkeypatch):
    """The reference CNN with random weights, PTQ'd: the port's
    QuantizedModel against JAX's ``QuantizedModel.apply`` on the same
    numpy inputs.  Tolerance 1e-4 of the largest logit, as the f32 CNN
    test (test_torch_mnist.py)."""
    monkeypatch.setattr(jops_module, "_Q8_KERNEL", "1")
    jmodel = jmodels.mnist_cnn()
    params = jmodel.init(jax.random.PRNGKey(3))
    model = load_jax_params(models.mnist_cnn(),
                            jax.tree.map(np.asarray, params))
    cfg = getattr(QuantizationConfig, name)()
    qm = quantize_model(model, cfg)
    jqm, jqp = jptq.quantize_model(
        jmodel, params, getattr(JC.QuantizationConfig, name)())
    x = np.random.default_rng(3).random((2, 784)).astype(np.float32)
    out = qm(torch.from_numpy(x))
    with jops.use_backend("pallas"):
        ref = np.asarray(jqm.apply(jqp, jnp.asarray(x)))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4,
                               atol=1e-4 * float(np.abs(ref).max()))


class _Digits:
    """A small random stand-in for MNISTDataset (the example renders
    70,000 synthetic digits; the test needs its flow, not its data)."""

    def __init__(self, train=True, data_dir=None):
        n = 512 if train else 2000
        rng = np.random.default_rng(0 if train else 1)
        self.labels = rng.integers(0, 10, n).astype(np.int32)
        self.images = rng.random((n, 784)).astype(np.float32) * 0.1
        self.images[np.arange(n), self.labels * 78] = 1.0

    def __len__(self):
        return len(self.labels)


def test_ptq_example_runs_on_the_cpu(monkeypatch, capsys):
    """The walkthrough end to end on the CPU: it trains, quantizes to
    int8, float16 and fp8_e4m3, and reports each format's accuracy, size
    and logit difference; int8 and float16 stay close to f32."""
    monkeypatch.setattr(ptq_quantize.data, "MNISTDataset", _Digits)
    res = ptq_quantize.main(["--device", "cpu", "--epochs", "1"])
    assert set(res) == {"f32", "int8", "float16", "fp8_e4m3"}
    assert res["f32"]["bytes"] == 4 * sum(
        p.numel() for p in models.mnist_cnn().parameters())
    assert res["int8"]["bytes"] < res["float16"]["bytes"] < \
        res["f32"]["bytes"]
    assert abs(res["int8"]["acc"] - res["f32"]["acc"]) <= 0.01
    assert abs(res["float16"]["acc"] - res["f32"]["acc"]) <= 0.001
    assert res["float16"]["max_logit_diff"] < res["int8"]["max_logit_diff"]
    out = capsys.readouterr().out
    assert "fp8_e4m3" in out and "accuracy" in out
