"""Quantization, port of ``taper_tpu/quantization``: the configuration
(``config``), the quantized tensor formats int4/int8/fp16/bf16/fp8/NF4
(``qtensor``) and post-training quantization of a module (``ptq``).

Not ported yet: ``fake_quantize`` (QAT's straight-through fake-quant),
``observers`` and ``qat``.
"""

from taper_tpu_torch.quantization.config import (
    QuantizationConfig, QuantizationSchema, QuantizationType)
from taper_tpu_torch.quantization.ptq import (
    QuantizedModel, dequantize_params, quantize_model, quantize_params,
    quantized_bytes)
from taper_tpu_torch.quantization.qtensor import (
    QuantizedTensor, dequantize, quantize)

__all__ = ["QuantizationConfig", "QuantizationSchema", "QuantizationType",
           "QuantizedTensor", "quantize", "dequantize", "quantize_params",
           "dequantize_params", "quantized_bytes", "QuantizedModel",
           "quantize_model"]
