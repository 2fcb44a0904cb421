"""Op surface of the port: port of ``taper_tpu/ops/__init__.py``, with the
JAX signatures, NCHW activations and OIHW weights.  Each op runs its
hand-written CUDA kernel on CUDA tensors and its plain PyTorch version on
CPU tensors (``ops/backend.py``), and is differentiable on both, except
the quantized products of ``ops/quant.py``.

``linear``, ``conv2d`` and ``conv2d_relu`` take a quantized weight
(``quantization.QuantizedTensor``): ``linear`` dispatches it as
``ops.quant.linear_quantized`` says (int8 to K12, int4 to K13, W8A8 to
K14 + K15a, other formats dequantized), the convolutions dequantize it.

``attention`` and ``attention_bshd`` take a sliding ``window`` and packed
``segment_ids``.  Not ported yet: ``ops/tensor_ops.py``.
"""

from __future__ import annotations

from taper_tpu_torch.ops import gemm as _gemm
from taper_tpu_torch.ops.attention import attention, attention_bshd
from taper_tpu_torch.ops.conv import conv2d, conv2d_relu
from taper_tpu_torch.ops.elementwise import (
    add, div, fma, mul, relu, sigmoid, sub)
from taper_tpu_torch.ops.gemm import matmul
from taper_tpu_torch.ops.pool import avg_pool2d, max_pool2d
from taper_tpu_torch.ops.quant import linear_quantized
from taper_tpu_torch.quantization.qtensor import QuantizedTensor


def linear(x, w, b=None, *, activation=None):
    """Fused ``act(x @ w.T + b)`` with ``w`` ``[out, in]``, a tensor or a
    ``QuantizedTensor``; ``activation`` is ``None``, ``"relu"``,
    ``"sigmoid"`` or a callable of that name."""
    activation = _gemm.activation_name(activation)
    if isinstance(w, QuantizedTensor):
        return linear_quantized(x, w, b, activation)
    return _gemm.linear(x, w, b, activation)


__all__ = ["relu", "sigmoid", "add", "mul", "fma", "sub", "div", "linear",
           "matmul", "conv2d", "conv2d_relu", "max_pool2d", "avg_pool2d",
           "attention", "attention_bshd"]
