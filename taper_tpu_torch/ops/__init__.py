"""Op surface of the port: port of ``taper_tpu/ops/__init__.py``, with the
JAX signatures, NCHW activations and OIHW weights.  Each op runs its
hand-written CUDA kernel on CUDA tensors and its plain PyTorch version on
CPU tensors (``ops/backend.py``), and is differentiable on both.

Not ported yet: quantized weights, ``ops/tensor_ops.py``, and the
sliding-window and segment arguments of ``attention``.
"""

from __future__ import annotations

from taper_tpu_torch.ops import gemm as _gemm
from taper_tpu_torch.ops.attention import attention, attention_bshd
from taper_tpu_torch.ops.conv import conv2d, conv2d_relu
from taper_tpu_torch.ops.elementwise import (
    add, div, fma, mul, relu, sigmoid, sub)
from taper_tpu_torch.ops.gemm import matmul
from taper_tpu_torch.ops.pool import avg_pool2d, max_pool2d


def linear(x, w, b=None, *, activation=None):
    """Fused ``act(x @ w.T + b)`` with ``w`` ``[out, in]``; ``activation``
    is ``None``, ``"relu"``, ``"sigmoid"`` or a callable of that name."""
    return _gemm.linear(x, w, b, _gemm.activation_name(activation))


__all__ = ["relu", "sigmoid", "add", "mul", "fma", "sub", "div", "linear",
           "matmul", "conv2d", "conv2d_relu", "max_pool2d", "avg_pool2d",
           "attention", "attention_bshd"]
