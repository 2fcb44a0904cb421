"""Convolution dispatch: port of ``taper_tpu/ops/pallas/conv.py``
(``conv2d``, ``conv2d_relu``).

NCHW activations, OIHW weights, differentiable on every route:

* stride-1 convolutions with a kernel larger than 1x1 run
  :func:`conv_direct.conv2d_direct` (K3a/K3b on CUDA) at every channel
  count.  The JAX package sends ``C*kh*kw <= 4096`` to XLA's emitter by
  default and reaches its direct kernel only under ``TAPER_CONV=direct``;
  that routing was measured on a TPU and is not inherited;
* 1x1 stride-1 unpadded convolutions are a channel-mixing GEMM;
* the rest (strided, or padding >= kernel) materialise the
  ``[N*Ho*Wo, C*kh*kw]`` patch matrix (columns in (c, i, j) order, as
  ``_extract_patches``) and run the fused GEMM (K1);
* grouped convolutions run each group through the routes above and
  concatenate, as ``conv.py:85-96`` does.

A quantized weight or bias (``quantization.QuantizedTensor``) is
dequantized first, as ``taper_tpu/ops/__init__.py:180-191`` does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from taper_tpu_torch.ops.conv_direct import conv2d_direct
from taper_tpu_torch.ops.gemm import activation_name, linear
from taper_tpu_torch.quantization.qtensor import dense


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _extract_patches(x, kh, kw, stride, padding):
    """NCHW -> ``[N*Ho*Wo, C*kh*kw]`` patch matrix, differentiable."""
    n = x.shape[0]
    cols = F.unfold(x, (kh, kw), padding=padding, stride=stride)
    ho = (x.shape[2] + 2 * padding[0] - kh) // stride[0] + 1
    wo = (x.shape[3] + 2 * padding[1] - kw) // stride[1] + 1
    return cols.transpose(1, 2).reshape(n * ho * wo, -1), ho, wo


def conv2d(x, w, b=None, *, stride=(1, 1), padding=(0, 0), groups=1,
           activation=None):
    """NCHW convolution with an optional fused ``"relu"``/``"sigmoid"``
    epilogue (a name or a callable with that name); ``w`` is OIHW."""
    stride, padding = _pair(stride), _pair(padding)
    act = activation_name(activation)
    w, b = dense(w), dense(b)
    if groups != 1:
        if x.shape[1] % groups or w.shape[0] % groups:
            raise ValueError(f"conv2d: {groups} groups do not divide "
                             f"x {tuple(x.shape)} / w {tuple(w.shape)}")
        xs = x.chunk(groups, dim=1)
        ws = w.chunk(groups, dim=0)
        bs = b.chunk(groups) if b is not None else [None] * groups
        return torch.cat([conv2d(xi.contiguous(), wi, bi, stride=stride,
                                 padding=padding, activation=act)
                          for xi, wi, bi in zip(xs, ws, bs)], dim=1)

    n, c, h, wd = x.shape
    o, ci, kh, kw = w.shape
    if ci != c:
        raise ValueError(f"conv2d: x {tuple(x.shape)} has {c} channels, "
                         f"w {tuple(w.shape)} takes {ci}")
    if (stride == (1, 1) and (kh, kw) != (1, 1)
            and padding[0] < kh and padding[1] < kw):
        return conv2d_direct(x, w, b, padding, act)
    if (kh, kw) == (1, 1) and stride == (1, 1) and padding == (0, 0):
        xm = x.permute(0, 2, 3, 1).reshape(n * h * wd, c)
        ho, wo = h, wd
    else:
        xm, ho, wo = _extract_patches(x, kh, kw, stride, padding)
    y = linear(xm, w.reshape(o, c * kh * kw), b, act)     # [N*Ho*Wo, O]
    return y.reshape(n, ho, wo, o).permute(0, 3, 1, 2).contiguous()


def conv2d_relu(x, w, b=None, *, stride=(1, 1), padding=(0, 0), groups=1):
    return conv2d(x, w, b, stride=stride, padding=padding, groups=groups,
                  activation="relu")
