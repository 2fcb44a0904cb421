"""Pooling: port of ``taper_tpu/ops/pallas/pool.py`` (``max_pool2d``,
``avg_pool2d``; kernel ``_pool_kernel`` and the custom VJPs).

NCHW f32.  Pools with ``stride == kernel`` and no padding (every pool of
the library's models: ``MaxPool2d.new_2x2`` and the global average pools)
are a ``torch.autograd.Function``:

* forward: K4 on CUDA (``csrc/pool.cu``) at every such shape, the 7x7
  global average and the 14->7 max pool included (the TPU kernel's
  ``wo >= 8`` lane rule is not inherited); :func:`max_pool2d_reference` /
  :func:`avg_pool2d_reference` on the CPU.  Ragged tails are floored away
  (``H // kh`` rows), as ``pool.py:76-78`` does;
* backward, plain tensor code on both devices, as the JAX package's is
  XLA: max pool routes the cotangent to the first maximum of each window
  in row-major order (XLA's select-and-scatter); average pool spreads it
  evenly over the window.  Trimmed tails get zero.

Other configurations (overlapping windows, padding) run the plain XLA
semantics of ``ops/xla.py`` on the CPU and raise on CUDA.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from taper_tpu_torch.ops import _build
from taper_tpu_torch.ops import backend

POOL_MODES = {"max": 0, "avg": 1}


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _windows(x, kh, kw):
    """``[N, C, H, W]`` -> ``[N, C, Ho, Wo, kh*kw]``, each window's
    elements in row-major order (ragged tails dropped)."""
    n, c, h, w = x.shape
    ho, wo = h // kh, w // kw
    t = x[:, :, :ho * kh, :wo * kw].reshape(n, c, ho, kh, wo, kw)
    return t.permute(0, 1, 2, 4, 3, 5).reshape(n, c, ho, wo, kh * kw)


def max_pool2d_reference(x, kh, kw):
    """Plain version of the non-overlapping max pool."""
    return _windows(x.float(), kh, kw).amax(-1)


def avg_pool2d_reference(x, kh, kw):
    """Plain version of the non-overlapping average pool."""
    return _windows(x.float(), kh, kw).sum(-1) / (kh * kw)


def _pool(x, kh, kw, mode):
    """Forward of a non-overlapping pool: K4 or the plain version."""
    if not backend.on_cuda(x):
        ref = max_pool2d_reference if mode == "max" else avg_pool2d_reference
        return ref(x, kh, kw)
    backend.check_kernel_args("pool", x, dtypes=(torch.float32,))
    n, c, h, w = x.shape
    y = torch.empty((n, c, h // kh, w // kw), dtype=torch.float32,
                    device=x.device)
    code = _build.library().taper_pool(
        x.data_ptr(), y.data_ptr(), n * c, h, w, kh, kw, POOL_MODES[mode],
        _build.stream(x))
    _build.check(code, f"{mode} pool")
    backend.count_launch("pool")
    return y


def _unwindow(gw, shape, kh, kw):
    """Inverse of :func:`_windows` for a cotangent: ``[N, C, Ho, Wo,
    kh*kw]`` -> ``[N, C, H, W]``, zero on the dropped tails."""
    n, c, h, w = shape
    ho, wo = gw.shape[2:4]
    t = gw.reshape(n, c, ho, wo, kh, kw).permute(0, 1, 2, 4, 3, 5)
    t = t.reshape(n, c, ho * kh, wo * kw)
    return F.pad(t, (0, w - wo * kw, 0, h - ho * kh))


class _Pool(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, kh, kw, mode):
        ctx.kh, ctx.kw, ctx.mode, ctx.shape = kh, kw, mode, x.shape
        if mode == "max":
            ctx.save_for_backward(x)
        return _pool(x, kh, kw, mode)

    @staticmethod
    def backward(ctx, g):
        kh, kw = ctx.kh, ctx.kw
        if ctx.mode == "max":
            (x,) = ctx.saved_tensors
            first = _windows(x, kh, kw).argmax(-1, keepdim=True)
            gw = torch.zeros((*g.shape, kh * kw), dtype=g.dtype,
                             device=g.device)
            gw.scatter_(-1, first, g.unsqueeze(-1))
        else:
            gw = (g / (kh * kw)).unsqueeze(-1).expand(*g.shape, kh * kw)
        return _unwindow(gw, ctx.shape, kh, kw), None, None, None


def _args(kernel, stride, padding):
    kernel = _pair(kernel)
    stride = kernel if stride is None else _pair(stride)
    return kernel, stride, _pair(padding)


def _non_overlapping(x, kernel, stride, padding):
    return (stride == kernel and padding == (0, 0)
            and x.shape[2] >= kernel[0] and x.shape[3] >= kernel[1])


def _unsupported(x, what, kernel, stride, padding):
    if backend.on_cuda(x):
        raise NotImplementedError(
            f"{what} on CUDA takes stride == kernel and no padding; got "
            f"kernel {kernel}, stride {stride}, padding {padding}")


def max_pool2d(x, *, kernel=(2, 2), stride=None, padding=(0, 0)):
    kernel, stride, padding = _args(kernel, stride, padding)
    if _non_overlapping(x, kernel, stride, padding):
        return _Pool.apply(x, kernel[0], kernel[1], "max")
    _unsupported(x, "max_pool2d", kernel, stride, padding)
    return F.max_pool2d(x, kernel, stride, padding)


def avg_pool2d(x, *, kernel=(2, 2), stride=None, padding=(0, 0)):
    kernel, stride, padding = _args(kernel, stride, padding)
    if _non_overlapping(x, kernel, stride, padding):
        return _Pool.apply(x, kernel[0], kernel[1], "avg")
    _unsupported(x, "avg_pool2d", kernel, stride, padding)
    # with padding, XLA's version divides by the edge-clipped window size
    return F.avg_pool2d(x, kernel, stride, padding, count_include_pad=False)
