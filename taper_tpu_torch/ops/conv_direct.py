"""Direct stride-1 convolution: port of
``taper_tpu/ops/pallas/conv_direct.py`` (``conv2d_direct`` with its custom
VJP; kernels ``_fwd_kernel`` and ``_dw_kernel``).

``x`` is ``[N, C, H, W]`` (NCHW), ``w`` is ``[O, C, kh, kw]`` (OIHW),
``b`` is ``[O]`` or ``None``, all f32; ``padding = (ph, pw)`` zero-pads
each side, with ``ph < kh`` and ``pw < kw`` so that the input gradient is
itself a convolution.  The output ``[N, O, H + 2ph - kh + 1,
W + 2pw - kw + 1]`` is f32, with the bias and the
``"none"``/``"relu"``/``"sigmoid"`` epilogue fused.

:func:`conv2d_direct` is a ``torch.autograd.Function`` with the backward
of ``_conv_direct_bwd`` (``conv_direct.py:296-315``): the cotangent goes
through the epilogue, ``dX`` is the forward kernel run on it with the
weights of :func:`flip_weights` (``flipped=True``: on CUDA the kernel
reads ``w`` in that order itself, no flipped copy is made) and padding
``(kh - 1 - ph, kw - 1 - pw)``, ``dW`` is the weight-gradient kernel and
``db = g.sum((0, 2, 3))``.  ``dX`` is skipped where the input needs no
gradient (the first layer's input is the data).

CPU tensors run the plain versions (:func:`conv2d_reference`,
:func:`conv_dw_reference`); CUDA tensors run the kernels of
``csrc/conv_direct.cu`` in f32 (no bf16 or TF32 variant yet).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from taper_tpu_torch.ops import _build
from taper_tpu_torch.ops import backend
from taper_tpu_torch.ops.gemm import (
    ACTIVATIONS, activation_grad, apply_activation)

# K3b: 256 threads a block, each holding 8 output channels of one input
# channel; its sum over whole images is split across blocks, about two
# blocks per SM of the H100 (132 SMs) in all.
_DW_THREADS = 256
_DW_BLOCKS = 264


def _out_hw(x, w, padding):
    ph, pw = padding
    return (x.shape[2] + 2 * ph - w.shape[2] + 1,
            x.shape[3] + 2 * pw - w.shape[3] + 1)


def _check(x, w, b, padding, flipped=False):
    c_in, c_out = (0, 1) if flipped else (1, 0)
    if x.dim() != 4 or w.dim() != 4 or x.shape[1] != w.shape[c_in]:
        layout = "[C, O, kh, kw]" if flipped else "[O, C, kh, kw]"
        raise ValueError(f"conv2d_direct: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} are not [N, C, H, W] and "
                         f"{layout}")
    if b is not None and tuple(b.shape) != (w.shape[c_out],):
        raise ValueError(f"conv2d_direct: bias {tuple(b.shape)} is not "
                         f"[{w.shape[c_out]}]")
    kh, kw = w.shape[2:]
    ph, pw = padding
    if not (0 <= ph < kh and 0 <= pw < kw):
        raise ValueError(f"conv2d_direct: padding {padding} must lie in "
                         f"[0, kernel) for kernel {(kh, kw)}")
    if min(_out_hw(x, w, padding)) < 1:
        raise ValueError(f"conv2d_direct: kernel {(kh, kw)} is larger than "
                         f"the padded input {tuple(x.shape[2:])}")


def flip_weights(w):
    """``_flip_w``: swap in/out channels and flip spatially, the weights
    of the input gradient's convolution."""
    return w.transpose(0, 1).flip(2, 3).contiguous()


def conv2d_reference(x, w, b=None, padding=(0, 0), activation="none"):
    """Plain version of the forward: ``F.conv2d`` in full f32 (cuDNN's
    TF32 is off, ``ops/backend.py``), plus bias and epilogue."""
    y = F.conv2d(x.float(), w.float(), None if b is None else b.float(),
                 padding=tuple(padding))
    return apply_activation(y, activation)


def conv_dw_reference(x, g, kernel, padding):
    """Plain version of the weight gradient, ``[O, C, kh, kw]``."""
    w_shape = (g.shape[1], x.shape[1], *kernel)
    return torch.nn.grad.conv2d_weight(x.float(), w_shape, g.float(),
                                       padding=tuple(padding))


def conv_fwd(x, w, b=None, padding=(0, 0), activation="none",
             flipped=False):
    """The forward convolution: K3a on CUDA, the plain version on the
    CPU.  Not differentiable (the building block of both passes).  With
    ``flipped`` the weights are ``flip_weights(w)`` (``w`` is a forward's
    ``[O, C, kh, kw]``, read as the input gradient's ``[C, O, kh, kw]``):
    the input gradient's convolution, without a flipped copy on CUDA."""
    _check(x, w, b, padding, flipped)
    if not backend.on_cuda(x, w, b):
        return conv2d_reference(x, flip_weights(w) if flipped else w, b,
                                padding, activation)
    backend.check_kernel_args("conv2d_direct", x, w, b,
                              dtypes=(torch.float32,))
    n, c, h, wd = x.shape
    o = w.shape[1] if flipped else w.shape[0]
    kh, kw = w.shape[2:]
    y = torch.empty((n, o, *_out_hw(x, w, padding)), dtype=torch.float32,
                    device=x.device)
    code = _build.library().taper_conv_fwd(
        x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
        y.data_ptr(), n, c, h, wd, o, kh, kw, padding[0], padding[1],
        ACTIVATIONS[activation], int(flipped), _build.stream(x))
    _build.check(code, "conv2d_direct forward")
    backend.count_launch("conv_fwd")
    return y


def dw_channel_group(c: int, o: int) -> int:
    """Input channels a K3b block: as many as :data:`_DW_THREADS` threads
    hold at 8 output channels each, balanced over the groups.  The
    kernel's grid and plan take it as an argument."""
    per_block = min(c, max(1, _DW_THREADS // -(-o // 8)))
    groups = -(-c // per_block)
    return -(-c // groups)


def dw_splits(n: int, c: int, o: int) -> int:
    """Blocks along K3b's image axis, each summing ``ceil(n / splits)``
    whole images: about :data:`_DW_BLOCKS` blocks in all, over the
    groups of :func:`dw_channel_group`.  A function of the shapes only,
    so the order of the sum, and the result, is the same from run to
    run."""
    groups = -(-c // dw_channel_group(c, o))
    images = -(-n // min(n, -(-_DW_BLOCKS // groups)))
    return -(-n // images)


def conv_dw(x, g, kernel, padding):
    """The weight gradient ``[O, C, kh, kw]`` of a stride-1 convolution
    of ``x`` whose output gradient is ``g``: K3b on CUDA, the plain
    version on the CPU."""
    if not backend.on_cuda(x, g):
        return conv_dw_reference(x, g, kernel, padding)
    backend.check_kernel_args("conv2d_direct weight gradient", x, g,
                              dtypes=(torch.float32,))
    n, c, h, wd = x.shape
    o = g.shape[1]
    kh, kw = kernel
    splits = dw_splits(n, c, o)
    part = torch.empty((splits, o, c * kh * kw), dtype=torch.float32,
                       device=x.device)
    dw = torch.empty((o, c, kh, kw), dtype=torch.float32, device=x.device)
    code = _build.library().taper_conv_dw(
        x.data_ptr(), g.data_ptr(), part.data_ptr(), dw.data_ptr(), n, c, h,
        wd, o, kh, kw, padding[0], padding[1], splits,
        dw_channel_group(c, o), _build.stream(x))
    _build.check(code, "conv2d_direct weight gradient")
    backend.count_launch("conv_dw")
    return dw


class _ConvDirect(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, b, padding, activation):
        y = conv_fwd(x, w, b, padding, activation)
        ctx.padding, ctx.activation = padding, activation
        ctx.save_for_backward(x, w, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, y = ctx.saved_tensors
        g = activation_grad(g, y, ctx.activation).contiguous()
        need_x, need_w, need_b, _, _ = ctx.needs_input_grad
        kh, kw = w.shape[2:]
        ph, pw = ctx.padding
        dx = (conv_fwd(g, w, None, (kh - 1 - ph, kw - 1 - pw),
                       flipped=True) if need_x else None)
        dw = conv_dw(x, g, (kh, kw), ctx.padding) if need_w else None
        db = g.sum((0, 2, 3)) if need_b else None
        return dx, dw, db, None, None


def conv2d_direct(x, w, b=None, padding=(0, 0), activation="none"):
    """Stride-1 NCHW convolution, differentiable; see the module
    docstring."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    padding = tuple(padding)
    _check(x, w, b, padding)
    return _ConvDirect.apply(x, w, b, padding, activation)
