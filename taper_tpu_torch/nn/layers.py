"""Core layers: port of ``taper_tpu/nn/layers.py``: Linear, ReLU,
Sigmoid, Conv2d (``conv3x3``, ``conv1x1``), Conv2dReLU, MaxPool2d,
AvgPool2d, AdaptiveAvgPool2d, Flatten, Dropout, BatchNorm2d and
BasicBlock.

Each layer runs the op of ``taper_tpu_torch.ops`` its JAX counterpart
runs, with the activation fused into the Linear and Conv epilogues, and
the ReLU and Sigmoid layers through the elementwise kernel K2.
Initialisation follows ``layers.py:51-103``: Linear weights uniform in
``+-sqrt(2 / fan_in)``, Conv weights uniform in
``+-sqrt(2 / fan_in) * sqrt(3)``, biases zero; ``reset_parameters``
draws them from an explicit ``torch.Generator`` (PyTorch's default
Kaiming init is not used).

BatchNorm's running statistics are buffers (``running_mean``,
``running_var``), where the JAX package keeps them in the parameter tree
under ``running_`` names that its optimizers mask out; they follow
``model.train()`` / ``model.eval()`` as JAX's ``apply_train`` /
``apply`` do.

Linear, Conv2d and Conv2dReLU take a PTQ ``QuantizedTensor`` in place of
their weight parameter (``quantization.quantize_params`` installs one
under the same name): ``ops.linear`` sends int8 and int4 weights to the
dequant-on-load kernels, and the convolutions dequantize.

Dropout draws its mask from an explicit ``torch.Generator``, the
counterpart of JAX's ``rng`` key; its bits are not ``jax.random``'s.  A
generator on another device than the activations (a CPU generator, say,
for a CUDA tensor) seeds a generator on their device from one draw
(:func:`generator_on`), so a CPU generator drives any device without a
host sync.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from taper_tpu_torch import ops


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _uniform_(p: torch.Tensor, bound: float, generator) -> None:
    """Fill ``p`` uniformly in ``[-bound, bound)``, drawn on the CPU so a
    generator gives the same values on every device."""
    with torch.no_grad():
        draw = torch.empty(p.shape).uniform_(-bound, bound,
                                             generator=generator)
        p.copy_(draw)


class Linear(nn.Module):
    """``y = act(x @ w.T + b)`` with ``w: [out_features, in_features]``;
    ``activation`` is ``None``, ``"relu"`` or ``"sigmoid"`` (fused)."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, activation: Optional[str] = None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.activation = activation
        self.w = nn.Parameter(torch.empty(out_features, in_features))
        self.b = nn.Parameter(torch.zeros(out_features)) if bias else None
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        _uniform_(self.w, math.sqrt(2.0 / self.in_features), generator)
        if self.b is not None:
            with torch.no_grad():
                self.b.zero_()

    def forward(self, x):
        return ops.linear(x, self.w, self.b, activation=self.activation)


class ReLU(nn.Module):
    def forward(self, x):
        return ops.relu(x)


class Sigmoid(nn.Module):
    def forward(self, x):
        return ops.sigmoid(x)


class Conv2d(nn.Module):
    """NCHW convolution, weight ``w [out, in/groups, kh, kw]`` (OIHW)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=1, padding=0, groups: int = 1, bias: bool = True,
                 activation: Optional[str] = None):
        super().__init__()
        if in_channels % groups or out_channels % groups:
            raise ValueError(f"Conv2d: {groups} groups do not divide "
                             f"{in_channels} -> {out_channels} channels")
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = _pair(kernel_size)
        self.stride = _pair(stride)
        self.padding = _pair(padding)
        self.groups = groups
        self.activation = activation
        self.w = nn.Parameter(torch.empty(
            out_channels, in_channels // groups, *self.kernel_size))
        self.b = nn.Parameter(torch.zeros(out_channels)) if bias else None
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        kh, kw = self.kernel_size
        fan_in = (self.in_channels // self.groups) * kh * kw
        _uniform_(self.w, math.sqrt(2.0 / fan_in) * math.sqrt(3.0),
                  generator)
        if self.b is not None:
            with torch.no_grad():
                self.b.zero_()

    def forward(self, x):
        return ops.conv2d(x, self.w, self.b, stride=self.stride,
                          padding=self.padding, groups=self.groups,
                          activation=self.activation)


def conv3x3(in_ch: int, out_ch: int, stride=1, **kw) -> Conv2d:
    """3x3 same-padding convolution."""
    return Conv2d(in_ch, out_ch, 3, stride=stride, padding=1, **kw)


def conv1x1(in_ch: int, out_ch: int, stride=1, **kw) -> Conv2d:
    """1x1 convolution."""
    return Conv2d(in_ch, out_ch, 1, stride=stride, padding=0, **kw)


class Conv2dReLU(Conv2d):
    """Convolution with a fused bias + ReLU epilogue."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, groups=1, bias=True):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, groups, bias, activation="relu")


class MaxPool2d(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0):
        super().__init__()
        self.kernel_size = _pair(kernel_size)
        self.stride = self.kernel_size if stride is None else _pair(stride)
        self.padding = _pair(padding)

    @classmethod
    def new_2x2(cls):
        return cls(2, 2)

    def forward(self, x):
        return ops.max_pool2d(x, kernel=self.kernel_size, stride=self.stride,
                              padding=self.padding)


class AvgPool2d(nn.Module):
    """Average pool; kernel ``(0, 0)`` pools the whole H x W plane (the
    ``global_()`` sentinel)."""

    def __init__(self, kernel_size, stride=None, padding=0):
        super().__init__()
        self.kernel_size = _pair(kernel_size)
        self.stride = self.kernel_size if stride is None else _pair(stride)
        self.padding = _pair(padding)

    @classmethod
    def global_(cls):
        return cls((0, 0))

    def forward(self, x):
        kernel, stride = self.kernel_size, self.stride
        if kernel == (0, 0):
            kernel = stride = (x.shape[2], x.shape[3])
        return ops.avg_pool2d(x, kernel=kernel, stride=stride,
                              padding=self.padding)


class AdaptiveAvgPool2d(nn.Module):
    """Pools to a fixed output size: kernel = stride = floor(in / out)."""

    def __init__(self, output_size):
        super().__init__()
        self.output_size = _pair(output_size)

    @classmethod
    def global_(cls):
        return cls((1, 1))

    def forward(self, x):
        oh, ow = self.output_size
        kernel = (x.shape[2] // oh, x.shape[3] // ow)
        return ops.avg_pool2d(x, kernel=kernel, stride=kernel)


class Flatten(nn.Module):
    def __init__(self, start_dim: int = 1):
        super().__init__()
        self.start_dim = start_dim

    def forward(self, x):
        return x.reshape(*x.shape[:self.start_dim], -1)


def draw_seed(generator) -> int:
    """One 63-bit seed drawn from ``generator`` (read on the host: a CPU
    generator costs no device sync)."""
    return int(torch.randint(2 ** 63 - 1, (1,), generator=generator,
                             device=generator.device))


def generator_on(generator, device) -> torch.Generator:
    """``generator`` itself where it lives on ``device``, else a generator
    on ``device`` seeded by one draw from it."""
    device = torch.device(device)
    if generator.device.type == device.type:
        return generator
    return torch.Generator(device=device).manual_seed(draw_seed(generator))


def dropout(x, p: float, generator):
    """Inverted dropout: each element kept with probability ``1 - p`` and
    scaled by ``1 / (1 - p)``, at ``x``'s dtype (``where(mask, x / keep,
    0)``, as JAX's ``Dropout.apply``).  The mask is drawn from
    ``generator`` on ``x``'s device."""
    keep = 1.0 - p
    gen = generator_on(generator, x.device)
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0)


class Dropout(nn.Module):
    """Inverted dropout, active in training only.  ``train`` defaults to
    the module's mode (``model.train()``/``model.eval()``); a training
    call needs a ``generator`` and raises without one, as JAX's
    ``Dropout.apply`` raises without ``rng``."""

    takes_rng = True

    def __init__(self, p: float = 0.5):
        super().__init__()
        if not 0.0 <= p < 1.0:
            raise ValueError(f"dropout p must be in [0, 1), got {p}")
        self.p = p

    def forward(self, x, train: Optional[bool] = None, generator=None):
        train = self.training if train is None else train
        if not train or self.p == 0.0:
            return x
        if generator is None:
            raise ValueError("Dropout in training needs a generator=")
        return dropout(x, self.p, generator)


class BatchNorm2d(nn.Module):
    """Batch norm over NCHW (``layers.py:218-294``): parameters ``scale``
    and ``bias``, buffers ``running_mean`` and ``running_var``.

    In train mode it normalises with the batch mean and the biased batch
    variance and moves the running statistics by ``momentum`` toward the
    batch mean and the Bessel-corrected variance (JAX's ``_unbias``); in
    eval mode it normalises with the running statistics.  That is
    ``F.batch_norm``'s convention, which computes it (the JAX package has
    no kernel for batch norm either)."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        self.num_features = num_features
        self.eps = eps
        self.momentum = momentum
        self.scale = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.scale, self.bias, training=self.training,
                            momentum=self.momentum, eps=self.eps)


class BasicBlock(nn.Module):
    """conv3x3 (-> BN) -> ReLU (-> conv3x3 (-> BN)), with a residual add
    when ``residual`` (``layers.py:297-359``): the shortcut is the input,
    or a 1x1 projection when the stride or the width changes, and the sum
    goes through a last ReLU.  With ``batchnorm`` the convolutions have no
    bias.  The ReLUs run K2; the residual ``+`` is a plain add, as JAX's
    ``y + shortcut`` is."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1,
                 residual: bool = False, batchnorm: bool = False):
        super().__init__()
        self.residual = residual
        self.batchnorm = batchnorm
        self.conv1 = conv3x3(in_ch, out_ch, stride, bias=not batchnorm)
        self.conv2 = (conv3x3(out_ch, out_ch, bias=not batchnorm)
                      if residual else None)
        self.proj = (conv1x1(in_ch, out_ch, stride, bias=False)
                     if residual and (stride != 1 or in_ch != out_ch)
                     else None)
        self.bn1 = BatchNorm2d(out_ch) if batchnorm else None
        self.bn2 = BatchNorm2d(out_ch) if batchnorm and residual else None

    def reset_parameters(self, generator=None) -> None:
        for layer in (self.conv1, self.conv2, self.proj, self.bn1,
                      self.bn2):
            if layer is not None:
                layer.reset_parameters(generator)

    def forward(self, x):
        y = self.conv1(x)
        if self.bn1 is not None:
            y = self.bn1(y)
        y = ops.relu(y)
        if not self.residual:
            return y
        y = self.conv2(y)
        if self.bn2 is not None:
            y = self.bn2(y)
        shortcut = self.proj(x) if self.proj is not None else x
        return ops.relu(y + shortcut)
