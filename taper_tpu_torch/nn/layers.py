"""Core layers: port of ``taper_tpu/nn/layers.py``, the part the MNIST
models use (Linear, Conv2d, Conv2dReLU, MaxPool2d, AvgPool2d,
AdaptiveAvgPool2d, Flatten).

Each layer runs the op of ``taper_tpu_torch.ops`` its JAX counterpart
runs, with the activation fused into the Linear and Conv epilogues.
Initialisation follows ``layers.py:51-103``: Linear weights uniform in
``+-sqrt(2 / fan_in)``, Conv weights uniform in
``+-sqrt(2 / fan_in) * sqrt(3)``, biases zero; ``reset_parameters``
draws them from an explicit ``torch.Generator`` (PyTorch's default
Kaiming init is not used).

Not ported yet: ReLU and Sigmoid layers (they run the elementwise ops of
K2), Dropout, BatchNorm2d and BasicBlock.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
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
