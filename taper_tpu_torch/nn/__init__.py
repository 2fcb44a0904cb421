"""Layers of the port (``taper_tpu/nn``): the MNIST layers and the
transformer blocks."""

from taper_tpu_torch.nn.layers import (
    AdaptiveAvgPool2d, AvgPool2d, Conv2d, Conv2dReLU, Flatten, Linear,
    MaxPool2d)
from taper_tpu_torch.nn.module import Sequential

__all__ = ["Sequential", "Linear", "Conv2d", "Conv2dReLU", "MaxPool2d",
           "AvgPool2d", "AdaptiveAvgPool2d", "Flatten"]
