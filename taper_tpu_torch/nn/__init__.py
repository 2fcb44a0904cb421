"""Layers of the port (``taper_tpu/nn``): the MNIST and ResNet layers
and the transformer blocks."""

from taper_tpu_torch.nn.layers import (
    AdaptiveAvgPool2d, AvgPool2d, BasicBlock, BatchNorm2d, Conv2d,
    Conv2dReLU, Dropout, Flatten, Linear, MaxPool2d, ReLU, Sigmoid, conv1x1,
    conv3x3)
from taper_tpu_torch.nn.module import Sequential

__all__ = ["Sequential", "Linear", "ReLU", "Sigmoid", "Conv2d", "conv3x3",
           "conv1x1", "Conv2dReLU", "MaxPool2d", "AvgPool2d",
           "AdaptiveAvgPool2d", "Flatten", "Dropout", "BatchNorm2d",
           "BasicBlock"]
