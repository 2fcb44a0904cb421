"""ResNet-8 for CIFAR-10: port of ``taper_tpu/models/resnet.py``.

A conv3x3 stem, three residual BasicBlocks (16 -> 32 -> 64 channels,
stride 2 between stages), a global average pool and a linear head: 8
weighted layers.  ``batchnorm=True`` (the default) puts a BatchNorm after
every convolution of the stem and the blocks, with running statistics
that follow ``train()``/``eval()``.

On the card a training step runs K3a/K3b for the five stride-1 3x3
convolutions, K1 for the two stride-2 convolutions and the two 1x1
projections (patch GEMMs) and the head, K4 for the 8x8 average pool, and
K2 for the seven ReLUs.
"""

from __future__ import annotations

from torch import nn

from taper_tpu_torch import nn as tnn
from taper_tpu_torch import ops


class _Stem(nn.Module):
    """conv3x3 3 -> 16 (-> BN) -> ReLU."""

    def __init__(self, batchnorm: bool = False):
        super().__init__()
        self.conv = tnn.conv3x3(3, 16, bias=not batchnorm)
        self.bn = tnn.BatchNorm2d(16) if batchnorm else None

    def reset_parameters(self, generator=None) -> None:
        self.conv.reset_parameters(generator)
        if self.bn is not None:
            self.bn.reset_parameters(generator)

    def forward(self, x):
        y = self.conv(x)
        if self.bn is not None:
            y = self.bn(y)
        return ops.relu(y)


def resnet8(num_classes: int = 10, batchnorm: bool = True) -> tnn.Sequential:
    return tnn.Sequential(
        _Stem(batchnorm),
        tnn.BasicBlock(16, 16, residual=True, batchnorm=batchnorm),
        tnn.BasicBlock(16, 32, stride=2, residual=True, batchnorm=batchnorm),
        tnn.BasicBlock(32, 64, stride=2, residual=True, batchnorm=batchnorm),
        tnn.AdaptiveAvgPool2d.global_(),
        tnn.Flatten(),
        tnn.Linear(64, num_classes),
    )
