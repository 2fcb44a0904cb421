"""MNIST model architectures of the reference examples: port of
``taper_tpu/models/mnist.py``.  Activations are fused into the Linear and
Conv epilogues, as in the JAX package."""

from __future__ import annotations

from torch import nn

from taper_tpu_torch import nn as tnn


def mnist_mlp() -> tnn.Sequential:
    """784-128-64-10 ReLU MLP."""
    return tnn.Sequential(
        tnn.Linear(784, 128, activation="relu"),
        tnn.Linear(128, 64, activation="relu"),
        tnn.Linear(64, 10),
    )


class _Reshape(nn.Module):
    def __init__(self, shape):
        super().__init__()
        self.shape = tuple(shape)

    def forward(self, x):
        return x.reshape(x.shape[0], *self.shape)


def mnist_cnn() -> tnn.Sequential:
    """The reference CNN: Conv2dReLU 1->32->32 + pool, 32->64->64 + pool,
    64->128, global average pool, FC 128-128-64-10.  Takes flat
    ``[B, 784]`` input."""
    return tnn.Sequential(
        _Reshape((1, 28, 28)),
        tnn.Conv2dReLU(1, 32, 3, padding=1),
        tnn.Conv2dReLU(32, 32, 3, padding=1),
        tnn.MaxPool2d.new_2x2(),
        tnn.Conv2dReLU(32, 64, 3, padding=1),
        tnn.Conv2dReLU(64, 64, 3, padding=1),
        tnn.MaxPool2d.new_2x2(),
        tnn.Conv2dReLU(64, 128, 3, padding=1),
        tnn.AdaptiveAvgPool2d.global_(),
        tnn.Flatten(),
        tnn.Linear(128, 128, activation="relu"),
        tnn.Linear(128, 64, activation="relu"),
        tnn.Linear(64, 10),
    )


def xor_mlp() -> tnn.Sequential:
    """2-4-1 sigmoid MLP."""
    return tnn.Sequential(
        tnn.Linear(2, 4, activation="sigmoid"),
        tnn.Linear(4, 1, activation="sigmoid"),
    )
