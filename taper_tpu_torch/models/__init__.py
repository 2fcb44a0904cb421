"""Models of the port (``taper_tpu/models``)."""

from taper_tpu_torch.models.mnist import mnist_cnn, mnist_mlp, xor_mlp
from taper_tpu_torch.models.resnet import resnet8
from taper_tpu_torch.models.transformer import TinyGPT

__all__ = ["TinyGPT", "mnist_cnn", "mnist_mlp", "resnet8", "xor_mlp"]
