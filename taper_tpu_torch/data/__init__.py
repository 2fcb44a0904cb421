"""Data of the port (``taper_tpu/data``): the MNIST and CIFAR-10
datasets with their synthetic renderers, the batching loaders, and the
sort task of the transformer family."""

from taper_tpu_torch.data.cifar10 import (
    CIFAR10Dataset, parse_cifar_batch, synthesize_cifar)
from taper_tpu_torch.data.loader import DataLoader, PrefetchLoader
from taper_tpu_torch.data.mnist import (
    MNISTDataset, parse_idx_images, parse_idx_labels)
from taper_tpu_torch.data.seq import (
    masked_token_loss, sort_task_batch, sort_task_vocab)
from taper_tpu_torch.data.synth import synthesize_images_numpy

__all__ = ["CIFAR10Dataset", "DataLoader", "MNISTDataset", "PrefetchLoader",
           "masked_token_loss", "parse_cifar_batch", "parse_idx_images",
           "parse_idx_labels", "sort_task_batch", "sort_task_vocab",
           "synthesize_cifar", "synthesize_images_numpy"]
