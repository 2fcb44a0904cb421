"""Data of the port (``taper_tpu/data``): the MNIST and CIFAR-10
datasets with their synthetic renderers, the batching loaders, the sort
task of the transformer family, sequence packing and the byte-level BPE
tokenizer."""

from taper_tpu_torch.data.cifar10 import (
    CIFAR10Dataset, parse_cifar_batch, synthesize_cifar)
from taper_tpu_torch.data.loader import DataLoader, PrefetchLoader
from taper_tpu_torch.data.packing import pack_documents, packing_efficiency
from taper_tpu_torch.data.mnist import (
    MNISTDataset, parse_idx_images, parse_idx_labels)
from taper_tpu_torch.data.seq import (
    masked_token_loss, sort_task_batch, sort_task_vocab)
from taper_tpu_torch.data.synth import synthesize_images_numpy
from taper_tpu_torch.data.tokenizer import BPETokenizer

__all__ = ["BPETokenizer", "CIFAR10Dataset", "DataLoader", "MNISTDataset", "PrefetchLoader",
           "masked_token_loss", "pack_documents", "packing_efficiency",
           "parse_cifar_batch", "parse_idx_images",
           "parse_idx_labels", "sort_task_batch", "sort_task_vocab",
           "synthesize_cifar", "synthesize_images_numpy"]
