"""Data of the port (``taper_tpu/data``): the MNIST dataset and its
synthetic renderer, and the sort task of the transformer family.
``loader.py`` (the batching ``DataLoader``) comes with ``Trainer.fit`` in
the next slice."""

from taper_tpu_torch.data.mnist import (
    MNISTDataset, parse_idx_images, parse_idx_labels)
from taper_tpu_torch.data.seq import (
    masked_token_loss, sort_task_batch, sort_task_vocab)
from taper_tpu_torch.data.synth import synthesize_images_numpy

__all__ = ["MNISTDataset", "masked_token_loss", "parse_idx_images",
           "parse_idx_labels", "sort_task_batch", "sort_task_vocab",
           "synthesize_images_numpy"]
