"""Data of the port (``taper_tpu/data``): the MNIST dataset and its
synthetic renderer.  ``loader.py`` (the batching ``DataLoader``) comes
with ``Trainer.fit`` in the next slice."""

from taper_tpu_torch.data.mnist import (
    MNISTDataset, parse_idx_images, parse_idx_labels)
from taper_tpu_torch.data.synth import synthesize_images_numpy

__all__ = ["MNISTDataset", "parse_idx_images", "parse_idx_labels",
           "synthesize_images_numpy"]
