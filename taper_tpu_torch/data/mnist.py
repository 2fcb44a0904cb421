"""MNIST dataset: port of ``taper_tpu/data/mnist.py`` (IDX parsing and
the synthetic fallback).

Resolution per split, as ``mnist.py:122-161`` without its download step:
raw IDX files in ``data_dir`` (``train_images``, ``train_labels``,
``test_images``, ``test_labels``, uncompressed) when present; otherwise
labels drawn from ``np.random.default_rng(0)`` (train, 60,000) or
``default_rng(1)`` (test, 10,000), and images rendered from the labels by
:func:`synthesize_images_numpy` with seed 0 (train) or 1 (test).  The
port attempts no download (the machines it runs on have no network) and
writes no cache: rendering all 70,000 images takes a few seconds.
"""

from __future__ import annotations

import os
import struct
from typing import Tuple

import numpy as np

from taper_tpu_torch.data.synth import synthesize_images_numpy

_SIZES = {"train": 60000, "test": 10000}


def parse_idx_images(data: bytes) -> np.ndarray:
    """IDX image file -> ``[N, rows*cols]`` float32 in [0, 1]."""
    if len(data) < 16:
        raise ValueError("truncated IDX image file: no header")
    magic, n, rows, cols = struct.unpack(">IIII", data[:16])
    if magic != 0x803:
        raise ValueError(f"bad IDX image magic {magic:#x}")
    expect = 16 + n * rows * cols
    if len(data) < expect:
        raise ValueError(f"truncated IDX image file: {len(data)} < {expect}")
    imgs = np.frombuffer(data, np.uint8, count=n * rows * cols, offset=16)
    return imgs.reshape(n, rows * cols).astype(np.float32) / 255.0


def parse_idx_labels(data: bytes) -> np.ndarray:
    """IDX label file -> ``[N]`` int32 in 0..9."""
    if len(data) < 8:
        raise ValueError("truncated IDX label file: no header")
    magic, n = struct.unpack(">II", data[:8])
    if magic != 0x801:
        raise ValueError(f"bad IDX label magic {magic:#x}")
    if len(data) < 8 + n:
        raise ValueError("truncated IDX label file")
    labels = np.frombuffer(data, np.uint8, count=n, offset=8).astype(np.int32)
    if labels.size and labels.max() > 9:
        raise ValueError(f"IDX label out of range: max {labels.max()}")
    return labels


class MNISTDataset:
    """``images: [N, 784]`` float32 in [0, 1]; ``labels: [N]`` int32;
    ``source`` is ``"idx"`` or ``"synthetic"``."""

    def __init__(self, train: bool = True, data_dir: str = "data/mnist",
                 allow_synthetic: bool = True):
        split = "train" if train else "test"
        self.train = train
        self.data_dir = data_dir
        self.source = "idx"
        labels = self._load(f"{split}_labels", parse_idx_labels)
        images = self._load(f"{split}_images", parse_idx_images)
        if (labels is None or images is None) and not allow_synthetic:
            raise FileNotFoundError(
                f"MNIST {split} IDX files unavailable in {data_dir}")
        if labels is None:
            labels = np.random.default_rng(0 if train else 1).integers(
                0, 10, _SIZES[split]).astype(np.int32)
            self.source = "synthetic"
        if images is None:
            images = synthesize_images_numpy(labels, seed=0 if train else 1)
            self.source = "synthetic"
        if len(images) != len(labels):
            raise ValueError(f"MNIST {split}: {len(images)} images but "
                             f"{len(labels)} labels")
        self.images = images
        self.labels = labels

    def _load(self, name: str, parser):
        path = os.path.join(self.data_dir, name)
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            return parser(f.read())

    def __len__(self) -> int:
        return len(self.labels)

    def get_batch(self, indices) -> Tuple[np.ndarray, np.ndarray]:
        idx = np.asarray(indices, np.int64)
        return self.images[idx], self.labels[idx]
