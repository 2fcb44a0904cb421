"""CIFAR-10 dataset: port of ``taper_tpu/data/cifar10.py`` (the binary
batch parser and the synthetic v2 renderer).

Resolution per split, as ``cifar10.py:97-135`` without its download and
its cache: the binary batches in ``data_dir`` (``data_batch_1.bin`` ...
``data_batch_5.bin`` for train, ``test_batch.bin`` for test) when all are
present; otherwise labels drawn from ``np.random.default_rng(0)`` (train,
50,000) or ``default_rng(1)`` (test, 10,000), and images rendered from the
labels by :func:`synthesize_cifar` with seed 0 or 1.  The numpy code is
the JAX package's, so the synthetic images are bit-identical to its own.
The port attempts no download (the machines it runs on have no network)
and writes nothing.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

_TRAIN_FILES = [f"data_batch_{i}.bin" for i in range(1, 6)]
_TEST_FILES = ["test_batch.bin"]
_REC = 1 + 3072
_SIZES = {"train": 50000, "test": 10000}


def parse_cifar_batch(data: bytes) -> Tuple[np.ndarray, np.ndarray]:
    """One binary batch (records of 1 label byte + 3x32x32 RGB bytes) ->
    ``[N, 3, 32, 32]`` float32 in [0, 1] and ``[N]`` int32 labels."""
    n = len(data) // _REC
    arr = np.frombuffer(data, np.uint8, count=n * _REC).reshape(n, _REC)
    labels = arr[:, 0].astype(np.int32)
    images = arr[:, 1:].reshape(n, 3, 32, 32).astype(np.float32) / 255.0
    return images, labels


def synthesize_cifar(labels: np.ndarray, seed: int = 0) -> np.ndarray:
    """``[N, 3, 32, 32]`` synthetic class-texture images (v2): each class is
    a sinusoidal grating of its own angle and frequency, with a per-sample
    colour, contrast, phase and jitter, a distractor grating of another
    class, a gray occluder patch and noise."""
    rng = np.random.default_rng(seed)
    n = len(labels)
    yy, xx = np.mgrid[0:32, 0:32].astype(np.float32)
    freqs = 1.0 + np.arange(10) * 0.35         # cycles per image
    angles = np.arange(10) * (np.pi / 10)
    colors = rng.uniform(0.3, 1.0, (n, 3)).astype(np.float32)
    out = np.empty((n, 3, 32, 32), np.float32)
    phase = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
    phase2 = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
    jitter = rng.normal(0, 0.12, (n, 2)).astype(np.float32)
    # the distractor is always another class (own+1..own+9 mod 10)
    distract = (labels + 1 + rng.integers(0, 9, n)) % 10
    contrast = rng.uniform(0.6, 1.0, n).astype(np.float32)
    occ_y = rng.integers(0, 24, n)
    occ_x = rng.integers(0, 24, n)
    occ_s = rng.integers(4, 11, n)
    occ_v = rng.uniform(0.2, 0.8, n).astype(np.float32)
    noise = rng.normal(0, 0.14, (n, 3, 32, 32)).astype(np.float32)

    def grating(cls_arr, idx, ph, amp):
        a = angles[cls_arr] + jitter[idx, 0]
        f = freqs[cls_arr] * (1.0 + jitter[idx, 1])
        proj = (np.cos(a)[:, None, None] * xx
                + np.sin(a)[:, None, None] * yy) / 32.0
        return amp * (0.5 + 0.5 * np.sin(
            2 * np.pi * f[:, None, None] * proj + ph[:, None, None]))

    for c in range(10):
        idx = np.nonzero(labels == c)[0]
        if len(idx) == 0:
            continue
        tex = grating(np.full(len(idx), c), idx, phase[idx], 1.0)
        tex = tex + grating(distract[idx], idx, phase2[idx], 0.35)
        tex = (tex / 1.35) * contrast[idx][:, None, None]
        out[idx] = tex[:, None, :, :] * colors[idx][:, :, None, None]
    for i in range(n):  # gray occluder patch
        s = occ_s[i]
        out[i, :, occ_y[i]:occ_y[i] + s, occ_x[i]:occ_x[i] + s] = occ_v[i]
    out += noise
    return np.clip(out, 0.0, 1.0)


class CIFAR10Dataset:
    """``images: [N, 3, 32, 32]`` float32 in [0, 1]; ``labels: [N]``
    int32; ``source`` is ``"binary"`` or ``"synthetic"``."""

    def __init__(self, train: bool = True, data_dir: str = "data/cifar10",
                 allow_synthetic: bool = True):
        split = "train" if train else "test"
        paths = [os.path.join(data_dir, f)
                 for f in (_TRAIN_FILES if train else _TEST_FILES)]
        if all(os.path.exists(p) for p in paths):
            parts = []
            for p in paths:
                with open(p, "rb") as f:
                    parts.append(parse_cifar_batch(f.read()))
            self.images = np.concatenate([im for im, _ in parts])
            self.labels = np.concatenate([lb for _, lb in parts])
            self.source = "binary"
        elif allow_synthetic:
            seed = 0 if train else 1
            self.labels = np.random.default_rng(seed).integers(
                0, 10, _SIZES[split]).astype(np.int32)
            self.images = synthesize_cifar(self.labels, seed)
            self.source = "synthetic"
        else:
            raise FileNotFoundError(
                f"CIFAR-10 {split} batches unavailable in {data_dir}")

    def __len__(self) -> int:
        return len(self.labels)

    def get_batch(self, indices) -> Tuple[np.ndarray, np.ndarray]:
        idx = np.asarray(indices)
        return self.images[idx], self.labels[idx]
