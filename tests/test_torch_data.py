"""Data of the port (taper_tpu_torch/data) against the JAX package's
(taper_tpu/data): the synthetic digit renderer and the IDX parsers."""

import struct

import numpy as np
import pytest

from taper_tpu.data import mnist as jmnist
from taper_tpu.data.synth import synthesize_images_numpy as jax_render
from taper_tpu_torch.data import (
    MNISTDataset, parse_idx_images, parse_idx_labels,
    synthesize_images_numpy)


@pytest.mark.parametrize("seed", [0, 1])
def test_renderer_matches_jax_package(seed):
    labels = np.random.default_rng(seed).integers(0, 10, 512)
    out = synthesize_images_numpy(labels, seed)
    ref = jax_render(labels, seed)
    assert out.shape == (512, 784) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


def _idx_files(n=5, rows=3, cols=4):
    rng = np.random.default_rng(0)
    pixels = rng.integers(0, 256, n * rows * cols).astype(np.uint8)
    labels = rng.integers(0, 10, n).astype(np.uint8)
    images = struct.pack(">IIII", 0x803, n, rows, cols) + pixels.tobytes()
    return images, struct.pack(">II", 0x801, n) + labels.tobytes()


def test_idx_parsers_match_jax_package():
    """Pixels to [0, 1]: the JAX package's threaded C++ parser scales by
    1/255 where the port divides by 255, 1 ulp apart at most."""
    images, labels = _idx_files()
    np.testing.assert_allclose(parse_idx_images(images),
                               jmnist.parse_idx_images(images), rtol=0,
                               atol=1e-7)
    np.testing.assert_array_equal(parse_idx_labels(labels),
                                  jmnist.parse_idx_labels(labels))


def test_idx_parsers_reject_bad_files():
    images, labels = _idx_files()
    with pytest.raises(ValueError, match="magic"):
        parse_idx_images(labels + bytes(8))
    with pytest.raises(ValueError, match="header"):
        parse_idx_images(labels)
    with pytest.raises(ValueError, match="truncated"):
        parse_idx_images(images[:-1])
    with pytest.raises(ValueError, match="range"):
        parse_idx_labels(struct.pack(">II", 0x801, 1) + bytes([12]))


def test_dataset_reads_idx_files_then_falls_back_to_synthetic(tmp_path):
    images, labels = _idx_files()
    (tmp_path / "test_images").write_bytes(images)
    (tmp_path / "test_labels").write_bytes(labels)
    ds = MNISTDataset(train=False, data_dir=str(tmp_path))
    assert ds.source == "idx" and len(ds) == 5
    x, y = ds.get_batch([4, 0])
    np.testing.assert_array_equal(y, parse_idx_labels(labels)[[4, 0]])
    assert x.shape == (2, 12)

    with pytest.raises(FileNotFoundError):
        MNISTDataset(train=True, data_dir=str(tmp_path),
                     allow_synthetic=False)
    (tmp_path / "test_images").unlink()
    synth = MNISTDataset(train=False, data_dir=str(tmp_path))
    assert synth.source == "synthetic"
    np.testing.assert_array_equal(synth.labels, parse_idx_labels(labels))
    np.testing.assert_array_equal(
        synth.images, synthesize_images_numpy(synth.labels, 1))


def test_fully_synthetic_split_uses_the_seeded_labels(tmp_path):
    ds = MNISTDataset(train=False, data_dir=str(tmp_path / "none"))
    assert ds.source == "synthetic" and len(ds) == 10000
    np.testing.assert_array_equal(
        ds.labels, np.random.default_rng(1).integers(0, 10, 10000))
    np.testing.assert_array_equal(ds.images[:64],
                                  jax_render(ds.labels[:64], 1))
