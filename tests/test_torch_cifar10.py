"""The CIFAR-10 dataset (taper_tpu_torch/data/cifar10.py) against the JAX
package's (taper_tpu/data/cifar10.py): the synthetic v2 renderer gives
the same images bit for bit, and the binary batch parser reads a
hand-made buffer."""

import numpy as np
import pytest

from taper_tpu.data import cifar10 as jc
from taper_tpu_torch.data import cifar10 as pc


@pytest.mark.parametrize("seed", [0, 1])
def test_synthetic_images_equal_jax_bit_for_bit(seed):
    labels = np.random.default_rng(seed).integers(0, 10, 200).astype(
        np.int32)
    out = pc.synthesize_cifar(labels, seed)
    ref = jc.synthesize_cifar(labels, seed)
    assert out.shape == (200, 3, 32, 32) and out.dtype == np.float32
    np.testing.assert_array_equal(out, ref)
    assert 0.0 <= out.min() and out.max() <= 1.0


def test_parse_cifar_batch_reads_a_hand_made_buffer():
    rng = np.random.default_rng(0)
    labels = np.array([3, 0, 9], np.uint8)
    pixels = rng.integers(0, 256, (3, 3072), dtype=np.uint8)
    data = b"".join(bytes([lb]) + px.tobytes()
                    for lb, px in zip(labels, pixels))
    images, got = pc.parse_cifar_batch(data + b"\x01")  # a stray byte
    assert got.dtype == np.int32 and got.tolist() == [3, 0, 9]
    assert images.shape == (3, 3, 32, 32) and images.dtype == np.float32
    np.testing.assert_array_equal(images[1, 2, 31, 31],
                                  pixels[1, 3071] / np.float32(255.0))
    np.testing.assert_array_equal(images[2, 0].reshape(-1),
                                  pixels[2, :1024] / np.float32(255.0))
    ref_images, ref_labels = jc.parse_cifar_batch(data)
    np.testing.assert_array_equal(images, ref_images)
    np.testing.assert_array_equal(got, ref_labels)


def test_dataset_reads_local_batches_and_writes_nothing(tmp_path):
    rng = np.random.default_rng(1)
    rec = lambda n: b"".join(                            # noqa: E731
        bytes([i % 10]) + rng.integers(0, 256, 3072, dtype=np.uint8)
        .tobytes() for i in range(n))
    for i in range(1, 6):
        (tmp_path / f"data_batch_{i}.bin").write_bytes(rec(2))
    ds = pc.CIFAR10Dataset(train=True, data_dir=str(tmp_path))
    assert ds.source == "binary" and len(ds) == 10
    x, y = ds.get_batch([0, 3])
    assert x.shape == (2, 3, 32, 32) and y.tolist() == [0, 1]
    with pytest.raises(FileNotFoundError):
        pc.CIFAR10Dataset(train=False, data_dir=str(tmp_path),
                          allow_synthetic=False)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        f"data_batch_{i}.bin" for i in range(1, 6)]
