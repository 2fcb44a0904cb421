"""The batching loaders (taper_tpu_torch/data/loader.py) against the JAX
package's (taper_tpu/data/loader.py): ``DataLoader`` gives the same
batches in the same order for the same seed over two epochs, with and
without ``drop_last`` and ``with_count``; ``PrefetchLoader`` on the CPU
yields the wrapped loader's batches as tensors, and its worker stops
after at most one more batch when the loop is left early."""

import threading
import time

import numpy as np
import pytest
import torch

from taper_tpu.data import loader as jl
from taper_tpu_torch.data import loader as pl


class _Data:
    def __init__(self, n):
        self.images = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
        self.labels = np.arange(n, dtype=np.int32)

    def __len__(self):
        return len(self.labels)

    def get_batch(self, idx):
        idx = np.asarray(idx)
        return self.images[idx], self.labels[idx]


@pytest.mark.parametrize("kw", [
    dict(drop_last=True), dict(drop_last=False),
    dict(drop_last=False, with_count=True), dict(shuffle=False)],
    ids=["drop_last", "padded", "with_count", "no_shuffle"])
def test_dataloader_order_matches_jax_over_two_epochs(kw):
    data = _Data(23)
    ours = pl.DataLoader(data, 5, seed=3, **kw)
    ref = jl.DataLoader(data, 5, seed=3, **kw)
    assert len(ours) == len(ref)
    for _ in range(2):
        got, want = list(ours), list(ref)
        assert len(got) == len(want) == len(ours)
        for a, b in zip(got, want):
            assert len(a) == len(b)
            for u, v in zip(a, b):
                np.testing.assert_array_equal(u, v)


def test_prefetch_loader_on_the_cpu_yields_the_same_batches():
    data = _Data(40)
    inner = pl.DataLoader(data, 8, seed=1, with_count=True)
    ref = [b for b in pl.DataLoader(data, 8, seed=1, with_count=True)]
    batches = list(pl.PrefetchLoader(inner, prefetch=2, device="cpu"))
    assert len(batches) == len(ref) == 5
    for (x, y, n), (rx, ry, rn) in zip(batches, ref):
        assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
        assert torch.equal(x, torch.from_numpy(rx))
        assert torch.equal(y, torch.from_numpy(ry)) and n == rn


def test_prefetch_worker_stops_on_an_early_break():
    pulled = []

    class Slow:
        def __len__(self):
            return 100

        def __iter__(self):
            for i in range(100):
                pulled.append(i)
                yield (np.full(2, i, np.float32),)

    before = threading.active_count()
    loader = pl.PrefetchLoader(Slow(), prefetch=1, device="cpu")
    for i, (x,) in enumerate(loader):
        assert float(x[0]) == i
        if i == 2:
            break
    deadline = time.monotonic() + 5
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.01)
    assert threading.active_count() == before
    # 3 consumed, at most one in the queue and one more staged
    assert len(pulled) <= 3 + 2


def test_prefetch_raises_the_worker_error_and_wants_a_card(monkeypatch):
    class Broken:
        def __len__(self):
            return 1

        def __iter__(self):
            raise OSError("disk gone")
            yield

    with pytest.raises(OSError, match="disk gone"):
        list(pl.PrefetchLoader(Broken(), device="cpu"))
    with pytest.raises(ValueError):
        pl.PrefetchLoader(Broken(), prefetch=0, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        pl.PrefetchLoader(Broken())
