"""Batching data loader: port of ``taper_tpu/data/loader.py``
(``DataLoader``, ``PrefetchLoader``).

:class:`DataLoader` is the JAX package's, numpy through and through: it
shuffles with ``np.random.default_rng(seed)`` on construction and after
every epoch, so the two packages see the same batches in the same order
for the same seed.  ``drop_last=True`` (the default) drops the ragged tail
batch; ``drop_last=False`` pads it with index 0 up to ``batch_size`` and
``with_count=True`` yields its true size as a third element.

:class:`PrefetchLoader` stages each batch on the device from a worker
thread while the training loop computes on the one before.  On the card:
the worker copies each numpy array into pinned host memory and from there
to the device with a ``non_blocking`` copy on a side stream, records an
event after the copies, and the consumer's stream waits on that event
before it reads the batch; ``record_stream`` tells PyTorch's allocator
that the consumer's stream uses the batch, so its memory is not handed
out again while that stream may still read it.  On the CPU the arrays
become tensors without a copy.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np
import torch


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0,
                 with_count: bool = False):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.with_count = with_count
        self._rng = np.random.default_rng(seed)
        self._order: Optional[np.ndarray] = None
        self.reset()

    @property
    def num_batches(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def reset(self) -> None:
        n = len(self.dataset)
        self._order = (self._rng.permutation(n) if self.shuffle
                       else np.arange(n))

    def __len__(self) -> int:
        return self.num_batches

    def __iter__(self) -> Iterator[Tuple[np.ndarray, ...]]:
        n = len(self.dataset)
        bs = self.batch_size
        for start in range(0, n, bs):
            idx = self._order[start:start + bs]
            count = len(idx)
            if count < bs:
                if self.drop_last:
                    break
                idx = np.concatenate(
                    [idx, np.zeros(bs - count, dtype=idx.dtype)])
            x, y = self.dataset.get_batch(idx)
            if self.with_count:
                yield x, y, count
            else:
                yield x, y
        self.reset()  # reshuffle for the next epoch


class PrefetchLoader:
    """Stages the batches of ``loader`` on ``device`` up to ``prefetch``
    batches ahead, from a worker thread.  ``device=None`` means the card,
    and raises without one unless ``device="cpu"`` asks for the CPU (the
    Trainer's rule).  Leaving the loop early stops the worker after at
    most one more batch."""

    _DONE = object()

    def __init__(self, loader, prefetch: int = 2, device=None):
        if prefetch < 1:
            raise ValueError(f"prefetch must be >= 1, got {prefetch}")
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "PrefetchLoader: no CUDA device; it stages batches on "
                    "the card unless asked otherwise, so pass "
                    "device=\"cpu\" to stay on the CPU")
            device = "cuda"
        self.loader = loader
        self.prefetch = prefetch
        self.device = torch.device(device)

    def __len__(self) -> int:
        return len(self.loader)

    def _stage(self, batch, stream):
        """The batch's arrays as tensors on the device, and the event after
        their copies (None on the CPU)."""
        if self.device.type == "cpu":
            return tuple(torch.from_numpy(np.asarray(b))
                         if isinstance(b, np.ndarray) else b
                         for b in batch), None
        with torch.cuda.stream(stream):
            out = tuple(
                torch.from_numpy(np.ascontiguousarray(b)).pin_memory()
                .to(self.device, non_blocking=True)
                if isinstance(b, np.ndarray) else b for b in batch)
            event = torch.cuda.Event()
            event.record(stream)
        return out, event

    def _hand_over(self, batch, event):
        """Make the consumer's stream wait for the copies and mark the
        tensors as used by it."""
        if event is None:
            return batch
        current = torch.cuda.current_stream(self.device)
        current.wait_event(event)
        for b in batch:
            if isinstance(b, torch.Tensor):
                b.record_stream(current)
        return batch

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        stream = (torch.cuda.Stream(self.device)
                  if self.device.type == "cuda" else None)

        def worker():
            try:
                for batch in self.loader:
                    if stop.is_set():      # the consumer left early
                        return
                    q.put(self._stage(batch, stream))
                    if stop.is_set():
                        return
            except BaseException as e:  # raised again in the consumer
                q.put(e)
                return
            q.put(self._DONE)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is self._DONE:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield self._hand_over(*item)
        finally:
            # early exit: the worker stops after at most one more batch;
            # drain the queue so that a worker blocked on a full one wakes
            stop.set()
            while t.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    pass
                t.join(timeout=0.01)
