"""Training loop: port of ``taper_tpu/train.py`` (``Metrics``, and
``Trainer`` with ``train_step``, ``fit_device`` and ``evaluate``).

The JAX Trainer compiles the forward, backward and update of a step (or
of a whole epoch, ``fit_device``) into one XLA program.  PyTorch runs
eagerly: a step is the model's forward through the port's kernels,
``loss.backward()`` through their autograd Functions, and the
optimizer's in-place update.  What the JAX epoch program keeps on the
device stays there: the dataset (uploaded once), the batch gather, and
the running loss and accuracy sums.  The host synchronises once per epoch,
to read that epoch's metrics; a ``.item()`` per step would serialise the
loop.

The batch order comes from a ``torch.Generator`` seeded from ``seed``, not
from JAX's key stream, so the two packages see different batches.

Not ported yet: ``fit`` over a ``DataLoader``, ``fit_device_fused``,
``reset_parameters``, JSON metric logs, checkpoints and ``restore``,
meshes (data/tensor parallel, ZeRO-1), augmentation, BatchNorm running
state and dropout keys.  Their arguments raise ``NotImplementedError``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch

from taper_tpu_torch import losses as L
from taper_tpu_torch import optim as opt_mod


@dataclass
class Metrics:
    """Per-epoch history of ``fit_device``."""

    train_loss: List[float] = field(default_factory=list)
    train_acc: List[float] = field(default_factory=list)
    val_loss: List[float] = field(default_factory=list)
    val_acc: List[float] = field(default_factory=list)
    epoch_times: List[float] = field(default_factory=list)

    def record(self, tl, ta, vl, va, dt) -> None:
        self.train_loss.append(float(tl))
        self.train_acc.append(float(ta))
        self.val_loss.append(float(vl))
        self.val_acc.append(float(va))
        self.epoch_times.append(float(dt))

    def print_last(self) -> None:
        e = len(self.train_loss)
        print(f"epoch {e:3d} | train loss {self.train_loss[-1]:.4f} "
              f"acc {self.train_acc[-1]*100:5.2f}% | val loss "
              f"{self.val_loss[-1]:.4f} acc {self.val_acc[-1]*100:5.2f}% | "
              f"{self.epoch_times[-1]:.2f}s")


def _not_ported(**args) -> None:
    for name, value in args.items():
        if value:
            raise NotImplementedError(
                f"Trainer: {name} is not ported to taper_tpu_torch yet "
                f"(ROADMAP.md, Queue 1)")


class Trainer:
    """Owns a model and its optimizer on one device.

    The constructor draws the model's parameters from a generator seeded
    with ``seed`` (as the JAX Trainer calls ``model.init`` with its seed's
    key), moves the model to ``device`` (CUDA when available, else the
    CPU) and binds the optimizer to its parameters.
    """

    def __init__(self, model: torch.nn.Module,
                 optimizer: opt_mod.Optimizer,
                 scheduler: Optional[opt_mod.LRScheduler] = None,
                 loss_fn: Callable = L.cross_entropy_loss, seed: int = 0,
                 device=None, mesh=None,
                 tensor_parallel: bool = False, zero1: bool = False,
                 augment: Optional[Callable] = None):
        _not_ported(mesh=mesh is not None, tensor_parallel=tensor_parallel,
                    zero1=zero1, augment=augment is not None)
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        self.device = torch.device(device)
        self.model = model
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.loss_fn = loss_fn
        self.metrics = Metrics()
        self.model.reset_parameters(torch.Generator().manual_seed(seed))
        self.model.to(self.device)
        self.optimizer.init(self.model.parameters())
        # batch order of fit_device, one permutation per epoch
        self._shuffle = torch.Generator().manual_seed(seed + 1)

    # -- steps -------------------------------------------------------------

    def train_step(self, x, y):
        """Forward, backward and update on one batch (tensors on the
        trainer's device).  Returns the loss and the accuracy as 0-d
        tensors on the device, without a host sync."""
        self.model.train()
        logits = self.model(x)
        loss = self.loss_fn(logits, y)
        self.optimizer.zero_grad()
        loss.backward()
        self.optimizer.step()
        return loss.detach(), L.accuracy(logits.detach(), y)

    @torch.no_grad()
    def _eval_sums(self, images, labels, batch_size: int):
        """Summed loss and count of correct predictions over a split, as
        device tensors."""
        self.model.eval()
        loss_sum = torch.zeros((), device=self.device)
        correct = torch.zeros((), device=self.device)
        for start in range(0, len(labels), batch_size):
            x = images[start:start + batch_size]
            y = labels[start:start + batch_size]
            logits = self.model(x)
            # a mean loss times the batch is the sum of per-sample losses
            loss_sum += self.loss_fn(logits, y) * len(y)
            correct += (logits.argmax(-1) == y.reshape(-1)).sum()
        return loss_sum, correct

    def evaluate(self, images, labels,
                 batch_size: int = 2048) -> Dict[str, float]:
        """Grad-free evaluation over a whole split."""
        images, labels = self._to_device(images, labels)
        loss_sum, correct = self._eval_sums(images, labels, batch_size)
        n = len(labels)
        loss_sum, correct = torch.stack([loss_sum, correct]).tolist()
        return {"loss": loss_sum / n, "acc": correct / n}

    def _to_device(self, images, labels):
        x = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        y = torch.as_tensor(labels, device=self.device).long()
        return x.contiguous(), y

    # -- epoch loop --------------------------------------------------------

    def fit_device(self, train_images, train_labels, val_images, val_labels,
                   epochs: int, batch_size: int = 256,
                   early_stop_acc: float = 0.99, verbose: bool = True,
                   eval_batch_size: int = 2000,
                   checkpoint_path: Optional[str] = None,
                   resume: bool = False) -> Metrics:
        """Train with both splits resident on the device: per epoch, a
        shuffled pass of ``len // batch_size`` full batches, an evaluation
        of the validation split, the scheduler step (fed the validation
        loss) and the early stop once validation accuracy exceeds
        ``early_stop_acc``."""
        _not_ported(checkpoint_path=checkpoint_path, resume=resume)
        ti, tl = self._to_device(train_images, train_labels)
        vi, vl = self._to_device(val_images, val_labels)
        n, nv = len(tl), len(vl)
        steps = n // batch_size
        if steps == 0:
            raise ValueError(f"fit_device: {n} samples make no batch of "
                             f"{batch_size}")
        for _ in range(epochs):
            t0 = time.perf_counter()
            order = torch.randperm(n, generator=self._shuffle)
            order = order[:steps * batch_size].view(steps, batch_size)
            order = order.to(self.device)
            loss_sum = torch.zeros((), device=self.device)
            acc_sum = torch.zeros((), device=self.device)
            for idx in order:
                loss, acc = self.train_step(ti.index_select(0, idx),
                                            tl.index_select(0, idx))
                loss_sum += loss
                acc_sum += acc
            va_loss, va_correct = self._eval_sums(vi, vl, eval_batch_size)
            # the epoch's one host sync
            tr_loss, tr_acc, va_loss, va_correct = torch.stack(
                [loss_sum, acc_sum, va_loss, va_correct]).tolist()
            tr_loss, tr_acc = tr_loss / steps, tr_acc / steps
            va_loss, va_acc = va_loss / nv, va_correct / nv
            self.metrics.record(tr_loss, tr_acc, va_loss, va_acc,
                                time.perf_counter() - t0)
            if verbose:
                self.metrics.print_last()
            if self.scheduler is not None:
                self.optimizer.lr = self.scheduler.step(va_loss)
            if va_acc > early_stop_acc:
                if verbose:
                    print(f"early stop: val acc {va_acc*100:.2f}% > "
                          f"{early_stop_acc*100:.1f}%")
                break
        return self.metrics
