"""Training loop: port of ``taper_tpu/train.py`` (``Metrics``, and
``Trainer`` with ``train_step``, ``train_epoch``, ``fit``,
``fit_device``, ``evaluate``, ``reset_parameters`` and the checkpoints:
``save_checkpoint``, ``load_checkpoint``, ``restore``, ``fit``'s
``ckpt_manager`` and ``fit_device``'s ``checkpoint_path``/``save_every``/
``resume``).

The JAX Trainer compiles the forward, backward and update of a step (or
of a whole epoch, ``fit_device``) into one XLA program.  PyTorch runs
eagerly: a step is the model's forward through the port's kernels,
``loss.backward()`` through their autograd Functions, and the
optimizer's in-place update (K17 on the card).  What the JAX epoch program
keeps on the device stays there: in ``fit_device`` the dataset (uploaded
once), the batch gather, and the running loss and accuracy sums; in
``train_epoch`` (``fit`` over a loader) the per-step losses.  The host
synchronises once per epoch, to read that epoch's metrics; a ``.item()``
per step would serialise the loop.

BatchNorm's running statistics are buffers that follow the model's mode:
a training step runs in ``model.train()``, evaluation in
``model.eval()``, as JAX's ``apply_train`` and ``apply`` do.

``fit_device``'s batch order for epoch ``e`` is a permutation drawn from a
``torch.Generator`` seeded from ``(seed, e)`` alone, as JAX draws it from
``fold_in(key, e)``: a run resumed at epoch ``e`` sees the batches the
interrupted run would have seen.  The numbers are not JAX's key stream, so
the two packages see different batches there; ``fit`` takes its batches
from the loader it is given (the port's ``DataLoader`` gives JAX's order
for the same seed).

A checkpoint holds ``{"params", "opt_state"}`` in the JAX package's
``.npz`` format (``utils/checkpoint.py``): the parameters (and BatchNorm
statistics) under the JAX tree's names, and the optimizer's ``lr``, step
count and moments.

``train_uses_rng=True`` gives every training step a ``torch.Generator``
(the model is called ``model(x, train=True, generator=g)``, as JAX calls
``apply(p, x, train=True, rng=key)``), seeded from the Trainer's seed and
a counter alone: ``train_epoch``'s global step count (JAX:
``fold_in(dropout_key, step)``) or ``fit_device``'s epoch and step in it
(JAX: ``fold_in(fold_in(dropout_key, epoch), step)``), so a resumed
``fit_device`` draws the masks the interrupted run would have drawn.  The
bits are not ``jax.random``'s.

Not ported yet: ``fit_device_fused``, meshes (data/tensor parallel,
ZeRO-1) and augmentation.  Their arguments raise
``NotImplementedError``.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch

from taper_tpu_torch import losses as L
from taper_tpu_torch import optim as opt_mod
from taper_tpu_torch.utils import checkpoint as ckpt
from taper_tpu_torch.utils import not_ported

# fit_device's batch order: epoch e draws its permutation from the seed
# seed + 1 + e * _EPOCH_STRIDE (epoch 0 keeps the seed + 1 of a generator
# drawn in sequence)
_EPOCH_STRIDE = 0x9E3779B9
_MASK64 = 2 ** 64 - 1


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def stream_seed(*parts: int) -> int:
    """A 63-bit generator seed from integers (seed, counters), each folded
    in by splitmix64: the counter-based stream of the Trainer's dropout
    generators, the same parts giving the same seed."""
    h = 0
    for x in parts:
        h = _splitmix64(h ^ _splitmix64(x & _MASK64))
    return h >> 1


@dataclass
class Metrics:
    """Per-epoch history of ``fit`` and ``fit_device``.  With ``log_path``
    set, every :meth:`record` also appends one JSON line ``{ts, epoch,
    train_loss, train_acc, val_loss, val_acc, epoch_s}`` to that file."""

    train_loss: List[float] = field(default_factory=list)
    train_acc: List[float] = field(default_factory=list)
    val_loss: List[float] = field(default_factory=list)
    val_acc: List[float] = field(default_factory=list)
    epoch_times: List[float] = field(default_factory=list)
    log_path: Optional[str] = None

    def record(self, tl, ta, vl, va, dt) -> None:
        self.train_loss.append(float(tl))
        self.train_acc.append(float(ta))
        self.val_loss.append(float(vl))
        self.val_acc.append(float(va))
        self.epoch_times.append(float(dt))
        if self.log_path:
            with open(self.log_path, "a") as f:
                f.write(json.dumps(
                    {"ts": time.time(), "epoch": len(self.train_loss),
                     "train_loss": float(tl), "train_acc": float(ta),
                     "val_loss": float(vl), "val_acc": float(va),
                     "epoch_s": float(dt)}) + "\n")

    def print_last(self) -> None:
        e = len(self.train_loss)
        print(f"epoch {e:3d} | train loss {self.train_loss[-1]:.4f} "
              f"acc {self.train_acc[-1]*100:5.2f}% | val loss "
              f"{self.val_loss[-1]:.4f} acc {self.val_acc[-1]*100:5.2f}% | "
              f"{self.epoch_times[-1]:.2f}s")

    def plot_summary(self) -> None:
        if not self.val_acc:
            print("no epochs recorded")
            return
        total = sum(self.epoch_times)
        print("-" * 60)
        print(f"best val acc  : {max(self.val_acc) * 100:.2f}%")
        print(f"final val acc : {self.val_acc[-1] * 100:.2f}%")
        print(f"total time    : {total:.2f}s "
              f"({total / len(self.epoch_times):.2f}s/epoch)")
        print("-" * 60)


class Trainer:
    """Owns a model and its optimizer on one device.

    The constructor draws the model's parameters from a generator seeded
    with ``seed`` (as the JAX Trainer calls ``model.init`` with its seed's
    key), moves the model to ``device`` (the card by default; without one
    the constructor raises unless ``device="cpu"`` asks for the CPU) and
    binds the optimizer to its parameters.
    """

    def __init__(self, model: torch.nn.Module,
                 optimizer: opt_mod.Optimizer,
                 scheduler: Optional[opt_mod.LRScheduler] = None,
                 loss_fn: Callable = L.cross_entropy_loss, seed: int = 0,
                 device=None, mesh=None,
                 tensor_parallel: bool = False, zero1: bool = False,
                 train_uses_rng: bool = False,
                 log_path: Optional[str] = None,
                 augment: Optional[Callable] = None):
        not_ported("Trainer", mesh=mesh is not None,
                   tensor_parallel=tensor_parallel, zero1=zero1,
                   augment=augment is not None)
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "Trainer: no CUDA device; the Trainer runs on the card "
                    "unless asked otherwise, so pass device=\"cpu\" to "
                    "train on the CPU")
            device = "cuda"
        self.device = torch.device(device)
        self.model = model
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.loss_fn = loss_fn
        self.train_uses_rng = train_uses_rng
        self.log_path = log_path
        self._initial_lr = optimizer.lr
        self.model.to(self.device)
        self.reset_parameters(seed)

    def reset_parameters(self, seed: int = 0) -> None:
        """A fresh training run: parameters (and BatchNorm statistics)
        drawn from ``seed``, optimizer state, metrics, the scheduler and
        ``fit_device``'s batch order."""
        self.model.reset_parameters(torch.Generator().manual_seed(seed))
        self.optimizer.init(self.model.named_parameters())
        self.metrics = Metrics(log_path=self.log_path)
        self.optimizer.lr = self._initial_lr
        if self.scheduler is not None:
            self.scheduler.reset()
        self._seed = seed
        # epochs completed before this process (set by restore): keeps
        # fit's checkpoint numbering global across resumes
        self._epoch_offset = 0
        # train_epoch's steps so far: its dropout generators' counter
        self._step_count = 0

    def _epoch_order(self, n: int, epoch: int) -> torch.Tensor:
        """fit_device's permutation of ``n`` samples for ``epoch``, from
        the seed and the epoch alone."""
        gen = torch.Generator().manual_seed(
            (self._seed + 1 + epoch * _EPOCH_STRIDE) % 2 ** 63)
        return torch.randperm(n, generator=gen)

    def _dropout_generator(self, *counters: int):
        """The step's generator (CPU) under ``train_uses_rng``, from the
        seed and ``counters`` alone; None otherwise."""
        if not self.train_uses_rng:
            return None
        return torch.Generator().manual_seed(
            stream_seed(self._seed, 0xD809, *counters))

    # -- steps -------------------------------------------------------------

    def train_step(self, x, y, generator=None):
        """Forward, backward and update on one batch (tensors on the
        trainer's device).  Returns the loss and the accuracy as 0-d
        tensors on the device, without a host sync.  Under
        ``train_uses_rng`` the model draws its dropout masks from
        ``generator``."""
        self.model.train()
        if self.train_uses_rng:
            logits = self.model(x, train=True, generator=generator)
        else:
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
                   save_every: int = 1, resume: bool = False) -> Metrics:
        """Train with both splits resident on the device: per epoch, a
        shuffled pass of ``len // batch_size`` full batches, an evaluation
        of the validation split, the scheduler step (fed the validation
        loss) and the early stop once validation accuracy exceeds
        ``early_stop_acc``.

        With ``checkpoint_path``, the parameters, the optimizer state and
        the epoch count are saved every ``save_every`` epochs, and
        ``resume=True`` continues an interrupted run from that file: it
        trains epochs ``[done, epochs)`` with the scheduler fast-forwarded
        past the ``done`` epochs and each epoch's own batch order."""
        start_epoch = 0
        if resume and checkpoint_path and os.path.exists(checkpoint_path):
            start_epoch = int(self._load(checkpoint_path).get("epochs", 0))
            self._fast_forward_scheduler(start_epoch)
            if verbose and start_epoch:
                print(f"resumed from {checkpoint_path} at epoch "
                      f"{start_epoch}")
        ti, tl = self._to_device(train_images, train_labels)
        vi, vl = self._to_device(val_images, val_labels)
        n, nv = len(tl), len(vl)
        steps = n // batch_size
        if steps == 0:
            raise ValueError(f"fit_device: {n} samples make no batch of "
                             f"{batch_size}")
        for e in range(start_epoch, epochs):
            t0 = time.perf_counter()
            order = self._epoch_order(n, e)
            order = order[:steps * batch_size].view(steps, batch_size)
            order = order.to(self.device)
            loss_sum = torch.zeros((), device=self.device)
            acc_sum = torch.zeros((), device=self.device)
            for i, idx in enumerate(order):
                loss, acc = self.train_step(ti.index_select(0, idx),
                                            tl.index_select(0, idx),
                                            self._dropout_generator(e, i))
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
            if checkpoint_path and (e + 1) % max(save_every, 1) == 0:
                ckpt.save_checkpoint(checkpoint_path, self._state_tree(),
                                     metadata={"epochs": e + 1})
            if va_acc > early_stop_acc:
                if verbose:
                    print(f"early stop: val acc {va_acc*100:.2f}% > "
                          f"{early_stop_acc*100:.1f}%")
                break
        return self.metrics

    # -- epoch loops over a loader -----------------------------------------

    def train_epoch(self, loader, log_every: int = 0) -> Dict[str, float]:
        """One pass over ``loader``'s ``(images, labels)`` batches (numpy
        arrays or tensors, moved to the trainer's device).  The per-step
        losses stay on the device and the host syncs once at the end,
        except every ``log_every`` steps when that is set."""
        losses, accs = [], []
        for i, (bx, by) in enumerate(loader):
            self._step_count += 1
            loss, acc = self.train_step(
                *self._to_device(bx, by),
                self._dropout_generator(self._step_count))
            losses.append(loss)
            accs.append(acc)
            if log_every and (i + 1) % log_every == 0:
                print(f"  batch {i + 1}/{len(loader)} loss "
                      f"{float(loss):.4f} acc {float(acc) * 100:.2f}%")
        if not losses:
            return {"loss": 0.0, "acc": 0.0}
        loss, acc = torch.stack([torch.stack(losses).mean(),
                                 torch.stack(accs).mean()]).tolist()
        return {"loss": loss, "acc": acc}

    def fit(self, train_loader, val_images, val_labels, epochs: int,
            early_stop_acc: float = 0.99, log_every: int = 0,
            verbose: bool = True, ckpt_manager=None) -> Metrics:
        """Epoch loop over a loader: train, evaluate the validation split,
        step the scheduler (fed the validation loss), optionally save a
        checkpoint, stop early once validation accuracy exceeds
        ``early_stop_acc``.

        ``ckpt_manager`` (a :class:`utils.checkpoint.CheckpointManager`)
        saves ``{params, opt_state}`` after every epoch under the global
        epoch index (``restore``'s count plus this process's epochs), with
        the validation accuracy as its metric when its mode is ``'max'``
        and the validation loss otherwise."""
        for _ in range(epochs):
            t0 = time.perf_counter()
            tr = self.train_epoch(train_loader, log_every=log_every)
            va = self.evaluate(val_images, val_labels)
            self.metrics.record(tr["loss"], tr["acc"], va["loss"],
                                va["acc"], time.perf_counter() - t0)
            if verbose:
                self.metrics.print_last()
            if self.scheduler is not None:
                self.optimizer.lr = self.scheduler.step(va["loss"])
            if ckpt_manager is not None:
                epoch = self._epoch_offset + len(self.metrics.val_acc)
                metric = (va["acc"] if ckpt_manager.mode == "max"
                          else va["loss"])
                ckpt_manager.save(
                    epoch, self._state_tree(),
                    metadata={"epochs": float(epoch), "val_acc": va["acc"]},
                    metric=metric)
            if va["acc"] > early_stop_acc:
                if verbose:
                    print(f"early stop: val acc {va['acc'] * 100:.2f}% > "
                          f"{early_stop_acc * 100:.1f}%")
                break
        if ckpt_manager is not None:
            ckpt_manager.wait()
        return self.metrics

    # -- checkpoints -------------------------------------------------------

    def _trainable_names(self):
        return [n for n, p in self.model.named_parameters()
                if p.requires_grad]

    def _state_tree(self) -> dict:
        """``{"params", "opt_state"}``: the model's tensors and the
        optimizer's state, as the JAX Trainer checkpoints them."""
        return {"params": ckpt.params_tree(self.model),
                "opt_state": self.optimizer.state_tree(
                    self._trainable_names())}

    def _take(self, tree) -> None:
        """Load a restored ``{"params", "opt_state"}`` tree in place."""
        ckpt.copy_tree_(ckpt.params_tree(self.model), tree["params"])
        self.optimizer.load_state_tree(tree["opt_state"],
                                       self._trainable_names())

    def _load(self, path: str) -> dict:
        tree, meta = ckpt.load_checkpoint(path, self._state_tree())
        self._take(tree)
        return meta

    def save_checkpoint(self, path: str) -> None:
        ckpt.save_checkpoint(path, self._state_tree(),
                             metadata={"epochs": len(self.metrics.val_acc)})

    def load_checkpoint(self, path: str) -> None:
        self._load(path)

    def _fast_forward_scheduler(self, epochs: int) -> None:
        """Advance the LR scheduler past ``epochs`` completed epochs.
        Deterministic schedules recompute lr from the epoch count and set
        it; ReduceLROnPlateau cannot replay its metrics, so only its epoch
        count advances and the loaded lr stays (the optimizer's, which the
        checkpoint restored)."""
        if self.scheduler is None or not epochs:
            return
        lr_loaded = self.optimizer.lr
        for _ in range(epochs):
            lr = self.scheduler.step(None)
        if isinstance(self.scheduler, opt_mod.ReduceLROnPlateau):
            self.scheduler.lr = lr_loaded
        else:
            self.optimizer.lr = lr

    def restore(self, manager, step: Optional[int] = None) -> int:
        """Resume ``{params, opt_state}`` from a CheckpointManager: loads
        ``step`` (default: the latest in its manifest), fast-forwards the
        scheduler by the stored epoch count and returns that count (pass
        ``epochs - resumed`` to ``fit`` to finish an interrupted run).
        Later ``fit(..., ckpt_manager=...)`` saves continue the global
        epoch numbering."""
        tree, meta = manager.restore(self._state_tree(), step=step)
        self._take(tree)
        epochs = int(meta.get("epochs", 0))
        self._epoch_offset = epochs
        self._fast_forward_scheduler(epochs)
        return epochs
