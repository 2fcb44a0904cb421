"""Optimizers and LR schedulers: port of ``taper_tpu/optim.py``
(``SGD``, ``Adam``, ``AdamW`` at ``optim.py:129-264``; the schedulers at
``:557-650``).

The JAX optimizers are pure ``(init, update)`` pairs over a parameter tree.
The port's update the parameters in place, as PyTorch's do:
``optimizer.init(params)`` binds the parameters and zeroes the moments,
``step()`` applies one update from each parameter's ``.grad``.  The
learning rate is the field ``lr``, which a scheduler sets once per epoch
(the JAX package keeps it in the optimizer state for the same reason: so
that changing it recompiles nothing).

The update formulas are written out and follow the JAX package's, which
are not ``torch.optim``'s:

* SGD: ``g += wd p``; ``m = mu m + g``; ``p -= lr m`` (``lr g`` without
  momentum);
* Adam: L2 decay folded into the gradient (``g += wd p``), and the bias
  correction folded into the step size,
  ``p -= lr sqrt(1 - b2^t) / (1 - b1^t) * m / (sqrt(v) + eps)``, where
  ``torch.optim.Adam`` divides by ``sqrt(v) / sqrt(1 - b2^t) + eps``: the
  two place ``eps`` differently, so they are different optimizers;
* AdamW: as Adam, with decoupled decay ``p *= 1 - lr wd`` instead.

On CUDA parameters the update is the fused kernel K17 (K17a for Adam and
AdamW, K17b for SGD; ``ops/optim_kernels.py``): one launch per step for
up to 256 parameter tensors, every parameter f32.  The JAX package keeps
its flat-vector kernel opt-in because of the ravel copies around it; the
port's multi-tensor kernel needs none, so it is the update of every
training path on the card.  On CPU parameters the same formulas run as
PyTorch ``_foreach`` ops (the kernel's plain version).

A parameter with ``requires_grad=False`` is left out of the update: the
port's form of the JAX package's ``running_``/``fq_`` masks (BatchNorm's
running statistics are buffers and never reach the optimizer).
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch

from taper_tpu_torch.ops import optim_kernels as K
from taper_tpu_torch.utils.checkpoint import flatten, nest


class Optimizer:
    """Base: binds parameters with :meth:`init`, updates them with
    :meth:`step`."""

    def __init__(self, lr: float, weight_decay: float = 0.0):
        self.lr = float(lr)
        self.weight_decay = float(weight_decay)
        self.params: List[torch.Tensor] = []

    def init(self, params) -> "Optimizer":
        """Bind the trainable ones of ``params`` (``requires_grad``) and
        reset the optimizer state."""
        self.params = [p for p in params if p.requires_grad]
        self._reset()
        return self

    def _reset(self) -> None:
        raise NotImplementedError

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        """One update of every bound parameter from its ``.grad``.  A
        parameter that the loss did not reach (``.grad`` is None, as for
        TinyGPT's position table under RoPE) takes a zero gradient, as the
        leaf of JAX's ``value_and_grad`` does: weight decay still moves
        it."""
        self._update([p.grad for p in self.params])

    def _update(self, grads) -> None:
        raise NotImplementedError

    def _zeros(self):
        return [torch.zeros_like(p) for p in self.params]

    def _slots(self):
        """The per-parameter state lists, by the JAX state's names."""
        return {}

    def state_tree(self, names) -> dict:
        """The optimizer state as the JAX package keeps it: ``lr``, the
        step count where there is one, and each moment as a tree under the
        bound parameters' ``names`` (the tensors themselves)."""
        if len(names) != len(self.params):
            raise ValueError(f"{len(names)} names for {len(self.params)} "
                             f"bound parameters")
        # lr in f64, the port's Python float, so a resumed run keeps it
        # to the bit (JAX keeps an f32 lr in its state)
        tree = {"lr": torch.tensor(self.lr, dtype=torch.float64)}
        if hasattr(self, "t"):
            tree["step"] = torch.tensor(self.t, dtype=torch.int32)
        for slot, tensors in self._slots().items():
            tree[slot] = nest(dict(zip(names, tensors)))
        return tree

    def load_state_tree(self, tree, names) -> None:
        """Take a loaded :meth:`state_tree` of the same ``names``: ``lr``
        and the step count, and the moments copied into the optimizer's
        own tensors in place."""
        self.lr = float(tree["lr"])
        if hasattr(self, "t"):
            self.t = int(tree["step"])
        with torch.no_grad():
            for slot, tensors in self._slots().items():
                src = dict(flatten(tree[slot], sep="."))
                for name, t in zip(names, tensors):
                    t.copy_(src[name])


class SGD(Optimizer):
    """SGD with optional momentum and L2 weight decay."""

    def __init__(self, lr: float, momentum: float = 0.0,
                 weight_decay: float = 0.0):
        super().__init__(lr, weight_decay)
        self.momentum = float(momentum)

    def _reset(self) -> None:
        self.m = self._zeros() if self.momentum else None

    def _slots(self):
        return {"m": self.m} if self.m is not None else {}

    def _update(self, grads) -> None:
        K.sgd_update(self.params, grads, self.m, lr=self.lr,
                     momentum=self.momentum, wd=self.weight_decay)


class Adam(Optimizer):
    """Adam with L2-style weight decay folded into the gradient."""

    decoupled = False

    def __init__(self, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(lr, weight_decay)
        self.b1, self.b2 = float(betas[0]), float(betas[1])
        self.eps = float(eps)

    def _reset(self) -> None:
        self.t = 0
        self.m = self._zeros()
        self.v = self._zeros()

    def _slots(self):
        return {"m": self.m, "v": self.v}

    def _update(self, grads) -> None:
        self.t += 1
        step_size = (self.lr * math.sqrt(1.0 - self.b2 ** self.t)
                     / (1.0 - self.b1 ** self.t))
        K.adam_update(self.params, grads, self.m, self.v, lr=self.lr,
                      step_size=step_size, b1=self.b1, b2=self.b2,
                      eps=self.eps, wd=self.weight_decay,
                      decoupled=self.decoupled)


class AdamW(Adam):
    """Adam with decoupled weight decay."""

    decoupled = True


# ---------------------------------------------------------------------------
# LR schedulers: host-side, stepped once per epoch; the Trainer writes
# ``step()``'s value into ``optimizer.lr``.
# ---------------------------------------------------------------------------

class LRScheduler:
    def __init__(self, initial_lr: float):
        self.initial_lr = float(initial_lr)
        self.lr = float(initial_lr)
        self.epoch = 0

    def step(self, metric: Optional[float] = None) -> float:
        self.epoch += 1
        self.lr = self._compute(metric)
        return self.lr

    def get_lr(self) -> float:
        return self.lr

    def reset(self) -> None:
        """Back to the initial schedule state (fresh training run)."""
        self.lr = self.initial_lr
        self.epoch = 0

    def _compute(self, metric) -> float:
        raise NotImplementedError


class StepLR(LRScheduler):
    """Multiply by ``gamma`` every ``step_size`` epochs."""

    def __init__(self, initial_lr: float, step_size: int,
                 gamma: float = 0.1):
        super().__init__(initial_lr)
        self.step_size = int(step_size)
        self.gamma = float(gamma)

    def _compute(self, metric):
        return self.initial_lr * self.gamma ** (self.epoch // self.step_size)


class ExponentialLR(LRScheduler):
    def __init__(self, initial_lr: float, gamma: float):
        super().__init__(initial_lr)
        self.gamma = float(gamma)

    def _compute(self, metric):
        return self.initial_lr * self.gamma ** self.epoch


class CosineAnnealingLR(LRScheduler):
    def __init__(self, initial_lr: float, t_max: int, min_lr: float = 0.0):
        super().__init__(initial_lr)
        self.t_max = int(t_max)
        self.min_lr = float(min_lr)

    def _compute(self, metric):
        t = min(self.epoch, self.t_max)
        cos = (1.0 + math.cos(math.pi * t / self.t_max)) / 2.0
        return self.min_lr + (self.initial_lr - self.min_lr) * cos


class ReduceLROnPlateau(LRScheduler):
    """Cut lr by ``factor`` after ``patience`` epochs without improvement."""

    def __init__(self, initial_lr: float, mode: str = "min",
                 factor: float = 0.1, patience: int = 10,
                 min_lr: float = 0.0, threshold: float = 1e-4):
        super().__init__(initial_lr)
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        self.mode = mode
        self.factor = float(factor)
        self.patience = int(patience)
        self.min_lr = float(min_lr)
        self.threshold = float(threshold)
        self.best: Optional[float] = None
        self.bad_epochs = 0

    def reset(self) -> None:
        super().reset()
        self.best = None
        self.bad_epochs = 0

    def _compute(self, metric):
        if metric is None:
            return self.lr
        improved = (self.best is None
                    or (self.mode == "min"
                        and metric < self.best - self.threshold)
                    or (self.mode == "max"
                        and metric > self.best + self.threshold))
        if improved:
            self.best = float(metric)
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.bad_epochs = 0
                return max(self.lr * self.factor, self.min_lr)
        return self.lr
