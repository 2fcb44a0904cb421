"""Optimizers, LR schedulers and training helpers: port of
``taper_tpu/optim.py`` (``SGD``, ``Adam``, ``AdamW`` at
``optim.py:129-264``; ``Adafactor``, ``Lion``, ``Muon`` with
``newton_schulz_orthogonalize`` at ``:267-554``; the schedulers at
``:557-688``; ``clip_grad_norm``, ``accumulate_gradients`` and ``EMA`` at
``:692-775``).

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

Adafactor, Lion and Muon have no kernel in the JAX package (they are
tree-wise ``jnp`` math there) and are plain PyTorch here, per parameter,
with their state f32 under JAX's slot names.  Muon's rule for which
leaves are matrices reads their names, so it binds
``init(model.named_parameters())``; every optimizer takes names or bare
tensors.

A parameter with ``requires_grad=False`` is left out of the update: the
port's form of the JAX package's ``running_``/``fq_`` masks (BatchNorm's
running statistics are buffers and never reach the optimizer).
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch

from taper_tpu_torch.ops import optim_kernels as K
from taper_tpu_torch.utils.checkpoint import flatten, nest, tree_map


class Optimizer:
    """Base: binds parameters with :meth:`init`, updates them with
    :meth:`step`."""

    def __init__(self, lr: float, weight_decay: float = 0.0):
        self.lr = float(lr)
        self.weight_decay = float(weight_decay)
        self.params: List[torch.Tensor] = []

    def init(self, params) -> "Optimizer":
        """Bind the trainable ones of ``params`` (``requires_grad``) and
        reset the optimizer state.  ``params`` are tensors, or ``(name,
        tensor)`` pairs as ``named_parameters()`` gives them (the names
        are kept in ``names``, None for a bare tensor)."""
        pairs = [p if isinstance(p, tuple) else (None, p) for p in params]
        pairs = [(n, p) for n, p in pairs if p.requires_grad]
        self.names = [n for n, _ in pairs]
        self.params = [p for _, p in pairs]
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
                mine = flatten(nest(dict(zip(names, tensors))), sep=".")
                for key, t in mine:
                    t.copy_(src[key])


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


def _f32_zeros(shape, like):
    return torch.zeros(shape, dtype=torch.float32, device=like.device)


class Adafactor(Optimizer):
    """Adafactor (Shazeer & Stern 2018): second moments of rank >= 2
    parameters factored over their last two axes (a row and a column
    vector, state ``v`` as ``(vr, vc)``), full for vectors (``(v,)``);
    beta2 = 1 - t^(-decay); updates clipped to RMS <= ``clip_threshold``;
    step size ``max(eps2, RMS(p)) * min(lr, 1/sqrt(t))`` with
    ``relative_step``, else ``lr``; a first moment ``m`` only where
    ``beta1 > 0``; decoupled weight decay (``optim.py:267-383``)."""

    def __init__(self, lr: float = 1e-2, beta1: float = 0.0,
                 decay: float = 0.8, eps1: float = 1e-30,
                 eps2: float = 1e-3, clip_threshold: float = 1.0,
                 weight_decay: float = 0.0, relative_step: bool = True):
        super().__init__(lr, weight_decay)
        self.beta1 = float(beta1)
        self.decay = float(decay)
        self.eps1 = float(eps1)
        self.eps2 = float(eps2)
        self.d = float(clip_threshold)
        self.relative_step = bool(relative_step)

    def _reset(self) -> None:
        self.t = 0
        self.v = [(_f32_zeros(p.shape[:-1], p),
                   _f32_zeros(p.shape[:-2] + p.shape[-1:], p))
                  if p.dim() >= 2 else (_f32_zeros(p.shape, p),)
                  for p in self.params]
        self.m = ([_f32_zeros(p.shape, p) for p in self.params]
                  if self.beta1 > 0.0 else None)

    def _slots(self):
        return {"v": self.v, **({"m": self.m} if self.m is not None else {})}

    def _update(self, grads) -> None:
        self.t += 1
        t = float(self.t)
        beta2 = 1.0 - t ** (-self.decay)
        rho = min(self.lr, 1.0 / math.sqrt(t)) if self.relative_step \
            else self.lr
        for i, (p, g, v) in enumerate(zip(self.params, grads, self.v)):
            g = torch.zeros_like(p) if g is None else g
            g = g.float()
            g2 = g * g + self.eps1
            if p.dim() >= 2:
                vr, vc = v
                vr.mul_(beta2).add_((1.0 - beta2) * g2.mean(-1))
                vc.mul_(beta2).add_((1.0 - beta2) * g2.mean(-2))
                # rank-1 reconstruction vr vc / mean(vr)
                denom = vr.mean(-1, keepdim=True)[..., None]
                vhat = vr[..., :, None] * vc[..., None, :] \
                    / denom.clamp_min(self.eps1)
            else:
                v[0].mul_(beta2).add_((1.0 - beta2) * g2)
                vhat = v[0]
            u = g * torch.rsqrt(vhat.clamp_min(self.eps1))
            rms_u = torch.sqrt((u * u).mean() + 1e-30)
            u = u / torch.clamp(rms_u / self.d, min=1.0)
            if self.m is not None:
                self.m[i].mul_(self.beta1).add_((1.0 - self.beta1) * u)
                u = self.m[i]
            if self.relative_step:
                rms_p = torch.sqrt((p.float() ** 2).mean() + 1e-30)
                alpha = rms_p.clamp_min(self.eps2) * rho
            else:
                alpha = rho
            p_out = p.float()
            if self.weight_decay != 0.0:
                p_out = p_out * (1.0 - alpha * self.weight_decay)
            p.copy_(p_out - alpha * u)


class Lion(Optimizer):
    """Lion (Chen et al. 2023): ``p -= lr sign(b1 m + (1 - b1) g)``, then
    ``m = b2 m + (1 - b2) g``; one f32 moment, decoupled weight decay
    (``optim.py:386-430``)."""

    def __init__(self, lr: float = 1e-4, betas=(0.9, 0.99),
                 weight_decay: float = 0.0):
        super().__init__(lr, weight_decay)
        self.b1, self.b2 = float(betas[0]), float(betas[1])

    def _reset(self) -> None:
        self.m = [_f32_zeros(p.shape, p) for p in self.params]

    def _slots(self):
        return {"m": self.m}

    def _update(self, grads) -> None:
        lr = self.lr
        for p, g, m in zip(self.params, grads, self.m):
            g = torch.zeros_like(p) if g is None else g
            g = g.float()
            u = torch.sign(self.b1 * m + (1.0 - self.b1) * g)
            p_out = p.float()
            if self.weight_decay != 0.0:
                p_out = p_out * (1.0 - lr * self.weight_decay)
            p.copy_(p_out - lr * u)
            m.mul_(self.b2).add_((1.0 - self.b2) * g)


def newton_schulz_orthogonalize(x, steps: int = 5, eps: float = 1e-7):
    """Approximately the nearest semi-orthogonal matrix to ``x [r, c]``:
    Muon's quintic Newton-Schulz iteration (coefficients 3.4445, -4.7750,
    2.0315), on the transpose where ``r > c`` so that the Gram matrix is
    the smaller; the singular values end in roughly [0.7, 1.3]
    (``optim.py:433-453``).  Plain ``torch.matmul``s, f32 in f32."""
    a, b, c = 3.4445, -4.7750, 2.0315
    transposed = x.shape[0] > x.shape[1]
    if transposed:
        x = x.t()
    x = x / (torch.linalg.norm(x) + eps)
    for _ in range(steps):
        gram = x @ x.t()
        x = a * x + (b * gram + c * (gram @ gram)) @ x
    return x.t() if transposed else x


class Muon(Optimizer):
    """Muon (Jordan et al. 2024): momentum orthogonalized by
    :func:`newton_schulz_orthogonalize` for matrix parameters (rank >= 2,
    flattened to ``[rows, rest]``; a rank-3 stacked MoE weight too, as
    JAX flattens it), scaled by ``sqrt(max(1, rows / rest))``; an internal
    Adam for the rest and for every name holding one of ``exclude``
    (``optim.py:456-554``).  The Adam side's lr rides at ``adam_lr / lr``
    of ``lr``, so a scheduler's lr scales both.  State: ``m`` for every
    parameter, ``v`` for the Adam side (a 0-d placeholder on matrices).
    Binds ``init(model.named_parameters())``: the rule reads the names."""

    def __init__(self, lr: float = 0.02, momentum: float = 0.95,
                 nesterov: bool = True, ns_steps: int = 5,
                 weight_decay: float = 0.0, adam_lr: float = 3e-4,
                 betas=(0.9, 0.95), eps: float = 1e-8,
                 exclude=("tok", "pos", "emb")):
        super().__init__(lr, weight_decay)
        self.momentum = float(momentum)
        self.nesterov = bool(nesterov)
        self.ns_steps = int(ns_steps)
        self.adam_lr = float(adam_lr)
        self.b1, self.b2 = float(betas[0]), float(betas[1])
        self.eps = float(eps)
        self.exclude = tuple(exclude)
        # the Adam side's lr over the Muon lr, fixed at construction, as
        # JAX's self.adam_lr / self.lr (the port's lr field is the live one)
        self.adam_ratio = self.adam_lr / self.lr

    def _is_matrix(self, name, p) -> bool:
        return p.dim() >= 2 and not any(
            t in name.lower() for t in self.exclude)

    def _reset(self) -> None:
        if None in self.names:
            raise ValueError("Muon reads the parameters' names: bind it "
                             "with init(model.named_parameters())")
        self.t = 0
        self.matrix = [self._is_matrix(n, p)
                       for n, p in zip(self.names, self.params)]
        self.m = [_f32_zeros(p.shape, p) for p in self.params]
        self.v = [_f32_zeros((), p) if mat else _f32_zeros(p.shape, p)
                  for p, mat in zip(self.params, self.matrix)]

    def _slots(self):
        return {"m": self.m, "v": self.v}

    def _update(self, grads) -> None:
        lr = self.lr
        adam_lr = lr * self.adam_ratio
        self.t += 1
        adam_step = (adam_lr * math.sqrt(1.0 - self.b2 ** self.t)
                     / (1.0 - self.b1 ** self.t))
        for p, g, m, v, mat in zip(self.params, grads, self.m, self.v,
                                   self.matrix):
            g = torch.zeros_like(p) if g is None else g
            g = g.float()
            p32 = p.float()
            if mat:
                m.mul_(self.momentum).add_(g)
                u = g + self.momentum * m if self.nesterov else m
                u2 = u.reshape(u.shape[0], -1)
                o = newton_schulz_orthogonalize(u2, self.ns_steps)
                scale = math.sqrt(max(1.0, u2.shape[0] / u2.shape[1]))
                if self.weight_decay != 0.0:
                    p32 = p32 * (1.0 - lr * self.weight_decay)
                p.copy_(p32 - lr * scale * o.reshape(p.shape))
            else:
                m.mul_(self.b1).add_((1.0 - self.b1) * g)
                v.mul_(self.b2).add_((1.0 - self.b2) * g * g)
                if self.weight_decay != 0.0:
                    p32 = p32 * (1.0 - adam_lr * self.weight_decay)
                p.copy_(p32 - adam_step * m / (torch.sqrt(v) + self.eps))


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


class WarmupCosineLR(LRScheduler):
    """Linear warmup to ``initial_lr`` over ``warmup`` steps, then cosine
    decay to ``min_lr`` over the remaining ``t_max - warmup``
    (``optim.py:653-688``)."""

    def __init__(self, initial_lr: float, t_max: int, warmup: int,
                 min_lr: float = 0.0):
        super().__init__(initial_lr)
        if not 0 <= warmup < t_max:
            raise ValueError(f"need 0 <= warmup ({warmup}) < t_max "
                             f"({t_max})")
        self.t_max = int(t_max)
        self.warmup = int(warmup)
        self.min_lr = float(min_lr)

    def _compute(self, metric):
        # step() counts before computing: the epoch is 1-based here
        t = self.epoch
        if self.warmup and t <= self.warmup:
            return self.initial_lr * t / self.warmup
        t = min(t - self.warmup, self.t_max - self.warmup)
        cos = (1.0 + math.cos(
            math.pi * t / max(self.t_max - self.warmup, 1))) / 2.0
        return self.min_lr + (self.initial_lr - self.min_lr) * cos

    def schedule_array(self) -> torch.Tensor:
        """Every step's lr, f32: entry k is the lr after step k + 1, as
        :meth:`step` gives them."""
        saved = self.epoch
        try:
            out = []
            for t in range(1, self.t_max + 1):
                self.epoch = t
                out.append(self._compute(None))
            return torch.tensor(out, dtype=torch.float32)
        finally:
            self.epoch = saved


# ---------------------------------------------------------------------------
# Training helpers over tensor lists
# ---------------------------------------------------------------------------

def clip_grad_norm(grads, max_norm: float):
    """Scale ``grads`` (a list of tensors, None entries skipped) in place
    so that their global L2 norm is at most ``max_norm``.  Returns
    ``(grads, norm)``, the norm a 0-d f32 tensor on the gradients' device
    (no host sync), as JAX returns ``(clipped_grads, global_norm)``."""
    live = [g for g in grads if g is not None]
    norm = torch.linalg.vector_norm(torch.stack(
        torch._foreach_norm([g.float() for g in live])))
    scale = torch.clamp(max_norm / norm.clamp_min(1e-12), max=1.0)
    torch._foreach_mul_(live, scale)
    return grads, norm


def accumulate_gradients(loss_fn, params, batches, *, has_aux=False):
    """Mean loss and mean gradients over microbatches, one backward each,
    so peak memory is one microbatch's activations.  ``loss_fn(batch)``
    returns the loss (or ``(loss, aux)`` with ``has_aux``) of the modules
    that own ``params``; ``batches`` is a tree of tensors with a leading
    microbatch axis.  Returns ``(mean_loss, mean_grads)`` (plus the aux
    values stacked along a leading axis with ``has_aux``): the gradients
    summed in f32, divided by the count and cast to each parameter's
    dtype, as JAX's scan does (``optim.py:706-738``); ``.grad`` is not
    touched."""
    params = list(params)
    n = next(flatten(batches))[1].shape[0]
    loss_sum = torch.zeros((), device=params[0].device)
    grad_sum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in params]
    auxs = []
    for i in range(n):
        out = loss_fn(tree_map(lambda t: t[i], batches))
        loss, aux = out if has_aux else (out, None)
        gs = torch.autograd.grad(loss, params, allow_unused=True)
        for acc, g in zip(grad_sum, gs):
            if g is not None:
                acc += g
        loss_sum += loss.detach()
        auxs.append(aux)
    mean_grads = [(g / n).to(p.dtype) for g, p in zip(grad_sum, params)]
    if has_aux:
        return loss_sum / n, mean_grads, tree_map(
            lambda *xs: torch.stack([torch.as_tensor(x).detach()
                                     for x in xs]), *auxs)
    return loss_sum / n, mean_grads


class EMA:
    """Exponential moving average of parameters: ``shadow = decay shadow +
    (1 - decay) params``, the shadow f32 whatever the parameters' dtype
    (a bf16 shadow would not move at decay >= ~0.99) (``optim.py:741-775``).
    Over lists of tensors; :meth:`update` works in place."""

    def __init__(self, decay: float = 0.999):
        if not 0.0 < decay < 1.0:
            raise ValueError(f"decay must be in (0, 1), got {decay}")
        self.decay = float(decay)

    def init(self, params):
        return [p.detach().float().clone() for p in params]

    @torch.no_grad()
    def update(self, shadow, params):
        d = self.decay
        torch._foreach_mul_(shadow, d)
        torch._foreach_add_(shadow, torch._foreach_mul(
            [p.float() for p in params], 1.0 - d))
        return shadow

    @staticmethod
    def as_params(shadow, like):
        """The shadow cast to the dtypes of ``like``."""
        return [s.to(p.dtype) for s, p in zip(shadow, like)]
