"""Mixed-precision policy and loss scaling: port of
``taper_tpu/utils/amp.py``.

``Policy`` names the dtype roles of one model: where parameters live,
what the trunk computes in and what the model returns
(``TinyGPT(compute_dtype=torch.bfloat16)`` is ``tpu_bf16_policy()``'s
recipe, the name kept so that a reader finds its counterpart).  bf16
shares f32's exponent range and needs no loss scaling; float16 does, and
``StaticLossScale``/``DynamicLossScale`` give it.

The functions work on trees of tensors (nested dicts, lists and tuples)
and on lists of gradients.  The loss-scale state is two 0-d tensors, so
its transitions run on the device without a host sync.  The port's
optimizers update in place, so :func:`apply_if_finite` skips an update
by a host branch on one scalar (one sync a step, as
``torch.amp.GradScaler``'s), where JAX selects with ``jnp.where``.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from taper_tpu_torch.utils.checkpoint import flatten, tree_map

_ABBREV = {
    "f32": torch.float32, "float32": torch.float32,
    "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
    "f16": torch.float16, "float16": torch.float16,
    "f64": torch.float64, "float64": torch.float64,
}


def _as_dtype(d):
    return _ABBREV[d] if isinstance(d, str) else d


def _cast_floats(tree, dtype):
    """Floating tensor leaves cast to ``dtype``; others pass through."""
    return tree_map(lambda x: x.to(dtype) if torch.is_tensor(x)
                    and x.is_floating_point() else x, tree)


class Policy(NamedTuple):
    """Dtype roles of one model.
    ``Policy.from_string("params=float32,compute=bfloat16,output=float32")``
    or the short form ``"p=f32,c=bf16,o=f32"``."""

    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32
    output_dtype: Any = torch.float32

    @classmethod
    def from_string(cls, s: str) -> "Policy":
        kw = {}
        for part in s.replace(" ", "").split(","):
            if not part:
                continue
            k, v = part.split("=")
            key = {"p": "param_dtype", "params": "param_dtype",
                   "c": "compute_dtype", "compute": "compute_dtype",
                   "o": "output_dtype", "output": "output_dtype"}[k]
            kw[key] = _as_dtype(v)
        return cls(**kw)

    def cast_to_param(self, tree):
        return _cast_floats(tree, self.param_dtype)

    def cast_to_compute(self, tree):
        return _cast_floats(tree, self.compute_dtype)

    def cast_to_output(self, tree):
        return _cast_floats(tree, self.output_dtype)


def tpu_bf16_policy() -> Policy:
    """f32 parameters, bf16 compute, f32 outputs (losses and logits): the
    JAX package's TPU recipe, and the port's bf16 trunk on the card."""
    return Policy(torch.float32, torch.bfloat16, torch.float32)


# ---------------------------------------------------------------------------
# Loss scaling
# ---------------------------------------------------------------------------

def all_finite(tree) -> torch.Tensor:
    """0-d bool tensor: every element of every floating leaf is finite
    (True for a tree without one)."""
    leaves = [x for _, x in flatten(tree)
              if torch.is_tensor(x) and x.is_floating_point()]
    if not leaves:
        return torch.tensor(True)
    return torch.stack([torch.isfinite(x).all() for x in leaves]).all()


class LossScaleState(NamedTuple):
    """The loss scale (f32) and the count of finite steps since the last
    change (int32, dynamic only), both 0-d tensors."""

    scale: torch.Tensor
    good_steps: torch.Tensor


class StaticLossScale:
    """A fixed multiplier: ``loss * S`` forward, ``grads / S`` after."""

    def __init__(self, scale: float):
        self._scale = float(scale)

    def init(self, device=None) -> LossScaleState:
        return LossScaleState(
            torch.tensor(self._scale, dtype=torch.float32, device=device),
            torch.tensor(0, dtype=torch.int32, device=device))

    def scale_loss(self, loss, state: LossScaleState):
        return loss * state.scale.to(loss.dtype)

    def unscale(self, grads, state: LossScaleState):
        inv = 1.0 / state.scale
        return tree_map(lambda g: (g.float() * inv).to(g.dtype)
                        if torch.is_tensor(g) and g.is_floating_point()
                        else g, grads)

    def adjust(self, state: LossScaleState, grads_finite) -> LossScaleState:
        return state


class DynamicLossScale(StaticLossScale):
    """Halve the scale on a non-finite gradient, double it after
    ``growth_interval`` finite steps in a row; it stays in ``[1,
    max_scale]``."""

    def __init__(self, initial: float = 2.0 ** 15, factor: float = 2.0,
                 growth_interval: int = 2000,
                 max_scale: float = 2.0 ** 24):
        super().__init__(initial)
        self.factor = float(factor)
        self.growth_interval = int(growth_interval)
        self.max_scale = float(max_scale)

    def adjust(self, state: LossScaleState, grads_finite) -> LossScaleState:
        fin = torch.as_tensor(grads_finite, device=state.scale.device)
        good = torch.where(fin, state.good_steps + 1,
                           torch.zeros_like(state.good_steps))
        grow = good >= self.growth_interval
        scale = torch.where(
            fin,
            torch.where(grow, torch.clamp(state.scale * self.factor,
                                          max=self.max_scale), state.scale),
            torch.clamp(state.scale / self.factor, min=1.0))
        good = torch.where(grow | ~fin, torch.zeros_like(good), good)
        return LossScaleState(scale.float(), good.to(torch.int32))


def scaled_grad_step(loss_fn, params, ls, ls_state, *args, has_aux=False):
    """One mixed-precision gradient evaluation: ``loss_fn(*args)`` (the
    loss of the modules that own ``params``; ``(loss, aux)`` with
    ``has_aux``) scaled, differentiated with respect to ``params``,
    unscaled, checked finite, and the scale adjusted.  Returns ``(grads,
    loss, aux, grads_finite, new_ls_state)``: ``loss`` and ``grads``
    unscaled; apply the update only where ``grads_finite``
    (:func:`apply_if_finite`)."""
    params = list(params)
    out = loss_fn(*args)
    loss, aux = out if has_aux else (out, None)
    grads = torch.autograd.grad(ls.scale_loss(loss, ls_state), params,
                                allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, params)]
    grads = ls.unscale(grads, ls_state)
    fin = all_finite(grads)
    return grads, loss.detach(), aux, fin, ls.adjust(ls_state, fin)


def apply_if_finite(opt, grads, grads_finite) -> bool:
    """``opt.step()`` on ``grads`` (in the order of ``opt.params``) when
    ``grads_finite``; on a non-finite gradient nothing changes, neither
    the parameters nor the optimizer's state.  Returns whether it
    stepped."""
    if not bool(grads_finite):
        return False
    for p, g in zip(opt.params, grads):
        p.grad = g
    opt.step()
    return True
