"""Fused optimizer updates: port of ``taper_tpu/ops/pallas/optim_kernels.py``
(``adam_update_flat`` / ``_adam_kernel``, ``sgd_update_flat`` /
``_sgd_kernel``).

The TPU kernels update one raveled vector of every parameter; the port
updates the parameter tensors in place, as a list.  :func:`adam_update`
and :func:`sgd_update` take lists of parameters, gradients (``None`` is a
zero gradient) and moments:

* on CUDA tensors: K17a/K17b (``csrc/optim.cu``), one launch per
  :data:`TABLE` tensors (a multi-tensor apply: no ravel, no copy), f32
  only, every tensor contiguous and 16-byte aligned;
* on CPU tensors: :func:`adam_reference` / :func:`sgd_reference`, the
  same formulas with PyTorch's multi-tensor ``_foreach`` ops.

The formulas are the JAX package's (``optim_kernels.py:60-101``), not
``torch.optim``'s; ``step_size = lr sqrt(1 - b2^t) / (1 - b1^t)`` comes
from the caller.  Frozen parameters are left out of the lists by the
caller (the port's form of the kernel's ``mask``).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import torch

from taper_tpu_torch.ops import _build
from taper_tpu_torch.ops import backend

# kMaxTensors and kChunk of csrc/optim.cu
TABLE = 256
CHUNK = 8192


def _grads(params, grads):
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(params, grads)]


def adam_reference(params, grads, ms, vs, *, lr, step_size, b1, b2, eps,
                   wd, decoupled) -> None:
    """Plain version of K17a, in place."""
    grads = _grads(params, grads)
    if wd and not decoupled:
        grads = torch._foreach_add(grads, params, alpha=wd)
    torch._foreach_mul_(ms, b1)
    torch._foreach_add_(ms, grads, alpha=1.0 - b1)
    torch._foreach_mul_(vs, b2)
    torch._foreach_addcmul_(vs, grads, grads, value=1.0 - b2)
    if wd and decoupled:
        torch._foreach_mul_(params, 1.0 - lr * wd)
    denom = torch._foreach_sqrt(vs)
    torch._foreach_add_(denom, eps)
    torch._foreach_addcdiv_(params, ms, denom, value=-step_size)


def sgd_reference(params, grads, ms, *, lr, momentum, wd) -> None:
    """Plain version of K17b, in place (``ms`` is None without
    momentum)."""
    grads = _grads(params, grads)
    if wd:
        grads = torch._foreach_add(grads, params, alpha=wd)
    step = grads
    if momentum:
        torch._foreach_mul_(ms, momentum)
        torch._foreach_add_(ms, grads)
        step = ms
    torch._foreach_add_(params, step, alpha=-lr)


def _pointers(tensors) -> ctypes.Array:
    return (ctypes.c_uint64 * len(tensors))(*(
        0 if t is None else t.data_ptr() for t in tensors))


def _check(name, params, grads, *states):
    for group in (params, *states):
        if group is not None:
            backend.check_kernel_args(name, *group, dtypes=(torch.float32,))
    for p, g in zip(params, grads):
        if g is not None:
            if g.shape != p.shape:
                raise ValueError(f"{name}: gradient {tuple(g.shape)} for "
                                 f"parameter {tuple(p.shape)}")
            backend.check_kernel_args(name, g, dtypes=(torch.float32,))
    devices = {t.device for group in (params, grads, *states)
               if group is not None for t in group if t is not None}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices: {devices}")


def _launch(name, fn, params, grads, states, *hyper) -> None:
    """One launch of ``fn`` per :data:`TABLE` tensors.  ``states`` holds
    the moment lists (a None list is a null array)."""
    stream = _build.stream(params[0])
    for lo in range(0, len(params), TABLE):
        hi = lo + TABLE
        part = [_pointers(params[lo:hi]), _pointers(grads[lo:hi])]
        part += [None if s is None else _pointers(s[lo:hi]) for s in states]
        sizes = (ctypes.c_int64 * len(params[lo:hi]))(
            *(p.numel() for p in params[lo:hi]))
        code = fn(*(None if a is None else ctypes.addressof(a)
                    for a in part), ctypes.addressof(sizes),
                  len(params[lo:hi]), *hyper, stream)
        _build.check(code, name)
        backend.count_launch(name)


def adam_update(params: Sequence[torch.Tensor],
                grads: Sequence[Optional[torch.Tensor]],
                ms: List[torch.Tensor], vs: List[torch.Tensor], *,
                lr: float, step_size: float, b1: float, b2: float,
                eps: float, wd: float, decoupled: bool) -> None:
    """One Adam (``decoupled=False``, L2 decay) or AdamW step over the
    lists, in place: K17a on CUDA, :func:`adam_reference` on the CPU."""
    params, grads = list(params), list(grads)
    if not params:
        return
    if not backend.on_cuda(*params):
        adam_reference(params, grads, ms, vs, lr=lr, step_size=step_size,
                       b1=b1, b2=b2, eps=eps, wd=wd, decoupled=decoupled)
        return
    _check("adam", params, grads, ms, vs)
    _launch("adam", _build.library().taper_adam, params, grads, (ms, vs),
            lr, step_size, b1, 1.0 - b1, b2, 1.0 - b2, eps, wd,
            int(decoupled))


def sgd_update(params: Sequence[torch.Tensor],
               grads: Sequence[Optional[torch.Tensor]],
               ms: Optional[List[torch.Tensor]], *, lr: float,
               momentum: float, wd: float) -> None:
    """One SGD step over the lists, in place (``ms`` None without
    momentum): K17b on CUDA, :func:`sgd_reference` on the CPU."""
    params, grads = list(params), list(grads)
    if not params:
        return
    if (ms is None) != (not momentum):
        raise ValueError("sgd_update: momentum buffers go with momentum")
    if not backend.on_cuda(*params):
        sgd_reference(params, grads, ms, lr=lr, momentum=momentum, wd=wd)
        return
    _check("sgd", params, grads, ms)
    _launch("sgd", _build.library().taper_sgd, params, grads, (ms,), lr,
            momentum, wd)
