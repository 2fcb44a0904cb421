"""Elementwise ops: port of ``taper_tpu/ops/pallas/elementwise.py``
(``relu``, ``sigmoid``, ``add``, ``mul``, ``fma``, ``sub``, ``div``; the
kernels ``_relu_kernel`` ... ``_div_kernel`` and their custom VJPs).

Each op is a ``torch.autograd.Function`` whose forward is K2 on CUDA
(``csrc/elementwise.cu``, f32 or bf16, computed in f32) and
:func:`elementwise_reference` on the CPU, and whose backward has the JAX
VJPs' formulas (``elementwise.py:97-208``) as plain tensor code on both
devices, as the JAX package's are XLA ops:

* ``relu`` and ``sigmoid`` save their output: ``g * (y > 0)`` and
  ``g * y * (1 - y)``;
* ``add`` gives ``(g, g)``, ``sub`` ``(g, -g)``, ``mul`` ``(g b, g a)``,
  ``fma`` ``(g b, g a, g)``, ``div`` ``(g / b, -g a / b^2)``.

The binary and ternary ops broadcast their operands outside the Function
(``elementwise.py:211-259``): the expanded operands are made contiguous,
and autograd sums their gradients back over the broadcast dimensions.
Tensor operands of mixed dtypes are promoted first; Python scalars take
the dtype and device of the tensor operands (JAX's weak types).
"""

from __future__ import annotations

import functools

import torch

from taper_tpu_torch.ops import _build
from taper_tpu_torch.ops import backend

# op codes of csrc/elementwise.cu
OPS = {name: i for i, name in enumerate(backend.EW_OPS)}
ARITY = {"relu": 1, "sigmoid": 1, "add": 2, "mul": 2, "fma": 3, "sub": 2,
         "div": 2}


def elementwise_reference(op: str, *xs: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: the op computed in f32, rounded once to the
    operands' dtype (``fma`` in f64, so that ``a * b + c`` is rounded
    once, as the fused kernel rounds it)."""
    dtype = xs[0].dtype
    if op == "fma":
        a, b, c = (x.double() for x in xs)
        return (a * b + c).to(dtype)
    f = [x.float() for x in xs]
    if op == "relu":
        y = torch.relu(f[0])
    elif op == "sigmoid":
        y = torch.sigmoid(f[0])
    elif op == "add":
        y = f[0] + f[1]
    elif op == "mul":
        y = f[0] * f[1]
    elif op == "sub":
        y = f[0] - f[1]
    elif op == "div":
        y = f[0] / f[1]
    else:
        raise ValueError(f"unknown elementwise op {op!r}")
    return y.to(dtype)


def elementwise(op: str, *xs: torch.Tensor) -> torch.Tensor:
    """One elementwise op over operands of one shape and dtype: K2 on
    CUDA, the plain version on the CPU.  Not differentiable (the forward
    of the autograd Functions below)."""
    if len(xs) != ARITY[op]:
        raise ValueError(f"{op} takes {ARITY[op]} operands, got {len(xs)}")
    shape, dtype = xs[0].shape, xs[0].dtype
    for x in xs[1:]:
        if x.shape != shape or x.dtype != dtype:
            raise ValueError(f"{op}: operands differ after broadcasting: "
                             f"{[(tuple(t.shape), t.dtype) for t in xs]}")
    if not backend.on_cuda(*xs):
        return elementwise_reference(op, *xs)
    # any alignment: the kernel takes 16-byte vectors only where every
    # operand is aligned
    if not all(x.is_contiguous() for x in xs):
        raise ValueError(f"{op}: kernel needs contiguous tensors, got "
                         f"strides {[x.stride() for x in xs]}")
    if dtype not in _build.DTYPES:
        raise ValueError(f"{op}: kernel takes dtype in "
                         f"{tuple(_build.DTYPES)}, got {dtype}")
    y = torch.empty_like(xs[0], memory_format=torch.contiguous_format)
    if y.numel() == 0:
        return y
    a, b, c = (list(xs) + [None, None])[:3]
    code = _build.library().taper_elementwise(
        a.data_ptr(), None if b is None else b.data_ptr(),
        None if c is None else c.data_ptr(), y.data_ptr(), y.numel(),
        OPS[op], _build.DTYPES[dtype], _build.stream(a))
    _build.check(code, f"elementwise {op}")
    backend.count_launch(op)
    return y


class _Relu(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x):
        y = elementwise("relu", x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return torch.where(y > 0, g, torch.zeros((), dtype=g.dtype,
                                                 device=g.device))


class _Sigmoid(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x):
        y = elementwise("sigmoid", x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * y * (1.0 - y)


class _Add(torch.autograd.Function):

    @staticmethod
    def forward(ctx, a, b):
        return elementwise("add", a, b)

    @staticmethod
    def backward(ctx, g):
        return g, g


class _Sub(torch.autograd.Function):

    @staticmethod
    def forward(ctx, a, b):
        return elementwise("sub", a, b)

    @staticmethod
    def backward(ctx, g):
        return g, -g


class _Mul(torch.autograd.Function):

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return elementwise("mul", a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return g * b, g * a


class _Fma(torch.autograd.Function):

    @staticmethod
    def forward(ctx, a, b, c):
        ctx.save_for_backward(a, b)
        return elementwise("fma", a, b, c)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return g * b, g * a, g


class _Div(torch.autograd.Function):

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return elementwise("div", a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return g / b, -g * a / (b * b)


def _operands(*xs):
    """Tensors of one shape and dtype from tensors and Python scalars:
    scalars take the tensors' device, dtypes are promoted, shapes
    broadcast; the expanded operands are made contiguous."""
    tensors = [x for x in xs if isinstance(x, torch.Tensor)]
    if not tensors:
        raise TypeError("elementwise ops need at least one tensor operand")
    dtype = functools.reduce(torch.promote_types,
                             (t.dtype for t in tensors))
    ts = [torch.as_tensor(x, device=tensors[0].device).to(dtype)
          for x in xs]
    if len({tuple(t.shape) for t in ts}) > 1:
        ts = [t.contiguous() for t in torch.broadcast_tensors(*ts)]
    return ts


def relu(x):
    return _Relu.apply(x)


def sigmoid(x):
    return _Sigmoid.apply(x)


def add(a, b):
    """Broadcasting add; the broadcast happens outside the autograd
    Function, so the gradients are reduced over the broadcast dims."""
    return _Add.apply(*_operands(a, b))


def mul(a, b):
    """Broadcasting multiply; see :func:`add`."""
    return _Mul.apply(*_operands(a, b))


def fma(a, b, c):
    """Fused multiply-add ``a * b + c``, rounded once."""
    return _Fma.apply(*_operands(a, b, c))


def sub(a, b):
    """Broadcasting subtract, gradient ``(g, -g)``."""
    return _Sub.apply(*_operands(a, b))


def div(a, b):
    """Broadcasting divide, gradient ``(g / b, -g a / b^2)``."""
    return _Div.apply(*_operands(a, b))
