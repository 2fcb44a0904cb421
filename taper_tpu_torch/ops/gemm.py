"""GEMM in three contraction modes and the differentiable ops built on it:
port of ``taper_tpu/ops/pallas/gemm.py`` (``_gemm_jit`` ->
``_linear_kernel``, and the custom VJPs of ``matmul``, ``linear`` and
``linear_nb``).

The modes of ``_MODES`` (``gemm.py:76-80``), each operand in its natural
layout, output ``[M, N]`` in f32:

* ``"nt"``: ``a[M, K] . b[N, K]^T`` (+ bias, + epilogue): linear forward;
* ``"nn"``: ``a[M, K] . b[K, N]``: linear backward dX;
* ``"tn"``: ``a[K, M]^T . b[K, N]``: linear backward dW.

``linear`` takes ``x [M, K]``, ``w [N, K]`` (the ``[out, in]`` layout of
both packages), ``b [N]`` or ``None``, all of one dtype (f32 or bf16).  The
product accumulates in f32, the bias is added in f32, then the
``"none"``/``"relu"``/``"sigmoid"`` epilogue; the result is f32 for any
operand dtype, as ``_gemm_jit`` returns it, and callers cast back.

``linear``, ``linear_nb`` and ``matmul`` are ``torch.autograd.Function``s
whose backward follows the JAX VJPs: the cotangent is masked by ``y > 0``
(relu) or multiplied by ``y (1 - y)`` (sigmoid), ``db = sum(g)``,
``dX = g . W`` in mode nn and ``dW = g^T . X`` in mode tn.

CPU tensors run the plain versions (:func:`linear_reference`,
:func:`gemm_reference`); CUDA tensors run the kernels of ``csrc/gemm.cu``:
mode nt in f32 or bf16, modes nn and tn in f32 (their bf16 variants come
with M2 and raise until then).
"""

from __future__ import annotations

import torch

from taper_tpu_torch.ops import _build
from taper_tpu_torch.ops import backend

ACTIVATIONS = {"none": 0, "relu": 1, "sigmoid": 2}
MODES = {"nt": 0, "nn": 1, "tn": 2}


def activation_name(activation) -> str:
    """``None``, a name of :data:`ACTIVATIONS`, or a callable whose name
    contains ``relu`` or ``sigmoid`` (the JAX package's convention for
    fused epilogues), as a name of :data:`ACTIVATIONS`."""
    if activation is None:
        return "none"
    if isinstance(activation, str):
        if activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}")
        return activation
    name = getattr(activation, "__name__", str(activation))
    for known in ("relu", "sigmoid"):
        if known in name:
            return known
    raise ValueError(f"unsupported fused activation {name!r}")


def apply_activation(y, activation: str):
    if activation == "relu":
        return torch.relu(y)
    if activation == "sigmoid":
        return torch.sigmoid(y)
    return y


def activation_grad(g, y, activation: str):
    """The cotangent through the epilogue, from the saved output ``y``."""
    if activation == "relu":
        return torch.where(y > 0, g, torch.zeros_like(g))
    if activation == "sigmoid":
        return g * y * (1.0 - y)
    return g


def gemm_reference(a, b, mode: str):
    """Plain version of one contraction mode: f32 product of the operands
    as given (a bf16 product is exact in f32)."""
    a, b = a.float(), b.float()
    if mode == "nt":
        return torch.matmul(a, b.t())
    if mode == "nn":
        return torch.matmul(a, b)
    return torch.matmul(a.t(), b)


def linear_reference(x, w, b=None, activation: str = "none"):
    """Plain version of mode nt with bias and epilogue."""
    y = gemm_reference(x, w, "nt")
    if b is not None:
        y = y + b.float()
    return apply_activation(y, activation)


def _dims(a, b, mode: str):
    """``(M, N, K)`` of ``contract_K(a, b)`` in ``mode``; raises on
    operands that do not contract."""
    if mode not in MODES:
        raise ValueError(f"unknown GEMM mode {mode!r}")
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"gemm: operands {tuple(a.shape)} and "
                         f"{tuple(b.shape)} are not matrices")
    m, k = a.shape if mode != "tn" else a.shape[::-1]
    n, k2 = b.shape if mode == "nt" else b.shape[::-1]
    if k != k2:
        raise ValueError(f"gemm {mode}: {tuple(a.shape)} and "
                         f"{tuple(b.shape)} do not contract")
    return m, n, k


def _nt(x, w, b, activation):
    """Mode nt with bias and epilogue: the kernel or the plain version."""
    if not backend.on_cuda(x, w, b):
        return linear_reference(x, w, b, activation)
    if w.dtype != x.dtype or (b is not None and b.dtype != x.dtype):
        raise ValueError("linear: x, w and b must share one dtype")
    backend.check_kernel_args("linear", x, w, b, dtypes=_build.DTYPES)
    m, k = x.shape
    n = w.shape[0]
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    code = _build.library().taper_linear(
        x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
        y.data_ptr(), m, n, k, _build.DTYPES[x.dtype],
        ACTIVATIONS[activation], _build.stream(x))
    _build.check(code, "linear")
    backend.count_launch("linear")
    return y


def gemm(a, b, mode: str):
    """``contract_K(a, b)`` in ``mode`` (no bias, no epilogue), f32 out.
    Not differentiable: the building block of the backward passes."""
    m, n, k = _dims(a, b, mode)
    if mode == "nt":
        return _nt(a, b, None, "none")
    if not backend.on_cuda(a, b):
        return gemm_reference(a, b, mode)
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f"gemm {mode}: the kernel takes f32 operands; the "
                         f"bf16 variant of modes nn/tn comes with M2")
    backend.check_kernel_args(f"gemm {mode}", a, b)
    y = torch.empty((m, n), dtype=torch.float32, device=a.device)
    code = _build.library().taper_gemm(
        a.data_ptr(), b.data_ptr(), y.data_ptr(), m, n, k, MODES[mode],
        _build.stream(a))
    _build.check(code, f"gemm {mode}")
    backend.count_launch(f"gemm_{mode}")
    return y


class _Linear(torch.autograd.Function):
    """``act(x @ w.T + b)`` with the VJP of ``gemm.py:255-272``."""

    @staticmethod
    def forward(ctx, x, w, b, activation):
        y = _nt(x, w, b, activation)
        ctx.activation = activation
        ctx.bias_dtype = None if b is None else b.dtype
        ctx.save_for_backward(x, w, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, y = ctx.saved_tensors
        g = activation_grad(g, y, ctx.activation)
        need_x, need_w, need_b, _ = ctx.needs_input_grad
        # db sums the f32 cotangent before the cast to the operand dtype
        db = g.sum(0).to(ctx.bias_dtype) if need_b else None
        g = g.to(x.dtype).contiguous()
        dx = gemm(g, w, "nn").to(x.dtype) if need_x else None
        dw = gemm(g, x, "tn").to(w.dtype) if need_w else None
        return dx, dw, db, None


class _Matmul(torch.autograd.Function):
    """``a @ b`` with the VJP of ``gemm.py:220-238``."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return gemm(a, b, "nn")

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype).contiguous()
        need_a, need_b = ctx.needs_input_grad
        da = gemm(g, b, "nt").to(a.dtype) if need_a else None   # g . b^T
        db = gemm(a, g, "tn").to(b.dtype) if need_b else None   # a^T . g
        return da, db


def linear(x, w, b=None, activation: str = "none"):
    """``act(x @ w.T + b)`` in f32, differentiable; see the module
    docstring."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[1]:
        raise ValueError(f"linear: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} are not [M, K] and [N, K]")
    if b is not None and tuple(b.shape) != (w.shape[0],):
        raise ValueError(f"linear: bias {tuple(b.shape)} is not "
                         f"[{w.shape[0]}]")
    return _Linear.apply(x, w, b, activation)


def linear_nb(x, w, activation: str = "none"):
    """Bias-free ``act(x @ w.T)``: the conv-as-GEMM helper."""
    return linear(x, w, None, activation)


def matmul(a, b):
    """2-D ``a[M, K] @ b[K, N]`` in f32, differentiable (mode nn forward,
    nt and tn backward)."""
    _dims(a, b, "nn")
    return _Matmul.apply(a, b)
