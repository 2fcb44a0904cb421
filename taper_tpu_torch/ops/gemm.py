"""GEMM in three contraction modes and the differentiable ops built on it:
port of ``taper_tpu/ops/pallas/gemm.py`` (``_gemm_jit`` ->
``_linear_kernel``, and the custom VJPs of ``matmul``, ``linear`` and
``linear_nb``).

The modes of ``_MODES`` (``gemm.py:76-80``), each operand in its natural
layout, output ``[M, N]``:

* ``"nt"``: ``a[M, K] . b[N, K]^T`` (+ bias, + epilogue): linear forward;
* ``"nn"``: ``a[M, K] . b[K, N]``: linear backward dX;
* ``"tn"``: ``a[K, M]^T . b[K, N]``: linear backward dW.

``linear`` takes ``x [M, K]``, ``w [N, K]`` (the ``[out, in]`` layout of
both packages), ``b [N]`` or ``None``, all of one dtype (f32 or bf16).  The
product accumulates in f32, the bias is added in f32, then the
``"none"``/``"relu"``/``"sigmoid"`` epilogue; the result is f32 for any
operand dtype, as ``_gemm_jit`` returns it.  The private keyword
``out_dtype`` (f32, or the operands' bf16) rounds that f32 result once,
to nearest even, as ``.to(out_dtype)`` would: the kernel writes it in the
caller's dtype, where the JAX package casts it in a separate pass.

``linear``, ``linear_nb`` and ``matmul`` are ``torch.autograd.Function``s
whose backward follows the JAX VJPs: the cotangent is masked by ``y > 0``
(relu) or multiplied by ``y (1 - y)`` (sigmoid), ``db = sum(g)`` in f32,
``dX = g . W`` in mode nn and ``dW = g^T . X`` in mode tn, each written
in its operand's dtype.

CPU tensors run the plain versions (:func:`linear_reference`,
:func:`gemm_reference`); CUDA tensors run K1's kernels, chosen by
:func:`plan` from the shape, dtype and alignment alone: ``wgmma``
(``csrc/gemm_sm90.cu``, bf16 through TMA and Hopper's warpgroup MMA),
``wmma`` and ``decode`` (bf16 WMMA tiles, ``csrc/gemm.cu``) and ``f32``
(the FMA tile kernel, ``csrc/gemm.cu``); ``wgmma`` and ``f32`` split a
long K over blocks when the output's tiles are too few to fill the card,
and sum the splits in a fixed order.
"""

from __future__ import annotations

import torch

from taper_tpu_torch.ops import _build
from taper_tpu_torch.ops import backend

ACTIVATIONS = {"none": 0, "relu": 1, "sigmoid": 2}
MODES = {"nt": 0, "nn": 1, "tn": 2}
# K1's kernels (codes shared with csrc/gemm.cu) and the output and K tile
# of each route that splits K (csrc/gemm_sm90.cu, csrc/gemm.cu)
ROUTES = {"wgmma": 0, "wmma": 1, "decode": 2, "f32": 3}
TILES = {"wgmma": (128, 128, 64), "f32": (64, 64, 16)}
SMS = 132                  # the H100 SXM's streaming multiprocessors
WAVE = 119                 # "about one wave": 90% of them
MIN_SPLIT_K_TILES = 4      # K tiles of the shortest split
WORKSPACE_CAP = 64 << 20   # bytes of f32 partials a split call may use
DECODE_ROWS = 16           # the decode tile's M


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
    """The cotangent through the epilogue, from the saved output ``y``.
    ReLU passes none where ``y`` is exactly 0, as the pallas backend's
    ``_conv_direct_bwd`` (``jnp.where(y > 0, g, 0)``); the xla backend's
    ``jnp.maximum(x, 0)`` passes half there."""
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


def plan(m: int, n: int, k: int, dtype, mode: str, aligned: bool):
    """K1's kernel and K split for ``[m, n] = contract_k`` in ``mode``:
    ``(route, splits)``, a pure function of its arguments, so one shape
    always runs the same kernels in the same order (bit-for-bit
    repeatable).  ``aligned``: both operands' contiguous dimension is a
    multiple of 8 elements and their data 16-byte aligned (TMA's rules).

    * bf16 nt at ``m <= 16``: ``decode`` (the skinny WMMA tile);
    * bf16 at ``m > 16``, aligned: ``wgmma``; other bf16: ``wmma``;
    * f32: ``f32``.

    ``wgmma`` and ``f32`` split K when the output's tiles fill less than
    about one wave of the SMs: the smallest count that brings the blocks
    to ``WAVE``, each split at least ``MIN_SPLIT_K_TILES`` whole K tiles,
    the f32 partials within ``WORKSPACE_CAP``, and no split empty (the
    splits cover ``ceil(k_tiles / splits)`` tiles each)."""
    if dtype == torch.bfloat16:
        if mode == "nt" and m <= DECODE_ROWS:
            return "decode", 1
        if m <= DECODE_ROWS or not aligned:
            return "wmma", 1
        route = "wgmma"
    elif dtype == torch.float32:
        route = "f32"
    else:
        raise ValueError(f"K1 takes f32 or bf16 operands, got {dtype}")
    bm, bn, bk = TILES[route]
    tiles = -(-m // bm) * -(-n // bn)
    k_tiles = -(-k // bk)
    splits = min(-(-WAVE // tiles), k_tiles // MIN_SPLIT_K_TILES,
                 WORKSPACE_CAP // (4 * m * n))
    if splits <= 1:
        return route, 1
    per = -(-k_tiles // splits)
    return route, -(-k_tiles // per)


def split_ranges(k: int, splits: int, k_tile: int):
    """The ``[lo, hi)`` K ranges of a call split ``splits`` ways over
    ``k_tile``-wide tiles, in the order the kernels sum them."""
    k_tiles = -(-k // k_tile)
    per = -(-k_tiles // splits) * k_tile
    return [(lo, min(k, lo + per)) for lo in range(0, k, per)]


def _k_slice(t, lo, hi, k_major: bool):
    return t[:, lo:hi] if k_major else t[lo:hi]


def gemm_reference_split(a, b, mode: str, splits: int, k_tile: int):
    """Plain version of a split-K call: the f32 products over
    :func:`split_ranges`, summed in that order as the kernels' reduce
    does."""
    _, _, k = _dims(a, b, mode)
    out = None
    for lo, hi in split_ranges(k, splits, k_tile):
        part = gemm_reference(_k_slice(a, lo, hi, mode != "tn"),
                              _k_slice(b, lo, hi, mode == "nt"), mode)
        out = part if out is None else out + part
    return out


def plan_for(a, b, mode: str):
    """:func:`plan` for the operands ``a`` and ``b`` of ``mode`` as given
    (their shapes, dtype and alignment)."""
    m, n, k = _dims(a, b, mode)
    aligned = all(t.shape[-1] % 8 == 0 and t.data_ptr() % 16 == 0
                  for t in (a, b))
    return plan(m, n, k, a.dtype, mode, aligned)


def _out_dtype(out_dtype, dtype):
    if out_dtype in (None, torch.float32):
        return torch.float32
    if out_dtype != dtype:
        raise ValueError(f"K1 writes f32 or its operands' dtype {dtype}, "
                         f"not {out_dtype}")
    return out_dtype


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


def _launch(a, b, bias, mode, activation, out_dtype):
    """K1 on CUDA operands: the kernel :func:`plan` picks, one launch
    count a call (a split call also launches its reduce)."""
    m, n, k = _dims(a, b, mode)
    name = "linear" if mode == "nt" else f"gemm {mode}"
    if b.dtype != a.dtype or (bias is not None and bias.dtype != a.dtype):
        raise ValueError(f"{name}: operands and bias must share one dtype")
    backend.check_kernel_args(name, a, b, bias, dtypes=_build.DTYPES,
                              aligned=False)
    out_dtype = _out_dtype(out_dtype, a.dtype)
    route, splits = plan_for(a, b, mode)
    y = torch.empty((m, n), dtype=out_dtype, device=a.device)
    ws = (torch.empty((splits, m, n), dtype=torch.float32, device=a.device)
          if splits > 1 else None)
    code = _build.library().taper_gemm(
        a.data_ptr(), b.data_ptr(), None if bias is None else bias.data_ptr(),
        y.data_ptr(), None if ws is None else ws.data_ptr(), m, n, k,
        MODES[mode], _build.DTYPES[a.dtype], _build.DTYPES[out_dtype],
        ACTIVATIONS[activation], ROUTES[route], splits, _build.stream(a))
    _build.check(code, name)
    backend.count_launch("linear" if mode == "nt" else f"gemm_{mode}")
    backend.count_route(route, mode, splits)
    return y


def _nt(x, w, b, activation, out_dtype=None):
    """Mode nt with bias and epilogue: the kernel or the plain version."""
    if not backend.on_cuda(x, w, b):
        y = linear_reference(x, w, b, activation)
        return y.to(_out_dtype(out_dtype, x.dtype))
    return _launch(x, w, b, "nt", activation, out_dtype)


def gemm(a, b, mode: str, out_dtype=None):
    """``contract_K(a, b)`` in ``mode`` (no bias, no epilogue), f32 out
    (or ``out_dtype``, see the module docstring).  Not differentiable:
    the building block of the backward passes."""
    _dims(a, b, mode)
    if mode == "nt":
        return _nt(a, b, None, "none", out_dtype)
    if not backend.on_cuda(a, b):
        return gemm_reference(a, b, mode).to(_out_dtype(out_dtype, a.dtype))
    return _launch(a, b, None, mode, "none", out_dtype)


class _Linear(torch.autograd.Function):
    """``act(x @ w.T + b)`` with the VJP of ``gemm.py:255-272``."""

    @staticmethod
    def forward(ctx, x, w, b, activation, out_dtype):
        y = _nt(x, w, b, activation, out_dtype)
        ctx.activation = activation
        ctx.bias_dtype = None if b is None else b.dtype
        # the output is kept only where the epilogue's gradient reads it
        ctx.save_for_backward(x, w, None if activation == "none" else y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, y = ctx.saved_tensors
        g = activation_grad(g, y, ctx.activation)
        need_x, need_w, need_b, _, _ = ctx.needs_input_grad
        # db sums the cotangent in f32 before the cast to the bias dtype
        db = g.float().sum(0).to(ctx.bias_dtype) if need_b else None
        g = g.to(x.dtype).contiguous()
        dx = gemm(g, w, "nn", out_dtype=x.dtype) if need_x else None
        dw = gemm(g, x, "tn", out_dtype=w.dtype) if need_w else None
        return dx, dw, db, None, None


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
        da = gemm(g, b, "nt", out_dtype=a.dtype) if need_a else None
        db = gemm(a, g, "tn", out_dtype=b.dtype) if need_b else None
        return da, db


def linear(x, w, b=None, activation: str = "none", *, out_dtype=None):
    """``act(x @ w.T + b)`` in f32 (or ``out_dtype``), differentiable; see
    the module docstring.  A bf16 ``out_dtype`` takes no activation: the
    epilogue's gradient would read a rounded output."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    if out_dtype not in (None, torch.float32) and activation != "none":
        raise ValueError(f"linear: out_dtype {out_dtype} takes activation "
                         f"'none', got {activation!r}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[1]:
        raise ValueError(f"linear: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} are not [M, K] and [N, K]")
    if b is not None and tuple(b.shape) != (w.shape[0],):
        raise ValueError(f"linear: bias {tuple(b.shape)} is not "
                         f"[{w.shape[0]}]")
    return _Linear.apply(x, w, b, activation, out_dtype)


def linear_nb(x, w, activation: str = "none"):
    """Bias-free ``act(x @ w.T)``: the conv-as-GEMM helper."""
    return linear(x, w, None, activation)


def matmul(a, b):
    """2-D ``a[M, K] @ b[K, N]`` in f32, differentiable (mode nn forward,
    nt and tn backward)."""
    _dims(a, b, "nn")
    return _Matmul.apply(a, b)
