"""Quantized matrix products: port of ``taper_tpu/ops/pallas/quant.py``
and of the quantized branch of ``taper_tpu/ops/__init__.py::linear``.

Four kernels (``csrc/quant.cu``, ``csrc/quant_sm90.cu``,
``csrc/quant_decode.cu``), each with its plain PyTorch version beside
it:

* K12 :func:`linear_q8` (``_q8_kernel``, ``quant.py:41``): int8 weights
  dequantized on load.  With ``w = (q - zp) * scale`` per tensor or per
  output channel the output factorises as
  ``y[m,n] = scale[n] * sum_k bf16(x[m,k]) q[n,k]
  - scale[n] zp[n] * sum_k x[m,k] (+ b) (+ relu|sigmoid)``:
  the activations are rounded to bf16 before the product, as the TPU
  kernel does (``quant.py:53``, a known numerics gap reproduced here), and
  the row sum is taken over the unrounded f32 activations (``:57``).
  :func:`plan_q` picks its kernel: ``wgmma`` (``csrc/quant_sm90.cu``: a
  row pass writes bf16 x and the row sums, then bf16 warpgroup MMA on a
  TMA ring, the codes widened to bf16 in shared memory) at M > 16 where
  TMA reads both operands and stores y, ``decode``
  (``csrc/quant_decode.cu``: swap-AB ``mma.sync`` with the codes widened
  in registers, K split over a cluster of :func:`decode_splits` blocks)
  at decode's M <= 16 where the codes' rows are whole 16-byte units from
  aligned bases, else ``mma`` (the same ``mma.sync`` kernel for the odd
  shapes: loads as wide as the rows allow, a ragged last unit zero-filled,
  activation rows in groups of :func:`mma_rows`);
* K13 :func:`linear_q4` (``_q4_kernel``, ``quant.py:159``): the same over
  int4 codes packed two to a byte ``[N, K/2]`` (K even), on the same three
  routes (its codes' rows whole 16-byte units when K is a multiple of
  32);
* K14 :func:`quantize_rows` (``_rowquant_kernel``, ``quant.py:460``):
  per-row symmetric activation quantization ``s = max(absmax, 1e-8) /
  127`` (a multiply by the f32 reciprocal, as XLA runs it),
  ``xq = rint(x / s)``, and the codes' row sum;
* K15a/b :func:`matmul_int8_scaled` / :func:`matmul_int8`
  (``_i8mm_scaled_kernel`` / ``_i8mm_kernel``, ``quant.py:324`` /
  ``:292``): int8 x int8 -> int32 on the tensor cores, K15b writing the
  exact int32 product, K15a the W8A8 epilogue
  ``sx[m] sw[n] (acc - zw[n] corr[m]) (+ b) (+ relu)`` in the output
  dtype.  :func:`plan` picks their kernel: ``wgmma``
  (``csrc/quant_sm90.cu``: int8 warpgroup MMA fed by TMA) where the rows
  are whole 16-byte units from 16-byte-aligned bases, else ``mma``
  (``csrc/quant.cu``'s ``mma.sync`` kernel).

:func:`linear_w8a8` composes K14 and K15a and applies a sigmoid epilogue
outside the kernel (``quant.py:519-548``).  :func:`linear_quantized` is the
dispatch of ``ops.linear`` for a quantized weight.

CPU tensors run the plain versions; CUDA tensors launch the kernels or
raise (no fallback).  None of these is differentiable: under grad mode a
CUDA input that requires grad raises, as ``paged_decode_attention`` does.
"""

from __future__ import annotations

import os

import torch

from taper_tpu_torch.ops import _build
from taper_tpu_torch.ops import backend
from taper_tpu_torch.ops import gemm as G
from taper_tpu_torch.ops.gemm import ACTIVATIONS, apply_activation
from taper_tpu_torch.ops.gemm import linear as _dense_linear
from taper_tpu_torch.quantization.config import QuantizationType
from taper_tpu_torch.quantization.qtensor import (
    QuantizedTensor, dense, unpack_int4)

# W8A8 engages for int8 weights at this many rows or more, under
# TAPER_W8A8=1 (the JAX rule, kept: it decides the model's numbers)
W8A8_MIN_ROWS = 256


def w8a8_engages(x, w) -> bool:
    """The one W8A8 predicate, read at call time: ``TAPER_W8A8=1``, an
    int8 :class:`QuantizedTensor` weight, and at least
    :data:`W8A8_MIN_ROWS` rows of ``x``.  ``ops.linear`` dispatches on it
    and ``nn.transformer._proj`` keeps bf16 activations on it."""
    return (isinstance(w, QuantizedTensor)
            and w.qtype == QuantizationType.INT8
            and os.environ.get("TAPER_W8A8") == "1"
            and x.shape[0] >= W8A8_MIN_ROWS)


def _row(v, n: int, device) -> torch.Tensor:
    """A per-tensor scalar or a per-channel ``[n]`` vector as a contiguous
    f32 ``[n]`` vector (``quant.py:108-111``)."""
    v = torch.as_tensor(v, device=device).float().reshape(-1)
    return v.expand(n).contiguous()


def _term(v, n: int, device, dtypes=(torch.float32,)):
    """A per-tensor scalar or a per-channel ``[n]`` vector as K12's and
    K13's kernels read it: ``(tensor, stride)``, the stride between
    channels 0 for one value and 1 for ``[n]``.  Nothing is expanded, and a
    tensor on ``device`` in one of ``dtypes`` is passed as it is (PTQ's
    int32 zero point among them where the caller allows it); anything
    else becomes f32."""
    v = torch.as_tensor(v, device=device)
    if v.dtype not in dtypes:
        v = v.float()
    v = v.reshape(-1)
    if v.numel() == 1:
        return v, 0
    if v.numel() != n:
        raise ValueError(f"scale / zero point of {v.numel()} values for "
                         f"{n} output channels")
    return v.contiguous(), 1


def _check_epilogue(epilogue: str) -> None:
    if epilogue not in ACTIVATIONS:
        raise ValueError(f"unknown epilogue {epilogue!r}")


# -- K12 / K13: dequant-on-load linear ----------------------------------------

def linear_q8_reference(x, q, scale, zp, b=None, epilogue: str = "none"):
    """Plain version of K12 over integer codes ``q [N, K]``: the factorised
    product step by step; products of bf16 activations and integer codes
    are exact in f32, so it differs from the kernel in the summation order
    only."""
    n = q.shape[0]
    acc = torch.matmul(x.to(torch.bfloat16).float(), q.float().t())
    xsum = x.float().sum(1, keepdim=True)
    scale, zp = _row(scale, n, x.device), _row(zp, n, x.device)
    out = acc * scale - xsum * (scale * zp)
    if b is not None:
        out = out + b.float()
    return apply_activation(out, epilogue)


def linear_q4_reference(x, packed, scale, zp, b=None, *, n_features: int,
                        epilogue: str = "none"):
    """Plain version of K13: unpack the nibbles in their natural order,
    then K12's plain version (JAX permutes the activation's columns to its
    planar nibble order instead; only the summation order differs)."""
    n = packed.numel() * 2 // n_features
    return linear_q8_reference(x, unpack_int4(packed, (n, n_features)),
                               scale, zp, b, epilogue)


# K12's and K13's kernels (codes shared with csrc/quant.cu's Q8Route)
Q8_ROUTES = {"wgmma": 0, "mma": 1, "decode": 2}
# The decode route (M <= ops.gemm.DECODE_ROWS): each rank of its cluster
# takes at least DECODE_MIN_BYTES of every code row, and a cluster holds
# at most DECODE_MAX_RANKS (on an H100 at M 8, four ranks ran 15-35%
# slower than two, one rank up to 31% slower; PERF.md)
DECODE_MIN_BYTES = 512
DECODE_MAX_RANKS = 2


def plan_q(m: int, n: int, k: int, aligned: bool, bits: int = 8) -> str:
    """K12's (``bits`` 8) or K13's (``bits`` 4) kernel for ``x [m, k] .
    q [n, k]^T``, a pure function of its arguments.  The codes' rows are
    whole 16-byte units where ``k`` is a multiple of 16 (int8) or 32
    (int4); ``aligned``: the bases of x and q are 16-byte aligned.

    * ``decode`` at decode's ``m <= 16`` with whole units, aligned;
    * ``wgmma`` where ``m > 16``, TMA can read both operands (whole units,
      aligned) and store the f32 output (``n`` a multiple of 4: its rows
      whole 16-byte units; the CNN's 10-way head fails this);
    * else ``mma``, the ``mma.sync`` kernel of ``decode`` with loads as
      wide as the rows allow, which reads and writes any row (``k`` even
      for int4)."""
    if min(m, n, k) <= 0:
        raise ValueError(f"K12: empty product [{m}, {k}] . [{n}, {k}]^T")
    if bits not in (8, 4):
        raise ValueError(f"K12/K13 take 8- or 4-bit codes, got {bits}")
    whole = k % (128 // bits) == 0 and aligned
    if m <= G.DECODE_ROWS:
        return "decode" if whole else "mma"
    return "wgmma" if whole and n % 4 == 0 else "mma"


def plan_q_for(x, q, bits: int = 8) -> str:
    """:func:`plan_q` for K12's (or K13's) operands as given: ``q`` the
    int8 codes ``[N, K]`` or the packed int4 codes (``[N, K/2]`` or
    flat)."""
    m, k = x.shape
    return plan_q(m, q.numel() * 8 // bits // k, k,
                  x.data_ptr() % 16 == 0 and q.data_ptr() % 16 == 0, bits)


def decode_splits(n: int, k: int, bits: int) -> int:
    """The decode route's cluster size for ``n`` weight rows of ``k``
    ``bits``-bit codes: ``ops.gemm.decode_splits``' rule (32 rows a block,
    two blocks an SM), each rank at least ``DECODE_MIN_BYTES`` of every
    code row, at most ``DECODE_MAX_RANKS`` ranks."""
    return min(DECODE_MAX_RANKS,
               G.decode_splits(n, k, DECODE_MIN_BYTES * 8 // bits))


# The mma.sync kernel's weight rows a block (its two m16 tiles)
MMA_WEIGHT_ROWS = 32


def mma_rows(m: int, n: int) -> int:
    """The activation rows a block of the ``decode``/``mma`` kernel takes
    (one n8 tile or two), a pure function of the shape: 8 for ``m <= 8``,
    16 for ``m <= 16``; above, 16 unless 16-row groups give fewer blocks
    than the card has SMs, then 8 (the PTQ example's 10-way head, N 10 in
    one 32-row weight block at M 2,000: 125 blocks of 16 rows, 250 of
    8).  A block reads its weight rows' codes once for its group."""
    if m <= 8:
        return 8
    if m <= G.DECODE_ROWS:
        return 16
    blocks = -(-n // MMA_WEIGHT_ROWS) * -(-m // 16)
    return 16 if blocks >= G.SMS else 8


def q_linear_args(x, q, scale, scale_stride, zp, zp_stride, b, y, ws,
                  bits, epilogue, route, splits, rows, stream):
    """The arguments of ``taper_linear_q`` for these tensors, a pure
    function: pointers (``None`` for a missing bias or workspace), the
    shape, and the route's codes.  ``scale`` (f32) and ``zp`` (f32 or
    int32) go as they are, with their strides (0: one value for every
    channel) and whether ``zp`` is int32."""
    m, k = x.shape
    n = y.shape[1]
    return (x.data_ptr(), q.data_ptr(), scale.data_ptr(), zp.data_ptr(),
            None if b is None else b.data_ptr(), y.data_ptr(),
            None if ws is None else ws.data_ptr(), m, n, k, bits,
            ACTIVATIONS[epilogue], Q8_ROUTES[route], stream, splits, rows,
            scale_stride, zp_stride, int(zp.dtype == torch.int32))


def _q_linear(name, bits, x, q, scale, zp, b, epilogue, n, k):
    """K12 (``bits`` 8) or K13 (``bits`` 4) on the route :func:`plan_q`
    gives; a per-tensor scale and zero point reach the kernel as they are
    (stride 0, PTQ's int32 zero point as int32), with no copy."""
    _check_epilogue(epilogue)
    if x.dim() != 2 or x.shape[1] != k:
        raise ValueError(f"{name}: x {tuple(x.shape)} is not [M, {k}]")
    if b is not None and tuple(b.shape) != (n,):
        raise ValueError(f"{name}: bias {tuple(b.shape)} is not [{n}]")
    backend.refuse_grad(name, x, b)
    dev = x.device
    scale, ss = _term(scale, n, dev)
    zp, zs = _term(zp, n, dev, (torch.float32, torch.int32))
    b = None if b is None else b.float().contiguous()
    # the routes read any base (plan_q sends misaligned ones to mma)
    backend.check_kernel_args(name, x, dtypes=(torch.float32,),
                              aligned=False)
    backend.check_kernel_args(name, q, scale, zp, b, aligned=False)
    m = x.shape[0]
    route = plan_q_for(x, q, bits)
    splits = (decode_splits(n, k, bits)
              if route != "wgmma" and m <= G.DECODE_ROWS else 1)
    y = torch.empty((m, n), dtype=torch.float32, device=dev)
    # the wgmma route's row pass: bf16 x and the row sums
    ws = (torch.empty(m * k * 2 + m * 4, dtype=torch.uint8, device=dev)
          if route == "wgmma" else None)
    code = _build.library().taper_linear_q(*q_linear_args(
        x, q, scale, ss, zp, zs, b, y, ws, bits, epilogue, route, splits,
        mma_rows(m, n), _build.stream(x)))
    _build.check(code, name)
    backend.count_launch(name)
    backend.count_route(route, name, 1)
    return y


def linear_q8(x, q, scale, zp, b=None, *, epilogue: str = "none"):
    """``y = act(x @ dequant(q).T + b)`` with ``q`` int8 ``[N, K]``,
    ``scale``/``zp`` per tensor or ``[N]``; ``x`` ``[M, K]`` f32; f32
    out, on the kernel :func:`plan_q` picks.  Not differentiable."""
    if not backend.on_cuda(x, q, b):
        _check_epilogue(epilogue)
        return linear_q8_reference(x, q, scale, zp, b, epilogue)
    if q.dim() != 2 or q.dtype != torch.int8:
        raise ValueError(f"linear_q8: q must be int8 [N, K], got "
                         f"{q.dtype} {tuple(q.shape)}")
    return _q_linear("linear_q8", 8, x, q, scale, zp, b, epilogue,
                     q.shape[0], q.shape[1])


def linear_q4(x, packed, scale, zp, b=None, *, n_features: int,
              epilogue: str = "none"):
    """``y = act(x @ dequant(int4 packed).T + b)``: ``packed`` holds the
    nibbles of a row-major ``[N, K]`` weight (``qtensor.pack_nibbles``),
    ``n_features = K``, even.  Not differentiable."""
    k = n_features
    if k % 2 or (packed.numel() * 2) % k:
        raise ValueError(f"linear_q4: K = {k} must be even and divide "
                         f"{packed.numel() * 2} codes")
    if not backend.on_cuda(x, packed, b):
        _check_epilogue(epilogue)
        return linear_q4_reference(x, packed, scale, zp, b, n_features=k,
                                   epilogue=epilogue)
    if packed.dtype != torch.uint8:
        raise ValueError(f"linear_q4: packed must be uint8, got "
                         f"{packed.dtype}")
    n = packed.numel() * 2 // k
    return _q_linear("linear_q4", 4, x, packed.reshape(n, k // 2), scale,
                     zp, b, epilogue, n, k)


# -- K14: per-row activation quantization -------------------------------------

# K14's 1/127 as the TPU kernel's ``s = max(a, 1e-8) / 127.0``
# (``quant.py:463``) runs: XLA folds the division by the constant into a
# multiply by its f32 reciprocal
_INV127 = torch.tensor(1.0 / 127.0, dtype=torch.float32)


def quantize_rows_reference(x):
    """Plain version of K14, the kernel's steps in three passes:
    ``(xq int8 [M, K], sx f32 [M], xsum f32 [M])``."""
    xf = x.float()
    sx = xf.abs().amax(-1).clamp_min(1e-8) * _INV127.to(xf.device)
    qc = torch.round(xf / sx[:, None])
    return qc.to(torch.int8), sx, qc.sum(-1)


def quantize_rows(x):
    """One-pass dynamic per-row symmetric quantization of ``x [M, K]`` (f32
    or bf16): ``sx = max(absmax, 1e-8) * f32(1/127)``, ``xq = rint(x /
    sx)``,
    ``xsum = sum_k xq``.  Codes, scales and sums are exact (the same f32
    operations as the plain version).  Not differentiable."""
    if x.dim() != 2:
        raise ValueError(f"quantize_rows: x {tuple(x.shape)} is not 2-D")
    if not backend.on_cuda(x):
        return quantize_rows_reference(x)
    backend.refuse_grad("quantize_rows", x)
    backend.check_kernel_args("quantize_rows", x, dtypes=_build.DTYPES)
    m, k = x.shape
    xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
    sx = torch.empty(m, dtype=torch.float32, device=x.device)
    xsum = torch.empty(m, dtype=torch.float32, device=x.device)
    code = _build.library().taper_quantize_rows(
        x.data_ptr(), xq.data_ptr(), sx.data_ptr(), xsum.data_ptr(), m, k,
        _build.DTYPES[x.dtype], _build.stream(x))
    _build.check(code, "quantize_rows")
    backend.count_launch("quantize_rows")
    return xq, sx, xsum


# -- K15a / K15b: int8 x int8 on the tensor cores -----------------------------

def matmul_int8_reference(xq, q):
    """Plain version of K15b: the exact int32 product, through f64 (every
    product and partial sum of int8 codes is an integer below 2^53; CUDA
    has no integer matmul)."""
    return torch.matmul(xq.double(), q.double().t()).to(torch.int32)


def matmul_int8_scaled_reference(xq, q, sx, corr, sw, zw, bias=None,
                                 relu=False, out_dtype=torch.float32):
    """Plain version of K15a: the exact product, then the epilogue in the
    TPU kernel's order, ``(sx sw) (acc - zw corr)`` (``quant.py:351``)."""
    acc = matmul_int8_reference(xq, q).float()
    y = (sx.float()[:, None] * sw.float()[None, :]) * (
        acc - zw.float()[None, :] * corr.float()[:, None])
    if bias is not None:
        y = y + bias.float()
    if relu:
        y = torch.relu(y)
    return y.to(out_dtype)


_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}


# K15's kernels (codes shared with csrc/quant.cu)
I8_ROUTES = {"wgmma": 0, "mma": 1}


def plan(m: int, n: int, k: int, aligned: bool) -> str:
    """K15's kernel for ``[m, k] . [n, k]^T``, a pure function of its
    arguments: ``wgmma`` where TMA can read both operands (``k`` a
    multiple of 16, so that each row is whole 16-byte units, and
    ``aligned``: both bases 16-byte aligned), at every ``m`` and ``n``
    (TMA zero-fills the tiles' ragged edges, so decode's 8 rows run there
    too); else ``mma``, the ``mma.sync`` kernel, which reads any row."""
    if min(m, n, k) <= 0:
        raise ValueError(f"K15: empty product [{m}, {k}] . [{n}, {k}]^T")
    return "wgmma" if k % 16 == 0 and aligned else "mma"


def plan_for(xq, q) -> str:
    """:func:`plan` for the operands as given."""
    return plan(xq.shape[0], q.shape[0], xq.shape[1],
                xq.data_ptr() % 16 == 0 and q.data_ptr() % 16 == 0)


def _i8mm(name, xq, q, vecs, bias, relu, out_dtype):
    if (xq.dim() != 2 or q.dim() != 2 or xq.shape[1] != q.shape[1]
            or xq.dtype != torch.int8 or q.dtype != torch.int8):
        raise ValueError(f"{name}: xq {xq.dtype} {tuple(xq.shape)} and q "
                         f"{q.dtype} {tuple(q.shape)} are not int8 [M, K] "
                         f"and [N, K]")
    m, k = xq.shape
    n = q.shape[0]
    # the codes may lie anywhere (plan sends unaligned ones to mma)
    backend.check_kernel_args(name, xq, q, aligned=False)
    backend.check_kernel_args(name, *vecs, bias)
    route = plan_for(xq, q)
    y = torch.empty((m, n), dtype=out_dtype, device=xq.device)
    ptr = [None if t is None else t.data_ptr() for t in (*vecs, bias)]
    code = _build.library().taper_matmul_int8(
        xq.data_ptr(), q.data_ptr(), *ptr, y.data_ptr(), m, n, k, int(relu),
        _OUT_DTYPES[out_dtype], I8_ROUTES[route], _build.stream(xq))
    _build.check(code, name)
    backend.count_launch(name)
    backend.count_route(route, name, 1)
    return y


def matmul_int8(xq, q):
    """``xq [M, K] int8 @ q [N, K] int8 ^T -> int32 [M, N]``, exact."""
    if not backend.on_cuda(xq, q):
        return matmul_int8_reference(xq, q)
    return _i8mm("matmul_int8", xq, q, (None,) * 4, None, False,
                 torch.int32)


def matmul_int8_scaled(xq, q, sx, corr, sw, zw, bias=None, relu=False,
                       out_dtype=torch.float32):
    """Fused W8A8 linear core: ``xq [M, K] @ q [N, K]^T`` with the per-row
    activation scale ``sx [M]``, codes sum ``corr [M]``, weight scale ``sw
    [N]`` and zero point ``zw [N]`` applied in the epilogue, plus optional
    bias and ReLU; ``[M, N]`` in ``out_dtype`` (f32 or bf16)."""
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"matmul_int8_scaled: out_dtype {out_dtype}")
    if not backend.on_cuda(xq, q, sx, corr, sw, zw, bias):
        return matmul_int8_scaled_reference(xq, q, sx, corr, sw, zw, bias,
                                            relu, out_dtype)
    m, n = xq.shape[0], q.shape[0]
    dev = xq.device
    vecs = (_row(sx, m, dev), _row(corr, m, dev), _row(sw, n, dev),
            _row(zw, n, dev))
    bias = None if bias is None else _row(bias, n, dev)
    return _i8mm("matmul_int8_scaled", xq, q, vecs, bias, relu, out_dtype)


def linear_w8a8(x, q, scale, zp, b=None, *, epilogue: str = "none"):
    """W8A8 linear (``quant.py:519-548``): the activations quantized per
    row (K14), the int8 weight codes as they are, the product and its
    affine algebra on the int8 tensor cores (K15a); a sigmoid epilogue
    runs after the kernel.  bf16 activations give a bf16 result, others
    f32.  The activation rounding is the only approximation."""
    _check_epilogue(epilogue)
    xq, sx, corr = quantize_rows(x)
    n = q.shape[0]
    sw, zw = _row(scale, n, x.device), _row(zp, n, x.device)
    out_dtype = x.dtype if x.dtype == torch.bfloat16 else torch.float32
    y = matmul_int8_scaled(xq, q, sx, corr, sw, zw, bias=b,
                           relu=epilogue == "relu", out_dtype=out_dtype)
    if epilogue == "sigmoid":
        y = torch.sigmoid(y)
    return y


# -- ops.linear's quantized branch --------------------------------------------

def linear_quantized(x, w: QuantizedTensor, b=None, activation="none"):
    """``ops.linear`` for a :class:`QuantizedTensor` weight
    (``taper_tpu/ops/__init__.py:91-161``), on either device: int8 goes to
    K12 at every M (W8A8's K14 + K15a where :func:`w8a8_engages`), int4
    with an even K to K13, every other format dequantizes and goes to K1.
    The JAX package's TPU-measured row threshold for K12 (M >= 64 unless
    ``TAPER_Q8_KERNEL=1``) is not inherited."""
    b = dense(b)
    if w.qtype == QuantizationType.INT8:
        if w8a8_engages(x, w):
            return linear_w8a8(x, w.values, w.scale, w.zero_point, b,
                               epilogue=activation)
        return linear_q8(x, w.values, w.scale, w.zero_point, b,
                         epilogue=activation)
    if w.qtype == QuantizationType.INT4 and w.shape[1] % 2 == 0:
        return linear_q4(x, w.values, w.scale, w.zero_point, b,
                         n_features=w.shape[1], epilogue=activation)
    wd = w.dequantize().to(x.dtype)
    return _dense_linear(x, wd, None if b is None else b.to(x.dtype),
                         activation)


__all__ = ["linear_q8", "linear_q4", "quantize_rows", "matmul_int8",
           "matmul_int8_scaled", "linear_w8a8", "linear_quantized",
           "w8a8_engages"]
