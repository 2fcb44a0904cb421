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
``decode`` (``csrc/gemm_decode.cu``, bf16 mode nt at M <= 16: weights
streamed into mma.sync fragments, K split over a thread-block cluster),
``realign`` (``csrc/gemm_realign.cu``, bf16 operands TMA cannot take:
each operand staged by :func:`staging`, streamed where its rows are whole
16-byte chunks, else through 16-byte windows realigned on chip) and
``f32`` (the FMA tile kernel, ``csrc/gemm.cu``, on a tile sized to the
output by :func:`f32_plan`); ``wgmma`` and ``f32`` split a long K over
blocks when the output's tiles are too few to fill the card, and sum the
splits in a fixed order (``f32`` in the same launch).  Operands are
contiguous, except that a bf16 operand whose rows are contiguous may lie
at any row stride (a view into a wider buffer): ``realign`` takes it.
"""

from __future__ import annotations

import torch

from taper_tpu_torch.ops import _build
from taper_tpu_torch.ops import backend

ACTIVATIONS = {"none": 0, "relu": 1, "sigmoid": 2}
MODES = {"nt": 0, "nn": 1, "tn": 2}
# K1's kernels (codes shared with csrc/gemm.cu), and the output and K tile
# of the wgmma route, which splits K (csrc/gemm_sm90.cu)
ROUTES = {"wgmma": 0, "realign": 1, "decode": 2, "f32": 3}
TILES = {"wgmma": (128, 128, 64)}
# The f32 route's tiles (BM, BN, BK, KG: the thread groups that split
# each K tile inside a block), codes shared with gemm_f32 in csrc/gemm.cu
# (in that order).  The two 32 x 32 tiles 64 deep differ in KG alone: 2
# where the call splits K over blocks, 4 where it does not
F32_TILES = ((128, 32, 16, 1), (64, 64, 32, 1), (32, 32, 64, 2),
             (64, 32, 32, 1), (32, 32, 16, 1), (32, 32, 64, 4))
F32_SHORT_K = 64           # a shorter K takes the tiles 16 deep
F32_WHOLE = {2: 5}         # the split 32 x 32 tile -> its unsplit twin
SMS = 132                  # the H100 SXM's streaming multiprocessors
# A split call's target blocks and the K tiles of its shortest split, by
# route: wgmma aims at about one wave (90% of the SMs) of persistent
# blocks; f32, whose output then has fewer tiles than SMs (so its tile is
# a 32 x 32 one, four of which fit an SM), at four blocks an SM, all
# resident at once (its splits meet at a grid barrier)
WAVE = {"wgmma": 119, "f32": 4 * SMS}
MIN_SPLIT_K_TILES = {"wgmma": 4, "f32": 4}
WORKSPACE_CAP = 64 << 20   # bytes of f32 partials a split call may use
DECODE_ROWS = 16           # the decode route's largest M
# csrc/gemm_decode.cu: the weight rows of a block, the least K a cluster
# rank takes (four 32-deep steps for each of 8 warps), and the largest
# cluster its K split takes
DECODE_TILE = (32, 1024)
DECODE_CLUSTER = 8


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


def plan(m: int, n: int, k: int, dtype, mode: str, aligned: bool,
         dense: bool = True):
    """K1's kernel and K split for ``[m, n] = contract_k`` in ``mode``:
    ``(route, splits)``, a pure function of its arguments, so one shape
    always runs the same kernels in the same order (bit-for-bit
    repeatable).  ``aligned``: both operands are dense and
    :func:`streams` (TMA's rules); ``dense``: both operands' row stride is
    their row width.

    * bf16 nt at ``m <= 16``, dense: ``decode``, its K split over a
      cluster of :func:`decode_splits` blocks;
    * bf16 at ``m > 16``, aligned: ``wgmma``; other bf16: ``realign``
      (each operand staged as :func:`staging` says);
    * f32: ``f32``, on the tile and split :func:`f32_plan` picks.

    ``wgmma`` and ``f32`` split K when the output's tiles are fewer than
    the route's ``WAVE`` of blocks: the smallest count that brings the
    blocks to it, each split at least ``MIN_SPLIT_K_TILES`` whole K tiles,
    the f32 partials within ``WORKSPACE_CAP``, and no split empty (the
    splits cover ``ceil(k_tiles / splits)`` tiles each)."""
    if dtype == torch.bfloat16:
        if mode == "nt" and m <= DECODE_ROWS and dense:
            return "decode", decode_splits(n, k)
        if m <= DECODE_ROWS or not aligned:
            return "realign", 1
        route = "wgmma"
    elif dtype == torch.float32:
        route = "f32"
    else:
        raise ValueError(f"K1 takes f32 or bf16 operands, got {dtype}")
    if route == "f32":
        return route, f32_plan(m, n, k)[0]
    return route, _splits(route, m, n, k, *TILES[route])


def _splits(route, m, n, k, bm, bn, bk):
    """The K split of a ``route`` call on ``bm x bn x bk`` tiles (see
    :func:`plan`)."""
    tiles = -(-m // bm) * -(-n // bn)
    k_tiles = -(-k // bk)
    wave = (-(-WAVE[route] // tiles) if route == "wgmma"
            else WAVE[route] // tiles if tiles < SMS else 1)
    splits = min(wave, k_tiles // MIN_SPLIT_K_TILES[route],
                 WORKSPACE_CAP // (4 * m * n))
    if splits <= 1:
        return 1
    per = -(-k_tiles // splits)
    return -(-k_tiles // per)


def f32_plan(m: int, n: int, k: int):
    """The f32 route's ``(splits, tile)`` for an ``[m, n]`` output over
    ``k``, the tile a code of :data:`F32_TILES`.  Among the tiles of its K
    depth (16 below ``F32_SHORT_K``, else the deeper ones; 128 x 32 at
    either), the one that pads the output least (the paths' outputs are
    skinny: N of 10 to 512 over long M, or M of 10 to 512 in the weight
    gradients); among those, the largest that still gives a block to
    every SM (more FMAs for each operand load), else the smallest (more
    blocks); squarer first on a tie.  A 32 x 32 call that does not split
    takes the twin with more K groups (more threads on a short chain)."""
    def cost(code):
        bm, bn, _, _ = F32_TILES[code]
        tiles = -(-m // bm) * -(-n // bn)
        fills = tiles >= SMS
        return (tiles * bm * bn, not fills, -bm * bn if fills else bm * bn,
                1 / bm + 1 / bn)
    short = k < F32_SHORT_K
    codes = [c for c, (_, _, bk, _) in enumerate(F32_TILES)
             if c not in F32_WHOLE.values()
             and (c == 0 or (bk == 16) == short)]
    code = min(codes, key=cost)
    splits = _splits("f32", m, n, k, *F32_TILES[code][:3])
    return splits, F32_WHOLE.get(code, code) if splits == 1 else code


def f32_tile(m: int, n: int, k: int) -> int:
    """The tile code of :func:`f32_plan`."""
    return f32_plan(m, n, k)[1]


def tile_shape(route: str, m: int, n: int, k: int):
    """``(BM, BN, BK)``: the output and K tile of a route that splits K
    (``wgmma``, ``f32``) for an ``[m, n]`` output over ``k``."""
    if route == "f32":
        return F32_TILES[f32_tile(m, n, k)][:3]
    return TILES[route]


def decode_splits(n: int, k: int, k_min: int = DECODE_TILE[1]) -> int:
    """The decode route's cluster size: the most blocks a tile of
    ``DECODE_TILE[0]`` weight rows, a power of two up to
    ``DECODE_CLUSTER``, that leave each cluster rank at least ``k_min``
    of K (``DECODE_TILE[1]`` for bf16 weights) and the grid within two
    blocks an SM (on an H100 at M = 8 and 16, a larger split ran slower
    and a smaller one left SMs idle; PERF.md).  K12/K13's decode route
    (``ops.quant.decode_splits``) takes the same rule in bytes."""
    tiles, splits = -(-n // DECODE_TILE[0]), 1
    while (splits < DECODE_CLUSTER and k >= 2 * splits * k_min
           and tiles * 2 * splits <= 2 * SMS):
        splits *= 2
    return splits


def split_ranges(k: int, splits: int, k_tile: int):
    """The ``[lo, hi)`` K ranges of a call split ``splits`` ways over
    ``k_tile``-wide tiles, in the order the kernels sum them."""
    k_tiles = -(-k // k_tile)
    per = -(-k_tiles // splits) * k_tile
    return [(lo, min(k, lo + per)) for lo in range(0, k, per)]


def _k_slice(t, lo, hi, k_major: bool):
    return t[:, lo:hi] if k_major else t[lo:hi]


def gemm_reference_split(a, b, mode: str, splits: int, k_tile: int,
                         route: str = "wgmma"):
    """Plain version of a split-K call: the f32 products over
    :func:`split_ranges`, summed as the route's kernels sum them: wgmma's
    reduce adds them in order; f32 adds, for each of G lanes (the splits'
    count rounded up to a power of two, at most 32), the splits l, l + G,
    ... in order (from 0), then the lanes in a butterfly, and takes lane
    0's sum."""
    _, _, k = _dims(a, b, mode)
    parts = [gemm_reference(_k_slice(a, lo, hi, mode != "tn"),
                            _k_slice(b, lo, hi, mode == "nt"), mode)
             for lo, hi in split_ranges(k, splits, k_tile)]
    if route != "f32":
        out = parts[0]
        for part in parts[1:]:
            out = out + part
        return out
    g = min(32, 1 << (len(parts) - 1).bit_length())
    lanes = [torch.zeros_like(parts[0]) for _ in range(g)]
    for z, part in enumerate(parts):
        lanes[z % g] = lanes[z % g] + part
    off = g // 2
    while off:
        lanes = [lanes[lane] + lanes[lane ^ off] for lane in range(g)]
        off //= 2
    return lanes[0]


def streams(t) -> bool:
    """A 2-D operand's rows are whole 16-byte chunks from a 16-byte-aligned
    base (its row width and row stride multiples of 8 elements): 16-byte
    copies read it as it lies."""
    return (t.shape[1] % 8 == 0 and _ld(t) % 8 == 0
            and t.data_ptr() % 16 == 0)


def staging(a_streams: bool, b_streams: bool) -> int:
    """The realign route's staging of its two operands, each judged alone
    (an aligned operand streams whatever the other one needs), as the
    kernel's code: bit 0 stages ``a`` through realigned windows, bit 1
    ``b``."""
    return int(not a_streams) | int(not b_streams) << 1


def plan_for(a, b, mode: str):
    """:func:`plan` for the operands ``a`` and ``b`` of ``mode`` as given
    (their shapes, dtype, alignment and row strides)."""
    m, n, k = _dims(a, b, mode)
    dense = a.is_contiguous() and b.is_contiguous()
    aligned = dense and streams(a) and streams(b)
    return plan(m, n, k, a.dtype, mode, aligned, dense)


def _ld(t) -> int:
    """A 2-D operand's row stride in elements (its width where dense)."""
    return t.shape[1] if t.is_contiguous() else t.stride(0)


def _check_rows(name, t) -> None:
    """The realign route reads any row stride, but each row contiguous (a
    row of one element is, whatever its stride)."""
    if t.is_contiguous():
        return
    if (t.stride(1) != 1 and t.shape[1] != 1) or _ld(t) < t.shape[1]:
        raise ValueError(f"{name}: kernel needs contiguous rows, got "
                         f"strides {t.stride()} for shape {tuple(t.shape)}")


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


_GRID_SYNC = {}


def _grid_sync(device, stream):
    """The f32 split's grid-barrier state for one stream: two int32
    zeros, which each split call leaves as it found them (calls on one
    stream run in order; another stream gets its own)."""
    key = (device, stream)
    if key not in _GRID_SYNC:
        _GRID_SYNC[key] = torch.zeros(2, dtype=torch.int32, device=device)
    return _GRID_SYNC[key]


def _launch(a, b, bias, mode, activation, out_dtype):
    """K1 on CUDA operands: the kernel :func:`plan` picks, one launch
    count a call (a wgmma split call also launches its reduce; the f32
    route sums its splits in the same launch, the decode route inside one
    cluster)."""
    m, n, k = _dims(a, b, mode)
    name = "linear" if mode == "nt" else f"gemm {mode}"
    if b.dtype != a.dtype or (bias is not None and bias.dtype != a.dtype):
        raise ValueError(f"{name}: operands and bias must share one dtype")
    # a bf16 operand may lie at any row stride (plan sends it to realign)
    strided = a.dtype == torch.bfloat16
    backend.check_kernel_args(name, *((bias,) if strided else (a, b, bias)),
                              dtypes=_build.DTYPES, aligned=False)
    for t in (a, b):
        _check_rows(name, t)
    out_dtype = _out_dtype(out_dtype, a.dtype)
    route, splits = plan_for(a, b, mode)
    y = torch.empty((m, n), dtype=out_dtype, device=a.device)
    ws = (torch.empty((splits, m, n), dtype=torch.float32, device=a.device)
          if splits > 1 and route != "decode" else None)
    stream = _build.stream(a)
    sync = (_grid_sync(a.device, stream).data_ptr()
            if splits > 1 and route == "f32" else None)
    tile = (f32_tile(m, n, k) if route == "f32"
            else staging(streams(a), streams(b)) if route == "realign"
            else 0)
    code = _build.library().taper_gemm(
        a.data_ptr(), b.data_ptr(), None if bias is None else bias.data_ptr(),
        y.data_ptr(), None if ws is None else ws.data_ptr(), sync, m, n, k,
        _ld(a), _ld(b), MODES[mode], _build.DTYPES[a.dtype],
        _build.DTYPES[out_dtype], ACTIVATIONS[activation], ROUTES[route],
        splits, tile, stream)
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
