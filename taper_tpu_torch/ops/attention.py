"""Scaled dot-product attention, differentiable: port of the flash kernels
of ``taper_tpu/ops/pallas/attention.py`` (``flash_attention`` and
``flash_attention_bshd`` -> ``_flash_fwd`` -> ``_fwd_kernel`` (K5) or
``_fwd_kernel_bound`` (K8); ``_flash_bwd_impl`` -> ``_dq_kernel`` (K6) then
``_dkv_kernel`` (K7), or the opt-in ``_dkv_kernel_t`` (K11) and
``_bwd_fused_kernel`` (K10)) and of the plain version ``taper_tpu/ops/
xla.py::attention``.

Two layouts, as in the JAX package: :func:`attention` takes ``q``
``[B, H, S, D]`` and ``k``/``v`` ``[B, Hkv, S, D]``; :func:`attention_bshd`
takes the projections' own ``[B, S, H*D]`` and ``[B, S, Hkv*D]``, which the
kernels read through strides, without a transposed copy in either pass.
``H % Hkv == 0`` (GQA/MQA: query head ``h`` reads KV head
``h // (H / Hkv)``).  Softmax statistics are f32 at any input dtype; the
output has ``q``'s dtype.

Masks (``taper_tpu/ops/xla.py:203-218``): ``causal``; ``window=W`` bounds
the past only, row ``r`` keeps cols ``> r - W`` (with ``causal`` exactly
``[r - W + 1, r]``; without it the future stays visible);
``segment_ids [B, S]`` (packed documents) keeps pairs of equal id, id 0
being padding that attends padding.  Segments take no window, as JAX
asserts (``attention.py:1703-1707``), and get no gradient.  The CUDA
kernels visit only the band of tiles a window leaves, so their work scales
with ``S * W``.

Both entry points are ``torch.autograd.Function``s.  CPU tensors run the
plain versions (:func:`attention_lse_reference` forward,
:func:`flash_bwd_reference` backward); CUDA tensors run the kernels of
``csrc/flash_sm90.cu``, ``csrc/flash_bwd_sm90.cu``, ``csrc/flash_fwd.cu``,
``csrc/flash_bwd_f32.cu`` and ``csrc/flash_bwd.cu`` at every shape they
take (f32 or bf16, D of 64 or 128, and 32 in f32 but for K10, any S), or
raise.  The forward picks its
kernel as JAX does (``attention.py:1155``, :func:`uses_bound`): the
bound-max K8 for bf16 causal inputs with no window and no segments, its
exact arm chosen on the device by :func:`bound_predicate`; the exact K5
for the rest.  :func:`plan_fwd` names K8's and K5's kernel and
:func:`plan_bwd` K6's, K7's, K10's and K11's before launch: the TMA +
wgmma kernels of ``csrc/flash_sm90.cu`` (K8, K5, K7, K10, K11) and
``csrc/flash_bwd_sm90.cu`` (K6) for bf16 (whose data
``backend.check_kernel_args`` holds to TMA's 16-byte alignment, or
raises), the FMA kernels of ``csrc/flash_fwd.cu`` (K5),
``csrc/flash_bwd_f32.cu`` (K6, K7, K11) and ``csrc/flash_bwd.cu`` (K10)
for f32; ``backend.route_counts()`` counts the calls by route.  K11 is a
mode of K7's kernel in each dtype (one block a query head, per-head f32
partials out).  The backward is
K6 then K7, with JAX's two opt-in alternatives, read from the environment
at each call as JAX reads them at trace time, and only on the card:
``TAPER_ATTN_FUSED_BWD=1`` runs K10 for plain causal attention (no window,
no segments; JAX's further ``S * D * 4 <= 4 MiB`` condition is the TPU's
VMEM capacity for its resident dQ, which K10 here keeps in device memory,
so it is dropped), and ``TAPER_ATTN_DKV_T=1`` runs K11 in K7's place for
non-causal or windowed attention without segments
(``attention.py:1368-1371``, ``:1527``).  K10's dQ sums with atomics, so
its low bits vary from run to run; the default path is deterministic.

Not ported: the JAX package's S >= 1024 crossover to its kernel (measured
on a TPU), and its TPU schedule knobs ``TAPER_ATTN_GRID``,
``TAPER_ATTN_FWD_BLOCKS`` and ``TAPER_ATTN_BWD_BLOCKS``, which change no
result: the CUDA grid is 64-row tiles with band-limited loops.  q/k
offsets and the lse cotangent (sequence parallelism and ring attention),
and ``TAPER_ATTN_CHUNK``, wait for their own slices.
"""

from __future__ import annotations

import math
import os

import torch

from taper_tpu_torch.ops import _build
from taper_tpu_torch.ops import backend

HEAD_DIMS = (64, 128)
# the f32 FMA kernels (K5 of flash_fwd.cu; K6, K7 and K11 of
# flash_bwd_f32.cu) also take 32: the draft byte LM of
# benchmarks/bench_serving.py:446 and examples/train_bytelm.py's default
# model have 4 heads of 32
F32_HEAD_DIMS = (32, 64, 128)
LOG2E = math.log2(math.e)
MASKS = ("none", "causal", "window", "segments")
# max|q| * scale * log2(e) * max|k| at most this keeps the bound arm's
# largest weight per row above 2^-120, inside f32 (attention.py:1208-1231)
BOUND_LIMIT = 60.0


def _dims(q, k, v, heads=None):
    """``(B, H, Hkv, S, D)`` of attention inputs in either layout
    (``heads`` None: ``[B, H, S, D]``; else ``[B, S, H*D]`` with ``heads``
    query heads).  Raises on shapes that do not fit together."""
    if k.shape != v.shape or q.dim() != k.dim():
        raise ValueError(f"attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if heads is None:
        if q.dim() != 4:
            raise ValueError(f"attention: q {tuple(q.shape)}, k "
                             f"{tuple(k.shape)}, v {tuple(v.shape)} are not "
                             f"[B, H, S, D] and [B, Hkv, S, D]")
        b, h, s, d = q.shape
        hkv = k.shape[1]
        bad = (k.shape[0] != b or k.shape[2] != s or k.shape[3] != d
               or not hkv or h % hkv)
    else:
        if q.dim() != 3 or heads <= 0 or q.shape[2] % heads:
            raise ValueError(f"attention_bshd: q {tuple(q.shape)} is not "
                             f"[B, S, H*D] for {heads} heads")
        b, s, e = q.shape
        h, d = heads, e // heads
        hkv = k.shape[2] // d
        bad = (k.shape[0] != b or k.shape[1] != s or k.shape[2] % d
               or not hkv or h % hkv)
    if bad:
        raise ValueError(f"attention: q {tuple(q.shape)} does not match "
                         f"k/v {tuple(k.shape)}")
    return b, h, hkv, s, d


def _to_bhsd(x, heads, d):
    """``[B, S, n*D]`` as a ``[B, n, S, D]`` view (``heads`` None: as is)."""
    if heads is None:
        return x
    b, s, e = x.shape
    return x.reshape(b, s, e // d, d).transpose(1, 2)


def _from_bhsd(x, heads):
    if heads is None:
        return x
    b, n, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, n * d)


def check_mask(q, k, window, segment_ids, heads=None):
    """Raise on a window or segment ids the kernels and the plain versions
    do not take (see the module docstring)."""
    b, s = q.shape[0], q.shape[2 if heads is None else 1]
    if window is not None and (isinstance(window, bool)
                               or int(window) != window or window < 1):
        raise ValueError(f"attention: window must be a positive int, got "
                         f"{window!r}")
    if segment_ids is None:
        return
    if window is not None:
        raise ValueError("attention: segment_ids compose with plain "
                         "(optionally causal) attention only, not with a "
                         "window (as JAX asserts)")
    if tuple(segment_ids.shape) != (b, s):
        raise ValueError(f"attention: segment_ids {tuple(segment_ids.shape)}"
                         f" must be [B, S] = {(b, s)}")
    if segment_ids.dtype.is_floating_point or segment_ids.dtype == torch.bool:
        raise ValueError(f"attention: segment_ids must be integers, got "
                         f"{segment_ids.dtype}")


def _keep(s, device, causal, window, segment_ids):
    """The kept (row, col) pairs as a bool mask broadcasting against
    ``[B, Hkv, G, S, S]`` scores, or None when nothing is masked."""
    rows = torch.arange(s, device=device)[:, None]
    cols = torch.arange(s, device=device)[None, :]
    keep = None
    if causal:
        keep = rows >= cols
    if window is not None:
        w = cols > rows - int(window)
        keep = w if keep is None else keep & w
    if keep is not None:
        keep = keep[None, None, None]
    if segment_ids is not None:
        seg = segment_ids.to(device)
        same = (seg[:, :, None] == seg[:, None, :])[:, None, None]
        keep = same if keep is None else keep & same
    return keep


def attention_lse_reference(q, k, v, *, causal=False, scale=None,
                            window=None, segment_ids=None):
    """Plain version of the forward over ``[B, H, S, D]`` (the
    ``ops/xla.py`` oracle, masks as ``xla.py:203-218``): f32 scores and
    softmax, the weights cast to ``v``'s dtype before the second product,
    GQA broadcasting each KV head over its query group.  Returns ``(o,
    lse)``, ``lse`` the natural-log row logsumexp ``[B*H, S]`` f32 that the
    kernels export.  The plain version of K5 with a window or segment
    ids."""
    b, h, hkv, s, d = _dims(q, k, v)
    check_mask(q, k, window, segment_ids)
    if scale is None:
        scale = d ** -0.5
    qg = q.float().reshape(b, hkv, h // hkv, s, d)
    sc = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) * scale
    keep = _keep(s, q.device, causal, window, segment_ids)
    if keep is not None:
        sc = sc.masked_fill(~keep, float("-inf"))
    lse = torch.logsumexp(sc, dim=-1)
    p = torch.softmax(sc, dim=-1).to(v.dtype).float()
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return o.reshape(b, h, s, d).to(q.dtype), lse.reshape(b * h, s)


def attention_reference(q, k, v, *, causal=False, scale=None, window=None,
                        segment_ids=None):
    """Plain version of the forward: the output of
    :func:`attention_lse_reference`."""
    return attention_lse_reference(q, k, v, causal=causal, scale=scale,
                                   window=window,
                                   segment_ids=segment_ids)[0]


def flash_bwd_reference(q, k, v, o, lse, do, causal, scale, window=None,
                        segment_ids=None, per_query_head=False):
    """Plain version of the backward over ``[B, H, S, D]``, written out
    with the formulas of the JAX kernels in f32: ``p = exp(s - lse)``
    (0 where masked), ``delta = rowsum(dO * O)``, ``ds = p * (dO V^T -
    delta)``, ``dQ = ds K scale``, ``dK = ds^T Q scale``, ``dV = p^T dO``,
    dK and dV summed over each KV head's query group.  Returns ``(dq, dk,
    dv, delta)`` in f32, ``delta`` ``[B*H, S]``.

    It is the plain version of K6 and K7 under every mask, of K10 (the
    same three gradients in one sweep) and, with ``per_query_head=True``,
    of K11: ``dk`` and ``dv`` are then the per-query-head partials
    ``[B, H, S, D]`` before the group sum."""
    b, h, hkv, s, d = _dims(q, k, v)
    check_mask(q, k, window, segment_ids)
    g = h // hkv
    qf = q.float().reshape(b, hkv, g, s, d)
    dof = do.float().reshape(b, hkv, g, s, d)
    kf, vf = k.float(), v.float()
    sc = torch.einsum("bkgqd,bksd->bkgqs", qf, kf) * scale
    keep = _keep(s, q.device, causal, window, segment_ids)
    if keep is not None:
        sc = sc.masked_fill(~keep, float("-inf"))
    lse = lse.float().reshape(b, hkv, g, s)
    # a fully masked row has lse = -inf; its weights are 0 either way
    lse = torch.where(torch.isfinite(lse), lse, torch.zeros_like(lse))
    p = torch.exp(sc - lse[..., None])
    delta = (dof * o.float().reshape(b, hkv, g, s, d)).sum(-1)
    dp = torch.einsum("bkgqd,bksd->bkgqs", dof, vf)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, kf) * scale
    if per_query_head:
        dk = torch.einsum("bkgqs,bkgqd->bkgsd", ds, qf).reshape(
            b, h, s, d) * scale
        dv = torch.einsum("bkgqs,bkgqd->bkgsd", p, dof).reshape(b, h, s, d)
    else:
        dk = torch.einsum("bkgqs,bkgqd->bksd", ds, qf) * scale
        dv = torch.einsum("bkgqs,bkgqd->bksd", p, dof)
    return dq.reshape(b, h, s, d), dk, dv, delta.reshape(b * h, s)


# -- routing ----------------------------------------------------------------

def mask_kind(causal, window, segment_ids):
    """The mask of a call as :func:`plan_fwd` takes it: ``"segments"``,
    ``"window"``, ``"causal"`` or ``"none"``."""
    if segment_ids is not None:
        return "segments"
    if window is not None:
        return "window"
    return "causal" if causal else "none"


def uses_bound(dtype, mask: str) -> bool:
    """Whether the forward is K8 (bf16 inputs under a plain causal mask,
    JAX's ``use_bound``, ``attention.py:1155``) rather than K5."""
    return dtype == torch.bfloat16 and mask == "causal"


def plan_fwd(dtype, mask: str) -> str:
    """The forward's route, a pure function of its arguments (as
    ``ops.gemm.plan``), decided before launch: ``"wgmma"`` for bf16
    inputs under every mask (K8 or K5, as :func:`uses_bound` picks, both
    on ``csrc/flash_sm90.cu``'s TMA + wgmma kernel); ``"exact"`` for f32
    (K5's FMA kernel, ``csrc/flash_fwd.cu``)."""
    if mask not in MASKS:
        raise ValueError(f"unknown mask kind {mask!r}")
    return "wgmma" if dtype == torch.bfloat16 else "exact"


def plan_bwd(dtype) -> str:
    """The backward kernels' route (K6, K7, K10 and K11 alike), decided
    before launch by the dtype alone, under every mask: ``"wgmma"`` for
    bf16 (K6 in ``csrc/flash_bwd_sm90.cu``, K7, K10's sweep and K11 in
    ``csrc/flash_sm90.cu``), ``"f32"`` for f32 (the FMA kernels of
    ``csrc/flash_bwd_f32.cu`` for K6, K7 and K11, of
    ``csrc/flash_bwd.cu`` for K10)."""
    return "wgmma" if dtype == torch.bfloat16 else "f32"


# -- the kernels (CUDA tensors only) ---------------------------------------

def _fma_dims(dtype):
    """The head dims of a kernel with an f32 FMA form (K5, K6, K7,
    K11) on tensors of ``dtype``."""
    return F32_HEAD_DIMS if dtype == torch.float32 else HEAD_DIMS


def _check_kernel(name, d, *tensors, dims=HEAD_DIMS):
    if d not in dims:
        raise ValueError(f"{name}: kernel takes head_dim in {dims}, "
                         f"got {d}")
    if len({t.dtype for t in tensors}) != 1:
        raise ValueError(f"{name}: q, k, v (and o, do) must share one dtype")
    backend.check_kernel_args(name, *tensors, dtypes=_build.DTYPES)


def _layout(heads):
    return 0 if heads is None else 1   # layout codes of flash_common.cuh


def _mask_args(name, q, k, heads, window, segment_ids):
    """The kernels' ``(seg pointer, window)``: ids as int32 ``[B, S]`` on
    the card (None: no segments), the window as an int (0: none; a
    window of S or more masks nothing)."""
    check_mask(q, k, window, segment_ids, heads)
    s = q.shape[2 if heads is None else 1]
    win = 0 if window is None or window >= s else int(window)
    if segment_ids is None:
        return None, win
    backend.check_kernel_args(name, segment_ids, dtypes=(torch.int32,))
    if not backend.on_cuda(q, segment_ids):
        raise ValueError(f"{name}: segment_ids must lie on q's device")
    return segment_ids.data_ptr(), win


def flash_fwd_exact(q, k, v, *, causal, scale, heads=None, window=None,
                    segment_ids=None):
    """The exact kernel (K5) on CUDA tensors in either layout, with an
    optional window or int32 segment ids, through the route
    :func:`plan_fwd` gives: returns ``(o, lse)``."""
    b, h, hkv, s, d = _dims(q, k, v, heads)
    _check_kernel("flash forward", d, q, k, v, dims=_fma_dims(q.dtype))
    seg, win = _mask_args("flash forward", q, k, heads, window, segment_ids)
    route = plan_fwd(q.dtype, mask_kind(causal, window, segment_ids))
    o = torch.empty_like(q)
    lse = torch.empty(b * h, s, dtype=torch.float32, device=q.device)
    code = _build.library().taper_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), seg, b, h, hkv, s, d, float(scale),
        int(bool(causal)), win, _layout(heads), _build.DTYPES[q.dtype],
        _build.stream(q))
    _build.check(code, "flash attention")
    backend.count_launch("flash_fwd")
    backend.count_route(route, "flash_fwd", 1)
    return o, lse


def bound_predicate(q, k, *, scale, heads=None):
    """What the bound arm of K8 needs, computed on the device without a
    host sync (plain PyTorch, as the JAX package's norm pre-pass is plain
    XLA): ``max |k|`` over positions per (batch, KV head), ``[B*Hkv]`` f32,
    and the arm as one int32, ``max |q| * scale * log2(e) * max |k| <=``
    :data:`BOUND_LIMIT`."""
    b, h, hkv, s, d = _dims(q, k, k, heads)
    if heads is not None:
        q, k = q.reshape(b, s, h, d), k.reshape(b, s, hkv, d)
    qn = torch.linalg.vector_norm(q, dim=-1, dtype=torch.float32)
    kn = torch.linalg.vector_norm(k, dim=-1, dtype=torch.float32)
    kn = kn.amax(dim=2 if heads is None else 1).reshape(-1)
    pred = qn.amax() * (scale * LOG2E) * kn.amax() <= BOUND_LIMIT
    return kn, pred.to(torch.int32).reshape(1)


def flash_fwd_bound(q, k, v, *, scale, heads=None, force_bound=None):
    """The bound-max kernel (K8, route ``"wgmma"``) on bf16 causal CUDA
    tensors in either layout: returns ``(o, lse)``.  ``force_bound``
    (True: the bound arm, False: the exact arm) overrides the device
    predicate; it exists for the card tests and ``chip_smoke.py``, which
    must reach both arms."""
    b, h, hkv, s, d = _dims(q, k, v, heads)
    _check_kernel("flash forward (bound)", d, q, k, v)
    if q.dtype != torch.bfloat16:
        raise ValueError("flash forward (bound): the kernel takes bf16")
    route = plan_fwd(q.dtype, "causal")
    kn, pred = bound_predicate(q, k, scale=scale, heads=heads)
    if force_bound is not None:
        pred = torch.full_like(pred, int(bool(force_bound)))
    o = torch.empty_like(q)
    lse = torch.empty(b * h, s, dtype=torch.float32, device=q.device)
    code = _build.library().taper_flash_fwd_bound(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), kn.data_ptr(), pred.data_ptr(),
        backend.bound_arm_counter(q.device).data_ptr(), b, h, hkv, s, d,
        float(scale), _layout(heads), _build.stream(q))
    _build.check(code, "flash attention (bound)")
    backend.count_launch("flash_fwd_bound")
    backend.count_route(route, "flash_fwd_bound", 1)
    return o, lse


def _bwd_args(name, q, k, v, heads, causal, scale, window, segment_ids,
              *more, rows=(), dims=HEAD_DIMS):
    """Checks a backward kernel's inputs; returns ``(seg pointer, dims
    and flags for the C entry point)``."""
    b, h, hkv, s, d = _dims(q, k, v, heads)
    for t in more:
        if t.shape != q.shape:
            raise ValueError(f"{name}: o and do must have q's shape "
                             f"{tuple(q.shape)}, got {tuple(t.shape)}")
    _check_kernel(name, d, q, k, v, *more, dims=dims)
    backend.check_kernel_args(name, *rows, dtypes=(torch.float32,))
    seg, win = _mask_args(name, q, k, heads, window, segment_ids)
    return seg, (b, h, hkv, s, d, float(scale), int(bool(causal)), win,
                 _layout(heads), _build.DTYPES[q.dtype], _build.stream(q))


def flash_dq(q, k, v, o, lse, do, *, causal, scale, heads=None,
             window=None, segment_ids=None):
    """K6 on CUDA tensors in either layout (``o`` and ``do`` in ``q``'s),
    through the route :func:`plan_bwd` gives: returns ``(dq, delta)``,
    ``delta`` ``[B*H, S]`` f32 for K7/K11."""
    seg, args = _bwd_args("flash backward dQ", q, k, v, heads, causal,
                          scale, window, segment_ids, o, do, rows=(lse,),
                          dims=_fma_dims(q.dtype))
    route = plan_bwd(q.dtype)
    dq = torch.empty_like(q)
    delta = torch.empty_like(lse)
    code = _build.library().taper_flash_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), dq.data_ptr(), delta.data_ptr(), seg,
        *args)
    _build.check(code, "flash backward dQ")
    backend.count_launch("flash_dq")
    backend.count_route(route, "flash_dq", 1)
    return dq, delta


def flash_dkv(q, k, v, lse, delta, do, *, causal, scale, heads=None,
              window=None, segment_ids=None):
    """K7 on CUDA tensors in either layout, after K6 (its ``delta``),
    through the route :func:`plan_bwd` gives: returns ``(dk, dv)``."""
    seg, args = _bwd_args("flash backward dK/dV", q, k, v, heads, causal,
                          scale, window, segment_ids, do, rows=(lse, delta),
                          dims=_fma_dims(q.dtype))
    route = plan_bwd(q.dtype)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    code = _build.library().taper_flash_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), seg,
        *args)
    _build.check(code, "flash backward dK/dV")
    backend.count_launch("flash_dkv")
    backend.count_route(route, "flash_dkv", 1)
    return dk, dv


def flash_dkv_t(q, k, v, lse, delta, do, *, causal, scale, heads=None,
                window=None):
    """K11 on CUDA tensors in either layout, after K6 (its ``delta``),
    through the route :func:`plan_bwd` gives: returns the per-query-head
    partials ``(dk, dv)``, f32 ``[B, H, S, D]`` (:func:`group_sum` reduces
    them).  No segment ids, as in JAX."""
    _, args = _bwd_args("flash backward dK/dV (per head)", q, k, v, heads,
                        causal, scale, window, None, do, rows=(lse, delta),
                        dims=_fma_dims(q.dtype))
    route = plan_bwd(q.dtype)
    b, h, _, s, d = args[:5]
    dk, dv = (torch.empty(b, h, s, d, dtype=torch.float32, device=q.device)
              for _ in range(2))
    code = _build.library().taper_flash_dkv_t(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *args)
    _build.check(code, "flash backward dK/dV (per head)")
    backend.count_launch("flash_dkv_t")
    backend.count_route(route, "flash_dkv_t", 1)
    return dk, dv


def group_sum(part, like, heads=None):
    """K11's per-query-head partials ``[B, H, S, D]`` summed over each KV
    head's query group in f32 and cast to ``like``'s dtype and layout
    (plain PyTorch, as JAX sums after its kernel)."""
    b, h, s, d = part.shape
    hkv = like.shape[1] if heads is None else like.shape[2] // d
    # a group of one head sums nothing
    out = part if h == hkv else part.reshape(b, hkv, h // hkv, s, d).sum(2)
    return _from_bhsd(out, heads).to(like.dtype).contiguous()


def flash_bwd_fused(q, k, v, o, lse, do, *, causal, scale, heads=None,
                    window=None, segment_ids=None):
    """K10 on CUDA tensors in either layout, through the route
    :func:`plan_bwd` gives: its delta pre-pass, the fused sweep and the
    dQ epilogue (three launches, one count).  Returns ``(dq, dk, dv,
    delta)``."""
    seg, args = _bwd_args("flash backward (fused)", q, k, v, heads, causal,
                          scale, window, segment_ids, o, do, rows=(lse,))
    route = plan_bwd(q.dtype)
    b, h, _, s, d = args[:5]
    # the sweep's f32 dQ sums, each 64-row query tile in one block (the
    # kernel's own order inside it)
    dq_acc = torch.zeros(b * h * -(-s // 64) * 64 * d, dtype=torch.float32,
                         device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty_like(lse)
    code = _build.library().taper_flash_bwd_fused(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq_acc.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), seg, *args)
    _build.check(code, "flash backward (fused)")
    backend.count_launch("flash_bwd_fused")
    backend.count_route(route, "flash_bwd_fused", 1)
    return dq, dk, dv, delta


def _flag(name):
    return os.environ.get(name, "0") == "1"


def flash_bwd(q, k, v, o, lse, do, *, causal, scale, heads=None,
              window=None, segment_ids=None):
    """The backward on CUDA tensors: K6 then K7 by default; K10 under
    ``TAPER_ATTN_FUSED_BWD=1`` for plain causal attention; K6 then K11
    under ``TAPER_ATTN_DKV_T=1`` for non-causal or windowed attention
    without segments.  Returns ``(dq, dk, dv, delta)``."""
    plain_causal = causal and window is None and segment_ids is None
    if plain_causal and _flag("TAPER_ATTN_FUSED_BWD"):
        return flash_bwd_fused(q, k, v, o, lse, do, causal=causal,
                               scale=scale, heads=heads)
    dq, delta = flash_dq(q, k, v, o, lse, do, causal=causal, scale=scale,
                         heads=heads, window=window,
                         segment_ids=segment_ids)
    if (segment_ids is None and not (causal and window is None)
            and _flag("TAPER_ATTN_DKV_T")):
        parts = flash_dkv_t(q, k, v, lse, delta, do, causal=causal,
                            scale=scale, heads=heads, window=window)
        dk, dv = (group_sum(p, t, heads) for p, t in zip(parts, (k, v)))
    else:
        dk, dv = flash_dkv(q, k, v, lse, delta, do, causal=causal,
                           scale=scale, heads=heads, window=window,
                           segment_ids=segment_ids)
    return dq, dk, dv, delta


class _Flash(torch.autograd.Function):
    """Attention in either layout with the flash VJP
    (``attention.py:1586-1657``, ``_flash``/``_flash_bshd``/``_flash_seg``):
    the forward keeps ``o`` and ``lse``, the backward recomputes the
    weights from them; ``segment_ids`` get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, causal, scale, heads, window):
        if backend.on_cuda(q, k, v):
            if uses_bound(q.dtype, mask_kind(causal, window, segment_ids)):
                o, lse = flash_fwd_bound(q, k, v, scale=scale, heads=heads)
            else:
                o, lse = flash_fwd_exact(q, k, v, causal=causal, scale=scale,
                                         heads=heads, window=window,
                                         segment_ids=segment_ids)
        else:
            d = q.shape[-1] if heads is None else q.shape[-1] // heads
            o, lse = attention_lse_reference(
                *(_to_bhsd(t, heads, d) for t in (q, k, v)), causal=causal,
                scale=scale, window=window, segment_ids=segment_ids)
            o = _from_bhsd(o, heads)
        ctx.save_for_backward(q, k, v, o, lse, segment_ids)
        ctx.causal, ctx.scale, ctx.heads = causal, scale, heads
        ctx.window = window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, seg = ctx.saved_tensors
        causal, scale, heads = ctx.causal, ctx.scale, ctx.heads
        if backend.on_cuda(q, k, v):
            dq, dk, dv, _ = flash_bwd(q, k, v, o, lse, do.contiguous(),
                                      causal=causal, scale=scale,
                                      heads=heads, window=ctx.window,
                                      segment_ids=seg)
        else:
            d = q.shape[-1] if heads is None else q.shape[-1] // heads
            grads = flash_bwd_reference(
                *(_to_bhsd(t, heads, d) for t in (q, k, v, o)), lse,
                _to_bhsd(do, heads, d), causal, scale, window=ctx.window,
                segment_ids=seg)[:3]
            dq, dk, dv = (_from_bhsd(g, heads).to(t.dtype)
                          for g, t in zip(grads, (q, k, v)))
        return dq, dk, dv, None, None, None, None, None


def _apply(q, k, v, heads, causal, scale, window, segment_ids):
    d = _dims(q, k, v, heads)[4]
    check_mask(q, k, window, segment_ids, heads)
    if segment_ids is not None and backend.on_cuda(q):
        segment_ids = segment_ids.to(q.device, torch.int32).contiguous()
    scale = d ** -0.5 if scale is None else scale
    return _Flash.apply(q, k, v, segment_ids, bool(causal), float(scale),
                        heads, None if window is None else int(window))


def attention(q, k, v, *, causal=False, scale=None, window=None,
              segment_ids=None):
    """Flash attention over ``[B, H, S, D]``, differentiable, with an
    optional sliding ``window`` or ``segment_ids [B, S]``; see the module
    docstring."""
    return _apply(q, k, v, None, causal, scale, window, segment_ids)


def attention_bshd(q, k, v, num_heads, *, causal=False, scale=None,
                   window=None, segment_ids=None):
    """Flash attention in the projections' layout: ``q`` ``[B, S, H*D]``,
    ``k``/``v`` ``[B, S, Hkv*D]``, output ``[B, S, H*D]``; numerically the
    same as :func:`attention` on the transposed inputs, masks included
    (JAX's ``flash_attention_bshd`` takes none; the kernels read either
    layout, so the port's does)."""
    return _apply(q, k, v, int(num_heads), causal, scale, window,
                  segment_ids)
