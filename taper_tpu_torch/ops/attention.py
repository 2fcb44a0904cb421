"""Scaled dot-product attention, differentiable: port of the flash kernels
of ``taper_tpu/ops/pallas/attention.py`` (``flash_attention`` and
``flash_attention_bshd`` -> ``_flash_fwd`` -> ``_fwd_kernel`` (K5) or
``_fwd_kernel_bound`` (K8); ``_flash_bwd_impl`` -> ``_dq_kernel`` (K6) then
``_dkv_kernel`` (K7)) and of the plain version ``taper_tpu/ops/xla.py::
attention``.

Two layouts, as in the JAX package: :func:`attention` takes ``q``
``[B, H, S, D]`` and ``k``/``v`` ``[B, Hkv, S, D]``; :func:`attention_bshd`
takes the projections' own ``[B, S, H*D]`` and ``[B, S, Hkv*D]``, which the
kernels read through strides, without a transposed copy in either pass.
``H % Hkv == 0`` (GQA/MQA: query head ``h`` reads KV head
``h // (H / Hkv)``).  Softmax statistics are f32 at any input dtype; the
output has ``q``'s dtype.

Both are ``torch.autograd.Function``s.  CPU tensors run the plain versions
(:func:`attention_lse_reference` forward, :func:`flash_bwd_reference`
backward); CUDA tensors run the kernels of ``csrc/flash_fwd.cu`` and
``csrc/flash_bwd.cu`` at every shape they take (f32 or bf16, D of 64 or
128, any S), or raise.  The forward picks its kernel as JAX does
(``attention.py:1155``): the bound-max K8 for bf16 causal inputs, with its
exact arm chosen on the device by :func:`bound_predicate`; the exact K5
for the rest.  The JAX package's S >= 1024 crossover to its kernel was
measured on a TPU and is not inherited.  Sliding windows, segment ids and
q/k offsets are not ported yet.
"""

from __future__ import annotations

import math

import torch

from taper_tpu_torch.ops import _build
from taper_tpu_torch.ops import backend
from taper_tpu_torch.utils import not_ported

HEAD_DIMS = (64, 128)
LOG2E = math.log2(math.e)
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


def attention_lse_reference(q, k, v, *, causal=False, scale=None):
    """Plain version of the forward over ``[B, H, S, D]`` (the
    ``ops/xla.py`` oracle): f32 scores and softmax, the weights cast to
    ``v``'s dtype before the second product, GQA broadcasting each KV head
    over its query group.  Returns ``(o, lse)``, ``lse`` the natural-log
    row logsumexp ``[B*H, S]`` f32 that the kernels export."""
    b, h, hkv, s, d = _dims(q, k, v)
    if scale is None:
        scale = d ** -0.5
    qg = q.float().reshape(b, hkv, h // hkv, s, d)
    sc = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) * scale
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        sc = sc.masked_fill(~keep, float("-inf"))
    lse = torch.logsumexp(sc, dim=-1)
    p = torch.softmax(sc, dim=-1).to(v.dtype).float()
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return o.reshape(b, h, s, d).to(q.dtype), lse.reshape(b * h, s)


def attention_reference(q, k, v, *, causal=False, scale=None):
    """Plain version of the forward: the output of
    :func:`attention_lse_reference`."""
    return attention_lse_reference(q, k, v, causal=causal, scale=scale)[0]


def flash_bwd_reference(q, k, v, o, lse, do, causal, scale):
    """Plain version of the backward over ``[B, H, S, D]``, written out
    with the formulas of the JAX kernels in f32: ``p = exp(s - lse)``,
    ``delta = rowsum(dO * O)``, ``ds = p * (dO V^T - delta)``,
    ``dQ = ds K scale``, ``dK = ds^T Q scale``, ``dV = p^T dO``, dK and dV
    summed over each KV head's query group.  Returns ``(dq, dk, dv,
    delta)`` in f32, ``delta`` ``[B*H, S]``."""
    b, h, hkv, s, d = _dims(q, k, v)
    g = h // hkv
    qf = q.float().reshape(b, hkv, g, s, d)
    dof = do.float().reshape(b, hkv, g, s, d)
    kf, vf = k.float(), v.float()
    sc = torch.einsum("bkgqd,bksd->bkgqs", qf, kf) * scale
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        sc = sc.masked_fill(~keep, float("-inf"))
    lse = lse.float().reshape(b, hkv, g, s)
    # a fully masked row has lse = -inf; its weights are 0 either way
    lse = torch.where(torch.isfinite(lse), lse, torch.zeros_like(lse))
    p = torch.exp(sc - lse[..., None])
    delta = (dof * o.float().reshape(b, hkv, g, s, d)).sum(-1)
    dp = torch.einsum("bkgqd,bksd->bkgqs", dof, vf)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, kf) * scale
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, qf) * scale
    dv = torch.einsum("bkgqs,bkgqd->bksd", p, dof)
    return dq.reshape(b, h, s, d), dk, dv, delta.reshape(b * h, s)


# -- the kernels (CUDA tensors only) ---------------------------------------

def _check_kernel(name, d, *tensors):
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: kernel takes head_dim in {HEAD_DIMS}, "
                         f"got {d}")
    if len({t.dtype for t in tensors}) != 1:
        raise ValueError(f"{name}: q, k, v (and o, do) must share one dtype")
    backend.check_kernel_args(name, *tensors, dtypes=_build.DTYPES)


def _layout(heads):
    return 0 if heads is None else 1   # layout codes of flash_common.cuh


def flash_fwd_exact(q, k, v, *, causal, scale, heads=None):
    """The exact kernel (K5) on CUDA tensors in either layout: returns
    ``(o, lse)``."""
    b, h, hkv, s, d = _dims(q, k, v, heads)
    _check_kernel("flash forward", d, q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty(b * h, s, dtype=torch.float32, device=q.device)
    code = _build.library().taper_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, h, hkv, s, d, float(scale), int(bool(causal)),
        _layout(heads), _build.DTYPES[q.dtype], _build.stream(q))
    _build.check(code, "flash attention")
    backend.count_launch("flash_fwd")
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
    """The bound-max kernel (K8) on bf16 causal CUDA tensors in either
    layout: returns ``(o, lse)``.  ``force_bound`` (True: the bound arm,
    False: the exact arm) overrides the device predicate; it exists for the
    card tests and ``chip_smoke.py``, which must reach both arms."""
    b, h, hkv, s, d = _dims(q, k, v, heads)
    _check_kernel("flash forward (bound)", d, q, k, v)
    if q.dtype != torch.bfloat16:
        raise ValueError("flash forward (bound): the kernel takes bf16")
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
    return o, lse


def _bwd_args(name, q, k, v, heads, causal, scale, *more):
    b, h, hkv, s, d = _dims(q, k, v, heads)
    for t in more:
        if t.shape != q.shape:
            raise ValueError(f"{name}: o and do must have q's shape "
                             f"{tuple(q.shape)}, got {tuple(t.shape)}")
    _check_kernel(name, d, q, k, v, *more)
    return (b, h, hkv, s, d, float(scale), int(bool(causal)),
            _layout(heads), _build.DTYPES[q.dtype], _build.stream(q))


def flash_dq(q, k, v, o, lse, do, *, causal, scale, heads=None):
    """K6 on CUDA tensors in either layout (``o`` and ``do`` in ``q``'s):
    returns ``(dq, delta)``, ``delta`` ``[B*H, S]`` f32 for K7."""
    args = _bwd_args("flash backward dQ", q, k, v, heads, causal, scale, o,
                     do)
    backend.check_kernel_args("flash backward dQ", lse,
                              dtypes=(torch.float32,))
    dq = torch.empty_like(q)
    delta = torch.empty_like(lse)
    code = _build.library().taper_flash_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), dq.data_ptr(), delta.data_ptr(),
        *args)
    _build.check(code, "flash backward dQ")
    backend.count_launch("flash_dq")
    return dq, delta


def flash_dkv(q, k, v, lse, delta, do, *, causal, scale, heads=None):
    """K7 on CUDA tensors in either layout, after K6 (its ``delta``):
    returns ``(dk, dv)``."""
    args = _bwd_args("flash backward dK/dV", q, k, v, heads, causal, scale,
                     do)
    backend.check_kernel_args("flash backward dK/dV", lse, delta,
                              dtypes=(torch.float32,))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    code = _build.library().taper_flash_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *args)
    _build.check(code, "flash backward dK/dV")
    backend.count_launch("flash_dkv")
    return dk, dv


def flash_bwd(q, k, v, o, lse, do, *, causal, scale, heads=None):
    """K6 then K7 on CUDA tensors: returns ``(dq, dk, dv, delta)``."""
    dq, delta = flash_dq(q, k, v, o, lse, do, causal=causal, scale=scale,
                         heads=heads)
    dk, dv = flash_dkv(q, k, v, lse, delta, do, causal=causal, scale=scale,
                       heads=heads)
    return dq, dk, dv, delta


class _Flash(torch.autograd.Function):
    """Attention in either layout with the flash VJP
    (``attention.py:1586-1628``): the forward keeps ``o`` and ``lse``, the
    backward recomputes the weights from them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, heads):
        if backend.on_cuda(q, k, v):
            if q.dtype == torch.bfloat16 and causal:
                o, lse = flash_fwd_bound(q, k, v, scale=scale, heads=heads)
            else:
                o, lse = flash_fwd_exact(q, k, v, causal=causal, scale=scale,
                                         heads=heads)
        else:
            d = q.shape[-1] if heads is None else q.shape[-1] // heads
            o, lse = attention_lse_reference(
                *(_to_bhsd(t, heads, d) for t in (q, k, v)), causal=causal,
                scale=scale)
            o = _from_bhsd(o, heads)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale, ctx.heads = causal, scale, heads
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, scale, heads = ctx.causal, ctx.scale, ctx.heads
        if backend.on_cuda(q, k, v):
            dq, dk, dv, _ = flash_bwd(q, k, v, o, lse, do.contiguous(),
                                      causal=causal, scale=scale,
                                      heads=heads)
        else:
            d = q.shape[-1] if heads is None else q.shape[-1] // heads
            grads = flash_bwd_reference(
                *(_to_bhsd(t, heads, d) for t in (q, k, v, o)), lse,
                _to_bhsd(do, heads, d), causal, scale)[:3]
            dq, dk, dv = (_from_bhsd(g, heads).to(t.dtype)
                          for g, t in zip(grads, (q, k, v)))
        return dq, dk, dv, None, None, None


def attention(q, k, v, *, causal=False, scale=None, window=None,
              segment_ids=None):
    """Flash attention over ``[B, H, S, D]``, differentiable; see the
    module docstring.  ``window`` and ``segment_ids`` are not ported yet
    and raise."""
    not_ported("attention", window=window is not None,
               segment_ids=segment_ids is not None)
    d = _dims(q, k, v)[4]
    scale = d ** -0.5 if scale is None else scale
    return _Flash.apply(q, k, v, bool(causal), float(scale), None)


def attention_bshd(q, k, v, num_heads, *, causal=False, scale=None):
    """Flash attention in the projections' layout: ``q`` ``[B, S, H*D]``,
    ``k``/``v`` ``[B, S, Hkv*D]``, output ``[B, S, H*D]``; numerically the
    same as :func:`attention` on the transposed inputs."""
    d = _dims(q, k, v, num_heads)[4]
    scale = d ** -0.5 if scale is None else scale
    return _Flash.apply(q, k, v, bool(causal), float(scale), int(num_heads))
