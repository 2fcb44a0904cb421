"""Scaled dot-product attention: port of the flash forward of
``taper_tpu/ops/pallas/attention.py`` (``flash_attention`` ->
``_flash_fwd`` -> ``_fwd_kernel``) and of the plain version
``taper_tpu/ops/xla.py::attention``.

``q`` is ``[B, H, S, D]``, ``k``/``v`` are ``[B, Hkv, S, D]`` with
``H % Hkv == 0`` (GQA/MQA: query head ``h`` reads KV head
``h // (H // Hkv)``).  Softmax statistics are f32 at any input dtype; the
output has ``q``'s dtype.

CPU tensors run :func:`attention_reference`, which autograd
differentiates; CUDA tensors run the kernel of ``csrc/flash_fwd.cu`` at
every shape it takes (f32 or bf16, D of 64 or 128, any S).  The flash
backward kernels come with M2: until then a CUDA input that requires grad
under grad mode raises rather than return a detached result.  The JAX package's S >= 1024 crossover to its kernel was
measured on a TPU and is not inherited.  Sliding windows, segment ids,
q/k offsets and the logsumexp output are not ported yet.
"""

from __future__ import annotations

import torch

from taper_tpu_torch.ops import _build
from taper_tpu_torch.ops import backend

HEAD_DIMS = (64, 128)


def _check_shapes(q, k, v):
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} are not "
                         f"[B, H, S, D] and [B, Hkv, S, D]")
    b, h, s, d = q.shape
    if (k.shape[0] != b or k.shape[2] != s or k.shape[3] != d
            or h % k.shape[1]):
        raise ValueError(f"attention: q {tuple(q.shape)} does not match "
                         f"k/v {tuple(k.shape)}")


def attention_reference(q, k, v, *, causal=False, scale=None):
    """Plain PyTorch version (the ``ops/xla.py`` oracle): f32 scores and
    softmax, the weights cast to ``v``'s dtype before the second product.
    GQA broadcasts each KV head over its query group."""
    _check_shapes(q, k, v)
    b, h, s, d = q.shape
    hkv = k.shape[1]
    if scale is None:
        scale = d ** -0.5
    qg = q.float().reshape(b, hkv, h // hkv, s, d)
    sc = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) * scale
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        sc = sc.masked_fill(~keep, float("-inf"))
    p = torch.softmax(sc, dim=-1).to(v.dtype).float()
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return o.reshape(b, h, s, d).to(q.dtype)


def attention(q, k, v, *, causal=False, scale=None):
    """Flash attention forward; see the module docstring."""
    _check_shapes(q, k, v)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not backend.on_cuda(q, k, v):
        return attention_reference(q, k, v, causal=causal, scale=scale)
    b, h, s, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"attention: kernel takes head_dim in {HEAD_DIMS}, "
                         f"got {d}")
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError("attention: q, k and v must share one dtype")
    backend.refuse_grad("attention", q, k, v)
    backend.check_kernel_args("attention", q, k, v, dtypes=_build.DTYPES)
    o = torch.empty_like(q)
    code = _build.library().taper_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, h,
        k.shape[1], s, d, float(scale), int(bool(causal)),
        _build.DTYPES[q.dtype], _build.stream(q))
    _build.check(code, "flash attention")
    backend.count_launch("flash_fwd")
    return o
