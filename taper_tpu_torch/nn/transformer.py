"""Transformer building blocks: port of ``taper_tpu/nn/transformer.py``,
the part that serving (contiguous and paged KV caches, f32, bf16 and
int8) and training run.

Modules are ``torch.nn.Module``s whose parameter names mirror the JAX
parameter tree (``wq``, ``bq``, ..., ``g``, ``b``), so one tree moves
between the packages by name (``utils/convert.py``).  Parameters stay f32;
a ``compute_dtype`` trunk casts activations, and :func:`_proj` casts each
weight to the activation dtype (``TinyGPT.cast_projections`` does that
cast once, ahead of serving).  Normalisation statistics and the softmax
stay f32.

A weight may be a PTQ ``QuantizedTensor`` in place of its parameter
(``quantization.quantize_params``): :func:`_proj` hands it to
``ops.linear`` untouched, so int8 and int4 weights reach the
dequant-on-load kernels, and ``Embedding`` dequantizes its table.

The KV caches are updated IN PLACE (``_cache_write``, the paged writes),
where the JAX package returns new caches that its jitted programs donate.
A contiguous cache is ``{"k", "v": [B, kvh, max_seq, D]}``, with int8 rows
and ``"k_scale"``/``"v_scale"`` ``[B, kvh, max_seq]`` f32 when quantized;
decode attention over it (``_decode_attention``) is plain PyTorch, as the
JAX package leaves it to XLA with no Pallas kernel.  A sliding-window
model (``window=W``) may keep a W-slot ring instead (``init_cache(...,
ring=True)``): position ``p`` lives in slot ``p % W``, and a cache shorter
than ``max_seq`` is read and written as a ring, as in JAX.

Packed sequences: ``forward(x, segment_ids=, positions=)`` masks attention
to each document and rotates every token by its own position.

Training options: ``TransformerBlock(dropout=p)`` drops the attention
and FFN outputs before each residual add when called with ``train=True``
and a ``generator`` (two masks from it, in that order, where JAX splits
the block's key in two).  ``n_experts > 0`` swaps the FFN for
:class:`MoEMLP`, dense (every expert on every token) or capacity-routed
(``capacity_factor``), with the routing and dispatch in the plain
functions :func:`moe_capacity`, :func:`moe_sparse_routing` and
:func:`moe_sparse_dispatch`.

Chunked decode (``MultiHeadAttention.chunk``, ``TransformerBlock.chunk``;
JAX's ``mha_apply_chunk``/``block_apply_chunk``) scores C tokens at
positions ``[pos, pos + C)`` against the contiguous cache in one pass:
``pos`` is a scalar, or ``[B]`` per-row starts (per-row speculative
verification), and each query row attends up to its own position through
``_decode_attention(q_offsets=)``.  It is what ``TinyGPT.decode_chunk``,
``generate_continued``, ``speculative_generate`` and the engine's shared
system prompt run.

Not ported yet: LoRA and bias-free projections; their arguments raise
``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from taper_tpu_torch import ops
from taper_tpu_torch.nn.layers import Dropout
from taper_tpu_torch.ops import gemm as _gemm
from taper_tpu_torch.ops.paged_attention import (
    paged_decode_attention, paged_write, paged_write_scale)
from taper_tpu_torch.ops.quant import w8a8_engages
from taper_tpu_torch.quantization.qtensor import QuantizedTensor, dense
from taper_tpu_torch.utils import not_ported


class LayerNorm(nn.Module):
    """LayerNorm over the last axis; statistics in f32 at any input dtype."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.g = nn.Parameter(torch.ones(dim))
        self.b = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + self.eps)
        return (y * self.g + self.b).to(x.dtype)


class RMSNorm(nn.Module):
    """RMS normalization (no mean subtraction, no bias); f32 statistics."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.g = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        xf = x.float()
        ms = xf.square().mean(-1, keepdim=True)
        return (xf * torch.rsqrt(ms + self.eps) * self.g).to(x.dtype)


class Embedding(nn.Module):
    """Token/position embedding table ``w [num_embeddings, dim]``."""

    def __init__(self, num_embeddings: int, dim: int,
                 init_std: float = 0.02):
        super().__init__()
        self.init_std = init_std
        self.w = nn.Parameter(torch.empty(num_embeddings, dim))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.w.normal_(0.0, self.init_std, generator=generator)

    def forward(self, ids):
        return F.embedding(ids, dense(self.w))   # a PTQ'd table dequantizes


def _proj(x2, w, b):
    """``[R, E_in] @ w[E_out, E_in]^T + b`` at the activation dtype: the
    weights are cast to ``x2``'s dtype (a no-op once cast ahead), and K1
    writes its f32 result in that dtype (the same bits as JAX's f32
    result cast back), so a bf16 trunk stays bf16.

    A quantized weight goes to ``ops.linear`` untouched
    (``taper_tpu/nn/transformer.py:121-134``) with f32 activations, or
    with the trunk's own where W8A8 engages: its row quantization reads
    them as they are, and a bf16 trunk keeps a bf16 product."""
    if isinstance(w, QuantizedTensor):
        xin = x2 if w8a8_engages(x2, w) else x2.float()
        return ops.linear(xin, w, b).to(x2.dtype)
    return _gemm.linear(x2, w.to(x2.dtype),
                        None if b is None else b.to(x2.dtype),
                        out_dtype=x2.dtype)


def rope_angles(head_dim: int, max_seq: int, base: float = 10000.0):
    """cos/sin tables ``[max_seq, head_dim/2]`` (f32)."""
    if head_dim % 2:
        raise ValueError(f"rope needs an even head_dim, got {head_dim}")
    inv = base ** (-torch.arange(0, head_dim, 2, dtype=torch.float32)
                   / head_dim)
    t = torch.arange(max_seq, dtype=torch.float32)[:, None] * inv[None, :]
    return torch.cos(t), torch.sin(t)


def apply_rope(x, cos, sin, offset=0):
    """Rotate ``x [B, H, S, D]`` by position (half-split, not interleaved).
    ``offset``: an int or a 0-d tensor shifts the table (a tensor start
    is clamped into the table, as ``dynamic_slice`` clamps it); a ``[B]``
    tensor gives each row its own position (decode, S == 1); a ``[B, S]``
    tensor gives every token its own (packed sequences: positions restart
    per document).  The f32 tables are cast to ``x``'s dtype before the
    multiply."""
    s, half = x.shape[2], x.shape[3] // 2
    if torch.is_tensor(offset) and offset.dim() == 2:
        idx = offset.long()
        c, si = cos[idx][:, None], sin[idx][:, None]       # [B, 1, S, half]
    elif torch.is_tensor(offset) and offset.dim() == 0:
        start = offset.long().clamp(0, cos.shape[0] - s)
        idx = start + torch.arange(s, device=offset.device)
        c, si = cos[idx][None, None], sin[idx][None, None]
    elif torch.is_tensor(offset):
        if s != 1:
            raise ValueError("per-row rope offsets require single-token "
                             f"steps, got {s} tokens")
        # a frozen serving row may step past the table; its tokens are
        # discarded, so any in-range angle will do
        idx = offset.long().clamp(max=cos.shape[0] - 1)
        c = cos[idx][:, None, None, :]                     # [B, 1, 1, half]
        si = sin[idx][:, None, None, :]
    else:
        c = cos[offset:offset + s][None, None]
        si = sin[offset:offset + s][None, None]
    c, si = c.to(x.dtype), si.to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * si, x2 * c + x1 * si], dim=-1)


def apply_rope_bshd(x, cos, sin, n_heads, offset=0):
    """Rotate ``x [B, S, H*D]`` by position: the projection-layout twin of
    :func:`apply_rope` (the ``[B, S, H, D]`` view is a reshape, not a
    copy).  ``offset``: an int shifts the table; a ``[B, S]`` tensor gives
    every token its own position."""
    b, s, e = x.shape
    half = e // n_heads // 2
    x4 = x.reshape(b, s, n_heads, 2 * half)
    if torch.is_tensor(offset):
        if offset.dim() != 2:
            raise ValueError("apply_rope_bshd: offset is an int or [B, S] "
                             "positions ([B] per-row offsets are a decode "
                             "form: use apply_rope)")
        idx = offset.long()
        c, si = cos[idx][:, :, None], sin[idx][:, :, None]  # [B, S, 1, half]
    else:
        c = cos[offset:offset + s][None, :, None]
        si = sin[offset:offset + s][None, :, None]
    c, si = c.to(x.dtype), si.to(x.dtype)
    x1, x2 = x4[..., :half], x4[..., half:]
    out = torch.cat([x1 * c - x2 * si, x2 * c + x1 * si], dim=-1)
    return out.reshape(b, s, e)

# ---------------------------------------------------------------------------
# KV-cache decode path (serving)
# ---------------------------------------------------------------------------

def _is_rows(pos) -> bool:
    """A ``[B]`` tensor of per-row positions (ragged serving), as against
    a scalar position (an int or a 0-d tensor) shared by every row."""
    return torch.is_tensor(pos) and pos.dim() == 1


def kv_quantize(x):
    """Symmetric int8 row quantization for KV cache entries: one scale per
    (batch, head, position), amax over the head dim, round half to even.
    Returns ``(int8 rows, f32 scales [..., :-1 dims])``.

    The scale is ``max(amax, 1e-8) * f32(1/127)``: JAX's ``/ 127.0``
    under ``jit`` (every serving program of the JAX package) is folded by
    XLA into that multiply, where an eager JAX call divides, which differs
    in the last bit.  The codes divide by the scale (a tensor: one true
    division on every device)."""
    xf = x.float()
    amax = xf.abs().amax(-1)
    # a fill on the device, not a host copy: decode steps run under
    # CUDA-graph capture, which refuses host-to-device copies
    inv = torch.full((), 1.0 / 127.0, dtype=torch.float32, device=x.device)
    scale = torch.clamp(amax, min=1e-8) * inv
    q = torch.round(xf / scale[..., None])
    return q.to(torch.int8), scale


def _decode_attention(q, k_cache, v_cache, pos, scale, window=None,
                      k_scale=None, v_scale=None, q_offsets=None,
                      ring=False):
    """Single- or few-position attention against a contiguous KV cache:
    ``q`` ``[B, H, Q, D]``, caches ``[B, H, Smax, D]``; entries past
    ``pos`` (a scalar, or ``[B]`` per-row positions) are masked out.
    ``q_offsets`` ``[Q]`` (chunked decode): query row r sits at absolute
    position ``pos + q_offsets[r]`` and attends the cache up to there;
    omitted, every row sits at ``pos``.  Scores and the softmax are f32.
    int8 caches (``k_scale``/``v_scale`` ``[B, H, Smax]``): the rows enter
    the dots in f32, the k scale multiplies the scores after the dot and
    the v scale the softmax weights before theirs.  f32/bf16 caches: the
    weights are cast to the cache dtype before ``P.V``, as JAX does.
    ``window``: entries at or before ``pos - window`` are masked too.
    ``ring``: the cache is a W-slot ring (W its length) whose slot ``s``
    holds absolute position ``pos - ((pos - s) mod W)``; only slots never
    written (a negative position) are masked, the window holds by
    construction.  Plain PyTorch on every device: JAX runs this as XLA,
    with no Pallas kernel."""
    s = torch.matmul(q.float(), k_cache.float().transpose(-1, -2)) * scale
    if k_scale is not None:
        s = s * k_scale[:, :, None, :]
    idx = torch.arange(k_cache.shape[2], device=q.device)
    # each query row's absolute position: [B, Q, 1] for per-row starts,
    # [Q, 1] (or the scalar itself, every row at pos) for a shared one
    base = pos.long() if torch.is_tensor(pos) else int(pos)
    if q_offsets is None:
        qpos = base[:, None, None] if _is_rows(pos) else base
    else:
        off = torch.as_tensor(q_offsets, device=q.device).long()
        qpos = (base[:, None] + off if _is_rows(pos) else base + off)
        qpos = qpos[..., None]
    if ring:
        # torch.remainder is a floor modulo, as numpy's and JAX's %
        mask = qpos - torch.remainder(qpos - idx, k_cache.shape[2]) >= 0
    else:
        mask = idx <= qpos
        if window is not None:
            mask = mask & (idx > qpos - window)
    if _is_rows(pos):
        mask = mask[:, None]                   # [B, 1, Q, S]
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    if v_scale is not None:
        p = p * v_scale[:, :, None, :]
        return torch.matmul(p, v_cache.float())
    return torch.matmul(p.to(v_cache.dtype), v_cache)


def _cache_write(cache, k, v, pos, ring=False):
    """Write new K/V rows ``[B, kvh, C, D]`` into a contiguous cache, in
    place: at ``[pos, pos + C)`` for a scalar ``pos`` (prefill, lockstep
    decode), or row b's C rows at ``[pos[b], pos[b] + C)`` for ``[B]``
    starts (ragged decode at C = 1, per-row speculative verification at C
    = γ + 1).  Quantizes the rows when the cache holds scales.  A start
    past the cache is clamped to ``Smax - C``, as XLA's
    ``dynamic_update_slice`` clamps it: a frozen serving row that keeps
    stepping past ``max_seq`` rewrites its last entries, whose tokens the
    engine discards.  One indexed write stands for JAX's three write
    strategies, which are XLA speed choices with one result for every
    start the callers give (``pos[b] + C <= Smax``).

    ``ring=True``: the cache is a W-slot ring (W its length); position
    ``p`` lands in slot ``p % W``, and of a C-row write longer than W only
    the last W rows are kept (only they would survive anyway).  Per-row
    starts write one row each there (chunked decode refuses rings)."""
    quantized = "k_scale" in cache
    new = {"k": k, "v": v}
    if quantized:
        new["k"], new["k_scale"] = kv_quantize(k)
        new["v"], new["v_scale"] = kv_quantize(v)
    smax, c = cache["k"].shape[2], k.shape[2]
    if ring and _is_rows(pos):
        if c != 1:
            raise ValueError("per-row chunks into a ring cache: chunked "
                             "decode does not support ring caches")
        pos = torch.remainder(pos, smax)       # then the per-row write
    elif ring:
        if c > smax:
            new = {name: x[:, :, c - smax:] for name, x in new.items()}
            pos, c = pos + (c - smax), smax
        start = torch.as_tensor(pos, device=k.device).long()
        slots = torch.remainder(start + torch.arange(c, device=k.device),
                                smax)
        for name, x in new.items():
            cache[name].index_copy_(2, slots, x.to(cache[name].dtype))
        return cache
    span = torch.arange(c, device=k.device)
    if _is_rows(pos):
        rows = torch.arange(k.shape[0], device=k.device)[:, None]
        at = pos.long().clamp(0, smax - c)[:, None] + span       # [B, C]
        for name, x in new.items():
            # [B, C] index pairs around the head dim: the selection is
            # [B, C, kvh(, D)], the rows' C axis moved ahead of the heads
            cache[name][rows, :, at] = x.movedim(2, 1).to(cache[name].dtype)
        return cache
    # the clamped start of dynamic_update_slice, kept on the device
    start = torch.as_tensor(pos, device=k.device).long().clamp(0, smax - c)
    for name, x in new.items():
        cache[name].index_copy_(2, start + span, x.to(cache[name].dtype))
    return cache


class MultiHeadAttention(nn.Module):
    """Multi-head self-attention over the flash kernels (on CUDA tensors).
    Input ``[B, S, E]``; GQA when ``num_kv_heads`` is smaller than
    ``num_heads``; ``window=W`` attends each token to the last W keys.
    ``forward`` keeps a head dim that is a multiple of 128 in the
    projections' ``[B, S, H*D]`` layout end to end
    (``ops.attention_bshd``, as JAX's ``nn/transformer.py:205-225``), and
    transposes to ``[B, H, S, D]`` otherwise.  JAX leaves the ``[B, S,
    H*D]`` path for a window or segment ids (``:205-207``), because its
    bshd kernel takes neither; the port's kernels read either layout
    through strides with the same numbers, so it keeps the one path."""

    def __init__(self, dim: int, num_heads: int, causal: bool = True,
                 bias: bool = True, init_std: float = 0.02,
                 out_init_std: Optional[float] = None, rope: bool = False,
                 max_seq: int = 4096, num_kv_heads: Optional[int] = None,
                 window: Optional[int] = None):
        super().__init__()
        not_ported("MultiHeadAttention", bias=not bias)
        if window is not None and window < 1:
            raise ValueError(f"window must be a positive int, got {window}")
        self.num_kv_heads = num_heads if num_kv_heads is None \
            else num_kv_heads
        if dim % num_heads or num_heads % self.num_kv_heads:
            raise ValueError(f"dim {dim}, num_heads {num_heads} and "
                             f"num_kv_heads {self.num_kv_heads} must divide "
                             f"evenly")
        self.dim = dim
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.kv_groups = num_heads // self.num_kv_heads
        self.kv_dim = self.num_kv_heads * self.head_dim
        self.causal = causal
        self.init_std = init_std
        self.out_init_std = init_std if out_init_std is None \
            else out_init_std
        self.rope = rope
        self.max_seq = max_seq
        self.window = window
        for name, out in (("q", dim), ("k", self.kv_dim), ("v", self.kv_dim),
                          ("o", dim)):
            self.register_parameter(f"w{name}",
                                    nn.Parameter(torch.empty(out, dim)))
            self.register_parameter(f"b{name}",
                                    nn.Parameter(torch.zeros(out)))
        if rope:
            cos, sin = rope_angles(self.head_dim, max_seq)
            self.register_buffer("rope_cos", cos, persistent=False)
            self.register_buffer("rope_sin", sin, persistent=False)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            for name in ("wq", "wk", "wv"):
                getattr(self, name).normal_(0.0, self.init_std,
                                            generator=generator)
            self.wo.normal_(0.0, self.out_init_std, generator=generator)
            for name in ("bq", "bk", "bv", "bo"):
                getattr(self, name).zero_()

    def _rope(self, x, offset=0):
        if not self.rope:
            return x
        return apply_rope(x, self.rope_cos, self.rope_sin, offset)

    def _qkv_heads(self, x, positions=None):
        """Projections as contiguous ``[B, H(kv), S, D]`` heads, rotated
        (by ``positions [B, S]`` when given)."""
        b, s, e = x.shape
        x2 = x.reshape(b * s, e)

        def heads(w, bias, n):
            y = _proj(x2, w, bias).reshape(b, s, n, self.head_dim)
            return y.transpose(1, 2).contiguous()

        off = 0 if positions is None else positions
        q = self._rope(heads(self.wq, self.bq, self.num_heads), off)
        k = self._rope(heads(self.wk, self.bk, self.num_kv_heads), off)
        v = heads(self.wv, self.bv, self.num_kv_heads)
        return q, k, v

    def _out(self, o):
        b, h, s, d = o.shape
        o2 = o.transpose(1, 2).reshape(b * s, h * d)
        return _proj(o2, self.wo, self.bo).reshape(b, s, h * d)

    def forward(self, x, segment_ids=None, positions=None):
        """``segment_ids [B, S]`` (packed sequences) masks attention to
        same-segment keys; ``positions [B, S]`` gives every token its own
        RoPE position (restarting per document)."""
        mask = dict(causal=self.causal, window=self.window,
                    segment_ids=segment_ids)
        if self.head_dim % 128:
            q, k, v = self._qkv_heads(x, positions)
            return self._out(ops.attention(q, k, v, **mask))
        # the transpose-free path: [B, S, H*D] from the projections to the
        # output projection
        b, s, e = x.shape
        x2 = x.reshape(b * s, e)
        q = _proj(x2, self.wq, self.bq).reshape(b, s, e)
        k = _proj(x2, self.wk, self.bk).reshape(b, s, self.kv_dim)
        v = _proj(x2, self.wv, self.bv).reshape(b, s, self.kv_dim)
        if self.rope:
            off = 0 if positions is None else positions
            q = apply_rope_bshd(q, self.rope_cos, self.rope_sin,
                                self.num_heads, off)
            k = apply_rope_bshd(k, self.rope_cos, self.rope_sin,
                                self.num_kv_heads, off)
        o = ops.attention_bshd(q, k, v, self.num_heads, **mask)
        return _proj(o.reshape(b * s, e), self.wo, self.bo).reshape(b, s, e)

    def _decode_heads(self, x_t, pos):
        """This step's rotated ``q [B, H, 1, D]`` and ``k``, ``v`` ``[B,
        kvh, 1, D]`` from ``x_t [B, 1, E]`` at ``pos``."""
        b, _, e = x_t.shape
        x2 = x_t.reshape(b, e)

        def heads(w, bias, n):
            return _proj(x2, w, bias).reshape(b, n, 1, self.head_dim)

        q = self._rope(heads(self.wq, self.bq, self.num_heads), pos)
        k = self._rope(heads(self.wk, self.bk, self.num_kv_heads), pos)
        v = heads(self.wv, self.bv, self.num_kv_heads)
        return q, k, v

    def _out_step(self, o, x_t):
        """Output projection of one step's ``[B, kvh, G, D]`` attention."""
        b, _, e = x_t.shape
        y = _proj(o.reshape(b, e).to(x_t.dtype), self.wo, self.bo)
        return y.reshape(b, 1, e)

    def init_cache(self, batch: int, max_seq: int, dtype=torch.float32,
                   quantized: bool = False, device=None, ring: bool = False):
        """``mha_init_cache``: zero K/V ``[batch, kvh, max_seq, D]`` of
        ``dtype``, or int8 rows with f32 ``k_scale``/``v_scale`` ``[batch,
        kvh, max_seq]`` when ``quantized`` (``dtype`` is then ignored).
        ``ring``: W slots in place of ``max_seq``, for a model with a
        window W shorter than ``max_seq`` only (raises otherwise)."""
        if ring:
            if self.window is None or self.window >= max_seq:
                raise ValueError("ring caches need a sliding-window model "
                                 f"(window {self.window}, max_seq "
                                 f"{max_seq})")
            max_seq = self.window
        shape = (batch, self.num_kv_heads, max_seq, self.head_dim)
        return _zero_cache(shape, dtype, quantized, device)

    def _ring(self, cache):
        """A cache shorter than ``max_seq`` is a ring (JAX's rule)."""
        return cache["k"].shape[2] < self.max_seq

    def prefill(self, x, cache):
        """Prompt prefill (``mha_apply_prefill``): one flash attention
        forward over ``x [B, P, E]`` on the full-precision K/V, which also
        fill cache positions ``[0, P)`` in place (quantized when the cache
        holds scales; through the ring, keeping the last W rows, when the
        cache is one).  Returns ``y [B, P, E]``."""
        q, k, v = self._qkv_heads(x)
        _cache_write(cache, k, v, 0, ring=self._ring(cache))
        return self._out(ops.attention(q, k, v, causal=True,
                                       window=self.window))

    def decode(self, x_t, cache, pos):
        """One decode step against a contiguous cache
        (``mha_apply_decode``): ``x_t [B, 1, E]`` at ``pos`` (a scalar, or
        ``[B]`` per-row positions).  Writes this step's K/V in place, then
        attends to ``[0, pos]``, with GQA's query groups folded into the
        query dim against the kv-sized cache (never repeated).  Returns
        ``y [B, 1, E]``."""
        b = x_t.shape[0]
        ring = self._ring(cache)
        q, k, v = self._decode_heads(x_t, pos)
        _cache_write(cache, k, v, pos, ring=ring)
        qg = q.reshape(b, self.num_kv_heads, self.kv_groups, self.head_dim)
        o = _decode_attention(qg, cache["k"], cache["v"], pos,
                              self.head_dim ** -0.5, self.window,
                              k_scale=cache.get("k_scale"),
                              v_scale=cache.get("v_scale"), ring=ring)
        return self._out_step(o, x_t)

    def chunk(self, x_c, cache, pos):
        """Chunked decode (``mha_apply_chunk``): ``x_c [B, C, E]`` at
        positions ``[pos, pos + C)`` (``pos`` a scalar, or ``[B]`` per-row
        starts), each query attending the cache through its own position.
        Writes cache entries ``[pos, pos + C)`` in place first; GQA folds
        each KV head's query group into the query dim (row ``g * C + c``
        at offset ``c``).  Returns ``y [B, C, E]``.  A ring cache raises,
        as JAX asserts."""
        if self._ring(cache):
            raise ValueError("chunked decode does not support ring "
                             "(windowed) caches")
        b, c, e = x_c.shape
        span = torch.arange(c, device=x_c.device)
        if _is_rows(pos):
            # a frozen row's chunk may run past the table; its results are
            # discarded, so any in-range angle will do
            roff = (pos.long()[:, None] + span).clamp(max=self.max_seq - 1)
        else:
            # a tensor start: apply_rope clamps it into the table, as
            # dynamic_slice does
            roff = torch.as_tensor(pos, device=x_c.device).long()
        q, k, v = self._qkv_heads(x_c, roff)
        _cache_write(cache, k, v, pos)
        g, d = self.kv_groups, self.head_dim
        qg = q.reshape(b, self.num_kv_heads, g * c, d)
        o = _decode_attention(qg, cache["k"], cache["v"], pos, d ** -0.5,
                              self.window, k_scale=cache.get("k_scale"),
                              v_scale=cache.get("v_scale"),
                              q_offsets=span.repeat(g))
        o2 = o.reshape(b, self.num_kv_heads, g, c, d).permute(
            0, 3, 1, 2, 4).reshape(b * c, e).to(x_c.dtype)
        return _proj(o2, self.wo, self.bo).reshape(b, c, e)

    def init_paged_pool(self, n_blocks: int, block_size: int,
                        dtype=torch.float32, device=None,
                        quantized: bool = False):
        """``mha_init_paged_pool``: zero K/V pools
        ``[n_blocks, kvh, block_size, D]``, or int8 pools with f32
        ``k_scale``/``v_scale`` ``[n_blocks, kvh, block_size]``.  Raises
        for a window model, as JAX asserts (``nn/transformer.py:637``)."""
        self._refuse_paged()
        shape = (n_blocks, self.num_kv_heads, block_size, self.head_dim)
        return _zero_cache(shape, dtype, quantized, device)

    def decode_paged(self, x_t, pool, tables, pos):
        """One decode step against a paged pool
        (``mha_apply_decode_paged``): ``x_t [B, 1, E]``, ``pool`` {"k",
        "v"} (+ "k_scale", "v_scale" for int8 pools), ``tables [B, mb]``
        int32, ``pos [B]`` int32 per-row positions.  Writes this step's
        K/V (quantized, with their scales, into int8 pools) in place, then
        attends to positions ``[0, pos]``.  Returns ``y [B, 1, E]``."""
        self._refuse_paged()
        b = x_t.shape[0]
        q, k, v = self._decode_heads(x_t, pos)
        scales = {}
        if "k_scale" in pool:            # int8 paged pools
            k, k_sc = kv_quantize(k)
            v, v_sc = kv_quantize(v)
            paged_write_scale(pool["k_scale"], k_sc[:, :, 0], tables, pos)
            paged_write_scale(pool["v_scale"], v_sc[:, :, 0], tables, pos)
            scales = dict(k_scales=pool["k_scale"],
                          v_scales=pool["v_scale"])
        paged_write(pool["k"], pool["v"], k, v, tables, pos)
        # GQA folds each KV head's query group into rows: query head
        # kvh_idx * G + g, the same [B, kvh, G, D] form as JAX; MHA is G=1
        qg = q.reshape(b, self.num_kv_heads, self.kv_groups, self.head_dim)
        o = paged_decode_attention(qg, pool["k"], pool["v"], tables,
                                   pos + 1, scale=self.head_dim ** -0.5,
                                   **scales)
        return self._out_step(o, x_t)

    def _refuse_paged(self):
        if self.window is not None:
            raise ValueError("paged caches are for full-attention models; "
                             "a window model uses the contiguous cache or "
                             "the O(W) ring cache")


def _zero_cache(shape, dtype, quantized, device):
    """Zero K/V of ``shape``; int8 with per-position f32 scales when
    ``quantized``."""
    if quantized:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:-1], device=device),
                "v_scale": torch.zeros(shape[:-1], device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


class MLPBlock(nn.Module):
    """Position-wise FFN: Linear -> tanh-GELU -> Linear (hidden =
    ratio * dim), or SwiGLU with ``gated=True``."""

    def __init__(self, dim: int, ratio: int = 4, bias: bool = True,
                 init_std: float = 0.02,
                 out_init_std: Optional[float] = None, gated: bool = False):
        super().__init__()
        not_ported("MLPBlock", bias=not bias)
        hidden = ratio * dim
        self.gated = gated
        self.init_std = init_std
        self.out_init_std = init_std if out_init_std is None \
            else out_init_std
        self.w1 = nn.Parameter(torch.empty(hidden, dim))
        self.w2 = nn.Parameter(torch.empty(dim, hidden))
        self.w3 = nn.Parameter(torch.empty(hidden, dim)) if gated else None
        self.b1 = nn.Parameter(torch.zeros(hidden))
        self.b2 = nn.Parameter(torch.zeros(dim))
        self.b3 = nn.Parameter(torch.zeros(hidden)) if gated else None
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.w1.normal_(0.0, self.init_std, generator=generator)
            self.w2.normal_(0.0, self.out_init_std, generator=generator)
            if self.w3 is not None:
                self.w3.normal_(0.0, self.init_std, generator=generator)
            for bias in (self.b1, self.b2, self.b3):
                if bias is not None:
                    bias.zero_()

    def forward(self, x):
        b, s, e = x.shape
        x2 = x.reshape(b * s, e)
        h = _proj(x2, self.w1, self.b1)
        if self.gated:
            h = F.silu(h) * _proj(x2, self.w3, self.b3)
        else:
            # jax.nn.gelu defaults to the tanh approximation
            h = F.gelu(h, approximate="tanh")
        return _proj(h, self.w2, self.b2).reshape(b, s, e)


class TransformerBlock(nn.Module):
    """Pre-LN block: ``x + MHA(LN(x))`` then ``x + FFN(LN(x))``, each
    branch's output dropped (``dropout > 0``, training only) before its
    add."""

    def __init__(self, dim: int, num_heads: int, causal: bool = True,
                 mlp_ratio: int = 4, dropout: float = 0.0,
                 init_std: float = 0.02,
                 out_init_std: Optional[float] = None, rope: bool = False,
                 max_seq: int = 4096, num_kv_heads: Optional[int] = None,
                 n_experts: int = 0, top_k: int = 2,
                 window: Optional[int] = None,
                 capacity_factor: Optional[float] = None,
                 norm: str = "layer", mlp_act: str = "gelu"):
        super().__init__()
        if norm not in ("layer", "rms") or mlp_act not in ("gelu", "swiglu"):
            raise ValueError(f"norm {norm!r} (layer|rms) or mlp_act "
                             f"{mlp_act!r} (gelu|swiglu) unknown")
        norm_cls = RMSNorm if norm == "rms" else LayerNorm
        self.ln1 = norm_cls(dim)
        self.attn = MultiHeadAttention(
            dim, num_heads, causal=causal, init_std=init_std,
            out_init_std=out_init_std, rope=rope, max_seq=max_seq,
            num_kv_heads=num_kv_heads, window=window)
        self.ln2 = norm_cls(dim)
        # n_experts > 0 swaps the FFN for a top-k gated MoE (JAX's experts
        # are plain GELU MLPBlocks whatever mlp_act says)
        if n_experts > 0:
            self.mlp = MoEMLP(dim, n_experts, ratio=mlp_ratio, top_k=top_k,
                              init_std=init_std, out_init_std=out_init_std,
                              capacity_factor=capacity_factor)
        else:
            self.mlp = MLPBlock(dim, ratio=mlp_ratio, init_std=init_std,
                                out_init_std=out_init_std,
                                gated=mlp_act == "swiglu")
        self.drop = Dropout(dropout) if dropout > 0 else None

    def _drop(self, y, train, generator):
        if self.drop is None:
            return y
        return self.drop(y, train=train, generator=generator)

    def forward(self, x, segment_ids=None, positions=None, train=False,
                generator=None):
        """``train`` with a ``generator`` applies the dropout (the block
        draws its attention mask, then its FFN mask, from it)."""
        a = self.attn(self.ln1(x), segment_ids, positions)
        x = x + self._drop(a, train, generator)
        return x + self._drop(self.mlp(self.ln2(x)), train, generator)

    def prefill(self, x, cache):
        """``block_apply_prefill``: fills ``cache`` at ``[0, P)`` in
        place; returns ``x``."""
        x = x + self.attn.prefill(self.ln1(x), cache)
        return x + self.mlp(self.ln2(x))

    def decode(self, x_t, cache, pos):
        """``block_apply_decode``: one token per row against a contiguous
        cache, updated in place."""
        x_t = x_t + self.attn.decode(self.ln1(x_t), cache, pos)
        return x_t + self.mlp(self.ln2(x_t))

    def chunk(self, x_c, cache, pos):
        """``block_apply_chunk``: C tokens per row at ``[pos, pos + C)``
        against a contiguous cache, updated in place."""
        x_c = x_c + self.attn.chunk(self.ln1(x_c), cache, pos)
        return x_c + self.mlp(self.ln2(x_c))

    def decode_paged(self, x_t, pool, tables, pos):
        """``block_apply_decode_paged``: one token per row; updates
        ``pool`` in place."""
        x_t = x_t + self.attn.decode_paged(self.ln1(x_t), pool, tables, pos)
        return x_t + self.mlp(self.ln2(x_t))


# ---------------------------------------------------------------------------
# Mixture of experts (taper_tpu/nn/transformer.py:891-1058)
# ---------------------------------------------------------------------------

class MoEExperts(nn.Module):
    """The experts' parameters, stacked along a leading expert axis as
    JAX's tree keeps them: ``w1 [n, hidden, dim]``, ``b1 [n, hidden]``,
    ``w2 [n, dim, hidden]``, ``b2 [n, dim]`` (each expert a GELU
    :class:`MLPBlock`)."""

    def __init__(self, n_experts: int, dim: int, hidden: int,
                 init_std: float, out_init_std: float):
        super().__init__()
        self.init_std = init_std
        self.out_init_std = out_init_std
        self.w1 = nn.Parameter(torch.empty(n_experts, hidden, dim))
        self.b1 = nn.Parameter(torch.zeros(n_experts, hidden))
        self.w2 = nn.Parameter(torch.empty(n_experts, dim, hidden))
        self.b2 = nn.Parameter(torch.zeros(n_experts, dim))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.w1.normal_(0.0, self.init_std, generator=generator)
            self.w2.normal_(0.0, self.out_init_std, generator=generator)
            self.b1.zero_()
            self.b2.zero_()

    def unbound(self, dtype):
        """Per expert ``(w1, b1, w2, b2)`` views at ``dtype``: one cast of
        each stack, and one gradient stack in the backward (``unbind``)."""
        parts = [t.to(dtype).unbind(0)
                 for t in (self.w1, self.b1, self.w2, self.b2)]
        return list(zip(*parts))


def _expert_apply(x2, w1, b1, w2, b2):
    """One GELU expert on rows ``x2 [R, dim]``: two K1 products, as
    JAX's ``MLPBlock.apply`` reaches ``ops.linear``."""
    h = F.gelu(_proj(x2, w1, b1), approximate="tanh")
    return _proj(h, w2, b2)


class MoEMLP(nn.Module):
    """Mixture-of-experts FFN: softmax top-k gating over ``n_experts``
    GELU experts.  Dense (``capacity_factor=None``, the oracle): every
    expert on every token, the non-top-k gates zero.  Sparse
    (``capacity_factor=f``): each expert takes a buffer of ``C =
    ceil(top_k T / n f)`` tokens by top-k assignment in token order; a
    slot past capacity drops that expert's contribution only.  With
    nothing dropped the two agree.

    The gate's product is a plain f32 ``torch.matmul`` (an einsum in
    JAX); every expert product is K1 through ``_proj`` on the stacked
    weights' views.  ``torch.topk`` does not promise JAX's lower-index
    choice on tied gate logits."""

    def __init__(self, dim: int, n_experts: int, ratio: int = 4,
                 top_k: int = 2, init_std: float = 0.02,
                 out_init_std: Optional[float] = None,
                 capacity_factor: Optional[float] = None):
        super().__init__()
        if not 1 <= top_k <= n_experts:
            raise ValueError(f"top_k {top_k} must be in [1, {n_experts}]")
        self.dim = dim
        self.n_experts = n_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.init_std = init_std
        self.gate = nn.Parameter(torch.empty(n_experts, dim))
        self.experts = MoEExperts(
            n_experts, dim, ratio * dim, init_std,
            init_std if out_init_std is None else out_init_std)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.gate.normal_(0.0, self.init_std, generator=generator)
        self.experts.reset_parameters(generator)

    def gates(self, x):
        """Top-k masked, renormalised softmax gates ``[..., n_experts]``
        (f32)."""
        logits = torch.matmul(x.float(), self.gate.t())
        if self.top_k < self.n_experts:
            idx = torch.topk(logits, self.top_k, dim=-1).indices
            keep = torch.zeros_like(logits, dtype=torch.bool).scatter_(
                -1, idx, True)
            logits = logits.masked_fill(~keep, float("-inf"))
        return torch.softmax(logits, dim=-1)

    def forward(self, x):
        if self.capacity_factor is not None:
            return self.forward_sparse(x)
        b, s, e = x.shape
        x2 = x.reshape(b * s, e)
        g = self.gates(x2)
        ye = torch.stack([_expert_apply(x2, *p)
                          for p in self.experts.unbound(x.dtype)])
        y = torch.einsum("nte,tn->te", ye.float(), g)
        return y.reshape(b, s, e).to(x.dtype)

    def forward_sparse(self, x):
        """Capacity-routed dispatch: routing by :func:`moe_sparse_routing`,
        the gather, experts and weighted sum by
        :func:`moe_sparse_dispatch`."""
        b, s, e = x.shape
        t = b * s
        n, k = self.n_experts, self.top_k
        cap = moe_capacity(t, n, k, self.capacity_factor)
        x2 = x.reshape(t, e)
        w, expert, pos, keep = moe_sparse_routing(self.gate, x2, n, k, cap)
        y2 = moe_sparse_dispatch(x2, expert, pos, keep, w, cap, n, 0,
                                 _expert_apply,
                                 self.experts.unbound(x.dtype))
        return y2.reshape(b, s, e).to(x.dtype)


def moe_capacity(t: int, n_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    """Per-expert buffer ``C = ceil(top_k T / n f)``, at most T."""
    return min(int(math.ceil(top_k * t / n_experts * capacity_factor)), t)


def moe_sparse_routing(gate_w, x2, n_experts: int, top_k: int, cap: int):
    """Global routing of capacity-based sparse dispatch, for ``x2 [T,
    E]``: ``(w [T, k], expert [T k], pos [T k], keep [T k])``, the
    renormalised top-k gate weights, each slot's expert, its position in
    that expert's buffer (an exclusive running count in token-major
    order) and whether it fits under ``cap``."""
    t = x2.shape[0]
    logits = torch.matmul(x2.float(), gate_w.t())
    top, idx = torch.topk(logits, top_k, dim=-1)        # [T, k]
    w = torch.softmax(top, dim=-1)
    expert = idx.reshape(t * top_k)
    onehot = F.one_hot(expert, n_experts)
    pos = ((torch.cumsum(onehot, 0) - onehot) * onehot).sum(1)
    return w, expert, pos, pos < cap


def moe_sparse_dispatch(x2, expert, pos, mine, w, cap: int, n_local: int,
                        lo: int, expert_apply, experts_params):
    """Gather dispatch for experts ``[lo, lo + n_local)``: this range's
    weighted contributions ``[T, E]`` (f32; other ranges' slots give 0).
    ``mine`` masks the slots this range takes (kept and owned);
    ``experts_params[i]`` are expert ``lo + i``'s arguments of
    ``expert_apply(rows, *params)``.  Each buffer row (e, c) gathers the
    token of the slot routed there, through the inverse permutation; a
    row no slot fills gathers a zero row.  Every slot not taken points
    at one trash row past the buffers, which takes the duplicate writes
    and is never read into a result."""
    t, e = x2.shape
    tk = expert.shape[0]
    k = tk // t
    rows = n_local * cap
    dst = torch.where(mine, (expert - lo) * cap + pos,
                      torch.full_like(pos, rows))
    slot = torch.arange(tk, device=x2.device)
    inv = torch.full((rows + 1,), tk, dtype=torch.int64, device=x2.device)
    inv[dst] = slot
    tok_idx = torch.where(inv < tk, inv // k, torch.full_like(inv, t))
    x2p = torch.cat([x2, x2.new_zeros(1, e)])
    xe = x2p[tok_idx[:rows]].reshape(n_local, cap, e)
    ye = torch.cat([torch.stack([expert_apply(xe[i], *experts_params[i])
                                 for i in range(n_local)]).reshape(rows, e),
                    x2.new_zeros(1, e)])
    wm = torch.where(mine, w.reshape(tk), torch.zeros_like(w.reshape(tk)))
    y_slot = ye[dst].float() * wm[:, None]
    return y_slot.reshape(t, k, e).sum(1)
