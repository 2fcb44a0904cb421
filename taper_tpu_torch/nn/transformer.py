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

Not ported yet: dropout, MoE, LoRA, bias-free projections and chunked
decode (``q_offsets``, per-row chunks); their arguments raise
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from taper_tpu_torch import ops
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
    weights are cast to ``x2``'s dtype (a no-op once cast ahead), the
    kernel returns f32, which is cast back so a bf16 trunk stays bf16.

    A quantized weight goes to ``ops.linear`` untouched
    (``taper_tpu/nn/transformer.py:121-134``) with f32 activations, or
    with the trunk's own where W8A8 engages: its row quantization reads
    them as they are, and a bf16 trunk keeps a bf16 product."""
    if isinstance(w, QuantizedTensor):
        xin = x2 if w8a8_engages(x2, w) else x2.float()
        return ops.linear(xin, w, b).to(x2.dtype)
    return ops.linear(x2, w.to(x2.dtype), b.to(x2.dtype)).to(x2.dtype)


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
    inv = torch.tensor(1.0 / 127.0, dtype=torch.float32, device=x.device)
    scale = torch.clamp(amax, min=1e-8) * inv
    q = torch.round(xf / scale[..., None])
    return q.to(torch.int8), scale


def _decode_attention(q, k_cache, v_cache, pos, scale, window=None,
                      k_scale=None, v_scale=None, q_offsets=None,
                      ring=False):
    """Single-position attention against a contiguous KV cache: ``q``
    ``[B, H, Q, D]``, caches ``[B, H, Smax, D]``; entries past ``pos`` (a
    scalar, or ``[B]`` per-row positions) are masked out.  Scores and the
    softmax are f32.  int8 caches (``k_scale``/``v_scale`` ``[B, H,
    Smax]``): the rows enter the dots in f32, the k scale multiplies the
    scores after the dot and the v scale the softmax weights before
    theirs.  f32/bf16 caches: the weights are cast to the cache dtype
    before ``P.V``, as JAX does.  ``window``: entries at or before ``pos -
    window`` are masked too.  ``ring``: the cache is a W-slot ring (W its
    length) whose slot ``s`` holds absolute position ``pos - ((pos - s)
    mod W)``; only slots never written (a negative position) are masked,
    the window holds by construction.  Plain PyTorch on every device: JAX
    runs this as XLA, with no Pallas kernel."""
    not_ported("_decode_attention", q_offsets=q_offsets is not None)
    s = torch.matmul(q.float(), k_cache.float().transpose(-1, -2)) * scale
    if k_scale is not None:
        s = s * k_scale[:, :, None, :]
    idx = torch.arange(k_cache.shape[2], device=q.device)
    qpos = pos.long()[:, None, None, None] if _is_rows(pos) else pos
    if ring:
        # torch.remainder is a floor modulo, as numpy's and JAX's %
        mask = qpos - torch.remainder(qpos - idx, k_cache.shape[2]) >= 0
    else:
        mask = idx <= qpos
        if window is not None:
            mask = mask & (idx > qpos - window)
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    if v_scale is not None:
        p = p * v_scale[:, :, None, :]
        return torch.matmul(p, v_cache.float())
    return torch.matmul(p.to(v_cache.dtype), v_cache)


def _cache_write(cache, k, v, pos, ring=False):
    """Write new K/V rows ``[B, kvh, C, D]`` into a contiguous cache, in
    place: at ``[pos, pos + C)`` for a scalar ``pos`` (prefill, lockstep
    decode), or row b's single row at ``pos[b]`` for ``[B]`` positions
    (ragged decode, C = 1).  Quantizes the rows when the cache holds
    scales.  A position past the cache is clamped, as XLA's
    ``dynamic_update_slice`` clamps it: a frozen serving row that keeps
    stepping past ``max_seq`` rewrites its last entry, whose tokens the
    engine discards.  One indexed write stands for JAX's three write
    strategies, which are XLA speed choices with one result.

    ``ring=True``: the cache is a W-slot ring (W its length); position
    ``p`` lands in slot ``p % W``, and of a C-row write longer than W only
    the last W rows are kept (only they would survive anyway)."""
    quantized = "k_scale" in cache
    new = {"k": k, "v": v}
    if quantized:
        new["k"], new["k_scale"] = kv_quantize(k)
        new["v"], new["v_scale"] = kv_quantize(v)
    smax, c = cache["k"].shape[2], k.shape[2]
    if ring and _is_rows(pos):
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
    if _is_rows(pos):
        not_ported("_cache_write", per_row_chunks=c != 1)
        rows = torch.arange(k.shape[0], device=k.device)
        at = pos.long().clamp(0, smax - 1)
        for name, x in new.items():
            cache[name][rows, :, at] = x[:, :, 0].to(cache[name].dtype)
        return cache
    # the clamped start of dynamic_update_slice, kept on the device
    start = torch.as_tensor(pos, device=k.device).long().clamp(0, smax - c)
    at = start + torch.arange(c, device=k.device)
    for name, x in new.items():
        cache[name].index_copy_(2, at, x.to(cache[name].dtype))
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
    """Pre-LN block: ``x + MHA(LN(x))`` then ``x + FFN(LN(x))``."""

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
        not_ported("TransformerBlock", dropout=dropout != 0.0,
                   n_experts=n_experts != 0, top_k=top_k != 2,
                   capacity_factor=capacity_factor is not None)
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
        self.mlp = MLPBlock(dim, ratio=mlp_ratio, init_std=init_std,
                            out_init_std=out_init_std,
                            gated=mlp_act == "swiglu")

    def forward(self, x, segment_ids=None, positions=None):
        x = x + self.attn(self.ln1(x), segment_ids, positions)
        return x + self.mlp(self.ln2(x))

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

    def decode_paged(self, x_t, pool, tables, pos):
        """``block_apply_decode_paged``: one token per row; updates
        ``pool`` in place."""
        x_t = x_t + self.attn.decode_paged(self.ln1(x_t), pool, tables, pos)
        return x_t + self.mlp(self.ln2(x_t))
