"""Paged KV-cache decode attention: port of
``taper_tpu/ops/pallas/paged_attention.py`` (``paged_decode_attention``
-> ``_pallas_paged`` -> ``_make_paged_kernel``, and the pool writes).

Layouts (per layer), as in the JAX package:
  * pools ``k/v: [n_blocks, kvh, block_size, D]``;
  * tables ``[B, max_blocks] int32``: slot b's logical block j lives in
    pool block ``tables[b, j]``;
  * lengths ``[B] int32``: valid positions per slot, each >= 1 (decode
    writes the current token before attending to it).

The pool writes are plain tensor indexing, as they are XLA scatters and
not kernels in the JAX package.  The port updates the pools IN PLACE where
the JAX engine donates the pool buffers to its jitted programs
(``taper_tpu/serve.py``, ``donate_argnums``).

CPU tensors run :func:`paged_decode_reference` (``_xla_paged``'s
gather-then-attend); CUDA tensors run the kernel of
``csrc/paged_decode.cu``, and raise where an input requires grad under
grad mode (decode has no backward; a detached result would be silent).  f32 and bf16 pools are ported; int8 pools with
per-position scales are not yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from taper_tpu_torch.ops import _build
from taper_tpu_torch.ops import backend

HEAD_DIMS = (64, 128)
GROUPS = (1, 2, 4, 8)


def paged_write(k_pool, v_pool, k, v, tables, pos):
    """Write one decode-step row per slot into the pools, in place.

    ``k``/``v``: ``[B, kvh, 1, D]``; ``pos``: ``[B]`` write positions;
    slot b's row lands in pool block ``tables[b, pos // bs]`` at offset
    ``pos % bs``.  Idle slots all point at the engine's trash block, so
    several slots may write the same trash position in one step; which
    write wins does not matter, since no live slot reads that block.  A
    frozen row past its table's reach writes its last table entry (its
    own block or the trash block), never another slot's."""
    bs = k_pool.shape[2]
    col = torch.clamp(pos.long() // bs, max=tables.shape[1] - 1)
    blk = torch.gather(tables, 1, col[:, None])[:, 0].long()
    off = pos.long() % bs
    k_pool[blk, :, off] = k[:, :, 0].to(k_pool.dtype)
    v_pool[blk, :, off] = v[:, :, 0].to(v_pool.dtype)


def paged_write_prefill(k_pool, v_pool, k, v, table_row):
    """Scatter ONE sequence's prefill rows into its blocks, in place.

    ``k``/``v``: ``[kvh, P, D]``; rows fill ``ceil(P / bs)`` blocks of
    ``table_row``.  The tail of the last block holds padding, masked by
    the lengths at read time and overwritten by later decode steps."""
    kvh, p, d = k.shape
    bs = k_pool.shape[2]
    nb = -(-p // bs)
    pad = nb * bs - p
    ids = table_row[:nb].long()
    for pool, x in ((k_pool, k), (v_pool, v)):
        x = F.pad(x, (0, 0, 0, pad))
        # [kvh, nb*bs, D] -> [nb, kvh, bs, D]
        pool[ids] = x.reshape(kvh, nb, bs, d).transpose(0, 1).to(pool.dtype)


def paged_decode_reference(q, k_pool, v_pool, tables, lengths, *, scale):
    """Plain PyTorch version (``_xla_paged``): gather each slot's blocks
    into a contiguous view, then masked attention in f32."""
    b, mb = tables.shape
    kvh, bs, d = k_pool.shape[1:]

    def gather(pool):                # [B, mb, kvh, bs, D] -> [B, kvh, L, D]
        g = pool[tables.long()].transpose(1, 2)
        return g.reshape(b, kvh, mb * bs, d).float()

    s = torch.einsum("bhgd,bhkd->bhgk", q.float(), gather(k_pool)) * scale
    cols = torch.arange(mb * bs, device=q.device)
    mask = cols[None, :] < lengths[:, None]
    s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bhkd->bhgd", p, gather(v_pool))
    return o.to(q.dtype)


def paged_decode_attention(q, k_pool, v_pool, tables, lengths, *, scale):
    """Decode attention against a paged KV cache.

    ``q``: ``[B, kvh, G, D]`` (G query heads per KV head; MHA is G=1);
    pools ``[n_blocks, kvh, bs, D]``; ``tables`` ``[B, mb]`` int32;
    ``lengths`` ``[B]`` int32, each >= 1.  Returns ``[B, kvh, G, D]`` in
    ``q``'s dtype."""
    if q.dim() != 4 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"paged attention: q {tuple(q.shape)}, pools "
                         f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}")
    b, kvh, g, d = q.shape
    if k_pool.shape[1] != kvh or k_pool.shape[3] != d:
        raise ValueError(f"paged attention: q {tuple(q.shape)} does not "
                         f"match pools {tuple(k_pool.shape)}")
    if tables.dim() != 2 or tables.shape[0] != b or \
            tuple(lengths.shape) != (b,):
        raise ValueError(f"paged attention: tables {tuple(tables.shape)} "
                         f"/ lengths {tuple(lengths.shape)} for B={b}")
    if not backend.on_cuda(q, k_pool, v_pool, tables, lengths):
        return paged_decode_reference(q, k_pool, v_pool, tables, lengths,
                                      scale=scale)
    if d not in HEAD_DIMS or g not in GROUPS:
        raise ValueError(f"paged attention: kernel takes head_dim in "
                         f"{HEAD_DIMS} and groups in {GROUPS}, got D={d}, "
                         f"G={g}")
    if not q.dtype == k_pool.dtype == v_pool.dtype:
        raise ValueError("paged attention: q and the pools must share one "
                         "dtype (int8 pools are not ported yet)")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("paged attention: tables and lengths must be int32")
    backend.refuse_grad("paged attention", q, k_pool, v_pool)
    backend.check_kernel_args("paged attention", q, k_pool, v_pool,
                              dtypes=_build.DTYPES)
    backend.check_kernel_args("paged attention", tables, lengths)
    o = torch.empty_like(q)
    code = _build.library().taper_paged_decode(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        tables.data_ptr(), lengths.data_ptr(), o.data_ptr(), b, kvh, g, d,
        k_pool.shape[2], tables.shape[1], float(scale),
        _build.DTYPES[q.dtype], _build.stream(q))
    _build.check(code, "paged decode attention")
    backend.count_launch("paged_decode")
    return o
