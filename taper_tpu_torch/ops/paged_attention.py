"""Paged KV-cache decode attention: port of
``taper_tpu/ops/pallas/paged_attention.py`` (``paged_decode_attention``
-> ``_pallas_paged`` -> ``_make_paged_kernel``, and the pool writes).

Layouts (per layer), as in the JAX package:
  * pools ``k/v: [n_blocks, kvh, block_size, D]``; int8 pools carry one
    f32 scale per stored position, ``k_scale/v_scale: [n_blocks, kvh,
    block_size]``;
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
``csrc/paged_decode.cu`` (f32 and bf16 pools: ``taper_paged_decode``,
counted as ``paged_decode``; int8 pools with their scales:
``taper_paged_decode_int8``, counted as ``paged_decode_int8``), and raise
where an input requires grad under grad mode (decode has no backward; a
detached result would be silent).  The kernel splits each row's
positions across blocks as :func:`plan` says (flash-decoding) and merges
the splits in a fixed order; :func:`paged_decode_reference_split` repeats
that chunking and merge in plain PyTorch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from taper_tpu_torch.ops import _build
from taper_tpu_torch.ops import backend
from taper_tpu_torch.ops.gemm import SMS

LOG2E = 1.4426950408889634

HEAD_DIMS = (64, 128)
GROUPS = (1, 2, 4, 8)
# K16's split (plan): at most SPLIT_WAVES blocks an SM over the call (two
# are resident at a time), each split at least MIN_SPLIT_BYTES of K and V
SPLIT_WAVES = 16
MIN_SPLIT_BYTES = 64 * 1024


def paged_write(k_pool, v_pool, k, v, tables, pos):
    """Write one decode-step row per slot into the pools, in place.

    ``k``/``v``: ``[B, kvh, 1, D]``; ``pos``: ``[B]`` write positions;
    slot b's row lands in pool block ``tables[b, pos // bs]`` at offset
    ``pos % bs``.  Idle slots all point at the engine's trash block, so
    several slots may write the same trash position in one step; which
    write wins does not matter, since no live slot reads that block.  A
    frozen row past its table's reach writes its last table entry (its
    own block or the trash block), never another slot's."""
    blk, off = _pos_block(tables, pos, k_pool.shape[2])
    k_pool[blk, :, off] = k[:, :, 0].to(k_pool.dtype)
    v_pool[blk, :, off] = v[:, :, 0].to(v_pool.dtype)


def _pos_block(tables, pos, bs):
    """Pool block and offset of each slot's write position; a frozen row
    past its table's reach writes its last table entry."""
    col = torch.clamp(pos.long() // bs, max=tables.shape[1] - 1)
    return torch.gather(tables, 1, col[:, None])[:, 0].long(), pos.long() % bs


def paged_write_scale(scale_pool, scale, tables, pos):
    """Write one per-position quantization scale per slot into a scale
    pool ``[n_blocks, kvh, bs]``, in place (int8 pools; the row itself
    goes through :func:`paged_write`).  ``scale``: ``[B, kvh]``."""
    blk, off = _pos_block(tables, pos, scale_pool.shape[2])
    scale_pool[blk, :, off] = scale.to(scale_pool.dtype)


def paged_write_prefill_scale(scale_pool, scale, table_row):
    """Prefill counterpart of :func:`paged_write_scale`: ``scale``
    ``[kvh, P]`` scattered block-wise into ``table_row``'s blocks, in
    place."""
    kvh, p = scale.shape
    bs = scale_pool.shape[2]
    nb = -(-p // bs)
    scale = F.pad(scale, (0, nb * bs - p))
    scale_pool[table_row[:nb].long()] = scale.reshape(kvh, nb, bs).transpose(
        0, 1).to(scale_pool.dtype)


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


def paged_decode_reference(q, k_pool, v_pool, tables, lengths, *, scale,
                           k_scales=None, v_scales=None):
    """Plain PyTorch version (``_xla_paged``): gather each slot's blocks
    into a contiguous view, then masked attention in f32.  int8 pools
    gather their rows in f32 times their per-position scales."""
    b, mb = tables.shape
    kvh, bs = k_pool.shape[1:3]

    def gather(pool):      # [B, mb, kvh, bs(, D)] -> [B, kvh, L(, D)]
        g = pool[tables.long()].transpose(1, 2)
        return g.reshape((b, kvh, mb * bs) + pool.shape[3:]).float()

    kg, vg = gather(k_pool), gather(v_pool)
    if k_scales is not None:
        kg = kg * gather(k_scales)[..., None]
        vg = vg * gather(v_scales)[..., None]
    s = torch.einsum("bhgd,bhkd->bhgk", q.float(), kg) * scale
    cols = torch.arange(mb * bs, device=q.device)
    mask = cols[None, :] < lengths[:, None]
    s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bhkd->bhgd", p, vg)
    return o.to(q.dtype)


def plan(b: int, kvh: int, g: int, d: int, bs: int, mb: int, dtype):
    """K16's split of each row's table over blocks, ``(splits, chunk)``:
    block (head, s) reads table entries ``[s chunk, (s + 1) chunk)`` of
    its row (``splits chunk >= mb``, no split empty).  A pure function of
    the shape, the pools' ``dtype`` and the SM count (the lengths live on
    the device; the kernel skips a split past its row's length): the most
    splits, a power of two, that keep the call within ``SPLIT_WAVES``
    blocks an SM and each split's pages at ``MIN_SPLIT_BYTES`` of K and V
    or more.  ``g`` does not move it: a position costs G dot products,
    few beside its bytes.  A table of one entry is never split."""
    if min(b, kvh, g, d, bs, mb) <= 0:
        raise ValueError(f"K16: empty shape B={b} kvh={kvh} G={g} D={d} "
                         f"bs={bs} mb={mb}")
    row = 2 * d * dtype.itemsize
    heads, splits = b * kvh, 1
    while (2 * splits <= mb and heads * 2 * splits <= SPLIT_WAVES * SMS
           and -(-mb // (2 * splits)) * bs * row >= MIN_SPLIT_BYTES):
        splits *= 2
    chunk = -(-mb // splits)
    return -(-mb // chunk), chunk


def paged_decode_reference_split(q, k_pool, v_pool, tables, lengths, *,
                                 scale, splits, chunk, k_scales=None,
                                 v_scales=None):
    """Plain version of K16's chunking and merge order: each split's
    positions ``[s chunk bs, (s + 1) chunk bs)`` of its row give a partial
    ``(m, l, acc)`` in base 2 (the k scale on the score after the dot, the
    v scale on the weight, l over unscaled weights), and the splits that
    reach into the row merge in split order.  Same function as
    :func:`paged_decode_reference`, other rounding."""
    b, mb = tables.shape
    kvh, bs = k_pool.shape[1:3]
    if splits * chunk < mb or (splits - 1) * chunk >= mb:
        raise ValueError(f"K16: {splits} splits of {chunk} do not cover "
                         f"{mb} table entries")

    def gather(pool):      # [B, mb, kvh, bs(, D)] -> [B, kvh, L(, D)]
        g = pool[tables.long()].transpose(1, 2)
        return g.reshape((b, kvh, mb * bs) + pool.shape[3:]).float()

    kg, vg = gather(k_pool), gather(v_pool)
    s = torch.einsum("bhgd,bhkd->bhgk", q.float() * (scale * LOG2E), kg)
    w_scale = None
    if k_scales is not None:
        s = s * gather(k_scales)[:, :, None, :]
        w_scale = gather(v_scales)[:, :, None, :]
    length = torch.clamp(lengths.long(), max=mb * bs)
    span = chunk * bs
    m_all, l_all, acc_all = [], [], []
    for i in range(splits):
        cols = torch.arange(i * span, min((i + 1) * span, mb * bs),
                            device=q.device)
        live = cols[None, :] < length[:, None]               # [B, span]
        ss = s[..., cols].masked_fill(~live[:, None, None, :],
                                      float("-inf"))
        m = ss.amax(-1, keepdim=True)                        # [B, kvh, G, 1]
        p = torch.exp2(ss - torch.where(torch.isfinite(m), m,
                                        torch.zeros_like(m)))
        pv = p if w_scale is None else p * w_scale[..., cols]
        m_all.append(m)
        l_all.append(p.sum(-1, keepdim=True))
        acc_all.append(torch.einsum("bhgk,bhkd->bhgd", pv, vg[:, :, cols]))
    # the splits that reach into each row, merged in split order
    n = torch.clamp(-(-length // span), min=1)               # [B]
    mx = torch.full_like(m_all[0], float("-inf"))
    for i in range(splits):
        on = (i < n)[:, None, None, None]
        mx = torch.where(on, torch.maximum(mx, m_all[i]), mx)
    num = torch.zeros_like(acc_all[0])
    den = torch.zeros_like(l_all[0])
    for i in range(splits):
        on = (i < n)[:, None, None, None]
        f = torch.where(on, torch.exp2(m_all[i] - mx),
                        torch.zeros_like(mx))
        num = num + acc_all[i] * f
        den = den + l_all[i] * f
    return (num / den).to(q.dtype)


def paged_decode_attention(q, k_pool, v_pool, tables, lengths, *, scale,
                           k_scales=None, v_scales=None):
    """Decode attention against a paged KV cache.

    ``q``: ``[B, kvh, G, D]`` (G query heads per KV head; MHA is G=1);
    pools ``[n_blocks, kvh, bs, D]``; ``tables`` ``[B, mb]`` int32;
    ``lengths`` ``[B]`` int32, each >= 1.  int8 pools pass ``k_scales``/
    ``v_scales`` ``[n_blocks, kvh, bs]`` f32, one symmetric scale per
    stored position.  Returns ``[B, kvh, G, D]`` in ``q``'s dtype."""
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
    quant = k_scales is not None or v_scales is not None
    if quant:
        for name, sc in (("k_scales", k_scales), ("v_scales", v_scales)):
            if sc is None or tuple(sc.shape) != tuple(k_pool.shape[:3]) \
                    or sc.dtype != torch.float32:
                raise ValueError(
                    f"paged attention: {name} must be f32 "
                    f"{tuple(k_pool.shape[:3])} beside int8 pools, got "
                    f"{None if sc is None else (sc.dtype, tuple(sc.shape))}")
    if quant != (k_pool.dtype == torch.int8) or \
            v_pool.dtype != k_pool.dtype:
        raise ValueError(f"paged attention: {k_pool.dtype}/{v_pool.dtype} "
                         f"pools {'with' if quant else 'without'} scales; "
                         f"int8 pools and scales go together")
    if not backend.on_cuda(q, k_pool, v_pool, tables, lengths, k_scales,
                           v_scales):
        return paged_decode_reference(q, k_pool, v_pool, tables, lengths,
                                      scale=scale, k_scales=k_scales,
                                      v_scales=v_scales)
    if d not in HEAD_DIMS or g not in GROUPS:
        raise ValueError(f"paged attention: kernel takes head_dim in "
                         f"{HEAD_DIMS} and groups in {GROUPS}, got D={d}, "
                         f"G={g}")
    if not quant and q.dtype != k_pool.dtype:
        raise ValueError("paged attention: q and f32/bf16 pools must share "
                         "one dtype")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("paged attention: tables and lengths must be int32")
    backend.refuse_grad("paged attention", q, k_pool, v_pool)
    backend.check_kernel_args("paged attention", q, dtypes=_build.DTYPES)
    backend.check_kernel_args("paged attention", k_pool, v_pool, tables,
                              lengths, k_scales, v_scales)
    bs, mb = k_pool.shape[2], tables.shape[1]
    splits, chunk = plan(b, kvh, g, d, bs, mb, k_pool.dtype)
    o = torch.empty_like(q)
    # the splits' partial (acc, m, l) where a row may have more than one
    ws = (torch.empty(b * kvh * splits * g * (d + 2), dtype=torch.float32,
                      device=q.device) if splits > 1 else None)
    lib = _build.library()
    common = (b, kvh, g, d, bs, mb, float(scale), _build.DTYPES[q.dtype],
              _build.stream(q), None if ws is None else ws.data_ptr(),
              splits, chunk)
    if quant:
        name = "paged_decode_int8"
        code = lib.taper_paged_decode_int8(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scales.data_ptr(), v_scales.data_ptr(), tables.data_ptr(),
            lengths.data_ptr(), o.data_ptr(), *common)
        _build.check(code, "paged decode attention (int8 pools)")
    else:
        name = "paged_decode"
        code = lib.taper_paged_decode(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            tables.data_ptr(), lengths.data_ptr(), o.data_ptr(), *common)
        _build.check(code, "paged decode attention")
    backend.count_launch(name)
    backend.count_route("split" if splits > 1 else "whole", name, 1)
    return o
