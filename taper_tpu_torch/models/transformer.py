"""Decoder-only transformer LM: port of
``taper_tpu/models/transformer.py``, the part that training and serving
(contiguous and paged KV caches, f32, bf16 and int8) run.

GPT-2 style: token embedding (+ learned positions unless ``rope``), pre-LN
blocks, final norm, tied or untied LM head.  ``compute_dtype`` runs the
trunk in that dtype; parameters, normalisation statistics, the softmax
and the logits stay f32.

``loss`` trains it, branching as the JAX package's ``TinyGPT.loss``: full
logits and the masked next-token loss while ``B * S * vocab <= 2^28``,
the vocab-chunked ``fused_linear_cross_entropy`` beyond.  ``hidden``,
``forward`` and ``loss`` take ``train`` and a ``generator`` (JAX's
``train=`` and ``rng=``): with ``dropout > 0`` each block draws its masks
from a seed of its own, drawn from the generator before the block runs.
``remat=True`` recomputes each block's forward in the backward
(``torch.utils.checkpoint``); the seeds fixed ahead make the recompute
draw the same masks.  ``n_experts > 0`` gives every block an MoE FFN.

``hidden``, ``forward`` and ``loss`` take ``segment_ids``/``positions``
``[B, S]`` for packed-sequence training (``data/packing.py``); a
``window`` model attends each token to the last W keys and may decode
from W-slot ring caches (``init_cache(ring=True)``).

The caches are filled and updated in place (``prefill``,
``decode_step``, ``prefill_paged``, ``decode_step_paged``), where the JAX
package returns new caches.  Paged caches refuse a window model, as JAX
asserts; the contiguous engine serves one through the full cache.

Generation (JAX ``models/transformer.py:415-1125``): ``generate`` (one-shot
or token-at-a-time prefill, ragged ``prompt_lens``, eos and padding,
int8 and ring caches, ``return_cache``), ``decode_chunk`` (C tokens per
row in one pass, at a scalar or per-row start), ``generate_continued``
(multi-turn over a filled cache), ``prefill_paged_continued`` (a chunk at
an offset over paged pools whose tables alias shared prefix blocks: the
engine's system prompt), ``beam_search`` and ``speculative_generate``.
JAX's ``lax.scan``/``while_loop`` decode loops are Python loops here whose
body (a decode step, a beam step, a speculative round) is captured once as
a CUDA graph and replayed (``utils/graphs.py``; on the CPU the same body
runs eagerly); each loop's program (the graph and the static buffers it
reads) is kept on the model, keyed by its static configuration, as
``jax.jit`` caches a compiled loop.  An eos early exit looks at the device once every
``EOS_BLOCK`` steps (one host sync), speculative decoding once a round.
The prefills, and the token-at-a-time oracle (``one_shot_prefill=False``),
stay eager.  Sampling draws from a caller's ``torch.Generator`` (``generator=``
where JAX takes ``key=``; a generator seeded 0 when none is given, as
JAX's default key is 0; a cached program draws from its own generator,
which takes the caller's state before the loop and gives it back after),
so sampled tokens differ from JAX's while
their distributions agree; greedy tokens agree up to numerics.
"""

from __future__ import annotations

import functools
import itertools
import math
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from taper_tpu_torch.data.seq import masked_token_loss
from taper_tpu_torch.losses import fused_linear_cross_entropy
from taper_tpu_torch.nn.layers import draw_seed
from taper_tpu_torch.nn.transformer import (
    Embedding, LayerNorm, RMSNorm, TransformerBlock)
from taper_tpu_torch.ops.paged_attention import (
    paged_write_prefill, paged_write_prefill_scale)
from taper_tpu_torch.quantization.qtensor import dense
from taper_tpu_torch.utils import graphs

# TinyGPT.loss takes the naive branch (full [B, S, vocab] logits) up to
# this many logits and the fused vocab-chunked loss beyond, as JAX does
# (models/transformer.py:290-292); the limit was measured on a TPU v5e
# and is kept as JAX's rule, not as a speed fact of the card
NAIVE_LOSS_MAX = 2 ** 28
FUSED_CHUNK = 4096              # the fused loss's vocab chunk by default
# the decode loops look at eos once every EOS_BLOCK steps (one host sync
# each); the tokens past a row's first eos are masked, so the steps run
# after every row has ended change no output
EOS_BLOCK = 8


def _filter_logits(logits, temperature, top_k=None, top_p=None):
    """Temperature-scaled, top-k/top-p-masked logits.  ``top_k`` keeps the
    k highest logits; ``top_p`` keeps the smallest set whose probability
    reaches p (the argmax always survives)."""
    logits = logits / temperature
    v = logits.shape[-1]
    if top_k is not None and top_k < v:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p is not None and top_p < 1.0:
        sl, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
        probs = torch.softmax(sl, dim=-1)
        keep = (torch.cumsum(probs, dim=-1) - probs) < top_p
        keep[..., 0] = True
        sl = sl.masked_fill(~keep, float("-inf"))
        logits = torch.empty_like(sl).scatter_(-1, idx, sl)
    return logits


def _sample(logits, generator=None, *, temperature=0.0, top_k=None,
            top_p=None):
    """Next-token sampling (greedy at ``temperature == 0``): ``[B, V]``
    logits -> ``[B]`` int64 tokens, drawn with ``generator``."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(_filter_logits(logits, temperature, top_k, top_p),
                          dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def _mask_after_eos(tokens, starts, eos, pad):
    """Replace every token strictly after each row's first ``eos`` in its
    generated region (positions >= ``starts``, a ``[B]`` tensor or a
    scalar) with ``pad``."""
    b, s = tokens.shape
    idx = torch.arange(s, device=tokens.device)[None, :]
    starts = torch.as_tensor(starts, device=tokens.device).long()
    starts = starts.reshape(-1, 1).expand(b, 1)
    hit = ((tokens == eos) & (idx >= starts)).long()
    after = (torch.cumsum(hit, dim=1) - hit) > 0
    return torch.where(after & (idx >= starts),
                       torch.full_like(tokens, pad), tokens)


def _residual_sample(generator, p_at, q_at):
    """A sample from ``norm(max(p - q, 0))`` per row, or from ``p`` where
    that residual is all zero (``p == q``: the draft is then accepted
    with probability 1, so the fallback is never biased).  JAX draws
    ``categorical(log(max(r, 1e-38)))``, which gives a zero entry a
    weight of ~1e-38 where ``multinomial`` gives it none."""
    r = torch.clamp(p_at - q_at, min=0.0)
    rsum = r.sum(-1, keepdim=True)
    r = torch.where(rsum > 0, r / torch.where(rsum > 0, rsum,
                                              torch.ones_like(rsum)), p_at)
    return torch.multinomial(r, 1, generator=generator)[:, 0]


def _spec_accept(generator, drafts, q, p):
    """One round of speculative sampling verification, rows in lockstep
    (JAX ``_spec_accept``): draft token x (drawn from ``q [B, γ, V]``) is
    accepted with probability ``min(1, p(x)/q(x))`` against the target's
    ``p [B, γ+1, V]``; every row advances by the batch's minimum
    acceptance count; a row that accepted further keeps its draft there,
    the others take a residual sample (a bonus sample from ``p[γ]`` when
    everything was accepted).  Returns ``(n_acc 0-d, nxt [B])``."""
    b, g, _ = q.shape
    qx = q.gather(2, drafts[..., None])[..., 0]                  # [B, γ]
    px = p[:, :g].gather(2, drafts[..., None])[..., 0]
    u = torch.rand((b, g), generator=generator, device=q.device)
    acc = u * qx < px           # u < p/q without the division (q > 0 a.s.)
    n_acc_row = torch.cumprod(acc.long(), dim=1).sum(1)          # [B]
    n_acc = n_acc_row.min()
    p_at = p.index_select(1, n_acc.reshape(1))[:, 0]             # [B, V]
    q_at = q.index_select(1, n_acc.clamp(max=g - 1).reshape(1))[:, 0]
    q_at = torch.where(n_acc >= g, torch.zeros_like(q_at), q_at)
    res = _residual_sample(generator, p_at, q_at)
    kept = drafts.index_select(1, n_acc.clamp(max=g - 1).reshape(1))[:, 0]
    return n_acc, torch.where(n_acc_row > n_acc, kept, res)


def _spec_accept_rows(generator, drafts, q, p):
    """Per-row speculative sampling verification (JAX
    ``_spec_accept_rows``): each row keeps its own accepted count and
    takes the residual sample at it (a bonus sample from ``p[γ]`` on full
    acceptance).  Returns ``(n_acc [B], nxt [B])``."""
    b, g, _ = q.shape
    qx = q.gather(2, drafts[..., None])[..., 0]
    px = p[:, :g].gather(2, drafts[..., None])[..., 0]
    u = torch.rand((b, g), generator=generator, device=q.device)
    n_acc = torch.cumprod((u * qx < px).long(), dim=1).sum(1)    # [B]
    p_at = p.gather(1, n_acc[:, None, None].expand(b, 1, p.shape[2]))[:, 0]
    q_at = q.gather(1, n_acc.clamp(max=g - 1)[:, None, None].expand(
        b, 1, q.shape[2]))[:, 0]
    q_at = torch.where((n_acc >= g)[:, None], torch.zeros_like(q_at), q_at)
    return n_acc, _residual_sample(generator, p_at, q_at)


class TinyGPT(nn.Module):
    """Causal LM over integer tokens ``[B, S] -> logits [B, S, vocab]``."""

    def __init__(self, vocab_size: int, dim: int = 128, depth: int = 2,
                 num_heads: int = 2, max_seq: int = 256,
                 mlp_ratio: int = 4, tied_head: bool = True,
                 dropout: float = 0.0, rope: bool = False,
                 num_kv_heads: Optional[int] = None,
                 n_experts: int = 0, top_k: int = 2,
                 capacity_factor: Optional[float] = None,
                 window: Optional[int] = None,
                 compute_dtype: Optional[torch.dtype] = None,
                 remat: bool = False,
                 norm: str = "layer", mlp_act: str = "gelu"):
        super().__init__()
        self.vocab_size = vocab_size
        self.dim = dim
        self.depth = depth
        self.max_seq = max_seq
        self.tied_head = tied_head
        self.rope = rope
        self.window = window
        self.compute_dtype = compute_dtype
        self.remat = remat
        out_std = 0.02 / math.sqrt(2 * depth)
        self.tok = Embedding(vocab_size, dim)
        self.pos = Embedding(max_seq, dim)
        self.blocks = nn.ModuleList(
            TransformerBlock(dim, num_heads, causal=True,
                             mlp_ratio=mlp_ratio, dropout=dropout,
                             out_init_std=out_std, rope=rope,
                             max_seq=max_seq, num_kv_heads=num_kv_heads,
                             n_experts=n_experts, top_k=top_k,
                             capacity_factor=capacity_factor, window=window,
                             norm=norm, mlp_act=mlp_act)
            for _ in range(depth))
        self.ln_f = (RMSNorm if norm == "rms" else LayerNorm)(dim)
        self.head = None if tied_head else \
            nn.Parameter(torch.empty(vocab_size, dim))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        """Random weights with the JAX package's init distributions, drawn
        from ``generator`` (a seeded ``torch.Generator`` makes them
        reproducible; they are not JAX's numbers)."""
        self.tok.reset_parameters(generator)
        self.pos.reset_parameters(generator)
        for blk in self.blocks:
            blk.attn.reset_parameters(generator)
            blk.mlp.reset_parameters(generator)
        if self.head is not None:
            with torch.no_grad():
                self.head.normal_(0.0, 0.02, generator=generator)

    def cast_projections(self, dtype):
        """Cast the attention and MLP weights and biases to ``dtype`` once,
        in place: the per-call cast in ``_proj`` then does nothing, with
        the same numbers.  Embeddings, norms and the head stay f32, and a
        quantized weight (not a parameter) stays as it is."""
        for blk in self.blocks:
            # an MoE FFN casts its experts; the gate stays f32
            for mod in (blk.attn, getattr(blk.mlp, "experts", blk.mlp)):
                for p in mod.parameters(recurse=False):
                    p.data = p.data.to(dtype)
        return self

    def _embed(self, tokens, positions):
        x = self.tok(tokens)
        if not self.rope:
            x = x + self.pos(positions)
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        return x

    def _embed_prompt(self, tokens, positions=None):
        """Embed ``tokens [B, S]`` at positions ``[0, S)``, or at
        ``positions [B, S]``."""
        s = tokens.shape[1]
        if s > self.max_seq:
            raise ValueError(f"sequence of {s} tokens exceeds max_seq "
                             f"{self.max_seq}")
        if positions is None:
            positions = torch.arange(s, device=tokens.device)
        return self._embed(tokens, positions)

    def _head_weights(self):
        """Tied or untied head ``[V, D]``; a PTQ'd head dequantizes
        (``taper_tpu/models/transformer.py:247-253``)."""
        return dense(self.tok.w if self.tied_head else self.head)

    def _logits(self, x):
        # the f32 logits product stays a plain matmul, as JAX's einsum
        return torch.matmul(x, self._head_weights().t())

    def hidden(self, tokens, segment_ids=None, positions=None,
               train: bool = False, generator=None):
        """Trunk forward: final-normed activations ``[B, S, D]`` (f32).
        ``segment_ids``/``positions`` ``[B, S]``: packed sequences,
        attention within each document and positions restarting per
        document (JAX ``models/transformer.py:212-240``).  ``train`` with
        a ``generator``: dropout, one seed a block drawn from the
        generator first (as JAX splits ``rng`` into one key a block), each
        block's masks then drawn on the activations' device from a
        generator of its seed alone, so a remat recompute draws them
        again."""
        x = self._embed_prompt(tokens, positions)
        seeds = ([draw_seed(generator) for _ in self.blocks]
                 if generator is not None else [None] * self.depth)
        for blk, seed in zip(self.blocks, seeds):
            run = functools.partial(self._block, blk, seed, train,
                                    segment_ids, positions)
            # the blocks draw nothing from the global RNG, so checkpoint
            # need not save and restore it
            x = (checkpoint(run, x, use_reentrant=False,
                            preserve_rng_state=False)
                 if self.remat else run(x))
        return self.ln_f(x).float()

    @staticmethod
    def _block(blk, seed, train, segment_ids, positions, x):
        gen = None if seed is None else \
            torch.Generator(device=x.device).manual_seed(seed)
        return blk(x, segment_ids, positions, train=train, generator=gen)

    def forward(self, tokens, segment_ids=None, positions=None,
                train: bool = False, generator=None):
        """Logits ``[B, S, vocab]`` (JAX's ``TinyGPT.apply``)."""
        return self._logits(self.hidden(tokens, segment_ids, positions,
                                        train, generator))

    def loss(self, tokens, targets, mask, z_loss: float = 0.0, chunk=None,
             segment_ids=None, positions=None, train: bool = False,
             generator=None):
        """Masked next-token loss and accuracy, ``(loss, acc)`` as 0-d
        tensors (JAX ``models/transformer.py:259-309``).  ``targets``
        ``[B, S]``, ``mask`` ``[S]`` or ``[B, S]``; ``z_loss`` adds
        ``z_loss * mean(logsumexp^2)`` over the masked positions;
        ``segment_ids``/``positions``, ``train`` and ``generator`` as
        :meth:`hidden` (the packer's loss mask already zeroes
        cross-document targets).

        The naive branch (full logits) runs where ``chunk == 0``, or
        ``chunk`` is None and ``B * S * vocab <= 2^28``; otherwise the
        fused vocab-chunked loss (``fused_linear_cross_entropy``, vocab
        chunks of ``chunk`` or FUSED_CHUNK rows), which never holds the
        ``[B * S, vocab]`` logits: its z-loss comes from the fused
        logsumexp and its accuracy from the fused argmax."""
        x = self.hidden(tokens, segment_ids, positions, train, generator)
        b, s, d = x.shape
        if chunk == 0 or (chunk is None and
                          b * s * self.vocab_size <= NAIVE_LOSS_MAX):
            return masked_token_loss(self._logits(x), targets, mask,
                                     z_loss=z_loss)
        nll, pred, lse = fused_linear_cross_entropy(
            x.reshape(b * s, d), self._head_weights(), targets.reshape(-1),
            chunk=chunk or FUSED_CHUNK, return_lse=True)
        nll, pred, lse = (t.reshape(b, s) for t in (nll, pred, lse))
        m = mask.to(nll.dtype).expand_as(nll)
        denom = m.sum().clamp_min(1.0)
        loss = (nll * m).sum() / denom
        if z_loss:
            loss = loss + z_loss * (lse * lse * m).sum() / denom
        acc = ((pred == targets).to(m.dtype) * m).sum() / denom
        return loss, acc

    def _device(self, device):
        return self.tok.w.device if device is None else device

    def _caches(self, batch, length, dtype, quantized, device, ring=False):
        dt = dtype or self.compute_dtype or torch.float32
        return [blk.attn.init_cache(batch, length, dt, quantized,
                                    self._device(device), ring)
                for blk in self.blocks]

    def init_cache(self, batch: int, dtype=None, quantized: bool = False,
                   device=None, ring: bool = False):
        """Per-layer contiguous caches ``{"k", "v": [batch, kvh, max_seq,
        D]}`` (+ per-position ``"k_scale"``/``"v_scale"`` when
        ``quantized``: int8 rows, ``dtype`` ignored) on ``device`` (the
        model's by default).  ``ring``: W-slot ring buffers for a window
        model (raises for any other), which ``prefill`` and
        ``decode_step`` read and write as rings: cache memory and decode
        reads drop from O(max_seq) to O(W) per layer."""
        return self._caches(batch, self.max_seq, dtype, quantized, device,
                            ring)

    def prefill(self, prompt, caches):
        """Process the whole prompt ``[B, P]`` in one forward (flash
        attention) and fill cache positions ``[0, P)`` of every layer, in
        place.  Returns logits ``[B, P, vocab]``."""
        x = self._embed_prompt(prompt)
        for blk, cache in zip(self.blocks, caches):
            x = blk.prefill(x, cache)
        return self._logits(self.ln_f(x).float())

    def _embed_step(self, tok_t, pos):
        """``tok_t [B]`` at ``pos`` (a scalar or ``[B]``) -> ``[B, 1, E]``.
        A frozen serving row may step past ``max_seq``; its tokens are
        discarded, so any in-range position will do."""
        if torch.is_tensor(pos) and pos.dim() == 1:
            positions = pos[:, None].long()
        else:
            positions = torch.as_tensor(pos, device=tok_t.device).reshape(1)
        return self._embed(tok_t[:, None],
                           positions.long().clamp(max=self.max_seq - 1))

    def decode_step(self, tok_t, pos, caches):
        """One token per sequence against the contiguous caches: ``tok_t``
        ``[B]`` at ``pos`` (a scalar, or ``[B]`` per-row positions for
        ragged serving).  Writes each layer's K/V at ``pos`` in place;
        returns logits ``[B, vocab]``."""
        x = self._embed_step(tok_t, pos)
        for blk, cache in zip(self.blocks, caches):
            x = blk.decode(x, cache, pos)
        return self._logits(self.ln_f(x).float())[:, 0]

    def init_paged_cache(self, n_blocks: int, block_size: int = 128,
                         dtype=None, device=None, quantized: bool = False):
        """Per-layer paged pools ``{"k", "v": [n_blocks, kvh, bs, D]}``
        (+ per-position ``"k_scale"``/``"v_scale"`` ``[n_blocks, kvh,
        bs]`` when ``quantized``: int8 pools) on ``device`` (the model's
        by default); block tables live outside (the serving engine owns
        them)."""
        dt = dtype or self.compute_dtype or torch.float32
        return [blk.attn.init_paged_pool(n_blocks, block_size, dt,
                                         self._device(device), quantized)
                for blk in self.blocks]

    def prefill_paged(self, prompt, pools, tables):
        """Prefill ``prompt [B, P]`` into prompt-length caches, then
        scatter each row's K/V (and, for int8 pools, their scales) into
        its table's blocks (``ceil(P / bs)`` per row), in place.  The
        prefill attention runs on the full-precision K/V; only the stored
        rows are int8.  Returns logits ``[B, P, vocab]``.  Raises for a
        window model."""
        self.blocks[0].attn._refuse_paged()
        b, p = prompt.shape
        quantized = "k_scale" in pools[0]
        tmp = self._caches(b, p, None, quantized, prompt.device)
        logits = self.prefill(prompt, tmp)
        for pool, c in zip(pools, tmp):
            for i in range(b):                 # engine admissions: 1 row
                paged_write_prefill(pool["k"], pool["v"], c["k"][i],
                                    c["v"][i], tables[i])
                if quantized:
                    for name in ("k_scale", "v_scale"):
                        paged_write_prefill_scale(pool[name], c[name][i],
                                                  tables[i])
        return logits

    def decode_step_paged(self, tok_t, pos, pools, tables):
        """One token per slot against the paged cache: ``tok_t [B]``,
        ``pos [B]`` int32 positions, ``tables [B, mb]`` int32.  Writes
        each layer's K/V at ``pos`` in place; returns logits
        ``[B, vocab]``."""
        x = self._embed_step(tok_t, pos)
        for blk, pool in zip(self.blocks, pools):
            x = blk.decode_paged(x, pool, tables, pos)
        return self._logits(self.ln_f(x).float())[:, 0]

    def prefill_paged_continued(self, toks, pools, tables, past_len: int):
        """Chunk-prefill ``toks [B, C]`` at offset ``past_len`` against
        paged pools whose ``tables [B, mb]`` already hold the first
        ``past_len`` positions: a shared system prompt, whose blocks many
        tables may alias (its K/V stored once).  The new rows land in each
        row's own blocks, in place; the caller owns the blocks from
        ``past_len // bs`` on (with ``past_len % bs == 0`` the shared
        blocks are never written; the engine makes sure of it).  Returns
        logits ``[B, C, vocab]``.

        As in JAX: each table's blocks are gathered into a transient
        contiguous cache as long as the model's ``max_seq`` (one
        admission-sized buffer), :meth:`decode_chunk` runs over it, and
        the blocks it touched are scattered back."""
        self.blocks[0].attn._refuse_paged()
        toks = self._tokens(toks)
        tables = torch.as_tensor(tables, device=toks.device)
        b, c = toks.shape
        past_len = int(past_len)
        bs = pools[0]["k"].shape[2]
        quantized = "k_scale" in pools[0]
        nb_used = -(-(past_len + c) // bs)
        j0 = past_len // bs
        ids = tables[:, :nb_used].long()

        def gathered(arr):           # pool -> [B, kvh, max(L, max_seq)(, D)]
            g = arr[ids].movedim(2, 1)         # [B, kvh, nb, bs(, D)]
            flat = g.reshape((b, arr.shape[1], nb_used * bs)
                             + tuple(arr.shape[3:]))
            out = arr.new_zeros((b, arr.shape[1],
                                 max(nb_used * bs, self.max_seq))
                                + tuple(arr.shape[3:]))
            out[:, :, :nb_used * bs] = flat
            return out

        tmp = [{name: gathered(x) for name, x in pool.items()}
               for pool in pools]
        # a 0-d device start: an int would cost a blocking copy a layer
        logits = self.decode_chunk(toks, torch.full(
            (), past_len, dtype=torch.long, device=toks.device), tmp)
        lo, hi = j0 * bs, nb_used * bs
        for pool, cch in zip(pools, tmp):
            for i in range(b):                 # engine admissions: 1 row
                row = tables[i, j0:nb_used]
                paged_write_prefill(pool["k"], pool["v"],
                                    cch["k"][i, :, lo:hi],
                                    cch["v"][i, :, lo:hi], row)
                if quantized:
                    for name in ("k_scale", "v_scale"):
                        paged_write_prefill_scale(
                            pool[name], cch[name][i, :, lo:hi], row)
        return logits

    def decode_chunk(self, toks, pos, caches):
        """Multi-token cache-backed step: ``toks [B, C]`` at positions
        ``[pos, pos + C)`` (``pos`` a scalar, or ``[B]`` per-row starts:
        per-row speculative verification) against the contiguous caches,
        which take the chunk's K/V in place.  Returns logits ``[B, C,
        vocab]``: the verifier of speculative decoding and the turn
        prefill of multi-turn generation, one pass where C decode steps
        would be C."""
        toks = self._tokens(toks)
        span = torch.arange(toks.shape[1], device=toks.device)
        if torch.is_tensor(pos) and pos.dim() == 1:
            positions = pos.long()[:, None] + span
        else:
            positions = span + (pos.long() if torch.is_tensor(pos)
                                else int(pos))
        x = self._embed(toks, positions if self.rope else
                        positions.clamp(max=self.max_seq - 1))
        for blk, cache in zip(self.blocks, caches):
            x = blk.chunk(x, cache, pos)
        return self._logits(self.ln_f(x).float())

    # -- generation ---------------------------------------------------------

    def _tokens(self, x):
        """Token ids as int64 on the model's device."""
        return torch.as_tensor(x, device=self._device(None)).long()

    def _positions(self, n: int):
        """Positions ``[0, n)`` on the model's device: the token-at-a-time
        loop passes ``at[pos]``, a 0-d device tensor, where a Python int
        would cost a blocking host-to-device copy in every layer's cache
        write (the rows and the RoPE table take either)."""
        return torch.arange(n, device=self._device(None))

    def _generator(self, generator):
        """The caller's generator, or one seeded 0 on the model's device
        (JAX's default key is ``PRNGKey(0)``)."""
        if generator is not None:
            return generator
        return torch.Generator(device=self._device(None)).manual_seed(0)

    def _fits(self, total: int, seq=None):
        limit = self.max_seq if seq is None else seq
        if total > limit:
            raise ValueError(f"{total} positions exceed max_seq {limit}")

    def state_key(self) -> tuple:
        """Where and how the weights lie: a captured decode graph reads
        them at these addresses, so a decode program is keyed by them (a
        cast, a move or a PTQ pass makes new storages and so a new
        program)."""
        return (self.compute_dtype,) + tuple(
            (t.data_ptr(), t.dtype, tuple(t.shape))
            for t in itertools.chain(self.parameters(), self.buffers()))

    def _program(self, kind, key, build, keep=True):
        """The decode program of ``kind`` for this model's weights and the
        static configuration ``key`` (``utils.graphs.program``: kept on
        the model, so it goes with it)."""
        return graphs.program(self, (kind, self.state_key()) + tuple(key),
                              build, keep)

    @staticmethod
    def _run(step, n: int, done) -> None:
        """``n`` decode steps, ending early once every row has emitted
        eos: ``done`` (a ``[B]`` bool buffer, or None: no eos) is read
        before the first step and then once every ``EOS_BLOCK`` steps (one
        host sync each)."""
        for i in range(n):
            if done is not None and i % EOS_BLOCK == 0 and bool(done.all()):
                return
            step()

    def _sampler(self, temperature, top_k, top_p):
        """``(generator, sample)``: a program's own generator (it takes a
        caller's state before each loop, ``graphs.draw_from``) and
        :func:`_sample` bound to it and the filter."""
        gen = torch.Generator(device=self._device(None))
        return gen, functools.partial(_sample, generator=gen,
                                      temperature=temperature, top_k=top_k,
                                      top_p=top_p)

    @torch.no_grad()
    def generate(self, prompt, max_new: int, temperature: float = 0.0,
                 generator=None, one_shot_prefill: bool = True,
                 prompt_lens=None, top_k=None, top_p=None,
                 quantized_cache: bool = False, eos_token=None,
                 pad_token=None, return_cache: bool = False,
                 ring_cache: bool = False):
        """Autoregressive generation over a contiguous KV cache (JAX
        ``TinyGPT.generate``): ``prompt [B, P]`` -> tokens ``[B, P +
        max_new]`` (int64, on the model's device); greedy at ``temperature
        == 0``, else drawn from ``generator`` through ``top_k``/``top_p``.

        :meth:`prefill` fills the P cache entries in one pass, then the
        ``max_new - 1`` decode steps replay one captured step
        (``utils.graphs``; eager on the CPU); ``one_shot_prefill=False``
        feeds the prompt token by token through an eager loop of
        :meth:`decode_step` (the equality oracle).  ``prompt_lens [B]``: a
        ragged batch, each row right-padded to P, its tokens at ``[L_r,
        L_r + max_new)`` (one-shot only).  ``eos_token``: the loop stops
        once every row has emitted it (looked at every ``EOS_BLOCK``
        steps), and every token after a row's first eos becomes
        ``pad_token`` (default: the eos token).  ``return_cache=True``:
        ``(tokens, caches)``, the cache filled through ``P + max_new - 1``
        for :meth:`generate_continued` (``max_new=0``: the prefill-only
        call); it refuses ``eos_token`` and ragged prompts.
        ``quantized_cache``: int8 K/V; ``ring_cache``: W-slot rings for a
        window model.  JAX's assertions raise ``ValueError`` here."""
        prompt = self._tokens(prompt)
        b, plen = prompt.shape
        if return_cache and eos_token is not None:
            raise ValueError(
                "return_cache with eos_token is not supported: early exit "
                "leaves the cache partially filled (and post-eos rows "
                "disagree with the pad-masked tokens); bound the turn with "
                "max_new instead")
        if max_new <= 0:
            if return_cache:
                caches = self.init_cache(b, quantized=quantized_cache,
                                         ring=ring_cache)
                self.prefill(prompt, caches)
                return prompt, caches
            return prompt
        if prompt_lens is not None:
            if not one_shot_prefill:
                raise ValueError(
                    "ragged generation (prompt_lens=...) always uses "
                    "one-shot prefill; for a sequential oracle run each row "
                    "separately with one_shot_prefill=False")
            if return_cache:
                raise ValueError("return_cache with ragged prompts is not "
                                 "supported (per-row cache lengths)")
            if ring_cache:
                raise ValueError(
                    "ring_cache with ragged prompts is not supported: the "
                    "shared padded prefill writes pad rows into ring slots "
                    "a shorter row's mask cannot exclude")
            return self._generate_ragged(prompt, max_new, temperature,
                                         generator, prompt_lens, top_k,
                                         top_p, quantized_cache, eos_token,
                                         pad_token)
        total = plen + max_new
        self._fits(total)
        if not one_shot_prefill:
            return self._generate_sequential(
                prompt, max_new, generator, quantized_cache, eos_token,
                pad_token, return_cache, ring_cache,
                dict(temperature=temperature, top_k=top_k, top_p=top_p))
        dev = prompt.device

        def build():
            tokens = prompt.new_zeros(b, total)
            caches = self.init_cache(b, quantized=quantized_cache,
                                     ring=ring_cache)
            pos = torch.zeros((), dtype=torch.long, device=dev)
            done = (None if eos_token is None else
                    torch.zeros(b, dtype=torch.bool, device=dev))
            gen, sample = self._sampler(temperature, top_k, top_p)

            def step():
                # decode the token at pos, write the one after it
                tok = tokens.index_select(1, pos.reshape(1))[:, 0]
                nxt = sample(self.decode_step(tok, pos, caches))
                tokens.index_copy_(1, (pos + 1).reshape(1), nxt[:, None])
                if done is not None:
                    done.logical_or_(nxt == eos_token)
                pos.add_(1)

            return graphs.Program(
                tokens=tokens, caches=caches, pos=pos, done=done, gen=gen,
                sample=sample, step=graphs.Step(
                    step, dev, [gen] if temperature > 0 else []))

        # a returned cache is the caller's: that program is not kept
        prog = self._program(
            "generate", (b, plen, max_new, float(temperature), top_k, top_p,
                         quantized_cache, ring_cache, eos_token, dev), build,
            keep=not return_cache)
        graphs.draw_from(prog.gen, generator)
        prog.tokens[:, :plen] = prompt
        prog.tokens[:, plen:] = 0
        nxt = prog.sample(self.prefill(prompt, prog.caches)[:, -1])
        prog.tokens[:, plen] = nxt
        if prog.done is not None:
            prog.done.copy_(nxt == eos_token)
        prog.pos.fill_(plen)               # decode consumes positions P..
        self._run(prog.step, max_new - 1, prog.done)
        graphs.give_back(prog.gen, generator)
        if return_cache:                   # eos refused above
            return prog.tokens, prog.caches
        if eos_token is not None:
            return _mask_after_eos(prog.tokens, plen, eos_token,
                                   eos_token if pad_token is None
                                   else pad_token)
        return prog.tokens.clone()

    def _generate_sequential(self, prompt, max_new, generator,
                             quantized_cache, eos_token, pad_token,
                             return_cache, ring_cache, sampling):
        """Token-at-a-time generation (``one_shot_prefill=False``): the
        prompt and the new tokens go through one eager loop of
        :meth:`decode_step`, eos looked at every step.  The equality
        oracle of the one-shot path; never captured."""
        b, plen = prompt.shape
        total = plen + max_new
        sample = functools.partial(_sample, generator=self._generator(
            generator), **sampling)
        tokens = torch.cat([prompt, prompt.new_zeros(b, max_new)], dim=1)
        caches = self.init_cache(b, quantized=quantized_cache,
                                 ring=ring_cache)
        done = (None if eos_token is None else
                torch.zeros(b, dtype=torch.bool, device=prompt.device))
        at = self._positions(total)
        for pos in range(total - 1):
            if pos >= plen and done is not None and bool(done.all()):
                break
            logits = self.decode_step(tokens[:, pos], at[pos], caches)
            if pos + 1 < plen:             # prompt positions keep theirs
                continue
            nxt = sample(logits)
            tokens[:, pos + 1] = nxt
            if done is not None:
                done |= nxt == eos_token
        if eos_token is not None:          # return_cache refused
            return _mask_after_eos(tokens, plen, eos_token,
                                   eos_token if pad_token is None
                                   else pad_token)
        return (tokens, caches) if return_cache else tokens

    def _generate_ragged(self, prompt, max_new, temperature, generator,
                         prompt_lens, top_k, top_p, quantized_cache,
                         eos_token, pad_token):
        """Ragged-batch generation (see :meth:`generate`): one shared
        prefill, then per-row positions through the captured step."""
        b, plen = prompt.shape
        self._fits(plen + max_new)
        lens_host = np.asarray(prompt_lens.cpu() if torch.is_tensor(
            prompt_lens) else prompt_lens)
        if lens_host.min() < 1 or lens_host.max() > plen:
            raise ValueError(f"prompt_lens must be in [1, {plen}], got "
                             f"[{lens_host.min()}, {lens_host.max()}]")
        dev = prompt.device
        lens = torch.as_tensor(lens_host, device=dev).long()
        rows = torch.arange(b, device=dev)

        def build():
            tokens = prompt.new_zeros(b, plen + max_new)
            caches = self.init_cache(b, quantized=quantized_cache)
            pos = torch.zeros(b, dtype=torch.long, device=dev)
            done = (None if eos_token is None else
                    torch.zeros(b, dtype=torch.bool, device=dev))
            gen, sample = self._sampler(temperature, top_k, top_p)

            def step():
                nxt = sample(self.decode_step(tokens[rows, pos], pos,
                                              caches))
                tokens[rows, pos + 1] = nxt
                if done is not None:
                    done.logical_or_(nxt == eos_token)
                pos.add_(1)

            return graphs.Program(
                tokens=tokens, caches=caches, pos=pos, done=done, gen=gen,
                sample=sample, step=graphs.Step(
                    step, dev, [gen] if temperature > 0 else []))

        prog = self._program(
            "ragged", (b, plen, max_new, float(temperature), top_k, top_p,
                       quantized_cache, eos_token, dev), build)
        graphs.draw_from(prog.gen, generator)
        prog.tokens[:, :plen] = prompt
        prog.tokens[:, plen:] = 0
        logits = self.prefill(prompt, prog.caches)
        nxt = prog.sample(logits[rows, lens - 1])
        prog.tokens[rows, lens] = nxt
        if prog.done is not None:
            prog.done.copy_(nxt == eos_token)
        prog.pos.copy_(lens)
        self._run(prog.step, max_new - 1, prog.done)
        graphs.give_back(prog.gen, generator)
        if eos_token is None:
            return prog.tokens.clone()
        return _mask_after_eos(prog.tokens, lens, eos_token,
                               eos_token if pad_token is None else pad_token)

    @torch.no_grad()
    def generate_continued(self, prompt, max_new: int, caches,
                           past_len: int, temperature: float = 0.0,
                           generator=None, top_k=None, top_p=None,
                           eos_token=None, pad_token=None,
                           return_cache: bool = False):
        """Continue generation from a filled KV cache (multi-turn serving,
        JAX ``generate_continued``): ``caches`` hold positions ``[0,
        past_len)``; ``prompt [B, C]`` are the new tokens (chaining from
        :meth:`generate`, prepend its last sampled token, whose K/V was
        never written).  The chunk is prefilled by one
        :meth:`decode_chunk` at offset ``past_len``, then ``max_new``
        tokens decode as in :meth:`generate`, through a step captured over
        the caller's caches for this call.  Returns the new segment ``[B,
        C + max_new]`` (``return_cache=True``: with the caches, filled
        through ``past_len + C + max_new - 1``; refused with
        ``eos_token``)."""
        if return_cache and eos_token is not None:
            raise ValueError("return_cache with eos_token is not "
                             "supported: early exit leaves the cache "
                             "partially filled")
        prompt = self._tokens(prompt)
        b, clen = prompt.shape
        past_len = int(past_len)
        if clen < 1 or max_new < 1:
            raise ValueError(f"need a chunk of at least 1 token ({clen}) "
                             f"and max_new >= 1 ({max_new})")
        self._fits(past_len + clen + max_new)
        dev = prompt.device
        tokens = torch.cat([prompt, prompt.new_zeros(b, max_new)], dim=1)
        j = torch.full((), clen, dtype=torch.long, device=dev)
        done = (None if eos_token is None else
                torch.zeros(b, dtype=torch.bool, device=dev))
        gen = self._generator(generator)
        sample = functools.partial(_sample, generator=gen,
                                   temperature=temperature, top_k=top_k,
                                   top_p=top_p)

        def step():
            # decode tokens[:, j] at position past_len + j
            tok = tokens.index_select(1, j.reshape(1))[:, 0]
            nxt = sample(self.decode_step(tok, j + past_len, caches))
            tokens.index_copy_(1, (j + 1).reshape(1), nxt[:, None])
            if done is not None:
                done.logical_or_(nxt == eos_token)
            j.add_(1)

        # the caches are the caller's: the step is captured for this call
        captured = graphs.Step(step, dev, [gen] if temperature > 0 else [])
        start = torch.full((), past_len, dtype=torch.long, device=dev)
        nxt = sample(self.decode_chunk(prompt, start, caches)[:, -1])
        tokens[:, clen] = nxt
        if done is not None:
            done.copy_(nxt == eos_token)
        self._run(captured, max_new - 1, done)
        if eos_token is not None:
            tokens = _mask_after_eos(tokens, clen, eos_token,
                                     eos_token if pad_token is None
                                     else pad_token)
        return (tokens, caches) if return_cache else tokens

    @torch.no_grad()
    def beam_search(self, prompt, max_new: int, beams: int = 4,
                    eos_token=None, pad_token=None,
                    length_penalty: float = 1.0,
                    quantized_cache: bool = False, return_all=False):
        """Beam search over a KV cache (JAX ``beam_search``): ``beams``
        hypotheses per prompt decode together as a ``[B * W]`` batch; each
        step keeps the top W of the W * V joint candidates (score + log
        p) and reorders the cache rows by each survivor's parent beam, in
        place (an ``index_select`` along the batch copied back).  A beam
        that emits ``eos_token`` freezes: its one candidate is itself,
        extended by pad at an unchanged score.  The final ranking divides
        each score by ``len(generated) ** length_penalty``.  The steps
        replay one captured step (``utils.graphs``; eager on the CPU).
        Returns the best sequence per prompt ``[B, P + max_new]``
        (``return_all=True``: ``(tokens [B, W, P + max_new], scores [B,
        W])``, best first)."""
        prompt = self._tokens(prompt)
        b, plen = prompt.shape
        total = plen + max_new
        w, v = beams, self.vocab_size
        self._fits(total)
        if not 1 <= w <= v or max_new < 1:
            raise ValueError(f"need 1 <= beams ({w}) <= vocab ({v}) and "
                             f"max_new >= 1 ({max_new})")
        pad = eos_token if pad_token is None else pad_token
        dev = prompt.device

        def build():
            caches1 = self.init_cache(b, quantized=quantized_cache)
            caches = self.init_cache(b * w, quantized=quantized_cache)
            tokens = prompt.new_zeros(b, w, total)
            scores = torch.zeros(b, w, device=dev)
            finished = torch.zeros(b, w, dtype=torch.bool, device=dev)
            pos = torch.zeros((), dtype=torch.long, device=dev)
            frozen = None
            if eos_token is not None:
                frozen = torch.full((v,), float("-inf"), device=dev)
                frozen[pad] = 0.0
            base = (torch.arange(b, device=dev) * w)[:, None]

            def step():
                tok = tokens.index_select(2, pos.reshape(1))
                logits = self.decode_step(tok.reshape(b * w), pos, caches)
                logp = torch.log_softmax(logits.float(), -1).reshape(b, w, v)
                if frozen is not None:
                    logp = torch.where(finished[..., None], frozen, logp)
                cand = (scores[..., None] + logp).reshape(b, w * v)
                best, idx = torch.topk(cand, w, dim=-1)          # [B, W]
                parent, tok = idx // v, idx % v
                tokens.copy_(tokens.gather(
                    1, parent[..., None].expand(b, w, total)))
                tokens.index_copy_(2, (pos + 1).reshape(1), tok[..., None])
                flat = (base + parent).reshape(-1)
                for c in caches:
                    for x in c.values():
                        x.copy_(x.index_select(0, flat))
                if frozen is not None:
                    finished.copy_(finished.gather(1, parent)
                                   | (tok == eos_token))
                scores.copy_(best)
                pos.add_(1)

            return graphs.Program(caches1=caches1, caches=caches,
                                  tokens=tokens, scores=scores,
                                  finished=finished, pos=pos,
                                  step=graphs.Step(step, dev))

        prog = self._program("beam", (b, plen, max_new, w, eos_token, pad,
                                      quantized_cache, dev), build)
        logp0 = torch.log_softmax(self.prefill(prompt, prog.caches1)[:, -1]
                                  .float(), dim=-1)
        scores, tok0 = torch.topk(logp0, w, dim=-1)              # [B, W]
        for c1, c in zip(prog.caches1, prog.caches):
            for name, x in c.items():
                x.copy_(c1[name].repeat_interleave(w, 0))
        prog.scores.copy_(scores)
        prog.tokens.zero_()
        prog.tokens[:, :, :plen] = prompt[:, None, :]
        prog.tokens[:, :, plen] = tok0
        prog.finished.copy_(tok0 == eos_token if eos_token is not None
                            else torch.zeros_like(prog.finished))
        prog.pos.fill_(plen)
        for _ in range(max_new - 1):
            prog.step()
        tokens, scores = prog.tokens, prog.scores
        if eos_token is not None:
            hit = tokens[:, :, plen:] == eos_token
            first = torch.argmax(hit.long(), dim=2)              # [B, W]
            lens = torch.where(hit.any(2), first + 1,
                               torch.full_like(first, max_new))
            tokens = _mask_after_eos(tokens.reshape(b * w, total), plen,
                                     eos_token, pad).reshape(b, w, total)
        else:
            lens = torch.full((b, w), max_new, device=dev)
        norm = scores / lens.float() ** length_penalty
        order = torch.argsort(-norm, dim=1, stable=True)
        tokens = tokens.gather(1, order[..., None].expand(b, w, total))
        norm = norm.gather(1, order)
        if return_all:
            return tokens, norm
        return tokens[:, 0]

    @torch.no_grad()
    def speculative_generate(self, draft_model, prompt, max_new: int,
                             gamma: int = 4, temperature: float = 0.0,
                             generator=None, top_k=None, top_p=None,
                             quantized_cache: bool = False, eos_token=None,
                             pad_token=None, return_stats: bool = False,
                             per_row: bool = True):
        """Speculative (draft-verify) decoding (JAX
        ``speculative_generate``): ``draft_model`` proposes ``gamma``
        tokens by decode steps, this model scores them in one
        :meth:`decode_chunk`, and a verified prefix plus one target token
        is kept.  Greedy (``temperature == 0``): the longest run agreeing
        with the target's argmax, so the output is the target's own greedy
        decode (up to the rounding of a chunk against single steps).
        Sampled: the rejection-sampling scheme of :func:`_spec_accept`,
        whose tokens are distributed as the target's filtered sampling
        distribution.  ``per_row=True``: each row commits its own
        accepted length (positions are ``[B]`` through the draft steps,
        the verify chunk and the cache writes); finished rows freeze.
        ``per_row=False``: rows advance in lockstep at the batch's
        minimum.  A round (the draft steps, the verify chunk, acceptance
        and the draft's backfill step) replays one captured round
        (``utils.graphs``; eager on the CPU), and one host sync a round
        decides whether to go on.

        Returns ``[B, P + max_new]`` tokens (``return_stats=True``: also
        ``{"rounds", "tokens_per_round", "accept_hist", "row_tokens"}``).
        The statistics count the tokens each row committed after the
        first, up to ``P + max_new``: JAX's (``models/transformer.py:1054``)
        count the final round's tokens past that too, over-counting by
        up to γ; the port does not repeat that."""
        prompt = self._tokens(prompt)
        b, plen = prompt.shape
        total = plen + max_new
        self._fits(total + gamma)
        draft_model._fits(total + gamma)
        if self.vocab_size != draft_model.vocab_size:
            raise ValueError(f"vocab sizes differ: target {self.vocab_size}"
                             f", draft {draft_model.vocab_size}")
        if max_new <= 0:
            return (prompt, {"rounds": 0}) if return_stats else prompt
        dev = prompt.device
        sampled = temperature > 0
        # a frozen row's draft steps write up to 2 gamma past P + max_new
        # (JAX's scatter drops those writes; a longer buffer keeps them)
        buf = total + 2 * gamma
        cur0 = plen + 1                    # tokens[:, :cur] are final

        def build():
            tokens = prompt.new_zeros(b, buf)
            caches_t = self.init_cache(b, quantized=quantized_cache)
            caches_d = draft_model.init_cache(b, quantized=quantized_cache)
            gen = torch.Generator(device=dev)
            hist = torch.zeros(gamma + 1, dtype=torch.long, device=dev)
            cur = torch.zeros(b if per_row else (), dtype=torch.long,
                              device=dev)
            # per row: [B] rows done; lockstep: 0-d, the loop is over
            flag = torch.zeros(b if per_row else (), dtype=torch.bool,
                               device=dev)
            rows = torch.arange(b, device=dev)
            span = torch.arange(gamma + 1, device=dev)
            idx = torch.arange(buf, device=dev)[None, :]

            def dist(logits):
                """The filtered sampling distribution (f32), both
                models'."""
                return torch.softmax(_filter_logits(
                    logits.float(), temperature, top_k, top_p), dim=-1)

            def eos_rows():
                """[B] bool: an eos among each row's committed tokens."""
                if eos_token is None:
                    return torch.zeros(b, dtype=torch.bool, device=dev)
                gen_region = (idx >= plen) & (idx < cur.reshape(-1, 1))
                return ((tokens == eos_token) & gen_region).any(1)

            def draft_round():
                """gamma draft tokens after ``cur - 1``; the draft's
                distributions ``[B, γ, V]`` when sampling."""
                qs = []
                for j in range(gamma):
                    p = cur - 1 + j
                    tok_p = (tokens[rows, p] if per_row else
                             tokens.index_select(1, p.reshape(1))[:, 0])
                    logits = draft_model.decode_step(tok_p, p, caches_d)
                    if sampled:
                        q = dist(logits)
                        qs.append(q)
                        nxt = torch.multinomial(q, 1, generator=gen)[:, 0]
                    else:
                        nxt = torch.argmax(logits, dim=-1)
                    if per_row:
                        tokens[rows, p + 1] = nxt
                    else:
                        tokens.index_copy_(1, (p + 1).reshape(1),
                                           nxt[:, None])
                return torch.stack(qs, 1) if sampled else None

            def round_rows():
                done = flag.clone()
                q = draft_round()
                chunk = tokens.gather(1, (cur - 1)[:, None] + span)
                logits = self.decode_chunk(chunk, cur - 1, caches_t)
                drafts = chunk[:, 1:]
                if sampled:
                    n_acc, nxt = _spec_accept_rows(gen, drafts, q,
                                                   dist(logits))
                else:
                    tgt = torch.argmax(logits, dim=-1)
                    n_acc = torch.cumprod((tgt[:, :gamma] == drafts).long(),
                                          dim=1).sum(1)
                    nxt = tgt.gather(1, n_acc[:, None])[:, 0]
                n_acc = torch.where(done, torch.zeros_like(n_acc), n_acc)
                hist.scatter_add_(0, n_acc, (~done).long())
                at = cur + n_acc
                tokens[rows, at] = torch.where(done, tokens[rows, at], nxt)
                # full acceptance leaves the draft cache without position
                # cur + gamma - 1 (the next round drafts from cur +
                # gamma): backfill it; every other row rewrites cur +
                # n_acc, which the next round's first draft step writes
                # the same
                pb = cur + torch.where(n_acc == gamma,
                                       torch.full_like(n_acc, gamma - 1),
                                       n_acc)
                draft_model.decode_step(tokens[rows, pb], pb, caches_d)
                cur.copy_(torch.where(done, cur, cur + n_acc + 1))
                flag.copy_((cur >= total) | eos_rows())

            def round_lockstep():
                q = draft_round()
                chunk = tokens.gather(1, (cur - 1 + span).expand(b, -1))
                logits = self.decode_chunk(chunk, cur - 1, caches_t)
                drafts = chunk[:, 1:]
                if sampled:
                    n_acc, nxt = _spec_accept(gen, drafts, q, dist(logits))
                else:
                    tgt = torch.argmax(logits, dim=-1)
                    n_acc = torch.cumprod((tgt[:, :gamma] == drafts).long(),
                                          dim=1).sum(1).min()
                    nxt = tgt.index_select(1, n_acc.reshape(1))[:, 0]
                tokens.index_copy_(1, (cur + n_acc).reshape(1), nxt[:, None])
                # the draft cache's hole after full acceptance; below it
                # the step rewrites cur + n_acc as the next round's first
                # draft step does (a graph takes both branches' work)
                pb = cur + torch.where(n_acc == gamma,
                                       torch.full_like(n_acc, gamma - 1),
                                       n_acc)
                draft_model.decode_step(
                    tokens.index_select(1, pb.reshape(1))[:, 0], pb,
                    caches_d)
                hist.index_add_(0, n_acc.reshape(1),
                                torch.ones(1, dtype=torch.long, device=dev))
                cur.add_(n_acc + 1)
                flag.copy_((cur >= total) | eos_rows().all())

            round_ = round_rows if per_row else round_lockstep
            return graphs.Program(
                tokens=tokens, caches_t=caches_t, caches_d=caches_d,
                gen=gen, hist=hist, cur=cur, flag=flag, eos_rows=eos_rows,
                step=graphs.Step(round_, dev, [gen] if sampled else []))

        prog = self._program(
            "speculative", (draft_model, draft_model.state_key(), b, plen,
                            max_new, gamma, float(temperature), top_k, top_p,
                            quantized_cache, eos_token, per_row, dev), build)
        graphs.draw_from(prog.gen, generator)
        prog.tokens.zero_()
        prog.tokens[:, :plen] = prompt
        first = _sample(self.prefill(prompt, prog.caches_t)[:, -1], prog.gen,
                        temperature=temperature, top_k=top_k, top_p=top_p)
        draft_model.prefill(prompt, prog.caches_d)
        prog.tokens[:, plen] = first
        prog.hist.zero_()
        prog.cur.fill_(cur0)
        if per_row:
            prog.flag.copy_((prog.cur >= total) | prog.eos_rows())
        else:
            prog.flag.copy_((prog.cur >= total) | prog.eos_rows().all())
        rounds = 0
        while not bool(prog.flag.all()):   # one host sync a round
            prog.step()
            rounds += 1
        graphs.give_back(prog.gen, generator)
        if per_row:
            row_tokens = (prog.cur.clamp(max=total) - cur0).cpu()
            adv = float(row_tokens.float().mean())
        else:
            row_tokens = None
            adv = float(min(int(prog.cur), total) - cur0)
        out = prog.tokens[:, :total].clone()
        if eos_token is not None:
            out = _mask_after_eos(out, plen, eos_token,
                                  eos_token if pad_token is None
                                  else pad_token)
        if return_stats:
            return out, {"rounds": rounds,
                         "tokens_per_round": adv / max(rounds, 1),
                         "accept_hist": prog.hist.cpu(),
                         "row_tokens": row_tokens}
        return out
