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

Not ported yet: generation (``generate``,
``generate_continued``, ``decode_chunk``, ``prefill_paged_continued``,
beam search, speculative decoding).
"""

from __future__ import annotations

import functools
import math
from typing import Optional

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

# TinyGPT.loss takes the naive branch (full [B, S, vocab] logits) up to
# this many logits and the fused vocab-chunked loss beyond, as JAX does
# (models/transformer.py:290-292); the limit was measured on a TPU v5e
# and is kept as JAX's rule, not as a speed fact of the card
NAIVE_LOSS_MAX = 2 ** 28
FUSED_CHUNK = 4096              # the fused loss's vocab chunk by default


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
