"""Continuous-batching serving engine for TinyGPT: port of
``taper_tpu/serve.py`` (``ServingEngine``, with a contiguous or a paged KV
cache, in the model's dtype or int8).

A fixed batch of ``slots`` decodes together; requests stream through the
slots:

* **admission**: a one-row prefill of the prompt, right-padded to
  ``prompt_pad``, through the flash attention kernel.  Paged mode
  scatters its K/V rows into blocks taken from a shared pool by a
  host-side :class:`BlockAllocator`; contiguous mode prefills straight
  into the slot's row of the engine's ``[slots, kvh, max_seq, D]`` caches
  (positions ``[0, prompt_pad)``; what lies beyond is never attended, as
  decode writes a position before attending to it).  The first token is
  sampled from the logit at the prompt's last position.
* **decode**: ``decode_block`` steps for all slots, each row at its own
  position, through the GEMM kernel and, in paged mode, the
  paged-attention kernel (contiguous decode attention is plain PyTorch,
  as the JAX package leaves it to XLA).  The JAX engine runs the block as
  one ``lax.scan``; here the block is captured once as a CUDA graph over
  the engine's static buffers (``utils/graphs.py``: one graph for greedy
  blocks, one for blocks with a sampled row) and replayed, eager on the
  CPU; the host's tables and sampling settings are copied into those
  buffers before each replay.  The host syncs once per block (the ``[K,
  B]`` token tile) and once per admission (the first token).
* **retirement**: after each block the host scans the token tile for eos
  and the per-request budget, frees the request's blocks (paged) and
  re-admits from the queue.  A row that finishes inside a block keeps
  decoding to the block's end; those extra tokens are discarded, and a
  position past ``max_seq`` is clamped on the way.

``quantized_cache=True`` stores K/V as int8 rows with one f32 scale per
(row, head, position), in either mode; paged int8 pools run the int8
branch of the paged-attention kernel.

Paged mode: idle and retired slots point their tables at a reserved trash
block, so their writes never touch a live request's blocks.  Admission
reserves ``ceil((len + max_new) / bs)`` blocks, the request's true worst
case; the prefill scatters ``ceil(prompt_pad / bs)`` blocks, and any
beyond the reservation go back to the allocator right after admission.

A PTQ'd model (``quantization.quantize_params``) serves as it is: its
quantized weights move to the engine's device with the model, and its
projections run the dequant-on-load kernels.

Greedy rows get exactly the tokens of the JAX engine up to numerics;
sampled rows draw from an explicit ``torch.Generator`` (their numbers
differ from JAX's key stream).

A ``system_prompt`` (paged mode; a token list whose length is a
multiple of ``block_size``) is prefilled once, when the engine is built,
into prefix blocks allocated once, which every admitted row's table
aliases read-only: its K/V is stored once whatever the slot count, and
admission chunk-prefills only the request's own tokens at offset
``len(system_prompt)`` (``TinyGPT.prefill_paged_continued``).  The new
ranges start on a block boundary, so nothing writes the shared blocks.
JAX asserts the alignment and the paged mode; the port raises
``ValueError``.

:func:`offline_serve` serves a workload known up front through an
engine with a contiguous cache, syncing once per decode block where
JAX's ``lax.while_loop`` never syncs.

Not ported yet: LoRA adapter banks (``lora``, ``lora_bank``,
``submit(adapter=)``).  ``paged_impl`` picks a JAX backend: ``None`` and
``"pallas"`` mean the kernel; ``"xla"`` (the gather oracle) is what a CPU
engine runs, and raises on the card.
"""

from __future__ import annotations

import collections
import functools
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from taper_tpu_torch.utils import graphs, not_ported


def _sample_per_row(logits, generator, temps, top_ks, top_ps):
    """Per-request sampling for a slot batch: row b draws at ``temps[b]``
    with top-k ``top_ks[b]`` (0 = off) and top-p ``top_ps[b]`` (1.0 =
    off); rows with ``temps[b] == 0`` take the argmax.  ``[B, V]`` logits
    -> ``[B]`` int64 tokens; the argmax always survives the nucleus
    filter."""
    v = logits.shape[-1]
    greedy = torch.argmax(logits, dim=-1)
    lt = logits / temps.clamp_min(1e-6)[:, None]
    order = torch.argsort(lt, dim=-1, descending=True, stable=True)
    ranks = torch.argsort(order, dim=-1)              # 0 = highest logit
    k_eff = torch.where(top_ks > 0, top_ks, v)[:, None]
    lt = lt.masked_fill(ranks >= k_eff, float("-inf"))
    sl = torch.gather(lt, -1, order)                  # sorted, descending
    probs = torch.softmax(sl, dim=-1)
    keep = (torch.cumsum(probs, dim=-1) - probs) < top_ps[:, None]
    keep[:, 0] = True                                 # argmax always kept
    sl = sl.masked_fill(~keep, float("-inf"))
    lt = torch.gather(sl, -1, ranks)
    sampled = torch.multinomial(torch.softmax(lt, dim=-1), 1,
                                generator=generator)[:, 0]
    return torch.where(temps > 0, sampled, greedy)


def _serving_device(device, owner: str) -> torch.device:
    """The card unless ``device`` says otherwise; without a card, raise
    and say how to serve on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{owner}: no CUDA device; serving runs on the card unless "
                f"asked otherwise, so pass device=\"cpu\" to serve on the "
                f"CPU")
        device = "cuda"
    return torch.device(device)


def _host_ints(x, name: str) -> np.ndarray:
    x = np.asarray(x.cpu() if torch.is_tensor(x) else x)
    if x.size and x.dtype.kind not in "iu":
        raise ValueError(f"{name} must hold integers, got {x.dtype}")
    return x.astype(np.int64)


def offline_serve(model, prompts, lens, max_new, *, slots: int = 8,
                  eos_token: Optional[int] = None, temperature: float = 0.0,
                  top_k=None, top_p=None, quantized_cache: bool = False,
                  max_out: Optional[int] = None, generator=None,
                  device=None):
    """Continuous batching of a workload known up front (JAX
    ``offline_serve``, ``taper_tpu/serve.py:68``): ``prompts [N, P]``
    right-padded, ``lens [N]`` their true lengths, ``max_new [N]``
    per-request budgets (capped at ``max_out``, by default the largest).
    Returns ``(tokens [N, max_out], n_tokens [N])``, int64 host tensors:
    each request's generated tokens (its eos included when one ended it),
    zeros past ``n_tokens``.

    The requests go through a :class:`ServingEngine` with a contiguous
    cache (int8 with ``quantized_cache``) of ``slots`` rows, prompts
    padded to P, and its captured decode block; the engine is kept on the
    model for the next call with the same settings, as JAX caches its
    program.  Greedy rows are standalone ``generate``'s tokens (JAX's
    contract, ``serve.py:92-93``) bit for bit in f32 on the CPU; on the
    card a row's prefill at the padded length and its decode among
    ``slots`` rows take other K1 tiles and splits, so other roundings,
    than a standalone call, and a bf16 near-tie may resolve the other way.
    Sampled rows draw from ``generator`` (seed 0 when none is given, where
    JAX takes ``key=``), one stream for the whole run.

    A deliberate difference: JAX runs the whole scheduler in one
    ``lax.while_loop`` and never syncs; the engine syncs once per decode
    block, and a slot freed inside a block waits for the block's end.
    Rows never see each other, so no row's tokens change.  Runs on
    ``device``: the card unless asked for ``device="cpu"``."""
    device = _serving_device(device, "offline_serve")
    prompts = _host_ints(prompts, "prompts")
    if prompts.ndim != 2:
        raise ValueError(f"prompts must be [N, P], got {prompts.shape}")
    n, p_pad = prompts.shape
    lens = _host_ints(lens, "lens").reshape(-1)
    budgets = _host_ints(max_new, "max_new").reshape(-1)
    if len(lens) != n or len(budgets) != n:
        raise ValueError(f"lens ({len(lens)}) and max_new ({len(budgets)}) "
                         f"need one entry per prompt ({n})")
    if n and (lens.min() < 1 or lens.max() > p_pad):
        raise ValueError(f"lens must be in [1, {p_pad}]")
    m_out = int(max_out if max_out is not None else
                (budgets.max() if n else 0))
    if p_pad + m_out > model.max_seq:
        raise ValueError(f"padded prompt {p_pad} + max_out {m_out} exceeds "
                         f"max_seq {model.max_seq}")
    budgets = np.clip(budgets, 0, m_out)
    out = np.zeros((n, m_out), np.int64)
    n_tok = np.zeros(n, np.int64)
    if n == 0 or m_out == 0:
        return torch.from_numpy(out), torch.from_numpy(n_tok)
    model = model.to(device)
    eng = graphs.program(
        model, ("offline_serve", model.state_key(), slots, p_pad,
                quantized_cache, eos_token, float(temperature), top_k, top_p,
                device),
        lambda: ServingEngine(model, slots=slots, prompt_pad=p_pad,
                              eos_token=eos_token, temperature=temperature,
                              top_k=top_k, top_p=top_p,
                              quantized_cache=quantized_cache, device=device))
    graphs.draw_from(eng._gen, generator)
    ids = [eng.submit(prompts[i, :lens[i]], budgets[i]) for i in range(n)]
    done = eng.run()
    graphs.give_back(eng._gen, generator)
    for i, rid in enumerate(ids):
        toks = done[rid][:budgets[i]]        # an admission emits one token
        out[i, :len(toks)] = toks
        n_tok[i] = len(toks)
    return torch.from_numpy(out), torch.from_numpy(n_tok)


class BlockAllocator:
    """Host-side free list over a paged pool's block ids.  Allocation and
    free are bookkeeping only (the device pools are never resized); the
    engine serialises all calls."""

    def __init__(self, n_blocks: int):
        self.n_blocks = n_blocks
        self._free = list(range(n_blocks - 1, -1, -1))

    @property
    def available(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise RuntimeError(
                f"paged pool exhausted: need {n} blocks, "
                f"{len(self._free)}/{self.n_blocks} free")
        return [self._free.pop() for _ in range(n)]

    def free(self, ids) -> None:
        self._free.extend(int(i) for i in ids)


class ServingEngine:
    """Slot-based continuous batching over a TinyGPT, with a contiguous KV
    cache (``pool_blocks=None``) or a paged one (``pool_blocks=N`` blocks
    of ``block_size`` positions), int8 with ``quantized_cache``.

    ``submit()`` enqueues prompts; ``run()`` drains the queue and returns
    ``{request_id: generated tokens}`` (with the eos token when one ended
    the row).  The engine runs on ``device`` and moves the model there:
    the card by default (without one the constructor raises unless
    ``device="cpu"`` asks for the CPU, as the Trainer does).  Sampling
    draws from ``generator`` (a ``torch.Generator`` on that device), or
    from one seeded ``seed``."""

    def __init__(self, model, *, slots: int = 8, prompt_pad: int = 64,
                 decode_block: int = 16, eos_token: Optional[int] = None,
                 temperature: float = 0.0, top_k=None, top_p=None,
                 pool_blocks: Optional[int] = None, block_size: int = 128,
                 seed: int = 0, quantized_cache: bool = False,
                 system_prompt: Optional[Sequence[int]] = None,
                 paged_impl: Optional[str] = None,
                 lora=None, lora_bank=None, device=None, generator=None):
        not_ported("ServingEngine", lora=lora is not None,
                   lora_bank=lora_bank is not None)
        if system_prompt is not None and pool_blocks is None:
            raise ValueError("system_prompt sharing requires the paged "
                             "cache (pool_blocks=...)")
        if paged_impl not in (None, "pallas", "xla"):
            raise ValueError(f"paged_impl {paged_impl!r}: None, 'pallas' or "
                             f"'xla'")
        self.device = _serving_device(device, "ServingEngine")
        # the gather oracle is the CPU's paged attention; on the card the
        # kernel is the only one
        not_ported("ServingEngine", paged_impl=paged_impl == "xla"
                   and self.device.type == "cuda")
        self.model = model.to(self.device)
        self.slots = slots
        self.prompt_pad = prompt_pad
        self.decode_block = decode_block
        self.eos_token = eos_token
        self._gen = (generator if generator is not None else
                     torch.Generator(device=self.device).manual_seed(seed))
        self._queue = collections.deque()
        self._next_id = 0
        self._outputs: Dict[int, List[int]] = {}
        self._done_ids: List[int] = []
        # slot -> (request_id, max_new) or None
        self._slot_req: List[Optional[tuple]] = [None] * slots
        # engine-level sampling config = per-request defaults
        self._default_sampling = (float(temperature),
                                  0 if top_k is None else int(top_k),
                                  1.0 if top_p is None else float(top_p))
        self._temps = np.full((slots,), self._default_sampling[0],
                              np.float32)
        self._topks = np.full((slots,), self._default_sampling[1], np.int64)
        self._topps = np.full((slots,), self._default_sampling[2],
                              np.float32)

        # the caches are updated in place (JAX donates them to its
        # programs)
        self._paged = pool_blocks is not None
        self._prefix_len = 0 if system_prompt is None else len(system_prompt)
        self._prefix_blocks: List[int] = []
        if self._paged:
            bs = block_size
            if self._prefix_len % bs:
                raise ValueError(
                    f"system_prompt length ({self._prefix_len}) must be a "
                    f"multiple of block_size ({bs}) so shared prefix "
                    f"blocks are never written by per-request prefills")
            if self._prefix_len + prompt_pad > model.max_seq:
                raise ValueError(
                    f"system_prompt ({self._prefix_len}) + prompt_pad "
                    f"({prompt_pad}) exceeds max_seq {model.max_seq}")
            self._block_size = bs
            self._max_blocks = -(-model.max_seq // bs)
            self._alloc = BlockAllocator(pool_blocks)
            self._slot_blocks: List[List[int]] = [[] for _ in range(slots)]
            # host-side tables, pushed to the device per call (tiny int32)
            self._tables = np.zeros((slots, self._max_blocks), np.int32)
            self._caches = model.init_paged_cache(
                pool_blocks, bs, device=self.device,
                quantized=quantized_cache)
            # decode writes K/V for EVERY slot each step (frozen rows
            # rewrite their own last position); idle and retired slots'
            # tables point at a reserved trash block so their writes never
            # touch a live request's blocks
            self._trash = self._alloc.alloc(1)[0]
            self._tables[:] = self._trash
            if self._prefix_len:
                # the shared prefix: its blocks are allocated for the
                # engine's lifetime and prefilled once
                self._prefix_blocks = self._alloc.alloc(
                    self._prefix_len // bs)
                sp = torch.tensor([list(map(int, system_prompt))],
                                  dtype=torch.int64, device=self.device)
                row = torch.tensor([self._prefix_blocks], dtype=torch.int32,
                                   device=self.device)
                with torch.no_grad():
                    model.prefill_paged(sp, self._caches, row)
        else:
            self._caches = model.init_cache(slots, quantized=quantized_cache,
                                            device=self.device)
        # the decode block's static buffers, updated in place: the block
        # is captured over them once (a graph for greedy blocks, one for
        # blocks with a sampled row) and replayed
        self._last_tok = torch.zeros(slots, dtype=torch.int64,
                                     device=self.device)
        self._pos = torch.zeros(slots, dtype=torch.int32, device=self.device)
        self._active = torch.zeros(slots, dtype=torch.bool,
                                   device=self.device)
        self._tile = torch.zeros(decode_block, slots, dtype=torch.int64,
                                 device=self.device)
        self._tables_dev = (torch.from_numpy(self._tables).to(self.device)
                            if self._paged else None)
        self._sampling_dev = (
            torch.zeros(slots, dtype=torch.float32, device=self.device),
            torch.zeros(slots, dtype=torch.int64, device=self.device),
            torch.zeros(slots, dtype=torch.float32, device=self.device))
        self._blocks: Dict[bool, graphs.Step] = {}
        self._emitted = [0] * slots     # host mirror of tokens emitted
        self._stats = {"admitted": 0, "completed": 0, "decode_blocks": 0,
                       "tokens_emitted": 0, "admission_deferrals": 0}

    def stats(self):
        """Host counters (no device sync): request lifecycle counts, slot
        and queue occupancy, and pool occupancy."""
        out = dict(self._stats)
        out["queued"] = len(self._queue)
        out["active_slots"] = sum(r is not None for r in self._slot_req)
        out["slots"] = self.slots
        if self._paged:
            out["pool_blocks_total"] = (self._alloc.n_blocks - 1
                                        - len(self._prefix_blocks))
            out["pool_blocks_free"] = self._alloc.available
        return out

    # -- request lifecycle -------------------------------------------------

    def submit(self, prompt: Sequence[int], max_new: int,
               temperature: Optional[float] = None,
               top_k: Optional[int] = None,
               top_p: Optional[float] = None,
               adapter: Optional[int] = None) -> int:
        """Enqueue one request; ``temperature``/``top_k``/``top_p``
        override the engine defaults for this request."""
        not_ported("ServingEngine.submit", adapter=adapter is not None)
        if not 1 <= len(prompt) <= self.prompt_pad:
            raise ValueError(f"prompt length {len(prompt)} is outside "
                             f"[1, {self.prompt_pad}]")
        reach = self._prefix_len + self.prompt_pad + max_new
        if reach > self.model.max_seq:
            raise ValueError(f"system_prompt + prompt_pad + max_new = "
                             f"{reach} exceeds max_seq {self.model.max_seq}")
        if self._paged:
            need = self._paged_need(len(prompt), int(max_new))[2]
            usable = self._alloc.n_blocks - 1 - len(self._prefix_blocks)
            if need > usable:
                raise ValueError(
                    f"request needs {need} blocks but the pool only has "
                    f"{usable} usable (trash and shared prefix blocks "
                    f"reserved): it could never be admitted")
        rid = self._next_id
        self._next_id += 1
        dt, dk, dp = self._default_sampling
        samp = (dt if temperature is None else float(temperature),
                dk if top_k is None else int(top_k),
                dp if top_p is None else float(top_p))
        self._queue.append((rid, list(map(int, prompt)), int(max_new), samp))
        return rid

    def _free_slots(self):
        return [i for i, r in enumerate(self._slot_req) if r is None]

    def _paged_need(self, prompt_len: int, max_new: int):
        """(scatter, keep, alloc) counts of new blocks for one admission,
        beyond any shared prefix blocks: the prefill scatters the blocks
        that cover ``prefix + prompt_pad``, the request only ever reads
        what covers ``prefix + len + max_new``."""
        bs, pref = self._block_size, self._prefix_len
        nbp = pref // bs
        scatter = -(-(pref + self.prompt_pad) // bs) - nbp
        keep = -(-(pref + prompt_len + max_new) // bs) - nbp
        return scatter, keep, max(scatter, keep)

    def _sampling(self, rows):
        """Device tensors of the sampling config of ``rows`` (a slice), or
        None when every row is greedy (the argmax needs no sort)."""
        if not (self._temps[rows] > 0).any():
            return None
        return tuple(torch.from_numpy(a[rows]).to(self.device)
                     for a in (self._temps, self._topks, self._topps))

    def _sample(self, logits, sampling):
        if sampling is None:
            return torch.argmax(logits, dim=-1)
        return _sample_per_row(logits, self._gen, *sampling)

    def _admit_one(self, slot: int) -> bool:
        if self._paged:
            _, prompt, max_new, _ = self._queue[0]
            _, keep, need = self._paged_need(len(prompt), max_new)
            if need > self._alloc.available:
                self._stats["admission_deferrals"] += 1
                return False          # first come, first served: wait
        rid, prompt, max_new, (temp, topk, topp) = self._queue.popleft()
        self._temps[slot], self._topks[slot], self._topps[slot] = \
            temp, topk, topp
        padded = np.zeros((1, self.prompt_pad), np.int64)
        padded[0, :len(prompt)] = prompt
        padded = torch.from_numpy(padded).to(self.device)
        if self._paged:
            nbp = self._prefix_len // self._block_size
            ids = self._alloc.alloc(need)
            row = np.full((self._max_blocks,), self._trash, np.int32)
            row[:nbp] = self._prefix_blocks        # shared, read-only
            row[nbp:nbp + need] = ids
            self._tables[slot] = row
            table = torch.from_numpy(row[None]).to(self.device)
            if self._prefix_len:
                logits = self.model.prefill_paged_continued(
                    padded, self._caches, table, self._prefix_len)
            else:
                logits = self.model.prefill_paged(padded, self._caches,
                                                  table)
            if need > keep:   # prompt-pad scatter overshoot: return it now
                self._alloc.free(ids[keep:])
                self._tables[slot, nbp + keep:] = self._trash
            self._slot_blocks[slot] = ids[:keep]
        else:
            # the slot's row of every layer's cache, as a one-row view:
            # the prefill fills [0, prompt_pad) of it in place
            logits = self.model.prefill(padded, [
                {k: c[slot:slot + 1] for k, c in cache.items()}
                for cache in self._caches])
        tok = self._sample(logits[0, len(prompt) - 1][None],
                           self._sampling(slice(slot, slot + 1)))
        self._last_tok[slot] = tok[0]
        self._pos[slot] = self._prefix_len + len(prompt)
        self._active[slot] = True
        self._slot_req[slot] = (rid, max_new)
        self._stats["admitted"] += 1
        self._stats["tokens_emitted"] += 1
        self._emitted[slot] = 1        # prefill sampled the first token
        # one small device->host sync per admission: retirement must see
        # the first token before the next decode block (max_new == 1, eos)
        first = int(tok[0])
        self._outputs[rid] = [first]
        self._maybe_retire(slot, first)
        return True

    def _maybe_retire(self, slot: int, tok: int):
        rid, max_new = self._slot_req[slot]
        done = (self.eos_token is not None and tok == self.eos_token) \
            or self._emitted[slot] >= max_new
        if done:
            self._slot_req[slot] = None
            self._active[slot] = False
            self._done_ids.append(rid)
            self._stats["completed"] += 1
            if self._paged:
                self._alloc.free(self._slot_blocks[slot])
                self._slot_blocks[slot] = []
                self._tables[slot, :] = self._trash

    @torch.no_grad()
    def _decode_block(self):
        """``decode_block`` steps for all slots; frozen rows hold their
        token and position.  Returns the ``[K, B]`` token tile (host).
        The block replays a captured graph (eager on the CPU); the host
        state it reads goes to its static buffers once per block."""
        sampled = bool((self._temps > 0).any())
        if self._paged:
            self._tables_dev.copy_(torch.from_numpy(self._tables))
        if sampled:
            for buf, host in zip(self._sampling_dev, (
                    self._temps, self._topks, self._topps)):
                buf.copy_(torch.from_numpy(host))
        if sampled not in self._blocks:
            self._blocks[sampled] = graphs.Step(
                functools.partial(self._block_body, sampled), self.device,
                [self._gen] if sampled else [])
        self._blocks[sampled]()
        return self._tile.cpu().numpy()

    def _block_body(self, sampled: bool):
        """The decode block over the engine's static buffers (what the
        graph captures)."""
        sampling = self._sampling_dev if sampled else None
        active = self._active
        tok, pos = self._last_tok, self._pos
        for k in range(self.decode_block):
            if self._paged:
                logits = self.model.decode_step_paged(
                    tok, pos, self._caches, self._tables_dev)
            else:
                logits = self.model.decode_step(tok, pos, self._caches)
            nxt = self._sample(logits, sampling)
            tok = torch.where(active, nxt, tok)
            pos = torch.where(active, pos + 1, pos)
            self._tile[k].copy_(tok)
        self._last_tok.copy_(tok)
        self._pos.copy_(pos)

    @torch.no_grad()
    def step(self) -> bool:
        """One scheduling round: admit into free slots, then one decode
        block; returns True while work remains."""
        for slot in self._free_slots():
            if not self._queue:
                break
            if not self._admit_one(slot):
                break                 # paged pool full: decode first
        if not any(r is not None for r in self._slot_req):
            return bool(self._queue)
        self._stats["decode_blocks"] += 1
        tile = self._decode_block()
        for slot, req in enumerate(self._slot_req):
            if req is None:
                continue
            rid, _ = req
            for k in range(tile.shape[0]):
                if self._slot_req[slot] is None:
                    break
                t = int(tile[k, slot])
                self._outputs[rid].append(t)
                self._emitted[slot] += 1
                self._stats["tokens_emitted"] += 1
                self._maybe_retire(slot, t)
        return bool(self._queue) or any(r is not None
                                        for r in self._slot_req)

    def run(self) -> Dict[int, List[int]]:
        """Drain queue and slots; returns ``{request_id: tokens}`` for the
        requests completed by this call."""
        while self.step():
            pass
        done, self._done_ids = self._done_ids, []
        return {rid: self._outputs.pop(rid) for rid in done}
