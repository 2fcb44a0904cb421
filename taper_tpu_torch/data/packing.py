"""Sequence packing for LM training: port of ``taper_tpu/data/packing.py``
(pure numpy there too; the port keeps its own copy).

Variable-length documents waste most of a padded batch.  Packing
concatenates documents back to back into full rows and keeps them
independent with:

* ``segment_ids`` [B, S]: 1-based document id per token (0 = padding);
  attention masks to same-id keys (``ops.attention(segment_ids=...)``).
* ``positions`` [B, S]: the position inside the document, restarting at 0
  per document; it drives RoPE and the learned position table, so each
  document sees the positions it would see alone.
* ``targets``/``loss_mask``: next-token targets within each document; the
  last token of every document and all padding have mask 0, so no loss
  crosses a document boundary.

The packer is greedy first-fit over the documents in order
(deterministic); a document longer than ``seq_len`` is split into
``seq_len``-sized chunks, each its own segment.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

__all__ = ["pack_documents", "packing_efficiency"]


def pack_documents(docs: Sequence[Sequence[int]], seq_len: int,
                   pad_id: int = 0):
    """Pack token documents into fixed ``[B, seq_len]`` training rows.

    Returns a dict of numpy arrays, all ``[B, seq_len]``: ``tokens``,
    ``targets``, ``segment_ids`` (1-based, 0 = pad) and ``positions``
    (int32), and ``loss_mask`` (f32).  Feed them to ``TinyGPT.loss(tokens,
    targets, loss_mask, segment_ids=..., positions=...)`` as tensors.
    Empty documents are dropped."""
    if seq_len < 2:
        raise ValueError(f"seq_len must be at least 2, got {seq_len}")
    chunks: List[List[int]] = []
    for doc in docs:
        doc = list(doc)
        for i in range(0, len(doc), seq_len):
            chunks.append(doc[i:i + seq_len])

    rows: List[List[List[int]]] = []      # row -> its chunks
    fill: List[int] = []
    for ch in chunks:                      # greedy first-fit
        for r, used in enumerate(fill):
            if used + len(ch) <= seq_len:
                rows[r].append(ch)
                fill[r] += len(ch)
                break
        else:
            rows.append([ch])
            fill.append(len(ch))

    b = len(rows)
    tokens = np.full((b, seq_len), pad_id, np.int32)
    targets = np.full((b, seq_len), pad_id, np.int32)
    seg = np.zeros((b, seq_len), np.int32)
    pos = np.zeros((b, seq_len), np.int32)
    mask = np.zeros((b, seq_len), np.float32)
    for r, row in enumerate(rows):
        at = 0
        for s_id, ch in enumerate(row, start=1):
            n = len(ch)
            tokens[r, at:at + n] = ch
            seg[r, at:at + n] = s_id
            pos[r, at:at + n] = np.arange(n)
            if n > 1:
                targets[r, at:at + n - 1] = ch[1:]
                mask[r, at:at + n - 1] = 1.0
            at += n
    return {"tokens": tokens, "targets": targets, "segment_ids": seg,
            "positions": pos, "loss_mask": mask}


def packing_efficiency(packed) -> float:
    """Fraction of token slots that carry real (non-pad) tokens."""
    return float((packed["segment_ids"] > 0).mean())
