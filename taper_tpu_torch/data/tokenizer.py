"""Byte-level BPE tokenizer: port of ``taper_tpu/data/tokenizer.py``
(training, encode/decode, save/load).

The base alphabet is the 256 bytes (any input round-trips), and training
greedily merges the most frequent adjacent pair until ``vocab_size``.
Host code: the merge loop runs in C++ (``native/bpe.cpp`` through
:mod:`taper_tpu_torch.data.native`) when the library loads, else in
NumPy, with the same merges and ids either way.  ``save``/``load`` use
the JAX package's file format (``taper_tpu-bpe-v1``), so a file either
package saves loads in the other.  A file of another format raises
``ValueError``, where JAX asserts.
"""

from __future__ import annotations

import json
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np

FORMAT = "taper_tpu-bpe-v1"


class BPETokenizer:
    """Byte-level BPE; ``merges[k]`` is the pair merged into id ``256 +
    k``."""

    def __init__(self, merges: Sequence[Tuple[int, int]]):
        self.merges: List[Tuple[int, int]] = [tuple(m) for m in merges]
        self.rank: Dict[Tuple[int, int], int] = {
            m: i for i, m in enumerate(self.merges)}
        # id -> its bytes
        self._bytes: List[bytes] = [bytes([i]) for i in range(256)]
        for a, b in self.merges:
            self._bytes.append(self._bytes[a] + self._bytes[b])

    @property
    def vocab_size(self) -> int:
        return 256 + len(self.merges)

    def token_bytes(self, tok_id: int) -> bytes:
        return self._bytes[tok_id]

    @classmethod
    def train(cls, corpus: Union[bytes, str], vocab_size: int,
              verbose: bool = False,
              use_native: bool = True) -> "BPETokenizer":
        """Learn ``vocab_size - 256`` merges from ``corpus`` (fewer when no
        pair repeats).  ``use_native``: the C++ loop when the library
        loads; the NumPy loop below is its fallback and oracle."""
        if vocab_size < 256:
            raise ValueError(f"vocab_size {vocab_size} < 256 (the bytes)")
        if isinstance(corpus, str):
            corpus = corpus.encode("utf-8")
        if use_native:
            from taper_tpu_torch.data import native
            m = native.bpe_train(bytes(corpus), vocab_size - 256)
            if m is not None:
                return cls([(int(a), int(b)) for a, b in m])
        ids = np.frombuffer(corpus, np.uint8).astype(np.int32)
        merges: List[Tuple[int, int]] = []
        for k in range(vocab_size - 256):
            if len(ids) < 2:
                break
            pairs = ids[:-1].astype(np.int64) * (1 << 32) + ids[1:]
            uniq, counts = np.unique(pairs, return_counts=True)
            if counts.max() < 2:
                break
            best = uniq[np.argmax(counts)]     # the lowest pair on ties
            pair = (int(best >> 32), int(best & 0xFFFFFFFF))
            ids = cls._merge(ids, pair, 256 + k)
            merges.append(pair)
            if verbose and (k + 1) % 64 == 0:
                print(f"  merge {k + 1}: {pair} (corpus {len(ids)} tokens)")
        return cls(merges)

    @staticmethod
    def _merge(ids: np.ndarray, pair: Tuple[int, int],
               new_id: int) -> np.ndarray:
        """Replace each occurrence of ``pair`` by ``new_id``, left to
        right: a match consumes its right neighbour, so overlapping
        matches ("aaa" with (a, a)) drop."""
        m = (ids[:-1] == pair[0]) & (ids[1:] == pair[1])
        idx = np.flatnonzero(m)
        if idx.size == 0:
            return ids
        sel, prev = [], -2
        for i in idx:
            if i > prev + 1:
                sel.append(i)
                prev = i
        sel = np.asarray(sel)
        out = ids.copy()
        out[sel] = new_id
        return np.delete(out, sel + 1)

    def encode(self, text: Union[bytes, str],
               use_native: bool = True) -> List[int]:
        """Apply the merges in training order, one pass a rank (equal to
        repeatedly merging the lowest-ranked pair present: a merge only
        creates pairs with its new token, which rank later)."""
        if isinstance(text, str):
            text = text.encode("utf-8")
        if use_native and self.merges:
            from taper_tpu_torch.data import native
            ids = native.bpe_encode(bytes(text),
                                    np.asarray(self.merges, np.int32))
            if ids is not None:
                return ids.tolist()
        ids = np.frombuffer(text, np.uint8).astype(np.int32)
        for r, pair in enumerate(self.merges):
            if len(ids) < 2:
                break
            ids = self._merge(ids, pair, 256 + r)
        return ids.tolist()

    def decode(self, ids: Sequence[int], errors: str = "replace") -> str:
        return self.decode_bytes(ids).decode("utf-8", errors=errors)

    def decode_bytes(self, ids: Sequence[int]) -> bytes:
        return b"".join(self._bytes[int(i)] for i in ids)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"format": FORMAT, "merges": self.merges}, f)

    @classmethod
    def load(cls, path: str) -> "BPETokenizer":
        with open(path) as f:
            d = json.load(f)
        if d.get("format") != FORMAT:
            raise ValueError(f"{path}: format {d.get('format')!r}, not "
                             f"{FORMAT!r}")
        return cls([tuple(m) for m in d["merges"]])
