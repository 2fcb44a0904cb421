"""Sequence packing (taper_tpu_torch/data/packing.py) against the JAX
package's (taper_tpu/data/packing.py): the same documents give the same
arrays exactly, empty documents and documents longer than ``seq_len``
included; and the packed loss of the port's TinyGPT on the CPU, which
pad tokens cannot move."""

import numpy as np
import pytest
import torch

from taper_tpu.data import packing as jpacking
from taper_tpu_torch.data import pack_documents, packing_efficiency
from taper_tpu_torch.models import TinyGPT

torch.set_num_threads(1)


def _bench_docs(n_docs=64, mean_len=192, seq_len=1024, vocab=4096):
    """benchmarks/bench_packing.py:37-44's documents."""
    rng = np.random.default_rng(0)
    lens = np.clip(rng.geometric(1.0 / mean_len, n_docs), 8,
                   seq_len).astype(int)
    return [list(rng.integers(1, vocab, int(n))) for n in lens]


_CASES = {
    "short": ([[1, 2, 3], [4, 5, 6, 7, 8], [9, 10], [11] * 12], 8),
    "empty-docs": ([[], [3, 4], [], [5] * 7, []], 4),
    "longer-than-seq": ([[7] * 23, [1, 2], [8] * 5], 5),
    "seq-len-2": ([[1], [2, 3, 4], [5, 6]], 2),
    "one-token-docs": ([[i] for i in range(1, 9)], 3),
    "bench-packing": (_bench_docs(), 1024),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_pack_documents_equals_jax(case):
    docs, seq_len = _CASES[case]
    ref = jpacking.pack_documents(docs, seq_len)
    got = pack_documents(docs, seq_len)
    assert got.keys() == ref.keys()
    for name in ref:
        assert got[name].dtype == ref[name].dtype, name
        np.testing.assert_array_equal(got[name], ref[name])
    assert packing_efficiency(got) == jpacking.packing_efficiency(ref)


def test_bench_packing_rows():
    """bench_packing's 64 documents pack into ~13 rows of 1024."""
    p = pack_documents(_bench_docs(), 1024)
    assert 10 <= p["tokens"].shape[0] <= 16
    assert packing_efficiency(p) > 0.9


def test_seq_len_below_two_raises():
    with pytest.raises(ValueError, match="seq_len"):
        pack_documents([[1, 2]], 1)


def test_packed_loss_ignores_pad_tokens():
    """TinyGPT.loss over a packed batch on the CPU: finite, and garbage in
    the pad slots cannot move it (the segment mask keeps every document
    away from them and the loss mask drops their targets)."""
    model = TinyGPT(vocab_size=37, dim=32, depth=2, num_heads=4, max_seq=64,
                    rope=True)
    model.reset_parameters(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    docs = [list(rng.integers(1, 37, int(n)))
            for n in rng.integers(3, 14, 9)]
    p = {k: torch.from_numpy(v) for k, v in pack_documents(docs, 32).items()}

    def run(tokens):
        return model.loss(tokens, p["targets"], p["loss_mask"],
                          segment_ids=p["segment_ids"],
                          positions=p["positions"])[0]

    base = run(p["tokens"])
    assert torch.isfinite(base)
    poisoned = p["tokens"].clone()
    poisoned[p["segment_ids"] == 0] = 36
    assert float(run(poisoned)) == float(base)
    base.backward()
    assert all(torch.isfinite(q.grad).all() for q in model.parameters()
               if q.grad is not None)
