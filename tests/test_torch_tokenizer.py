"""Port of the byte-level BPE tokenizer (taper_tpu_torch/data/tokenizer.py
over its own ctypes loader, data/native.py) against the JAX package's,
and the byte-level LM example (taper_tpu_torch/examples/train_bytelm.py)
and the sort task's generation tail (examples/train_tinylm.py) run on
the CPU at a tiny size.

Merges and ids must be equal (host code, exact); the JAX package's file
format loads both ways.  The examples' losses are held against JAX's on
the same weights and windows at f32 (1e-5), and their generation
against JAX's greedy tokens.
"""

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taper_tpu import models as jmodels
from taper_tpu.data import native as jnative
from taper_tpu.data.tokenizer import BPETokenizer as JBPE
from taper_tpu_torch.data import native
from taper_tpu_torch.data.seq import sort_task_batch
from taper_tpu_torch.data.tokenizer import BPETokenizer
from taper_tpu_torch.examples import train_bytelm, train_tinylm
from taper_tpu_torch.models import TinyGPT
from taper_tpu_torch.utils.convert import load_jax_params

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def corpus():
    return bytes(train_bytelm.load_corpus().astype(np.uint8))[:40_000]


@pytest.mark.parametrize("use_native", [True, False])
def test_merges_and_ids_match_jax(corpus, use_native):
    if use_native:
        # the port's own loader finds the library wherever JAX's does
        assert native.available() == jnative.available()
    tok = BPETokenizer.train(corpus, 400, use_native=use_native)
    ref = JBPE.train(corpus, 400, use_native=use_native)
    assert tok.merges == ref.merges and tok.vocab_size == 400
    text = corpus[-5000:]
    ids = tok.encode(text, use_native=use_native)
    assert ids == ref.encode(text, use_native=use_native)
    assert tok.decode_bytes(ids) == text
    assert tok.decode(ids) == text.decode("utf-8", errors="replace")
    assert len(ids) < len(text)
    assert all(tok.token_bytes(i) == ref.token_bytes(i) for i in range(400))


def test_native_equals_python(corpus):
    a = BPETokenizer.train(corpus, 330)
    b = BPETokenizer.train(corpus, 330, use_native=False)
    assert a.merges == b.merges
    for text in (corpus[:3000], "naïve ünïcödé — ✓", b"", b"aaaa",
                 bytes(range(256))):
        assert a.encode(text) == b.encode(text, use_native=False)
        assert a.decode_bytes(a.encode(text)) == (
            text.encode() if isinstance(text, str) else text)


def test_overlapping_merges_and_early_stop():
    """"aaa" merges (a, a) once, left to right; training stops when no
    pair repeats."""
    for use_native in (True, False):
        tok = BPETokenizer.train(b"aaaaaaa", 300, use_native=use_native)
        ref = JBPE.train(b"aaaaaaa", 300, use_native=use_native)
        assert tok.merges == ref.merges
        assert tok.encode("aaa") == ref.encode("aaa")
    with pytest.raises(ValueError, match="256"):
        BPETokenizer.train(b"ab", 100)


def test_files_load_across_packages(corpus, tmp_path):
    j = JBPE.train(corpus[:10_000], 300)
    j.save(str(tmp_path / "jax.json"))
    mine = BPETokenizer.load(str(tmp_path / "jax.json"))
    assert mine.merges == j.merges
    mine.save(str(tmp_path / "port.json"))
    assert JBPE.load(str(tmp_path / "port.json")).merges == j.merges
    (tmp_path / "bad.json").write_text(json.dumps({"format": "x",
                                                   "merges": []}))
    with pytest.raises(ValueError, match="format"):
        BPETokenizer.load(str(tmp_path / "bad.json"))


def _bytelm_args(**kw):
    args = dict(device="cpu", steps=12, batch=4, seq=32, dim=32, depth=1,
                heads=2, lr=3e-3, bf16=False, eval_every=6,
                sample_bytes=12, bpe=0, packed=False)
    args.update(kw)
    return [f"--{k.replace('_', '-')}" + ("" if v is True else f"={v}")
            for k, v in args.items() if v is not False]


@pytest.mark.parametrize("kw", [dict(), dict(bpe=300), dict(packed=True),
                                dict(bpe=280, packed=True)])
def test_train_bytelm_runs_on_the_cpu(kw, capsys):
    out = train_bytelm.main(_bytelm_args(**kw))
    text = capsys.readouterr().out
    assert np.isfinite(out["train_bpb"]) and np.isfinite(out["val_bpb"])
    assert out["sample"].startswith("## Design")
    assert "--- sample ---" in text and "step    12" in text
    assert out["vocab"] == (kw.get("bpe") or 256)
    if kw.get("packed"):
        assert "packed:" in text


def test_bytelm_loss_and_generation_match_jax():
    """The example's window loss against JAX's on the same weights and
    batch (f32, 1e-5), and its greedy continuation against JAX's
    ``generate``."""
    cfg = dict(vocab_size=256, dim=32, depth=2, num_heads=2, max_seq=32,
               rope=True)
    jmodel = jmodels.TinyGPT(**cfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    model = load_jax_params(TinyGPT(**cfg), jax.tree.map(np.asarray,
                                                         params))
    c = torch.from_numpy(train_bytelm.load_corpus()).long()
    w = train_bytelm.window_batch(c, 4, 31, torch.Generator().manual_seed(0))
    logits = jmodel.apply(params, jnp.asarray(w[:, :-1].numpy()))
    logp = jax.nn.log_softmax(logits, -1)
    want = -jnp.mean(jnp.take_along_axis(
        logp, jnp.asarray(w[:, 1:, None].numpy()), -1))
    with torch.no_grad():
        got = train_bytelm.window_loss(model, w)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    pids = list(train_bytelm.PROMPT)
    out = model.generate(torch.tensor([pids]), 16)
    ref = jmodel.generate(params, jnp.asarray([pids]), 16)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_train_tinylm_generation_tail(capsys):
    """The example's generation tail runs after training, and its scores
    are those of JAX's greedy tokens on the same weights and prompts."""
    train_tinylm.main(["--device", "cpu", "--steps", "8", "--length", "6",
                       "--eval-every", "4", "--dim", "32"])
    assert "generate: token acc" in capsys.readouterr().out
    args = argparse.Namespace(length=6)
    cfg = dict(vocab_size=12, dim=32, depth=2, num_heads=2, max_seq=14)
    jmodel = jmodels.TinyGPT(**cfg)
    params = jmodel.init(jax.random.PRNGKey(3))
    model = load_jax_params(TinyGPT(**cfg), jax.tree.map(np.asarray,
                                                         params))
    tok_acc, seq_acc, rate = train_tinylm.generation(model, args, n=8)
    toks, _, _ = sort_task_batch(8, 6, generator=torch.Generator()
                                 .manual_seed(99))
    ref = np.asarray(jmodel.generate(params, jnp.asarray(toks[:, :8]
                                                         .numpy()), 6))
    hits = ref[:, 8:] == toks[:, 8:].numpy()
    assert tok_acc == pytest.approx(hits.mean())
    assert seq_acc == pytest.approx(hits.all(1).mean())
    assert rate > 0
