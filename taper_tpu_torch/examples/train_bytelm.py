"""Byte-level language model on the repository's own documentation: port
of ``examples/train_bytelm.py``.

    python -m taper_tpu_torch.examples.train_bytelm [--device cuda]
        [--steps 2000] [--bf16] [--bpe N] [--packed]

The corpus is the checked-in markdown (README, PARITY, SURVEY, ROUND2:
real English and tables, no download), vocab = the 256 bytes.  TinyGPT
with RoPE learns next-byte prediction on random windows (reported in
bits per byte), then samples a continuation of a prompt through
``TinyGPT.generate``.  ``--bpe N`` trains a byte-level BPE tokenizer
(``data/tokenizer.py``) to vocab N first and models its tokens (bits per
byte stay comparable: loss per token over the learned bytes per token).
``--packed`` trains on packed paragraphs (``data/packing.py``): several
blank-line documents a row under segment-masked attention with positions
restarting per document, the loss kept inside documents.

Differences from the JAX example: ``--device`` (default ``cuda``) picks
where the model runs and there is no ``--backend``; the windows and rows
come from a ``torch.Generator``, not from ``jax.random``, and the
sample's draws from a generator seeded 7 (JAX: ``PRNGKey(7)``).  Adam
runs under ``WarmupCosineLR`` as in JAX, its lr set before each step.
"""

from __future__ import annotations

import argparse
import math
import pathlib
import time

import numpy as np
import torch

from taper_tpu_torch import optim
from taper_tpu_torch.data.packing import pack_documents, packing_efficiency
from taper_tpu_torch.data.tokenizer import BPETokenizer
from taper_tpu_torch.models import TinyGPT

CORPUS_FILES = ("README.md", "PARITY.md", "SURVEY.md", "ROUND2.md")
PROMPT = b"## Design"
_LN2 = math.log(2.0)


def load_corpus(root=".") -> np.ndarray:
    """The checked-in markdown under ``root`` as int32 bytes."""
    parts = [(pathlib.Path(root) / n).read_bytes() for n in CORPUS_FILES
             if (pathlib.Path(root) / n).exists()]
    data = b"\n\n".join(parts)
    if len(data) < 20_000:
        raise SystemExit("corpus not found: run from the repository root "
                         "(needs the checked-in README.md/PARITY.md/"
                         "SURVEY.md)")
    return np.frombuffer(data, np.uint8).astype(np.int32)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--eval-every", type=int, default=250)
    ap.add_argument("--sample-bytes", type=int, default=118)
    ap.add_argument("--bpe", type=int, default=0, metavar="VOCAB",
                    help="train a BPE tokenizer to this vocab size and model "
                         "tokens instead of raw bytes")
    ap.add_argument("--packed", action="store_true",
                    help="train on packed paragraph documents "
                         "(segment-masked attention, per-doc positions)")
    return ap.parse_args(argv)


def window_batch(corpus, batch: int, seq: int, generator):
    """``batch`` random windows of ``seq + 1`` tokens of ``corpus`` (a
    tensor on the model's device)."""
    starts = torch.randint(0, corpus.shape[0] - seq - 1, (batch,),
                           generator=generator, device=corpus.device)
    return corpus[starts[:, None] + torch.arange(seq + 1,
                                                 device=corpus.device)]


def window_loss(model, w):
    """Mean next-token loss (nats) over windows ``w [B, S + 1]``."""
    mask = torch.ones(w.shape[1] - 1, device=w.device)
    return model.loss(w[:, :-1], w[:, 1:], mask)[0]


def packed_loss(model, rows, batch: int, generator):
    """Mean loss over ``batch`` random packed rows (``rows``: the packer's
    dict as tensors on the model's device)."""
    pick = torch.randint(0, rows["tokens"].shape[0], (batch,),
                         generator=generator, device=rows["tokens"].device)
    r = {k: v[pick] for k, v in rows.items()}
    return model.loss(r["tokens"], r["targets"], r["loss_mask"],
                      segment_ids=r["segment_ids"],
                      positions=r["positions"])[0]


def train(model, corpus, steps: int, *, batch: int, seq: int, lr: float,
          generator, schedule: bool = True, packed=None, val=None,
          eval_every: int = 0, report=None):
    """Adam(``lr``) over ``steps`` batches of random windows of
    ``corpus`` (or of ``packed`` rows); ``schedule``: under JAX's
    ``WarmupCosineLR(lr, steps, steps // 20, lr / 20)``.  Every
    ``eval_every`` steps (and at the end) the last step's loss and one
    batch of ``val`` windows' loss go to ``report(step, train, val)``.
    Returns the last ``(train, val)`` losses in nats (one host sync an
    evaluation)."""
    opt = optim.Adam(lr).init(model.parameters())
    lrs = (optim.WarmupCosineLR(lr, t_max=steps, warmup=steps // 20,
                                min_lr=lr * 0.05).schedule_array().tolist()
           if schedule else None)
    eval_gen = torch.Generator(device=corpus.device).manual_seed(
        int(torch.randint(0, 2 ** 31, (1,), generator=generator,
                          device=corpus.device)))
    last = (float("nan"), float("nan"))
    for i in range(steps):
        if lrs is not None:
            opt.lr = lrs[i]
        loss = (packed_loss(model, packed, batch, generator)
                if packed is not None else
                window_loss(model, window_batch(corpus, batch, seq,
                                                generator)))
        opt.zero_grad()
        loss.backward()
        opt.step()
        if (eval_every and (i + 1) % eval_every == 0) or i + 1 == steps:
            with torch.no_grad():
                vl = (window_loss(model, window_batch(val, batch, seq,
                                                      eval_gen))
                      if val is not None else loss)
            last = tuple(torch.stack([loss.detach(), vl]).tolist())
            if report is not None:
                report(i + 1, *last)
    return last


def build(vocab: int, args, max_seq=None, seed: int = 0):
    """The example's TinyGPT (RoPE) on ``args.device``, weights from
    ``seed``."""
    model = TinyGPT(vocab_size=vocab, dim=args.dim, depth=args.depth,
                    num_heads=args.heads, max_seq=max_seq or args.seq,
                    rope=True,
                    compute_dtype=torch.bfloat16 if args.bf16 else None)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(args.device)


def sample_ids(model, tok, n: int, prompt=PROMPT, temperature: float = 0.8,
               seed: int = 7) -> list:
    """The ids of ``prompt`` and of a sampled continuation (``n`` tokens,
    cut to the model's ``max_seq``) through ``TinyGPT.generate``."""
    pids = (tok.encode(prompt) if tok is not None else list(prompt))
    dev = model.tok.w.device
    n = min(n, model.max_seq - len(pids))
    out = model.generate(torch.tensor([pids], device=dev), n,
                         temperature=temperature,
                         generator=torch.Generator(device=dev)
                         .manual_seed(seed))
    return out[0].tolist()


def sample(model, tok, n: int, prompt=PROMPT, temperature: float = 0.8,
           seed: int = 7) -> str:
    """:func:`sample_ids`, decoded."""
    ids = sample_ids(model, tok, n, prompt, temperature, seed)
    if tok is not None:
        return tok.decode(ids)
    return bytes(ids).decode("utf-8", errors="replace")


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = torch.device(args.device)
    corpus = load_corpus()
    raw_all = bytes(corpus.astype(np.uint8))
    n_bytes = len(corpus)
    tok, vocab = None, 256
    if args.bpe:
        tok = BPETokenizer.train(raw_all, args.bpe)
        corpus = np.asarray(tok.encode(raw_all), np.int32)
        vocab = tok.vocab_size
        print(f"BPE: vocab {vocab}, corpus {n_bytes:,} bytes -> "
              f"{len(corpus):,} tokens "
              f"({n_bytes / len(corpus):.2f} bytes/token)")
    bytes_per_pos = n_bytes / len(corpus)
    split = int(len(corpus) * 0.9)
    train_c = torch.from_numpy(corpus[:split]).long().to(dev)
    val_c = torch.from_numpy(corpus[split:]).long().to(dev)
    print(f"corpus: {len(corpus):,} positions "
          f"(train {split:,} / val {len(corpus) - split:,})")

    model = build(vocab, args)
    print(f"params: {sum(p.numel() for p in model.parameters()):,} on "
          f"{args.device}")
    packed = None
    if args.packed:
        # paragraph documents from the train portion's raw text
        cut = int(len(raw_all) * 0.9)
        paras = [d for d in raw_all[:cut].split(b"\n\n") if len(d) >= 2]
        docs = [list(d) if tok is None else tok.encode(d) for d in paras]
        docs = [d for d in docs if len(d) >= 2]
        pk = pack_documents(docs, args.seq)
        packed = {k: torch.from_numpy(np.asarray(v)).to(dev)
                  for k, v in pk.items()}
        for k in ("tokens", "targets"):
            packed[k] = packed[k].long()
        print(f"packed: {len(docs)} paragraph docs -> "
              f"{pk['tokens'].shape[0]} rows "
              f"({packing_efficiency(pk):.1%} full)")

    scale = _LN2 * bytes_per_pos               # nats/token -> bits/byte

    def report(step, tl, vl):
        print(f"step {step:5d}  train {tl / scale:.3f} bpb  "
              f"val {vl / scale:.3f} bpb", flush=True)

    t0 = time.perf_counter()
    tl, vl = train(model, train_c, args.steps, batch=args.batch,
                   seq=args.seq, lr=args.lr,
                   generator=torch.Generator(device=dev).manual_seed(1),
                   packed=packed, val=val_c, eval_every=args.eval_every,
                   report=report)
    dt = time.perf_counter() - t0
    nbytes = args.steps * args.batch * args.seq * bytes_per_pos
    print(f"total {dt:.1f}s, {nbytes / dt:,.0f} bytes/s (first-call set-up "
          f"included)")
    text = sample(model, tok, args.sample_bytes)
    print("--- sample ---")
    print(text)
    return {"train_bpb": tl / scale, "val_bpb": vl / scale, "sample": text,
            "vocab": vocab}


if __name__ == "__main__":
    main()
