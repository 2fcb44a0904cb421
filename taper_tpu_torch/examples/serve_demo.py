"""Serving demo: train a small byte LM on the repository's own markdown,
then serve one mixed batch of prompts four ways; port of
``examples/serve_demo.py``.

    python -m taper_tpu_torch.examples.serve_demo [--device cuda]
        [--steps 1200] [--max-new 96] [--requests 8]

The model (TinyGPT with RoPE, vocab = the 256 bytes) trains through
``train_bytelm.train`` (Adam 1e-3 on random 128-byte windows).  Prompts
of 16 to 48 bytes are cut from held-out text and served greedily by

1. one ragged batched ``generate`` (one prefill, per-row positions),
2. the host-loop :class:`~taper_tpu_torch.serve.ServingEngine` (4 slots,
   a contiguous cache, decode blocks of 16),
3. :func:`~taper_tpu_torch.serve.offline_serve` (the workload known up
   front, 4 slots),
4. a two-turn chat through ``generate(return_cache=True)`` and
   ``generate_continued``: turn 2 extends turn 1's cache, which is never
   prefilled again,

asserting that every path emits the same tokens.  On the card every
decode loop replays a captured CUDA graph (``utils/graphs.py``).  Each
path runs once to warm up (its graphs captured) and once timed; the
printed rates are this run's, on its device.

Differences from the JAX example: ``--device`` (default ``cuda``) picks
where the model runs; training draws its windows from a
``torch.Generator``; the paged engine (the JAX example's ``3b``, which
pins its attention to the XLA gather oracle to match the contiguous
numbers bit for bit) is left out, since on the card the paged path is
the K16 kernel alone (``tests/test_torch_serve.py`` holds it).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from taper_tpu_torch.examples import train_bytelm
from taper_tpu_torch.models import TinyGPT
from taper_tpu_torch.serve import ServingEngine, offline_serve

PROMPT_PAD = 48
SLOTS = 4


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    ap.add_argument("--steps", type=int, default=1200)
    ap.add_argument("--max-new", type=int, default=96)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--heads", type=int, default=4)
    return ap.parse_args(argv)


def train_lm(corpus, args, dev):
    """The demo's byte LM, trained from seed 0."""
    model = TinyGPT(256, dim=args.dim, depth=args.depth,
                    num_heads=args.heads, max_seq=512, rope=True)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model = model.to(dev)
    loss, _ = train_bytelm.train(
        model, torch.from_numpy(corpus).long().to(dev), args.steps,
        batch=32, seq=128, lr=1e-3, schedule=False,
        generator=torch.Generator(device=dev).manual_seed(1))
    n = sum(p.numel() for p in model.parameters())
    print(f"trained {n / 1e6:.1f}M params, loss {loss:.3f} nats/byte",
          flush=True)
    return model.eval()


def timed(fn):
    """``fn()`` once to warm up, then once timed: (result, seconds)."""
    fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = torch.device(args.device)
    corpus = train_bytelm.load_corpus()
    model = train_lm(corpus, args, dev)

    # mixed ragged prompts cut from held-out text
    start = int(len(corpus) * 0.95)
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(args.requests):
        plen = int(rng.integers(16, PROMPT_PAD + 1))
        s = start + i * 131
        reqs.append([int(t) for t in corpus[s:s + plen]])
    padded = np.zeros((len(reqs), PROMPT_PAD), np.int64)
    lens = np.array([len(p) for p in reqs])
    for i, p in enumerate(reqs):
        padded[i, :len(p)] = p
    m = args.max_new
    rates = {}

    def show(name, seconds):
        rates[name] = len(reqs) * m / seconds
        print(f"  {name:32s} {rates[name]:9.1f} generated tokens/s",
              flush=True)

    # 1. one ragged batched generate
    prompts = torch.from_numpy(padded).to(dev)
    out, dt = timed(lambda: model.generate(
        prompts, m, prompt_lens=torch.from_numpy(lens)))
    show("batched ragged generate", dt)
    rows = out.cpu().numpy()
    refs = [rows[i, lens[i]:lens[i] + m].tolist() for i in range(len(reqs))]

    # 2. the host-loop continuous-batching engine
    eng = ServingEngine(model, slots=SLOTS, prompt_pad=PROMPT_PAD,
                        decode_block=16, device=dev)

    def engine_run():
        ids = [eng.submit(p, m) for p in reqs]
        got = eng.run()
        return [got[i] for i in ids]
    got, dt = timed(engine_run)
    assert got == refs, "engine tokens != batched generate"
    show("ServingEngine (host loop)", dt)

    # 3. the workload known up front
    (got, n_tok), dt = timed(lambda: offline_serve(
        model, padded, lens, [m] * len(reqs), slots=SLOTS, device=dev))
    assert n_tok.tolist() == [m] * len(reqs)
    assert got.tolist() == refs, "offline_serve tokens != batched generate"
    show("offline_serve", dt)

    # 4. a two-turn chat: turn 2 continues turn 1's cache
    p0 = torch.tensor([reqs[0]], device=dev)
    t1, cache = model.generate(p0, m, return_cache=True)
    assert t1[0, lens[0]:].tolist() == refs[0], "turn 1 != batched generate"
    turn2 = torch.cat([t1[:, -1:], prompts[1:2, :8]], dim=1)
    t2 = model.generate_continued(turn2, m, cache,
                                  past_len=t1.shape[1] - 1)
    text = bytes(t2[0].cpu().numpy().astype(np.uint8)).decode(
        "utf-8", errors="replace")
    print("--- turn-2 continuation (turn 1's cache reused) ---")
    print(text[:200])
    print("all serving paths emitted identical greedy tokens")
    return dict(rates=rates, tokens=refs, turn2=t2[0].tolist())


if __name__ == "__main__":
    main()
