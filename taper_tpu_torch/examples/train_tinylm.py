"""Train a TinyGPT causal LM on the sort task: port of
``examples/train_tinylm.py``.

    python -m taper_tpu_torch.examples.train_tinylm [--device cuda] [--bf16]

A decoder-only transformer learns to emit the sorted copy of its input
digits, a task that stays near chance (~1/10) until content-based
attention works.  The flags are the JAX example's, with these
differences:

* ``--device`` (default ``cuda``) chooses where the model runs: the port
  dispatches by the device of its tensors, CUDA tensors through the
  hand-written kernels, CPU tensors through the plain versions.  There is
  no ``--backend``: the port has no backend switch.
* ``--opt`` takes adam, adamw, lion, muon and adafactor, with JAX's
  default learning rates; ``--experts N`` gives every block an N-expert
  MoE FFN in dense mode, as JAX's example builds it.  ``--window W``
  trains with sliding-window attention over the last W positions.
* The greedy generation at the end (:func:`generation`) draws its 32
  prompts from a generator seeded 99 (JAX: ``PRNGKey(99)``).

Each step (:func:`make_step`) draws a fresh batch on the device, runs
``TinyGPT.loss``, ``loss.backward()`` and the optimizer's update; the
host reads the metrics once per evaluation.  The batches come from a
``torch.Generator``, not from ``jax.random``, so the two examples see
different digits.
"""

from __future__ import annotations

import argparse
import time

import torch

from taper_tpu_torch import optim
from taper_tpu_torch.data.seq import sort_task_batch, sort_task_vocab
from taper_tpu_torch.models import TinyGPT

LR_DEFAULTS = {"adam": 1e-3, "adamw": 1e-3, "lion": 1e-4, "muon": 0.02,
               "adafactor": 0.05}
OPTIMIZERS = {"adam": lambda lr: optim.Adam(lr, weight_decay=0.0),
              "adamw": lambda lr: optim.AdamW(lr, weight_decay=0.01),
              "lion": optim.Lion, "muon": optim.Muon,
              "adafactor": optim.Adafactor}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--heads", type=int, default=2)
    ap.add_argument("--length", type=int, default=63,
                    help="digits per sequence (S = 2*length + 2)")
    ap.add_argument("--lr", type=float, default=None,
                    help="default: per optimizer (adam/adamw 1e-3, "
                         "lion 1e-4, muon 0.02, adafactor 0.05)")
    ap.add_argument("--opt", default="adam", choices=list(LR_DEFAULTS))
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 trunk (params/softmax/logits stay f32)")
    ap.add_argument("--eval-every", type=int, default=100)
    ap.add_argument("--z-loss", type=float, default=0.0,
                    help="PaLM-style logit regularizer coefficient")
    ap.add_argument("--rope", action="store_true",
                    help="rotary position embeddings (the learned position "
                         "table is then unused)")
    ap.add_argument("--kv-heads", type=int, default=0,
                    help="GQA: number of KV heads (0 = same as --heads)")
    ap.add_argument("--window", type=int, default=0,
                    help="sliding-window attention over the last W "
                         "positions (0 = full causal)")
    ap.add_argument("--experts", type=int, default=0,
                    help="MoE: experts per FFN (0 = dense)")
    return ap.parse_args(argv)


def build(args, seed: int = 0):
    """The model on ``args.device`` (weights drawn from ``seed``) and its
    bound optimizer."""
    seq = 2 * args.length + 2
    model = TinyGPT(vocab_size=sort_task_vocab(), dim=args.dim,
                    depth=args.depth, num_heads=args.heads, max_seq=seq,
                    rope=args.rope, num_kv_heads=args.kv_heads or None,
                    window=args.window or None, n_experts=args.experts,
                    compute_dtype=torch.bfloat16 if args.bf16 else None)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    model.to(args.device)
    lr = LR_DEFAULTS[args.opt] if args.lr is None else args.lr
    opt = OPTIMIZERS[args.opt](lr)
    return model, opt.init(model.named_parameters())


def make_step(model, opt, args, generator):
    """One training step on a fresh batch drawn from ``generator`` (on the
    model's device): returns ``(loss, acc)`` as detached 0-d tensors, with
    no host sync."""
    def step():
        toks, tgts, mask = sort_task_batch(args.batch, args.length,
                                           generator=generator)
        loss, acc = model.loss(toks, tgts, mask, z_loss=args.z_loss)
        opt.zero_grad()
        loss.backward()
        opt.step()
        return loss.detach(), acc.detach()
    return step


@torch.no_grad()
def evaluate(model, args, generator):
    """Teacher-forced accuracy on one fresh batch, a 0-d tensor."""
    toks, tgts, mask = sort_task_batch(args.batch, args.length,
                                       generator=generator)
    return model.loss(toks, tgts, mask)[1]


@torch.no_grad()
def generation(model, args, n: int = 32, seed: int = 99):
    """The serving path: greedy KV-cache generation from ``[BOS] digits
    [SEP]`` prompts, scored as exact next-token match over the generated
    sorted segment.  Returns ``(token acc, whole-sequence acc, decode
    tokens/s)``."""
    dev = model.tok.w.device
    toks, _, _ = sort_task_batch(n, args.length, generator=torch.Generator(
        device=dev).manual_seed(seed))
    prompt = toks[:, :args.length + 2]
    expect = toks[:, args.length + 2:]
    t0 = time.perf_counter()
    got = model.generate(prompt, args.length)[:, args.length + 2:]
    hits = (got == expect).float()
    tok_acc, seq_acc = torch.stack(
        [hits.mean(), hits.min(1).values.mean()]).tolist()
    dt = time.perf_counter() - t0
    return tok_acc, seq_acc, n * (2 * args.length + 1) / dt


def main(argv=None) -> float:
    args = parse_args(argv)
    model, opt = build(args)
    seq = 2 * args.length + 2
    n_params = sum(p.numel() for p in model.parameters())
    print(f"TinyGPT dim={args.dim} depth={args.depth} heads={args.heads} "
          f"S={seq} vocab={sort_task_vocab()} params={n_params:,} "
          f"device={args.device} bf16={args.bf16}")
    dev = torch.device(args.device)
    step = make_step(model, opt, args,
                     torch.Generator(device=dev).manual_seed(1))
    eval_gen = torch.Generator(device=dev).manual_seed(2)
    t0 = time.perf_counter()
    done, eval_acc = 0, 0.0
    while done < args.steps:
        n = min(args.eval_every, args.steps - done)
        for _ in range(n):
            loss, acc = step()
        done += n
        # one host sync per evaluation
        loss, acc, eval_acc = torch.stack(
            [loss, acc, evaluate(model, args, eval_gen)]).tolist()
        print(f"step {done:5d}  loss {loss:.4f}  train acc {acc:.3f}  "
              f"eval acc {eval_acc:.3f}", flush=True)
    dt = time.perf_counter() - t0
    print(f"total {dt:.1f}s, {dt / args.steps * 1e3:.2f} ms/step, "
          f"{args.steps * args.batch * seq / dt:,.0f} tokens/s "
          f"(first-call set-up included)")
    if eval_acc >= 0.99:
        print("sort task SOLVED (eval acc >= 99%)")
    tok_acc, seq_acc, rate = generation(model, args)
    print(f"generate: token acc {tok_acc:.3f}, whole-sequence acc "
          f"{seq_acc:.3f} ({rate:,.0f} tokens/s decode, first call "
          f"included)")
    return eval_acc


if __name__ == "__main__":
    main()
