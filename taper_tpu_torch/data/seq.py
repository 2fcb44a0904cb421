"""Synthetic sequence tasks for the transformer family: port of
``taper_tpu/data/seq.py``.

Sort task (a seq2seq probe the model cannot shortcut):
  tokens = [BOS] d_1 .. d_L [SEP] s_1 .. s_L
where d are i.i.d. uniform digits and s = sorted(d).  Next-token prediction
is supervised only where the target is part of the sorted segment; copying
it sorted needs content-based attention over the whole prefix, so accuracy
stays near 1/base until attention works.

The batch is drawn on the device of the ``torch.Generator`` it is given,
so a training loop makes its data where it trains, with no host copy (the
JAX package draws it inside the jitted step).  The bits differ from
``jax.random``'s; the structure is the same.
"""

from __future__ import annotations

import torch


def sort_task_vocab(base: int = 10) -> int:
    """Digits 0..base-1, SEP = base, BOS = base+1."""
    return base + 2


def sort_task_batch(batch: int, length: int, base: int = 10,
                    generator=None):
    """Returns ``(tokens [B, S], targets [B, S], mask [S])`` with
    ``S = 2 * length + 2``, on ``generator``'s device (the CPU without
    one): int64 tokens and targets, f32 mask.

    ``targets[:, j] = tokens[:, j+1]`` (the last position padded with BOS
    and masked out); ``mask[j] = 1`` iff the target at ``j`` is a
    sorted-segment digit, positions ``length+1 .. 2*length``.  (JAX's
    ``descending`` option, used only by its LoRA fine-tuning example, is
    not ported.)"""
    device = generator.device if generator is not None else None
    digits = torch.randint(0, base, (batch, length), generator=generator,
                           device=device)
    s = torch.sort(digits, dim=1).values
    sep = torch.full((batch, 1), base, dtype=torch.int64, device=device)
    bos = torch.full((batch, 1), base + 1, dtype=torch.int64, device=device)
    tokens = torch.cat([bos, digits, sep, s], dim=1)
    targets = torch.cat([tokens[:, 1:], bos], dim=1)
    pos = torch.arange(2 * length + 2, device=device)
    mask = ((pos >= length + 1) & (pos <= 2 * length)).float()
    return tokens, targets, mask


def masked_token_loss(logits, targets, mask, z_loss: float = 0.0):
    """Mean next-token cross-entropy over masked positions.

    ``logits [B, S, V]``, ``targets [B, S]`` int, ``mask [S]`` or
    ``[B, S]`` float.  Returns ``(loss, accuracy)`` over the masked set, as
    0-d f32 tensors.  ``z_loss > 0`` adds ``z_loss * mean(logsumexp^2)``
    over the masked positions (the PaLM-style logit regulariser)."""
    lf = logits.float()
    targets = targets.long()
    lse = torch.logsumexp(lf, dim=-1)
    nll = lse - lf.gather(-1, targets[..., None])[..., 0]
    m = mask.to(nll.dtype).expand_as(nll)
    denom = m.sum().clamp_min(1.0)
    loss = (nll * m).sum() / denom
    if z_loss:
        loss = loss + z_loss * (lse * lse * m).sum() / denom
    hit = (logits.detach().argmax(-1) == targets).to(m.dtype)
    return loss, (hit * m).sum() / denom
