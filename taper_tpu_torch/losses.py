"""Losses and classification metrics: port of ``taper_tpu/losses.py``
(``losses.py:27-72``).  Plain tensor code: autograd differentiates it,
and the card runs PyTorch's own elementwise and reduction kernels.

Not ported yet: ``cross_entropy_loss_smoothed`` and
``fused_linear_cross_entropy`` (they come with M2).
"""

from __future__ import annotations

import torch

_EPS = 1e-7  # the BCE clamp of the JAX package


def bce_loss(preds, targets):
    """Mean binary cross-entropy with predictions clamped to
    ``[eps, 1 - eps]``."""
    p = preds.clamp(_EPS, 1.0 - _EPS)
    return -(targets * torch.log(p)
             + (1.0 - targets) * torch.log(1.0 - p)).mean()


def mse_loss(preds, targets):
    return ((preds - targets) ** 2).mean()


def _shifted(x, axis):
    # the max shift is a constant for autograd, as JAX's stop_gradient
    return x - x.amax(dim=axis, keepdim=True).detach()


def softmax(x, axis: int = -1):
    """Max-shifted softmax."""
    e = torch.exp(_shifted(x, axis))
    return e / e.sum(dim=axis, keepdim=True)


def log_softmax(x, axis: int = -1):
    s = _shifted(x, axis)
    return s - torch.log(torch.exp(s).sum(dim=axis, keepdim=True))


def one_hot(labels, num_classes: int):
    return torch.nn.functional.one_hot(labels.long(), num_classes).float()


def cross_entropy_loss(logits, targets):
    """Mean NLL with integer class targets ``[B]`` (or ``[B, 1]``)."""
    targets = targets.reshape(-1).long()
    logp = log_softmax(logits, axis=-1)
    return -logp.gather(-1, targets[:, None]).mean()


def cross_entropy_loss_onehot(logits, onehot_targets):
    logp = log_softmax(logits, axis=-1)
    return -(onehot_targets * logp).sum(-1).mean()


def accuracy(logits, targets):
    """Fraction of argmax predictions equal to the integer labels."""
    preds = logits.argmax(-1)
    return (preds == targets.reshape(-1).to(preds.dtype)).float().mean()
