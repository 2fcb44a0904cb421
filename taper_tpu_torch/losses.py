"""Losses and classification metrics: port of ``taper_tpu/losses.py``.
Plain tensor code: autograd differentiates it, and the card runs
PyTorch's own elementwise, reduction and matrix-product kernels.

``fused_linear_cross_entropy`` (``losses.py:93-229``) is a
``torch.autograd.Function`` in place of JAX's custom VJP: both passes
stream the head in vocab chunks, so no ``[N, V]`` buffer is ever held.
Its products are plain ``torch.matmul``s, as they are plain ``jnp``
products in JAX (TF32 stays off, ``ops/backend.py``).
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


def cross_entropy_loss_smoothed(logits, targets, smoothing: float = 0.1):
    """Label-smoothed CE: the target distribution puts ``1 - smoothing``
    on the true class and spreads ``smoothing`` uniformly.  Equals
    :func:`cross_entropy_loss` at ``smoothing = 0``."""
    targets = targets.reshape(-1).long()
    logp = log_softmax(logits, axis=-1)
    nll = -logp.gather(-1, targets[:, None])[:, 0]
    uniform = -logp.mean(-1)
    return ((1.0 - smoothing) * nll + smoothing * uniform).mean()


# ---------------------------------------------------------------------------
# Fused linear + cross-entropy: the large-vocab head without [N, V] logits
# ---------------------------------------------------------------------------

def _pad_head(head, chunk: int):
    """``head [V, D]`` padded with zero rows to a multiple of ``chunk`` and
    viewed as ``[n_chunks, chunk, D]``, and V; the padded rows are masked
    to -inf logits inside both passes (``losses.py:93-103``)."""
    v = head.shape[0]
    n_chunks = -(-v // chunk)
    pad = n_chunks * chunk - v
    if pad:
        head = torch.cat([head, head.new_zeros(pad, head.shape[1])])
    return head.reshape(n_chunks, chunk, head.shape[1]), v


def _chunk_logits(x, h_c, c0: int, v: int):
    """One chunk's logits ``[N, chunk]`` as both passes compute them: the
    product at the inputs' dtype, then the f32 cast, padded columns -inf.
    The backward must repeat the forward's arithmetic exactly: the saved
    lse came from it, and p = exp(logits - lse) sums to 1 only then."""
    logits = torch.matmul(x, h_c.t()).float()
    if c0 + h_c.shape[0] > v:
        logits[:, v - c0:] = float("-inf")
    return logits


class _FusedLinearCE(torch.autograd.Function):
    """``(nll, pred, lse)`` of ``x @ head^T`` against ``targets``, chunk by
    chunk; the backward recomputes each chunk from the saved lse."""

    @staticmethod
    def forward(ctx, x, head, targets, chunk):
        n = x.shape[0]
        dt = torch.promote_types(x.dtype, head.dtype)
        xc, hc = x.to(dt), head.to(dt)
        hcs, v = _pad_head(hc, chunk)
        dev = x.device
        m = torch.full((n,), float("-inf"), device=dev)
        s = torch.zeros(n, device=dev)
        tl = torch.zeros(n, device=dev)
        best = torch.full((n,), float("-inf"), device=dev)
        besti = torch.zeros(n, dtype=torch.int64, device=dev)
        for i in range(hcs.shape[0]):
            c0 = i * chunk
            logits = _chunk_logits(xc, hcs[i], c0, v)
            m_c, b_c = logits.max(dim=1)          # first index on ties
            m_new = torch.maximum(m, m_c)
            m_safe = torch.where(torch.isfinite(m_new), m_new,
                                 torch.zeros_like(m_new))
            s = s * torch.exp(m - m_safe) + torch.exp(
                logits - m_safe[:, None]).sum(1)
            j = targets - c0
            in_chunk = (j >= 0) & (j < chunk)
            lt = logits.gather(1, j.clamp(0, chunk - 1)[:, None])[:, 0]
            tl = torch.where(in_chunk, lt, tl)
            # the earliest chunk keeps a tie: strictly greater only
            better = m_c > best
            best = torch.where(better, m_c, best)
            besti = torch.where(better, b_c + c0, besti)
            m = m_new
        lse = m + torch.log(s)
        ctx.save_for_backward(x, head, targets, lse)
        ctx.chunk = chunk
        ctx.mark_non_differentiable(besti)
        return lse - tl, besti, lse

    @staticmethod
    def backward(ctx, g_nll, _g_pred, g_lse):
        x, head, targets, lse = ctx.saved_tensors
        chunk = ctx.chunk
        n = x.shape[0]
        zeros = lse.new_zeros(n)
        g = zeros if g_nll is None else g_nll.float()
        # d lse / d logits is softmax p, so lse's cotangent adds to p's
        # coefficient (losses.py:156-159)
        gp = g if g_lse is None else g + g_lse.float()
        dt = torch.promote_types(x.dtype, head.dtype)
        xc = x.to(dt)
        hcs, v = _pad_head(head.to(dt), chunk)
        xf = x.float()
        dx = torch.zeros_like(xf)
        dh = []
        for i in range(hcs.shape[0]):
            c0 = i * chunk
            h_c = hcs[i]
            p = torch.exp(_chunk_logits(xc, h_c, c0, v) - lse[:, None])
            gd = gp[:, None] * p                       # [N, chunk]
            # (g + gl) p - g onehot: g comes off each row's target column,
            # where the chunk holds it (-0 elsewhere leaves gd as it is)
            j = targets - c0
            in_chunk = (j >= 0) & (j < chunk)
            gd.scatter_add_(1, j.clamp(0, chunk - 1)[:, None],
                            -torch.where(in_chunk, g, zeros)[:, None])
            dx += torch.matmul(gd, h_c.float())
            dh.append(torch.matmul(gd.t(), xf))
        dh = torch.cat(dh)[:head.shape[0]]
        return dx.to(x.dtype), dh.to(head.dtype), None, None


def fused_linear_cross_entropy(x, head, targets, chunk: int = 4096,
                               return_lse: bool = False):
    """Per-token NLL of ``logits = x @ head^T`` without the ``[N, V]``
    logits: ``x [N, D]``, ``head [V, D]`` (TinyGPT's layout), ``targets
    [N]`` int.  The forward keeps an online max, sum of exponentials and
    target logit over vocab chunks of ``chunk`` rows; the backward
    recomputes each chunk's logits from the saved logsumexp and
    accumulates ``dx`` (f32) and the chunk's rows of ``dhead``.  Peak
    memory is O(N * chunk) in both passes.

    Returns ``(nll [N], pred [N])``: ``pred`` is the argmax class (int64,
    not differentiable; the lowest index on ties, as JAX's).
    ``return_lse=True`` adds the per-token ``logsumexp(logits)``,
    differentiable through the same chunked backward (z-loss needs it)."""
    targets = targets.reshape(-1).long()
    nll, pred, lse = _FusedLinearCE.apply(x, head, targets, int(chunk))
    return (nll, pred, lse) if return_lse else (nll, pred)
