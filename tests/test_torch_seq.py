"""The sort task and the masked next-token loss
(taper_tpu_torch/data/seq.py) against the JAX package's
(taper_tpu/data/seq.py).

``masked_token_loss`` takes the same numpy logits on both sides (tolerance
1e-6: the same f32 formulas); ``sort_task_batch`` draws its digits from a
``torch.Generator``, so its structure is checked rather than its bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taper_tpu.data import seq as jseq
from taper_tpu_torch.data import seq

TOL = 1e-6


@pytest.mark.parametrize("z_loss", [0.0, 1e-2])
@pytest.mark.parametrize("mask_shape", ["row", "full"])
def test_masked_token_loss_matches_jax(z_loss, mask_shape):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 10, 12)) * 3).astype(np.float32)
    targets = rng.integers(0, 12, (3, 10))
    mask = (rng.random(10 if mask_shape == "row" else (3, 10))
            < 0.6).astype(np.float32)
    ref_loss, ref_acc = jseq.masked_token_loss(
        jnp.asarray(logits), jnp.asarray(targets, jnp.int32),
        jnp.asarray(mask), z_loss=z_loss)
    loss, acc = seq.masked_token_loss(torch.from_numpy(logits),
                                      torch.from_numpy(targets),
                                      torch.from_numpy(mask), z_loss=z_loss)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=TOL)
    np.testing.assert_allclose(float(acc), float(ref_acc), rtol=TOL)


def test_masked_token_loss_grad_matches_softmax_minus_onehot():
    logits = torch.randn(2, 5, 7, generator=torch.Generator().manual_seed(1),
                         requires_grad=True)
    targets = torch.randint(0, 7, (2, 5),
                            generator=torch.Generator().manual_seed(2))
    mask = torch.tensor([0.0, 1.0, 1.0, 0.0, 1.0])
    seq.masked_token_loss(logits, targets, mask)[0].backward()
    onehot = torch.nn.functional.one_hot(targets, 7).float()
    expect = (torch.softmax(logits.detach(), -1) - onehot) \
        * mask[None, :, None] / 6.0
    torch.testing.assert_close(logits.grad, expect)


def test_empty_mask_gives_zero_not_nan():
    loss, acc = seq.masked_token_loss(torch.zeros(1, 4, 3),
                                      torch.zeros(1, 4, dtype=torch.int64),
                                      torch.zeros(4))
    assert float(loss) == 0.0 and float(acc) == 0.0


@pytest.mark.parametrize("length", [7, 63])
def test_sort_task_batch_structure(length):
    base = 10
    gen = torch.Generator().manual_seed(3)
    toks, tgts, mask = seq.sort_task_batch(5, length, base, generator=gen)
    assert toks.shape == tgts.shape == (5, 2 * length + 2)
    assert toks.dtype == torch.int64 and mask.dtype == torch.float32
    assert seq.sort_task_vocab(base) == base + 2
    assert (toks[:, 0] == base + 1).all()                  # BOS
    assert (toks[:, length + 1] == base).all()             # SEP
    digits, tail = toks[:, 1:length + 1], toks[:, length + 2:]
    assert ((digits >= 0) & (digits < base)).all()
    assert torch.equal(tail, torch.sort(digits, 1).values)
    assert torch.equal(tgts[:, :-1], toks[:, 1:])
    assert (tgts[:, -1] == base + 1).all()
    expect = np.zeros(2 * length + 2, np.float32)
    expect[length + 1:2 * length + 1] = 1.0
    np.testing.assert_array_equal(mask.numpy(), expect)
    # the JAX package's batch has the same mask and layout
    jtoks, _, jmask = jseq.sort_task_batch(jax.random.PRNGKey(0), 5, length,
                                           base)
    np.testing.assert_array_equal(np.asarray(jmask), expect)
    assert jtoks.shape == toks.shape


def test_sort_task_batch_is_reproducible_from_the_generator():
    a = seq.sort_task_batch(4, 9, generator=torch.Generator().manual_seed(5))
    b = seq.sort_task_batch(4, 9, generator=torch.Generator().manual_seed(5))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
