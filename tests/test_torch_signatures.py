"""The port's signatures take every argument of the JAX package's at the
entry points below.  An argument the port cannot honour yet raises
``NotImplementedError`` naming it (``utils.not_ported``), never
``TypeError``.
"""

import inspect

import numpy as np
import pytest
import torch

from taper_tpu import ops as jops
from taper_tpu import serve as jserve
from taper_tpu import train as jtrain
from taper_tpu.nn import transformer as JT
from taper_tpu_torch import ops, optim
from taper_tpu_torch.models import TinyGPT, mnist_mlp
from taper_tpu_torch.nn import transformer as T
from taper_tpu_torch.serve import ServingEngine
from taper_tpu_torch.train import Trainer

CFG = dict(vocab_size=32, dim=32, depth=1, num_heads=4, max_seq=32)
# JAX-only arguments: its functional state (params, keys), which the port
# keeps in modules and generators
FUNCTIONAL = {"self", "params", "key"}


@pytest.mark.parametrize("jfn,fn", [
    (jserve.ServingEngine.__init__, ServingEngine.__init__),
    (jserve.ServingEngine.submit, ServingEngine.submit),
    (JT.MultiHeadAttention.__init__, T.MultiHeadAttention.__init__),
    (JT.MLPBlock.__init__, T.MLPBlock.__init__),
    (jops.attention, ops.attention),
    (jtrain.Trainer.__init__, Trainer.__init__),
    (jtrain.Trainer.fit_device, Trainer.fit_device),
    (jtrain.Trainer.fit, Trainer.fit)])
def test_port_takes_every_jax_argument(jfn, fn):
    want = set(inspect.signature(jfn).parameters) - FUNCTIONAL
    assert want <= set(inspect.signature(fn).parameters)


def test_serving_engine_paged_impl_and_adapter():
    model = TinyGPT(**CFG)
    kw = dict(pool_blocks=8, block_size=8, slots=2, prompt_pad=8)
    for impl in (None, "pallas", "xla"):        # the CPU's own oracle
        ServingEngine(model, paged_impl=impl, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="paged_impl"):
        ServingEngine(model, paged_impl="xla", device="cuda", **kw)
    with pytest.raises(ValueError, match="paged_impl"):
        ServingEngine(model, paged_impl="mosaic", device="cpu", **kw)
    eng = ServingEngine(model, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="adapter"):
        eng.submit([1, 2], 3, adapter=0)


def test_attention_and_mlp_bias():
    T.MultiHeadAttention(32, 4, bias=True)
    T.MLPBlock(32, bias=True)
    with pytest.raises(NotImplementedError, match="bias"):
        T.MultiHeadAttention(32, 4, bias=False)
    with pytest.raises(NotImplementedError, match="bias"):
        T.MLPBlock(32, bias=False)


def test_ops_attention_window_and_segment_ids():
    """Both are taken (tests/test_torch_attention_masks.py holds them
    against JAX): a window of 1 leaves each row its own key, and two
    segments attend each within itself."""
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 4, 8, generator=gen) for _ in range(3))
    out = ops.attention(q, k, v, causal=True, window=1)
    torch.testing.assert_close(out, v)
    seg = torch.tensor([[1, 1, 2, 2]], dtype=torch.int32)
    out = ops.attention(q, k, v, segment_ids=seg)
    for sl in (slice(0, 2), slice(2, 4)):
        torch.testing.assert_close(
            out[:, :, sl], ops.attention(q[:, :, sl], k[:, :, sl],
                                         v[:, :, sl]))


def test_trainer_train_uses_rng_and_save_every(tmp_path):
    """train_uses_rng is ported: the Trainer hands the model a generator
    per step (tests/test_torch_regularize.py holds the masks it draws)."""
    tr = Trainer(mnist_mlp(), optim.SGD(0.1), device="cpu",
                 train_uses_rng=True)
    assert tr.train_uses_rng
    x = np.random.default_rng(0).random((16, 784)).astype(np.float32)
    y = np.arange(16) % 10
    tr.fit_device(x, y, x, y, 2, batch_size=8, verbose=False,
                  checkpoint_path=str(tmp_path / "c.npz"), save_every=2)
    assert (tmp_path / "c.npz").exists()
