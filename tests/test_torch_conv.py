"""Direct convolution and the conv2d dispatch (taper_tpu_torch/ops/
conv_direct.py, ops/conv.py) against the JAX package: ``conv2d_direct``
with its custom VJP (taper_tpu/ops/pallas/conv_direct.py, Pallas
interpreted on the CPU) and the pallas backend's ``conv2d`` in all-kernels
mode (``TAPER_CONV=direct``).

Inputs come from numpy with a fixed seed and go through both packages.
Tolerance 1e-5: both sides sum f32 products in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taper_tpu import ops as jops
from taper_tpu.ops.pallas import conv_direct as jcd
from taper_tpu_torch import ops
from taper_tpu_torch.ops import _build
from taper_tpu_torch.ops import backend
from taper_tpu_torch.ops import conv_direct as CD

torch.set_num_threads(1)

TOL = 1e-5


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _case(seed, n, c, o, h, w, k):
    rng = np.random.default_rng(seed)
    x = _rand(rng, n, c, h, w)
    wt = _rand(rng, o, c, *k, scale=(c * k[0] * k[1]) ** -0.5)
    b = _rand(rng, o)
    return rng, x, wt, b


def _vjp_torch(fn, arrays, ct):
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    out = fn(*leaves)
    (out * torch.from_numpy(ct)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in leaves]


def _vjp_jax(fn, arrays, ct):
    out, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in arrays])
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(ct))]


def _assert_same(port, ref):
    (out, grads), (ref_out, ref_grads) = port, ref
    assert out.shape == ref_out.shape
    np.testing.assert_allclose(out, ref_out, rtol=TOL, atol=TOL)
    for g, r in zip(grads, ref_grads):
        np.testing.assert_allclose(g, r, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("c", [1, 3, 5])
@pytest.mark.parametrize("pad", [0, 1])
@pytest.mark.parametrize("bias,activation", [(True, "relu"),
                                             (False, "none")])
def test_conv2d_direct_and_its_grads_match_jax(c, pad, bias, activation):
    rng, x, wt, b = _case(c * 10 + pad, 2, c, 4, 9, 8, (3, 3))
    pads = (pad, pad)
    ct = _rand(rng, 2, 4, 9 + 2 * pad - 2, 8 + 2 * pad - 2)
    arrays = [x, wt, b] if bias else [x, wt]
    if bias:
        port = lambda *t: CD.conv2d_direct(*t, pads, activation)
        ref = lambda *t: jcd.conv2d_direct(*t, pads, activation)
    else:
        port = lambda x_, w_: CD.conv2d_direct(x_, w_, None, pads,
                                               activation)
        ref = lambda x_, w_: jcd.conv2d_direct(x_, w_, None, pads,
                                               activation)
    _assert_same(_vjp_torch(port, arrays, ct), _vjp_jax(ref, arrays, ct))


def test_conv2d_direct_other_kernel_sizes_match_jax():
    """A 2x3 kernel with uneven padding: the flipped-weight dX and its
    complementary padding for a non-square filter."""
    rng, x, wt, b = _case(7, 2, 3, 5, 7, 6, (2, 3))
    ct = _rand(rng, 2, 5, 8, 6)
    port = lambda *t: CD.conv2d_direct(*t, (1, 1), "sigmoid")
    ref = lambda *t: jcd.conv2d_direct(*t, (1, 1), "sigmoid")
    _assert_same(_vjp_torch(port, [x, wt, b], ct),
                 _vjp_jax(ref, [x, wt, b], ct))


def test_flip_weights_matches_jax():
    rng = np.random.default_rng(0)
    w = _rand(rng, 4, 3, 2, 3)
    np.testing.assert_array_equal(
        CD.flip_weights(torch.from_numpy(w)).numpy(),
        np.asarray(jcd._flip_w(jnp.asarray(w))))


@pytest.mark.parametrize("stride,padding,groups,k", [
    (1, 1, 1, 3),     # direct route
    (1, 0, 1, 1),     # 1x1: channel-mixing GEMM
    (2, 1, 1, 3),     # strided: im2col + GEMM
    (1, 1, 2, 3),     # grouped: direct per group
])
def test_conv2d_routes_match_jax_pallas_conv2d(monkeypatch, stride, padding,
                                               groups, k):
    monkeypatch.setenv("TAPER_CONV", "direct")
    rng, x, wt, b = _case(stride * 7 + k + groups, 2, 4, 6, 8, 8, (k, k))
    wt = wt[:, :4 // groups]
    ho = (8 + 2 * padding - k) // stride + 1
    ct = _rand(rng, 2, 6, ho, ho)
    kw = dict(stride=stride, padding=padding, groups=groups)

    def ref(*t):
        with jops.use_backend("pallas"):
            return jops.conv2d(*t, activation="relu", **kw)

    port = lambda *t: ops.conv2d(*t, activation="relu", **kw)
    _assert_same(_vjp_torch(port, [x, wt, b], ct),
                 _vjp_jax(ref, [x, wt, b], ct))


def test_conv2d_relu_and_bias_free_route():
    rng, x, wt, _ = _case(3, 2, 3, 4, 6, 6, (3, 3))
    xt, wtt = torch.from_numpy(x), torch.from_numpy(wt)
    y = ops.conv2d_relu(xt, wtt, None, padding=1)
    ref = np.maximum(np.asarray(jcd.conv2d_direct(
        jnp.asarray(x), jnp.asarray(wt), None, (1, 1), "none")), 0.0)
    np.testing.assert_allclose(y.numpy(), ref, rtol=TOL, atol=TOL)


def test_conv_dw_splits_depend_on_shapes_only():
    # whole images a split, about 264 blocks over the channel groups: the
    # CNN's 32->32 layer one image a block, its 64->64 layer two channel
    # groups of two images, its 64->128 layer four groups of four images
    assert CD.dw_splits(256, 32, 32) == 256
    assert CD.dw_splits(256, 64, 64) == 128
    assert CD.dw_splits(256, 64, 128) == 64
    assert CD.dw_splits(100, 1, 1) == 100
    assert CD.dw_splits(1, 3, 5) == 1


class _Recorder:
    """Stands in for the kernel library: records each call, returns 0."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("taper_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


# the weight gradients of the CNN and ResNet-8 (n, c, o, hw)
_DW_PATH_SHAPES = [(256, 1, 32, 28), (256, 32, 32, 28), (256, 32, 64, 14),
                   (256, 64, 64, 14), (256, 64, 128, 7), (256, 3, 16, 32),
                   (256, 16, 16, 32), (256, 32, 32, 16), (256, 64, 64, 8)]


@pytest.mark.parametrize("n,c,o,hw", _DW_PATH_SHAPES)
def test_conv_dw_launch_takes_the_wrappers_channel_group(n, c, o, hw,
                                                         monkeypatch):
    """K3b's grid and plan use the channel group the wrapper splits by:
    the launch passes ``dw_channel_group`` beside ``dw_splits``, within
    the kernel's 256 threads at 8 output channels a thread, and the
    scratch holds one partial a split."""
    rec = _Recorder()
    monkeypatch.setattr(_build, "library", lambda: rec)
    monkeypatch.setattr(_build, "stream", lambda t: 0)
    monkeypatch.setattr(backend, "on_cuda", lambda *t: True)
    backend.reset_launch_counts()
    x, g = torch.zeros(n, c, hw, hw), torch.zeros(n, o, hw, hw)
    dw = CD.conv_dw(x, g, (3, 3), (1, 1))
    assert dw.shape == (o, c, 3, 3)
    [(name, args)] = rec.calls
    assert name == "taper_conv_dw"
    assert len(args) == len(_build._SIGNATURES[name])
    splits, cg = args[-3], args[-2]
    assert splits == CD.dw_splits(n, c, o)
    assert cg == CD.dw_channel_group(c, o)
    assert 1 <= cg <= c and -(-o // 8) * cg <= 256
    # the groups are balanced: none holds more than one channel over another
    groups = -(-c // cg)
    assert groups * cg - c < groups
    assert backend.launch_counts()["conv_dw"] == 1
    backend.reset_launch_counts()


@pytest.mark.parametrize("c,o,k,pad", [(3, 4, (3, 3), (1, 1)),
                                       (2, 5, (3, 3), (0, 2)),
                                       (3, 2, (2, 3), (1, 0))])
def test_conv_fwd_flipped_matches_jax_input_gradient_route(c, o, k, pad):
    """``conv_fwd(g, w, flipped=True)``, the input gradient's convolution
    without a flipped copy on CUDA, against JAX's route for it,
    ``conv2d_direct(g, _flip_w(w))``."""
    rng, _, wt, _ = _case(c + 10 * o, 2, c, o, 7, 6, k)
    g = _rand(rng, 2, o, 9, 8)
    out = CD.conv_fwd(torch.from_numpy(g), torch.from_numpy(wt), None, pad,
                      flipped=True)
    ref = jcd.conv2d_direct(jnp.asarray(g), jcd._flip_w(jnp.asarray(wt)),
                            None, pad, "none")
    assert out.shape == (2, c, *ref.shape[2:])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)
    with pytest.raises(ValueError, match=r"\[C, O, kh, kw\]"):
        CD.conv_fwd(torch.from_numpy(g[:, :1]), torch.from_numpy(wt), None,
                    pad, flipped=True)


def test_conv_cpu_path_counts_no_launch_and_rejects_bad_padding():
    rng, x, wt, b = _case(1, 1, 2, 3, 5, 5, (3, 3))
    backend.reset_launch_counts()
    ops.conv2d(torch.from_numpy(x), torch.from_numpy(wt), torch.from_numpy(b),
               padding=1)
    assert not any(backend.launch_counts().values())
    with pytest.raises(ValueError, match="padding"):
        CD.conv2d_direct(torch.from_numpy(x), torch.from_numpy(wt), None,
                         (3, 0))
