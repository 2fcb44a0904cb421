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
    # the CNN's layers: enough blocks for the card, never fewer pixels per
    # block than the floor
    assert CD.dw_splits(256 * 28 * 28, 5) == 53
    assert CD.dw_splits(256 * 7 * 7, 18) == 15
    assert CD.dw_splits(100, 1) == 1


def test_conv_cpu_path_counts_no_launch_and_rejects_bad_padding():
    rng, x, wt, b = _case(1, 1, 2, 3, 5, 5, (3, 3))
    backend.reset_launch_counts()
    ops.conv2d(torch.from_numpy(x), torch.from_numpy(wt), torch.from_numpy(b),
               padding=1)
    assert not any(backend.launch_counts().values())
    with pytest.raises(ValueError, match="padding"):
        CD.conv2d_direct(torch.from_numpy(x), torch.from_numpy(wt), None,
                         (3, 0))
