"""Pooling (taper_tpu_torch/ops/pool.py) against the JAX package's Pallas
pool kernel and its custom VJPs (taper_tpu/ops/pallas/pool.py, Pallas
interpreted on the CPU), and the other configurations against its XLA
versions.

Inputs come from numpy with a fixed seed and go through both packages.
Tolerance 1e-5 (a max is exact; an average sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taper_tpu import ops as jops
from taper_tpu.ops.pallas import pool as jpool
from taper_tpu_torch import ops
from taper_tpu_torch.ops import backend
from taper_tpu_torch.ops import pool as PL

torch.set_num_threads(1)

TOL = 1e-5


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


_CASES = [((2, 3, 16, 16), 2), ((2, 3, 17, 17), 2), ((2, 3, 17, 17), 3),
          ((2, 4, 7, 7), 7)]


@pytest.mark.parametrize("mode", ["max", "avg"])
@pytest.mark.parametrize("shape,k", _CASES)
def test_pool_matches_jax_pallas_kernel(shape, k, mode):
    x = _x(k, shape)
    ref = np.asarray(jpool._pool_pallas(jnp.asarray(x), kh=k, kw=k,
                                        mode=mode))
    fn = ops.max_pool2d if mode == "max" else ops.avg_pool2d
    out = fn(torch.from_numpy(x), kernel=k)
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=TOL, atol=TOL)


def _grads(x, ct, port, ref):
    xt = torch.from_numpy(x).requires_grad_(True)
    (port(xt) * torch.from_numpy(ct)).sum().backward()
    _, vjp = jax.vjp(ref, jnp.asarray(x))
    return xt.grad.numpy(), np.asarray(vjp(jnp.asarray(ct))[0])


@pytest.mark.parametrize("mode", ["max", "avg"])
@pytest.mark.parametrize("shape,k", _CASES)
def test_pool_grads_match_jax_custom_vjp(shape, k, mode):
    x = _x(k + 1, shape)
    ho = shape[2] // k
    ct = _x(k + 2, shape[:2] + (ho, ho))
    if mode == "max":
        port = lambda t: ops.max_pool2d(t, kernel=k)
        ref = lambda t: jpool._max_pool_p(t, k, k)
    else:
        port = lambda t: ops.avg_pool2d(t, kernel=k)
        ref = lambda t: jpool._avg_pool_p(t, k, k)
    g, rg = _grads(x, ct, port, ref)
    np.testing.assert_allclose(g, rg, rtol=TOL, atol=TOL)


def test_max_pool_grad_goes_to_the_first_tie():
    """Windows that tie at 0, as after a ReLU: the cotangent goes to the
    first maximum in row-major order, as XLA's select-and-scatter."""
    x = np.maximum(_x(3, (2, 2, 6, 6)), 0.0)
    x[0, 0, :2, :2] = 0.0                    # an all-zero window
    x[1, 1, 2:4, 2:4] = [[0.0, 0.5], [0.5, 0.5]]
    ct = _x(4, (2, 2, 3, 3))
    g, rg = _grads(x, ct, lambda t: ops.max_pool2d(t, kernel=2),
                   lambda t: jpool._max_pool_p(t, 2, 2))
    np.testing.assert_array_equal(g, rg)
    assert g[0, 0, 0, 0] == ct[0, 0, 0, 0] and g[0, 0, 1, 1] == 0.0
    assert g[1, 1, 2, 3] == ct[1, 1, 1, 1] and g[1, 1, 3, 3] == 0.0


@pytest.mark.parametrize("mode", ["max", "avg"])
def test_overlapping_and_padded_pools_match_jax_xla(mode):
    x = _x(5, (2, 3, 9, 9))
    kw = dict(kernel=3, stride=2, padding=1)
    with jops.use_backend("xla"):
        ref = np.asarray((jops.max_pool2d if mode == "max"
                          else jops.avg_pool2d)(jnp.asarray(x), **kw))
    out = (ops.max_pool2d if mode == "max" else ops.avg_pool2d)(
        torch.from_numpy(x), **kw)
    np.testing.assert_allclose(out.numpy(), ref, rtol=TOL, atol=TOL)


def test_pool_cpu_path_counts_no_launch():
    backend.reset_launch_counts()
    PL.max_pool2d(torch.from_numpy(_x(6, (1, 2, 4, 4))))
    assert not any(backend.launch_counts().values())
