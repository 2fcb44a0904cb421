"""The GEMM's backward modes and the gradients of ``linear``,
``linear_nb`` and ``matmul`` (taper_tpu_torch/ops/gemm.py) against the JAX
package's Pallas GEMM and its custom VJPs (taper_tpu/ops/pallas/gemm.py,
Pallas interpreted on the CPU).

Inputs come from numpy with a fixed seed and go through both packages; on
the CPU the port runs its plain versions through the same autograd
Functions that run the kernels on the card.  Tolerance 1e-5: both sides
sum f32 products in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taper_tpu.ops.pallas import gemm as jg
from taper_tpu_torch.ops import backend
from taper_tpu_torch.ops import gemm as G

torch.set_num_threads(1)

TOL = 1e-5


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("mode", ["nn", "tn", "nt"])
@pytest.mark.parametrize("m,n,k", [(16, 32, 64), (5, 19, 37), (33, 10, 130)])
def test_gemm_reference_matches_jax_modes(mode, m, n, k):
    rng = np.random.default_rng(m * n + k)
    a = _rand(rng, *((m, k) if mode != "tn" else (k, m)))
    b = _rand(rng, *((n, k) if mode == "nt" else (k, n)))
    ref = np.asarray(jg._gemm(jnp.asarray(a), jnp.asarray(b), None,
                              has_bias=False, mode=mode))
    out = G.gemm(torch.from_numpy(a), torch.from_numpy(b), mode)
    assert tuple(out.shape) == (m, n) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=TOL, atol=TOL)


def _torch_grads(fn, arrays, ct):
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    out = fn(*leaves)
    (out * torch.from_numpy(ct)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in leaves]


def _jax_grads(fn, arrays, ct):
    args = [jnp.asarray(a) for a in arrays]
    out, vjp = jax.vjp(fn, *args)
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(ct))]


def _assert_same(port, ref):
    (out, grads), (ref_out, ref_grads) = port, ref
    np.testing.assert_allclose(out, ref_out, rtol=TOL, atol=TOL)
    assert len(grads) == len(ref_grads)
    for g, r in zip(grads, ref_grads):
        np.testing.assert_allclose(g, r, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("activation", ["none", "relu", "sigmoid"])
@pytest.mark.parametrize("bias", [True, False])
def test_linear_grads_match_jax_vjp(activation, bias):
    rng = np.random.default_rng(3)
    x, w, b = _rand(rng, 12, 40), _rand(rng, 24, 40, scale=0.2), \
        _rand(rng, 24)
    ct = _rand(rng, 12, 24)
    if bias:
        arrays = [x, w, b]
        port = lambda *t: G.linear(*t, activation)
        ref = lambda *t: jg.linear(*t, activation)
    else:
        arrays = [x, w]
        port = lambda *t: G.linear_nb(*t, activation)
        ref = lambda *t: jg.linear_nb(*t, activation)
    _assert_same(_torch_grads(port, arrays, ct),
                 _jax_grads(ref, arrays, ct))


@pytest.mark.parametrize("bias", [True, False])
def test_bf16_linear_grads_match_jax_vjp(bias):
    """bf16 operands (the transformer's trunk): f32 output; the cotangent
    is cast to bf16 before modes nn and tn, whose f32 results are cast back
    to bf16 (gemm.py:255-272).  Both sides form the same exact products in
    f32 and differ in summation order, which can move a bf16 rounding by
    one unit (2^-8): 1e-2."""
    rng = np.random.default_rng(8)
    x, w, b = _rand(rng, 24, 64), _rand(rng, 48, 64, scale=0.2), \
        _rand(rng, 48)
    ct = _rand(rng, 24, 48)
    arrays = [x, w, b] if bias else [x, w]
    port = (lambda *t: G.linear(*t, "none")) if bias else \
        (lambda *t: G.linear_nb(*t, "none"))
    ref = (lambda *t: jg.linear(*t, "none")) if bias else \
        (lambda *t: jg.linear_nb(*t, "none"))
    leaves = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_(True)
              for a in arrays]
    out = port(*leaves)
    (out * torch.from_numpy(ct)).sum().backward()
    ref_out, vjp = jax.vjp(ref, *(jnp.asarray(a, jnp.bfloat16)
                                  for a in arrays))
    ref_grads = vjp(jnp.asarray(ct))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out),
                               rtol=TOL, atol=TOL)
    for t, r in zip(leaves, ref_grads):
        assert t.grad.dtype == torch.bfloat16
        np.testing.assert_allclose(t.grad.float().numpy(),
                                   np.asarray(r, np.float32), rtol=1e-2,
                                   atol=1e-2)


def test_relu_grad_masks_where_the_output_is_zero():
    """The relu mask comes from the saved output (y > 0), as the JAX VJP
    takes it, including pre-activations that are exactly 0."""
    x = np.array([[1.0, -1.0], [0.0, 0.0]], np.float32)
    w = np.eye(2, dtype=np.float32)
    b = np.zeros(2, np.float32)
    ct = np.ones((2, 2), np.float32)
    _assert_same(_torch_grads(lambda *t: G.linear(*t, "relu"), [x, w, b], ct),
                 _jax_grads(lambda *t: jg.linear(*t, "relu"), [x, w, b], ct))


@pytest.mark.parametrize("m,k,n", [(8, 16, 12), (3, 7, 5)])
def test_matmul_grads_match_jax_vjp(m, k, n):
    rng = np.random.default_rng(m + k + n)
    a, b, ct = _rand(rng, m, k), _rand(rng, k, n), _rand(rng, m, n)
    _assert_same(_torch_grads(G.matmul, [a, b], ct),
                 _jax_grads(jg.matmul, [a, b], ct))


def test_ops_linear_takes_the_jax_signature():
    from taper_tpu_torch import ops

    rng = np.random.default_rng(4)
    x, w = torch.from_numpy(_rand(rng, 4, 6)), torch.from_numpy(
        _rand(rng, 3, 6))
    y = ops.linear(x, w, activation=torch.relu)
    assert torch.equal(y, G.linear_nb(x, w, "relu"))
    with pytest.raises(ValueError, match="activation"):
        ops.linear(x, w, activation=torch.tanh)


def test_input_grad_skipped_when_not_needed():
    """dX is not computed for an input that needs no grad (the data)."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(_rand(rng, 4, 6))
    w = torch.from_numpy(_rand(rng, 3, 6)).requires_grad_(True)
    G.linear(x, w, None, "relu").sum().backward()
    assert x.grad is None and w.grad is not None


def test_cpu_backward_counts_no_launch():
    rng = np.random.default_rng(6)
    backend.reset_launch_counts()
    _torch_grads(lambda *t: G.linear(*t, "sigmoid"),
                 [_rand(rng, 4, 6), _rand(rng, 3, 6), _rand(rng, 3)],
                 _rand(rng, 4, 3))
    assert not any(backend.launch_counts().values())


def test_gemm_rejects_operands_that_do_not_contract():
    a = torch.zeros(4, 6)
    with pytest.raises(ValueError, match="contract"):
        G.gemm(a, torch.zeros(5, 3), "nn")
    with pytest.raises(ValueError, match="mode"):
        G.gemm(a, torch.zeros(6, 3), "tt")
