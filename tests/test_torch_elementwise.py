"""The elementwise ops (taper_tpu_torch/ops/elementwise.py, K2) against
the JAX package's Pallas versions (taper_tpu/ops/pallas/elementwise.py,
interpreted on the CPU): the same numpy operands, made from a seed, go
through each op forward and through its VJP (``jax.vjp`` against
``backward`` on the port), with same-shape and broadcast operands.
Tolerance 1e-6: the same f32 formula on both sides (``fma`` rounds once
on the port's side; the products and quotients of the VJPs are the same
f32 operations).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taper_tpu.ops.pallas import elementwise as E
from taper_tpu_torch import ops
from taper_tpu_torch.ops import elementwise as PE

TOL = 1e-6

# (op, operand shapes): same shapes with a ragged size (no multiple of a
# 16-byte vector), and broadcast operands whose gradients are reduced
CASES = [
    ("relu", [(3, 5, 7)]),
    ("relu", [(2, 16, 8, 8)]),
    ("sigmoid", [(3, 5, 7)]),
    ("sigmoid", [(2, 16, 8, 8)]),
    ("add", [(3, 5, 7), (3, 5, 7)]),
    ("add", [(4, 1, 6), (5, 1)]),
    ("mul", [(3, 5, 7), (3, 5, 7)]),
    ("mul", [(2, 3, 4), (4,)]),
    ("sub", [(3, 5, 7), (3, 5, 7)]),
    ("sub", [(1, 6), (3, 1)]),
    ("div", [(3, 5, 7), (3, 5, 7)]),
    ("div", [(2, 3, 4), (3, 1)]),
    ("fma", [(3, 5, 7), (3, 5, 7), (3, 5, 7)]),
    ("fma", [(2, 3, 4), (4,), (3, 1)]),
]


def _operands(op, shapes, seed):
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    if op == "div":   # keep the divisor away from 0
        b = xs[1]
        xs[1] = (np.where(b < 0, -1.0, 1.0) * (0.5 + np.abs(b))).astype(
            np.float32)
    return xs


@pytest.mark.parametrize("op,shapes", CASES,
                         ids=[f"{op}-{len(s)}x{'-'.join(map(str, s[-1]))}"
                              for op, s in CASES])
def test_op_and_vjp_match_jax(op, shapes):
    xs = _operands(op, shapes, seed=len(shapes) + sum(map(len, shapes)))
    jfn = getattr(E, op)
    jout, vjp = jax.vjp(jfn, *map(jnp.asarray, xs))
    g = np.random.default_rng(7).standard_normal(jout.shape).astype(
        np.float32)
    jgrads = vjp(jnp.asarray(g))

    ts = [torch.from_numpy(x.copy()).requires_grad_() for x in xs]
    out = getattr(ops, op)(*ts)
    assert tuple(out.shape) == tuple(jout.shape)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=TOL, atol=TOL)
    out.backward(torch.from_numpy(g))
    for t, jg in zip(ts, jgrads):
        assert t.grad.shape == t.shape
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg),
                                   rtol=TOL, atol=TOL)


def test_scalars_take_the_tensor_dtype_and_shapes_must_agree():
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    y = ops.mul(x, 2.0)
    assert y.dtype == torch.float32 and torch.equal(y, x * 2)
    assert torch.equal(ops.fma(x, 2.0, 1.0), x * 2 + 1)
    with pytest.raises(ValueError, match="differ"):
        PE.elementwise("add", x, x.T)
    with pytest.raises(ValueError, match="operands"):
        PE.elementwise("add", x)
    with pytest.raises(RuntimeError):
        ops.add(x, torch.ones(4))


def test_plain_bf16_rounds_once_from_f32():
    rng = np.random.default_rng(3)
    a, b, c = (torch.from_numpy(rng.standard_normal(64).astype(np.float32))
               for _ in range(3))
    bf = [t.bfloat16() for t in (a, b, c)]
    out = PE.elementwise_reference("fma", *bf)
    ref = (bf[0].double() * bf[1].double() + bf[2].double()).bfloat16()
    assert out.dtype == torch.bfloat16 and torch.equal(out, ref)
    out = PE.elementwise_reference("div", *bf[:2])
    assert torch.equal(out, (bf[0].float() / bf[1].float()).bfloat16())
