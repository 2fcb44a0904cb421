"""The gradients of the port's flash attention (taper_tpu_torch/ops/
attention.py: ``attention``, ``attention_bshd``) against ``jax.vjp`` of the
JAX package's Pallas flash kernels (taper_tpu/ops/pallas/attention.py:
``flash_attention``, ``flash_attention_bshd``, interpreted on the CPU), and
its logsumexp and bf16 forward against the same kernels.

On the CPU the port's autograd Function runs its plain versions: the
forward ``attention_lse_reference`` and the backward
``flash_bwd_reference``, which are the formulas its CUDA kernels K5/K8 and
K6/K7 compute.  Autograd of ``attention_reference`` is held against JAX
too, as an independent derivation.  Inputs come from numpy with a fixed
seed.  Tolerance 1e-5 in f32: the interpreter runs exact f32 dots
(attention.py:91-92); the two sides differ in summation order and in the
exponent's base.  bf16: 1e-2, both sides round the softmax weights and the
output to 8 bits, at other points.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taper_tpu.ops.pallas.attention import (
    flash_attention, flash_attention_bshd, flash_attention_lse)
from taper_tpu_torch.ops import backend
from taper_tpu_torch.ops.attention import (
    attention, attention_bshd, attention_lse_reference, attention_reference,
    flash_bwd_reference)

torch.set_num_threads(1)

TOL = 1e-5


def _arrays(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _torch_vjp(fn, arrays, ct):
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    out = fn(*leaves)
    (out * torch.from_numpy(ct)).sum().backward()
    return [out.detach().numpy()] + [t.grad.numpy() for t in leaves]


def _jax_vjp(fn, arrays, ct):
    out, vjp = jax.vjp(fn, *map(jnp.asarray, arrays))
    return [np.asarray(out)] + [np.asarray(g) for g in vjp(jnp.asarray(ct))]


def _assert_close(port, ref, tol=TOL):
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        np.testing.assert_allclose(p, r, rtol=tol, atol=tol)


@pytest.mark.parametrize("hkv", [4, 2, 1])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [128, 256])
def test_attention_grads_match_jax_flash_vjp(s, d, causal, hkv):
    q, k, v, ct = _arrays([(1, 4, s, d), (1, hkv, s, d), (1, hkv, s, d),
                           (1, 4, s, d)], seed=s + d + hkv + causal)
    ref = _jax_vjp(lambda *t: flash_attention(*t, causal=causal),
                   [q, k, v], ct)
    backend.reset_launch_counts()
    _assert_close(_torch_vjp(lambda *t: attention(*t, causal=causal),
                             [q, k, v], ct), ref)
    assert not any(backend.launch_counts().values())   # the CPU path
    _assert_close(_torch_vjp(
        lambda *t: attention_reference(*t, causal=causal), [q, k, v], ct),
        ref)


@pytest.mark.parametrize("hkv", [4, 1])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [128, 256])
def test_attention_bshd_grads_match_jax_flash_vjp(s, causal, hkv):
    d = 128
    q, k, v, ct = _arrays([(1, s, 4 * d), (1, s, hkv * d), (1, s, hkv * d),
                           (1, s, 4 * d)], seed=s + hkv + causal)
    ref = _jax_vjp(lambda *t: flash_attention_bshd(*t, 4, causal=causal),
                   [q, k, v], ct)
    _assert_close(_torch_vjp(lambda *t: attention_bshd(*t, 4, causal=causal),
                             [q, k, v], ct), ref)


def test_flash_bwd_reference_exports_delta():
    """delta = rowsum(dO * O), per (batch * head, row)."""
    q, k, v, do = map(torch.from_numpy, _arrays(
        [(2, 4, 9, 8), (2, 2, 9, 8), (2, 2, 9, 8), (2, 4, 9, 8)], seed=3))
    o, lse = attention_lse_reference(q, k, v, causal=True, scale=0.3)
    *_, delta = flash_bwd_reference(q, k, v, o, lse, do, True, 0.3)
    torch.testing.assert_close(delta, (do * o).sum(-1).reshape(8, 9))


@pytest.mark.parametrize("causal", [True, False])
def test_lse_matches_jax_flash_attention_lse(causal):
    q, k, v = _arrays([(2, 4, 128, 64), (2, 2, 128, 64), (2, 2, 128, 64)],
                      seed=7 + causal)
    o_ref, lse_ref = flash_attention_lse(*map(jnp.asarray, (q, k, v)),
                                         causal=causal)
    o, lse = attention_lse_reference(*map(torch.from_numpy, (q, k, v)),
                                     causal=causal)
    assert tuple(lse.shape) == (8, 128) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_bf16_forward_matches_jax_bound_kernel(layout):
    """bf16 causal inputs take JAX's bound-max kernel (K8,
    attention.py:1155-1157), interpreted here."""
    d = 128
    if layout == "bhsd":
        shapes = [(1, 4, 256, d), (1, 2, 256, d), (1, 2, 256, d)]
        jfn = lambda *t: flash_attention(*t, causal=True)
        tfn = lambda *t: attention(*t, causal=True)
    else:
        shapes = [(1, 256, 4 * d), (1, 256, 2 * d), (1, 256, 2 * d)]
        jfn = lambda *t: flash_attention_bshd(*t, 4, causal=True)
        tfn = lambda *t: attention_bshd(*t, 4, causal=True)
    arrays = _arrays(shapes, seed=11)
    ref = jfn(*(jnp.asarray(a, jnp.bfloat16) for a in arrays))
    out = tfn(*(torch.from_numpy(a).to(torch.bfloat16) for a in arrays))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), rtol=1e-2,
                               atol=1e-2)


def test_attention_bshd_rejects_bad_shapes():
    x = torch.zeros(1, 8, 24)
    with pytest.raises(ValueError, match="heads"):
        attention_bshd(x, x, x, 5)
    with pytest.raises(ValueError, match="match"):
        attention_bshd(x, torch.zeros(1, 8, 20), torch.zeros(1, 8, 20), 2)
