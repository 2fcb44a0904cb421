"""Port of the int8 KV cache pieces (taper_tpu_torch/nn/transformer.py
``kv_quantize``; taper_tpu_torch/ops/paged_attention.py scale writes and
int8 paged decode) against the JAX package's.

Inputs come from numpy with a fixed seed.  ``kv_quantize`` is held bit for
bit against JAX under ``jit``, where every serving program of the JAX
package runs it: XLA folds its ``/ 127.0`` into a multiply by the f32
reciprocal there, so an eager JAX call's scale can differ from it in the
last bit (and a code by one step, at a rounding tie); the port follows
``jit``.  Decode attention over int8 pools: 2e-5, the bound of the f32
paged tests, against the Pallas kernel (``impl=None``, interpreted) and
the gather oracle (``impl="xla"``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taper_tpu.nn import transformer as JT
from taper_tpu.ops.pallas import paged_attention as JPA
from taper_tpu_torch.nn import transformer as T
from taper_tpu_torch.ops import paged_attention as PA

torch.set_num_threads(1)

TOL = 2e-5


def _rows(shape, seed, dtype=np.float32):
    """Rows whose magnitudes span four decades, some all zero."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * rng.uniform(1e-3, 10, shape[:-1] + (1,))
    x[..., 0, :] = 0.0
    return x.astype(dtype)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_kv_quantize_equals_jax_jit_bit_for_bit(dtype):
    x = jnp.asarray(_rows((4, 3, 37, 64), seed=1), dtype)
    ref_q, ref_s = jax.jit(JT.kv_quantize)(x)
    t = torch.from_numpy(np.array(x.astype(jnp.float32)))
    q, s = T.kv_quantize(t.to(torch.bfloat16) if dtype == jnp.bfloat16
                         else t)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(ref_q))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ref_s))


def test_kv_quantize_against_eager_jax():
    """Eager JAX divides by 127 where jit multiplies by its reciprocal:
    the scales are within one ulp and the codes within one step."""
    x = jnp.asarray(_rows((8, 4, 33, 128), seed=2))
    eq, es = JT.kv_quantize(x)
    q, s = T.kv_quantize(torch.from_numpy(np.array(x)))
    np.testing.assert_array_max_ulp(s.numpy(), np.asarray(es), maxulp=1)
    assert np.abs(q.numpy().astype(int) - np.asarray(eq, int)).max() <= 1
    # zero rows keep the floor scale 1e-8 / 127 and zero codes
    assert (q[:, :, 0] == 0).all() and (s[:, :, 0] > 0).all()


def _int8_case(b=3, kvh=2, g=2, d=16, bs=8, mb=4, seed=0,
               lengths=None):
    """int8 pools (codes of JAX's kv_quantize) with their scales, and a
    fragmented layout; default lengths end at 1, at a block edge and
    mid-block."""
    rng = np.random.default_rng(seed)
    n_blocks = b * mb + 2
    q = rng.standard_normal((b, kvh, g, d)).astype(np.float32)
    pools = []
    for _ in range(2):
        codes, scales = jax.jit(JT.kv_quantize)(jnp.asarray(
            _rows((n_blocks, kvh, bs, d), seed=rng.integers(1 << 30))))
        pools += [np.array(codes), np.array(scales)]
    tables = rng.permutation(n_blocks)[:b * mb].reshape(b, mb)
    if lengths is None:
        lengths = [1, bs, 2 * bs + 3][:b]
    return (q, pools, tables.astype(np.int32),
            np.asarray(lengths, np.int32))


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("impl", [None, "xla"])
def test_int8_paged_decode_matches_jax(g, impl):
    q, (kq, ks, vq, vs), tb, ln = _int8_case(g=g, seed=g)
    scale = q.shape[-1] ** -0.5
    ref = JPA.paged_decode_attention(
        *map(jnp.asarray, (q, kq, vq, tb, ln)), scale=scale, impl=impl,
        k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
    out = PA.paged_decode_attention(
        *map(torch.from_numpy, (q, kq, vq, tb, ln)), scale=scale,
        k_scales=torch.from_numpy(ks), v_scales=torch.from_numpy(vs))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


def test_int8_paged_decode_bf16_q_matches_jax_oracle():
    q, (kq, ks, vq, vs), tb, ln = _int8_case(seed=7)
    ref = JPA.paged_decode_attention(
        jnp.asarray(q, jnp.bfloat16), *map(jnp.asarray, (kq, vq, tb, ln)),
        scale=0.25, impl="xla", k_scales=jnp.asarray(ks),
        v_scales=jnp.asarray(vs))
    out = PA.paged_decode_attention(
        torch.from_numpy(q).to(torch.bfloat16),
        *map(torch.from_numpy, (kq, vq, tb, ln)), scale=0.25,
        k_scales=torch.from_numpy(ks), v_scales=torch.from_numpy(vs))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), rtol=1e-2,
                               atol=1e-2)


def test_int8_paged_decode_refuses_mismatched_scales():
    q, (kq, ks, vq, vs), tb, ln = _int8_case(seed=8)
    t = lambda a: torch.from_numpy(a)   # noqa: E731
    args = (t(q), t(kq), t(vq), t(tb), t(ln))
    for kw in (dict(k_scales=t(ks)[:, :, :4], v_scales=t(vs)),
               dict(k_scales=t(ks), v_scales=t(vs).double()),
               dict(k_scales=t(ks)), dict()):
        with pytest.raises(ValueError, match="scales"):
            PA.paged_decode_attention(*args, scale=0.25, **kw)


def test_scale_writes_match_jax_scatters():
    _, (_, ks, _, _), tb, _ = _int8_case(seed=4)
    rng = np.random.default_rng(4)
    b, kvh = tb.shape[0], ks.shape[1]
    # a frozen row past its table's reach writes its last table entry
    pos = np.array([0, 9, 4 * 8 + 5], np.int32)
    sc = rng.uniform(0.01, 1, (b, kvh)).astype(np.float32)
    ref = JPA.paged_write_scale(*map(jnp.asarray, (ks, sc, tb,
                                                   np.minimum(pos, 31))))
    mine = torch.from_numpy(ks.copy())
    PA.paged_write_scale(mine, torch.from_numpy(sc), torch.from_numpy(tb),
                         torch.from_numpy(np.minimum(pos, 31)))
    np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))
    PA.paged_write_scale(mine, torch.from_numpy(sc), torch.from_numpy(tb),
                         torch.from_numpy(pos))
    assert mine[tb[2, -1], :, 5].tolist() == sc[2].tolist()
    for p in (8, 13):
        scp = rng.uniform(0.01, 1, (kvh, p)).astype(np.float32)
        ref = JPA.paged_write_prefill_scale(*map(jnp.asarray,
                                                 (ks, scp, tb[1])))
        mine = torch.from_numpy(ks.copy())
        PA.paged_write_prefill_scale(mine, torch.from_numpy(scp),
                                     torch.from_numpy(tb[1]))
        np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))
