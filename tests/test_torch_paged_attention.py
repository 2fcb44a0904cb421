"""Port of paged decode attention and the pool writes
(taper_tpu_torch/ops/paged_attention.py) against the JAX package's
(taper_tpu/ops/pallas/paged_attention.py): the Pallas kernel
(``impl=None``, interpreted on the CPU) and the pool scatters.

Inputs come from numpy with a fixed seed.  Tolerance 2e-5, the bound the
JAX package's own kernel-vs-oracle test uses at f32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taper_tpu.ops.pallas import paged_attention as JPA
from taper_tpu_torch.ops import paged_attention as PA

torch.set_num_threads(1)

TOL = 2e-5


def _case(b=3, kvh=2, g=2, d=16, bs=8, mb=4, seed=0):
    """Random pools and a valid fragmented layout: slots own distinct,
    shuffled blocks; lengths include 1 and a block boundary."""
    rng = np.random.default_rng(seed)
    n_blocks = b * mb + 2
    q = rng.standard_normal((b, kvh, g, d)).astype(np.float32)
    kp = rng.standard_normal((n_blocks, kvh, bs, d)).astype(np.float32)
    vp = rng.standard_normal((n_blocks, kvh, bs, d)).astype(np.float32)
    tables = rng.permutation(n_blocks)[:b * mb].reshape(b, mb)
    lengths = rng.integers(1, mb * bs + 1, b)
    lengths[0], lengths[-1] = 1, bs
    return q, kp, vp, tables.astype(np.int32), lengths.astype(np.int32)


@pytest.mark.parametrize("g", [1, 2, 4])
def test_paged_decode_matches_jax_pallas_kernel(g):
    q, kp, vp, tb, ln = _case(g=g, seed=g)
    scale = q.shape[-1] ** -0.5
    ref = JPA.paged_decode_attention(*map(jnp.asarray, (q, kp, vp, tb, ln)),
                                     scale=scale, impl=None)
    out = PA.paged_decode_attention(*map(torch.from_numpy,
                                         (q, kp, vp, tb, ln)), scale=scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


def test_paged_decode_bf16_pools_match_jax_oracle():
    q, kp, vp, tb, ln = _case(seed=9)
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (q, kp, vp)]
    ref = JPA.paged_decode_attention(*bf, jnp.asarray(tb), jnp.asarray(ln),
                                     scale=0.25, impl="xla")
    out = PA.paged_decode_attention(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, kp, vp)),
        torch.from_numpy(tb), torch.from_numpy(ln), scale=0.25)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), rtol=1e-2,
                               atol=1e-2)


def test_blocks_past_the_length_are_never_read():
    """Poison every position a slot does not own below its length: the
    output must not move."""
    q, kp, vp, tb, ln = _case(seed=3)
    bs = kp.shape[2]
    args = lambda k, v: (torch.from_numpy(q), torch.from_numpy(k),  # noqa
                         torch.from_numpy(v), torch.from_numpy(tb),
                         torch.from_numpy(ln))
    base = PA.paged_decode_attention(*args(kp, vp), scale=0.25)
    kp2, vp2 = kp.copy(), vp.copy()
    live = np.zeros(kp.shape[:1] + kp.shape[2:3], bool)   # [n_blocks, bs]
    for i in range(tb.shape[0]):
        for p in range(ln[i]):
            live[tb[i, p // bs], p % bs] = True
    kp2[~live[:, None, :].repeat(kp.shape[1], 1)] = 1e9
    vp2[~live[:, None, :].repeat(kp.shape[1], 1)] = 1e9
    poisoned = PA.paged_decode_attention(*args(kp2, vp2), scale=0.25)
    torch.testing.assert_close(poisoned, base)


def test_paged_write_matches_jax_scatter():
    q, kp, vp, tb, _ = _case(seed=4)
    rng = np.random.default_rng(4)
    b, kvh, _, d = q.shape
    k = rng.standard_normal((b, kvh, 1, d)).astype(np.float32)
    v = rng.standard_normal((b, kvh, 1, d)).astype(np.float32)
    pos = np.array([0, 9, 31], np.int32)
    rk, rv = JPA.paged_write(*map(jnp.asarray, (kp, vp, k, v, tb, pos)))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    PA.paged_write(tk, tv, torch.from_numpy(k), torch.from_numpy(v),
                   torch.from_numpy(tb), torch.from_numpy(pos))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(rk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))


@pytest.mark.parametrize("p", [8, 13])
def test_paged_write_prefill_matches_jax_scatter(p):
    _, kp, vp, tb, _ = _case(seed=5)
    rng = np.random.default_rng(p)
    kvh, d = kp.shape[1], kp.shape[3]
    k = rng.standard_normal((kvh, p, d)).astype(np.float32)
    v = rng.standard_normal((kvh, p, d)).astype(np.float32)
    rk, rv = JPA.paged_write_prefill(*map(jnp.asarray,
                                          (kp, vp, k, v, tb[1])))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    PA.paged_write_prefill(tk, tv, torch.from_numpy(k), torch.from_numpy(v),
                           torch.from_numpy(tb[1]))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(rk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))


# -- K16's split of each row across blocks (ops.paged_attention.plan) --------

@pytest.mark.parametrize("shape,dtype,want", [
    # bench_paged_decode's and serving's pools: 16 slots x 8 KV heads, D
    # 128, bs 128, 32 table entries
    ((16, 8, 1, 128, 128, 32), torch.bfloat16, (16, 2)),
    ((16, 8, 1, 128, 128, 32), torch.int8, (16, 2)),
    # phase 17's model (f32, GQA 4 on 4 KV heads, two table entries)
    ((8, 4, 4, 128, 128, 2), torch.float32, (2, 1)),
    ((16, 8, 1, 128, 128, 7), torch.bfloat16, (4, 2)),   # no split empty
    ((16, 8, 1, 128, 128, 1), torch.bfloat16, (1, 1)),   # a narrow table
    ((3, 2, 2, 64, 8, 5), torch.float32, (1, 5)),        # small pages
    ((512, 8, 1, 128, 128, 32), torch.bfloat16, (1, 32)),  # heads fill it
    ((128, 8, 1, 128, 128, 32), torch.bfloat16, (2, 16)),  # the SM limit
])
def test_plan_splits_by_shape_and_sm_count(shape, dtype, want):
    assert PA.plan(*shape, dtype) == want


def test_plan_is_pure_and_covers_the_table():
    shapes = [(b, kvh, g, d, bs, mb, dt)
              for b in (1, 16, 300) for kvh in (1, 8) for g in (1, 8)
              for d in (64, 128) for bs in (8, 128) for mb in (1, 5, 32, 257)
              for dt in (torch.float32, torch.bfloat16, torch.int8)]
    plans = [PA.plan(*s) for s in shapes]
    assert plans == [PA.plan(*s) for s in shapes]
    for (b, kvh, g, d, bs, mb, dt), (splits, chunk) in zip(shapes, plans):
        assert splits * chunk >= mb > (splits - 1) * chunk
        if splits > 1:
            assert b * kvh * splits <= PA.SPLIT_WAVES * PA.SMS
            assert chunk * bs * 2 * d * dt.itemsize >= PA.MIN_SPLIT_BYTES
    assert {s for s, _ in plans} >= {1, 2, 4, 8, 16}
    with pytest.raises(ValueError, match="empty"):
        PA.plan(0, 8, 1, 128, 128, 32, torch.bfloat16)


def _split_case(dtype, g, d, bs=16, mb=6, seed=0):
    """Inputs over a fragmented table whose lengths hit 1, bs, bs + 1, a
    chunk of 3 entries' boundary and its neighbours, mb bs and past it."""
    rng = np.random.default_rng(seed)
    lengths = np.array([1, bs, bs + 1, 3 * bs - 1, 3 * bs, 3 * bs + 1,
                        mb * bs, mb * bs + 5], np.int32)
    b, kvh = len(lengths), 2
    n_blocks = b * mb + 1
    q = rng.standard_normal((b, kvh, g, d)).astype(np.float32)
    tables = rng.permutation(n_blocks)[:b * mb].reshape(b, mb)
    pools = []
    for _ in range(2):
        x = rng.standard_normal((n_blocks, kvh, bs, d)).astype(np.float32)
        if dtype == torch.int8:
            sc = np.maximum(np.abs(x).max(-1), 1e-8) / 127.0
            pools += [np.rint(x / sc[..., None]).astype(np.int8),
                      sc.astype(np.float32)]
        else:
            pools += [x, None]
    return q, pools, tables.astype(np.int32), lengths


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
def test_split_reference_matches_reference_and_jax(dtype, g, d):
    """``paged_decode_reference_split`` (the kernel's chunking and merge
    order) at every split of a 6-entry table against the gather-then-attend
    plain version and JAX's ``impl="xla"`` on the same numpy inputs: 1e-5
    in f32 (f32 q over f32 or int8 pools), the bf16 output's 2^-8 over bf16
    pools."""
    q, (kp, ks, vp, vs), tb, ln = _split_case(dtype, g, d, seed=g * d)
    scale = d ** -0.5
    pool = (lambda a: torch.from_numpy(a).to(torch.bfloat16)) \
        if dtype == torch.bfloat16 else torch.from_numpy
    tq = torch.from_numpy(q).to(torch.bfloat16 if dtype == torch.bfloat16
                                else torch.float32)
    args = (tq, pool(kp), pool(vp), torch.from_numpy(tb),
            torch.from_numpy(ln))
    sc = {} if ks is None else dict(k_scales=torch.from_numpy(ks),
                                    v_scales=torch.from_numpy(vs))
    ref = PA.paged_decode_reference(*args, scale=scale, **sc).float()
    jq = jnp.asarray(q, jnp.bfloat16 if dtype == torch.bfloat16
                     else jnp.float32)
    jpool = (lambda a: jnp.asarray(a, jnp.bfloat16)) \
        if dtype == torch.bfloat16 else jnp.asarray
    jsc = {} if ks is None else dict(k_scales=jnp.asarray(ks),
                                     v_scales=jnp.asarray(vs))
    jax_out = np.asarray(JPA.paged_decode_attention(
        jq, jpool(kp), jpool(vp), jnp.asarray(tb), jnp.asarray(ln),
        scale=scale, impl="xla", **jsc), np.float32)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    for splits, chunk in ((1, 6), (2, 3), (3, 2), (6, 1)):
        out = PA.paged_decode_reference_split(
            *args, scale=scale, splits=splits, chunk=chunk, **sc)
        assert out.dtype == tq.dtype and out.shape == tq.shape
        np.testing.assert_allclose(out.float().numpy(), ref.numpy(),
                                   rtol=tol, atol=tol)
        np.testing.assert_allclose(out.float().numpy(), jax_out, rtol=tol,
                                   atol=tol)
    with pytest.raises(ValueError, match="cover"):
        PA.paged_decode_reference_split(*args, scale=scale, splits=2,
                                        chunk=2, **sc)


class _Recorder:
    """Stands in for the kernel library: records each entry point's
    arguments and reports success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("taper_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.fixture
def recorder(monkeypatch):
    from taper_tpu_torch.ops import _build, backend
    rec = _Recorder()
    monkeypatch.setattr(_build, "library", lambda: rec)
    monkeypatch.setattr(_build, "stream", lambda t: 0)
    monkeypatch.setattr(backend, "on_cuda", lambda *t: True)
    backend.reset_launch_counts()
    yield rec
    backend.reset_launch_counts()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_wrapper_passes_the_planned_split(recorder, dtype):
    """The wrapper passes plan's splits and chunk after the stream, a
    workspace of heads x splits x G x (D + 2) floats where it splits and
    none where it does not, counts one launch a call and the route by
    split."""
    from taper_tpu_torch.ops import _build, backend
    name = "paged_decode_int8" if dtype == torch.int8 else "paged_decode"
    for b, mb in ((16, 32), (16, 1)):
        kvh, g, d, bs = 8, 1, 128, 128
        q = torch.zeros(b, kvh, g, d, dtype=torch.bfloat16)
        pool = torch.zeros(b * mb + 1, kvh, bs, d, dtype=dtype)
        sc = {} if dtype != torch.int8 else dict(
            k_scales=torch.zeros(pool.shape[:3]),
            v_scales=torch.zeros(pool.shape[:3]))
        tables = torch.zeros(b, mb, dtype=torch.int32)
        lengths = torch.ones(b, dtype=torch.int32)
        with torch.no_grad():
            PA.paged_decode_attention(q, pool, pool, tables, lengths,
                                      scale=0.1, **sc)
        got, args = recorder.calls[-1]
        assert got == "taper_" + name
        assert len(args) == len(_build._SIGNATURES[got])
        splits, chunk = PA.plan(b, kvh, g, d, bs, mb, dtype)
        assert args[-2:] == (splits, chunk)
        assert (args[-3] is None) == (splits == 1)
    assert backend.route_counts() == {f"split {name}": 1,
                                      f"whole {name}": 1}
    assert backend.launch_counts()[name] == 2
