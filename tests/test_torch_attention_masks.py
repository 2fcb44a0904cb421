"""Sliding windows and segment ids in the port's flash attention
(taper_tpu_torch/ops/attention.py: ``attention``, ``attention_bshd``)
against the JAX package's Pallas flash kernels
(taper_tpu/ops/pallas/attention.py: ``flash_attention(window=,
segment_ids=)``, interpreted on the CPU), forward and ``jax.vjp``, and the
JAX package's opt-in backward kernels K10 (``TAPER_ATTN_FUSED_BWD=1``) and
K11 (``TAPER_ATTN_DKV_T=1``) against the port's plain backward, which is
their plain version.

On the CPU the port runs its plain versions (``attention_lse_reference``
and ``flash_bwd_reference`` with the masks); the CUDA kernels are held
against the same functions on the card (tests/test_torch_cuda_kernels.py).
Inputs come from numpy with a fixed seed.  Tolerance 1e-5 in f32: the
interpreter runs exact f32 dots, the two sides differ in summation order
and in the exponent's base.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taper_tpu.ops import xla as X
from taper_tpu.ops.pallas.attention import flash_attention
from taper_tpu_torch.ops import backend

# the module itself: ops/__init__.py re-exports its function "attention"
A = importlib.import_module("taper_tpu_torch.ops.attention")

torch.set_num_threads(1)

TOL = 1e-5
S, D = 256, 32


def _arrays(h, hkv, seed, s=S, d=D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for shape in
            ((1, h, s, d), (1, hkv, s, d), (1, hkv, s, d), (1, h, s, d))]


def _segments(s=S):
    """Three documents and padding (id 0) at the end; rows of the later
    documents see whole leading KV blocks of an earlier one."""
    seg = np.zeros((1, s), np.int32)
    for i, (a, z) in enumerate([(0, 140), (140, 170), (170, s - 30)]):
        seg[0, a:z] = i + 1
    return seg


def _jax_vjp(fn, arrays, ct):
    out, vjp = jax.vjp(fn, *map(jnp.asarray, arrays))
    return [np.asarray(out)] + [np.asarray(g) for g in vjp(jnp.asarray(ct))]


def _torch_vjp(fn, arrays, ct):
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    out = fn(*leaves)
    (out * torch.from_numpy(ct)).sum().backward()
    return [out.detach().numpy()] + [t.grad.numpy() for t in leaves]


def _assert_close(port, ref, tol=TOL):
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        np.testing.assert_allclose(p, r, rtol=tol, atol=tol)


@pytest.mark.parametrize("window,causal,hkv", [
    (1, True, 2), (100, True, 4), (100, False, 2), (300, True, 2),
    (100, True, 1)])
def test_window_matches_jax_flash(window, causal, hkv):
    """``window`` of 1, 100 and more than S, causal or not, MHA, GQA and
    MQA: the output and the three gradients."""
    q, k, v, ct = _arrays(4, hkv, window + hkv + causal)
    ref = _jax_vjp(lambda *t: flash_attention(*t, causal, window=window),
                   [q, k, v], ct)
    backend.reset_launch_counts()
    _assert_close(_torch_vjp(lambda *t: A.attention(
        *t, causal=causal, window=window), [q, k, v], ct), ref)
    assert not any(backend.launch_counts().values())   # the CPU path


@pytest.mark.parametrize("causal,hkv", [(True, 2), (False, 4)])
def test_segments_match_jax_flash(causal, hkv):
    q, k, v, ct = _arrays(4, hkv, 7 + hkv)
    seg = _segments()
    ref = _jax_vjp(lambda *t: flash_attention(
        *t, causal, segment_ids=jnp.asarray(seg)), [q, k, v], ct)
    _assert_close(_torch_vjp(lambda *t: A.attention(
        *t, causal=causal, segment_ids=torch.from_numpy(seg)), [q, k, v],
        ct), ref)


@pytest.mark.parametrize("mask", ["window", "segments"])
def test_masks_in_the_projection_layout_match_jax(mask):
    """``attention_bshd`` with a mask against JAX's flash on the
    transposed inputs (JAX's bshd entry takes no masks)."""
    h, hkv = 4, 2
    q, k, v, ct = _arrays(h, hkv, 21)
    kw = (dict(window=70) if mask == "window"
          else dict(segment_ids=_segments()))
    ref = _jax_vjp(lambda *t: flash_attention(
        *t, True, **{n: jnp.asarray(x) if isinstance(x, np.ndarray) else x
                     for n, x in kw.items()}), [q, k, v], ct)

    def bshd(x):
        return np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(
            1, S, -1))

    tkw = {n: (torch.from_numpy(x) if isinstance(x, np.ndarray) else x)
           for n, x in kw.items()}
    port = _torch_vjp(lambda *t: A.attention_bshd(*t, h, causal=True, **tkw),
                      [bshd(x) for x in (q, k, v)], bshd(ct))
    _assert_close([p.reshape(1, S, -1, D).transpose(0, 2, 1, 3)
                   for p in port], ref)


@pytest.mark.parametrize("kw", [dict(window=37, causal=False),
                                dict(window=5, causal=True),
                                dict(segment_ids="seg", causal=False)])
def test_plain_forward_matches_the_xla_oracle(kw):
    """The plain forward with its masks against ``taper_tpu/ops/xla.py``
    (the masks of ``xla.py:203-218``), at an S that is no multiple of
    128 and GQA."""
    q, k, v, _ = _arrays(4, 2, 3, s=75, d=16)
    seg = np.repeat(np.array([[1] * 30 + [2] * 40 + [0] * 5]), 1, 0)
    kw = {n: (seg if x == "seg" else x) for n, x in kw.items()}
    ref = X.attention(*map(jnp.asarray, (q, k, v)),
                      **{n: jnp.asarray(x) if isinstance(x, np.ndarray)
                         else x for n, x in kw.items()})
    out = A.attention_reference(
        *map(torch.from_numpy, (q, k, v)),
        **{n: torch.from_numpy(x) if isinstance(x, np.ndarray) else x
           for n, x in kw.items()})
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("flag,kw", [
    ("TAPER_ATTN_FUSED_BWD", dict(causal=True)),
    ("TAPER_ATTN_DKV_T", dict(causal=False)),
    ("TAPER_ATTN_DKV_T", dict(causal=True, window=90))])
def test_jax_opt_in_backwards_match_the_plain_backward(monkeypatch, flag,
                                                       kw):
    """JAX's K10 (fused, causal) and K11 (transposed dK/dV, non-causal or
    windowed), interpreted, against ``flash_bwd_reference``, the plain
    version of both; and the flag does nothing to the port on CPU
    tensors."""
    monkeypatch.setenv(flag, "1")
    q, k, v, ct = _arrays(4, 2, 31)
    causal, window = kw["causal"], kw.get("window")
    ref = _jax_vjp(lambda *t: flash_attention(*t, causal, window=window),
                   [q, k, v], ct)
    qt, kt, vt, dot = map(torch.from_numpy, (q, k, v, ct))
    o, lse = A.attention_lse_reference(qt, kt, vt, causal=causal,
                                       window=window)
    grads = A.flash_bwd_reference(qt, kt, vt, o, lse, dot, causal,
                                  D ** -0.5, window=window)
    _assert_close([o.numpy()] + [g.numpy() for g in grads[:3]], ref)
    backend.reset_launch_counts()
    flagged = _torch_vjp(lambda *t: A.attention(*t, **kw), [q, k, v], ct)
    assert not any(backend.launch_counts().values())
    monkeypatch.delenv(flag)
    for a, b in zip(flagged, _torch_vjp(lambda *t: A.attention(*t, **kw),
                                        [q, k, v], ct)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", [dict(causal=False),
                                dict(causal=True, window=50),
                                dict(causal=True, segment_ids="seg")])
def test_per_query_head_partials_sum_to_the_grouped_grads(kw):
    """K11's plain version: the per-query-head dK/dV partials summed over
    each group are the grouped gradients; at one head per group they are
    those gradients."""
    q, k, v, do = map(torch.from_numpy, _arrays(4, 2, 41, s=100, d=16))
    kw = {n: (torch.from_numpy(_segments(100)) if x == "seg" else x)
          for n, x in kw.items()}
    o, lse = A.attention_lse_reference(q, k, v, **kw)
    args = (q, k, v, o, lse, do, kw.pop("causal"), 0.25)
    grouped = A.flash_bwd_reference(*args, **kw)
    parts = A.flash_bwd_reference(*args, per_query_head=True, **kw)
    assert parts[1].shape == q.shape
    for g, p in zip(grouped[1:3], parts[1:3]):
        torch.testing.assert_close(p.reshape(1, 2, 2, 100, 16).sum(2), g,
                                   rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(parts[0], grouped[0], rtol=0, atol=0)


def test_bf16_causal_window_does_not_take_the_bound_kernel(monkeypatch):
    """The dispatch of the forward as on the card (``backend.on_cuda``
    made true, the kernel wrappers replaced by spies): a bf16 causal call
    goes to K8 only without a window and without segment ids, as JAX's
    ``use_bound`` (attention.py:1155); a windowed one would lose its
    window there."""
    calls = []
    monkeypatch.setattr(backend, "on_cuda", lambda *t: True)
    monkeypatch.setattr(A, "flash_fwd_bound", lambda q, k, v, **kw: (
        calls.append(("K8", kw)) or A.attention_lse_reference(
            q, k, v, causal=True, scale=kw["scale"])))
    monkeypatch.setattr(A, "flash_fwd_exact", lambda q, k, v, **kw: (
        calls.append(("K5", kw)) or A.attention_lse_reference(
            q, k, v, causal=kw["causal"], scale=kw["scale"],
            window=kw["window"], segment_ids=kw["segment_ids"])))
    q = torch.randn(1, 2, 64, 64, generator=torch.Generator().manual_seed(0)
                    ).to(torch.bfloat16)
    seg = torch.ones(1, 64, dtype=torch.int32)
    with torch.no_grad():
        A.attention(q, q, q, causal=True)
        A.attention(q, q, q, causal=True, window=8)
        A.attention(q, q, q, causal=True, segment_ids=seg)
        A.attention(q.float(), q.float(), q.float(), causal=True)
    assert [c[0] for c in calls] == ["K8", "K5", "K5", "K5"]
    assert calls[1][1]["window"] == 8
    assert calls[2][1]["segment_ids"] is not None


def test_masks_that_are_refused():
    q = torch.zeros(1, 2, 8, 16)
    seg = torch.zeros(1, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="window"):
        A.attention(q, q, q, causal=True, window=4, segment_ids=seg)
    with pytest.raises(ValueError, match="window"):
        A.attention(q, q, q, window=0)
    with pytest.raises(ValueError, match="segment_ids"):
        A.attention(q, q, q, segment_ids=torch.zeros(1, 7, dtype=torch.int32))
    with pytest.raises(ValueError, match="integers"):
        A.attention(q, q, q, segment_ids=torch.zeros(1, 8))
