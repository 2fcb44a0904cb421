"""The flash kernels' routing (taper_tpu_torch/ops/attention.py
``plan_fwd`` for K8 and K5, ``plan_bwd`` for K6, K7, K10 and K11) on the
CPU, and
the CPU path of the attention ops
against the JAX package's flash kernels at the layouts the paths use.

The plans are pure functions of the dtype (and, for the forward, the
mask): the tests pin the route of every path's attention (the 170M
model, bench_packing's padded and packed batches, serving prefill, the
windowed model, the sort task), check that the wrappers count the
planned route and that a misaligned view raises before any launch (the
library replaced by a recorder, so no card is needed).  The CPU path
runs the plain versions; it is held to JAX's ``flash_attention`` and
``flash_attention_bshd`` (Pallas, interpreted) within 1e-5 in f32,
output and gradients (exact f32 on both sides in other summation orders),
and a small TinyGPT's logits in each attention layout to JAX's model on
the pallas backend within 1e-4 (the same, through two layers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taper_tpu import models as jmodels
from taper_tpu import ops as jops
from taper_tpu.ops.pallas.attention import (flash_attention,
                                            flash_attention_bshd)
from taper_tpu_torch.models import TinyGPT
from taper_tpu_torch.ops import _build, backend
from taper_tpu_torch.ops import attention as attention_fn
from taper_tpu_torch.utils.convert import load_jax_params
import importlib

A = importlib.import_module("taper_tpu_torch.ops.attention")

torch.set_num_threads(1)

BF, F32 = torch.bfloat16, torch.float32
OPS_TOL, LOGITS_TOL = 1e-5, 1e-4


def _layout(dim, heads):
    """The layout TinyGPT's attention takes (nn/transformer.py: the
    transpose-free [B, S, H*D] path at head dims that are multiples of
    128) and its head dim."""
    d = dim // heads
    return d, ("bshd" if d % 128 == 0 else "bhsd")


# (path, dtype, (dim, heads), mask, the forward's route, the backward's
# route); the forward of a masked bf16 call is K5 on wgmma, of an f32 call
# K5's FMA kernel ("exact"); serving runs no backward.  Serving prefill
# calls ops.attention on [B, H, S, D] (nn/transformer.py prefill),
# whatever the head dim.
PATHS = [
    ("170M (bench.py:141)", BF, (1024, 8), "causal", "wgmma", "wgmma"),
    ("padded (bench_packing)", BF, (512, 8), "causal", "wgmma", "wgmma"),
    ("serving prefill", BF, (1024, 8), "causal", "wgmma", None),
    ("windowed (W 512)", BF, (1024, 8), "window", "wgmma", "wgmma"),
    ("packed (segment ids)", BF, (512, 8), "segments", "wgmma", "wgmma"),
    ("sort task (f32)", F32, (128, 2), "causal", "exact", "f32"),
]


@pytest.mark.parametrize("path,dtype,dims,mask,fwd,dkv", PATHS,
                         ids=[p[0] for p in PATHS])
def test_plan_pins_the_route_of_every_path(path, dtype, dims, mask, fwd,
                                           dkv):
    d = dims[0] // dims[1]
    assert d in A.HEAD_DIMS
    assert A.plan_fwd(dtype, mask) == fwd
    if dkv is not None:
        assert A.plan_bwd(dtype) == dkv


@pytest.mark.parametrize("mask", A.MASKS)
def test_every_bf16_launch_takes_wgmma(mask):
    """The backward in bf16 runs the Hopper kernels under every mask, and
    so does the forward: K8 for plain causal attention and K5 for the
    rest, both on wgmma."""
    assert A.plan_bwd(BF) == "wgmma"
    assert A.plan_fwd(BF, mask) == "wgmma"
    assert A.uses_bound(BF, mask) == (mask == "causal")


@pytest.mark.parametrize("mask", A.MASKS)
def test_f32_keeps_k5_and_the_fma_k7(mask):
    """f32 (the sort task) has no Hopper kernel: the forward is K5 under
    every mask and the backward its FMA kernels.  A pure function: the
    same arguments, the same answer."""
    assert [A.plan_fwd(F32, mask) for _ in range(3)] == ["exact"] * 3
    assert [A.plan_bwd(F32) for _ in range(3)] == ["f32"] * 3
    assert not A.uses_bound(F32, mask)


@pytest.mark.parametrize("dtype,route", [(BF, "wgmma"), (F32, "f32")])
@pytest.mark.parametrize("mask", A.MASKS)
def test_backward_plans_depend_on_the_dtype_alone(mask, dtype, route):
    """K6, K7 and K10 in bf16 run the Hopper kernels under every mask, in
    f32 the FMA kernels; a pure function: the same argument, the same
    answer."""
    assert [A.plan_bwd(dtype) for _ in range(3)] == [route] * 3


def test_plans_refuse_unknown_masks():
    with pytest.raises(ValueError, match="mask"):
        A.plan_fwd(BF, "sliding")


def test_mask_kind():
    seg = torch.zeros(1, 4, dtype=torch.int32)
    assert A.mask_kind(True, None, None) == "causal"
    assert A.mask_kind(False, None, None) == "none"
    assert A.mask_kind(True, 8, None) == "window"
    assert A.mask_kind(False, 8, None) == "window"
    assert A.mask_kind(True, None, seg) == "segments"


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
    rec = _Recorder()
    monkeypatch.setattr(_build, "library", lambda: rec)
    monkeypatch.setattr(_build, "stream", lambda t: 0)
    monkeypatch.setattr(backend, "on_cuda", lambda *t: True)
    backend.reset_launch_counts()
    yield rec
    backend.reset_launch_counts()


def _inputs(dtype, b=2, h=4, hkv=2, s=96, d=64, layout="bhsd", seed=0):
    gen = torch.Generator().manual_seed(seed)
    if layout == "bhsd":
        shapes = [(b, h, s, d), (b, hkv, s, d), (b, hkv, s, d), (b, h, s, d)]
    else:
        shapes = [(b, s, h * d), (b, s, hkv * d), (b, s, hkv * d),
                  (b, s, h * d)]
    q, k, v, do = (torch.randn(*sh, generator=gen).to(dtype)
                   for sh in shapes)
    lse = torch.zeros(b * h, s)
    return q, k, v, do, lse, lse.clone()


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_wrappers_count_the_planned_route(recorder, layout):
    heads = None if layout == "bhsd" else 4
    q, k, v, do, lse, delta = _inputs(BF, layout=layout)
    A.flash_fwd_bound(q, k, v, scale=0.125, heads=heads)
    A.flash_dkv(q, k, v, lse, delta, do, causal=True, scale=0.125,
                heads=heads)
    A.flash_dkv(q, k, v, lse, delta, do, causal=True, scale=0.125,
                heads=heads, window=16)
    seg = torch.ones(2, 96, dtype=torch.int32)
    A.flash_dkv(q, k, v, lse, delta, do, causal=True, scale=0.125,
                heads=heads, segment_ids=seg)
    qf, kf, vf, dof, _, _ = _inputs(F32, layout=layout)
    A.flash_dkv(qf, kf, vf, lse, delta, dof, causal=True, scale=0.125,
                heads=heads)
    names = [name for name, _ in recorder.calls]
    assert names == ["taper_flash_fwd_bound"] + ["taper_flash_dkv"] * 4
    # each call passes what its C signature takes (no route argument:
    # the kernel follows from the dtype)
    for name, args in recorder.calls:
        assert len(args) == len(_build._SIGNATURES[name]), name
    dtypes = [args[-2] for _, args in recorder.calls[1:]]
    assert dtypes == [_build.DTYPES[BF]] * 3 + [_build.DTYPES[F32]]
    assert backend.route_counts() == {"wgmma flash_fwd_bound": 1,
                                      "wgmma flash_dkv": 3,
                                      "f32 flash_dkv": 1}
    counts = backend.launch_counts()
    assert counts["flash_fwd_bound"] == 1 and counts["flash_dkv"] == 4


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_backward_wrappers_count_the_planned_route(recorder, layout,
                                                   monkeypatch):
    """K6 under each mask and K10, in bf16 and f32, count the route their
    plan gives, one launch each; ``flash_bwd`` takes K10 under
    TAPER_ATTN_FUSED_BWD=1 for plain causal attention and K6 + K7 else."""
    heads = None if layout == "bhsd" else 4
    q, k, v, do, lse, delta = _inputs(BF, layout=layout)
    o = do.clone()
    seg = torch.ones(2, 96, dtype=torch.int32)
    kw = dict(scale=0.125, heads=heads)
    for mask in (dict(causal=True), dict(causal=False),
                 dict(causal=True, window=16),
                 dict(causal=True, segment_ids=seg)):
        A.flash_dq(q, k, v, o, lse, do, **kw, **mask)
    A.flash_bwd_fused(q, k, v, o, lse, do, causal=True, **kw)
    qf, kf, vf, dof, _, _ = _inputs(F32, layout=layout)
    A.flash_dq(qf, kf, vf, dof, lse, dof, causal=True, **kw)
    A.flash_bwd_fused(qf, kf, vf, dof, lse, dof, causal=True, **kw)
    names = [name for name, _ in recorder.calls]
    assert names == (["taper_flash_dq"] * 4 + ["taper_flash_bwd_fused"]
                     + ["taper_flash_dq", "taper_flash_bwd_fused"])
    for name, args in recorder.calls:
        assert len(args) == len(_build._SIGNATURES[name]), name
    dtypes = [args[-2] for _, args in recorder.calls]
    assert dtypes == [_build.DTYPES[BF]] * 5 + [_build.DTYPES[F32]] * 2
    assert backend.route_counts() == {"wgmma flash_dq": 4,
                                      "wgmma flash_bwd_fused": 1,
                                      "f32 flash_dq": 1,
                                      "f32 flash_bwd_fused": 1}
    counts = backend.launch_counts()
    assert counts["flash_dq"] == 5 and counts["flash_bwd_fused"] == 2
    # the dispatch: K10 only under the flag and only for plain causal
    backend.reset_launch_counts()
    monkeypatch.setenv("TAPER_ATTN_FUSED_BWD", "1")
    A.flash_bwd(q, k, v, o, lse, do, causal=True, **kw)
    A.flash_bwd(q, k, v, o, lse, do, causal=True, window=16, **kw)
    monkeypatch.delenv("TAPER_ATTN_FUSED_BWD")
    A.flash_bwd(q, k, v, o, lse, do, causal=True, **kw)
    assert backend.route_counts() == {"wgmma flash_bwd_fused": 1,
                                      "wgmma flash_dq": 2,
                                      "wgmma flash_dkv": 2}


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_k11_wrapper_counts_the_planned_route(recorder, layout,
                                              monkeypatch):
    """K11 (``flash_dkv_t``) in bf16 and f32, non-causal and windowed,
    counts the route plan_bwd gives, one launch a call, and returns f32
    per-query-head partials [B, H, S, D]; ``flash_bwd`` takes it under
    TAPER_ATTN_DKV_T=1 for non-causal or windowed attention and keeps K7
    for plain causal attention."""
    heads = None if layout == "bhsd" else 4
    for dtype in (BF, F32):
        q, k, v, do, lse, delta = _inputs(dtype, layout=layout)
        parts = A.flash_dkv_t(q, k, v, lse, delta, do, causal=False,
                              scale=0.125, heads=heads)
        assert all(tuple(p.shape) == (2, 4, 96, 64) and p.dtype == F32
                   for p in parts)
        A.flash_dkv_t(q, k, v, lse, delta, do, causal=True, scale=0.125,
                      heads=heads, window=16)
    names = [name for name, _ in recorder.calls]
    assert names == ["taper_flash_dkv_t"] * 4
    for name, args in recorder.calls:
        assert len(args) == len(_build._SIGNATURES[name]), name
    dtypes = [args[-2] for _, args in recorder.calls]
    assert dtypes == [_build.DTYPES[BF]] * 2 + [_build.DTYPES[F32]] * 2
    assert backend.route_counts() == {"wgmma flash_dkv_t": 2,
                                      "f32 flash_dkv_t": 2}
    assert backend.launch_counts()["flash_dkv_t"] == 4
    # the dispatch
    backend.reset_launch_counts()
    monkeypatch.setenv("TAPER_ATTN_DKV_T", "1")
    for dtype in (BF, F32):
        q, k, v, do, lse, _ = _inputs(dtype, layout=layout)
        kw = dict(scale=0.125, heads=heads)
        A.flash_bwd(q, k, v, do.clone(), lse, do, causal=False, **kw)
        A.flash_bwd(q, k, v, do.clone(), lse, do, causal=True, window=16,
                    **kw)
        A.flash_bwd(q, k, v, do.clone(), lse, do, causal=True, **kw)
    assert backend.route_counts() == {
        "wgmma flash_dq": 3, "wgmma flash_dkv_t": 2, "wgmma flash_dkv": 1,
        "f32 flash_dq": 3, "f32 flash_dkv_t": 2, "f32 flash_dkv": 1}


TRAIN_PATHS = [p for p in PATHS if p[5] is not None]


@pytest.mark.parametrize("path,dtype,dims,mask,fwd,route", TRAIN_PATHS,
                         ids=[p[0] for p in TRAIN_PATHS])
def test_every_training_path_counts_its_backward_route(
        recorder, monkeypatch, path, dtype, dims, mask, fwd, route):
    """Each training path's backward, at its dtype, head dim, layout and
    mask, counts the route plan_bwd gives: K6 then K7 by default, K10
    under TAPER_ATTN_FUSED_BWD=1 for plain causal attention only."""
    d, layout = _layout(*dims)
    heads = None if layout == "bhsd" else 4
    q, k, v, do, lse, _ = _inputs(dtype, d=d, layout=layout)
    kw = dict(causal=True, scale=d ** -0.5, heads=heads)
    if mask == "window":
        kw["window"] = 16
    if mask == "segments":
        kw["segment_ids"] = torch.ones(2, 96, dtype=torch.int32)
    split = {f"{route} flash_dq": 1, f"{route} flash_dkv": 1}
    A.flash_bwd(q, k, v, do.clone(), lse, do, **kw)
    assert backend.route_counts() == split
    backend.reset_launch_counts()
    monkeypatch.setenv("TAPER_ATTN_FUSED_BWD", "1")
    A.flash_bwd(q, k, v, do.clone(), lse, do, **kw)
    assert backend.route_counts() == (
        {f"{route} flash_bwd_fused": 1} if mask == "causal" else split)
    for name, args in recorder.calls:
        assert len(args) == len(_build._SIGNATURES[name]), name
        assert args[-2] == _build.DTYPES[dtype], name


@pytest.mark.parametrize("operand", ["q", "k", "v", "o", "do"])
def test_a_misaligned_operand_of_k6_or_k10_raises(recorder, operand):
    """TMA reads 16-byte aligned data: a view one element in raises in K6
    and K10 before any launch, whichever operand it is, and counts no
    route."""
    q, k, v, do, lse, _ = _inputs(BF)
    ops = dict(q=q, k=k, v=v, o=do.clone(), do=do)
    buf = torch.empty(ops[operand].numel() + 1, dtype=BF)
    shifted = buf[1:].view_as(ops[operand])
    shifted.copy_(ops[operand])
    ops[operand] = shifted
    args = [ops[n] for n in ("q", "k", "v", "o")] + [lse, ops["do"]]
    with pytest.raises(ValueError, match="aligned"):
        A.flash_dq(*args, causal=True, scale=0.125)
    with pytest.raises(ValueError, match="aligned"):
        A.flash_bwd_fused(*args, causal=True, scale=0.125)
    assert recorder.calls == [] and backend.route_counts() == {}


@pytest.mark.parametrize("operand", ["q", "k", "v", "do"])
def test_a_misaligned_operand_raises_rather_than_falls_back(recorder,
                                                            operand):
    """TMA reads 16-byte aligned data, and so do the WMMA/FMA kernels: a
    view one element in raises before any launch, whichever operand it
    is (the forward takes no ``do``)."""
    ops = dict(zip(("q", "k", "v", "do", "lse", "delta"), _inputs(BF)))
    buf = torch.empty(ops[operand].numel() + 1, dtype=BF)
    shifted = buf[1:].view_as(ops[operand])
    shifted.copy_(ops[operand])
    ops[operand] = shifted
    q, k, v, do, lse, delta = ops.values()
    if operand != "do":
        with pytest.raises(ValueError, match="aligned"):
            A.flash_fwd_bound(q, k, v, scale=0.125)
    with pytest.raises(ValueError, match="aligned"):
        A.flash_dkv(q, k, v, lse, delta, do, causal=True, scale=0.125)
    assert recorder.calls == [] and backend.route_counts() == {}


def test_the_cpu_path_counts_no_route():
    q, k, v, _, _, _ = _inputs(BF)
    backend.reset_launch_counts()
    attention_fn(q, k, v, causal=True)
    assert backend.route_counts() == {}
    assert not any(backend.launch_counts().values())


# -- the CPU path against JAX's interpreted flash kernels -------------------

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


# the paths' layouts at small sizes: (layout, H, Hkv, S, D)
_OPS = [("bshd", 2, 2, 256, 128), ("bshd", 4, 1, 128, 128),
        ("bhsd", 4, 2, 128, 64), ("bhsd", 2, 2, 256, 64)]


@pytest.mark.parametrize("layout,h,hkv,s,d", _OPS)
def test_cpu_path_matches_jax_flash_with_gradients(layout, h, hkv, s, d):
    if layout == "bhsd":
        shapes = [(1, h, s, d), (1, hkv, s, d), (1, hkv, s, d), (1, h, s, d)]
        jfn = lambda *t: flash_attention(*t, causal=True)
        tfn = lambda *t: A.attention(*t, causal=True)
    else:
        shapes = [(1, s, h * d), (1, s, hkv * d), (1, s, hkv * d),
                  (1, s, h * d)]
        jfn = lambda *t: flash_attention_bshd(*t, h, causal=True)
        tfn = lambda *t: A.attention_bshd(*t, h, causal=True)
    q, k, v, ct = _arrays(shapes, seed=s + h + hkv + d)
    ref = _jax_vjp(jfn, [q, k, v], ct)
    port = _torch_vjp(tfn, [q, k, v], ct)
    for p, r in zip(port, ref):
        np.testing.assert_allclose(p, r, rtol=OPS_TOL, atol=OPS_TOL)


@pytest.mark.parametrize("dim", [256, 128])   # head dim 128 (bshd), 64
def test_tinygpt_logits_match_jax_in_each_attention_layout(monkeypatch,
                                                           dim):
    monkeypatch.setenv("TAPER_FLASH_MIN", "128")
    cfg = dict(vocab_size=32, dim=dim, depth=2, num_heads=2, max_seq=128)
    jmodel = jmodels.TinyGPT(**cfg)
    params = jmodel.init(jax.random.PRNGKey(dim))
    model = load_jax_params(TinyGPT(**cfg), jax.tree.map(np.asarray, params))
    toks = np.random.default_rng(dim).integers(0, 32, (2, 128))
    with jops.use_backend("pallas"):
        ref = np.asarray(jmodel.apply(params, jnp.asarray(toks, jnp.int32)))
    with torch.no_grad():
        out = model(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(out, ref, rtol=LOGITS_TOL, atol=LOGITS_TOL)
