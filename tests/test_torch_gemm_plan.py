"""K1's routing (taper_tpu_torch/ops/gemm.py ``plan``), its split-K plain
version, and the ``out_dtype`` epilogue, on the CPU.

``plan`` is a pure function of the shape, dtype, mode and alignment: the
tests pin the route and K split it gives at the shapes of every training
and serving path, and the properties every split must have.  The split-K
plain version sums the partial products in the kernels' fixed order; it
is held to the unsplit plain version and to the JAX package's Pallas GEMM
(interpreted on the CPU) within 1e-5, as f32 sums in different orders.
``out_dtype=bfloat16`` must give the bits of the f32 result cast with
``.to(bfloat16)``, forward and backward, so the bf16 trunk's numbers do
not change.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taper_tpu.ops.pallas import gemm as jg
from taper_tpu_torch import ops
from taper_tpu_torch.models import TinyGPT
from taper_tpu_torch.nn import transformer as T
from taper_tpu_torch.ops import backend
from taper_tpu_torch.ops import gemm as G

torch.set_num_threads(1)

BF, F32 = torch.bfloat16, torch.float32
E, TOKENS = 1024, 16384          # the 170M model's width and batch tokens
SORT_T, SORT_E = 64 * 128, 128   # the sort task: batch 64 x 128, dim 128


def _modes(t, k_in, n_out):
    """``(mode, m, n, k)`` of a projection's forward, dX and dW."""
    return (("nt", t, n_out, k_in), ("nn", t, k_in, n_out),
            ("tn", n_out, k_in, t))


# ResNet-8's patch GEMMs at batch 256: (tokens, K_in, N_out) of the two
# stride-2 3x3 convolutions, the two 1x1 stride-2 projections and the head
RESNET = ((65536, 144, 32), (65536, 16, 32), (16384, 288, 64),
          (16384, 32, 64), (256, 64, 10))
# the reference CNN's FC layers at batch 256
CNN = ((256, 128, 128), (256, 128, 64), (256, 64, 10))

# The f32 route's tiles, as (BM, BN, BK, KG): 128 x 32 for N <= 32 over
# long M (and for K under 64), 64 x 64 for wider outputs that fill the
# SMs, 64 x 32 for N = 32 over 16,384 rows, and 32 x 32 for the weight
# gradients and the batch-256 layers: the only tile that splits (two K
# groups a block), four K groups where it does not, 16 deep for K under 64
T128x32, T64, T64x32 = (128, 32, 16, 1), (64, 64, 32, 1), (64, 32, 32, 1)
T32, T32W, T32K16 = (32, 32, 64, 2), (32, 32, 64, 4), (32, 32, 16, 1)

PATH_CASES = (
    # the 170M model, bf16: every projection through wgmma; only dW at
    # (e, e) (an 8 x 8 grid of 128 x 128 tiles) splits K
    [(f"170M ({k_in},{n_out}) {mode}", mode, m, n, k, BF,
      ("wgmma", 2 if (mode, k_in, n_out) == ("tn", E, E) else 1))
     for k_in, n_out in ((E, E), (E, 4 * E), (4 * E, E))
     for mode, m, n, k in _modes(TOKENS, k_in, n_out)]
    # the sort task, f32: dW [128..512, 128..512] over 8,192 tokens splits
    # over 32 x 32 tiles to four blocks an SM; the rest fill the card
    + [(f"sort ({k_in},{n_out}) {mode}", mode, m, n, k, F32,
        ("f32", {(SORT_E, SORT_E): 32}.get((k_in, n_out), 8), T32)
        if mode == "tn" else ("f32", 1, T64))
       for k_in, n_out in ((SORT_E, SORT_E), (SORT_E, 4 * SORT_E),
                           (4 * SORT_E, SORT_E))
       for mode, m, n, k in _modes(SORT_T, k_in, n_out)]
    # ResNet-8's patch-GEMM dW over 65,536 or 16,384 rows: a few tiles,
    # many splits (the head's K of 256 is too short to split); their
    # forward and dX fill the card
    + [(f"resnet ({k_in},{n_out}) tn", "tn", n_out, k_in, t, F32,
        ("f32", splits, T32))
       for (t, k_in, n_out), splits in zip(RESNET, (103, 256, 29, 64, 1))
       if splits > 1]
    + [("resnet (64,10) tn", "tn", 10, 64, 256, F32, ("f32", 1, T32W))]
    + [(f"resnet ({k_in},{n_out}) {mode}", mode, m, n, k, F32,
        ("f32", 1, tile))
       for (t, k_in, n_out), tiles in zip(RESNET[:4], (
           (T128x32, T128x32), (T128x32, T128x32), (T64, T128x32),
           (T128x32, T64x32)))
       for (mode, m, n, k), tile in zip(_modes(t, k_in, n_out)[:2], tiles)]
    # the CNN's FC layers at batch 256: 32 x 32 tiles with four K groups
    # (16 deep, one group, for the head's dX, K = 10), K of 10 to 256 too
    # short to split
    + [(f"cnn ({k_in},{n_out}) {mode}", mode, m, n, k, F32,
        ("f32", 1, T32K16 if k < 64 else T32W))
       for t, k_in, n_out in CNN
       for mode, m, n, k in _modes(t, k_in, n_out)]
    # serving: decode at 16 slots ((e, e): a K of 1,024, too short to
    # split), the (4e, e) down projection (K split over a cluster of 4
    # blocks of 32 weight rows), the quantized-serving baseline's bf16 up
    # projection (256 blocks: no split), prefill at 512 rows
    + [("decode M=16", "nt", 16, 1024, 1024, BF, ("decode", 1)),
       ("decode M=16 down", "nt", 16, 1024, 4096, BF, ("decode", 4)),
       ("decode M=8 up", "nt", 8, 8192, 2048, BF, ("decode", 1)),
       ("prefill M=512", "nt", 512, 4096, 1024, BF, ("wgmma", 1))])


@pytest.mark.parametrize("what,mode,m,n,k,dtype,want", PATH_CASES,
                         ids=[c[0] for c in PATH_CASES])
def test_plan_at_the_path_shapes(what, mode, m, n, k, dtype, want):
    got = G.plan(m, n, k, dtype, mode, True)
    if got[0] == "f32":
        got = (*got, G.F32_TILES[G.f32_tile(m, n, k)])
    assert got == want


@pytest.mark.parametrize("mode,m,n,k,aligned,want", [
    ("nt", 5, 19, 37, False, ("decode", 1)),     # ragged, skinny: decode
    ("nn", 5, 19, 37, False, ("realign", 1)),
    ("tn", 33, 70, 130, False, ("realign", 1)),  # ragged: no TMA
    ("nt", 33, 72, 136, False, ("realign", 1)),  # a misaligned view
    ("nt", 33, 72, 136, True, ("wgmma", 1)),
    ("nn", 16, 1024, 1024, True, ("realign", 1)),  # M <= 16 off mode nt
    ("tn", 17, 1024, 1024, True, ("wgmma", 4)),  # 8 tiles, 16 K tiles
])
def test_plan_routes_ragged_misaligned_and_skinny_bf16(mode, m, n, k,
                                                       aligned, want):
    assert G.plan(m, n, k, BF, mode, aligned) == want


def _view(shape, offset=0, pad=0, dtype=BF):
    """A ``shape`` view ``offset`` elements into a buffer whose rows are
    ``pad`` elements wider than the view's."""
    r, c = shape
    buf = torch.zeros(offset + r * (c + pad), dtype=dtype)
    return buf[offset:].view(r, c + pad)[:, :c]


# (mode, a's and b's (shape, offset, pad), route, staging code): the race
# shape's three modes (K_in 1,001) and misaligned or strided views of an
# aligned shape, each operand staged alone
STAGING_CASES = [
    ("nt", ((512, 1001), 0, 0), ((1000, 1001), 0, 0), "realign", 3),
    # dX: the gradient [512, 1000] streams, the weight [1000, 1001] not
    ("nn", ((512, 1000), 0, 0), ((1000, 1001), 0, 0), "realign", 2),
    # dW: the gradient [512, 1000] streams, x [512, 1001] not
    ("tn", ((512, 1000), 0, 0), ((512, 1001), 0, 0), "realign", 2),
    ("nt", ((96, 136), 1, 0), ((80, 136), 0, 0), "realign", 1),
    ("nn", ((96, 136), 0, 0), ((136, 80), 3, 0), "realign", 2),
    ("tn", ((136, 96), 8, 0), ((136, 80), 0, 0), "wgmma", 0),
    # a row stride of whole chunks streams; another one does not
    ("nt", ((96, 136), 0, 8), ((80, 136), 0, 0), "realign", 0),
    ("nt", ((96, 136), 0, 5), ((80, 136), 0, 0), "realign", 1),
    ("nt", ((8, 136), 0, 0), ((80, 136), 0, 3), "realign", 2),
    ("nt", ((8, 136), 0, 0), ((80, 136), 1, 0), "decode", None),
]


@pytest.mark.parametrize("mode,a,b,route,code", STAGING_CASES)
def test_each_operand_is_staged_by_its_own_alignment(mode, a, b, route,
                                                     code):
    """An unaligned or strided operand sends the call to ``realign``, but
    the other operand still streams where its own rows are whole 16-byte
    chunks from an aligned base (it is not dragged through the windows);
    a view whose base is a whole chunk off stays on ``wgmma``; a strided
    operand never takes ``decode``, which reads dense rows only."""
    ta, tb = _view(*a), _view(*b)
    assert G.plan_for(ta, tb, mode)[0] == route
    if code is not None:
        assert G.staging(G.streams(ta), G.streams(tb)) == code


def test_strided_rows_run_on_the_cpu_and_other_strides_raise():
    """A bf16 operand at a row stride wider than its rows is taken as it
    is (the plain version on the CPU); a layout whose rows are not
    contiguous is refused on the card's path before any launch."""
    a = _view((6, 10), offset=1, pad=5, dtype=F32)
    a.copy_(torch.arange(60.0).view(6, 10))
    w = torch.ones(3, 10)
    assert torch.equal(G.linear(a, w), G.linear(a.contiguous(), w))
    with pytest.raises(ValueError, match="contiguous rows"):
        G._check_rows("linear", torch.zeros(10, 6).t())
    G._check_rows("linear", a)
    # rows of one element: contiguous to PyTorch whatever their stride
    # (strides (1, 5)), or not (strides (6, 3))
    G._check_rows("linear", torch.zeros(1, 5).t())
    G._check_rows("linear", torch.zeros(4, 6)[:, ::3][:, :1])
    with pytest.raises(ValueError, match="contiguous rows"):
        G._check_rows("linear", torch.zeros(1, 1).expand(4, 1))


def test_plan_refuses_other_dtypes():
    with pytest.raises(ValueError, match="f32 or bf16"):
        G.plan(64, 64, 64, torch.float16, "nt", True)


def _shapes():
    rng = np.random.default_rng(0)
    dims = [1, 7, 16, 17, 64, 100, 128, 129, 300, 1024, 4096, 16384, 65536]
    for _ in range(400):
        yield tuple(int(rng.choice(dims)) for _ in range(3))


@pytest.mark.parametrize("dtype", [BF, F32])
@pytest.mark.parametrize("mode", ["nt", "nn", "tn"])
def test_plan_splits_are_whole_nonempty_and_bounded(dtype, mode):
    """Over 400 shapes: every split covers whole K tiles and none is empty
    (the kernels' ceil(k_tiles / splits) per split), each has at least
    MIN_SPLIT_K_TILES tiles, the f32 partials fit WORKSPACE_CAP, a grid of
    two waves or more is never split, and an f32 split grid (resident at
    once) has the 32 x 32 tile, fewer tiles than SMs and at most WAVE
    blocks."""
    for m, n, k in _shapes():
        route, splits = G.plan(m, n, k, dtype, mode, True)
        assert splits >= 1
        if route == "decode":
            # a cluster: a power of two up to DECODE_CLUSTER, each rank
            # at least DECODE_TILE[1] of K, two blocks an SM at most
            rows, k_min = G.DECODE_TILE
            assert splits & (splits - 1) == 0
            assert splits <= G.DECODE_CLUSTER and splits * k_min <= max(
                k, k_min)
            assert -(-n // rows) * splits <= 2 * G.SMS or splits == 1
            continue
        if route not in G.WAVE:
            assert splits == 1
            continue
        bm, bn, bk = G.tile_shape(route, m, n, k)
        tiles = -(-m // bm) * -(-n // bn)
        k_tiles = -(-k // bk)
        if tiles >= 2 * G.SMS:
            assert splits == 1
        if splits == 1:
            continue
        per = -(-k_tiles // splits)
        assert (splits - 1) * per < k_tiles, (m, n, k, splits)
        ranges = G.split_ranges(k, splits, bk)
        assert len(ranges) == splits
        assert ranges[0][0] == 0 and ranges[-1][1] == k
        assert all(lo % bk == 0 and hi > lo for lo, hi in ranges)
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        assert per >= G.MIN_SPLIT_K_TILES[route]
        assert splits * m * n * 4 <= G.WORKSPACE_CAP
        # no more than the smallest count that reaches about one wave
        assert tiles * (splits - 1) < G.WAVE[route]
        if route == "f32":
            assert G.F32_TILES[G.f32_tile(m, n, k)] == (32, 32, 64, 2)
            assert tiles < G.SMS and tiles * splits <= G.WAVE["f32"]


def test_plan_is_a_pure_function():
    calls = [G.plan(m, n, k, F32, "tn", True) for m, n, k in _shapes()]
    assert calls == [G.plan(m, n, k, F32, "tn", True)
                     for m, n, k in _shapes()]


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("mode", ["nt", "nn", "tn"])
@pytest.mark.parametrize("m,n,k,splits,k_tile", [
    (32, 20, 4096, None, 64),    # ResNet-8's stride-2 dW, cut to 4,096 rows
    (64, 36, 2048, None, 64),
    (16, 16, 1024, None, 64),    # the sort task's dW, cut
    (24, 40, 700, 3, 64),        # a ragged last split, wgmma's K tile
])
def test_split_reference_matches_unsplit_and_jax(mode, m, n, k, splits,
                                                 k_tile):
    """The split sum in the kernels' order (the splits plan gives f32 at
    these shapes, summed in the f32 route's lanes and butterfly; wgmma's
    in split order) against one f32 product and JAX's: 1e-5, f32 sums of
    O(1) terms in different orders."""
    route = "wgmma"
    if splits is None:
        route, splits = G.plan(m, n, k, F32, mode, True)
        assert route == "f32" and splits > 1
        assert G.tile_shape(route, m, n, k)[2] == k_tile
    rng = np.random.default_rng(m + n + k + splits)
    a = _rand(rng, *((m, k) if mode != "tn" else (k, m)))
    b = _rand(rng, *((n, k) if mode == "nt" else (k, n))) / np.sqrt(k)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    assert len(G.split_ranges(k, splits, k_tile)) == splits
    out = G.gemm_reference_split(at, bt, mode, splits, k_tile, route)
    np.testing.assert_allclose(out.numpy(),
                               G.gemm_reference(at, bt, mode).numpy(),
                               rtol=1e-5, atol=1e-5)
    ref = np.asarray(jg._gemm(jnp.asarray(a), jnp.asarray(b), None,
                              has_bias=False, mode=mode))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def _bf16(rng, *shape, scale=1.0):
    return torch.from_numpy(_rand(rng, *shape) * scale).to(BF)


@pytest.mark.parametrize("mode", ["nt", "nn", "tn"])
def test_out_dtype_bf16_is_the_cast_f32_result(mode):
    rng = np.random.default_rng(11)
    m, n, k = 24, 40, 96
    a = _bf16(rng, *((m, k) if mode != "tn" else (k, m)))
    b = _bf16(rng, *((n, k) if mode == "nt" else (k, n)), scale=0.1)
    y = G.gemm(a, b, mode, out_dtype=BF)
    assert y.dtype == BF
    assert torch.equal(y, G.gemm(a, b, mode).to(BF))
    assert torch.equal(G.gemm(a, b, mode, out_dtype=F32), G.gemm(a, b, mode))


def _backward(fn, leaves, ct):
    leaves = [t.detach().clone().requires_grad_(True) for t in leaves]
    out = fn(*leaves)
    (out.float() * ct).sum().backward()
    return out.detach(), [t.grad for t in leaves]


@pytest.mark.parametrize("bias", [True, False])
def test_linear_out_dtype_bf16_matches_the_cast_bitwise(bias):
    """``linear(..., out_dtype=bf16)`` against ``linear(...).to(bf16)``,
    the output and every gradient, bit for bit: the backward sums the
    bias gradient in f32 and writes dX and dW in bf16 either way."""
    rng = np.random.default_rng(12)
    x, w, b = _bf16(rng, 24, 64), _bf16(rng, 48, 64, scale=0.2), \
        _bf16(rng, 48)
    ct = torch.from_numpy(_rand(rng, 24, 48))
    leaves = [x, w, b] if bias else [x, w]
    new = _backward(lambda x, w, b=None: G.linear(x, w, b, out_dtype=BF),
                    leaves, ct)
    old = _backward(lambda x, w, b=None: G.linear(x, w, b).to(BF),
                    leaves, ct)
    assert new[0].dtype == BF and torch.equal(new[0], old[0])
    for g_new, g_old in zip(new[1], old[1]):
        assert g_new.dtype == g_old.dtype == BF
        assert torch.equal(g_new, g_old)


def test_matmul_grads_in_bf16_are_the_cast_f32_products():
    """``matmul``'s backward writes dA and dB in the operands' bf16: the
    bits of the f32 products cast, as the JAX VJP's casts give them."""
    rng = np.random.default_rng(13)
    a, b = _bf16(rng, 12, 40), _bf16(rng, 40, 20, scale=0.2)
    ct = torch.from_numpy(_rand(rng, 12, 20))
    out, (da, db) = _backward(G.matmul, [a, b], ct)
    g = ct.to(BF)
    assert out.dtype == F32
    assert torch.equal(da, G.gemm_reference(g, b, "nt").to(BF))
    assert torch.equal(db, G.gemm_reference(a, g, "tn").to(BF))


def _old_proj(x2, w, b):
    """The projection as it was: f32 out of K1, cast back."""
    return ops.linear(x2, w.to(x2.dtype), b.to(x2.dtype)).to(x2.dtype)


def test_bf16_trunk_loss_and_grads_unchanged_bitwise(monkeypatch):
    """A bf16 TinyGPT trunk on the CPU: the loss and every gradient with
    K1 writing bf16 equal the f32-then-cast path's, bit for bit."""
    cfg = dict(vocab_size=64, dim=64, depth=2, num_heads=2, max_seq=32,
               rope=True)
    gen = torch.Generator().manual_seed(0)
    model = TinyGPT(**cfg, compute_dtype=BF)
    model.reset_parameters(gen)
    toks = torch.randint(0, 64, (2, 32), generator=gen)
    tgts, mask = toks.roll(-1, 1), torch.ones(32)

    def run():
        model.zero_grad(set_to_none=True)
        loss, _ = model.loss(toks, tgts, mask)
        loss.backward()
        return loss.detach(), {k: p.grad.clone()
                               for k, p in model.named_parameters()
                               if p.grad is not None}

    loss_new, g_new = run()
    monkeypatch.setattr(T, "_proj", _old_proj)
    loss_old, g_old = run()
    assert torch.equal(loss_new, loss_old)
    assert g_new.keys() == g_old.keys() and len(g_new) > 10
    for k in g_new:
        assert torch.equal(g_new[k], g_old[k]), k


def test_out_dtype_refusals_and_no_route_counts_on_the_cpu():
    x, w = torch.zeros(4, 8), torch.zeros(3, 8)
    with pytest.raises(ValueError, match="out_dtype"):
        G.linear(x.to(BF), w.to(BF), None, "relu", out_dtype=BF)
    with pytest.raises(ValueError, match="writes f32 or"):
        G.linear(x, w, None, out_dtype=BF)
    backend.reset_launch_counts()
    G.linear(x.to(BF), w.to(BF), None, out_dtype=BF)
    G.gemm(x, torch.zeros(8, 3), "nn")
    assert backend.route_counts() == {}
    assert not any(backend.launch_counts().values())
