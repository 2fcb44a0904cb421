"""Card-only tests: each hand-written CUDA kernel of taper_tpu_torch
against its plain PyTorch version on the same CUDA tensors.

These need an NVIDIA GPU (a CUDA kernel has no interpret mode) and skip
without one.  This file imports no JAX, so it also runs on a machine that
has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py

Tolerances, by the operands' dtype:
  * f32 (GEMM in every mode, convolution, weight gradient, and the
    gradients through them): 1e-4; kernel and plain version sum f32
    products in different orders (no TF32 on either side).
  * weight gradient: 1e-4 of the largest |entry|, not of each entry: an
    entry sums N*Ho*Wo (up to 200,704) products in blocks of another
    order, so its rounding scales with the terms, and an entry that
    cancels to near 0 keeps the error of its terms.
  * pooling: 1e-6; the same max, or the same sum of a window in another
    order.
  * bf16 GEMM: 2e-4; products of bf16 values are exact in f32, so only the
    summation order differs.
  * bf16 attention: 2e-2; the kernel rounds the running-max-relative
    softmax weights to bf16 where the plain version rounds the normalised
    ones, and the bf16 output itself keeps 8 bits.
  * paged decode over int8 pools: 1e-4 (1 + |ref|) with f32 q, 2e-2 with
    bf16 q (the bf16 output's 8 bits).  Both sides compute in f32 from the
    same int8 codes and scales; the kernel applies the k scale to the
    score and the v scale to the weight where the plain version scales
    the rows, and sums in another order.
  * logsumexp: 1e-4 (f32 on both sides from the same scores; 1e-3 for bf16
    inputs, whose bound arm sums weights shifted far below 1).
  * quantized linear K12/K13: 2e-4 (1 + |ref|); the activations are
    rounded to bf16 on both sides and the int8/int4 codes are exact in
    bf16, so the products are exact in f32 and only the summation order
    differs, as for the bf16 GEMM.  K14 and K15a/b: exact (integer
    products, the same f32 operations in the same order).
  * flash backward: 1e-4 in f32.  bf16, against the plain backward in f32
    on the same bf16 inputs (the kernels round the weights and ds to bf16
    before their products, as JAX does, and round their outputs): each
    (batch, head, 64-row tile) within 1e-2 relative L2 of its own norm,
    plus 1e-5 per entry (RMS) for a tile whose gradient is ~0.  The
    gradients are heavy-tailed along S, so a bound on the whole tensor
    would not see a late tile gone wrong; a planted fault shows it does.
"""

import importlib
import math
import shutil

import pytest
import torch
import torch.nn.functional as F

from taper_tpu_torch import losses
from taper_tpu_torch.models import mnist_cnn
from taper_tpu_torch.ops import _build, backend
from taper_tpu_torch.ops import conv_direct as CD
from taper_tpu_torch.ops import gemm as G
from taper_tpu_torch.ops import paged_attention as PA
from taper_tpu_torch.ops import pool as PL
from taper_tpu_torch.ops.attention import attention, attention_reference
from taper_tpu_torch.ops.conv import conv2d

# the module itself: ops/__init__.py re-exports its function "attention"
# under the same name
A = importlib.import_module("taper_tpu_torch.ops.attention")

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _randn(gen, *shape, dtype=torch.float32, scale=1.0):
    return (torch.randn(*shape, generator=gen) * scale).to(dtype)


def _close(out, ref, dtype, bf16_tol):
    tol = 1e-4 if dtype == torch.float32 else bf16_tol
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("activation", ["none", "relu", "sigmoid"])
@pytest.mark.parametrize("m,n,k,bias", [
    (16, 1024, 1024, True), (512, 4096, 1024, True), (16, 1024, 4096, True),
    (5, 19, 37, True), (33, 70, 130, False), (1, 8, 16, True)])
def test_linear_kernel_matches_plain(dev, m, n, k, bias, activation, dtype):
    gen = torch.Generator().manual_seed(m * n + k)
    x = _randn(gen, m, k, dtype=dtype).to(dev)
    w = _randn(gen, n, k, dtype=dtype, scale=k ** -0.5).to(dev)
    b = _randn(gen, n, dtype=dtype).to(dev) if bias else None
    backend.reset_launch_counts()
    y = G.linear(x, w, b, activation)
    torch.cuda.synchronize()
    assert backend.launch_counts()["linear"] == 1
    assert y.dtype == torch.float32 and y.device.type == "cuda"
    _close(y, G.linear_reference(x, w, b, activation), dtype, 2e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,h,hkv,s,d", [
    (1, 8, 8, 512, 128), (2, 4, 2, 70, 64), (1, 2, 1, 1, 128),
    (1, 4, 4, 200, 64)])
def test_flash_kernel_matches_plain(dev, b, h, hkv, s, d, causal, dtype):
    gen = torch.Generator().manual_seed(s * h + d)
    q = _randn(gen, b, h, s, d, dtype=dtype).to(dev)
    k = _randn(gen, b, hkv, s, d, dtype=dtype).to(dev)
    v = _randn(gen, b, hkv, s, d, dtype=dtype).to(dev)
    backend.reset_launch_counts()
    o = attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    # bf16 causal inputs take the bound-max kernel K8, as in JAX
    bound = dtype == torch.bfloat16 and causal
    assert backend.launch_counts()[
        "flash_fwd_bound" if bound else "flash_fwd"] == 1
    assert o.dtype == dtype
    _close(o, attention_reference(q, k, v, causal=causal), dtype, 2e-2)


def _paged_case(dev, dtype, b, kvh, g, d, bs, mb, lengths, seed=0):
    gen = torch.Generator().manual_seed(seed)
    n_blocks = b * mb + 1
    q = _randn(gen, b, kvh, g, d, dtype=dtype).to(dev)
    kp = _randn(gen, n_blocks, kvh, bs, d, dtype=dtype).to(dev)
    vp = _randn(gen, n_blocks, kvh, bs, d, dtype=dtype).to(dev)
    tables = torch.randperm(n_blocks, generator=gen)[:b * mb]
    tables = tables.reshape(b, mb).to(torch.int32).to(dev)
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, kp, vp, tables, lengths


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,kvh,g,d,bs,mb,lengths", [
    (16, 8, 1, 128, 128, 6,
     [1, 33, 127, 128, 129, 300, 512, 513, 640, 700, 768, 45, 256, 2, 9, 600]),
    (3, 2, 2, 64, 8, 5, [1, 8, 40]),
    (4, 2, 8, 128, 16, 3, [48, 17, 3, 30]),
    (2, 4, 4, 64, 32, 2, [64, 64 + 7])])     # second row runs past its table
def test_paged_kernel_matches_plain(dev, b, kvh, g, d, bs, mb, lengths,
                                    dtype):
    q, kp, vp, tb, ln = _paged_case(dev, dtype, b, kvh, g, d, bs, mb,
                                    lengths)
    backend.reset_launch_counts()
    o = PA.paged_decode_attention(q, kp, vp, tb, ln, scale=d ** -0.5)
    torch.cuda.synchronize()
    assert backend.launch_counts()["paged_decode"] == 1
    ref = PA.paged_decode_reference(q, kp, vp, tb, ln, scale=d ** -0.5)
    _close(o, ref, dtype, 2e-2)


def _int8_pools(gen, n_blocks, kvh, bs, d, dev):
    """int8 codes and their f32 per-position scales, as kv_quantize
    stores rows of std ~1."""
    out = []
    for _ in range(2):
        x = torch.randn(n_blocks, kvh, bs, d, generator=gen)
        scale = x.abs().amax(-1).clamp_min(1e-8) / 127.0
        codes = torch.round(x / scale[..., None]).to(torch.int8)
        out += [codes.to(dev), scale.to(dev)]
    return out          # k codes, k scales, v codes, v scales


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs", [16, 128])
@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("d", [64, 128])
def test_paged_int8_kernel_matches_plain(dev, d, g, bs, dtype):
    """K16 over int8 pools: lengths of 1, one block, one block and one
    position, and 4033 (mixed with the others in one launch)."""
    gen = torch.Generator().manual_seed(d * g + bs)
    b, kvh = 4, 2
    mb = -(-4033 // bs)
    n_blocks = b * mb + 1
    q = _randn(gen, b, kvh, g, d, dtype=dtype).to(dev)
    kq, ks, vq, vs = _int8_pools(gen, n_blocks, kvh, bs, d, dev)
    tables = torch.randperm(n_blocks, generator=gen)[:b * mb]
    tables = tables.reshape(b, mb).to(torch.int32).to(dev)
    lengths = torch.tensor([1, bs, bs + 1, 4033], dtype=torch.int32,
                           device=dev)
    args = (q, kq, vq, tables, lengths)
    sc = dict(scale=d ** -0.5, k_scales=ks, v_scales=vs)
    backend.reset_launch_counts()
    o = PA.paged_decode_attention(*args, **sc)
    torch.cuda.synchronize()
    counts = backend.launch_counts()
    assert counts["paged_decode_int8"] == 1 and counts["paged_decode"] == 0
    assert o.dtype == dtype
    ref = PA.paged_decode_reference(*args, **sc)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert float(((o.float() - ref.float()).abs()
                  / (1 + ref.float().abs())).max()) <= tol


def test_paged_int8_refuses_bad_scales_without_the_plain_version(
        dev, monkeypatch):
    """int8 pools with scales of the wrong shape or dtype, or without
    them, raise on the card; the plain version is never run."""
    gen = torch.Generator().manual_seed(3)
    kq, ks, vq, vs = _int8_pools(gen, 5, 2, 16, 64, dev)
    q = torch.randn(2, 2, 1, 64, generator=gen).to(dev)
    tables = torch.arange(4, dtype=torch.int32, device=dev).reshape(2, 2)
    lengths = torch.tensor([3, 20], dtype=torch.int32, device=dev)

    def plain(*a, **k):
        raise AssertionError("the plain version ran on the card")
    monkeypatch.setattr(PA, "paged_decode_reference", plain)
    bad = [dict(k_scales=ks[:, :, :8], v_scales=vs),
           dict(k_scales=ks, v_scales=vs.half()),
           dict(k_scales=ks, v_scales=None),
           dict(k_scales=ks.to(torch.float64), v_scales=vs), dict()]
    for kw in bad:
        with pytest.raises(ValueError, match="scales"):
            PA.paged_decode_attention(q, kq, vq, tables, lengths, scale=0.1,
                                      **kw)
    with pytest.raises(ValueError, match="scales"):    # f32 pools + scales
        PA.paged_decode_attention(q, kq.float(), vq.float(), tables,
                                  lengths, scale=0.1, k_scales=ks,
                                  v_scales=vs)


def test_kernels_raise_on_what_they_do_not_take(dev):
    """A CUDA tensor runs the kernel or raises: never the plain version."""
    q = torch.zeros(1, 2, 8, 48, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        attention(q, q, q)
    x = torch.zeros(4, 8, device=dev)
    with pytest.raises(ValueError, match="devices"):
        G.linear(x, torch.zeros(3, 8), None)
    with pytest.raises(ValueError, match="contiguous"):
        G.linear(x, torch.zeros(8, 3, device=dev).t(), None)
    with pytest.raises(ValueError, match="dtype"):
        G.linear(x.half(), torch.zeros(3, 8, device=dev).half(), None)


def test_engine_on_card_matches_cpu(dev):
    """The whole paged engine on the card (f32, GQA: G=2, D=64) emits the
    CPU engine's greedy tokens, through all three kernels."""
    from taper_tpu_torch.models import TinyGPT
    from taper_tpu_torch.serve import ServingEngine

    cfg = dict(vocab_size=64, dim=128, depth=2, num_heads=2,
               num_kv_heads=1, max_seq=64, rope=True)
    cpu = TinyGPT(**cfg)
    cpu.reset_parameters(torch.Generator().manual_seed(0))
    card = TinyGPT(**cfg).to(dev)
    card.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(1)
    prompts = [torch.randint(0, 64, (n,), generator=gen).tolist()
               for n in (5, 16, 9, 12)]
    outs = []
    for model in (cpu, card):
        eng = ServingEngine(model, slots=2, prompt_pad=16, decode_block=4,
                            block_size=8, pool_blocks=12)
        ids = [eng.submit(p, 7) for p in prompts]
        backend.reset_launch_counts()
        out = eng.run()
        outs.append([out[i] for i in ids])
    counts = backend.launch_counts()
    assert all(counts[k] > 0 for k in ("linear", "flash_fwd",
                                       "paged_decode")), counts
    assert outs[1] == outs[0]


@pytest.mark.parametrize("paged", [True, False])
def test_int8_cache_engines_on_card_match_cpu(dev, paged):
    """The engine over int8 KV caches on the card, paged (K16's int8
    branch) and contiguous, emits the CPU engine's greedy tokens (f32,
    GQA: G=2, D=64)."""
    from taper_tpu_torch.models import TinyGPT
    from taper_tpu_torch.serve import ServingEngine

    cfg = dict(vocab_size=64, dim=128, depth=2, num_heads=2,
               num_kv_heads=1, max_seq=64, rope=True)
    cpu = TinyGPT(**cfg)
    cpu.reset_parameters(torch.Generator().manual_seed(0))
    card = TinyGPT(**cfg).to(dev)
    card.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(1)
    prompts = [torch.randint(0, 64, (n,), generator=gen).tolist()
               for n in (5, 16, 9, 12)]
    kw = dict(pool_blocks=12, block_size=8) if paged else {}
    outs = []
    for model, d in ((cpu, "cpu"), (card, dev)):
        eng = ServingEngine(model, slots=2, prompt_pad=16, decode_block=4,
                            quantized_cache=True, device=d, **kw)
        ids = [eng.submit(p, 7) for p in prompts]
        backend.reset_launch_counts()
        out = eng.run()
        outs.append([out[i] for i in ids])
    counts = backend.launch_counts()
    assert counts["paged_decode_int8"] > 0 if paged else \
        counts["paged_decode_int8"] == 0
    assert counts["paged_decode"] == 0 and counts["linear"] > 0
    assert outs[1] == outs[0]


# -- training kernels (K1 nn/tn, K3a, K3b, K4) ------------------------------

@pytest.mark.parametrize("mode", ["nn", "tn"])
@pytest.mark.parametrize("m,n,k", [
    (256, 128, 128), (256, 64, 128), (256, 10, 64), (128, 784, 256),
    (5, 19, 37), (1, 1, 1)])
def test_gemm_mode_kernel_matches_plain(dev, mode, m, n, k):
    gen = torch.Generator().manual_seed(m + n + k)
    a = _randn(gen, *((m, k) if mode == "nn" else (k, m))).to(dev)
    b = _randn(gen, k, n).to(dev)
    backend.reset_launch_counts()
    y = G.gemm(a, b, mode)
    torch.cuda.synchronize()
    assert backend.launch_counts()[f"gemm_{mode}"] == 1
    assert tuple(y.shape) == (m, n)
    _close(y, G.gemm_reference(a, b, mode), torch.float32, None)


@pytest.mark.parametrize("mode", ["nn", "tn"])
@pytest.mark.parametrize("m,n,k", [
    (16384, 1024, 1024), (16384, 1024, 4096), (1024, 4096, 16384),
    (300, 200, 136), (5, 19, 37), (33, 70, 130)])
def test_gemm_mode_kernel_matches_plain_bf16(dev, mode, m, n, k):
    """Modes nn/tn on bf16 operands (the transformer's backward): f32
    out, against the plain f32 product of the same bf16 values."""
    gen = torch.Generator().manual_seed(m + n + k)
    a = _randn(gen, *((m, k) if mode == "nn" else (k, m)),
               dtype=torch.bfloat16).to(dev)
    b = _randn(gen, k, n, dtype=torch.bfloat16, scale=k ** -0.5).to(dev)
    backend.reset_launch_counts()
    y = G.gemm(a, b, mode)
    torch.cuda.synchronize()
    assert backend.launch_counts()[f"gemm_{mode}"] == 1
    assert tuple(y.shape) == (m, n) and y.dtype == torch.float32
    _close(y, G.gemm_reference(a, b, mode), torch.bfloat16, 2e-4)


def _attn_inputs(dev, b, h, hkv, s, d, dtype, layout, seed):
    gen = torch.Generator().manual_seed(seed)
    shapes = ([(b, h, s, d), (b, hkv, s, d)] if layout == "bhsd"
              else [(b, s, h * d), (b, s, hkv * d)])
    q = _randn(gen, *shapes[0], dtype=dtype).to(dev)
    k = _randn(gen, *shapes[1], dtype=dtype).to(dev)
    v = _randn(gen, *shapes[1], dtype=dtype).to(dev)
    do = _randn(gen, *shapes[0], dtype=dtype).to(dev)
    return q, k, v, do


def _bhsd(x, layout, d):
    return x if layout == "bhsd" else A._to_bhsd(x, 1, d)


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,h,hkv,s,d", [
    (2, 4, 2, 70, 64), (1, 8, 8, 256, 128), (1, 4, 1, 129, 128),
    (2, 2, 2, 1, 64)])
def test_flash_fwd_exact_and_lse_match_plain(dev, b, h, hkv, s, d, causal,
                                             dtype, layout):
    q, k, v, _ = _attn_inputs(dev, b, h, hkv, s, d, dtype, layout, s + d)
    heads = None if layout == "bhsd" else h
    backend.reset_launch_counts()
    o, lse = A.flash_fwd_exact(q, k, v, causal=causal, scale=d ** -0.5,
                               heads=heads)
    torch.cuda.synchronize()
    assert backend.launch_counts()["flash_fwd"] == 1
    ref_o, ref_lse = A.attention_lse_reference(
        *(_bhsd(t, layout, d) for t in (q, k, v)), causal=causal)
    _close(_bhsd(o, layout, d), ref_o, dtype, 2e-2)
    tol = 1e-4 if dtype == torch.float32 else 1e-3
    torch.testing.assert_close(lse, ref_lse, rtol=tol, atol=tol)


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("force", [True, False, None])
@pytest.mark.parametrize("b,h,hkv,s,d", [
    (2, 8, 8, 512, 128), (1, 4, 2, 200, 64), (1, 4, 1, 65, 128)])
def test_flash_fwd_bound_matches_plain_on_both_arms(dev, b, h, hkv, s, d,
                                                    force, layout):
    q, k, v, _ = _attn_inputs(dev, b, h, hkv, s, d, torch.bfloat16, layout,
                              s + h)
    heads = None if layout == "bhsd" else h
    auto = int(A.bound_predicate(q, k, scale=d ** -0.5, heads=heads)[1])
    backend.reset_launch_counts()
    o, lse = A.flash_fwd_bound(q, k, v, scale=d ** -0.5, heads=heads,
                               force_bound=force)
    torch.cuda.synchronize()
    assert backend.launch_counts()["flash_fwd_bound"] == 1
    assert backend.bound_arm_count() == (auto if force is None else force)
    ref_o, ref_lse = A.attention_lse_reference(
        *(_bhsd(t, layout, d) for t in (q, k, v)), causal=True)
    _close(_bhsd(o, layout, d), ref_o, torch.bfloat16, 2e-2)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("size,arm", [(1.0, 1), (8.0, 0)])
def test_bound_predicate_picks_the_arm_from_the_envelope(dev, size, arm):
    """max|q| * scale * log2(e) * max|k| <= 60 takes the bound arm; unit
    normals at D 64 give ~20, eight times larger ones ~1,200."""
    gen = torch.Generator().manual_seed(4)
    q = (_randn(gen, 1, 2, 64, 64) * size).to(torch.bfloat16).to(dev)
    k = (_randn(gen, 1, 2, 64, 64) * size).to(torch.bfloat16).to(dev)
    v = _randn(gen, 1, 2, 64, 64, dtype=torch.bfloat16).to(dev)
    kn, pred = A.bound_predicate(q, k, scale=0.125)
    assert int(pred.item()) == arm and kn.shape == (2,)
    backend.reset_launch_counts()
    o = attention(q, k, v, causal=True)
    assert backend.launch_counts()["flash_fwd_bound"] == 1
    assert backend.bound_arm_count() == arm
    _close(o, attention_reference(q, k, v, causal=True), torch.bfloat16,
           2e-2)


def _bwd_case(dev, b, h, hkv, s, d, dtype, layout, causal, seed=0):
    q, k, v, do = _attn_inputs(dev, b, h, hkv, s, d, dtype, layout, seed)
    heads = None if layout == "bhsd" else h
    scale = d ** -0.5
    o, lse = A.attention_lse_reference(
        *(_bhsd(t, layout, d) for t in (q, k, v)), causal=causal)
    o = o if layout == "bhsd" else A._from_bhsd(o, 1)
    return q, k, v, o.contiguous(), lse, do, heads, scale


def _worst_tile(out, ref, tol=1e-2, atol=1e-5, tile=64):
    """The largest ratio, over the (batch, head, ``tile``-row) tiles of
    ``[B, H, S, D]`` tensors, of a tile's error norm to ``tol`` times its
    reference norm plus ``atol`` per entry (RMS): the tiles agree where
    it is <= 1."""
    b, h, s, d = ref.shape
    pad = (0, 0, 0, -s % tile)
    err = F.pad(out.float() - ref.float(), pad).reshape(b * h, -1, tile * d)
    ref = F.pad(ref.float(), pad).reshape(b * h, -1, tile * d)
    bound = tol * ref.norm(dim=-1) + atol * (tile * d) ** 0.5
    return float((err.norm(dim=-1) / bound).max())


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,h,hkv,s,d", [
    (2, 4, 2, 70, 64), (1, 8, 8, 256, 128), (1, 4, 1, 129, 128),
    (1, 2, 2, 1, 64), (1, 8, 8, 2048, 128)])
def test_flash_bwd_kernels_match_plain(dev, b, h, hkv, s, d, causal, dtype,
                                       layout):
    q, k, v, o, lse, do, heads, scale = _bwd_case(
        dev, b, h, hkv, s, d, dtype, layout, causal)
    backend.reset_launch_counts()
    grads = A.flash_bwd(q, k, v, o, lse, do, causal=causal, scale=scale,
                        heads=heads)
    torch.cuda.synchronize()
    counts = backend.launch_counts()
    assert counts["flash_dq"] == 1 and counts["flash_dkv"] == 1
    refs = A.flash_bwd_reference(
        *(_bhsd(t, layout, d) for t in (q, k, v, o)), lse,
        _bhsd(do, layout, d), causal, scale)
    for name, g, r, like in zip(("dq", "dk", "dv", "delta"), grads, refs,
                                (q, k, v, lse)):
        assert g.dtype == like.dtype, name
        g = g if name == "delta" else _bhsd(g, layout, d)
        if dtype == torch.float32 or name == "delta":
            torch.testing.assert_close(g.float(), r, rtol=1e-4, atol=1e-4)
        else:
            assert _worst_tile(g, r) <= 1, (name, _worst_tile(g, r))


# Faults planted in a copy of csrc: (what, the source file, the line as it
# is, the line with the fault).  The first one drops work that only the
# last rows see, whose gradient is far below the largest entries.  The
# bf16 kernels are the wgmma ones (ops.attention.plan_bwd): K6 in
# flash_bwd_sm90.cu, K7 and K10's sweep in flash_sm90.cu.  A fault named
# "K10" is held through flash_bwd_fused, the others through K6 + K7.
_FAULTS = [
    ("K6 skips the last query tile's diagonal KV tile", "flash_bwd_sm90.cu",
     "const int kv_hi = causal ? min(S, q0 + P::BM) : S;",
     "const int kv_hi = causal ? min(S - P::BN, q0 + P::BM) : S;"),
    ("K6 skips KV tile 0 below the diagonal", "flash_bwd_sm90.cu",
     "const int kv_lo = kv_begin<MASKED>(mask, q0);",
     "const int kv_lo = q0 > 0 ? P::BN : kv_begin<MASKED>(mask, q0);"),
    ("K7 skips the last query tile", "flash_sm90.cu",
     "const int total = group * n_q;",
     "const int total = group * n_q - 1;"),
    ("K6 skips the diagonal KV tile", "flash_bwd_sm90.cu",
     "bool skip = sl.skip || (causal && kv0 > qc + 63) ||",
     "bool skip = sl.skip || (causal && kv0 + P::BN - 1 > qc) ||"),
    ("K7 drops the diagonal of its causal mask", "flash_sm90.cu",
     "return kv < S && qrow < S && keep<MASKED>(mask, qrow, kv) &&",
     "return kv < S && qrow < S && kv < qrow &&"),
    ("K10 sums dQ's share over the first 64 KV rows of a block",
     "flash_sm90.cu",
     "constexpr int KK = D == 128 ? BKV / 16 : BKV / 32;  // k16 slices",
     "constexpr int KK = D == 128 ? BKV / 32 : BKV / 64;  // k16 slices"),
]


def _plant(tmp_path, monkeypatch, name, line, fault, what):
    """Rebuilds the kernels from a copy of csrc with ``line`` of ``name``
    replaced by ``fault``."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    src = (csrc / name).read_text()
    assert src.count(line) == 1, what
    (csrc / name).write_text(src.replace(line, fault))
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_lib", None)


@pytest.mark.parametrize("what,name,line,fault", _FAULTS,
                         ids=[f[0] for f in _FAULTS])
def test_flash_bwd_check_catches_a_planted_fault(dev, tmp_path, monkeypatch,
                                                 what, name, line, fault):
    """The bf16 backward's per-tile check fails a K6, K7 or K10 built with
    a tile of its work left out (or, K7, with a wrong mask), at the 170M
    model's attention shape (one batch row): the kernels are rebuilt from
    a copy of csrc with the fault in it.  The whole-tensor bound (2e-2 of
    the largest |entry|) that the per-tile check replaced is printed
    beside it."""
    _plant(tmp_path, monkeypatch, name, line, fault, what)
    q, k, v, o, lse, do, heads, scale = _bwd_case(
        dev, 1, 8, 8, 2048, 128, torch.bfloat16, "bshd", True)
    bwd = A.flash_bwd_fused if what.startswith("K10") else A.flash_bwd
    grads = bwd(q, k, v, o, lse, do, causal=True, scale=scale, heads=heads)
    refs = A.flash_bwd_reference(
        *(_bhsd(t, "bshd", 128) for t in (q, k, v, o)), lse,
        _bhsd(do, "bshd", 128), True, scale)
    worst = {}
    for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
        g = _bhsd(g, "bshd", 128).float()
        whole = float((g - r).abs().max() / r.abs().max())
        worst[name] = (_worst_tile(g, r), whole)
    print(f"{what}: worst tile / its bound, and max error / max |ref| "
          f"(the whole-tensor bound was 2e-2): {worst}")
    assert max(t for t, _ in worst.values()) > 1, (what, worst)


# Faults planted in flash_bwd.cu's K7 loop, which f32 (the sort task) still
# runs: (what, the line as it is, the line with the fault).
_F32_DKV_FAULTS = [
    ("K7 skips the last query tile",
     "for (int q0 = q_lo; q0 < q_hi; q0 += kTile)\n",
     "for (int q0 = q_lo; q0 + kTile < q_hi; q0 += kTile)\n"),
    ("K7 leaves dK unscaled",
     "write_rows<OutT, D>(dkg, ld, Cs + r0 * L::LDO, kv0 + r0, S, scale);",
     "write_rows<OutT, D>(dkg, ld, Cs + r0 * L::LDO, kv0 + r0, S, 1.0f);"),
]


@pytest.mark.parametrize("what,line,fault", _F32_DKV_FAULTS,
                         ids=[f[0] for f in _F32_DKV_FAULTS])
def test_flash_dkv_f32_check_catches_a_planted_fault(dev, tmp_path,
                                                     monkeypatch, what,
                                                     line, fault):
    """The f32 check of K7 (1e-4, as test_flash_bwd_kernels_match_plain
    holds it) fails a kernel built with a fault in its loop, at the sort
    task's shape (examples/train_tinylm.py's defaults: batch 64, 2 heads
    of 64, S 128, causal)."""
    _plant(tmp_path, monkeypatch, "flash_bwd.cu", line, fault, what)
    q, k, v, o, lse, do, heads, scale = _bwd_case(
        dev, 64, 2, 2, 128, 64, torch.float32, "bhsd", True)
    refs = A.flash_bwd_reference(q, k, v, o, lse, do, True, scale)
    backend.reset_launch_counts()
    dk, dv = A.flash_dkv(q, k, v, lse, refs[3].contiguous(), do,
                         causal=True, scale=scale)
    torch.cuda.synchronize()
    assert backend.route_counts() == {"wmma flash_dkv": 1}
    errs = {name: float((g - r).abs().max())
            for name, g, r in zip(("dk", "dv"), (dk, dv), refs[1:3])}
    print(f"{what}: max error {errs} (the check's 1e-4)")
    assert not all(torch.allclose(g, r, rtol=1e-4, atol=1e-4)
                   for g, r in zip((dk, dv), refs[1:3])), (what, errs)


# Faults planted in flash_bwd.cu's K6 loop, which f32 (the sort task) still
# runs: (what, the line as it is, the line with the fault).
_F32_DQ_FAULTS = [
    ("K6 skips its last KV tile",
     "const int kv_hi = kv_end(mask, q0, S);",
     "const int kv_hi = kv_end(mask, q0, S) - kTile;"),
    ("K6 drops delta from dS",
     "from_f32<T>(p * (dPs[r * L::LDS + c] - delta_s[r]));",
     "from_f32<T>(p * dPs[r * L::LDS + c]);"),
]


@pytest.mark.parametrize("what,line,fault", _F32_DQ_FAULTS,
                         ids=[f[0] for f in _F32_DQ_FAULTS])
def test_flash_dq_f32_check_catches_a_planted_fault(dev, tmp_path,
                                                    monkeypatch, what, line,
                                                    fault):
    """The f32 check of K6 (1e-4, as test_flash_bwd_kernels_match_plain
    holds it) fails a kernel built with a fault in its loop, at the sort
    task's shape (examples/train_tinylm.py's defaults: batch 64, 2 heads
    of 64, S 128, causal)."""
    _plant(tmp_path, monkeypatch, "flash_bwd.cu", line, fault, what)
    q, k, v, o, lse, do, heads, scale = _bwd_case(
        dev, 64, 2, 2, 128, 64, torch.float32, "bhsd", True)
    refs = A.flash_bwd_reference(q, k, v, o, lse, do, True, scale)
    backend.reset_launch_counts()
    dq, _ = A.flash_dq(q, k, v, o, lse, do, causal=True, scale=scale)
    torch.cuda.synchronize()
    assert backend.route_counts() == {"wmma flash_dq": 1}
    err = float((dq - refs[0]).abs().max())
    print(f"{what}: max error of dq {err} (the check's 1e-4)")
    assert not torch.allclose(dq, refs[0], rtol=1e-4, atol=1e-4), (what,
                                                                   err)


def test_flash_dkv_is_deterministic(dev):
    """dK/dV sum each GQA group in a fixed order, without atomics: the
    same bits every run."""
    q, k, v, o, lse, do, heads, scale = _bwd_case(
        dev, 2, 8, 2, 300, 128, torch.bfloat16, "bshd", True)
    first = A.flash_bwd(q, k, v, o, lse, do, causal=True, scale=scale,
                        heads=heads)
    again = A.flash_bwd(q, k, v, o, lse, do, causal=True, scale=scale,
                        heads=heads)
    assert all(torch.equal(x, y) for x, y in zip(first, again))


# -- K8 and K7 on their wgmma route (csrc/flash_sm90.cu) ----------------------

# ragged S (in [B, S, H*D] a row past S is the next batch row's), GQA
# groups 1, 2, 4 and 8, D 64 and 128
_WGMMA_SHAPES = [(2, 8, 8, 1000, 128), (2, 8, 4, 2047, 64),
                 (2, 8, 2, 1000, 64), (1, 8, 1, 2047, 128),
                 (3, 4, 4, 129, 128), (1, 2, 1, 1, 64)]


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("force", [True, False])
@pytest.mark.parametrize("b,h,hkv,s,d", _WGMMA_SHAPES)
def test_k8_wgmma_matches_plain(dev, b, h, hkv, s, d, force, layout):
    q, k, v, _ = _attn_inputs(dev, b, h, hkv, s, d, torch.bfloat16, layout,
                              s + hkv)
    heads = None if layout == "bhsd" else h
    backend.reset_launch_counts()
    o, lse = A.flash_fwd_bound(q, k, v, scale=d ** -0.5, heads=heads,
                               force_bound=force)
    torch.cuda.synchronize()
    assert backend.route_counts() == {"wgmma flash_fwd_bound": 1}
    assert backend.bound_arm_count() == force
    ref_o, ref_lse = A.attention_lse_reference(
        *(_bhsd(t, layout, d) for t in (q, k, v)), causal=True)
    _close(_bhsd(o, layout, d), ref_o, torch.bfloat16, 2e-2)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,h,hkv,s,d", _WGMMA_SHAPES)
def test_k7_wgmma_matches_plain(dev, b, h, hkv, s, d, causal, layout):
    """K7 alone (delta from the plain backward), each 64-row tile of dK
    and dV within 1e-2 of its own norm, and the same bits twice."""
    q, k, v, o, lse, do, heads, scale = _bwd_case(
        dev, b, h, hkv, s, d, torch.bfloat16, layout, causal)
    refs = A.flash_bwd_reference(
        *(_bhsd(t, layout, d) for t in (q, k, v, o)), lse,
        _bhsd(do, layout, d), causal, scale)
    delta = refs[3].contiguous()
    backend.reset_launch_counts()
    dk, dv = A.flash_dkv(q, k, v, lse, delta, do, causal=causal,
                         scale=scale, heads=heads)
    torch.cuda.synchronize()
    assert backend.route_counts() == {"wgmma flash_dkv": 1}
    _hold_grads([_bhsd(g, layout, d) for g in (dk, dv)], refs[1:3],
                torch.bfloat16, ("dk", "dv"))
    again = A.flash_dkv(q, k, v, lse, delta, do, causal=causal, scale=scale,
                        heads=heads)
    assert torch.equal(dk, again[0]) and torch.equal(dv, again[1])


@pytest.mark.parametrize("mask", [(True, 65, None), (False, 65, None),
                                  (True, None, "docs"),
                                  (True, None, "shuffled")],
                         ids=["causal-w65", "full-w65", "seg-docs",
                              "seg-shuffled"])
def test_k7_wgmma_under_masks_is_bitwise_repeatable(dev, mask):
    q, k, v, o, lse, do, kw = _masked_case(dev, 2, 8, 2, 700, 128,
                                           torch.bfloat16, "bshd", mask)
    refs = _masked_refs(q, k, v, o, lse, do, kw, "bshd", 128)
    backend.reset_launch_counts()
    first = A.flash_dkv(q, k, v, lse, refs[3].contiguous(), do, **kw)
    again = A.flash_dkv(q, k, v, lse, refs[3].contiguous(), do, **kw)
    torch.cuda.synchronize()
    assert backend.route_counts() == {"wgmma flash_dkv": 2}
    assert all(torch.equal(x, y) for x, y in zip(first, again))
    _hold_grads([_bhsd(g, "bshd", 128) for g in first], refs[1:3],
                torch.bfloat16, ("dk", "dv"))


def test_k7_in_f32_keeps_the_wmma_route(dev):
    q, k, v, o, lse, do, heads, scale = _bwd_case(
        dev, 2, 4, 2, 70, 64, torch.float32, "bhsd", True)
    _, delta = A.flash_dq(q, k, v, o, lse, do, causal=True, scale=scale)
    backend.reset_launch_counts()
    A.flash_dkv(q, k, v, lse, delta, do, causal=True, scale=scale)
    assert backend.route_counts() == {"wmma flash_dkv": 1}


@pytest.mark.parametrize("n", [64, 128])
def test_wgmma_fragments_match_a_plain_tile(dev, n):
    """hopper.cuh's fragment helpers on one warpgroup: s = a b^T by wgmma
    from shared memory, its rows' max and sum by quad shuffles, and
    bf16(s) c by wgmma with bf16(s) taken from the f32 accumulator as A
    fragments without a shuffle (acc_to_a).  Small integers make every
    value exact (|s| <= 256 is a bf16 integer, |out| <= 2^15 in f32), so
    the kernel must give the plain results bit for bit: an element in the
    wrong place of a fragment cannot hide under a tolerance, and no bf16
    rounding of s can flip between the two sides."""
    gen = torch.Generator().manual_seed(n)

    def ints(*shape):
        return torch.randint(-2, 3, shape, generator=gen).to(
            torch.bfloat16).to(dev)

    a, b, c = ints(64, 64), ints(64, 64), ints(64, n)
    out = torch.empty(64, n, device=dev)
    rmax, rsum = (torch.empty(64, device=dev) for _ in range(2))
    _build.check(_build.library().taper_wgmma_frag_test(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), out.data_ptr(),
        rmax.data_ptr(), rsum.data_ptr(), n, _build.stream(a)), "frag test")
    torch.cuda.synchronize()
    s = a.float() @ b.float().t()
    assert torch.equal(s.to(torch.bfloat16).float(), s)
    assert torch.equal(rmax, s.amax(1)) and torch.equal(rsum, s.sum(1))
    assert torch.equal(out, s @ c.float())


# Faults planted in a copy of csrc/flash_sm90.cu's K8: (what, the line as
# it is, the line with the fault).
_FWD_FAULTS = [
    ("K8 drops the diagonal of its causal mask",
     "[S](int r, int col) { return col <= r && col < S; });",
     "[S](int r, int col) { return col < r && col < S; });"),
    ("K8 skips the last KV tile of every block but the first",
     "const int n_tiles = (min(S, q0 + P::BM) + P::BN - 1) / P::BN;",
     "const int n_tiles = max(1, (min(S, q0 + P::BM) + P::BN - 1) / P::BN"
     " - 1);"),
]


@pytest.mark.parametrize("what,line,fault", _FWD_FAULTS,
                         ids=[f[0] for f in _FWD_FAULTS])
def test_flash_fwd_check_catches_a_planted_fault(dev, tmp_path, monkeypatch,
                                                 what, line, fault):
    """K8's check (2e-2 per entry, lse 1e-3) fails a kernel built with a
    fault in it, at the 170M model's attention shape (one batch row), on
    both arms."""
    _plant(tmp_path, monkeypatch, "flash_sm90.cu", line, fault, what)
    q, k, v, _ = _attn_inputs(dev, 1, 8, 8, 2048, 128, torch.bfloat16,
                              "bshd", 3)
    ref_o, ref_lse = A.attention_lse_reference(
        *(_bhsd(t, "bshd", 128) for t in (q, k, v)), causal=True)
    for force in (True, False):
        o, lse = A.flash_fwd_bound(q, k, v, scale=128 ** -0.5, heads=8,
                                   force_bound=force)
        err = float(((_bhsd(o, "bshd", 128).float() - ref_o.float()).abs()
                     / (1 + ref_o.float().abs())).max())
        lerr = float((lse - ref_lse).abs().max())
        print(f"{what}, bound arm {force}: o error {err:.3e} (tol 2e-2), "
              f"lse error {lerr:.3e} (tol 1e-3)")
        assert err > 2e-2 or lerr > 1e-3, (what, force, err, lerr)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_bshd_matches_the_transposed_call(dev, dtype):
    """attention_bshd and attention on the transposed inputs: the same
    forward and gradients through autograd."""
    b, h, hkv, s, d = 2, 4, 2, 200, 128
    q, k, v, do = _attn_inputs(dev, b, h, hkv, s, d, dtype, "bshd", 9)
    outs = []
    for transposed in (False, True):
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        if transposed:
            o = A._from_bhsd(attention(
                *(A._to_bhsd(t, 1, d).contiguous() for t in leaves),
                causal=True), 1)
        else:
            o = A.attention_bshd(*leaves, h, causal=True)
        (o.float() * do.float()).sum().backward()
        outs.append([o.detach()] + [t.grad for t in leaves])
    for x, y in zip(*outs):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def _grads(fn, tensors):
    leaves = [t.detach().clone().requires_grad_(True) for t in tensors]
    out = fn(*leaves)
    gen = torch.Generator().manual_seed(7)
    ct = torch.randn(out.shape, generator=gen).to(out.device)
    (out * ct).sum().backward()
    return out.detach(), [t.grad for t in leaves]


@pytest.mark.parametrize("activation", ["none", "relu", "sigmoid"])
def test_linear_grads_on_card_match_plain(dev, activation):
    """linear is differentiable on the card: K1 nt forward, nn/tn
    backward, and the grads equal the plain path's on the CPU."""
    gen = torch.Generator().manual_seed(3)
    x, w, b = (_randn(gen, 256, 128), _randn(gen, 64, 128, scale=0.1),
               _randn(gen, 64))
    fn = lambda *t: G.linear(*t, activation)
    backend.reset_launch_counts()
    out, grads = _grads(fn, [t.to(dev) for t in (x, w, b)])
    counts = backend.launch_counts()
    assert counts["linear"] == 1 and counts["gemm_nn"] == 1
    assert counts["gemm_tn"] == 1
    ref, ref_grads = _grads(fn, [x, w, b])
    _close(out.cpu(), ref, torch.float32, None)
    for g, r in zip(grads, ref_grads):
        _close(g.cpu(), r, torch.float32, None)


# The stride-1 3x3 convolutions (pad 1, batch 256) of the reference CNN
# and of ResNet-8, as (C, O, H): each path's forward and weight gradient.
_CNN_CONVS = [(1, 32, 28), (32, 32, 28), (32, 64, 14), (64, 64, 14),
              (64, 128, 7)]
_RESNET_CONVS = [(3, 16, 32), (16, 16, 32), (32, 32, 16), (64, 64, 8)]
# Their input gradients, as K3a runs them: (channels of g, channels of dX,
# H); the first layer of each model takes none (its input is the data).
_DX_CONVS = [(32, 32, 28), (64, 32, 14), (64, 64, 14), (128, 64, 7),
             (16, 16, 32), (32, 32, 16), (64, 64, 8)]

_CONV_CASES = [
    # N, C, O, H, W, kh, kw, pad, bias, activation
    (256, 1, 32, 28, 28, 3, 3, 1, True, "relu"),
    (256, 32, 32, 28, 28, 3, 3, 1, True, "relu"),
    (256, 64, 128, 7, 7, 3, 3, 1, True, "relu"),
    (256, 128, 64, 7, 7, 3, 3, 1, False, "none"),
    (3, 3, 5, 17, 9, 3, 3, 0, True, "sigmoid"),
    (2, 5, 40, 40, 37, 3, 3, 2, False, "none"),
    (4, 9, 33, 12, 13, 5, 2, (4, 1), True, "relu"),
    (1, 1, 1, 1, 1, 1, 1, 0, True, "none"),
    # every other path shape
    (256, 32, 64, 14, 14, 3, 3, 1, True, "relu"),
    (256, 64, 64, 14, 14, 3, 3, 1, True, "relu"),
    (256, 64, 32, 14, 14, 3, 3, 1, False, "none"),
    (256, 3, 16, 32, 32, 3, 3, 1, False, "none"),
    (256, 16, 16, 32, 32, 3, 3, 1, False, "none"),
    (256, 32, 32, 16, 16, 3, 3, 1, False, "none"),
    (256, 64, 64, 8, 8, 3, 3, 1, False, "none"),
    # C not a multiple of the 8-channel chunk, O of the channel tile, W of
    # the 4-pixel segment; tiles that cross images with a ragged last one
    (5, 12, 10, 13, 11, 3, 3, 1, True, "relu"),
    (3, 9, 33, 9, 30, 3, 3, 1, True, "sigmoid"),
    # O above K3b's 128 (its other-size kernel), three K3a channel tiles
    (2, 7, 130, 6, 5, 3, 3, 1, True, "none"),
    # rows wider than one tile (column tiles), padding that changes H
    (2, 4, 64, 3, 140, 3, 3, (2, 1), True, "relu"),
    (2, 3, 6, 5, 6, 3, 3, 0, False, "none"),
    # other filter sizes
    (3, 6, 20, 10, 9, 5, 5, 2, True, "relu"),
    (2, 3, 4, 8, 8, 1, 1, 0, False, "none"),
]


@pytest.mark.parametrize("n,c,o,h,w,kh,kw,pad,bias,activation", _CONV_CASES)
def test_conv_kernels_match_plain(dev, n, c, o, h, w, kh, kw, pad, bias,
                                  activation):
    gen = torch.Generator().manual_seed(c * o + h)
    pad = (pad, pad) if isinstance(pad, int) else pad
    x = _randn(gen, n, c, h, w).to(dev)
    wt = _randn(gen, o, c, kh, kw, scale=(c * kh * kw) ** -0.5).to(dev)
    b = _randn(gen, o).to(dev) if bias else None
    backend.reset_launch_counts()
    y = CD.conv_fwd(x, wt, b, pad, activation)
    g = _randn(gen, *y.shape).to(dev)
    dw = CD.conv_dw(x, g, (kh, kw), pad)
    torch.cuda.synchronize()
    counts = backend.launch_counts()
    assert counts["conv_fwd"] == 1 and counts["conv_dw"] == 1
    _close(y, CD.conv2d_reference(x, wt, b, pad, activation), torch.float32,
           None)
    ref_dw = CD.conv_dw_reference(x, g, (kh, kw), pad)
    assert (dw - ref_dw).abs().max() <= 1e-4 * ref_dw.abs().max()


@pytest.mark.parametrize("c,o,hw", _CNN_CONVS + _RESNET_CONVS)
def test_conv_dw_is_deterministic(dev, c, o, hw):
    gen = torch.Generator().manual_seed(11)
    x = _randn(gen, 256, c, hw, hw).to(dev)
    g = _randn(gen, 256, o, hw, hw).to(dev)
    first = CD.conv_dw(x, g, (3, 3), (1, 1))
    assert torch.equal(first, CD.conv_dw(x, g, (3, 3), (1, 1)))


@pytest.mark.parametrize("n,c,o,hw,k,pad", [
    (256, ci, co, hw, (3, 3), (1, 1)) for ci, co, hw in _DX_CONVS] + [
    (3, 5, 10, 11, (3, 3), (0, 2)), (2, 6, 33, 9, (5, 2), (4, 1))])
def test_conv_dx_reads_flipped_weights_in_the_kernel(dev, n, c, o, hw, k,
                                                     pad):
    """K3a's input gradient: ``conv_fwd(g, w, flipped=True)`` reads the
    forward's ``w`` ``[C_g, O, kh, kw]`` as flipped, in/out-swapped weights
    in the kernel (one launch, no copy), against the plain convolution
    over ``flip_weights(w)``; and ``conv2d_direct``'s backward takes it."""
    gen = torch.Generator().manual_seed(c * o + hw)
    g = _randn(gen, n, c, hw, hw).to(dev)
    w = _randn(gen, c, o, *k, scale=(c * k[0] * k[1]) ** -0.5).to(dev)
    backend.reset_launch_counts()
    dx = CD.conv_fwd(g, w, None, pad, flipped=True)
    torch.cuda.synchronize()
    assert backend.launch_counts()["conv_fwd"] == 1
    ref = F.conv2d(g, CD.flip_weights(w), padding=pad)
    assert dx.shape == ref.shape
    assert ((dx - ref).abs() <= 1e-4 * (1 + ref.abs())).all()
    if pad == (1, 1):
        x = _randn(gen, n, o, hw, hw).to(dev).requires_grad_(True)
        y = CD.conv2d_direct(x, w, None, (1, 1))
        (y * g).sum().backward()
        torch.testing.assert_close(x.grad, dx, rtol=0, atol=0)


@pytest.mark.parametrize("stride,groups,k", [(1, 1, 3), (1, 1, 1),
                                             (2, 1, 3), (1, 2, 3)])
def test_conv2d_grads_on_card_match_plain(dev, stride, groups, k):
    """conv2d is differentiable on the card through every route: K3a for
    the forward and dX, K3b for dW (direct route), K1 (im2col routes)."""
    gen = torch.Generator().manual_seed(5)
    x = _randn(gen, 4, 6, 12, 12)
    wt = _randn(gen, 8, 6 // groups, k, k, scale=0.3)
    b = _randn(gen, 8)
    fn = lambda *t: conv2d(*t, stride=stride, padding=k // 2,
                           groups=groups, activation="relu")
    backend.reset_launch_counts()
    out, grads = _grads(fn, [t.to(dev) for t in (x, wt, b)])
    counts = backend.launch_counts()
    if stride == 1 and k > 1:
        assert counts["conv_fwd"] == 2 * groups, counts
        assert counts["conv_dw"] == groups, counts
    else:
        assert counts["linear"] and counts["gemm_nn"] and counts["gemm_tn"]
    ref, ref_grads = _grads(fn, [x, wt, b])
    _close(out.cpu(), ref, torch.float32, None)
    for g, r in zip(grads, ref_grads):
        _close(g.cpu(), r, torch.float32, None)


@pytest.mark.parametrize("shape,k,mode", [
    ((256, 32, 28, 28), 2, "max"), ((256, 64, 14, 14), 2, "max"),
    ((256, 128, 7, 7), 7, "avg"), ((3, 5, 17, 17), 2, "avg"),
    ((3, 5, 17, 17), 3, "max"), ((2, 4, 9, 9), 9, "max"),
    ((2, 3, 40, 40), 8, "avg")])
def test_pool_kernel_matches_plain(dev, shape, k, mode):
    gen = torch.Generator().manual_seed(k)
    x = _randn(gen, *shape).to(dev)
    backend.reset_launch_counts()
    y = (PL.max_pool2d if mode == "max" else PL.avg_pool2d)(x, kernel=k)
    torch.cuda.synchronize()
    assert backend.launch_counts()["pool"] == 1
    ref = (PL.max_pool2d_reference if mode == "max"
           else PL.avg_pool2d_reference)(x, k, k)
    torch.testing.assert_close(y, ref, rtol=1e-6, atol=1e-6)


def test_pool_grads_on_card_match_plain(dev):
    gen = torch.Generator().manual_seed(2)
    x = torch.relu(_randn(gen, 4, 3, 9, 9))      # ties at 0, as after relu
    for fn in (lambda t: PL.max_pool2d(t, kernel=2),
               lambda t: PL.avg_pool2d(t, kernel=(3, 3))):
        out, (g,) = _grads(fn, [x.to(dev)])
        ref, (rg,) = _grads(fn, [x])
        torch.testing.assert_close(out.cpu(), ref, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(g.cpu(), rg, rtol=1e-6, atol=1e-6)


def test_pool_raises_on_what_the_kernel_does_not_take(dev):
    x = torch.zeros(1, 2, 8, 8, device=dev)
    with pytest.raises(NotImplementedError, match="stride == kernel"):
        PL.max_pool2d(x, kernel=3, stride=1, padding=1)


def test_paged_decode_refuses_grad_and_attention_has_a_backward(dev):
    """Paged decode has no backward kernel (nor has JAX's): a CUDA input
    that requires grad raises instead of a detached result.  Attention is
    differentiable through K6/K7."""
    q = torch.zeros(1, 2, 8, 64, device=dev, requires_grad=True)
    backend.reset_launch_counts()
    attention(q, q, q, causal=True).sum().backward()
    assert backend.launch_counts()["flash_dq"] == 1
    assert q.grad is not None and torch.isfinite(q.grad).all()
    qd = torch.zeros(1, 1, 1, 64, device=dev, requires_grad=True)
    pool = torch.zeros(2, 1, 8, 64, device=dev)
    tables = torch.zeros(1, 1, dtype=torch.int32, device=dev)
    lengths = torch.ones(1, dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="no backward"):
        PA.paged_decode_attention(qd, pool, pool, tables, lengths, scale=1.0)


def test_cnn_step_on_card_matches_cpu(dev):
    """The reference CNN's loss and every parameter's gradient on the
    card equal the plain path's on the CPU (batch 8)."""
    cpu = mnist_cnn()
    cpu.reset_parameters(torch.Generator().manual_seed(0))
    card = mnist_cnn().to(dev)
    card.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(1)
    x = torch.rand(8, 784, generator=gen)
    y = torch.randint(0, 10, (8,), generator=gen)
    out = []
    for model, d in ((cpu, "cpu"), (card, dev)):
        loss = losses.cross_entropy_loss(model(x.to(d)), y.to(d))
        loss.backward()
        out.append((loss.item(), {k: p.grad.cpu()
                                  for k, p in model.named_parameters()}))
    (l_ref, g_ref), (l_out, g_out) = out
    assert abs(l_out - l_ref) <= 1e-5 * abs(l_ref)
    for k in g_ref:
        rel = (g_out[k] - g_ref[k]).norm() / g_ref[k].norm().clamp_min(1e-30)
        assert rel <= 1e-4, (k, float(rel))


@pytest.mark.parametrize("cfg", [
    dict(dim=256, num_heads=2, rope=True),                 # [B, S, H*D]
    dict(dim=128, num_heads=2, num_kv_heads=1, rope=False)])  # transposed
def test_tinygpt_step_on_card_matches_cpu(dev, cfg):
    """TinyGPT.loss and every parameter's gradient in f32 on the card
    (K1 all modes, K5, K6, K7) against the plain path on the CPU."""
    from taper_tpu_torch.models import TinyGPT

    cfg = dict(vocab_size=64, depth=2, max_seq=200, **cfg)
    cpu = TinyGPT(**cfg)
    cpu.reset_parameters(torch.Generator().manual_seed(0))
    card = TinyGPT(**cfg).to(dev)
    card.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, 64, (2, 200), generator=gen)
    tgts, mask = toks.roll(-1, 1), torch.ones(200)
    out = []
    for model, d in ((cpu, "cpu"), (card, dev)):
        loss, _ = model.loss(toks.to(d), tgts.to(d), mask.to(d))
        loss.backward()
        out.append((loss.item(), {k: p.grad.cpu() for k, p in
                                  model.named_parameters()
                                  if p.grad is not None}))
    (l_ref, g_ref), (l_out, g_out) = out
    assert abs(l_out - l_ref) <= 1e-5 * abs(l_ref)
    assert g_out.keys() == g_ref.keys()
    total = sum(float(g.norm()) ** 2 for g in g_ref.values()) ** 0.5
    for k in g_ref:
        if k.endswith("attn.bk") and not cfg["rope"]:
            # zero in exact arithmetic without rope: rounding noise only
            assert max(float(g_out[k].norm()),
                       float(g_ref[k].norm())) <= 1e-6 * total, k
            continue
        rel = (g_out[k] - g_ref[k]).norm() / g_ref[k].norm()
        assert rel <= 1e-4, (k, float(rel))


# -- windows and segment ids in K5/K6/K7, K11 and K10 -------------------------

def _segments(b, s, kind):
    """Segment ids ``[b, s]`` int32: "docs" packs ragged documents with
    padding (id 0) at the end, so that rows of a later document meet
    whole leading KV tiles of another one (every tile of row 130's first
    two is document 1's); "shuffled" gives ids that are not sorted."""
    if kind == "docs":
        bounds = [0, 130, 167, 300, s - 20]
        seg = torch.zeros(s, dtype=torch.int32)
        for i, (a, z) in enumerate(zip(bounds[:-1], bounds[1:])):
            seg[a:z] = i + 1
        return seg.repeat(b, 1)
    gen = torch.Generator().manual_seed(s)
    return torch.randint(0, 3, (b, s), generator=gen, dtype=torch.int32)


# (causal, window, segment layout)
_MASKS = [(True, 1, None), (True, 64, None), (True, 65, None),
          (True, 512, None), (False, 65, None), (False, 1, None),
          (True, None, "docs"), (False, None, "docs"),
          (True, None, "shuffled")]
_MASK_IDS = [f"{'causal' if c else 'full'}-"
             + (f"w{w}" if w else f"seg-{g}") for c, w, g in _MASKS]


def _masked_case(dev, b, h, hkv, s, d, dtype, layout, mask, seed=0):
    causal, window, segs = mask
    q, k, v, o, lse, do, heads, scale = _bwd_case(dev, b, h, hkv, s, d,
                                                  dtype, layout, causal,
                                                  seed)
    seg = None if segs is None else _segments(b, s, segs).to(dev)
    o, lse = A.attention_lse_reference(
        *(_bhsd(t, layout, d) for t in (q, k, v)), causal=causal,
        window=window, segment_ids=seg)
    o = o if layout == "bhsd" else A._from_bhsd(o, 1).contiguous()
    kw = dict(causal=causal, scale=scale, heads=heads, window=window,
              segment_ids=seg)
    return q, k, v, o, lse, do, kw


def _masked_refs(q, k, v, o, lse, do, kw, layout, d, per_query_head=False):
    return A.flash_bwd_reference(
        *(_bhsd(t, layout, d) for t in (q, k, v, o)), lse,
        _bhsd(do, layout, d), kw["causal"], kw["scale"],
        window=kw["window"], segment_ids=kw["segment_ids"],
        per_query_head=per_query_head)


def _hold_grads(grads, refs, dtype, names=("dq", "dk", "dv")):
    """Gradients ``[B, H, S, D]`` against the plain backward's: 1e-4 in
    f32, each 64-row tile within 1e-2 of its own norm in bf16."""
    for name, g, r in zip(names, grads, refs):
        if dtype == torch.float32:
            torch.testing.assert_close(g.float(), r, rtol=1e-4, atol=1e-4)
        else:
            assert _worst_tile(g, r) <= 1, (name, _worst_tile(g, r))


_MASK_SHAPES = [(2, 4, 2, 333, 64), (1, 4, 4, 700, 128)]


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,s,d", _MASK_SHAPES)
@pytest.mark.parametrize("mask", _MASKS, ids=_MASK_IDS)
def test_flash_masked_fwd_matches_plain(dev, mask, b, h, hkv, s, d, dtype,
                                        layout):
    """K5 with a window or segment ids: the band-limited loop and the
    guard of a row whose first visited tiles are all masked (no NaN)."""
    q, k, v, o_ref, lse_ref, _, kw = _masked_case(dev, b, h, hkv, s, d,
                                                  dtype, layout, mask)
    backend.reset_launch_counts()
    o, lse = A.flash_fwd_exact(q, k, v, **{n: kw[n] for n in (
        "causal", "scale", "heads", "window", "segment_ids")})
    torch.cuda.synchronize()
    assert backend.launch_counts()["flash_fwd"] == 1
    assert torch.isfinite(o.float()).all() and torch.isfinite(lse).all()
    _close(_bhsd(o, layout, d), _bhsd(o_ref, layout, d), dtype, 2e-2)
    tol = 1e-4 if dtype == torch.float32 else 1e-3
    torch.testing.assert_close(lse, lse_ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,s,d", _MASK_SHAPES)
@pytest.mark.parametrize("mask", _MASKS, ids=_MASK_IDS)
def test_flash_masked_bwd_matches_plain(dev, mask, b, h, hkv, s, d, dtype,
                                        layout):
    """K6 and K7 with a window or segment ids against the plain backward:
    a masked pair across documents adds nothing to dS."""
    q, k, v, o, lse, do, kw = _masked_case(dev, b, h, hkv, s, d, dtype,
                                           layout, mask)
    backend.reset_launch_counts()
    grads = A.flash_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    counts = backend.launch_counts()
    assert counts["flash_dq"] == 1 and counts["flash_dkv"] == 1
    refs = _masked_refs(q, k, v, o, lse, do, kw, layout, d)
    _hold_grads([_bhsd(g, layout, d) for g in grads[:3]], refs[:3], dtype)
    torch.testing.assert_close(grads[3], refs[3], rtol=1e-4, atol=1e-4)


_DKV_T_MASKS = [(False, None, None), (True, 64, None), (True, 65, None),
                (True, 512, None), (False, 65, None), (True, 1, None)]


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,s,d", [(2, 4, 1, 333, 64),
                                         (1, 4, 2, 700, 128),
                                         (1, 2, 2, 129, 128)])
@pytest.mark.parametrize("mask", _DKV_T_MASKS,
                         ids=[f"{'causal' if c else 'full'}-w{w}"
                              for c, w, _ in _DKV_T_MASKS])
def test_flash_dkv_t_matches_plain(dev, mask, b, h, hkv, s, d, dtype,
                                   layout, monkeypatch):
    """K11: its per-query-head partials against the plain backward's, and
    through TAPER_ATTN_DKV_T=1 the group-summed dK/dV against K7's."""
    q, k, v, o, lse, do, kw = _masked_case(dev, b, h, hkv, s, d, dtype,
                                           layout, mask)
    _, delta = A.flash_dq(q, k, v, o, lse, do, **kw)
    backend.reset_launch_counts()
    parts = A.flash_dkv_t(q, k, v, lse, delta, do, **{
        n: kw[n] for n in ("causal", "scale", "heads", "window")})
    torch.cuda.synchronize()
    assert backend.launch_counts()["flash_dkv_t"] == 1
    assert all(p.dtype == torch.float32 for p in parts)
    refs = _masked_refs(q, k, v, o, lse, do, kw, layout, d,
                        per_query_head=True)
    # the partials are f32 sums of bf16-rounded products: held as K7
    _hold_grads(parts, refs[1:3], dtype, ("dk", "dv"))
    monkeypatch.setenv("TAPER_ATTN_DKV_T", "1")
    backend.reset_launch_counts()
    grads = A.flash_bwd(q, k, v, o, lse, do, **kw)
    counts = backend.launch_counts()
    monkeypatch.delenv("TAPER_ATTN_DKV_T")
    ref7 = A.flash_bwd(q, k, v, o, lse, do, **kw)
    plain_causal = mask[0] and mask[1] is None
    assert counts["flash_dkv_t"] == (0 if plain_causal else 1)
    assert counts["flash_dkv"] == (1 if plain_causal else 0)
    for g, r, like in zip(grads[1:3], ref7[1:3], (k, v)):
        assert g.shape == like.shape and g.dtype == like.dtype
        # two f32 sums of the same products in other orders, rounded once
        tol = 1e-4 if dtype == torch.float32 else 1e-2
        torch.testing.assert_close(g.float(), r.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,s,d", [
    (2, 4, 2, 70, 64), (1, 8, 8, 256, 128), (1, 4, 1, 129, 128),
    (1, 2, 2, 1, 64), (1, 8, 8, 2048, 128)])
def test_flash_bwd_fused_matches_plain(dev, b, h, hkv, s, d, dtype, layout,
                                       monkeypatch):
    """K10 (causal) against the plain backward, and chosen by
    TAPER_ATTN_FUSED_BWD=1.  Held by tolerance, not bits: its dQ sums
    with atomics, in an order that changes from run to run."""
    q, k, v, o, lse, do, kw = _masked_case(dev, b, h, hkv, s, d, dtype,
                                           layout, (True, None, None))
    monkeypatch.setenv("TAPER_ATTN_FUSED_BWD", "1")
    backend.reset_launch_counts()
    grads = A.flash_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    counts = backend.launch_counts()
    assert counts["flash_bwd_fused"] == 1
    assert counts["flash_dq"] == counts["flash_dkv"] == 0
    for g, like in zip(grads, (q, k, v, lse)):
        assert g.shape == like.shape and g.dtype == like.dtype
    refs = _masked_refs(q, k, v, o, lse, do, kw, layout, d)
    _hold_grads([_bhsd(g, layout, d) for g in grads[:3]], refs[:3], dtype)
    torch.testing.assert_close(grads[3], refs[3], rtol=1e-4, atol=1e-4)
    # the flag leaves windows and segments to K6 + K7, as JAX does
    seg = torch.ones(b, s, dtype=torch.int32, device=dev)
    backend.reset_launch_counts()
    A.flash_bwd(q, k, v, o, lse, do, **dict(kw, segment_ids=seg))
    assert backend.launch_counts()["flash_bwd_fused"] == 0


def test_flash_bwd_fused_general_mask(dev):
    """K10's kernel takes the full mask (the dispatch sends it plain
    causal attention only): non-causal and windowed, GQA, bf16."""
    for mask in ((False, None, None), (True, 65, None), (True, None, "docs")):
        q, k, v, o, lse, do, kw = _masked_case(dev, 1, 4, 2, 333, 64,
                                               torch.bfloat16, "bshd", mask)
        grads = A.flash_bwd_fused(q, k, v, o, lse, do, **kw)
        refs = _masked_refs(q, k, v, o, lse, do, kw, "bshd", 64)
        _hold_grads([_bhsd(g, "bshd", 64) for g in grads[:3]], refs[:3],
                    torch.bfloat16)


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_attention_masks_dispatch_on_card(dev, layout):
    """A bf16 causal call with a window or segment ids takes K5, not K8
    (which would drop the mask), through autograd, and matches the plain
    path on the same bf16 inputs."""
    b, h, s, d = 2, 4, 333, 64
    q, k, v, do = _attn_inputs(dev, b, h, 2, s, d, torch.bfloat16, layout,
                               5)
    heads = None if layout == "bhsd" else h
    for kw in (dict(window=70), dict(segment_ids=_segments(b, s, "docs"))):
        outs = []
        for device in (dev, "cpu"):
            leaves = [t.detach().to(device).requires_grad_(True)
                      for t in (q, k, v)]
            kwd = {n: (x.to(device) if torch.is_tensor(x) else x)
                   for n, x in kw.items()}
            backend.reset_launch_counts()
            if heads is None:
                o = attention(*leaves, causal=True, **kwd)
            else:
                o = A.attention_bshd(*leaves, heads, causal=True, **kwd)
            (o.float() * do.to(device).float()).sum().backward()
            if device == dev:
                counts = backend.launch_counts()
                assert counts["flash_fwd"] == 1, counts
                assert counts["flash_fwd_bound"] == 0, counts
            outs.append([o.detach().cpu().float()]
                        + [t.grad.cpu().float() for t in leaves])
        torch.testing.assert_close(outs[0][0], outs[1][0], rtol=2e-2,
                                   atol=2e-2)
        for g, r in zip(outs[0][1:], outs[1][1:]):
            assert float((g - r).norm() / r.norm()) <= 2e-2


# -- K6 and K10 on their wgmma route (csrc/flash_bwd_sm90.cu, flash_sm90.cu)

# ragged S (1, 70, 129, 333, 2048), D 64 and 128, MHA, GQA and MQA
_BWD_WGMMA_SHAPES = [(2, 8, 8, 70, 64), (2, 8, 2, 333, 128),
                     (3, 4, 4, 129, 128), (1, 8, 1, 2048, 128),
                     (1, 2, 1, 1, 64), (2, 8, 4, 2048, 64),
                     (1, 4, 1, 333, 64)]


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,h,hkv,s,d", _BWD_WGMMA_SHAPES)
def test_k6_wgmma_matches_plain(dev, b, h, hkv, s, d, causal, layout):
    """K6 alone: each 64-row tile of dQ within 1e-2 of its own norm, delta
    within 1e-4, the planned route counted, and the same bits twice."""
    q, k, v, o, lse, do, heads, scale = _bwd_case(
        dev, b, h, hkv, s, d, torch.bfloat16, layout, causal)
    refs = A.flash_bwd_reference(
        *(_bhsd(t, layout, d) for t in (q, k, v, o)), lse,
        _bhsd(do, layout, d), causal, scale)
    backend.reset_launch_counts()
    dq, delta = A.flash_dq(q, k, v, o, lse, do, causal=causal, scale=scale,
                           heads=heads)
    torch.cuda.synchronize()
    assert backend.route_counts() == {f"{A.plan_bwd(q.dtype)} flash_dq": 1}
    assert A.plan_bwd(q.dtype) == "wgmma"
    assert dq.dtype == q.dtype and dq.shape == q.shape
    _hold_grads([_bhsd(dq, layout, d)], refs[:1], torch.bfloat16, ("dq",))
    torch.testing.assert_close(delta, refs[3], rtol=1e-4, atol=1e-4)
    again = A.flash_dq(q, k, v, o, lse, do, causal=causal, scale=scale,
                       heads=heads)
    assert torch.equal(dq, again[0]) and torch.equal(delta, again[1])


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("mask", _MASKS, ids=_MASK_IDS)
def test_k6_wgmma_under_masks_is_bitwise_repeatable(dev, mask, layout):
    """K6 under every mask (the MASKED instantiation: windows at the tile
    edges and past them, documents, unsorted ids) against the plain
    backward, through its planned route, the same bits twice."""
    q, k, v, o, lse, do, kw = _masked_case(dev, 2, 8, 2, 700, 128,
                                           torch.bfloat16, layout, mask)
    refs = _masked_refs(q, k, v, o, lse, do, kw, layout, 128)
    backend.reset_launch_counts()
    first = A.flash_dq(q, k, v, o, lse, do, **kw)
    again = A.flash_dq(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert backend.route_counts() == {"wgmma flash_dq": 2}
    assert all(torch.equal(x, y) for x, y in zip(first, again))
    _hold_grads([_bhsd(first[0], layout, 128)], refs[:1], torch.bfloat16,
                ("dq",))
    torch.testing.assert_close(first[1], refs[3], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("b,h,hkv,s,d", [(2, 8, 2, 333, 128),
                                         (2, 4, 4, 70, 64),
                                         (1, 8, 8, 2048, 128)])
def test_k6_delta_equals_k10_prepass(dev, b, h, hkv, s, d, layout):
    """K6's delta and K10's pre-pass sum rowsum(dO O) in one order
    (flash_common.cuh, row_delta): the same bits."""
    q, k, v, o, lse, do, heads, scale = _bwd_case(
        dev, b, h, hkv, s, d, torch.bfloat16, layout, True)
    _, delta6 = A.flash_dq(q, k, v, o, lse, do, causal=True, scale=scale,
                           heads=heads)
    delta10 = A.flash_bwd_fused(q, k, v, o, lse, do, causal=True,
                                scale=scale, heads=heads)[3]
    assert torch.equal(delta6, delta10)


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("b,h,hkv,s,d", _BWD_WGMMA_SHAPES)
def test_k10_wgmma_matches_plain(dev, b, h, hkv, s, d, layout):
    """K10 (causal) through its planned route: each 64-row tile of dQ, dK
    and dV within 1e-2 of its own norm (dQ's low bits vary from run to
    run: its shares are added with atomics), delta within 1e-4."""
    q, k, v, o, lse, do, heads, scale = _bwd_case(
        dev, b, h, hkv, s, d, torch.bfloat16, layout, True)
    backend.reset_launch_counts()
    grads = A.flash_bwd_fused(q, k, v, o, lse, do, causal=True, scale=scale,
                              heads=heads)
    torch.cuda.synchronize()
    assert backend.route_counts() == {
        f"{A.plan_bwd(q.dtype)} flash_bwd_fused": 1}
    assert A.plan_bwd(q.dtype) == "wgmma"
    assert backend.launch_counts()["flash_bwd_fused"] == 1
    refs = A.flash_bwd_reference(
        *(_bhsd(t, layout, d) for t in (q, k, v, o)), lse,
        _bhsd(do, layout, d), True, scale)
    for g, like in zip(grads, (q, k, v, lse)):
        assert g.shape == like.shape and g.dtype == like.dtype
    _hold_grads([_bhsd(g, layout, d) for g in grads[:3]], refs[:3],
                torch.bfloat16)
    torch.testing.assert_close(grads[3], refs[3], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("mask", _MASKS, ids=_MASK_IDS)
def test_k10_wgmma_takes_every_mask(dev, mask, d):
    """K10's sweep under every mask (the dispatch sends it plain causal
    attention only), GQA, through its planned route: a warpgroup whose
    pair the mask empties still hands the other its zero half of ds^T."""
    q, k, v, o, lse, do, kw = _masked_case(dev, 2, 8, 2, 700, d,
                                           torch.bfloat16, "bshd", mask)
    backend.reset_launch_counts()
    grads = A.flash_bwd_fused(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert backend.route_counts() == {"wgmma flash_bwd_fused": 1}
    refs = _masked_refs(q, k, v, o, lse, do, kw, "bshd", d)
    _hold_grads([_bhsd(g, "bshd", d) for g in grads[:3]], refs[:3],
                torch.bfloat16)


def test_k6_and_k10_in_f32_keep_the_wmma_route(dev):
    q, k, v, o, lse, do, heads, scale = _bwd_case(
        dev, 2, 4, 2, 70, 64, torch.float32, "bhsd", True)
    backend.reset_launch_counts()
    A.flash_dq(q, k, v, o, lse, do, causal=True, scale=scale)
    A.flash_bwd_fused(q, k, v, o, lse, do, causal=True, scale=scale)
    assert backend.route_counts() == {"wmma flash_dq": 1,
                                      "wmma flash_bwd_fused": 1}


# -- K2: the elementwise kernel -----------------------------------------------

def _ulps(out, ref):
    """|out - ref| in units in the last place of ref, in ref's dtype."""
    bits = 24 if ref.dtype == torch.float32 else 8
    r = ref.float().abs()
    _, e = torch.frexp(r.clamp_min(torch.finfo(ref.dtype).tiny))
    return (out.float() - ref.float()).abs() / torch.ldexp(
        torch.ones_like(r), e - bits)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", backend.EW_OPS)
@pytest.mark.parametrize("n,offset", [(1, 0), (7, 0), (4096, 0),
                                      (1_000_003, 0), (4101, 1), (9, 3)])
def test_elementwise_kernel_matches_plain(dev, op, dtype, n, offset):
    """Odd sizes leave a tail past the last 16-byte vector; an offset
    view (4 or 12 bytes into an aligned buffer) takes the scalar path.
    relu/add/sub/mul are bit-equal to the plain version (one f32 op and
    one rounding on both sides); sigmoid (expf), div and fma within 2 ulp
    (fma is rounded once on both sides, the plain version through f64)."""
    E = importlib.import_module("taper_tpu_torch.ops.elementwise")
    gen = torch.Generator().manual_seed(n + offset)
    xs = []
    for i in range(E.ARITY[op]):
        base = _randn(gen, n + offset, dtype=dtype) * 3
        if op == "div" and i == 1:
            base = (torch.where(base < 0, -1.0, 1.0)
                    * (0.5 + base.float().abs())).to(dtype)
        xs.append(base.to(dev)[offset:])
    backend.reset_launch_counts()
    out = E.elementwise(op, *xs)
    torch.cuda.synchronize()
    assert backend.launch_counts()[op] == 1
    ref = E.elementwise_reference(op, *xs)
    assert out.dtype == dtype and out.shape == ref.shape
    if op in ("relu", "add", "sub", "mul"):
        assert torch.equal(out, ref)
    else:
        assert float(_ulps(out, ref).max()) <= 2.0


def test_elementwise_ops_on_card_are_differentiable(dev):
    E = importlib.import_module("taper_tpu_torch.ops.elementwise")
    gen = torch.Generator().manual_seed(0)
    a = _randn(gen, 4, 5, 6).to(dev).requires_grad_()
    b = (_randn(gen, 5, 1).abs() + 0.5).to(dev).requires_grad_()
    c = _randn(gen, 6).to(dev).requires_grad_()
    outs = [E.relu(a), E.sigmoid(a), E.add(a, b), E.sub(a, b), E.mul(a, b),
            E.div(a, b), E.fma(a, b, c)]
    torch.stack(outs).sum().backward()
    grads = [t.grad.clone() for t in (a, b, c)]
    ac, bc, cc = (t.detach().cpu().requires_grad_() for t in (a, b, c))
    ref = [torch.relu(ac), torch.sigmoid(ac), ac + bc, ac - bc, ac * bc,
           ac / bc, ac * bc + cc]
    torch.stack(ref).sum().backward()
    for g, r in zip(grads, (ac.grad, bc.grad, cc.grad)):
        torch.testing.assert_close(g.cpu(), r, rtol=1e-5, atol=1e-5)


def test_elementwise_kernel_raises_on_what_it_does_not_take(dev):
    E = importlib.import_module("taper_tpu_torch.ops.elementwise")
    x = torch.ones(4, 6, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        E.elementwise("relu", x.t())
    with pytest.raises(ValueError, match="dtype"):
        E.elementwise("relu", x.half())
    with pytest.raises(ValueError, match="differ"):
        E.elementwise("add", x, torch.ones(6, 4, device=dev))


# -- K17: the fused optimizer update ------------------------------------------

_OPT_CASES = [("adam", dict(wd=1e-2, decoupled=False)),
              ("adam", dict(wd=0.1, decoupled=True)),
              ("adam", dict(wd=0.0, decoupled=False)),
              ("sgd", dict(momentum=0.0, wd=0.0)),
              ("sgd", dict(momentum=0.9, wd=1e-2)),
              ("sgd", dict(momentum=0.0, wd=1e-2)),
              ("sgd", dict(momentum=0.9, wd=0.0))]


def _opt_run(dev, alg, hp, sizes, steps, none_at=(), lr=1e-2):
    """``steps`` updates by the kernel and by the plain version on copies
    of the same CUDA tensors; returns both parameter lists and the kernel
    launches."""
    K = importlib.import_module("taper_tpu_torch.ops.optim_kernels")
    gen = torch.Generator().manual_seed(len(sizes))
    ps = [_randn(gen, *s).to(dev) for s in sizes]
    runs = []
    backend.reset_launch_counts()
    for fused in (True, False):
        p = [t.clone() for t in ps]
        m = ([torch.zeros_like(t) for t in p]
             if alg == "adam" or hp.get("momentum") else None)
        v = [torch.zeros_like(t) for t in p]
        g_gen = torch.Generator().manual_seed(99)
        for t in range(1, steps + 1):
            g = [None if i in none_at else _randn(g_gen, *s).to(dev)
                 for i, s in enumerate(sizes)]
            if alg == "adam":
                step_size = lr * math.sqrt(1 - 0.999 ** t) / (1 - 0.9 ** t)
                kw = dict(lr=lr, step_size=step_size, b1=0.9, b2=0.999,
                          eps=1e-8, **hp)
                (K.adam_update if fused else K.adam_reference)(
                    p, g, m, v, **kw)
            else:
                (K.sgd_update if fused else K.sgd_reference)(
                    p, g, m, lr=lr, **hp)
        torch.cuda.synchronize()
        runs.append(p)
    return runs[0], runs[1], backend.launch_counts()[alg]


@pytest.mark.parametrize("alg,hp", _OPT_CASES,
                         ids=[f"{a}-{i}" for i, (a, _) in
                              enumerate(_OPT_CASES)])
def test_optimizer_kernel_matches_plain_over_ten_steps(dev, alg, hp):
    """Tensors of 1, 3, 8,192 (one chunk), 8,193 (a chunk and one) and
    100,000 elements and a 2-d one, one with a None gradient (a zero
    gradient, weight decay still moves it).  Tolerance 1e-6 (1 + |p|)
    after 10 steps: the same f32 formulas, but nvcc contracts a*b + c
    into FMAs (one rounding where the plain version rounds twice), and
    the plain version's _foreach ops order Adam's last product
    differently."""
    sizes = [(1,), (3,), (8192,), (8193,), (100_000,), (64, 33)]
    out, ref, launches = _opt_run(dev, alg, hp, sizes, 10, none_at=(3,))
    assert launches == 10
    for o, r in zip(out, ref):
        err = ((o - r).abs() / (1 + r.abs())).max()
        assert float(err) <= 1e-6


@pytest.mark.parametrize("alg,hp", [_OPT_CASES[1], _OPT_CASES[4]],
                         ids=["adamw", "sgd_momentum"])
def test_optimizer_kernel_splits_long_lists(dev, alg, hp):
    """300 tensors: more than one launch's table of 256."""
    sizes = [(i % 7 + 1, 5) for i in range(300)]
    out, ref, launches = _opt_run(dev, alg, hp, sizes, 3)
    assert launches == 3 * 2
    for o, r in zip(out, ref):
        assert float(((o - r).abs() / (1 + r.abs())).max()) <= 1e-6


def test_optimizer_kernel_raises_on_what_it_does_not_take(dev):
    K = importlib.import_module("taper_tpu_torch.ops.optim_kernels")
    p = [torch.ones(4, device=dev, dtype=torch.bfloat16)]
    with pytest.raises(ValueError, match="dtype"):
        K.sgd_update(p, [None], None, lr=0.1, momentum=0.0, wd=0.0)
    q = torch.ones(8, 2, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        K.sgd_update([q.t()], [None], None, lr=0.1, momentum=0.0, wd=0.0)
    with pytest.raises(ValueError, match="gradient"):
        K.sgd_update([q], [torch.ones(2, 8, device=dev)], None, lr=0.1,
                     momentum=0.0, wd=0.0)


def test_optimizers_launch_one_fused_update_per_step(dev):
    from taper_tpu_torch import optim

    model = mnist_cnn().to(dev)
    for opt, name in ((optim.Adam(1e-3, weight_decay=1e-4), "adam"),
                      (optim.AdamW(1e-3, weight_decay=1e-2), "adam"),
                      (optim.SGD(0.1, momentum=0.9), "sgd")):
        opt.init(model.parameters())
        backend.reset_launch_counts()
        for _ in range(3):
            for p in model.parameters():
                p.grad = torch.ones_like(p)
            opt.step()
        counts = backend.launch_counts()
        assert counts[name] == 3 and sum(counts.values()) == 3, counts


# -- quantized products (K12, K13, K14, K15a/b) -----------------------------

Q = importlib.import_module("taper_tpu_torch.ops.quant")


def _qweight(gen, n, k, bits, per_channel, symmetric):
    """Random int codes with their scale and zero point, as PTQ makes
    them: the weight ``(q - zp) * scale``."""
    from taper_tpu_torch.quantization import (
        QuantizationConfig, QuantizationSchema, QuantizationType, quantize)
    w = _randn(gen, n, k, scale=0.05)
    cfg = QuantizationConfig(
        QuantizationType.INT8 if bits == 8 else QuantizationType.INT4,
        QuantizationSchema.PER_CHANNEL if per_channel
        else QuantizationSchema.UNIFORM, symmetric)
    return quantize(w, cfg)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m,n,k", [
    (8, 2048, 2048), (8, 512, 2048), (8, 2048, 8192), (2000, 128, 128),
    (2000, 10, 64), (300, 1024, 512), (5, 19, 38), (17, 70, 130)])
@pytest.mark.parametrize("per_channel,symmetric,bias,act", [
    (False, False, True, "none"), (True, False, False, "relu"),
    (False, True, True, "sigmoid"), (True, True, False, "none")])
def test_linear_q_kernel_matches_plain(dev, bits, m, n, k, per_channel,
                                       symmetric, bias, act):
    gen = torch.Generator().manual_seed(m * n + k + bits)
    qt = _qweight(gen, n, k, bits, per_channel, symmetric).to(dev)
    x = _randn(gen, m, k).to(dev)
    b = _randn(gen, n, scale=0.1).to(dev) if bias else None
    backend.reset_launch_counts()
    if bits == 8:
        y = Q.linear_q8(x, qt.values, qt.scale, qt.zero_point, b,
                        epilogue=act)
        ref = Q.linear_q8_reference(x, qt.values, qt.scale, qt.zero_point,
                                    b, act)
    else:
        y = Q.linear_q4(x, qt.values, qt.scale, qt.zero_point, b,
                        n_features=k, epilogue=act)
        ref = Q.linear_q4_reference(x, qt.values, qt.scale, qt.zero_point,
                                    b, n_features=k, epilogue=act)
    torch.cuda.synchronize()
    assert backend.launch_counts()[f"linear_q{bits}"] == 1
    assert y.dtype == torch.float32 and y.shape == (m, n)
    torch.testing.assert_close(y, ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k", [(300, 2048), (16, 8192), (34, 192),
                                 (5, 37), (1, 1)])
def test_quantize_rows_kernel_is_exact(dev, m, k, dtype):
    gen = torch.Generator().manual_seed(m + k)
    x = _randn(gen, m, k, dtype=dtype, scale=2.0).to(dev)
    x[0, 0] = 0.0
    backend.reset_launch_counts()
    out = Q.quantize_rows(x)
    torch.cuda.synchronize()
    assert backend.launch_counts()["quantize_rows"] == 1
    for got, want in zip(out, Q.quantize_rows_reference(x)):
        assert got.dtype == want.dtype
        assert torch.equal(got, want)


@pytest.mark.parametrize("m,n,k", [(37, 53, 100), (512, 384, 2048),
                                   (300, 130, 64), (1, 1, 16),
                                   (256, 2048, 8192)])
def test_matmul_int8_kernels_are_exact(dev, m, n, k):
    gen = torch.Generator().manual_seed(m + n + k)
    xq = torch.randint(-127, 128, (m, k), generator=gen,
                       dtype=torch.int8).to(dev)
    q = torch.randint(-128, 128, (n, k), generator=gen,
                      dtype=torch.int8).to(dev)
    backend.reset_launch_counts()
    acc = Q.matmul_int8(xq, q)
    torch.cuda.synchronize()
    assert backend.launch_counts()["matmul_int8"] == 1
    assert acc.dtype == torch.int32
    assert torch.equal(acc, Q.matmul_int8_reference(xq, q))
    sx = torch.rand(m, generator=gen).to(dev) * 0.01
    corr = xq.float().sum(1)
    sw = torch.rand(n, generator=gen).to(dev) * 0.01
    zw = torch.randint(-5, 5, (n,), generator=gen).float().to(dev)
    bias = _randn(gen, n).to(dev)
    for out_dtype, b, relu in ((torch.float32, bias, False),
                               (torch.bfloat16, None, True),
                               (torch.float32, None, True)):
        y = Q.matmul_int8_scaled(xq, q, sx, corr, sw, zw, b, relu,
                                 out_dtype)
        want = Q.matmul_int8_scaled_reference(xq, q, sx, corr, sw, zw, b,
                                              relu, out_dtype)
        assert y.dtype == out_dtype
        assert torch.equal(y, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["none", "relu", "sigmoid"])
def test_linear_w8a8_on_card_matches_plain(dev, dtype, act):
    gen = torch.Generator().manual_seed(7)
    qt = _qweight(gen, 384, 512, 8, True, False).to(dev)
    x = _randn(gen, 256, 512, dtype=dtype).to(dev)
    b = _randn(gen, 384, scale=0.1).to(dev)
    backend.reset_launch_counts()
    y = Q.linear_w8a8(x, qt.values, qt.scale, qt.zero_point, b,
                      epilogue=act)
    torch.cuda.synchronize()
    counts = backend.launch_counts()
    assert counts["quantize_rows"] == 1
    assert counts["matmul_int8_scaled"] == 1
    xq, sx, corr = Q.quantize_rows_reference(x)
    want = Q.matmul_int8_scaled_reference(
        xq, qt.values, sx, corr, qt.scale.expand(384),
        qt.zero_point.float(), b, act == "relu", y.dtype)
    if act == "sigmoid":
        want = torch.sigmoid(want)
    assert y.dtype == (dtype if dtype == torch.bfloat16 else torch.float32)
    torch.testing.assert_close(y, want, rtol=0, atol=0)


def test_quant_kernels_refuse_grad(dev):
    """No backward kernel: a CUDA input that requires grad raises under
    grad mode, and runs under no_grad."""
    gen = torch.Generator().manual_seed(3)
    q8 = _qweight(gen, 32, 64, 8, False, False).to(dev)
    q4 = _qweight(gen, 32, 64, 4, False, False).to(dev)
    x = _randn(gen, 256, 64).to(dev).requires_grad_()
    calls = (
        lambda: Q.linear_q8(x, q8.values, q8.scale, q8.zero_point),
        lambda: Q.linear_q4(x, q4.values, q4.scale, q4.zero_point,
                            n_features=64),
        lambda: Q.quantize_rows(x),
        lambda: Q.linear_w8a8(x, q8.values, q8.scale, q8.zero_point))
    for call in calls:
        with pytest.raises(RuntimeError, match="no backward"):
            call()
        with torch.no_grad():
            out = call()
        for t in out if isinstance(out, tuple) else (out,):
            assert torch.isfinite(t.float()).all()


def test_quantized_linear_dispatch_on_card(dev, monkeypatch):
    """``ops.linear`` with a QuantizedTensor: int8 to K12 at every M, int4
    to K13, other formats dequantized to K1, W8A8 (opt-in) to K14 + K15a
    from 256 rows."""
    import copy

    from taper_tpu_torch import ops
    from taper_tpu_torch.quantization import QuantizationConfig, quantize

    gen = torch.Generator().manual_seed(5)
    w = _randn(gen, 96, 128, scale=0.05)
    x = _randn(gen, 300, 128).to(dev)
    cases = ((QuantizationConfig.int8(), {"linear_q8": 1}),
             (QuantizationConfig.int4(), {"linear_q4": 1}),
             (QuantizationConfig.nf4(), {"linear": 1}),
             (QuantizationConfig.fp8_e4m3(), {"linear": 1}))
    for cfg, want in cases:
        qt = quantize(w, cfg).to(dev)
        for rows in (1, 300):
            backend.reset_launch_counts()
            y = ops.linear(x[:rows], qt, activation="relu")
            torch.cuda.synchronize()
            got = {k: c for k, c in backend.launch_counts().items() if c}
            assert got == want, (cfg, rows, got)
            ref = ops.linear(x[:rows].cpu(), copy.deepcopy(qt).cpu(),
                             activation="relu")
            torch.testing.assert_close(y.cpu(), ref, rtol=2e-4, atol=2e-4)
    monkeypatch.setenv("TAPER_W8A8", "1")
    qt = quantize(w, QuantizationConfig.int8()).to(dev)
    for rows, want in ((255, {"linear_q8": 1}),
                       (256, {"quantize_rows": 1,
                              "matmul_int8_scaled": 1})):
        backend.reset_launch_counts()
        ops.linear(x[:rows], qt)
        torch.cuda.synchronize()
        got = {k: c for k, c in backend.launch_counts().items() if c}
        assert got == want, (rows, got)


def test_quantized_model_moves_to_the_card(dev):
    """A PTQ copy of TinyGPT moves its quantized buffers with
    ``model.to``, and its decode step runs 6 K12 launches a block."""
    from taper_tpu_torch.models import TinyGPT
    from taper_tpu_torch.quantization import (QuantizationConfig,
                                              quantize_params)

    cfg = dict(vocab_size=64, dim=128, depth=2, num_heads=2,
               num_kv_heads=1, max_seq=64, rope=True)
    cpu = TinyGPT(**cfg)
    cpu.reset_parameters(torch.Generator().manual_seed(0))
    qcpu = quantize_params(cpu, QuantizationConfig.int8()).eval()
    qcard = quantize_params(cpu, QuantizationConfig.int8()).to(dev).eval()
    assert qcard.blocks[0].attn.wq.values.device.type == "cuda"
    assert qcard.blocks[0].attn.wq.values.dtype == torch.int8
    table = torch.arange(1, 9, dtype=torch.int32)[None]
    prompt = torch.randint(0, 64, (1, 16),
                           generator=torch.Generator().manual_seed(1))
    outs = []
    with torch.no_grad():
        for model, d in ((qcpu, "cpu"), (qcard, dev)):
            pools = model.init_paged_cache(9, 8, device=d)
            model.prefill_paged(prompt.to(d), pools, table.to(d))
            backend.reset_launch_counts()
            step = model.decode_step_paged(
                torch.tensor([3], device=d),
                torch.tensor([16], dtype=torch.int32, device=d), pools,
                table.to(d))
            outs.append((step.cpu(), backend.launch_counts()))
    (ref, _), (out, counts) = outs
    assert counts["linear_q8"] == 12 and counts["linear"] == 0, counts
    torch.testing.assert_close(out, ref, rtol=1e-3, atol=1e-4)


# -- K1's routes (ops/gemm.py plan): wgmma, wmma, decode, f32, split-K ------

_K1_CASES = [
    # route, mode, M, N, K, dtype: M != N != K throughout
    ("wgmma", "nt", 300, 264, 520), ("wgmma", "nn", 300, 264, 520),
    ("wgmma", "tn", 296, 264, 520),
    ("wgmma", "nt", 200, 262, 136),      # N of 262: direct stores
    ("wgmma", "nt", 16384, 4096, 1024),  # the 170M (e, 4e) projection
    ("wgmma", "nn", 16384, 1024, 4096),
    ("wgmma", "tn", 4096, 1024, 16384),
    ("wgmma", "tn", 1024, 1024, 16384),  # (e, e) dW: split in 2
    ("wgmma", "nn", 384, 256, 4096),     # split
    ("wmma", "nt", 33, 70, 130), ("wmma", "nn", 33, 70, 130),
    ("wmma", "tn", 33, 70, 130), ("wmma", "nt", 300, 264, 1001),
    ("decode", "nt", 16, 1024, 1024), ("decode", "nt", 5, 19, 37),
    ("f32", "nt", 256, 128, 128), ("f32", "nn", 256, 64, 128),
    ("f32", "tn", 128, 128, 256), ("f32", "tn", 128, 128, 8192),
    ("f32", "tn", 32, 144, 65536), ("f32", "nn", 65536, 144, 32),
    ("f32", "nt", 65536, 32, 144), ("f32", "tn", 10, 64, 256),
    ("f32", "nt", 5, 19, 37),
]


def _k1_operands(dev, mode, m, n, k, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed + m + n + k)
    a = _randn(gen, *((m, k) if mode != "tn" else (k, m)), dtype=dtype)
    b = _randn(gen, *((n, k) if mode == "nt" else (k, n)), dtype=dtype,
               scale=k ** -0.5)
    return a.to(dev), b.to(dev)


def _k1(a, b, mode, bias=None, activation="none", out_dtype=None):
    if mode == "nt":
        return G.linear(a, b, bias, activation, out_dtype=out_dtype)
    return G.gemm(a, b, mode, out_dtype=out_dtype)


@pytest.mark.parametrize("route,mode,m,n,k", _K1_CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}x{c[3]}x{c[4]}"
                              for c in _K1_CASES])
def test_k1_route_matches_plain_and_writes_bf16_bits(dev, route, mode, m, n,
                                                     k):
    """Each route and mode against the plain product (f32: 1e-4; bf16
    operands: 2e-4, exact products summed in another order), through the
    route plan names; a bf16 output equals the f32 output cast to bf16,
    bit for bit."""
    dtype = _k1_dtype(route)
    a, b = _k1_operands(dev, mode, m, n, k, dtype)
    want, splits = G.plan_for(a, b, mode)
    assert want == route
    gen = torch.Generator().manual_seed(k)
    bias = (_randn(gen, n, dtype=dtype).to(dev) if mode == "nt" else None)
    backend.reset_launch_counts()
    y = _k1(a, b, mode, bias)
    torch.cuda.synchronize()
    key = f"{route} {mode}" + (" split" if splits > 1 else "")
    assert backend.route_counts() == {key: 1}
    counter = "linear" if mode == "nt" else f"gemm_{mode}"
    assert backend.launch_counts()[counter] == 1
    assert y.dtype == torch.float32 and tuple(y.shape) == (m, n)
    ref = G.gemm_reference(a, b, mode)
    if bias is not None:
        ref = ref + bias.float()
    _close(y, ref, dtype, 2e-4)
    if dtype == torch.bfloat16:
        y16 = _k1(a, b, mode, bias, out_dtype=torch.bfloat16)
        assert y16.dtype == torch.bfloat16
        assert torch.equal(y16, y.to(torch.bfloat16))


def _k1_dtype(route):
    return torch.float32 if route == "f32" else torch.bfloat16


@pytest.mark.parametrize("route,mode,m,n,k", [
    c for c in _K1_CASES if c[0] in G.TILES
    and G.plan(*c[2:], _k1_dtype(c[0]), c[1], True)[1] > 1])
def test_k1_split_matches_unsplit(dev, monkeypatch, route, mode, m, n, k):
    """A call split over K against the same call unsplit (plan forced to
    one split): f32 sums in another order, 1e-4 (bf16 operands: 2e-4);
    and against the plain split sum in the kernels' order."""
    dtype = _k1_dtype(route)
    a, b = _k1_operands(dev, mode, m, n, k, dtype, seed=1)
    _, splits = G.plan_for(a, b, mode)
    assert splits > 1
    y = _k1(a, b, mode)
    monkeypatch.setattr(G, "plan", lambda *args: (route, 1))
    y1 = _k1(a, b, mode)
    torch.cuda.synchronize()
    _close(y, y1, dtype, 2e-4)
    _close(y, G.gemm_reference_split(a, b, mode, splits,
                                     G.TILES[route][2]), dtype, 2e-4)


@pytest.mark.parametrize("mode,m,n,k,dtype", [
    ("tn", 1024, 1024, 16384, torch.bfloat16),
    ("nt", 300, 264, 520, torch.bfloat16),
    ("tn", 128, 128, 8192, torch.float32),
    ("tn", 32, 144, 65536, torch.float32),
    ("nt", 256, 128, 128, torch.float32)])
def test_k1_split_is_bitwise_repeatable(dev, mode, m, n, k, dtype):
    """Split-K sums its splits in a fixed order without atomics: two calls
    give the same bits (a resumed run stays bit-equal)."""
    a, b = _k1_operands(dev, mode, m, n, k, dtype, seed=2)
    assert G.plan_for(a, b, mode)[1] > 1
    y0, y1 = _k1(a, b, mode), _k1(a, b, mode)
    assert torch.equal(y0, y1)


@pytest.mark.parametrize("mode", ["nt", "nn", "tn"])
def test_k1_misaligned_bf16_view_takes_wmma(dev, mode):
    """A bf16 operand 2 bytes off a 16-byte boundary cannot go through
    TMA: the wmma route takes it, and gives the plain product."""
    m, n, k = 96, 80, 136
    a, b = _k1_operands(dev, mode, m, n, k, torch.bfloat16, seed=3)
    flat = torch.empty(a.numel() + 1, dtype=a.dtype, device=dev)
    flat[1:] = a.reshape(-1)
    a_off = flat[1:].view(a.shape)
    assert a_off.data_ptr() % 16 and a_off.is_contiguous()
    assert G.plan_for(a_off, b, mode) == ("wmma", 1)
    backend.reset_launch_counts()
    y = _k1(a_off, b, mode)
    torch.cuda.synchronize()
    assert backend.route_counts() == {f"wmma {mode}": 1}
    _close(y, G.gemm_reference(a, b, mode), torch.bfloat16, 2e-4)


def test_k1_bf16_projection_grads_on_card_match_the_cast(dev):
    """``linear(..., out_dtype=bf16)`` on the card (the bf16 trunk's
    projection): output and gradients equal those of the f32 output cast
    to bf16, bit for bit."""
    gen = torch.Generator().manual_seed(4)
    x = _randn(gen, 512, 1024, dtype=torch.bfloat16).to(dev)
    w = _randn(gen, 4096, 1024, dtype=torch.bfloat16, scale=0.03).to(dev)
    b = _randn(gen, 4096, dtype=torch.bfloat16).to(dev)
    ct = _randn(gen, 512, 4096).to(dev)
    res = []
    for fn in (lambda *t: G.linear(*t, out_dtype=torch.bfloat16),
               lambda *t: G.linear(*t).to(torch.bfloat16)):
        leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
        out = fn(*leaves)
        (out.float() * ct).sum().backward()
        res.append([out.detach()] + [t.grad for t in leaves])
    for new, old in zip(*res):
        assert new.dtype == old.dtype == torch.bfloat16
        assert torch.equal(new, old)
