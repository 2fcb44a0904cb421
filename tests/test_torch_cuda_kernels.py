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
"""

import pytest
import torch

from taper_tpu_torch import losses
from taper_tpu_torch.models import mnist_cnn
from taper_tpu_torch.ops import backend
from taper_tpu_torch.ops import conv_direct as CD
from taper_tpu_torch.ops import gemm as G
from taper_tpu_torch.ops import paged_attention as PA
from taper_tpu_torch.ops import pool as PL
from taper_tpu_torch.ops.attention import attention, attention_reference
from taper_tpu_torch.ops.conv import conv2d

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
    assert backend.launch_counts()["flash_fwd"] == 1
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


def test_gemm_backward_modes_refuse_bf16(dev):
    a = torch.zeros(4, 8, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="M2"):
        G.gemm(a, torch.zeros(8, 3, device=dev, dtype=torch.bfloat16), "nn")


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


def test_conv_dw_is_deterministic(dev):
    gen = torch.Generator().manual_seed(11)
    x = _randn(gen, 256, 32, 28, 28).to(dev)
    g = _randn(gen, 256, 32, 28, 28).to(dev)
    first = CD.conv_dw(x, g, (3, 3), (1, 1))
    assert torch.equal(first, CD.conv_dw(x, g, (3, 3), (1, 1)))


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


def test_kernels_without_backward_raise_under_grad(dev):
    """attention and paged decode have no backward kernel yet (M2): a
    CUDA input that requires grad raises instead of a detached result."""
    q = torch.zeros(1, 2, 8, 64, device=dev, requires_grad=True)
    with pytest.raises(RuntimeError, match="M2"):
        attention(q, q, q)
    with torch.no_grad():
        attention(q, q, q)
    qd = torch.zeros(1, 1, 1, 64, device=dev, requires_grad=True)
    pool = torch.zeros(2, 1, 8, 64, device=dev)
    tables = torch.zeros(1, 1, dtype=torch.int32, device=dev)
    lengths = torch.ones(1, dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="M2"):
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
