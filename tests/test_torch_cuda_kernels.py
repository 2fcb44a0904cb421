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
  * paged decode (K16): 1e-4 (1 + |ref|) with f32 q; with bf16 q,
    8e-3 (|ref| + 1e-3), one bf16 rounding of nearly the same f32 value
    (2^-7 |ref| at most).  Both sides compute in f32 and round o once;
    over int8 pools from the same codes and scales, the kernel applying
    the k scale to the score and the v scale to the weight where the plain
    version scales the rows, and summing in another order.  Planted
    faults in the merge show what this check and the 2e-2 (1 + |ref|) it
    replaced read.
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

import functools
import importlib
import math
import shutil
import subprocess
import sys
from pathlib import Path

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


def _plant(tmp_path, monkeypatch, name, line, fault, what):
    """Rebuilds the kernels from a copy of csrc with ``line`` of ``name``
    replaced by ``fault``."""
    _plant_lines(tmp_path, monkeypatch, name, [(line, fault)], what)


def _plant_lines(tmp_path, monkeypatch, name, lines, what):
    """Rebuilds the kernels from a copy of csrc with each ``(line,
    fault)`` of ``lines`` in ``name`` replaced.  A planted-fault test runs
    in a child process of its own (:func:`_in_child`), which gets no
    ``monkeypatch``: the faulty library is the only one it loads."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    src = (csrc / name).read_text()
    for line, fault in lines:
        assert src.count(line) == 1, what
        src = src.replace(line, fault)
    (csrc / name).write_text(src)
    if monkeypatch is None:
        _build.CSRC, _build.BUILD_DIR, _build._lib = (
            csrc, tmp_path / "build", None)
    else:
        monkeypatch.setattr(_build, "CSRC", csrc)
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
        monkeypatch.setattr(_build, "_lib", None)


# a planted-fault test's child process: its rebuild and its check
PLANTED_TIMEOUT = 900


def _in_child(test):
    """Run a planted-fault test in a child process of ``sys.executable``,
    with a time limit of its own.  Each rebuild loads a whole kernel
    library with ``ctypes`` and nothing unloads one, so a run of every
    planted fault in one process piles libraries up in the CUDA context
    (the card suite stalled that way); a child loads one and exits.  The
    child's output is printed here; its failure, or its time limit, fails
    the test with that output."""

    @functools.wraps(test)
    def run(dev, tmp_path, monkeypatch, **params):
        code = (
            "import importlib.util, sys, torch\n"
            "from pathlib import Path\n"
            f"spec = importlib.util.spec_from_file_location("
            f"'card_tests', {__file__!r})\n"
            "mod = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(mod)\n"
            f"mod.{test.__name__}.__wrapped__(dev=torch.device('cuda'), "
            f"tmp_path=Path({str(tmp_path)!r}), monkeypatch=None, "
            f"**{params!r})\n")
        try:
            proc = subprocess.run(
                [sys.executable, "-c", code], capture_output=True,
                text=True, timeout=PLANTED_TIMEOUT,
                cwd=Path(__file__).resolve().parents[1])
        except subprocess.TimeoutExpired as e:
            pytest.fail(f"{test.__name__}: the child ran past "
                        f"{PLANTED_TIMEOUT} s; its output:\n"
                        f"{e.stdout or ''}{e.stderr or ''}")
        print(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            pytest.fail(f"{test.__name__}: the child exited with "
                        f"{proc.returncode}:\n{proc.stdout}{proc.stderr}")

    return run


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


def _k16_err(o, ref):
    """K16's statistic against its plain version, held to 1: |o - ref| /
    (1e-4 (1 + |ref|)) with f32 q, |o - ref| / (8e-3 (|ref| + 1e-3))
    with bf16 q (both round o once from f32)."""
    err, ref = (o.float() - ref.float()).abs(), ref.float().abs()
    if o.dtype == torch.float32:
        return float((err / (1e-4 * (1 + ref))).max())
    return float((err / (8e-3 * (ref + 1e-3))).max())


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
    assert o.dtype == dtype and _k16_err(o, ref) <= 1


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
    assert _k16_err(o, ref) <= 1


# K16 split across blocks (ops.paged_attention.plan): shapes whose plan
# gives 1, 2, 3, 4, 8, 16 and 32 splits over bf16 pools, as (mb, bs, d, g,
# splits); f32 and int8 pools split them their own way
_K16_SPLITS = [(1, 128, 128, 1, 1), (2, 128, 128, 2, 2), (5, 128, 128, 4, 3),
               (8, 128, 64, 8, 4), (8, 128, 128, 1, 8),
               (16, 128, 128, 1, 16), (32, 128, 128, 2, 32),
               (32, 16, 64, 1, 2), (3, 16, 64, 2, 1)]


@pytest.mark.parametrize("mb,bs,d,g,splits", _K16_SPLITS)
@pytest.mark.parametrize("qdt,pdt", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.int8), (torch.float32, torch.int8)],
    ids=["f32", "bf16", "int8-bf16q", "int8-f32q"])
def test_k16_at_every_split_matches_plain(dev, qdt, pdt, mb, bs, d, g,
                                          splits):
    """K16 on the split ``plan`` gives against the plain version,
    at lengths 1, bs, bs + 1, a chunk's boundary and its neighbours, mb bs
    and past it, within K16's tolerance (``_k16_err``); counted by route,
    and a second call bit-equal."""
    b, kvh = 8, 2
    got = PA.plan(b, kvh, g, d, bs, mb, pdt)
    if pdt == torch.bfloat16:
        assert got[0] == splits, got
    chunk = got[1]
    lengths = [1, bs, bs + 1, max(1, chunk * bs - 1), chunk * bs,
               chunk * bs + 1, mb * bs, mb * bs + 9]
    gen = torch.Generator().manual_seed(mb * bs + d + g)
    n_blocks = b * mb + 1
    q = _randn(gen, b, kvh, g, d, dtype=qdt).to(dev)
    tables = torch.randperm(n_blocks, generator=gen)[:b * mb]
    tables = tables.reshape(b, mb).to(torch.int32).to(dev)
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    if pdt == torch.int8:
        kp, ks, vp, vs = _int8_pools(gen, n_blocks, kvh, bs, d, dev)
        sc = dict(k_scales=ks, v_scales=vs)
    else:
        kp = _randn(gen, n_blocks, kvh, bs, d, dtype=pdt).to(dev)
        vp = _randn(gen, n_blocks, kvh, bs, d, dtype=pdt).to(dev)
        sc = {}
    name = "paged_decode_int8" if pdt == torch.int8 else "paged_decode"
    backend.reset_launch_counts()
    o = PA.paged_decode_attention(q, kp, vp, tables, ln, scale=d ** -0.5,
                                  **sc)
    again = PA.paged_decode_attention(q, kp, vp, tables, ln,
                                      scale=d ** -0.5, **sc)
    torch.cuda.synchronize()
    assert backend.launch_counts()[name] == 2
    route = "split" if got[0] > 1 else "whole"
    assert backend.route_counts() == {f"{route} {name}": 2}
    ref = PA.paged_decode_reference(q, kp, vp, tables, ln, scale=d ** -0.5,
                                    **sc)
    assert _k16_err(o, ref) <= 1
    assert torch.equal(o, again)


@pytest.mark.parametrize("splits,chunk", [(2, 3), (3, 2), (6, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
def test_k16_forced_splits_of_small_pages(dev, monkeypatch, dtype, splits,
                                          chunk):
    """Splits ``plan`` does not give for pages of 16 rows (a stage of less
    than a page's ring slot), forced through it: the kernel against the
    plain version and against the split reference of the same chunking."""
    monkeypatch.setattr(PA, "plan", lambda *a: (splits, chunk))
    b, kvh, g, d, bs, mb = 8, 2, 4, 64, 16, 6
    lengths = [1, bs, bs + 1, chunk * bs - 1, chunk * bs, chunk * bs + 1,
               mb * bs, mb * bs + 3]
    gen = torch.Generator().manual_seed(splits * 10 + chunk)
    n_blocks = b * mb + 1
    qdt = torch.float32 if dtype == torch.int8 else dtype
    q = _randn(gen, b, kvh, g, d, dtype=qdt).to(dev)
    tables = torch.randperm(n_blocks, generator=gen)[:b * mb]
    tables = tables.reshape(b, mb).to(torch.int32).to(dev)
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    if dtype == torch.int8:
        kp, ks, vp, vs = _int8_pools(gen, n_blocks, kvh, bs, d, dev)
        sc = dict(k_scales=ks, v_scales=vs)
    else:
        kp = _randn(gen, n_blocks, kvh, bs, d, dtype=dtype).to(dev)
        vp = _randn(gen, n_blocks, kvh, bs, d, dtype=dtype).to(dev)
        sc = {}
    o = PA.paged_decode_attention(q, kp, vp, tables, ln, scale=0.125, **sc)
    torch.cuda.synchronize()
    for ref in (PA.paged_decode_reference(q, kp, vp, tables, ln,
                                          scale=0.125, **sc),
                PA.paged_decode_reference_split(
                    q, kp, vp, tables, ln, scale=0.125, splits=splits,
                    chunk=chunk, **sc)):
        assert _k16_err(o, ref) <= 1


# Faults planted in csrc/paged_decode.cu's merge (every row of more than
# one split): (what, the line as it is, the line with the fault)
_K16_FAULTS = [
    ("K16's merge drops a row's last split",
     "    for (int s = 0; s < n; ++s) {",
     "    for (int s = 0; s < n - 1; ++s) {"),
    ("K16's merge halves the first split's weight",
     "      const float f = exp2f(ml[at * 2] - mx);",
     "      const float f = exp2f(ml[at * 2] - mx) * (s ? 1.0f : 0.5f);"),
]


@pytest.mark.parametrize("what,line,fault", _K16_FAULTS,
                         ids=[f[0] for f in _K16_FAULTS])
@pytest.mark.parametrize("pdt", [torch.bfloat16, torch.int8])
@_in_child
def test_k16_check_catches_a_planted_fault(dev, tmp_path, monkeypatch, pdt,
                                           what, line, fault):
    """K16's bf16 check fails a merge built with a split dropped or
    misweighted, at bench_paged_decode's mixed rows (16 rows of 257 and
    4,033 positions, 8 KV heads, D 128, bs 128, 32 entries, bf16 q); the
    2e-2 (1 + |ref|) check it replaced is printed beside it."""
    _plant(tmp_path, monkeypatch, "paged_decode.cu", line, fault, what)
    b, kvh, d, bs, mb = 16, 8, 128, 128, 32
    gen = torch.Generator().manual_seed(5)
    n_blocks = b * mb + 1
    q = _randn(gen, b, kvh, 1, d, dtype=torch.bfloat16).to(dev)
    tables = torch.randperm(n_blocks, generator=gen)[:b * mb]
    tables = tables.reshape(b, mb).to(torch.int32).to(dev)
    ln = torch.tensor([257, 4033] * (b // 2), dtype=torch.int32, device=dev)
    if pdt == torch.int8:
        kp, ks, vp, vs = _int8_pools(gen, n_blocks, kvh, bs, d, dev)
        sc = dict(k_scales=ks, v_scales=vs)
    else:
        kp, vp = (_randn(gen, n_blocks, kvh, bs, d, dtype=pdt).to(dev)
                  for _ in range(2))
        sc = {}
    assert PA.plan(b, kvh, 1, d, bs, mb, pdt)[0] > 1
    o = PA.paged_decode_attention(q, kp, vp, tables, ln, scale=d ** -0.5,
                                  **sc)
    ref = PA.paged_decode_reference(q, kp, vp, tables, ln, scale=d ** -0.5,
                                    **sc)
    old = float(((o.float() - ref.float()).abs()
                 / (1 + ref.float().abs())).max())
    print(f"{what}, {pdt} pools: K16's check {_k16_err(o, ref):.3e} "
          f"(held to 1), the old check {old:.3e} (held to 2e-2)")
    assert _k16_err(o, ref) > 1, what


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
     "const int total = n_g * n_q;",
     "const int total = n_g * n_q - 1;"),
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


@pytest.mark.parametrize("what,name,line,fault", _FAULTS,
                         ids=[f[0] for f in _FAULTS])
@_in_child
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


# The cases the f32 faults are checked at: (B, H, Hkv, S, D, causal,
# window).  "sort" is the sort task's shape (examples/train_tinylm.py's
# defaults: batch 64, 2 heads of 64, S 128, causal); "gqa" a GQA group of
# 2 at ragged S, where K7 runs two thread groups; "window" phase 24's
# non-causal window of 256, where K6 runs 32-row tiles and two groups.
_F32_CASES = {"sort": (64, 2, 2, 128, 64, True, None),
              "gqa": (2, 4, 2, 70, 64, True, None),
              "window": (1, 4, 4, 1024, 64, False, 256)}


def _f32_fault_case(dev, case):
    b, h, hkv, s, d, causal, window = _F32_CASES[case]
    q, k, v, o, lse, do, kw = _masked_case(dev, b, h, hkv, s, d,
                                           torch.float32, "bhsd",
                                           (causal, window, None))
    refs = _masked_refs(q, k, v, o, lse, do, kw, "bhsd", d)
    return q, k, v, o, lse, do, kw, refs


# Faults planted in flash_bwd_f32.cu's K7 (every f32 K7 launch): (what,
# the line as it is, the line with the fault, the case).
_F32_DKV_FAULTS = [
    ("K7 skips the last query tile",
     "const int n_q = (q_hi - q_lo + BQ - 1) / BQ;",
     "const int n_q = (q_hi - q_lo + BQ - 1) / BQ - 1;", "sort"),
    ("K7 leaves dK unscaled",
     "store_block(dk + koff, lay.ks, dka, kv0, S, scale, ty, tx);",
     "store_block(dk + koff, lay.ks, dka, kv0, S, 1.0f, ty, tx);", "sort"),
    ("K7 drops the last query head of a GQA group",
     "const int total = n_g * n_q;",
     "const int total = (n_g - 1) * n_q;", "gqa"),
]


@pytest.mark.parametrize("what,line,fault,case", _F32_DKV_FAULTS,
                         ids=[f[0] for f in _F32_DKV_FAULTS])
@_in_child
def test_flash_dkv_f32_check_catches_a_planted_fault(dev, tmp_path,
                                                     monkeypatch, what,
                                                     line, fault, case):
    """The f32 check of K7 (1e-4, as test_flash_bwd_kernels_match_plain
    holds it) fails a kernel built with a fault in its sweep, at the case
    the fault names (_F32_CASES)."""
    _plant(tmp_path, monkeypatch, "flash_bwd_f32.cu", line, fault, what)
    q, k, v, o, lse, do, kw, refs = _f32_fault_case(dev, case)
    backend.reset_launch_counts()
    dk, dv = A.flash_dkv(q, k, v, lse, refs[3].contiguous(), do, **kw)
    torch.cuda.synchronize()
    assert backend.route_counts() == {"f32 flash_dkv": 1}
    errs = {name: float((g - r).abs().max())
            for name, g, r in zip(("dk", "dv"), (dk, dv), refs[1:3])}
    print(f"{what}: max error {errs} (the check's 1e-4)")
    assert not all(torch.allclose(g, r, rtol=1e-4, atol=1e-4)
                   for g, r in zip((dk, dv), refs[1:3])), (what, errs)


# Faults planted in flash_bwd_f32.cu's K6 (every f32 K6 launch): (what,
# the line as it is, the line with the fault, the case).
_F32_DQ_FAULTS = [
    ("K6 skips its last KV tile",
     "const int n_tiles = (hi - lo + BKV - 1) / BKV;",
     "const int n_tiles = (hi - lo + BKV - 1) / BKV - 1;", "sort"),
    ("K6 drops delta from dS",
     "dSs[(ty + 16 * i) * LDS + c] = p * (dp[i][j] - dl[i]);",
     "dSs[(ty + 16 * i) * LDS + c] = p * dp[i][j];", "sort"),
    ("K6 under a window skips the band's first KV tile",
     "const int lo = MASKED && window > 0 ? max(0, q0 - window + 1) / BKV"
     " * BKV",
     "const int lo = MASKED && window > 0 ? max(0, q0 - window + 1) / BKV"
     " * BKV + BKV", "window"),
]


@pytest.mark.parametrize("what,line,fault,case", _F32_DQ_FAULTS,
                         ids=[f[0] for f in _F32_DQ_FAULTS])
@_in_child
def test_flash_dq_f32_check_catches_a_planted_fault(dev, tmp_path,
                                                    monkeypatch, what, line,
                                                    fault, case):
    """The f32 check of K6 (1e-4, as test_flash_bwd_kernels_match_plain
    holds it) fails a kernel built with a fault in its sweep, at the case
    the fault names (_F32_CASES)."""
    _plant(tmp_path, monkeypatch, "flash_bwd_f32.cu", line, fault, what)
    q, k, v, o, lse, do, kw, refs = _f32_fault_case(dev, case)
    backend.reset_launch_counts()
    dq, _ = A.flash_dq(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert backend.route_counts() == {"f32 flash_dq": 1}
    err = float((dq - refs[0]).abs().max())
    print(f"{what}: max error of dq {err} (the check's 1e-4)")
    assert not torch.allclose(dq, refs[0], rtol=1e-4, atol=1e-4), (what,
                                                                   err)


# Faults planted in csrc/gemm.cu's f32 route: (what, the line as it is,
# the line with the fault, the (mode, M, N, K) it is checked at).  The
# split shapes are ResNet-8's and the sort task's weight gradients; the
# K-tile fault is also checked unsplit, at ResNet-8's patch GEMM.
_K1_F32_SPLIT_SHAPES = (("tn", 32, 144, 65536), ("tn", 128, 128, 8192))
_K1_F32_FAULTS = [
    ("K1 f32 drops the last split's partial",
     "    for (int z = gl; z < splits; z += G) {",
     "    for (int z = gl; z < splits - 1; z += G) {",
     _K1_F32_SPLIT_SHAPES),
    ("K1 f32 sums one split twice",
     "      const float* p = ws + z * MN;",
     "      const float* p = ws + (z == 1 ? 0 : z) * MN;",
     _K1_F32_SPLIT_SHAPES),
    ("K1 f32 drops the last K tile of a split",
     "  const int nk = min(k_tiles, kt0 + k_per_split) - kt0;",
     "  const int nk = min(k_tiles, kt0 + k_per_split) - kt0 - 1;",
     _K1_F32_SPLIT_SHAPES + (("nt", 65536, 32, 144),)),
]


@pytest.mark.parametrize("what,line,fault,shapes", _K1_F32_FAULTS,
                         ids=[f[0] for f in _K1_F32_FAULTS])
@_in_child
def test_k1_f32_check_catches_a_planted_fault(dev, tmp_path, monkeypatch,
                                              what, line, fault, shapes):
    """chip_smoke.py's check of K1 in f32 (1e-4 (1 + |ref|)) fails a
    kernel built with a fault in its split reduce or its K loop, at the
    paths' shapes, through the route and split plan gives them."""
    _plant(tmp_path, monkeypatch, "gemm.cu", line, fault, what)
    for mode, m, n, k in shapes:
        a, b = _k1_operands(dev, mode, m, n, k, torch.float32)
        route, splits = G.plan_for(a, b, mode)
        assert route == "f32" and (splits > 1) == (mode == "tn")
        y = _k1(a, b, mode)
        ref = G.gemm_reference(a, b, mode)
        err = float(((y - ref).abs() / (1 + ref.abs())).max())
        print(f"{what}, {mode} [{m},{n},{k}] x{splits}: max error / (1 + "
              f"|ref|) {err:.3e} (the check's 1e-4)")
        assert not err <= 1e-4, (what, mode, m, n, k, err)


# Faults planted in csrc/flash_fwd.cu's f32 K5: (what, the line as it is,
# the line with the fault).
_K5_F32_FAULTS = [
    ("K5 f32 skips the last KV tile of the band",
     "  const int n_tiles = (hi - lo + BKV - 1) / BKV;",
     "  const int n_tiles = (hi - lo + BKV - 1) / BKV - 1;"),
    ("K5 f32 drops the causal diagonal",
     "              !edge || (col < S && keep<MASKED>(mask, row, col) &&",
     "              !edge || (col < S && keep<MASKED>(mask, row, col) &&"
     " col != row &&"),
]


@pytest.mark.parametrize("what,line,fault", _K5_F32_FAULTS,
                         ids=[f[0] for f in _K5_F32_FAULTS])
@_in_child
def test_flash_fwd_f32_check_catches_a_planted_fault(dev, tmp_path,
                                                     monkeypatch, what,
                                                     line, fault):
    """chip_smoke.py's check of K5 in f32 (o within 1e-4 (1 + |ref|), lse
    within 1e-4) fails a kernel built with a fault in its band or its
    mask, at the sort task's shape (batch 64, 2 heads of 64, S 128,
    causal) and at the f32 170M step's (8 heads of 128, S 2048, causal,
    [B, S, H*D])."""
    _plant(tmp_path, monkeypatch, "flash_fwd.cu", line, fault, what)
    for b, h, s, d, layout in ((64, 2, 128, 64, "bhsd"),
                               (1, 8, 2048, 128, "bshd")):
        q, k, v, _ = _attn_inputs(dev, b, h, h, s, d, torch.float32, layout,
                                  5)
        heads = None if layout == "bhsd" else h
        backend.reset_launch_counts()
        o, lse = A.flash_fwd_exact(q, k, v, causal=True, scale=d ** -0.5,
                                   heads=heads)
        torch.cuda.synchronize()
        assert backend.route_counts() == {"exact flash_fwd": 1}
        ref_o, ref_lse = A.attention_lse_reference(
            *(_bhsd(t, layout, d) for t in (q, k, v)), causal=True)
        o = _bhsd(o, layout, d)
        err = float(((o - ref_o).abs() / (1 + ref_o.abs())).max())
        lerr = float((lse - ref_lse).abs().max())
        print(f"{what}, B={b} H={h} S={s} D={d} {layout}: o error "
              f"{err:.3e} (tol 1e-4), lse error {lerr:.3e} (tol 1e-4)")
        assert not (err <= 1e-4 and lerr <= 1e-4), (what, b, s, err, lerr)


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
    assert backend.route_counts() == {"f32 flash_dkv": 1}


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
@_in_child
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
                                         (1, 2, 2, 129, 128),
                                         (1, 4, 4, 200, 64),
                                         (1, 8, 2, 300, 128)])
@pytest.mark.parametrize("mask", _DKV_T_MASKS,
                         ids=[f"{'causal' if c else 'full'}-w{w}"
                              for c, w, _ in _DKV_T_MASKS])
def test_flash_dkv_t_matches_plain(dev, mask, b, h, hkv, s, d, dtype,
                                   layout, monkeypatch):
    """K11 (a mode of K7's kernel in each dtype, on the route plan_bwd
    gives): its per-query-head partials against the plain backward's, at
    MHA and GQA groups 2 and 4, and through TAPER_ATTN_DKV_T=1 the
    group-summed dK/dV against K7's."""
    q, k, v, o, lse, do, kw = _masked_case(dev, b, h, hkv, s, d, dtype,
                                           layout, mask)
    _, delta = A.flash_dq(q, k, v, o, lse, do, **kw)
    backend.reset_launch_counts()
    parts = A.flash_dkv_t(q, k, v, lse, delta, do, **{
        n: kw[n] for n in ("causal", "scale", "heads", "window")})
    torch.cuda.synchronize()
    assert backend.launch_counts()["flash_dkv_t"] == 1
    assert backend.route_counts() == {
        f"{A.plan_bwd(dtype)} flash_dkv_t": 1}
    assert all(tuple(p.shape) == (b, h, s, d) for p in parts)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mask", [(False, None, None), (True, 65, None)],
                         ids=["full", "causal-w65"])
def test_flash_dkv_t_is_bitwise_repeatable(dev, mask, dtype):
    """K11 sums each head's tiles in a fixed order, with no atomics: two
    calls give the same bits, on either route."""
    q, k, v, o, lse, do, kw = _masked_case(dev, 1, 8, 2, 300, 128, dtype,
                                           "bshd", mask)
    _, delta = A.flash_dq(q, k, v, o, lse, do, **kw)
    kw11 = {n: kw[n] for n in ("causal", "scale", "heads", "window")}
    first = A.flash_dkv_t(q, k, v, lse, delta, do, **kw11)
    second = A.flash_dkv_t(q, k, v, lse, delta, do, **kw11)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


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


# -- K5 in bf16 on its wgmma route (csrc/flash_sm90.cu, fwd_kernel<D, true>)

_K5_MASKS = [(False, None, None), (True, None, None), (True, 128, None),
             (True, 300, None), (False, 300, None), (True, None, "docs"),
             (False, None, "docs"), (True, None, "shuffled")]
_K5_MASK_IDS = [f"{'causal' if c else 'full'}-"
                + (f"w{w}" if w else f"seg-{g}" if g else "none")
                for c, w, g in _K5_MASKS]


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("b,h,hkv,s,d", [(2, 8, 2, 1000, 128),
                                         (1, 4, 1, 257, 64)])
@pytest.mark.parametrize("mask", _K5_MASKS, ids=_K5_MASK_IDS)
def test_k5_wgmma_matches_plain(dev, mask, b, h, hkv, s, d, layout):
    """bf16 K5 under each mask (none, causal, a window with and without
    causality, segment ids with padding id 0 sorted or shuffled), at S
    not a multiple of the 128-row tiles, D 64 and 128, GQA, both layouts:
    the output within 2e-2 and lse within 1e-3 of the plain version, one
    launch counted on the wgmma route, and a second call bit-equal.  A
    row whose first KV tiles are all masked (behind a window, another
    document) stays finite: its running max starts at -inf, the guard a
    fully masked row also takes (no row is fully masked through the
    entry points: every row keeps its own position)."""
    q, k, v, o_ref, lse_ref, _, kw = _masked_case(dev, b, h, hkv, s, d,
                                                  torch.bfloat16, layout,
                                                  mask)
    args = {n: kw[n] for n in ("causal", "scale", "heads", "window",
                               "segment_ids")}
    backend.reset_launch_counts()
    o, lse = A.flash_fwd_exact(q, k, v, **args)
    torch.cuda.synchronize()
    assert backend.launch_counts()["flash_fwd"] == 1
    assert backend.route_counts() == {"wgmma flash_fwd": 1}
    assert torch.isfinite(o.float()).all() and torch.isfinite(lse).all()
    _close(_bhsd(o, layout, d), _bhsd(o_ref, layout, d), torch.bfloat16,
           2e-2)
    torch.testing.assert_close(lse, lse_ref, rtol=1e-3, atol=1e-3)
    o2, lse2 = A.flash_fwd_exact(q, k, v, **args)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


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
    assert backend.route_counts() == {"f32 flash_dq": 1,
                                      "f32 flash_bwd_fused": 1}


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


# K12 on wgmma: M > 16, N a multiple of 4 and K of 16, with ragged edges
# (N not a multiple of the 128-column tile, K not of the 64-deep K tile)
_K12_WGMMA = [(17, 196, 1040), (64, 132, 208), (2000, 64, 128),
              (2000, 1028, 528), (4096, 2048, 2048), (4096, 260, 8192)]
_K12_TERMS = [(False, False, True, "none"), (True, False, False, "relu"),
              (False, True, True, "sigmoid"), (True, True, False, "none")]


@pytest.mark.parametrize("per_channel,symmetric,bias,act", _K12_TERMS)
@pytest.mark.parametrize("m,n,k", _K12_WGMMA)
def test_k12_wgmma_matches_plain(dev, m, n, k, per_channel, symmetric,
                                 bias, act):
    """K12 on its wgmma kernel (the row pass, then bf16 wgmma with the
    codes widened in shared memory) against the plain version, each
    epilogue, per-tensor and per-channel scale and zero point, at 2e-4
    (1 + |ref|), counted by route."""
    gen = torch.Generator().manual_seed(m + n + k)
    qt = _qweight(gen, n, k, 8, per_channel, symmetric).to(dev)
    x = _randn(gen, m, k).to(dev)
    b = _randn(gen, n, scale=0.1).to(dev) if bias else None
    assert Q.plan_q_for(x, qt.values) == "wgmma"
    backend.reset_launch_counts()
    y = Q.linear_q8(x, qt.values, qt.scale, qt.zero_point, b, epilogue=act)
    torch.cuda.synchronize()
    assert backend.launch_counts()["linear_q8"] == 1
    assert backend.route_counts() == {"wgmma linear_q8": 1}
    ref = Q.linear_q8_reference(x, qt.values, qt.scale, qt.zero_point, b,
                                act)
    assert y.dtype == torch.float32 and y.shape == (m, n)
    torch.testing.assert_close(y, ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("m,n,k", [(8, 2048, 2056), (16, 512, 4104),
                                   (1, 64, 72), (300, 1024, 1030),
                                   (2000, 10, 64), (64, 130, 256)])
def test_k12_mma_route_matches_plain(dev, m, n, k):
    """K % 16 != 0 (at decode's M <= 16 too) and rows of N f32 that are
    not whole 16-byte units take the mma route (the decode kernel's
    register widening, loads as wide as the rows allow, token groups)."""
    gen = torch.Generator().manual_seed(m + n + k)
    qt = _qweight(gen, n, k, 8, True, False).to(dev)
    x = _randn(gen, m, k).to(dev)
    b = _randn(gen, n, scale=0.1).to(dev)
    assert Q.plan_q_for(x, qt.values) == "mma"
    backend.reset_launch_counts()
    y = Q.linear_q8(x, qt.values, qt.scale, qt.zero_point, b)
    torch.cuda.synchronize()
    assert backend.route_counts() == {"mma linear_q8": 1}
    ref = Q.linear_q8_reference(x, qt.values, qt.scale, qt.zero_point, b)
    torch.testing.assert_close(y, ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("m,n,k", [(8, 2048, 2048), (300, 1024, 1030),
                                   (4096, 2048, 2048), (2000, 1028, 528)])
def test_k12_routes_are_bitwise_repeatable(dev, m, n, k):
    """Each K12 kernel sums in a fixed order: two calls give the same
    bits, on mma and on wgmma."""
    gen = torch.Generator().manual_seed(m + n + k)
    qt = _qweight(gen, n, k, 8, False, False).to(dev)
    x = _randn(gen, m, k).to(dev)
    a = Q.linear_q8(x, qt.values, qt.scale, qt.zero_point)
    b = Q.linear_q8(x, qt.values, qt.scale, qt.zero_point)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


# K12 and K13 on the decode route (csrc/quant_decode.cu): M 1-16 at the
# quantized model's decode shapes (dim 2,048: wq/wo, wk/wv, w1, w2), each
# epilogue, with and without a bias, in turn
_QDECODE_SHAPES = [(2048, 2048), (512, 2048), (8192, 2048), (2048, 8192)]


@pytest.mark.parametrize("n,k", _QDECODE_SHAPES)
@pytest.mark.parametrize("m", list(range(1, 17)))
@pytest.mark.parametrize("bits", [8, 4])
def test_k12_k13_decode_matches_plain(dev, bits, m, n, k):
    """The decode route (codes widened in registers into swap-AB mma.sync
    fragments, K split over a cluster of ``decode_splits`` blocks) against
    the plain version at 2e-4 (1 + |ref|), counted by route, and a second
    call bit-equal."""
    gen = torch.Generator().manual_seed(m * 7 + n + k + bits)
    act = ("none", "relu", "sigmoid")[m % 3]
    qt = _qweight(gen, n, k, bits, m % 4 < 2, m % 2 == 0).to(dev)
    x = _randn(gen, m, k).to(dev)
    b = _randn(gen, n, scale=0.1).to(dev) if m % 2 else None
    name = f"linear_q{bits}"
    backend.reset_launch_counts()
    if bits == 8:
        assert Q.plan_q_for(x, qt.values) == "decode"
        call = lambda: Q.linear_q8(x, qt.values, qt.scale,  # noqa: E731
                                   qt.zero_point, b, epilogue=act)
        ref = Q.linear_q8_reference(x, qt.values, qt.scale, qt.zero_point,
                                    b, act)
    else:
        call = lambda: Q.linear_q4(x, qt.values, qt.scale,  # noqa: E731
                                   qt.zero_point, b, n_features=k,
                                   epilogue=act)
        ref = Q.linear_q4_reference(x, qt.values, qt.scale, qt.zero_point,
                                    b, n_features=k, epilogue=act)
    y, again = call(), call()
    torch.cuda.synchronize()
    assert backend.launch_counts()[name] == 2
    assert backend.route_counts() == {f"decode {name}": 2}
    assert y.dtype == torch.float32 and y.shape == (m, n)
    torch.testing.assert_close(y, ref, rtol=2e-4, atol=2e-4)
    assert torch.equal(y, again)


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("m", [1, 8, 16])
@pytest.mark.parametrize("bits", [8, 4])
def test_k12_k13_decode_at_every_cluster_size(dev, monkeypatch, bits, m,
                                              splits):
    """The decode kernel takes clusters of up to 8 ranks; the wrapper's
    rule gives at most ``DECODE_MAX_RANKS``.  Each size, forced, at K
    8,192 (N 512, relu and a bias) against the plain version at 2e-4
    (1 + |ref|), and a second call bit-equal."""
    monkeypatch.setattr(Q, "decode_splits", lambda n, k, bits: splits)
    n, k = 512, 8192
    gen = torch.Generator().manual_seed(m + splits + bits)
    qt = _qweight(gen, n, k, bits, True, False).to(dev)
    x = _randn(gen, m, k).to(dev)
    b = _randn(gen, n, scale=0.1).to(dev)
    kw = {} if bits == 8 else dict(n_features=k)
    fn = Q.linear_q8 if bits == 8 else Q.linear_q4
    ref = (Q.linear_q8_reference if bits == 8 else Q.linear_q4_reference)(
        x, qt.values, qt.scale, qt.zero_point, b, epilogue="relu", **kw)
    backend.reset_launch_counts()
    y, again = (fn(x, qt.values, qt.scale, qt.zero_point, b,
                   epilogue="relu", **kw) for _ in range(2))
    torch.cuda.synchronize()
    assert backend.route_counts() == {f"decode linear_q{bits}": 2}
    torch.testing.assert_close(y, ref, rtol=2e-4, atol=2e-4)
    assert torch.equal(y, again)


@pytest.mark.parametrize("m,n,k", [(8, 2048, 2064), (16, 512, 2056),
                                   (1, 40, 18)])
def test_k13_ragged_takes_mma(dev, m, n, k):
    """K13 at decode's M with K % 32 != 0 takes the mma route."""
    gen = torch.Generator().manual_seed(m + n + k)
    qt = _qweight(gen, n, k, 4, True, False).to(dev)
    x = _randn(gen, m, k).to(dev)
    assert Q.plan_q_for(x, qt.values, 4) == "mma"
    backend.reset_launch_counts()
    y = Q.linear_q4(x, qt.values, qt.scale, qt.zero_point, n_features=k)
    torch.cuda.synchronize()
    assert backend.route_counts() == {"mma linear_q4": 1}
    ref = Q.linear_q4_reference(x, qt.values, qt.scale, qt.zero_point,
                                n_features=k)
    torch.testing.assert_close(y, ref, rtol=2e-4, atol=2e-4)


def _q_call(bits, x, qt, b=None, act="none", k=None):
    """K12 or K13 and its plain version on the same operands."""
    args = (x, qt.values, qt.scale, qt.zero_point, b)
    if bits == 8:
        return (Q.linear_q8(*args, epilogue=act),
                Q.linear_q8_reference(*args, act))
    return (Q.linear_q4(*args, n_features=k, epilogue=act),
            Q.linear_q4_reference(*args, n_features=k, epilogue=act))


# K13 on wgmma at its edges: M one past decode's, and a 128-row tile
# less one and plus one; N of one 16-byte output unit and one past a
# 128-column tile; K of one 32-code unit and 2,080 (65 units, a ragged
# 64-deep K tile); then phase 18's three shapes at M 4,096
_K13_WGMMA = ([(m, n, k) for m in (17, 63, 129) for n in (4, 132)
               for k in (32, 2080)]
              + [(4096, 2048, 2048), (4096, 8192, 2048), (4096, 2048, 8192)])


@pytest.mark.parametrize("per_channel,symmetric,bias,act", _K12_TERMS)
@pytest.mark.parametrize("m,n,k", _K13_WGMMA)
def test_k13_wgmma_matches_plain(dev, m, n, k, per_channel, symmetric,
                                 bias, act):
    """K13 on the wgmma kernel (the row pass, then bf16 wgmma with the
    nibbles widened in shared memory in K order) against the plain
    version, each epilogue, per-tensor and per-channel scale and zero
    point, at 2e-4 (1 + |ref|), counted by route."""
    gen = torch.Generator().manual_seed(m + n + k + 4)
    qt = _qweight(gen, n, k, 4, per_channel, symmetric).to(dev)
    x = _randn(gen, m, k).to(dev)
    b = _randn(gen, n, scale=0.1).to(dev) if bias else None
    assert Q.plan_q_for(x, qt.values, 4) == "wgmma"
    backend.reset_launch_counts()
    y, ref = _q_call(4, x, qt, b, act, k)
    torch.cuda.synchronize()
    assert backend.launch_counts()["linear_q4"] == 1
    assert backend.route_counts() == {"wgmma linear_q4": 1}
    assert y.dtype == torch.float32 and y.shape == (m, n)
    torch.testing.assert_close(y, ref, rtol=2e-4, atol=2e-4)


# every ragged tail: int8 K % 16 in 1..15, int4 K % 32 in 2..30
_TAILS = ([(8, r) for r in range(1, 16)] + [(4, r) for r in range(2, 32, 2)])


@pytest.mark.parametrize("m", [8, 40])
@pytest.mark.parametrize("bits,r", _TAILS)
def test_k12_k13_every_ragged_tail_matches_plain(dev, bits, r, m):
    """A ragged last 16-byte unit of the codes (and of the activations) is
    read as zeros past K, at decode's M and at M > 16, on the mma route;
    a zero point of 7, so that a wrong row sum moves its term."""
    k, n = 1024 + r, 96
    gen = torch.Generator().manual_seed(k * bits + m)
    qt = _qweight(gen, n, k, bits, m > 16, False).to(dev)
    qt.zero_point = torch.full_like(qt.zero_point, 7.0)
    x = _randn(gen, m, k).to(dev)
    b = _randn(gen, n, scale=0.1).to(dev)
    assert Q.plan_q_for(x, qt.values, bits) == "mma"
    backend.reset_launch_counts()
    y, ref = _q_call(bits, x, qt, b, "relu", k)
    torch.cuda.synchronize()
    assert backend.route_counts() == {f"mma linear_q{bits}": 1}
    torch.testing.assert_close(y, ref, rtol=2e-4, atol=2e-4)


def _offset(t, off):
    """A copy of ``t`` whose base lies ``off`` bytes past a 16-byte
    boundary (a view into a larger buffer)."""
    nb = t.numel() * t.element_size()
    buf = torch.empty(off + nb + 16, dtype=torch.uint8, device=t.device)
    assert buf.data_ptr() % 16 == 0
    out = buf[off:off + nb].view(t.dtype).view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("m", [8, 40])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("what,off", [("q", o) for o in range(1, 16)]
                         + [("x", o) for o in (4, 8, 12)])
def test_k12_k13_misaligned_bases_match_plain(dev, what, off, bits, m):
    """Codes 1..15 bytes off a 16-byte boundary, and f32 activations 4, 8
    and 12 bytes off (the offsets an f32 tensor can have), on the mma
    route at decode's M and at M > 16 (narrower loads, the same sums)."""
    n, k = 72, 512
    gen = torch.Generator().manual_seed(off * 3 + bits + m)
    qt = _qweight(gen, n, k, bits, False, False).to(dev)
    x = _randn(gen, m, k).to(dev)
    if what == "q":
        qt.values = _offset(qt.values, off)
    else:
        x = _offset(x, off)
    assert Q.plan_q_for(x, qt.values, bits) == "mma"
    backend.reset_launch_counts()
    y, ref = _q_call(bits, x, qt, None, "sigmoid", k)
    torch.cuda.synchronize()
    assert backend.route_counts() == {f"mma linear_q{bits}": 1}
    torch.testing.assert_close(y, ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("bits", [8, 4])
def test_k12_k13_large_odd_shape_matches_plain(dev, bits):
    """An odd shape on no path, K 2,050 at M 4,096 (N 2,048), on the mma
    route: 256 token groups of 16 rows over 64 weight blocks."""
    m, n, k = 4096, 2048, 2050
    gen = torch.Generator().manual_seed(bits)
    qt = _qweight(gen, n, k, bits, True, False).to(dev)
    x = _randn(gen, m, k).to(dev)
    assert Q.plan_q_for(x, qt.values, bits) == "mma"
    assert Q.mma_rows(m, n) == 16
    y, ref = _q_call(bits, x, qt, None, "none", k)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, ref, rtol=2e-4, atol=2e-4)


def _q_err(y, ref):
    return float(((y - ref).abs() / (1 + ref.abs())).max())


# Faults planted in K13's and the mma route's code widening and tail:
# (what, file, [(the line as it is, the line with the fault)], bits, (M, N,
# K)): K13 on wgmma with each byte's two nibbles exchanged, or read
# unsigned (the sign extension dropped); the mma route with the
# activations' ragged last unit read past K (its codes stay zero, so the
# row sum, and through it the zero point's term, goes wrong)
_Q_FAULTS = [
    ("K13 wgmma swaps each byte's nibbles", "quant_sm90.cu",
     [("    const uint32_t b = u >> (8 * j);",
       "    const uint32_t b = ((u >> (8 * j + 4)) & 0xFu) | "
       "(((u >> (8 * j)) & 0xFu) << 4);")], 4, (64, 128, 256)),
    ("K13 wgmma drops the nibbles' sign extension", "quant_sm90.cu",
     [("  const uint32_t u = w ^ 0x88888888u;", "  const uint32_t u = w;"),
      ("  const uint32_t bias = 0x41C04308u;  // bf16 24 (high), 136 (low)",
       "  const uint32_t bias = 0x41804300u;")], 4, (64, 128, 256)),
    ("the mma route reads the activations' tail past K", "quant_decode.cu",
     [("      if (4 * v < valid) {", "      if (true) {")], 8,
     (8, 256, 1032)),
]


@pytest.mark.parametrize("what,name,lines,bits,shape", _Q_FAULTS,
                         ids=[f[0] for f in _Q_FAULTS])
@_in_child
def test_k13_and_mma_check_catches_a_planted_fault(dev, tmp_path,
                                                   monkeypatch, what, name,
                                                   lines, bits, shape):
    """The K12/K13 check (2e-4 (1 + |ref|)) fails a kernel built with its
    nibbles swapped, their sign dropped, or a ragged tail not zeroed; the
    kernels are rebuilt from a copy of csrc with the fault in it.  The
    activations lie in a larger buffer, so a read past K stays inside
    it."""
    _plant_lines(tmp_path, monkeypatch, name, lines, what)
    m, n, k = shape
    gen = torch.Generator().manual_seed(7)
    qt = _qweight(gen, n, k, bits, False, False).to(dev)
    qt.zero_point = torch.full_like(qt.zero_point, 20.0)
    buf = _randn(gen, m * k + 64).to(dev)
    x = buf[:m * k].view(m, k)
    route = Q.plan_q_for(x, qt.values, bits)
    assert route == ("wgmma" if bits == 4 else "mma"), route
    y, ref = _q_call(bits, x, qt, None, "none", k)
    torch.cuda.synchronize()
    print(f"{what}: K12/K13's check {_q_err(y, ref):.3e} (held to 2e-4)")
    assert _q_err(y, ref) > 2e-4, what


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
                                   (256, 2048, 8192), (4096, 2048, 2048),
                                   (4096, 8192, 2048), (4096, 2048, 8192),
                                   (8, 2048, 2048), (200, 262, 2050),
                                   (130, 250, 48)])
def test_matmul_int8_kernels_are_exact(dev, m, n, k):
    """K15b and K15a against their plain versions, bit for bit, on the
    route plan gives each shape (wgmma for K % 16 == 0, the W8A8 shapes
    and decode's 8 rows among them; mma for K 100 and 2,050), counted by
    route."""
    gen = torch.Generator().manual_seed(m + n + k)
    xq = torch.randint(-127, 128, (m, k), generator=gen,
                       dtype=torch.int8).to(dev)
    q = torch.randint(-128, 128, (n, k), generator=gen,
                      dtype=torch.int8).to(dev)
    route = Q.plan_for(xq, q)
    assert route == ("wgmma" if k % 16 == 0 else "mma")
    backend.reset_launch_counts()
    acc = Q.matmul_int8(xq, q)
    torch.cuda.synchronize()
    assert backend.launch_counts()["matmul_int8"] == 1
    assert backend.route_counts() == {f"{route} matmul_int8": 1}
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
    assert backend.route_counts()[f"{route} matmul_int8_scaled"] == 3


@pytest.mark.parametrize("offset", [1, 3, 8, 16])
def test_matmul_int8_misaligned_views_take_mma(dev, offset):
    """Codes whose base is not 16-byte aligned cannot go through TMA: the
    mma route takes them (byte loads), exact; a base a whole 16 bytes off
    stays on wgmma."""
    gen = torch.Generator().manual_seed(offset)
    m, n, k = 96, 80, 256
    flat = torch.randint(-127, 128, (offset + m * k,), generator=gen,
                         dtype=torch.int8).to(dev)
    xq = flat[offset:].view(m, k)
    q = torch.randint(-128, 128, (n, k), generator=gen,
                      dtype=torch.int8).to(dev)
    route = "wgmma" if offset % 16 == 0 else "mma"
    assert Q.plan_for(xq, q) == route
    backend.reset_launch_counts()
    acc = Q.matmul_int8(xq, q)
    torch.cuda.synchronize()
    assert backend.route_counts() == {f"{route} matmul_int8": 1}
    assert torch.equal(acc, Q.matmul_int8_reference(xq, q))


# Faults planted in csrc/quant_sm90.cu's K15a epilogue: (what, the line as
# it is, the line with the fault)
_K15_FAULTS = [
    ("K15a's epilogue leaves nvcc free to contract the bias add into an FMA",
     "  if (has_bias) v = __fadd_rn(v, bn);",
     "  if (has_bias) v = sxm * swn * __fsub_rn(__int2float_rn(acc), "
     "__fmul_rn(zwn, corrm)) + bn;"),
]


@pytest.mark.parametrize("what,line,fault", _K15_FAULTS,
                         ids=[f[0] for f in _K15_FAULTS])
@_in_child
def test_matmul_int8_scaled_exactness_catches_a_planted_fault(
        dev, tmp_path, monkeypatch, what, line, fault):
    """K15a's bit-for-bit check fails a kernel whose epilogue rounds once
    where the plain version rounds twice."""
    _plant(tmp_path, monkeypatch, "quant_sm90.cu", line, fault, what)
    gen = torch.Generator().manual_seed(3)
    m, n, k = 512, 384, 2048
    xq = torch.randint(-127, 128, (m, k), generator=gen,
                       dtype=torch.int8).to(dev)
    q = torch.randint(-128, 128, (n, k), generator=gen,
                      dtype=torch.int8).to(dev)
    sx = torch.rand(m, generator=gen).to(dev) * 0.01
    corr = xq.float().sum(1)
    sw = torch.rand(n, generator=gen).to(dev) * 0.01
    zw = torch.randint(-5, 5, (n,), generator=gen).float().to(dev)
    bias = _randn(gen, n).to(dev)
    assert Q.plan_for(xq, q) == "wgmma"
    y = Q.matmul_int8_scaled(xq, q, sx, corr, sw, zw, bias)
    want = Q.matmul_int8_scaled_reference(xq, q, sx, corr, sw, zw, bias)
    torch.cuda.synchronize()
    off = int((y != want).sum())
    print(f"{what}: {off} of {y.numel()} outputs differ from the plain "
          f"version's bits")
    assert off > 0, what


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


# -- K1's routes (ops/gemm.py plan): wgmma, realign, decode, f32, split-K ---

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
    ("realign", "nt", 33, 70, 130), ("realign", "nn", 33, 70, 130),
    ("realign", "tn", 33, 70, 130), ("realign", "nt", 300, 264, 1001),
    ("realign", "nn", 16, 1024, 1024),   # M <= 16 off mode nt: streamed
    ("realign", "tn", 9, 40, 264),
    ("decode", "nt", 16, 1024, 1024), ("decode", "nt", 5, 19, 37),
    ("decode", "nt", 16, 1024, 4096),    # a cluster of 4 blocks
    ("decode", "nt", 4, 1024, 8192),     # a cluster of 8
    ("decode", "nt", 8, 8192, 2048), ("decode", "nt", 1, 4096, 1024),
    ("decode", "nt", 12, 1000, 1001),    # K % 8 != 0: element loads
    ("f32", "nt", 256, 128, 128), ("f32", "nn", 256, 64, 128),
    ("f32", "tn", 128, 128, 256), ("f32", "tn", 128, 128, 8192),
    ("f32", "tn", 32, 144, 65536), ("f32", "nn", 65536, 144, 32),
    ("f32", "nt", 65536, 32, 144), ("f32", "tn", 10, 64, 256),
    ("f32", "nt", 5, 19, 37),
    # f32 splits over 32 x 32 tiles (a grid barrier, then the lanes' sums)
    ("f32", "nt", 64, 96, 8192), ("f32", "nn", 48, 40, 4096),
    ("f32", "tn", 10, 64, 4096), ("f32", "tn", 64, 288, 16384),
    ("f32", "tn", 64, 32, 16384), ("f32", "nn", 16384, 32, 64),
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


@pytest.mark.parametrize("m", range(1, 17))
def test_k1_decode_at_every_m(dev, m):
    """The decode route at each M it takes (1 to 16: one or two n8 tiles
    of rows, rows past M masked), at a ragged N and K (N not a multiple
    of the block's 32 weight rows; K a multiple of 8 but not of the 32 of
    a step, and K % 8 != 0, which takes element loads), through each
    epilogue with a bias, against the plain version (2e-4); the bf16
    output equals the f32 output cast, bit for bit, and a second call
    repeats the bits (its K split over a cluster sums in a fixed order)."""
    acts = ("none", "relu", "sigmoid")
    for i, (n, k) in enumerate(((1000 + m, 1032), (77, 2050), (4096, 1024),
                                (1024, 4096))):
        a, b = _k1_operands(dev, "nt", m, n, k, torch.bfloat16, seed=i)
        gen = torch.Generator().manual_seed(n)
        bias = _randn(gen, n, dtype=torch.bfloat16).to(dev)
        route, splits = G.plan_for(a, b, "nt")
        assert route == "decode"
        act = acts[(m + i) % 3]
        backend.reset_launch_counts()
        y = _k1(a, b, "nt", bias, act)
        torch.cuda.synchronize()
        assert backend.route_counts() == {
            "decode nt" + (" split" if splits > 1 else ""): 1}
        assert backend.launch_counts()["linear"] == 1
        ref = G.linear_reference(a, b, bias, act)
        _close(y, ref, torch.bfloat16, 2e-4)
        assert torch.equal(y, _k1(a, b, "nt", bias, act))
        y16 = _k1(a, b, "nt", bias, out_dtype=torch.bfloat16)
        assert torch.equal(y16, _k1(a, b, "nt", bias).to(torch.bfloat16))


@pytest.mark.parametrize("route,mode,m,n,k", [
    c for c in _K1_CASES if c[0] in G.WAVE
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
    _close(y, G.gemm_reference_split(
        a, b, mode, splits, G.tile_shape(route, m, n, k)[2], route), dtype,
        2e-4)


@pytest.mark.parametrize("mode,m,n,k,dtype", [
    ("tn", 1024, 1024, 16384, torch.bfloat16),
    ("nt", 300, 264, 520, torch.bfloat16),
    ("tn", 128, 128, 8192, torch.float32),
    ("tn", 32, 144, 65536, torch.float32),
    ("nt", 64, 96, 8192, torch.float32)])
def test_k1_split_is_bitwise_repeatable(dev, mode, m, n, k, dtype):
    """Split-K sums its splits in a fixed order without atomics: two calls
    give the same bits (a resumed run stays bit-equal)."""
    a, b = _k1_operands(dev, mode, m, n, k, dtype, seed=2)
    assert G.plan_for(a, b, mode)[1] > 1
    y0, y1 = _k1(a, b, mode), _k1(a, b, mode)
    assert torch.equal(y0, y1)


@pytest.mark.parametrize("mode", ["nt", "nn", "tn"])
def test_k1_misaligned_bf16_view_takes_realign(dev, mode):
    """A bf16 operand 2 bytes off a 16-byte boundary cannot go through
    TMA: the realign route takes it, and gives the plain product."""
    m, n, k = 96, 80, 136
    a, b = _k1_operands(dev, mode, m, n, k, torch.bfloat16, seed=3)
    flat = torch.empty(a.numel() + 1, dtype=a.dtype, device=dev)
    flat[1:] = a.reshape(-1)
    a_off = flat[1:].view(a.shape)
    assert a_off.data_ptr() % 16 and a_off.is_contiguous()
    assert G.plan_for(a_off, b, mode) == ("realign", 1)
    backend.reset_launch_counts()
    y = _k1(a_off, b, mode)
    torch.cuda.synchronize()
    assert backend.route_counts() == {f"realign {mode}": 1}
    _close(y, G.gemm_reference(a, b, mode), torch.bfloat16, 2e-4)


def _k1_view(t, offset=0, pad=0, fill=0.0):
    """``t`` copied into a view ``offset`` elements into a buffer whose rows
    are ``pad`` elements wider, every other element of the buffer
    ``fill`` (past each row, before the view and past its end)."""
    r, c = t.shape
    buf = torch.full((offset + r * (c + pad) + 64,), fill, dtype=t.dtype,
                     device=t.device)
    view = buf[offset:offset + r * (c + pad)].view(r, c + pad)[:, :c]
    view.copy_(t)
    return view


def _k1_check(a, b, mode, a_view, b_view, bias=None, act="none"):
    """K1 on the views against the plain product of the clean operands
    (2e-4), through the realign route and the staging plan gives them;
    the bf16 output is the f32 output cast, bit for bit."""
    assert G.plan_for(a_view, b_view, mode)[0] == "realign"
    backend.reset_launch_counts()
    y = _k1(a_view, b_view, mode, bias, act)
    torch.cuda.synchronize()
    assert backend.route_counts() == {f"realign {mode}": 1}
    ref = G.gemm_reference(a, b, mode)
    if bias is not None:
        ref = ref + bias.float()
    ref = G.apply_activation(ref, act)
    assert torch.isfinite(y).all()
    _close(y, ref, torch.bfloat16, 2e-4)
    if act == "none":
        y16 = _k1(a_view, b_view, mode, bias, out_dtype=torch.bfloat16)
        assert torch.equal(y16, y.to(torch.bfloat16))


@pytest.mark.parametrize("mode", ["nt", "nn", "tn"])
@pytest.mark.parametrize("offset", range(8))
def test_k1_realign_at_every_base_offset(dev, mode, offset):
    """Each base offset of 0-7 elements, on a and on b in turn (the other
    operand aligned, so it streams), at an aligned shape and at odd M, N
    and K; every element of the buffers outside the views NaN."""
    for m, n, k in ((96, 80, 136), (97, 131, 77)):
        a, b = _k1_operands(dev, mode, m, n, k, torch.bfloat16,
                            seed=offset)
        bias = (_randn(torch.Generator().manual_seed(n), n,
                       dtype=torch.bfloat16).to(dev)
                if mode == "nt" else None)
        nan = float("nan")
        for a_off, b_off in ((offset, 0), (0, offset), (offset, 7 - offset)):
            av = _k1_view(a, a_off, fill=nan)
            bv = _k1_view(b, b_off, fill=nan)
            if G.plan_for(av, bv, mode)[0] == "wgmma":
                continue    # both aligned: TMA's operands
            _k1_check(a, b, mode, av, bv, bias)


@pytest.mark.parametrize("mode", ["nt", "nn", "tn"])
@pytest.mark.parametrize("m,n,k", [(129, 67, 203), (512, 1000, 1001),
                                   (33, 17, 9), (64, 72, 128)])
def test_k1_realign_poisoned_tail(dev, mode, m, n, k):
    """Operands as views into larger buffers whose elements past each
    row, before the view and past its end hold NaN (rows 5 or 8 elements
    wider, bases 1 or 3 elements off): the realign pass zeroes every
    element past the matrix, so the result is the plain product of the
    clean operands, with each epilogue."""
    a, b = _k1_operands(dev, mode, m, n, k, torch.bfloat16, seed=5)
    nan = float("nan")
    bias = (_randn(torch.Generator().manual_seed(m), n,
                   dtype=torch.bfloat16).to(dev) if mode == "nt" else None)
    for i, (a_off, a_pad, b_off, b_pad) in enumerate(
            ((1, 5, 0, 8), (0, 8, 3, 5), (3, 5, 1, 5))):
        act = ("none", "relu", "sigmoid")[i] if mode == "nt" else "none"
        _k1_check(a, b, mode, _k1_view(a, a_off, a_pad, nan),
                  _k1_view(b, b_off, b_pad, nan), bias, act)


# Faults planted in csrc/gemm_realign.cu: (what, the line as it is, the
# line with the fault)
_K1_REALIGN_FAULTS = [
    ("the realign pass leaves the K tail unmasked",
     "      if (valid < 8) v = keep_first(v, valid);",
     "      if (valid < 0) v = keep_first(v, valid);"),
]


@pytest.mark.parametrize("what,line,fault", _K1_REALIGN_FAULTS,
                         ids=[f[0] for f in _K1_REALIGN_FAULTS])
@_in_child
def test_k1_realign_poisoned_tail_catches_a_planted_fault(
        dev, tmp_path, monkeypatch, what, line, fault):
    """The poisoned-tail check fails a realign kernel built with its K
    tail left unmasked: a window past a row's end carries the buffer's
    NaN into the product."""
    _plant(tmp_path, monkeypatch, "gemm_realign.cu", line, fault, what)
    a, b = _k1_operands(dev, "nt", 129, 67, 203, torch.bfloat16, seed=5)
    nan = float("nan")
    y = _k1(_k1_view(a, 1, 5, nan), _k1_view(b, 0, 8, nan), "nt")
    torch.cuda.synchronize()
    ref = G.gemm_reference(a, b, "nt")
    bad = ~torch.isclose(y, ref, rtol=2e-4, atol=2e-4)
    print(f"{what}: {int(bad.sum())} of {y.numel()} outputs off")
    assert bad.any(), what


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


# -- the generation slice: the f32 flash kernels at head_dim 32, K16 over
# tables that alias shared prefix blocks, K1 at the generation shapes, and
# generation itself on the card against the CPU

# (b, h, hkv, s): the draft byte LM's training (32 x 128, 4 heads of 32)
# and prefill (64 positions) shapes, a ragged length with GQA, one row
_D32_SHAPES = [(32, 4, 4, 128), (1, 4, 4, 64), (2, 4, 2, 70), (1, 2, 1, 1)]


# (causal, window, segments); documents only where a row holds a few
_D32_CASES = [(shape, mask) for shape in _D32_SHAPES
              for mask in ((True, None, None), (False, None, None),
                           (True, 33, None), (True, None, "docs"))
              if mask[2] is None or shape[3] >= 4]


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("shape,mask", _D32_CASES)
def test_f32_flash_kernels_at_head_dim_32(dev, shape, mask, layout):
    """K5 (forward and lse), K6 and K7 in f32 at D 32 against the plain
    versions (1e-4), on the routes the plans give."""
    b, h, hkv, s = shape
    d = 32
    q, k, v, o, lse, do, kw = _masked_case(dev, b, h, hkv, s, d,
                                           torch.float32, layout, mask)
    backend.reset_launch_counts()
    o2, lse2 = A.flash_fwd_exact(q, k, v, **{
        n: kw[n] for n in ("causal", "scale", "heads", "window",
                           "segment_ids")})
    grads = A.flash_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert backend.route_counts() == {"exact flash_fwd": 1,
                                      "f32 flash_dq": 1, "f32 flash_dkv": 1}
    torch.testing.assert_close(_bhsd(o2, layout, d),
                               _bhsd(o, layout, d), rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(lse2, lse, rtol=1e-4, atol=1e-4)
    refs = _masked_refs(q, k, v, o, lse, do, kw, layout, d)
    _hold_grads([_bhsd(g, layout, d) for g in grads[:3]], refs[:3],
                torch.float32)


@pytest.mark.parametrize("mask", [(False, None, None), (True, 33, None)])
def test_f32_flash_dkv_t_at_head_dim_32(dev, mask):
    q, k, v, o, lse, do, kw = _masked_case(dev, 2, 4, 2, 70, 32,
                                           torch.float32, "bhsd", mask)
    _, delta = A.flash_dq(q, k, v, o, lse, do, **kw)
    parts = A.flash_dkv_t(q, k, v, lse, delta, do, **{
        n: kw[n] for n in ("causal", "scale", "heads", "window")})
    refs = _masked_refs(q, k, v, o, lse, do, kw, "bhsd", 32,
                        per_query_head=True)
    _hold_grads(parts, refs[1:3], torch.float32, ("dk", "dv"))


def test_head_dim_32_stays_f32_only(dev):
    """bf16 (K8, the wgmma kernels) and K10 take D 64 and 128 only."""
    q, k, v, o, lse, do, kw = _masked_case(dev, 1, 2, 2, 64, 32,
                                           torch.float32, "bhsd",
                                           (True, None, None))
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    with pytest.raises(ValueError, match="head_dim"):
        attention(qb, kb, vb, causal=True)
    with pytest.raises(ValueError, match="head_dim"):
        A.flash_fwd_exact(qb, kb, vb, causal=False, scale=32 ** -0.5)
    with pytest.raises(ValueError, match="head_dim"):
        A.flash_bwd_fused(q, k, v, o, lse, do, **kw)


def _aliased_tables(gen, b, mb, n_prefix, n_blocks):
    """Tables whose first ``n_prefix`` entries are the same shared blocks
    (a system prompt's) and the rest each row's own, from a permutation
    of the other blocks."""
    shared = torch.arange(1, n_prefix + 1)
    own = torch.randperm(n_blocks - n_prefix - 1, generator=gen)[
        :b * (mb - n_prefix)] + n_prefix + 1
    tables = torch.cat([shared.expand(b, n_prefix),
                        own.reshape(b, mb - n_prefix)], 1)
    return tables.to(torch.int32)


@pytest.mark.parametrize("pool", ["bf16", "int8"])
@pytest.mark.parametrize("b,kvh,g,d,bs,mb,n_prefix", [
    (16, 8, 1, 128, 128, 6, 2),       # the serving model, a 256 prefix
    (8, 4, 4, 128, 128, 9, 8),        # the multi-turn model's groups
    (3, 2, 2, 64, 16, 5, 3)])
def test_k16_over_tables_aliasing_shared_prefix_blocks(dev, pool, b, kvh, g,
                                                       d, bs, mb, n_prefix):
    """K16 where every row's table aliases the same prefix blocks (the
    engine's system prompt): against its plain version, bf16 and int8
    pools, rows at lengths inside the prefix, at its end and past it."""
    gen = torch.Generator().manual_seed(b * mb + n_prefix)
    n_blocks = n_prefix + b * (mb - n_prefix) + 1
    q = _randn(gen, b, kvh, g, d, dtype=torch.bfloat16).to(dev)
    tables = _aliased_tables(gen, b, mb, n_prefix, n_blocks).to(dev)
    top = mb * bs
    lengths = torch.tensor([[1, n_prefix * bs, n_prefix * bs + 1, top][i % 4]
                            if i < 4 else
                            int(torch.randint(1, top + 1, (1,),
                                              generator=gen))
                            for i in range(b)], dtype=torch.int32,
                           device=dev)
    sc = dict(scale=d ** -0.5)
    if pool == "int8":
        kq, ks, vq, vs = _int8_pools(gen, n_blocks, kvh, bs, d, dev)
        args = (q, kq, vq, tables, lengths)
        sc.update(k_scales=ks, v_scales=vs)
    else:
        kp, vp = (_randn(gen, n_blocks, kvh, bs, d,
                         dtype=torch.bfloat16).to(dev) for _ in range(2))
        args = (q, kp, vp, tables, lengths)
    backend.reset_launch_counts()
    o = PA.paged_decode_attention(*args, **sc)
    torch.cuda.synchronize()
    name = "paged_decode_int8" if pool == "int8" else "paged_decode"
    assert backend.launch_counts()[name] == 1
    assert _k16_err(o, PA.paged_decode_reference(*args, **sc)) <= 1


# the multi-turn model's products (dim 2048, 16 heads on 4 KV heads of 128,
# MLP 8,192) at a chunk of 32 tokens on 8 rows (M 256) and at a beam
# search's or generation's decode step of 8 rows (M 8)
_GEN_PRODUCTS = [(2048, 2048), (2048, 512), (2048, 8192), (8192, 2048)]


@pytest.mark.parametrize("m", [256, 8])
@pytest.mark.parametrize("k,n", _GEN_PRODUCTS)
def test_k1_at_the_generation_shapes(dev, m, k, n):
    """K1 (bf16 out, as the bf16 trunk's projections) against its plain
    version, on the route ``plan`` gives (decode at M 8, wgmma at 256)."""
    gen = torch.Generator().manual_seed(m + k + n)
    x = _randn(gen, m, k, dtype=torch.bfloat16).to(dev)
    w = _randn(gen, n, k, dtype=torch.bfloat16, scale=k ** -0.5).to(dev)
    b = _randn(gen, n, dtype=torch.bfloat16, scale=0.1).to(dev)
    route, splits = G.plan_for(x, w, "nt")
    assert route == ("decode" if m <= 16 else "wgmma")
    backend.reset_launch_counts()
    y = G.linear(x, w, b, out_dtype=torch.float32)
    torch.cuda.synchronize()
    key = f"{route} nt" + (" split" if splits > 1 else "")
    assert backend.route_counts() == {key: 1}
    _close(y, G.linear_reference(x, w, b), torch.bfloat16, 2e-4)


def _gen_pair(dev):
    from taper_tpu_torch.models import TinyGPT
    cfg = dict(vocab_size=64, dim=128, depth=2, num_heads=2, max_seq=96,
               rope=True)
    cpu = TinyGPT(**cfg)
    cpu.reset_parameters(torch.Generator().manual_seed(3))
    card = TinyGPT(**cfg)
    card.load_state_dict(cpu.state_dict())
    return cpu, card.to(dev)


# a greedy token's logit against its row's maximum in the CPU's forward:
# the card's f32 logits differ from the CPU's in the last bits (other
# summation orders), so a near-tie may resolve either way; a wrong token
# lies far below
_GREEDY_TAU = 1e-3


def _greedy_gaps(cpu, tokens, starts, n):
    """Each of the ``n`` tokens from its row's start (a [B] list): the CPU
    forward's row maximum less the token's logit, one position before."""
    with torch.no_grad():
        lg = cpu(tokens[:, :-1].cpu())
    gaps = []
    for r, st in enumerate(starts):
        row = lg[r, st - 1:st - 1 + n]
        pick = row.gather(1, tokens[r, st:st + n].cpu()[:, None])[:, 0]
        gaps.append(row.max(-1).values - pick)
    return torch.cat(gaps)


def test_generation_on_card_matches_cpu(dev):
    """f32 TinyGPT (2 heads of 64) on the card: greedy, int8-cache and
    ragged generation, beam search and speculative decoding (a draft of 4
    heads of 32, per row and in lockstep) choose tokens within
    _GREEDY_TAU of the CPU forward's row maximum, and agree with the CPU's
    own generation on most tokens; ``decode_chunk`` at per-row starts
    within 1e-4 of the CPU's logits."""
    from taper_tpu_torch.models import TinyGPT
    cpu, card = _gen_pair(dev)
    prompt = torch.randint(0, 64, (3, 20),
                           generator=torch.Generator().manual_seed(4))
    lens = torch.tensor([20, 11, 5])
    for kw, starts in ((dict(), [20] * 3), (dict(quantized_cache=True),
                                            [20] * 3),
                       (dict(prompt_lens=lens), lens.tolist())):
        out = card.generate(prompt.to(dev), 24, **kw)
        ref = cpu.generate(prompt, 24, **kw)
        if "quantized_cache" not in kw:
            assert _greedy_gaps(cpu, out, starts, 24).max() <= _GREEDY_TAU, \
                kw
        assert (out.cpu() == ref).float().mean() >= 0.9, kw
    d32 = TinyGPT(64, 128, 1, 4, max_seq=96, rope=True).to(dev)
    for per_row in (True, False):
        out = card.speculative_generate(d32, prompt.to(dev), 24, gamma=4,
                                        per_row=per_row)
        assert _greedy_gaps(cpu, out, [20] * 3, 24).max() <= _GREEDY_TAU
    outs, scores = card.beam_search(prompt.to(dev), 12, beams=3,
                                    return_all=True)
    ref, ref_scores = cpu.beam_search(prompt, 12, beams=3, return_all=True)
    assert (scores[:, 1:] <= scores[:, :-1] + 1e-6).all()
    torch.testing.assert_close(scores[:, 0].cpu(), ref_scores[:, 0],
                               rtol=1e-3, atol=1e-3)
    pos = torch.tensor([20, 11, 5])
    chunk = torch.randint(0, 64, (3, 5),
                          generator=torch.Generator().manual_seed(5))
    logits = []
    for m in (cpu, card):
        d = m.tok.w.device
        caches = m.init_cache(3)
        with torch.no_grad():
            m.prefill(prompt.to(d), caches)
            logits.append(m.decode_chunk(chunk.to(d), pos.to(d),
                                         caches).cpu())
    torch.testing.assert_close(logits[1], logits[0], rtol=1e-4, atol=1e-4)


# -- the decode loops replayed as CUDA graphs (utils/graphs.py) -------------
#
# The oracle of every graph is the loop's own eager form: the same step
# functions called directly (``Step.__call__`` patched to call ``fn``), on
# the same card, from the same weights.  Tokens must be equal bit for bit,
# and the launch and route counts of a run equal.

def _graph_model(dev, dtype):
    """A small TinyGPT on the card: f32 (2 heads of 64, K1's f32 route,
    split calls cooperative) or bf16 (2 heads of 128 on one KV head, K1's
    decode route)."""
    from taper_tpu_torch.models import TinyGPT
    if dtype == torch.float32:
        cfg = dict(vocab_size=64, dim=128, depth=2, num_heads=2, max_seq=96,
                   rope=True)
    else:
        cfg = dict(vocab_size=256, dim=256, depth=2, num_heads=2,
                   num_kv_heads=1, max_seq=96, rope=True)
    model = TinyGPT(**cfg)
    model.reset_parameters(torch.Generator().manual_seed(3))
    model = model.to(dev).eval()
    if dtype == torch.bfloat16:
        model.cast_projections(dtype)
        model.compute_dtype = dtype
    return model


def _counted(fn):
    torch.cuda.synchronize()
    backend.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, backend.launch_counts(), backend.route_counts()


def _eager_and_graph(monkeypatch, fn, owner=None):
    """``fn()`` through the eager loops, then through the graphs (a fresh
    program cache each on ``owner``, the model that keeps them), each
    with its launch and route counts."""
    from taper_tpu_torch.utils import graphs
    if owner is not None:
        graphs.clear(owner)
    with monkeypatch.context() as m:
        m.setattr(graphs.Step, "__call__", lambda self: self.fn())
        eager = _counted(fn)
    if owner is not None:
        graphs.clear(owner)
    graph = _counted(fn)
    return eager, graph


def _same(a, b):
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if torch.is_tensor(a):
        return torch.equal(a, b)
    return a == b


_GRAPH_CASES = {
    "generate": lambda m, p: m.generate(p, 20),
    "int8 cache": lambda m, p: m.generate(p, 20, quantized_cache=True),
    "ragged": lambda m, p: m.generate(
        p, 20, prompt_lens=torch.tensor([16, 9, 4])),
    "eos": lambda m, p: m.generate(
        p, 20, eos_token=int(m.generate(p, 4)[0, -1]), pad_token=0),
    "sampled": lambda m, p: m.generate(
        p, 20, temperature=0.8, top_k=20,
        generator=torch.Generator(p.device).manual_seed(5)),
    "continued": lambda m, p: m.generate_continued(
        p[:, :5], 12, m.generate(p, 3, return_cache=True)[1],
        past_len=18),
    "beam": lambda m, p: m.beam_search(p, 10, beams=3, return_all=True),
    "beam eos": lambda m, p: m.beam_search(
        p, 10, beams=3, eos_token=int(m.generate(p, 3)[0, -1]),
        return_all=True),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(_GRAPH_CASES))
def test_graph_generation_equals_its_eager_loop(dev, monkeypatch, case,
                                                dtype):
    """generate (one-shot, int8 cache, ragged, eos, sampled),
    generate_continued and beam_search replayed from captured steps give
    their eager loops' tokens bit for bit, with the same launches and K1
    routes (a replay counts what an eager step counts)."""
    model = _graph_model(dev, dtype)
    prompt = torch.randint(0, model.vocab_size, (3, 16),
                           generator=torch.Generator().manual_seed(4)).to(dev)
    (e_out, e_n, e_r), (g_out, g_n, g_r) = _eager_and_graph(
        monkeypatch, lambda: _GRAPH_CASES[case](model, prompt), model)
    assert _same(g_out, e_out), case
    assert g_n == e_n and g_r == e_r, (g_n, e_n, g_r, e_r)


def test_graph_ring_cache_generation_equals_its_eager_loop(dev, monkeypatch):
    """A window model decoding through W-slot ring caches past W."""
    from taper_tpu_torch.models import TinyGPT
    model = TinyGPT(64, 128, 2, 2, max_seq=96, rope=True, window=12)
    model.reset_parameters(torch.Generator().manual_seed(6))
    model = model.to(dev).eval()
    prompt = torch.randint(0, 64, (2, 10),
                           generator=torch.Generator().manual_seed(7)).to(dev)
    (e_out, e_n, _), (g_out, g_n, _) = _eager_and_graph(
        monkeypatch, lambda: model.generate(prompt, 30, ring_cache=True),
        model)
    assert torch.equal(g_out, e_out) and g_n == e_n


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("per_row", [True, False],
                         ids=["per_row", "lockstep"])
def test_graph_speculative_round_equals_its_eager_loop(dev, monkeypatch,
                                                      per_row, sampled):
    """Speculative decoding (f32 target, a draft of 4 heads of 32) with
    its round replayed: the eager rounds' tokens, statistics and counts."""
    from taper_tpu_torch.models import TinyGPT
    target = _graph_model(dev, torch.float32)
    draft = TinyGPT(64, 128, 1, 4, max_seq=96, rope=True)
    draft.reset_parameters(torch.Generator().manual_seed(8))
    draft = draft.to(dev).eval()
    prompt = torch.randint(0, 64, (3, 16),
                           generator=torch.Generator().manual_seed(9)).to(dev)
    kw = (dict(temperature=0.9, generator=torch.Generator(dev).manual_seed(2))
          if sampled else {})

    def run():
        if sampled:
            kw["generator"].manual_seed(2)
        return target.speculative_generate(draft, prompt, 24, gamma=4,
                                           per_row=per_row,
                                           return_stats=True, **kw)
    (e_out, e_n, e_r), (g_out, g_n, g_r) = _eager_and_graph(monkeypatch, run,
                                                            target)
    assert _same(g_out, e_out)
    assert g_n == e_n and g_r == e_r, (g_n, e_n)


@pytest.mark.parametrize("mode", ["paged bf16", "contiguous int8",
                                  "paged sampled"])
def test_graph_engine_block_equals_its_eager_loop(dev, monkeypatch, mode):
    """The engine's decode block replayed (paged bf16 pools through K16,
    a contiguous int8 cache, sampled rows beside greedy ones): the eager
    blocks' tokens for every request, and the same counts."""
    from taper_tpu_torch.serve import ServingEngine
    model = _graph_model(dev, torch.bfloat16)
    gen = torch.Generator().manual_seed(10)
    prompts = [torch.randint(0, 256, (n,), generator=gen).tolist()
               for n in (5, 16, 9, 12, 3)]
    kw = dict(pool_blocks=16, block_size=8) if "paged" in mode else {}

    def run():
        eng = ServingEngine(model, slots=3, prompt_pad=16, decode_block=4,
                            quantized_cache="int8" in mode, seed=1, **kw)
        ids = [eng.submit(p, 11, temperature=(0.7 if "sampled" in mode
                                              and i % 2 else None))
               for i, p in enumerate(prompts)]
        out = eng.run()
        return [out[i] for i in ids]
    (e_out, e_n, e_r), (g_out, g_n, g_r) = _eager_and_graph(monkeypatch, run)
    assert g_out == e_out
    assert g_n == e_n and g_r == e_r, (g_n, e_n)
    assert g_n["paged_decode"] > 0 if "paged" in mode else \
        g_n["paged_decode"] == 0


def test_graph_replay_counts_one_eager_step(dev):
    """One replay of a captured decode step adds to the launch and route
    counts exactly what one eager call of its function adds."""
    from taper_tpu_torch.utils import graphs
    model = _graph_model(dev, torch.bfloat16)
    prompt = torch.randint(0, 256, (4, 16),
                           generator=torch.Generator().manual_seed(11)).to(dev)
    model.generate(prompt, 6)
    (prog,) = graphs.programs(model)
    assert prog.step.graph is not None and prog.step.replays == 4
    prog.pos.fill_(16)                    # back to the first decode step
    _, n_eager, r_eager = _counted(prog.step.fn)
    prog.pos.fill_(16)
    _, n_replay, r_replay = _counted(prog.step)
    assert n_replay == n_eager and r_replay == r_eager
    assert n_eager["linear"] == 6 * model.depth


def _traced_kernels(fn, path):
    """Device kernels ``fn()`` launched, by name, from a torch.profiler
    trace (without the CUDA runtime's copy kernels, which run a graph's copy
    nodes where an eager copy is a memcpy)."""
    import collections
    import json
    import time
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof, \
            torch.no_grad():
        time.sleep(0.01)                  # kernels at the window's edges
        fn()
        torch.cuda.synchronize()
        time.sleep(0.01)
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return collections.Counter(
        e["name"] for e in events if e.get("cat") == "kernel"
        and not e["name"].startswith(("memcpy", "memset")))


@pytest.mark.parametrize("paged", [False, True], ids=["generate", "paged"])
def test_graph_replay_launches_the_eager_steps_kernels(dev, tmp_path, paged):
    """A replay, traced on the device, launches the kernels of the same
    step called eagerly, name by name (the port's among them), so the
    counts a replay adds stand for launches the trace saw."""
    from taper_tpu_torch.serve import ServingEngine
    from taper_tpu_torch.utils import graphs
    model = _graph_model(dev, torch.bfloat16)
    prompt = torch.randint(0, 256, (3, 16),
                           generator=torch.Generator().manual_seed(13))
    if paged:
        eng = ServingEngine(model, slots=3, prompt_pad=16, decode_block=4,
                            pool_blocks=16, block_size=8, seed=1)
        for row in prompt.tolist():
            eng.submit(row, 20)
        eng.step()                        # admissions and the warm-up
        eng._decode_block()               # the capture
        (step,) = eng._blocks.values()
        rewind = lambda: None                             # noqa: E731
    else:
        model.generate(prompt.to(dev), 6)
        prog = graphs.programs(model)[-1]
        step = prog.step
        rewind = lambda: prog.pos.fill_(16)               # noqa: E731
    assert step.graph is not None
    rewind()
    replayed = _traced_kernels(step, tmp_path / "replay.json")
    rewind()
    eager = _traced_kernels(step.fn, tmp_path / "eager.json")
    assert replayed == eager
    ours = {k: c for k, c in replayed.items() if "taper::" in k}
    assert sum(ours.values()) >= sum(step._delta[0].values()) > 0


def test_graph_replay_advances_its_generator(dev):
    """A registered generator advances on every replay: four replays draw
    four different rows, the same seed draws them again, and they are the
    draws the eager calls make from that seed."""
    from taper_tpu_torch.utils import graphs
    gen = torch.Generator(dev)
    probs = torch.softmax(torch.randn(4, 1000, device=dev), -1)
    out = torch.zeros(4, dtype=torch.long, device=dev)
    draw = lambda: out.copy_(torch.multinomial(probs, 1, generator=gen)[:, 0])  # noqa: E731
    eager = []
    gen.manual_seed(0)
    for _ in range(5):
        draw()
        eager.append(out.clone())
    step = graphs.Step(draw, dev, [gen])
    runs = []
    for _ in range(2):
        gen.manual_seed(0)
        rows = []
        for _ in range(5):
            step()
            rows.append(out.clone())
        runs.append(rows)
    assert step.replays == 9
    assert len({tuple(r.tolist()) for r in runs[0]}) == 5
    assert all(torch.equal(a, b) for a, b in zip(runs[0], runs[1]))
    assert all(torch.equal(a, b) for a, b in zip(runs[0], eager))


def test_graph_capture_refuses_a_host_copy(dev):
    """A step that copies a host value to the card raises at its capture,
    with nothing counted, rather than baking the value into the graph."""
    from taper_tpu_torch.utils import graphs
    buf = torch.zeros(4, device=dev)
    value = [1.0]

    def step():
        backend.count_launch("add")
        buf.add_(torch.tensor(value[0], device=dev))

    s = graphs.Step(step, dev)
    s()                                   # the warm-up runs eagerly
    value[0] = 2.0
    backend.reset_launch_counts()
    with pytest.raises(RuntimeError, match="capture"):
        s()
    assert backend.launch_counts()["add"] == 0 and s.graph is None
    torch.cuda.synchronize()
    assert torch.equal(buf.cpu(), torch.ones(4))


def test_offline_serve_on_card_equals_generate(dev):
    """offline_serve on the card (bf16, slots < N, budgets across decode
    blocks): each request's greedy tokens are standalone generate's on the
    same card, zeros past each count."""
    from taper_tpu_torch.serve import offline_serve
    model = _graph_model(dev, torch.bfloat16)
    gen = torch.Generator().manual_seed(12)
    lens = [16, 5, 11, 8, 13]
    prompts = torch.zeros(5, 16, dtype=torch.long)
    for i, n in enumerate(lens):
        prompts[i, :n] = torch.randint(0, 256, (n,), generator=gen)
    budgets = [30, 3, 17, 1, 22]
    out, n_tok = offline_serve(model, prompts, lens, budgets, slots=2)
    assert n_tok.tolist() == budgets
    for i, (n, m) in enumerate(zip(lens, budgets)):
        ref = model.generate(prompts[i:i + 1, :n].to(dev), m)[0, n:]
        assert out[i, :m].tolist() == ref.tolist(), i
        assert not out[i, m:].any()
