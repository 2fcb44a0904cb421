"""K15's routing (taper_tpu_torch/ops/quant.py ``plan``) on the CPU.

``plan`` is a pure function of the shape and the operands' alignment: the
int8 warpgroup-MMA kernel (``wgmma``) reads its operands through TMA,
which needs rows of whole 16-byte units (K % 16 == 0) from 16-byte-aligned
bases; every other product takes the ``mma.sync`` kernel (``mma``), which
reads any row.  M does not choose: TMA zero-fills the tiles' ragged rows,
so decode's 8 rows run on ``wgmma`` too.  The tests pin the route at the
W8A8 prefill's shapes, at decode's M, at ragged K and at misaligned views,
and that the plain versions on the CPU count no route.

K12's and K13's routing (``plan_q``) is pinned the same way: ``decode``
at M <= 16 where each thread's 16-byte code loads tile the rows (int8 K %
16 == 0, int4 K % 32 == 0) from 16-byte-aligned bases; the ``wgmma``
kernel at M > 16 where TMA reads both operands (the same whole units,
16-byte-aligned bases) and stores the f32 output (N % 4 == 0, rows of
whole 16-byte units), for int8 and int4 codes alike; ``mma``, the
``mma.sync`` kernel of ``decode`` with loads as wide as the rows allow,
for the rest (the CNN's 10-way head among them).  The decode route's
cluster size (``decode_splits``) is pinned at the quantized model's
shapes, and the mma route's token group (``mma_rows``) at the PTQ head.
The wrapper, against a recorder in place of the kernel library, counts
the route it passes, and passes a per-tensor scale and zero point as
they are, with a stride of 0.
"""

import pytest
import torch

from taper_tpu_torch.ops import _build, backend
from taper_tpu_torch.ops import gemm as G
from taper_tpu_torch.ops import quant as Q

# the W8A8 prefill of bench.py:273-301: 4 x 1,024 rows, dim 2,048
W8A8_SHAPES = [(4096, 2048, 2048), (4096, 8192, 2048), (4096, 2048, 8192)]


@pytest.mark.parametrize("m,n,k,aligned,want", [
    *[(m, n, k, True, "wgmma") for m, n, k in W8A8_SHAPES],
    (8, 2048, 2048, True, "wgmma"),     # decode's M beside K12
    (1, 1, 16, True, "wgmma"),
    (256, 2048, 8192, True, "wgmma"),   # W8A8's least M
    (37, 53, 100, True, "mma"),         # K % 16: no TMA
    (4096, 2048, 2050, True, "mma"),
    (3, 5, 7, True, "mma"),
    (4096, 2048, 2048, False, "mma"),   # a misaligned base
    (8, 64, 128, False, "mma"),
])
def test_plan_by_k_alignment_and_m(m, n, k, aligned, want):
    assert Q.plan(m, n, k, aligned) == want


def _codes(m, k, offset=0):
    buf = torch.zeros(offset + m * k, dtype=torch.int8)
    return buf[offset:].view(m, k)


@pytest.mark.parametrize("offset_x,offset_q,k,want", [
    (0, 0, 2048, "wgmma"), (16, 32, 2048, "wgmma"), (3, 0, 2048, "mma"),
    (0, 1, 128, "mma"), (0, 0, 2050, "mma"), (16, 0, 100, "mma")])
def test_plan_for_judges_the_views_as_given(offset_x, offset_q, k, want):
    xq, q = _codes(64, k, offset_x), _codes(48, k, offset_q)
    assert Q.plan_for(xq, q) == want


def test_plan_is_pure_and_refuses_empty_products():
    shapes = [(m, n, k) for m in (1, 8, 300, 4096) for n in (1, 130, 2048)
              for k in (7, 16, 100, 2048, 2050)]
    calls = [Q.plan(*s, a) for s in shapes for a in (True, False)]
    assert calls == [Q.plan(*s, a) for s in shapes for a in (True, False)]
    assert set(calls) == {"wgmma", "mma"}
    with pytest.raises(ValueError, match="empty"):
        Q.plan(0, 16, 16, True)


def test_plain_versions_count_no_route():
    xq, q = _codes(8, 32), _codes(4, 32)
    backend.reset_launch_counts()
    Q.matmul_int8(xq, q)
    Q.matmul_int8_scaled(xq, q, torch.ones(8), torch.zeros(8),
                         torch.ones(4), torch.zeros(4))
    Q.linear_q8(torch.ones(64, 32), q, 0.5, 0.0)
    assert backend.route_counts() == {}
    assert not any(backend.launch_counts().values())


# K12's shapes on the port's paths: the W8A8 model's projections run
# through K12 at M 4,096 (phase 18's int8 forward), the PTQ example's FC
# layers at an eval batch of 2,000 (M, 128, 128) and (M, 64, 128) and its
# 10-way head, and the quantized model's decode at M 8
@pytest.mark.parametrize("m,n,k,aligned,want", [
    *[(m, n, k, True, "wgmma") for m, n, k in W8A8_SHAPES],
    (2000, 128, 128, True, "wgmma"),
    (2000, 64, 128, True, "wgmma"),
    (2000, 10, 64, True, "mma"),        # N * 4 = 40 bytes a row: no TMA store
    (17, 4, 16, True, "wgmma"),         # the least M, N and K it takes
    (16, 2048, 2048, True, "decode"),   # decode's M
    (8, 8192, 2048, True, "decode"),
    (1, 1, 16, True, "decode"),
    (16, 10, 64, True, "decode"),       # any N at decode
    (1, 1, 1, True, "mma"),
    (8, 2048, 2056, True, "mma"),       # K % 16 == 8 at decode
    (8, 2048, 2048, False, "mma"),      # a misaligned base at decode
    (300, 1024, 1030, True, "mma"),     # K % 16: the codes' rows
    (300, 1024, 1032, True, "mma"),     # K % 16 == 8
    (300, 1022, 1024, True, "mma"),     # N % 4
    (300, 1020, 1024, True, "wgmma"),
    (4096, 2048, 2048, False, "mma"),   # a misaligned base
])
def test_plan_q_by_m_k_alignment_and_the_output_row(m, n, k, aligned, want):
    assert Q.plan_q(m, n, k, aligned) == want


@pytest.mark.parametrize("offset_x,offset_q,want", [
    (0, 0, "wgmma"), (4, 0, "wgmma"), (1, 0, "mma"), (0, 16, "wgmma"),
    (0, 8, "mma")])
def test_plan_q_for_judges_the_views_as_given(offset_x, offset_q, want):
    """x's base moves by ``offset_x`` f32 elements, q's by ``offset_q``
    bytes."""
    m, n, k = 64, 48, 256
    x = torch.zeros(offset_x + m * k)[offset_x:].view(m, k)
    q = _codes(n, k, offset_q)
    assert Q.plan_q_for(x, q) == want


def test_plan_q_is_pure_and_refuses_empty_products():
    shapes = [(m, n, k) for m in (1, 16, 17, 2000, 4096)
              for n in (4, 10, 130, 2048) for k in (7, 16, 100, 2048)]
    calls = [Q.plan_q(*s, a, bits) for s in shapes for a in (True, False)
             for bits in (8, 4)]
    assert calls == [Q.plan_q(*s, a, bits) for s in shapes
                     for a in (True, False) for bits in (8, 4)]
    assert set(calls) == {"wgmma", "mma", "decode"}
    with pytest.raises(ValueError, match="empty"):
        Q.plan_q(16, 0, 16, True)
    with pytest.raises(ValueError, match="bit"):
        Q.plan_q(16, 16, 16, True, 2)


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


def test_k12_wrapper_counts_the_planned_route(recorder):
    """K12 passes and counts the route plan_q gives (one launch a call),
    the wgmma route with a workspace for its row pass's bf16 x and row
    sums, the decode route with its cluster's size, the decode and mma
    routes with mma_rows' token group; K13 counts its route too."""
    gen = torch.Generator().manual_seed(0)

    def call(m, n, k, fn=Q.linear_q8):
        x = torch.randn(m, k, generator=gen)
        q = torch.randint(-128, 128, (n, k), generator=gen,
                          dtype=torch.int8)
        return fn(x, q, 0.01, torch.zeros(n), torch.zeros(n))

    shapes = ((4096, 2048, 2048), (2000, 10, 64), (8, 2048, 2048),
              (300, 1024, 1030), (2000, 128, 128))
    for shape in shapes:
        call(*shape)
    packed = torch.zeros(64, 16, dtype=torch.uint8)
    Q.linear_q4(torch.randn(20, 32), packed, 0.01, 0.0, n_features=32)
    names = [name for name, _ in recorder.calls]
    assert names == ["taper_linear_q"] * 6
    for _, args in recorder.calls:
        assert len(args) == len(_build._SIGNATURES["taper_linear_q"])
    routes = [args[12] for _, args in recorder.calls]
    wgmma, mma = Q.Q8_ROUTES["wgmma"], Q.Q8_ROUTES["mma"]
    decode = Q.Q8_ROUTES["decode"]
    assert routes == [wgmma, mma, decode, mma, wgmma, wgmma]
    splits = [args[14] for _, args in recorder.calls]
    assert splits == [1, 1, Q.decode_splits(2048, 2048, 8), 1, 1, 1]
    rows = [args[15] for _, args in recorder.calls]
    assert rows == [Q.mma_rows(m, n) for m, n, _ in shapes] + [8]
    assert rows[1:3] == [8, 8]
    workspaces = [args[6] for _, args in recorder.calls]
    assert [w is not None for w in workspaces] == [True, False, False,
                                                   False, True, True]
    assert backend.route_counts() == {"wgmma linear_q8": 2,
                                      "mma linear_q8": 2,
                                      "decode linear_q8": 1,
                                      "wgmma linear_q4": 1}
    counts = backend.launch_counts()
    assert counts["linear_q8"] == 5 and counts["linear_q4"] == 1


# K13 (int4 codes, two to a byte): decode and wgmma where each 16 bytes of
# a code row hold 32 codes, so K % 32 == 0; wgmma at M > 16 where TMA also
# stores y (N % 4 == 0); mma for the rest
@pytest.mark.parametrize("m,n,k,aligned,want", [
    (8, 2048, 2048, True, "decode"), (1, 512, 2048, True, "decode"),
    (16, 2048, 8192, True, "decode"), (8, 64, 32, True, "decode"),
    (17, 2048, 2048, True, "wgmma"), (4096, 2048, 2048, True, "wgmma"),
    (8, 2048, 2064, True, "mma"),       # K % 32 == 16
    (8, 2048, 2048, False, "mma"),      # a misaligned base
    # phase 18's int4 forward: M 4,096 at the model's three shapes
    (4096, 8192, 2048, True, "wgmma"), (4096, 2048, 8192, True, "wgmma"),
    (17, 4, 32, True, "wgmma"),         # the least M, N and K it takes
    (4096, 2048, 2064, True, "mma"),    # K % 32 == 16 at M > 16
    (2000, 130, 64, True, "mma"),       # N % 4 == 2
    (2000, 10, 64, True, "mma"),        # the PTQ head's shape
    (4096, 2048, 2048, False, "mma"),   # a misaligned base at M > 16
    (300, 1024, 1040, True, "mma"),     # K % 16 == 0, K % 32 == 16
])
def test_plan_q_for_int4_codes(m, n, k, aligned, want):
    assert Q.plan_q(m, n, k, aligned, 4) == want


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m", [1, 8, 16, 17])
def test_plan_q_names_decode_at_decode_rows_only(m, bits):
    for n, k in ((2048, 2048), (512, 2048), (8192, 2048), (2048, 8192)):
        want = "decode" if m <= 16 else "wgmma"
        assert Q.plan_q(m, n, k, True, bits) == want


# the quantized model's decode shapes (dim 2,048, 4 of 16 heads' width for
# k and v): wq/wo, wk/wv, w1, w2
@pytest.mark.parametrize("n,k,bits,want", [
    (2048, 2048, 8, 2), (512, 2048, 8, 2), (8192, 2048, 8, 1),
    (2048, 8192, 8, 2), (2048, 2048, 4, 2), (512, 2048, 4, 2),
    (8192, 2048, 4, 1), (2048, 8192, 4, 2),
    (64, 64, 8, 1),                     # under a rank's least share
    (1024, 512, 4, 1),
    (32, 65536, 8, 2),                  # the largest cluster
])
def test_decode_splits_at_the_model_shapes(n, k, bits, want):
    got = Q.decode_splits(n, k, bits)
    assert got == want
    tiles = -(-n // G.DECODE_TILE[0])
    assert got == 1 or (tiles * got <= 2 * G.SMS
                        and got <= Q.DECODE_MAX_RANKS
                        and k * bits // 8 // got >= Q.DECODE_MIN_BYTES)


@pytest.mark.parametrize("offset_x,offset_q,want", [
    (0, 0, "decode"), (4, 16, "decode"), (1, 0, "mma"), (0, 8, "mma")])
def test_plan_q_for_int4_judges_the_views_as_given(offset_x, offset_q, want):
    m, n, k = 8, 48, 256
    x = torch.zeros(offset_x + m * k)[offset_x:].view(m, k)
    q = torch.zeros(offset_q + n * k // 2, dtype=torch.uint8)[offset_q:]
    assert Q.plan_q_for(x, q.view(n, k // 2), 4) == want


def test_k13_wrapper_passes_the_decode_split(recorder):
    """K13 at decode passes route decode and decode_splits' cluster, and
    counts "decode linear_q4"."""
    x = torch.randn(8, 8192)
    packed = torch.zeros(2048, 4096, dtype=torch.uint8)
    Q.linear_q4(x, packed, 0.01, 0.0, n_features=8192)
    (name, args), = recorder.calls
    assert args[12] == Q.Q8_ROUTES["decode"] and args[10] == 4
    assert args[14] == Q.decode_splits(2048, 8192, 4) == 2
    assert backend.route_counts() == {"decode linear_q4": 1}


# The mma route's token group (activation rows a block): 8 or 16 as at
# decode, and above 16 rows 16 unless that leaves SMs idle; the PTQ
# example's 10-way head (N 10: one 32-row weight block, M 2,000) takes 8
@pytest.mark.parametrize("m,n,want", [
    (1, 2048, 8), (8, 512, 8), (9, 2048, 16), (16, 10, 16),
    (2000, 10, 8),                      # the PTQ head: 125 blocks of 16
    (2000, 130, 16), (4096, 2048, 16), (17, 4, 8),
    (2112, 32, 16), (2096, 32, 8),      # 132 and 131 blocks of 16 rows
])
def test_mma_rows_sizes_the_token_group_to_the_shape(m, n, want):
    assert Q.mma_rows(m, n) == want
    blocks16 = -(-n // Q.MMA_WEIGHT_ROWS) * -(-m // 16)
    assert (want == 16) == (8 < m <= 16 or (m > 16 and blocks16 >= G.SMS))


def test_per_tensor_terms_reach_the_kernel_args_without_a_copy():
    """A per-tensor scale and zero point reach ``taper_linear_q``'s
    arguments as the tensors they are, with a stride of 0 (no [N]
    expansion), an int32 zero point (PTQ's) as int32; per-channel vectors
    with a stride of 1, also uncopied."""
    n, k = 48, 64
    x = torch.randn(20, k)
    q = torch.zeros(n, k, dtype=torch.int8)
    y = torch.empty(20, n)
    scale, zp = torch.tensor(0.02), torch.tensor(3, dtype=torch.int32)
    vs, vz = torch.rand(n), torch.zeros(n)
    zdt = (torch.float32, torch.int32)
    for (s, ss), (z, zs), want in (
            (Q._term(scale, n, "cpu"), Q._term(zp, n, "cpu", zdt), (0, 0, 1)),
            (Q._term(vs, n, "cpu"), Q._term(zp, n, "cpu", zdt), (1, 0, 1)),
            (Q._term(vs, n, "cpu"), Q._term(vz, n, "cpu", zdt), (1, 1, 0))):
        args = Q.q_linear_args(x, q, s, ss, z, zs, None, y, None, 8, "relu",
                               "mma", 1, 8, 0)
        assert len(args) == len(_build._SIGNATURES["taper_linear_q"])
        assert args[16:] == want
        assert args[2] == s.data_ptr() and args[3] == z.data_ptr()
    assert Q._term(scale, n, "cpu")[0].data_ptr() == scale.data_ptr()
    assert Q._term(zp, n, "cpu", zdt)[0].data_ptr() == zp.data_ptr()
    assert Q._term(vs, n, "cpu")[0].data_ptr() == vs.data_ptr()
    assert Q._term(0.5, n, "cpu")[1] == 0
    assert Q._term(zp, n, "cpu")[0].dtype == torch.float32
    with pytest.raises(ValueError, match="channels"):
        Q._term(torch.ones(n - 1), n, "cpu")


def test_wrapper_passes_per_tensor_terms_as_they_are(recorder):
    """linear_q8 and linear_q4 hand a per-tensor scale and zero point
    (PTQ's 0-d f32 and int32 tensors) to the library with their own
    pointers and a stride of 0."""
    scale, zp = torch.tensor(0.01), torch.tensor(-2, dtype=torch.int32)
    Q.linear_q8(torch.randn(8, 64), torch.zeros(32, 64, dtype=torch.int8),
                scale, zp)
    Q.linear_q4(torch.randn(300, 64), torch.zeros(32 * 32, dtype=torch.uint8),
                scale, zp, n_features=64)
    for _, args in recorder.calls:
        assert args[2] == scale.data_ptr() and args[3] == zp.data_ptr()
        assert args[16:] == (0, 0, 1)
    assert backend.route_counts() == {"decode linear_q8": 1,
                                      "wgmma linear_q4": 1}


def test_k13_wrapper_routes_m_over_16(recorder):
    """K13 at M > 16: wgmma with its row pass's workspace where TMA takes
    the shape; mma (no workspace, a token group, no cluster) at a ragged
    K, an N that is not a multiple of 4, and a misaligned x."""
    def call(m, n, k, x_off=0):
        x = torch.randn(x_off + m * k)[x_off:].view(m, k)
        packed = torch.zeros(n * k // 2, dtype=torch.uint8)
        Q.linear_q4(x, packed, 0.01, 0.0, n_features=k)

    call(4096, 64, 128)
    call(64, 48, 2064)
    call(2000, 10, 64)
    call(64, 48, 256, x_off=1)
    routes = [args[12] for _, args in recorder.calls]
    wgmma, mma = Q.Q8_ROUTES["wgmma"], Q.Q8_ROUTES["mma"]
    assert routes == [wgmma, mma, mma, mma]
    assert [args[6] is not None for _, args in recorder.calls] == [
        True, False, False, False]
    assert [args[14] for _, args in recorder.calls] == [1, 1, 1, 1]
    assert [args[15] for _, args in recorder.calls][1:] == [8, 8, 8]
    assert backend.route_counts() == {"wgmma linear_q4": 1,
                                      "mma linear_q4": 3}
