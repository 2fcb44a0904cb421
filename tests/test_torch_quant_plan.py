"""K15's routing (taper_tpu_torch/ops/quant.py ``plan``) on the CPU.

``plan`` is a pure function of the shape and the operands' alignment: the
int8 warpgroup-MMA kernel (``wgmma``) reads its operands through TMA,
which needs rows of whole 16-byte units (K % 16 == 0) from 16-byte-aligned
bases; every other product takes the ``mma.sync`` kernel (``mma``), which
reads any row.  M does not choose: TMA zero-fills the tiles' ragged rows,
so decode's 8 rows run on ``wgmma`` too.  The tests pin the route at the
W8A8 prefill's shapes, at decode's M, at ragged K and at misaligned views,
and that the plain versions on the CPU count no route.

K12's routing (``plan_q``) is pinned the same way: its ``wgmma`` kernel
at M > 16 where TMA reads both operands (K % 16 == 0, 16-byte-aligned
bases) and stores the f32 output (N % 4 == 0, rows of whole 16-byte
units); ``wmma`` for decode's M <= 16 and the rest (the CNN's 10-way head
among them).  Its wrapper, against a recorder in place of the kernel
library, counts the route it passes.
"""

import pytest
import torch

from taper_tpu_torch.ops import _build, backend
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
    (2000, 10, 64, True, "wmma"),       # N * 4 = 40 bytes a row: no TMA store
    (17, 4, 16, True, "wgmma"),         # the least M, N and K it takes
    (16, 2048, 2048, True, "wmma"),     # decode's M
    (8, 8192, 2048, True, "wmma"),
    (1, 1, 1, True, "wmma"),
    (300, 1024, 1030, True, "wmma"),    # K % 16: the codes' rows
    (300, 1024, 1032, True, "wmma"),    # K % 16 == 8
    (300, 1022, 1024, True, "wmma"),    # N % 4
    (300, 1020, 1024, True, "wgmma"),
    (4096, 2048, 2048, False, "wmma"),  # a misaligned base
])
def test_plan_q_by_m_k_alignment_and_the_output_row(m, n, k, aligned, want):
    assert Q.plan_q(m, n, k, aligned) == want


@pytest.mark.parametrize("offset_x,offset_q,want", [
    (0, 0, "wgmma"), (4, 0, "wgmma"), (1, 0, "wmma"), (0, 16, "wgmma"),
    (0, 8, "wmma")])
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
    calls = [Q.plan_q(*s, a) for s in shapes for a in (True, False)]
    assert calls == [Q.plan_q(*s, a) for s in shapes for a in (True, False)]
    assert set(calls) == {"wgmma", "wmma"}
    with pytest.raises(ValueError, match="empty"):
        Q.plan_q(16, 0, 16, True)


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
    sums; K13 takes the WMMA kernel and counts no route."""
    gen = torch.Generator().manual_seed(0)

    def call(m, n, k, fn=Q.linear_q8):
        x = torch.randn(m, k, generator=gen)
        q = torch.randint(-128, 128, (n, k), generator=gen,
                          dtype=torch.int8)
        return fn(x, q, 0.01, torch.zeros(n), torch.zeros(n))

    for shape in ((4096, 2048, 2048), (2000, 10, 64), (8, 2048, 2048),
                  (300, 1024, 1030), (2000, 128, 128)):
        call(*shape)
    packed = torch.zeros(64, 16, dtype=torch.uint8)
    Q.linear_q4(torch.randn(20, 32), packed, 0.01, 0.0, n_features=32)
    names = [name for name, _ in recorder.calls]
    assert names == ["taper_linear_q"] * 6
    for _, args in recorder.calls:
        assert len(args) == len(_build._SIGNATURES["taper_linear_q"])
    routes = [args[-2] for _, args in recorder.calls]
    wgmma, wmma = Q.Q8_ROUTES["wgmma"], Q.Q8_ROUTES["wmma"]
    assert routes == [wgmma, wmma, wmma, wmma, wgmma, wmma]
    workspaces = [args[6] for _, args in recorder.calls]
    assert [w is not None for w in workspaces] == [True, False, False,
                                                   False, True, False]
    assert backend.route_counts() == {"wgmma linear_q8": 2,
                                      "wmma linear_q8": 3}
    counts = backend.launch_counts()
    assert counts["linear_q8"] == 5 and counts["linear_q4"] == 1
