"""K15's routing (taper_tpu_torch/ops/quant.py ``plan``) on the CPU.

``plan`` is a pure function of the shape and the operands' alignment: the
int8 warpgroup-MMA kernel (``wgmma``) reads its operands through TMA,
which needs rows of whole 16-byte units (K % 16 == 0) from 16-byte-aligned
bases; every other product takes the ``mma.sync`` kernel (``mma``), which
reads any row.  M does not choose: TMA zero-fills the tiles' ragged rows,
so decode's 8 rows run on ``wgmma`` too.  The tests pin the route at the
W8A8 prefill's shapes, at decode's M, at ragged K and at misaligned views,
and that the plain versions on the CPU count no route.
"""

import pytest
import torch

from taper_tpu_torch.ops import backend
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
    assert backend.route_counts() == {}
    assert not any(backend.launch_counts().values())
