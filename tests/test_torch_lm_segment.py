"""The segment kernel at the calls of the LM training step
(``repro_torch.launch.steps``): the per-leaf aggregation (1, C, n_leaf) into
one weighted segment, up to granite-3-2b's (40, 2048, 8192) MLP leaf, and
the clustering sums and counts, each against the plain version, and the
kernel's plan at its edges (a ragged row, a row start off 16 bytes, rows
past one chunk of the row lists), each bit-equal to the plain version run
on a CPU copy (``index_add_`` in row order). These need a CUDA card and
skip without one; no JAX is needed:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_lm_segment.py``.
"""
import pytest
import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels import segment_aggregate as sa


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_per_leaf_aggregation_at_granite_mlp_leaf_matches_plain(cuda):
    """The largest aggregation call of a full-width granite-3-2b round: one
    (40, 2048, 8192) MLP leaf of 2 clients' deltas into one segment."""
    g = torch.Generator(device=cuda).manual_seed(0)
    N = 40 * 2048 * 8192
    assert N == 671_088_640
    d = torch.randn((1, 2, N), generator=g, device=cuda)
    w = torch.tensor([[0.3, 0.7]], device=cuda)
    ids = torch.zeros((1, 2), dtype=torch.int32, device=cuda)
    got = kops.segment_aggregate(d, ids, 1, w)
    want = w[0, 0] * d[0, 0] + w[0, 1] * d[0, 1]
    assert tuple(got.shape) == (1, 1, N)
    torch.testing.assert_close(got[0, 0], want, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,k,weighted", [((1, 4, 128), 2, False), ((1, 4, 1), 2, False),
                                              ((1, 2, 4096 * 8192 + 3), 1, True)])
def test_lm_path_segment_calls_match_plain(cuda, shape, k, weighted):
    g = torch.Generator(device=cuda).manual_seed(1)
    d = torch.randn(shape, generator=g, device=cuda)
    ids = torch.randint(0, k, shape[:2], generator=g, device=cuda)
    w = torch.rand(shape[:2], generator=g, device=cuda) if weighted else None
    torch.testing.assert_close(kops.segment_aggregate(d, ids, k, w), kref.segment_aggregate(d, ids, k, w),
                               rtol=2e-5, atol=2e-5)


def _bit_equal_on_cpu_copy(d, ids, k, w):
    got = kops.segment_aggregate(d, ids, k, w).cpu()
    want = kref.segment_aggregate(d.cpu(), ids.cpu(), k, None if w is None else w.cpu())
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("D, vec", [(6, 4), (1_000_002, 8), (1_000_003, 4)])
def test_two_rows_of_a_ragged_width_bit_equal(cuda, D, vec):
    """P = 2, D not a multiple of 4: 8- and 4-byte vectors, no tail."""
    g = torch.Generator(device=cuda).manual_seed(D)
    d = torch.randn((1, 2, D), generator=g, device=cuda)
    w = torch.rand((1, 2), generator=g, device=cuda)
    assert sa.plan(1, 2, D, 1, 4, 132, d.data_ptr()).vec_bytes == vec
    _bit_equal_on_cpu_copy(d, torch.zeros((1, 2), dtype=torch.int32, device=cuda), 1, w)


@pytest.mark.cuda
@pytest.mark.parametrize("offset, vec", [(1, 2), (2, 4), (4, 4)])
def test_bf16_rows_off_16_bytes_bit_equal(cuda, offset, vec):
    """bf16 data starting `offset` elements past an aligned address, rows of
    6922 values (13,844 bytes): no row starts on a 16-byte boundary."""
    C, P, D, K = 2, 40, 6922, 7
    g = torch.Generator(device=cuda).manual_seed(offset)
    buf = torch.randn(C * P * D + offset, generator=g, device=cuda).to(torch.bfloat16)
    d = buf[offset:].view(C, P, D)
    assert d.data_ptr() % 16 == 2 * offset and sa.plan(C, P, D, K, 2, 132, d.data_ptr()).vec_bytes == vec
    ids = torch.randint(-1, K + 1, (C, P), generator=g, device=cuda)
    w = torch.rand((C, P), generator=g, device=cuda)
    for wt in (None, w):
        _bit_equal_on_cpu_copy(d, ids, K, wt)


@pytest.mark.cuda
@pytest.mark.parametrize("D, K", [(33, 4), (1, 3), (512, 1)])
def test_rows_past_the_list_chunk_bit_equal(cuda, D, K):
    """P = 3 chunks of the row lists and 5 rows: each chunk continues the
    sums the earlier ones stored."""
    P = 3 * sa.CHUNK + 5
    g = torch.Generator(device=cuda).manual_seed(D + K)
    d = torch.randn((2, P, D), generator=g, device=cuda)
    ids = torch.randint(-1, K + 1, (2, P), generator=g, device=cuda)
    w = torch.rand((2, P), generator=g, device=cuda)
    for wt in (None, w):
        _bit_equal_on_cpu_copy(d, ids, K, wt)
        _bit_equal_on_cpu_copy(d.bfloat16(), ids.int(), K, wt)
