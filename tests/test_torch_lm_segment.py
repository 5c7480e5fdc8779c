"""The segment kernel at the calls of the LM training step
(``repro_torch.launch.steps``): the per-leaf aggregation (1, C, n_leaf) into
one weighted segment, up to granite-3-2b's (40, 2048, 8192) MLP leaf, and
the clustering sums and counts, each against the plain version. These need
a CUDA card and skip without one; no JAX is needed:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_lm_segment.py``.
"""
import pytest
import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref


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
