"""The benchmark's own CPU tests: ``python -m pytest -q perfbench/tests``
from the repo root (the repo's test run does not collect them). Tests that
need the card carry the ``cuda`` marker and skip without one."""
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def tiny():
    """A two-layer, 64-wide dense configuration the program builds on the CPU."""
    with open(os.path.join(os.path.dirname(__file__), "tiny-dense.json")) as f:
        return json.load(f)


@pytest.fixture
def one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
