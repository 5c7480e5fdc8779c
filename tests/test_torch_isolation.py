"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points run on CUDA unless the caller asks for the CPU."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)|from\s+repro(\.|\s+import))",
    re.MULTILINE,
)


def test_importing_the_port_loads_no_jax_and_no_repro():
    code = (
        "import sys, repro_torch, repro_torch.fl, repro_torch.core, repro_torch.kernels.ops\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr


def test_no_source_file_imports_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(f.relative_to(ROOT)) for f in files if FORBIDDEN.search(f.read_text())]
    assert offenders == []
    assert FORBIDDEN.search("from repro.core import x") and FORBIDDEN.search("import jax.numpy")
    assert not FORBIDDEN.search("from repro_torch.core import x")


def test_engine_without_device_raises_on_a_cpu_only_host(monkeypatch):
    from repro_torch.data import make_population
    from repro_torch.fl import AuxoConfig, AuxoEngine, FLConfig, MLPTask

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pop = make_population(n_clients=8, n_groups=2, test_per_group=8, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        AuxoEngine(MLPTask(), pop, FLConfig(rounds=1), AuxoConfig())
    # asking for the CPU explicitly is the supported way to run without a card
    eng = AuxoEngine(MLPTask(), pop, FLConfig(rounds=1), AuxoConfig(), device="cpu")
    assert eng.pipeline.bank.params["w0"].device.type == "cpu"


def test_core_entry_points_without_device_raise_on_a_cpu_only_host(monkeypatch):
    import numpy as np

    from repro_torch.convert import cluster_state_from_numpy
    from repro_torch.core import ClusterState, CohortCoordinator, OnlineClustering

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fields = {f: np.zeros(s, np.float32) for f, s in (
        ("centroids", (2, 8)), ("counts", (2,)), ("round_counts", (2,)), ("dispersion", ()),
        ("margin", ()), ("cluster_dispersion", (2,)), ("initialized", ()), ("round", ()),
    )}
    for make in (
        lambda **kw: CohortCoordinator(d_sketch=8, **kw),
        lambda **kw: OnlineClustering(2, 8, **kw),
        lambda **kw: ClusterState.create(2, 8, **kw),
        lambda **kw: cluster_state_from_numpy(**fields, **kw),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
        make(device="cpu")
    assert CohortCoordinator(d_sketch=8, device="cpu").clusterers["0"].state.centroids.device.type == "cpu"


def test_later_slices_raise_not_implemented():
    from repro_torch.data import make_population
    from repro_torch.fl import AuxoConfig, AuxoEngine, FLConfig, MLPTask

    pop = make_population(n_clients=8, n_groups=2, test_per_group=8, seed=0)
    for kw in (dict(round_overlap=1), dict(cohort_shards=2), dict(population_store=True),
               dict(execution="sequential")):
        with pytest.raises(NotImplementedError):
            AuxoEngine(MLPTask(), pop, FLConfig(rounds=1, **kw), AuxoConfig(), device="cpu")
