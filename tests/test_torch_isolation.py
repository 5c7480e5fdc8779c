"""The port stands alone: it imports neither JAX nor the JAX package (its
package, ``chip_smoke.py`` and the ``examples/port_*.py`` drivers), and its
entry points run on CUDA unless the caller asks for the CPU."""
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
        "import repro_torch.models, repro_torch.models.moe, repro_torch.models.ssm, repro_torch.configs\n"
        "import repro_torch.serve\n"
        "import repro_torch.configs.granite_3_2b, repro_torch.configs.shapes\n"
        "import repro_torch.launch.steps, repro_torch.launch.train, repro_torch.checkpoint.npz\n"
        "import repro_torch.launch.mesh, repro_torch.launch.sharding, repro_torch.checkpoint.run_state\n"
        "import repro_torch.launch.specs, repro_torch.launch.dryrun, repro_torch.utils.hlo, repro_torch.utils.tree\n"
        "import repro_torch.launch.profile, repro_torch.utils.spmd\n"
        "import repro_torch.scale, repro_torch.data.plane, repro_torch.fl.baselines\n"
        "import repro_torch.paper, repro_torch.paper.common, repro_torch.paper.table3_tta\n"
        "import repro_torch.paper.table4_bias, repro_torch.paper.table5_clustered_fl\n"
        "import repro_torch.paper.fig10_algorithms, repro_torch.paper.fig12_correlation\n"
        "import repro_torch.paper.fig13_sensitivity, repro_torch.paper.fig14_resilience\n"
        "import repro_torch.paper.roofline, repro_torch.paper.run\n"
        f"sys.path.insert(0, {str(ROOT / 'examples')!r})\n"
        "import port_quickstart, port_robust_fl, port_serve_cohorts, port_train_lm_federated\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr


def test_no_source_file_imports_jax_or_repro():
    examples = sorted((ROOT / "examples").glob("port_*.py"))
    assert [f.name for f in examples] == ["port_quickstart.py", "port_robust_fl.py", "port_serve_cohorts.py",
                                          "port_train_lm_federated.py"]
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + examples
    assert len(files) > 10
    # the walk reaches every subpackage, the paper's drivers included
    paper = {f.name for f in files if f.parent == PORT / "paper"}
    assert paper == {"__init__.py", "common.py", "table3_tta.py", "table4_bias.py", "table5_clustered_fl.py",
                     "fig10_algorithms.py", "fig12_correlation.py", "fig13_sensitivity.py",
                     "fig14_resilience.py", "roofline.py", "run.py"}
    offenders = [str(f.relative_to(ROOT)) for f in files if FORBIDDEN.search(f.read_text())]
    assert offenders == []
    assert FORBIDDEN.search("from repro.core import x") and FORBIDDEN.search("import jax.numpy")
    assert not FORBIDDEN.search("from repro_torch.core import x")
    # nor the reference's drivers
    assert not any(re.search(r"^\s*(import|from)\s+benchmarks\b", f.read_text(), re.MULTILINE) for f in files)


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


def test_paper_drivers_without_device_raise_on_a_cpu_only_host():
    """``python -m repro_torch.paper.run`` runs on the card unless
    ``--device cpu`` is asked for: without it a host without CUDA raises
    (this container has none), as the engine does; ``kernels_micro`` is not
    one of the drivers and exits non-zero."""
    assert not torch.cuda.is_available()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for args, want in ((["--only", "table3_tta"], "CUDA"), (["--only", "kernels_micro"], "performance benchmark")):
        out = subprocess.run([sys.executable, "-m", "repro_torch.paper.run", *args], env=env, capture_output=True,
                             text=True, timeout=300)
        assert out.returncode != 0 and want in out.stderr, out.stderr[-2000:]
    from repro_torch.paper import table3_tta

    with pytest.raises(RuntimeError, match="CUDA"):
        table3_tta.run(2, scenarios=["reddit-like"])


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


def test_baselines_without_device_raise_on_a_cpu_only_host(monkeypatch):
    from repro_torch import random as rnd
    from repro_torch.data import make_population
    from repro_torch.fl import FLConfig, MLPTask
    from repro_torch.fl.baselines import CFL, FLHC, IFCA, FlexCFL

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pop = make_population(n_clients=8, n_groups=2, test_per_group=8, seed=0)
    task = MLPTask(dim=pop.dim, n_classes=pop.n_classes)
    init = {k: v.numpy() for k, v in task.init(rnd.key(0)).items()}
    for cls in (IFCA, FLHC, FlexCFL, CFL):
        with pytest.raises(RuntimeError, match="CUDA"):
            cls(task, pop, FLConfig(rounds=1), 2)
        assert cls(task, pop, FLConfig(rounds=1), 2, device="cpu").device.type == "cpu"
    # init_params: one dict, or IFCA's list of k; they land on the device asked for
    assert FLHC(task, pop, FLConfig(rounds=1), 2, device="cpu", init_params=init)._init()["w0"].device.type == "cpu"
    assert IFCA(task, pop, FLConfig(rounds=1), 2, device="cpu", init_params=[init, init])._init(1)["b0"].shape == (64,)


def test_later_slices_raise_not_implemented():
    from repro_torch.data import make_population
    from repro_torch.fl import AuxoConfig, AuxoEngine, FLConfig, MLPTask

    pop = make_population(n_clients=8, n_groups=2, test_per_group=8, seed=0)
    # cohort placement is ported: sharded engines build on CPU shards, with
    # and without the overlap
    for kw in (dict(cohort_shards=2), dict(cohort_shards=2, round_overlap=1)):
        eng = AuxoEngine(MLPTask(), pop, FLConfig(rounds=1, **kw), AuxoConfig(), device="cpu")
        assert eng.pipeline.bank.n_shards == 2
        assert eng.pipeline.mesh.devices == (torch.device("cpu"),) * 2
    # the engine's other single-device modes are ported
    for kw in (dict(round_overlap=1), dict(population_store=True), dict(execution="sequential"),
               dict(population_store=True, availability_mode="chunked", warm_rearrivals=True)):
        AuxoEngine(MLPTask(), pop, FLConfig(rounds=1, **kw), AuxoConfig(), device="cpu")


def test_cohort_mesh_past_the_cards_present_raises(monkeypatch):
    """A CUDA cohort mesh never shrinks and never lands on the CPU: asking
    for more cards than exist raises, on a host without CUDA any CUDA
    request raises, and S logical shards on one card are asked for
    explicitly."""
    from repro_torch.data import make_population
    from repro_torch.fl import AuxoConfig, AuxoEngine, FLConfig, MLPTask
    from repro_torch.launch.mesh import canonical_device, make_cohort_mesh

    pop = make_population(n_clients=8, n_groups=2, test_per_group=8, seed=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    # "cuda" names the current card: the engine's device and shard 0's agree
    assert canonical_device("cuda") == canonical_device(None) == torch.device("cuda", 0)
    assert canonical_device("cpu") == torch.device("cpu")
    for ask in (lambda: make_cohort_mesh(2),
                lambda: make_cohort_mesh(2, device="cuda"),
                lambda: make_cohort_mesh(2, devices=["cuda:0", "cuda:1"])):
        with pytest.raises(ValueError, match="CUDA device"):
            ask()
    one_card = make_cohort_mesh(4, devices=["cuda:0"] * 4)
    assert one_card.devices == (torch.device("cuda", 0),) * 4
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for ask in (lambda: make_cohort_mesh(2), lambda: make_cohort_mesh(2, devices=["cuda:0"] * 2)):
        with pytest.raises(RuntimeError, match="CUDA"):
            ask()
    # devices= without cohort_shards, or disagreeing with device=, raises
    with pytest.raises(ValueError, match="cohort_shards"):
        AuxoEngine(MLPTask(), pop, FLConfig(rounds=1), AuxoConfig(), devices=["cpu"])
    with pytest.raises(ValueError, match="shard 0"):
        AuxoEngine(MLPTask(), pop, FLConfig(rounds=1, cohort_shards=2), AuxoConfig(),
                   device="cpu", devices=["cpu:0", "cpu"])


def test_later_model_families_and_sliding_window_decode_raise():
    from repro_torch import random as rnd
    from repro_torch.configs import all_configs, reduce_config
    from repro_torch.models import build_model
    from repro_torch.models import transformer
    from repro_torch.serve import CohortDecoder

    families, ported = set(), set()
    for cfg in all_configs().values():
        small = reduce_config(cfg)
        if cfg.family == "dense":
            continue
        families.add(cfg.family)
        # every family inits (the full config on meta), the SSM and hybrid
        # ones too since models/ssm.py was ported
        params = build_model(small).init(rnd.key(0), device="cpu")
        assert params["embed"].device.type == "cpu" and build_model(cfg).param_count() > 0
        assert sorted(params["backbone"]) == sorted(transformer.block_stacks(small))
        ported.add(cfg.family)
        # paged decode stays dense-only, as the JAX package asserts
        with pytest.raises(NotImplementedError):
            CohortDecoder(build_model(small), dict, list, device="cpu")
    assert families == {"moe", "ssm", "hybrid", "vlm", "audio"}
    assert ported == {"moe", "vlm", "audio", "ssm", "hybrid"}
    # a family the zoo does not know raises, as the JAX package's does
    with pytest.raises(ValueError, match="unknown family"):
        transformer.block_stacks(small.replace(family="rnn"))
    # a dense config with a sliding window (h2o-danube-3-4b) inits, but paged
    # decode refuses it, as the JAX package does
    danube = reduce_config(all_configs()["h2o_danube_3_4b"])
    assert danube.family == "dense" and danube.sliding_window
    with pytest.raises(NotImplementedError, match="full-attention"):
        CohortDecoder(build_model(danube), dict, list, device="cpu")


def test_decode_entry_points_without_device_raise_on_a_cpu_only_host(monkeypatch):
    from repro_torch import random as rnd
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models import build_model
    from repro_torch.serve import CohortDecoder, PagedKVCache

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build_model(reduce_config(get_config("granite-3-2b")))
    for make in (lambda **kw: CohortDecoder(model, dict, list, **kw),
                 lambda **kw: PagedKVCache(2, 2, 2, 16, **kw),
                 lambda **kw: model.init(rnd.key(0), **kw),
                 lambda **kw: model.init_bank(rnd.key(0), 2, **kw)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
        make(device="cpu")
