"""Nothing the benchmark runs imports JAX or the JAX package (``repro``),
compared by whole top-level module names (``repro_torch`` begins with
``repro`` and is the program under test); the reference imports nothing of
the program either. Each check runs in a fresh interpreter."""
import json
import os
import subprocess
import sys

from perfbench.lib import manifest

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

PROBE = r"""
import glob, importlib.util, json, os, sys
root = sys.argv[1]
sys.path[:0] = [root, os.path.join(root, "src")]
mods = json.loads(sys.argv[2])
for m in mods:
    if m.endswith(".py"):
        spec = importlib.util.spec_from_file_location("probe_" + os.path.basename(m)[:-3].replace(".", "_"), m)
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
    else:
        importlib.import_module(m)
print(json.dumps(sorted({n.split(".")[0] for n in sys.modules})))
"""


def top_level(mods):
    out = subprocess.run([sys.executable, "-c", PROBE, manifest.ROOT, json.dumps(mods)],
                         capture_output=True, text=True, timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def bench_files(kind):
    d = os.path.join(manifest.BENCH, kind)
    return sorted(os.path.join(d, f) for f in os.listdir(d) if f.endswith(".py") and f != "__init__.py")


def test_harness_entries_and_readers_load_no_jax():
    mods = ["perfbench.run", "perfbench.control", "perfbench.lib.trace", "perfbench.lib.manifest",
            "repro_torch.launch.steps", "repro_torch.serve"]
    loaded = top_level(mods + bench_files("entries") + bench_files("metrics"))
    assert "repro_torch" in loaded  # the program itself is there
    assert not loaded & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    loaded = top_level(bench_files("reference"))
    assert not loaded & (FORBIDDEN | {"repro_torch"})


def test_whole_names_are_compared():
    from perfbench import run

    sys.modules.setdefault("repro_torch_probe_only", sys)
    try:
        assert "repro" not in run.forbidden_modules() or "repro" in {m.split(".")[0] for m in sys.modules}
        assert "repro_torch_probe_only" not in run.forbidden_modules()
    finally:
        del sys.modules["repro_torch_probe_only"]
