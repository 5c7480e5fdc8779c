"""Every public function of the JAX package has its counterpart in the
port, with every argument: both packages walked with ``ast``, neither
imported.

A public function is a module-level ``def`` or a public class's method
(``__init__`` included) whose name does not start with ``_``, in a module
of ``src/repro/``; its counterpart is the function of the same name in the
module of the same path under ``src/repro_torch/`` (a class's method in
the class of the same name). Each of its parameters (positional, keyword
or ``*``/``**``) must be one of the counterpart's. The exemptions below are
a fixed list, each with its reason, and each must still be a gap: a gap
that closes takes its entry out.
"""
import ast
import functools
import pathlib

import pytest

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
_PALLAS = "a Pallas kernel body's tiling or interpret switch: the CUDA kernel plans its own blocks"
_HLO = "parses XLA's HLO text, which a PyTorch step does not produce (the port counts ops instead)"
_JIT = "a jax.jit argument: the port's steps run eagerly, placed by their inputs"
# (module, function, parameter or None for the whole function): reason
EXEMPT = {
    ("kernels/cosine_sim.py", "cosine_similarity", "block_p"): _PALLAS,
    ("kernels/cosine_sim.py", "cosine_similarity", "block_d"): _PALLAS,
    ("kernels/cosine_sim.py", "cosine_similarity", "interpret"): _PALLAS,
    ("kernels/segment_aggregate.py", "segment_aggregate", "block_p"): _PALLAS,
    ("kernels/segment_aggregate.py", "segment_aggregate", "block_d"): _PALLAS,
    ("kernels/segment_aggregate.py", "segment_aggregate", "interpret"): _PALLAS,
    ("kernels/decode_attention.py", "decode_attention", "block_s"): _PALLAS,
    ("kernels/decode_attention.py", "decode_attention", "interpret"): _PALLAS,
    ("kernels/ops.py", "cosine_similarity", "block_p"): _PALLAS,
    ("kernels/ops.py", "cosine_similarity", "block_d"): _PALLAS,
    ("kernels/ops.py", "segment_aggregate", "block_p"): _PALLAS,
    ("kernels/ops.py", "segment_aggregate", "block_d"): _PALLAS,
    ("kernels/ops.py", "decode_attention", "block_s"): _PALLAS,
    ("utils/hlo.py", "analyze", None): _HLO,
    ("utils/hlo.py", "memory_summary", None): _HLO,
    ("utils/hlo.py", "top_collectives", "hlo_text"): _HLO + "; it takes recorded collectives",
    ("utils/hlo.py", "collective_bytes", "hlo_text"): _HLO + "; it takes recorded collectives",
    ("launch/steps.py", "jit_train_step", "in_shardings"): _JIT,
    ("launch/steps.py", "jit_train_step", "out_shardings"): _JIT,
    ("launch/steps.py", "jit_train_step", "donate"): _JIT,
    ("core/clustering.py", "assign_and_update_batched", "stacked"):
        "renamed state: the same (C, ...) ClusterState, which the port runs without a vmap",
    ("fl/client.py", "local_train", "noise_key"):
        "renamed noise_keys: the port's stacked rows take one threefry key each, (R, 2)",
    ("serve/decode.py", "make_row_decode_step", None):
        "renamed make_decode_step: one step for every cohort row at once, where the reference vmaps a row's",
}


def _functions(pkg: str):
    """{(module path, qualified name): FunctionDef} of a package's public
    functions and public classes' methods."""
    out = {}
    for f in sorted((SRC / pkg).rglob("*.py")):
        rel = f.relative_to(SRC / pkg).as_posix()
        for node in ast.parse(f.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and not node.name.startswith("_"):
                out[(rel, node.name)] = node
            elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
                for sub in node.body:
                    if isinstance(sub, ast.FunctionDef) and (sub.name == "__init__" or not sub.name.startswith("_")):
                        out[(rel, f"{node.name}.{sub.name}")] = sub
    return out


def _params(fn) -> list:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
    return names


@functools.lru_cache(maxsize=None)
def _gaps() -> frozenset:
    """{(module, function, parameter or None)} where the port lacks what
    the reference has."""
    ref, port = _functions("repro"), _functions("repro_torch")
    gaps = set()
    for (rel, name), fn in ref.items():
        if (rel, name) not in port:
            gaps.add((rel, name, None))
            continue
        have = set(_params(port[(rel, name)]))
        gaps.update((rel, name, p) for p in _params(fn) if p not in have)
    return frozenset(gaps)


def test_the_walk_sees_both_packages():
    ref, port = _functions("repro"), _functions("repro_torch")
    assert len(ref) > 300 and len(port) > 300
    for key in [("launch/sharding.py", "bank_spec"), ("fl/pipeline.py", "CohortBank.__init__"),
                ("models/common.py", "ModelConfig.checkpoint"), ("serve/plane.py", "ServingPlane.__init__")]:
        assert key in ref and key in port, key


def test_every_public_function_and_argument_has_its_counterpart():
    unexplained = sorted(_gaps() - set(EXEMPT), key=str)
    assert not unexplained, f"the port lacks: {unexplained}"


@pytest.mark.parametrize("entry", sorted(EXEMPT, key=str), ids=lambda e: "::".join(str(x) for x in e))
def test_each_exemption_is_still_a_gap(entry):
    assert EXEMPT[entry]
    assert entry in _gaps(), f"{entry} now has its counterpart: take it off the list"
