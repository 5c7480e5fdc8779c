"""The port's SPMD probe (``repro_torch.utils.spmd``, the collectives of
``repro_torch.utils.hlo``, ``repro_torch.launch.profile``) on the CPU.

- A column- then row-parallel MLP on a (2, 2) mesh records the collective
  bytes that the JAX package's ``collective_bytes`` reads from XLA's SPMD
  program of the same function on 4 forced host devices (run in a
  subprocess, as ``tests/test_dryrun_mini.py`` runs the reference), and so
  does a product whose sum over ``model`` is the only choice.
- ``top_collectives`` against the reference's rows of ``tests/test_hlo.py``'s
  SAMPLE.
- The federated train step of a reduced granite under ``tp`` on a (2, 2)
  mesh of a 4-rank ``gloo`` group (``tests/test_torch_spmd_worker.py``) equals
  the one-device step (gloo has every collective the program uses: DTensor
  runs a CPU mesh's all-to-all as an all-gather and a chunk).
- The sketch of a split leaf: the cards' partial projections sum to the
  one-device projection, and a (1, 1) mesh keeps its bits.
- The profile CLI prints the bytes by op and the top rows.
"""
import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch import random as rnd
from repro_torch.core import sketch
from repro_torch.launch import mesh as lmesh
from repro_torch.launch import profile
from repro_torch.utils import hlo, spmd

ROOT = Path(__file__).resolve().parents[1]

REF_SCRIPT = textwrap.dedent(
    """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.utils.hlo import collective_bytes

    mesh = jax.make_mesh((2, 2), ("data", "model"))
    ns = lambda *s: NamedSharding(mesh, P(*s))
    sds = lambda *s: jax.ShapeDtypeStruct(s, jnp.float32)
    B, D, F = 8, 16, 32
    mlp = jax.jit(lambda x, wu, wd: jax.nn.relu(x @ wu) @ wd,
                  in_shardings=(ns("data", None), ns(None, "model"), ns("model", None)))
    dot = jax.jit(lambda x, w: x @ w, in_shardings=(ns(None, "model"), ns("model", None)), out_shardings=ns())
    out = {"mlp": collective_bytes(mlp.lower(sds(B, D), sds(D, F), sds(F, D)).compile().as_text()),
           "dot": collective_bytes(dot.lower(sds(B, D), sds(D, F)).compile().as_text())}
    print("RESULT " + json.dumps(out))
    """
)

B, D, F = 8, 16, 32


@pytest.fixture(scope="module", autouse=True)
def _fake_world():
    import torch.distributed as dist

    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def reference_bytes():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", REF_SCRIPT], capture_output=True, text=True, timeout=600,
                          env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [l for l in proc.stdout.splitlines() if l.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def _mesh(shape):
    lmesh.init_fake_world(shape[0] * shape[1])
    return lmesh.make_mesh(shape, ("data", "model"), "cpu")


def _dt(mesh, shape, placements):
    local = list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            local[p.dim] //= mesh.size(i)
    return spmd.from_local(torch.ones(local), mesh, placements)


def _mlp_records(case):
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication

    mesh = _mesh((2, 2))
    R = Replicate()
    with hlo.CollectiveRecorder() as rec, implicit_replication():
        if case == "mlp":
            # x over data, wu split on F (column-parallel), wd split on F (row-parallel):
            # the row-parallel product's sum over model is all-reduced, as in models.common.mlp
            x, wu, wd = _dt(mesh, (B, D), [Shard(0), R]), _dt(mesh, (D, F), [R, Shard(1)]), \
                _dt(mesh, (F, D), [R, Shard(0)])
            spmd.replicate_partial(torch.relu(x @ wu) @ wd)
        else:
            # D split over model in both operands, a replicated result: one all-reduce
            x, w = _dt(mesh, (B, D), [R, Shard(1)]), _dt(mesh, (D, F), [R, Shard(0)])
            spmd.redistribute(x @ w, [R, R])
    return rec.records


@pytest.mark.parametrize("case", ["mlp", "dot"])
def test_collective_bytes_equal_the_reference(reference_bytes, case):
    """The MLP: XLA and DTensor both all-reduce the (B/2, D) result over
    model. The dot: with D split in both operands and a replicated result,
    an all-reduce of the (B, F) product is the only program either can give."""
    records = _mlp_records(case)
    got = hlo.collective_bytes(records)
    assert got == reference_bytes[case]
    assert got["total_weighted"] > 0 and [r[0] for r in records] == ["all-reduce"]


def test_top_collectives_match_the_reference():
    from test_hlo import SAMPLE
    from test_torch_dryrun import RECORDS

    from repro.utils.hlo import top_collectives as jax_top

    twice = RECORDS + [RECORDS[0]]
    sample = SAMPLE.replace("ROOT %t", "%ar2 = bf16[1024,2048]{1,0} all-reduce(%p0), replica_groups={}\n  ROOT %t")
    got = [row[:4] for row in hlo.top_collectives(twice, 15)]
    want = [row[:4] for row in jax_top(sample, 15)]
    assert got == want and got[0] == (2 * 1024 * 2048 * 2, 2, 1024 * 2048 * 2, "all-reduce")
    assert hlo.top_collectives(twice, 2) == hlo.top_collectives(twice, 15)[:2]
    assert hlo.top_collectives(RECORDS, 1)[0][4] == "bf16[1024,2048]"


def test_a_shard_move_records_one_all_to_all():
    """A CPU mesh runs Shard(0) -> Shard(1) as an all-gather and a chunk;
    the recorder names what DTensor asked for."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = _mesh((2, 2))
    x = _dt(mesh, (8, 16), [Replicate(), Shard(0)])
    with hlo.CollectiveRecorder() as rec:
        x.redistribute(mesh, [Replicate(), Shard(1)])
    assert rec.records == [("all-to-all", (8, 8), torch.float32)]


def test_private_torch_hooks_resolve_and_engage():
    """The two private DTensor names the counters wrap exist on this torch
    (``hlo.private_hooks`` raises when one is gone), and under
    ``StepCounter`` a DTensor op's shape propagation runs through the hook
    and is not counted as the card's work: a (24, 40) @ (40, 56) product
    split over model counts one card's (24, 20) @ (20, 56) bytes and FLOPs."""
    import warnings

    from torch.distributed.tensor import Replicate, Shard

    with warnings.catch_warnings():
        warnings.simplefilter("error")  # this torch is one the names were checked on
        hooks = hlo.private_hooks()
    assert set(hooks) == {"shape_work", "alltoall"}
    for owner, name in hooks.values():
        assert callable(getattr(owner, name))
    mesh = _mesh((2, 2))
    x, w = _dt(mesh, (24, 40), [Replicate(), Shard(1)]), _dt(mesh, (40, 56), [Replicate(), Shard(0)])
    counter = hlo.StepCounter()
    with counter:
        x @ w
    assert counter.shape_work > 0
    assert counter.flops == 2 * 24 * 20 * 56
    assert counter.bytes_accessed == 4 * (24 * 20 + 20 * 56 + 24 * 56)
    assert getattr(*hooks["shape_work"]).__name__ == hooks["shape_work"][1]  # unwrapped on exit


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _gloo(tmp_path, arch: str, kinds: str) -> dict:
    """Run ``tests/test_torch_spmd_worker.py`` on 4 ranks of a gloo group;
    its results by kind."""
    out = tmp_path / "spmd.pt"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, str(ROOT / "tests" / "test_torch_spmd_worker.py"), str(r), "4",
                               str(port), str(out), arch, kinds], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(4)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), logs[0][-3000:]
    return torch.load(out)


def _assert_trees_close(got, want, what: str) -> None:
    from repro_torch.utils.tree import leaves_with_path

    a_leaves, b_leaves = leaves_with_path(got), leaves_with_path(want)
    assert [p for p, _ in a_leaves] == [p for p, _ in b_leaves], what
    for (path, a), (_, b) in zip(a_leaves, b_leaves):
        if a.dtype.is_floating_point:
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5, msg=f"{what}{path}")
        else:
            assert torch.equal(a, b), f"{what}{path}"


def _assert_train_equal(got, want, what: str) -> None:
    assert torch.equal(got["assign"], want["assign"]), what
    for part in ("params", "metrics"):
        _assert_trees_close(got[part], want[part], f"{what} {part}")
    assert torch.equal(got["clust"]["counts"], want["clust"]["counts"]), what
    # the centroids are unit vectors of the 4 clients' centered sketches, which
    # cancel to ~1e-2 of the sketches' scale: the deltas' float32 rounding (the
    # sharded products sum in another order) shows there at ~2e-5 of a unit
    # vector, held at 1e-4 of it
    torch.testing.assert_close(got["clust"]["centroids"], want["clust"]["centroids"], rtol=0, atol=1e-4)


@pytest.mark.parametrize("arch", ["granite_3_2b", "qwen3_moe_235b_a22b", "zamba2_7b"])
def test_gloo_four_ranks_equal_one_device(tmp_path, arch):
    """A reduced model's federated train step under tp on a (2, 2) mesh of a
    4-rank gloo group: loss, assignments, counts and params equal the
    one-device step's (rtol 1e-4, atol 1e-5). The dense family splits its
    heads and MLP, the MoE family its experts (each card slotting tokens into
    its own), the hybrid's Mamba-2 layers run whole on every card."""
    res = _gloo(tmp_path, arch, "train")["train"]
    _assert_train_equal(res["spmd"], res["one"], "train")


@pytest.mark.parametrize("arch", ["granite_3_2b", "qwen3_moe_235b_a22b", "zamba2_7b"])
def test_gloo_four_ranks_central_prefill_decode_equal_one_device(tmp_path, arch):
    """The dry run's other step kinds on the same 4-rank gloo group equal
    one device at the same tolerances: the centralized train step under
    fsdp (each card pools the clients of its batch shard, ``spmd.Rows``),
    the prefill under tp, and two decode steps under tp from a prefilled
    cache placed by ``cache_shardings`` (batch over data, hd over model: the
    new K/V written into each card's shard, partial scores all-reduced, the
    heads' outputs moved by an all-to-all), logits and the whole cache."""
    res = _gloo(tmp_path, arch, "central,prefill,decode")
    _assert_train_equal(res["central"]["spmd"], res["central"]["one"], "central")
    _assert_trees_close(res["prefill"]["spmd"], res["prefill"]["one"], "prefill")
    _assert_trees_close(res["decode"]["spmd"], res["decode"]["one"], "decode")


def test_gloo_four_ranks_central_from_per_card_init_equal_one_device(tmp_path):
    """Reduced llama4-maverick's centralized step under fsdp on the 4-rank
    gloo group, each rank's params drawn by the per-card init (its own
    blocks only, ``launch.local.init_params``) and Yogi's and the
    clustering state made at local shape: equal to one device's step from
    the whole init, at the tolerances of the steps above."""
    res = _gloo(tmp_path, "llama4_maverick_400b_a17b", "central_local")["central_local"]
    _assert_train_equal(res["spmd"], res["one"], "central_local")


def test_sketch_of_split_leaves():
    """The cards' ``shard_projection`` parts of a (4, 6, 8) leaf split on
    each dim sum to ``leaf_projection``; on a (1, 1) mesh a DTensor sketch
    is bit-equal to the plain one."""
    from torch.distributed.tensor import Replicate, Shard

    g = torch.Generator().manual_seed(0)
    leaf = torch.randn(3, 4, 6, 8, generator=g)  # (R, ...)
    shape, n, d, seed = (4, 6, 8), 192, 16, 1234 * 7919
    want = sketch.leaf_projection(leaf.reshape(3, -1), sketch.projection_blocks(n, d, seed, "cpu"))
    for dim in range(3):
        parts = []
        for k, piece in enumerate(leaf.chunk(2, dim=dim + 1)):
            offsets = [0, 0, 0]
            offsets[dim] = k * shape[dim] // 2
            index = rnd.block_index(shape, rnd.Shard(tuple(piece.shape[1:]), tuple(offsets)), "cpu")
            parts.append(sketch.shard_projection(piece.reshape(3, -1), index, n, d, seed))
        torch.testing.assert_close(parts[0] + parts[1], want, rtol=1e-5, atol=1e-6)

    mesh = _mesh((1, 1))
    sk = sketch.GradientSketcher(d_sketch=d, strategy="full_proj")
    tree = {"a": leaf, "b": torch.randn(3, 5, generator=g)}
    placed = {"a": spmd.from_local(leaf, mesh, [Shard(0), Shard(2)]), "b": spmd.from_local(tree["b"], mesh,
                                                                                          [Replicate()] * 2)}
    assert torch.equal(sk.batch(placed).full_tensor(), sk.batch(tree))


def test_profile_cli_prints_bytes_by_op_and_top_rows(capsys):
    rep = profile.main(["--arch", "granite-3-2b", "--shape", "train_4k", "--units", "1", "--mesh", "2x2",
                        "--top", "5", "--set", "d_model=128", "--set", "n_heads=4", "--set", "n_kv_heads=2",
                        "--set", "d_ff=256", "--set", "vocab=256"])
    out = capsys.readouterr().out
    assert "per-card collective bytes by op:" in out and "total_weighted" in out and "top 5 collectives" in out
    assert rep["by_op"]["total_weighted"] > 0 and 0 < len(rep["top"]) <= 5
    assert sum(r[1] for r in hlo.top_collectives(rep["records"], 10 ** 6)) == len(rep["records"])
