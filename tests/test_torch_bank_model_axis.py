"""The cohort mesh with a ``model`` axis inside each bank slot
(``launch.mesh.make_cohort_mesh(n, model=m)``, ``launch.sharding.bank_spec``
/ ``bank_shardings`` / ``row_sharding``, ``CohortBank(policy=...)``, the
re-pack's ``out_shardings``) against the JAX package.

- ``bank_spec`` equals the reference's, entry for entry, on every leaf of
  the params and FedYoGi state of ``MLPTask`` and of each zoo arch at its
  reduced widths, on the fake meshes of tests/test_cohort_sharding.py
  (cohort 8; cohort 4 x model 2) and cohort 2 x model 4, under dp, tp and
  fsdp.
- A ``tp`` bank's piece shapes equal the reference's ``addressable_shards``
  shapes (the reference bank built in a subprocess on 8 fake host
  devices, where its construction works under jax 0.9.0), and ``fsdp``
  raises ValueError in both packages (a cohort mesh has no data axis).
- After the same ``spawn_children`` sequence the port's tp bank (all
  positions CPU positions) holds params, Yogi state and ``params_of``
  bit-equal to the reference's single-device bank (its spawns on a mesh
  raise ``ShardingTypeError`` under jax 0.9.0).
- A re-pack (4 x 2) -> (2 x 2) -> (1 x 1) lands in each target bank's
  pieces, bit-equal to the reference's ``repack_stacked``.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as jget
from repro.configs import reduce_config as jreduce
from repro.fl.pipeline import CohortBank as JBank
from repro.fl.task import MLPTask as JMLP
from repro.launch import mesh as jmesh
from repro.launch import sharding as jsh
from repro.models import build_model as jbuild
from repro_torch import random as rnd
from repro_torch.configs import get_config as tget
from repro_torch.configs import reduce_config as treduce
from repro_torch.convert import params_from_numpy
from repro_torch.fl.pipeline import CohortBank
from repro_torch.fl.task import MLPTask
from repro_torch.launch import sharding as tsh
from repro_torch.launch.mesh import make_cohort_mesh, model_size
from repro_torch.models import build_model as tbuild
from repro_torch.utils.tree import leaves_with_path, tree_map
from test_cohort_sharding import COHORT8, COHORT_TP, FakeMesh

COHORT2_TP4 = FakeMesh({"cohort": 2, "model": 4}, ("cohort", "model"))
MESHES = {"cohort8": COHORT8, "cohort4x2": COHORT_TP, "cohort2x4": COHORT2_TP4}
CAP = 8
# parent -> children, filling the 8 slots (7 spawns)
SPAWNS = [("0", ["1", "2"]), ("1", ["3", "4"]), ("2", ["5"]), ("4", ["6", "7"])]


@pytest.fixture(scope="module")
def shapes():
    """{model name: (the reference's {keystr: shape}, the port's)} over the
    params and FedYoGi's m and v, at reduced widths."""
    out = {"mlp": ({k: a.shape for k, a in _jleaves(jax.eval_shape(JMLP(dim=12, n_classes=5).init,
                                                                     jax.random.key(0)))},
                   {k: tuple(a.shape) for k, a in leaves_with_path(MLPTask(dim=12, n_classes=5).init(
                       rnd.key(0, device="cpu")))})}
    for arch in ARCH_IDS:
        jp = jbuild(jreduce(jget(arch))).init_shapes()
        tp = tbuild(treduce(tget(arch))).init_shapes()
        out[arch] = ({k: a.shape for k, a in _jleaves(jp)},
                     {k: tuple(a.shape) for k, a in leaves_with_path(tp)})
    return {name: tuple({f"['{o}']{k}" if o else k: s for o in ("", "m", "v") for k, s in side.items()}
                        for side in pair) for name, pair in out.items()}


def _jleaves(tree):
    return [(jax.tree_util.keystr(p), a) for p, a in jax.tree_util.tree_leaves_with_path(tree)]


@pytest.mark.parametrize("policy", ["dp", "tp", "fsdp"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_bank_spec_matches_the_reference(shapes, mesh, policy):
    fake = MESHES[mesh]
    n = 0
    for name, (jshapes, tshapes) in shapes.items():
        assert sorted(jshapes) == sorted(tshapes), name
        for k, shape in tshapes.items():
            assert tuple(jshapes[k]) == shape, (name, k)
            full = (CAP,) + shape
            want = tuple(jsh.bank_spec(k, full, fake, policy))
            assert tsh.bank_spec(k, full, fake, policy) == want, (name, k)
            n += "model" in want
    assert (n > 0) == (policy != "dp" and "model" in fake.axis_names)
    # the port's own mesh reads the same axes
    port = make_cohort_mesh(fake.shape["cohort"], model=fake.shape.get("model", 1), device="cpu")
    assert port.axis_names == fake.axis_names and port.shape == fake.shape


def test_row_sharding_matches_the_reference():
    assert tsh.row_sharding(make_cohort_mesh(4, model=2, device="cpu")).spec == tuple(
        jsh.row_sharding(jmesh.make_cohort_mesh(1)).spec)


# ------------------------------------------------- the reference on 8 fake devices
_REFERENCE = textwrap.dedent(
    """
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    from repro.configs import get_config, reduce_config
    from repro.fl.algorithms import make_server_opt
    from repro.fl.pipeline import CohortBank
    from repro.launch.mesh import make_cohort_mesh
    from repro.models import build_model

    p = build_model(reduce_config(get_config("granite_3_2b"))).init(jax.random.key(0))
    opt = make_server_opt("fedyogi").init(p)
    out = {}
    for n, m in ((4, 2), (2, 4)):
        mesh = make_cohort_mesh(n, model=m)
        bank = CohortBank(p, opt, 8, mesh=mesh, policy="tp")
        shapes = {}
        for tree, pre in ((bank.params, ""), (bank.opt_state, "")):
            for path, a in jax.tree_util.tree_leaves_with_path(tree):
                shapes[jax.tree_util.keystr(path)] = sorted(list(s.data.shape) for s in a.addressable_shards)
        try:
            CohortBank(p, opt, 8, mesh=mesh, policy="fsdp")
            fsdp = "built"
        except ValueError as e:
            fsdp = "ValueError: " + str(e)
        out[f"{n}x{m}"] = {"shapes": shapes, "fsdp": fsdp}
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)
    """
)


@pytest.fixture(scope="module")
def reference_banks(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref") / "banks.json"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _REFERENCE, str(path)], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, f"stdout:\n{out.stdout}\nstderr:\n{out.stderr}"
    return json.loads(path.read_text())


@pytest.fixture(scope="module")
def granite():
    """Reduced granite params (the reference's init) and a FedYoGi state
    of random m and v, as numpy, JAX and port trees."""
    p = jax.tree.map(np.asarray, jbuild(jreduce(jget("granite_3_2b"))).init(jax.random.key(0)))
    rng = np.random.default_rng(4)
    opt = {"m": jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), p),
           "v": jax.tree.map(lambda a: rng.random(a.shape).astype(np.float32), p)}
    return p, opt


def _port_bank(granite, n, m, policy="tp"):
    p, opt = granite
    return CohortBank(params_from_numpy(p, "cpu"), params_from_numpy(opt, "cpu"), CAP,
                      mesh=make_cohort_mesh(n, model=m, device="cpu"), policy=policy)


@pytest.mark.parametrize("n,m", [(4, 2), (2, 4)])
def test_tp_pieces_match_the_reference_shards(reference_banks, granite, n, m):
    ref = reference_banks[f"{n}x{m}"]
    bank = _port_bank(granite, n, m)
    assert bank.sharded and model_size(bank.mesh) == m and len(bank.groups) == 1
    got = {}
    for tree in (bank.placed_params, bank.placed_opt):
        for k, a in leaves_with_path(tree):
            got[k] = sorted(list(s) for s in a.shard_shapes())
            assert all(len(grp) == m for grp in a.parts)  # one piece a model position
    assert got == ref["shapes"]
    split = [k for k, a in leaves_with_path(bank.placed_params) if a.sharding.split_dim is not None]
    assert "['embed']" in split and "['backbone']['blocks']['attn']['wq']" in split
    # fsdp names the data axis, which a cohort mesh lacks
    assert ref["fsdp"].startswith("ValueError") and "data" in ref["fsdp"]
    with pytest.raises(ValueError, match="data"):
        _port_bank(granite, n, m, "fsdp")


def test_fsdp_on_a_cohort_only_mesh_builds_as_in_the_reference(granite):
    """Without a model axis every policy places a slot whole (the
    reference's ``bank_spec`` reads the model axis first)."""
    for policy in ("tp", "fsdp"):
        bank = _port_bank(granite, 4, 1, policy)
        assert not bank.sharded and bank.group_params is not None


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _equal_trees(got, want, what):
    want = dict(_jleaves(want))
    for k, a in leaves_with_path(got):
        np.testing.assert_array_equal(_np(a), np.asarray(want[k]), err_msg=what + k)


@pytest.mark.parametrize("n,m,policy", [(4, 2, "tp"), (2, 4, "tp"), (4, 2, "dp")])
def test_spawns_bit_equal_to_the_reference_single_device_bank(granite, n, m, policy):
    p, opt = granite
    ref = JBank(jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, opt), CAP)
    bank = _port_bank(granite, n, m, policy)
    assert bank.sharded == (policy == "tp")
    for parent, children in SPAWNS:
        assert len(ref.spawn_children(parent, children)) == len(bank.spawn_children(parent, children))
    assert bank._next == ref._next == CAP
    # the layouts differ (round-robin over shards): compare in allocation order
    slots = tsh.alloc_slots(CAP, CAP, n)
    assert sorted(slots) == list(range(CAP))
    _equal_trees(tsh.gather_allocations(bank.params, slots), ref.params, "params")
    _equal_trees(tsh.gather_allocations(bank.opt_state, slots), ref.opt_state, "opt")
    for cid in ref.slot_of:
        _equal_trees(bank.params_of(cid), ref.params_of(cid), cid)
        _equal_trees(bank.opt_state_of(cid), ref.opt_state_of(cid), cid)
    if policy == "tp":  # a position's pieces hold 1/m of each split leaf
        wq = bank.placed_params["backbone"]["blocks"]["attn"]["wq"]
        assert all(p.numel() * m == bank.params["backbone"]["blocks"]["attn"]["wq"].numel() for p in wq.parts[0])


def test_repack_lands_in_each_target_banks_pieces(granite):
    """(4 x 2) -> (2 x 2) -> (1 x 1): each re-pack's leaves are ``Placed``
    in the target bank's shardings, bit-equal to the reference's
    ``repack_stacked`` from its single-device layout, and the target bank
    takes them as they are."""
    p, opt = granite
    ref = JBank(jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, opt), CAP)
    src = _port_bank(granite, 4, 2)
    for parent, children in SPAWNS[:3]:
        ref.spawn_children(parent, children)
        src.spawn_children(parent, children)
    A = src._next
    tree, want = src.placed_params, jax.tree.map(np.asarray, ref.params)
    old, old_ref = 4, 1
    for n, m in ((2, 2), (1, 1)):
        target = _port_bank(granite, n, m)
        sh = target.shardings()[0]
        tree = tsh.repack_stacked(tree, CAP, A, old, n, out_shardings=sh)
        want = jax.tree.map(np.asarray, jsh.repack_stacked(want, CAP, A, old_ref, n))
        for (k, a), (_, s) in zip(leaves_with_path(tree), leaves_with_path(sh)):
            assert isinstance(a, tsh.Placed) and a.sharding == s and len(a.parts[0]) == m, k
        _equal_trees(tree_map(lambda a: a.whole(), tree), want, f"{n}x{m} ")
        target.params = tree
        if target.sharded:  # taken as it is: the pieces are the target's
            assert all(x is y for x, y in zip(_leaves(target.placed_params), _leaves(tree)))
        _equal_trees(target.params, want, f"{n}x{m} bank ")
        old = old_ref = n


def _leaves(tree):
    return [a for _, a in leaves_with_path(tree)]
