"""``remat_policy="outputs"`` in the port (``ModelConfig.checkpoint``,
``common.saved_output``, ``transformer.backbone_apply``) against "full"
and against the JAX package's ``jax.checkpoint`` with
``save_only_these_names("attn_out", "mlp_out", "moe_out", "ssm_out")``.

For every stack kind of ``block_stacks`` (dense, VLM, audio, MoE, llama4's
dense + MoE pairs, the hybrid and xLSTM) at the families tests' reduced
widths, in one process:

- the loss and every gradient under "outputs" are bit-equal to "full"
  (the same ops on the same inputs; only what is kept for the backward
  pass differs);
- they agree with the reference's ``jax.value_and_grad`` under "outputs"
  within the LM tests' floors (rtol 1e-4 plus 3e-4 of a leaf's largest
  |g|, or the family's measured floor: tests/test_torch_families.py,
  tests/test_torch_ssm_families.py);
- the tensors saved for the backward pass (``saved_tensors_hooks``) grow
  by one activation for each tagged output that a later sub-block of its
  layer reads: the attention output under the MLP or MoE sub-block, and
  in llama4's pair also the dense block's MLP output. A layer's last
  output is the next layer's saved input under either policy, and is not
  kept twice (nor does the reference keep it: nothing in the backward
  pass reads it). An SSM layer keeps nothing more (the reference tags
  nothing inside it).

And on the fake process group's (2, 2) mesh the dry run's step peak under
"outputs" is at least that under "full", with fewer collectives: the
backward pass no longer replays the all-reduce behind each attention
output.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import reduce_config as jreduce
from repro.models import build_model as jbuild
from repro_torch.configs import get_config as tget
from repro_torch.configs import reduce_config as treduce
from repro_torch.convert import params_from_numpy
from repro_torch.launch import dryrun, steps
from repro_torch.launch import mesh as lmesh
from repro_torch.launch.specs import SDS
from repro_torch.models import build_model as tbuild
from repro_torch.utils import hlo
from repro_torch.utils.tree import leaves_with_path, tree_map

FWD = dict(rtol=2e-5, atol=2e-5)
# stack kind: (arch, overrides of the reduced config, tokens per sequence,
# the gradient floor of the arch's own test, as a share of a leaf's scale)
STACKS = {
    "dense": ("granite_3_2b", {}, 16, 3e-4),
    "vlm": ("qwen2_vl_2b", {}, 16, 2e-3),
    "audio": ("musicgen_large", {}, 16, 4e-3),
    "moe": ("qwen3_moe_235b_a22b", {}, 16, 3e-4),
    "llama4": ("llama4_maverick_400b_a17b", {}, 16, 3e-4),
    "hybrid": ("zamba2_7b", {"n_layers": 5, "attn_every": 2}, 32, 4.2e-3),
    "xlstm": ("xlstm_1_3b", {}, 32, 3e-4),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tensors here are small, and several test
    workers share the cores (more threads only contend)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _models(kind, policy):
    arch, over, _, _ = STACKS[kind]
    kw = dict(over, attn_qchunk=8, ce_chunk=8, remat_policy=policy)
    return jbuild(jreduce(jget(arch)).replace(**kw)), tbuild(treduce(tget(arch)).replace(**kw))


def _batch(kind, cfg):
    """Tokens (and a VLM's image patches) from numpy seeds."""
    S = STACKS[kind][2]
    rng = np.random.default_rng(11)
    if cfg.n_codebooks:
        tok = rng.integers(0, cfg.vocab, size=(2, cfg.n_codebooks, S)).astype(np.int32)
    else:
        tok = rng.integers(0, cfg.vocab, size=(2, S - cfg.vision_patches)).astype(np.int32)
    out = {"tokens": tok}
    if cfg.family == "vlm":
        out["image_embeds"] = rng.standard_normal((2, cfg.vision_patches, cfg.d_model)).astype(np.float32)
    return out


def _saved_count(model, params, batch) -> int:
    """Tensors the loss's forward pass saves for its backward pass (a
    checkpoint saves its tensor inputs; what it recomputes is not saved)."""
    n = [0]

    def pack(t):
        n[0] += 1
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        model.loss(params, batch)
    return n[0]


def _kept_activations(cfg) -> int:
    """One per tagged output that a later sub-block of its layer reads."""
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every  # the shared block's attention output, per application
    if cfg.family == "ssm":
        return 0
    if cfg.family == "moe" and cfg.moe_interleave > 1:
        return 3 * (cfg.n_layers // 2)  # attn, mlp, attn of each (dense, MoE) pair
    return cfg.n_layers  # the attention output under the MLP / MoE


@pytest.mark.parametrize("kind", sorted(STACKS))
def test_outputs_policy_grads_equal_full_and_the_reference(kind):
    jm, tm = _models(kind, "outputs")
    _, tfull = _models(kind, "full")
    assert tm.cfg.checkpoint() is not tfull.cfg.checkpoint()
    jp = jax.jit(jm.init)(jax.random.key(3))
    tp = params_from_numpy(_np(jp), "cpu")
    nb = _batch(kind, tm.cfg)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}

    (tloss, tmet), tg = steps.loss_and_grads(tm, tp, tb)
    (floss, fmet), fg = steps.loss_and_grads(tfull, tp, tb)
    assert float(tloss) == float(floss)
    for k in tmet:
        assert float(tmet[k]) == float(fmet[k]), k
    full = dict(leaves_with_path(fg))
    for k, g in leaves_with_path(tg):
        assert torch.equal(g, full[k]), k

    (jloss, jmet), jg = jax.jit(jax.value_and_grad(lambda p: jm.loss(p, jb), has_aux=True))(jp)
    np.testing.assert_allclose(float(tloss), float(jloss), **FWD)
    floor = STACKS[kind][3]
    want = dict(leaves_with_path(_np(jg)))
    assert [k for k, _ in leaves_with_path(tg)] == sorted(want)
    for k, g in leaves_with_path(tg):
        s = float(np.abs(want[k]).max())
        np.testing.assert_allclose(g.numpy(), want[k], rtol=1e-4, atol=floor * s, err_msg=k)

    extra = _saved_count(tm, tp, tb) - _saved_count(tfull, tp, tb)
    assert extra == _kept_activations(tm.cfg)


def test_unknown_policy_raises():
    cfg = treduce(tget("granite_3_2b")).replace(remat_policy="offload")
    with pytest.raises(ValueError, match="remat_policy"):
        cfg.checkpoint()


@pytest.fixture
def mesh22():
    import torch.distributed as dist

    lmesh.init_fake_world(4)
    yield lmesh.make_mesh((2, 2), ("data", "model"), dryrun.fake_device())
    dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["granite_3_2b", "qwen3_moe_235b_a22b"])
def test_dry_run_plans_the_policy_it_is_given(mesh22, arch):
    """tests/test_torch_dryrun.py's mini train step under tp on (2, 2):
    "outputs" plans a step peak at least "full"'s (at these widths both
    peaks are the sketch's, not the layers'), replays fewer all-reduces and
    runs each output projection once."""
    cfg = reduce_config_mini(arch)
    batch, sc = {"tokens": SDS((4, 2, 32), torch.int32)}, steps.StepConfig(d_sketch=32)
    plans = {p: dryrun.plan_step(cfg.replace(remat_policy=p), "train", batch, mesh22, "tp", sc)
             for p in ("full", "outputs")}
    full, outs = plans["full"], plans["outputs"]
    assert outs["step_peak_bytes"] >= full["step_peak_bytes"]
    assert all(o < f for o, f in zip(outs["probes"]["n_collectives"], full["probes"]["n_collectives"]))
    assert outs["roofline"]["coll_by_op"]["all-reduce"] < full["roofline"]["coll_by_op"]["all-reduce"]
    assert outs["flops_probe"] < full["flops_probe"]  # the output projections run once
    assert hlo.HBM_BYTES > outs["plan_bytes"] >= full["plan_bytes"]


@pytest.mark.parametrize("kind", ["dense", "moe", "llama4", "hybrid", "xlstm"])
def test_step_counter_holds_the_kept_activations(kind):
    """``hlo.StepCounter`` (the dry run's count of live bytes) sees what
    the forward pass keeps for the backward pass: after the loss's forward
    pass, "outputs" holds one more (B, S, D) activation for each kept
    output (``_kept_activations``) than "full"."""
    live = {}
    for policy in ("full", "outputs"):
        _, tm = _models(kind, policy)
        tp = tree_map(lambda a: a.requires_grad_(), tm.init(torch.zeros(2, dtype=torch.uint32), device="cpu"))
        tb = {k: torch.from_numpy(v) for k, v in _batch(kind, tm.cfg).items()}
        keep, counter = [], hlo.StepCounter()
        hlo.count_step(lambda: keep.append(tm.loss(tp, tb)[0]), [a for _, a in leaves_with_path(tp)], counter)
        live[policy] = counter.live
    S, D = STACKS[kind][2], tm.cfg.d_model
    act = -(-2 * S * D * 4 // hlo.ALLOC_ROUND) * hlo.ALLOC_ROUND
    assert live["outputs"] - live["full"] == _kept_activations(tm.cfg) * act


def reduce_config_mini(arch):
    """tests/test_torch_dryrun.py's mini configs."""
    return treduce(tget(arch)).replace(dtype=torch.bfloat16, d_model=256, n_heads=8, n_kv_heads=4,
                                       attn_qchunk=16, ce_chunk=32)
