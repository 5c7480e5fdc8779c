"""Meshes of the fake process group made again in a new world (a dry run,
a profile, then another plan in one process): DTensor's ops on the new mesh
run on its own process groups, never on a destroyed world's, in the forward
and in the backward (which the autograd engine runs on a thread of its own
for CUDA tensors).

No JAX here: the file also runs on the machine with the card
(``PYTHONPATH=src python -m pytest -q tests/test_torch_mesh.py``), whose
torch differs from this one in how it names process groups.
"""
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.launch import mesh as lmesh


def _ops(mesh, device):
    """A product and a sum whose shardings DTensor caches, reduced over
    both mesh dims, a sum on the ``model`` sub-mesh, and the product's
    backward through a split operand."""
    x = DTensor.from_local(torch.ones(4, 4, device=device), mesh, [Shard(0), Replicate()])
    y = (x @ x.t()).sum()
    assert y.device_mesh is mesh  # not an equal mesh of an earlier world
    assert y.full_tensor().shape == ()
    sub = mesh["model"]
    z = DTensor.from_local(torch.ones(4, device=device), sub, [Shard(0)]).sum()
    assert z.device_mesh is sub
    assert z.full_tensor().shape == ()
    w = torch.ones(4, 4, device=device, requires_grad=True)
    v = DTensor.from_local(w, mesh, [Shard(0), Shard(1)])
    v.retain_grad()
    (v @ v.t()).sum().full_tensor().backward()
    assert v.grad.device_mesh is mesh  # the backward's own decisions, on its thread
    assert w.grad is not None and w.grad.shape == (4, 4)


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_equal_meshes_across_fake_worlds_run_on_their_own_groups(shape, device):
    """The same ops on an equal mesh in each of three fake worlds, each
    destroyed after its ops (as ``chip_smoke.py`` plans granite and
    qwen3-moe, then llama4-maverick, each on its own 16 x 16 world)."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if dist.is_initialized():
        dist.destroy_process_group()
    for _ in range(3):
        lmesh.init_fake_world(4)
        try:
            _ops(lmesh.make_mesh(shape, ("data", "model"), device), device)
        finally:
            dist.destroy_process_group()
