"""Mesh construction (port of ``repro.launch.mesh``).

Two mesh families, as in the reference:

- ``make_production_mesh``: the launch mesh, a ``torch.distributed``
  ``DeviceMesh`` of (data=16, model=16), or (pod=2, data=16, model=16) for
  two pods, built on the initialized process group. On this port's target
  (H100 cards) no run has had 256 cards: the dry run builds it on the
  fake process group (``init_fake_world``), where nothing is allocated.
  ``data_axes``, ``data_size`` and ``model_size`` read any mesh-like object
  with axis names and sizes: a ``DeviceMesh`` or a record with
  ``axis_names`` and a ``shape`` dict.
- ``make_cohort_mesh``: the FL engine's cohort mesh, below.

A cohort mesh is an explicit, ordered tuple of ``torch.device``s, one per
mesh position: ``n_shards`` cohort shards of ``model`` positions each
(``model`` 1 unless asked for), shard j owning positions ``j*model`` to
``j*model + model - 1`` as in the reference. Shard j owns the CohortBank's
slot block j and the round's row block j (ARCHITECTURE.md §④); a ``tp``
bank splits each slot's leaves over the shard's model positions
(``launch/sharding.bank_spec``). Several positions may name the same
device: ``devices=[torch.device("cuda:0")] * S`` places S logical shards
on one card, and the pipeline then runs them as one stacked group there.

The mesh never changes what it was asked for: a CUDA request never lands
on the CPU, and a request for S cards raises when fewer are present (as
the reference raises when the host has fewer jax devices).
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch import resolve_device


class CohortMesh(NamedTuple):
    devices: Tuple[torch.device, ...]  # the device of each mesh position, shard-major
    model: int = 1  # model positions per cohort shard

    @property
    def n_shards(self) -> int:
        return len(self.devices) // self.model

    def shard_devices(self, j: int) -> Tuple[torch.device, ...]:
        """The devices of shard j's model positions, in order."""
        return self.devices[j * self.model:(j + 1) * self.model]

    # the reference's mesh axes, read by ``model_size`` and ``bank_spec``
    @property
    def axis_names(self) -> Tuple[str, ...]:
        return ("cohort", "model") if self.model > 1 else ("cohort",)

    @property
    def shape(self) -> Dict[str, int]:
        sizes = {"cohort": self.n_shards, "model": self.model}
        return {a: sizes[a] for a in self.axis_names}


def canonical_device(dev) -> torch.device:
    """``dev`` resolved (None means the card), a CUDA device with its index
    made explicit; raises for a card that is not there."""
    dev = resolve_device(dev)
    if dev.type == "cuda":
        n = torch.cuda.device_count()
        idx = torch.cuda.current_device() if dev.index is None else dev.index
        if idx >= n:
            raise ValueError(f"cohort mesh asks for {dev}, only {n} CUDA device(s) available")
        dev = torch.device("cuda", idx)
    return dev


def make_cohort_mesh(n_shards: int, *, model: int = 1, devices: Optional[Sequence] = None,
                     device=None) -> CohortMesh:
    """A mesh of ``n_shards`` cohort shards of ``model`` positions each.

    ``devices`` lists the positions' devices in order (the first
    ``n_shards * model`` are used; fewer raise). Without it the positions
    take distinct devices of ``device``'s type: the first ``n_shards *
    model`` CUDA cards (None means CUDA), or the CPU for every position
    when ``device`` is the CPU.
    """
    n_shards, model = int(n_shards), int(model)
    if n_shards < 1 or model < 1:
        raise ValueError(f"a cohort mesh needs at least one shard and one model position, got "
                         f"{n_shards} x {model}")
    need = n_shards * model
    if devices is not None:
        devices = list(devices)
        if len(devices) < need:
            raise ValueError(
                f"cohort mesh needs {need} devices ({n_shards} cohort x {model} model), only "
                f"{len(devices)} given"
            )
        return CohortMesh(tuple(canonical_device(d) for d in devices[:need]), model)
    dev = resolve_device(device)
    if dev.type == "cpu":
        return CohortMesh((dev,) * need, model)
    if dev.type != "cuda":
        raise ValueError(f"no cohort mesh over {dev.type} devices")
    n = torch.cuda.device_count()
    if need > n:
        raise ValueError(
            f"cohort mesh needs {need} CUDA devices ({n_shards} cohort x {model} model), only {n} "
            "available; pass devices=[...] to place several positions on one card"
        )
    return CohortMesh(tuple(torch.device("cuda", i) for i in range(need)), model)


def cohort_size(mesh) -> int:
    """Number of cohort shards (1 without a mesh)."""
    return 1 if mesh is None else mesh.n_shards


# ---------------------------------------------------------------------------
# The production (launch) mesh
# ---------------------------------------------------------------------------
def init_fake_world(world_size: int) -> None:
    """Initialize the fake process group of ``world_size`` ranks (this
    process is rank 0; no collective moves data), the process group a dry
    run plans on. A fake group of another size is replaced; any other
    initialized group raises."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a real process group is initialized; the dry run needs the fake one")
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` on the initialized
    process group, whose world size must be the mesh's size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    n = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(f"a {shape} mesh needs an initialized process group of {n} ranks "
                           "(init_fake_world for a dry run)")
    if dist.get_world_size() != n:
        raise ValueError(f"a {shape} mesh needs {n} ranks, the process group has "
                         f"{dist.get_world_size()}")
    forget_shardings()
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def forget_shardings() -> None:
    """Drop DTensor's cached sharding decisions and redistribution plans.
    They are keyed by mesh value (ranks, shape, dim names), not by process
    group, so a mesh equal to one of a destroyed world would reuse that
    mesh's decisions: ops on the new mesh would run on the old one's groups
    (on torch 2.11, whose group names are not reused, "Could not resolve
    the process group"). The decisions are cached per thread: this
    thread's are dropped here, and each card's autograd thread, where the
    backward of CUDA tensors runs, drops its own in the backward of a
    one-value graph on that card."""
    from torch.distributed.tensor import _redistribute

    _redistribute._gen_transform_infos.cache_clear()
    _forget_on_this_thread()
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            x = torch.zeros((), device=torch.device("cuda", i), requires_grad=True)
            _ForgetInBackward.apply(x).backward()


def _forget_on_this_thread() -> None:
    from torch.distributed.tensor import DTensor

    DTensor._op_dispatcher.sharding_propagator.propagate_op_sharding.cache_clear()
    # the C++ dispatch's own cache of the same decisions
    native = getattr(torch._C, "_clear_DTensor_sharding_propagator_cache", None)
    if native is not None:
        native()


class _ForgetInBackward(torch.autograd.Function):
    """The identity, whose backward drops the sharding decisions cached on
    the thread it runs on (for a CUDA tensor, its card's autograd thread)."""

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, grad):
        _forget_on_this_thread()
        return grad

def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


class MeshAxes(NamedTuple):
    """A mesh's axis names and sizes, without devices or a process group:
    all that the specs of ``launch.sharding`` read."""
    axis_names: Tuple[str, ...]
    shape: Dict[str, int]


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of a record with
    ``axis_names`` and a ``shape`` dict."""
    names = getattr(mesh, "axis_names", None) or mesh.mesh_dim_names
    shape = mesh.shape
    if isinstance(shape, dict):
        return {a: int(shape[a]) for a in names}
    return dict(zip(names, (int(n) for n in shape)))


def data_axes(mesh) -> tuple:
    """The axes the batch/client dimension shards over."""
    return ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)


def data_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in data_axes(mesh) if a in sizes)


def model_size(mesh) -> int:
    return axis_sizes(mesh).get("model", 1)
