"""The FL engine's cohort mesh (port of ``repro.launch.mesh``'s
``make_cohort_mesh`` and ``cohort_size``).

A cohort mesh is an explicit, ordered tuple of ``torch.device``s, one per
cohort shard: shard j owns the CohortBank's slot block j and the round's
row block j (ARCHITECTURE.md §④). Several shards may name the same device:
``devices=[torch.device("cuda:0")] * S`` places S logical shards on one
card, and the pipeline then runs them as one stacked group there.

The mesh never changes what it was asked for: a CUDA request never lands
on the CPU, and a request for S cards raises when fewer are present (as
the reference raises when the host has fewer jax devices).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch import resolve_device


class CohortMesh(NamedTuple):
    devices: Tuple[torch.device, ...]  # the device of each cohort shard

    @property
    def n_shards(self) -> int:
        return len(self.devices)


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


def make_cohort_mesh(n_shards: int, *, devices: Optional[Sequence] = None,
                     device=None) -> CohortMesh:
    """A mesh of ``n_shards`` cohort shards.

    ``devices`` lists the shards' devices in order (the first ``n_shards``
    are used; fewer raise). Without it the shards take distinct devices of
    ``device``'s type: the first ``n_shards`` CUDA cards (None means CUDA),
    or the CPU for every shard when ``device`` is the CPU.
    """
    n_shards = int(n_shards)
    if n_shards < 1:
        raise ValueError(f"a cohort mesh needs at least one shard, got {n_shards}")
    if devices is not None:
        devices = list(devices)
        if len(devices) < n_shards:
            raise ValueError(
                f"cohort mesh needs {n_shards} devices, only {len(devices)} given"
            )
        return CohortMesh(tuple(canonical_device(d) for d in devices[:n_shards]))
    dev = resolve_device(device)
    if dev.type == "cpu":
        return CohortMesh((dev,) * n_shards)
    if dev.type != "cuda":
        raise ValueError(f"no cohort mesh over {dev.type} devices")
    n = torch.cuda.device_count()
    if n_shards > n:
        raise ValueError(
            f"cohort mesh needs {n_shards} CUDA devices, only {n} available; pass "
            "devices=[...] to place several shards on one card"
        )
    return CohortMesh(tuple(torch.device("cuda", i) for i in range(n_shards)))


def cohort_size(mesh) -> int:
    """Number of cohort shards (1 without a mesh)."""
    return 1 if mesh is None else mesh.n_shards
