"""Checkpoints of the port (port of ``repro.checkpoint``): flat-keyed
``.npz`` param trees, the chunked PopulationStore, the data-plane recipe,
and whole runs (``save_run``/``load_run``, with elastic remesh). The files
are the JAX package's, key for key: either package reads the other's."""
from repro_torch.checkpoint.npz import (
    load_data_plane,
    load_population_store,
    load_pytree,
    save_data_plane,
    save_population_store,
    save_pytree,
)
from repro_torch.checkpoint.run_state import load_run, save_run

__all__ = [
    "load_data_plane",
    "load_population_store",
    "load_pytree",
    "load_run",
    "save_data_plane",
    "save_population_store",
    "save_pytree",
    "save_run",
]
