"""Checkpoints of the port: flat-keyed ``.npz`` param trees, readable by
numpy and interchangeable with the JAX package's ``save_pytree`` files.
The population-store, data-plane and whole-run checkpoints are a later
port slice."""
from repro_torch.checkpoint.npz import load_pytree, save_pytree

__all__ = ["load_pytree", "save_pytree"]
