"""Carry weights and clustering state across from numpy.

Both packages can start from the same state: the caller exports the JAX
package's arrays with ``np.asarray`` and hands them here. Only numpy goes
in; nothing of JAX is imported.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.clustering import ClusterState


def params_from_numpy(tree: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A (possibly nested) dict of arrays -> the same dict of tensors on
    ``device``: task params, opt states and bank stacks alike. Floating
    arrays keep their dtype; copies never alias the numpy buffers."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = params_from_numpy(v, device)
        else:
            out[k] = torch.from_numpy(np.array(v)).to(device)
    return out


def cluster_state_from_numpy(device=None, **fields: np.ndarray) -> ClusterState:
    """A ClusterState (stacked or not) from its fields as numpy arrays:
    centroids, counts, round_counts, dispersion, margin,
    cluster_dispersion, initialized, round."""
    dtypes = {"initialized": torch.bool, "round": torch.int32}
    device = resolve_device(device)
    return ClusterState(**{
        name: torch.from_numpy(np.array(arr)).to(device=device, dtype=dtypes.get(name, torch.float32))
        for name, arr in fields.items()
    })
