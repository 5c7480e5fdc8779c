"""Federated data pipeline (numpy copies of ``repro.data``): non-IID
partitions, availability and device traces, and the DataPlane protocol."""
from repro_torch.data.availability import AvailabilityTrace, DeviceSpeeds
from repro_torch.data.datasets import (
    FederatedClassification,
    PopulationStructure,
    draw_structure,
    make_population,
)
from repro_torch.data.plane import DataPlane, MaterializedDataPlane, as_plane

__all__ = [
    "AvailabilityTrace",
    "DataPlane",
    "DeviceSpeeds",
    "FederatedClassification",
    "MaterializedDataPlane",
    "PopulationStructure",
    "as_plane",
    "draw_structure",
    "make_population",
]
