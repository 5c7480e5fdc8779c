"""Population plane (ARCHITECTURE.md §⑥): client count as a streaming
quantity — chunked client-state store, O(active)-per-round availability
sampling, and churn. Verbatim numpy copies of ``repro.scale`` (the host
RNG streams stay draw-for-draw the JAX package's); the fl/ engine mounts
these behind ``FLConfig.population_store`` with bit-equal small-N
semantics."""
from repro_torch.scale.availability import StreamingAvailability
from repro_torch.scale.churn import ChurnStream
from repro_torch.scale.store import (
    ChunkedAffinityTable,
    ClientField,
    DictProbeCache,
    FieldSpec,
    PopulationStore,
    StoreProbeCache,
    make_client_store,
)

__all__ = [
    "ChunkedAffinityTable",
    "ChurnStream",
    "ClientField",
    "DictProbeCache",
    "FieldSpec",
    "PopulationStore",
    "StoreProbeCache",
    "StreamingAvailability",
    "make_client_store",
]
