"""§⑧ production serving plane (port of ``repro.serve``).

Layers:

- `stream`    — synthetic production query stream (Poisson arrivals,
                hot/cold client-identity mix)
- `admission` — arrival accumulation into size-or-deadline batches
- `plane`     — batched routing (cached probe + match_many) and ONE batched
                inference over the gathered bank rows per admitted batch,
                always against the pipeline's round-boundary
                `serve_params` snapshot
- `kv_cache`  — paged per-cohort KV pages, freed/reallocated on partition
                with the slot discipline `spawn_children` uses
- `decode`    — incremental per-cohort decode over the paged cache through
                `kernels.ops.decode_attention` (the CUDA flash-decode
                kernel) with the plain version as oracle
"""
from repro_torch.serve.admission import AdmissionBatcher
from repro_torch.serve.decode import CohortDecoder
from repro_torch.serve.kv_cache import PagedKVCache
from repro_torch.serve.plane import ServingPlane
from repro_torch.serve.stream import QueryStream, StreamConfig

__all__ = [
    "AdmissionBatcher",
    "CohortDecoder",
    "PagedKVCache",
    "QueryStream",
    "ServingPlane",
    "StreamConfig",
]
