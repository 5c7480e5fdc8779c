"""Step analysis for the dry run: collective bytes, the three-term roofline
(H100 SXM), and the counts of one step run on fake tensors (port of
``repro.utils.hlo``).

The JAX package reads FLOPs and bytes from XLA's cost analysis of a
compiled step and its collectives from the optimized HLO text. The port
has no compiled program: a step runs eagerly, and ``count_step`` runs it
under ``FakeTensorMode`` (no storage, no arithmetic) and counts what its
aten ops would do on the card:

  flops        ``torch.utils.flop_counter.FlopCounterMode`` (matmuls,
               convolutions and attention; elementwise ops count none)
  bytes        every non-view op's tensor inputs read once and outputs
               written once
  peak bytes   the live storage bytes at their highest, each storage
               rounded up to 512 bytes as the CUDA caching allocator
               rounds a block; tensors that exist before the step are
               registered as external and count from the start

  compute    = flops / peak FLOP/s of the dtype
  memory     = bytes / HBM_BW
  collective = Σ bytes(op) · mult(op) / LINK_BW      (per card)

mult: all-reduce counts twice (reduce and broadcast phases of a ring);
all-gather / reduce-scatter / all-to-all / collective-permute once.
``collective_bytes`` takes recorded collectives ``(op, shape, dtype)``
instead of HLO text. The port has no SPMD execution yet, so the dry run
records none: its collective term is ``None`` with a reason, never 0.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import weakref
from typing import Callable, Dict, Iterable, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.weak import WeakIdKeyDictionary

# NVIDIA H100 SXM5 80GB (data sheet), per card
PEAK_FLOPS = 989e12  # bf16 tensor cores, dense
PEAK_FLOPS_F32 = 67e12  # float32 outside the tensor cores
HBM_BW = 3.35e12  # bytes/s, HBM3
LINK_BW = 900e9  # bytes/s, NVLink 4 per card
HBM_BYTES = 80e9  # the card's memory
ALLOC_ROUND = 512  # the CUDA caching allocator's block rounding

_COLLECTIVES = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


def peak_flops(dtype: torch.dtype) -> float:
    """The card's peak rate for a step computed in ``dtype``."""
    return PEAK_FLOPS if dtype in (torch.bfloat16, torch.float16) else PEAK_FLOPS_F32


def _record_bytes(shape: Sequence[int], dtype: torch.dtype) -> int:
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def collective_bytes(records: Iterable[Tuple[str, Sequence[int], torch.dtype]]) -> Dict[str, float]:
    """Per-card collective bytes by op type (weighted sum in 'total_weighted')
    of recorded collectives ``(op, per-card result shape, dtype)``."""
    out = {k: 0.0 for k in _COLLECTIVES}
    for op, shape, dtype in records:
        out[op] += _record_bytes(shape, dtype)
    out["total_weighted"] = sum(out[k] * _COLLECTIVES[k] for k in _COLLECTIVES)
    return out


@dataclasses.dataclass
class Roofline:
    flops: float  # per card
    bytes_accessed: float  # per card
    coll_bytes: Optional[float]  # per card, weighted; None: not measured
    coll_by_op: Optional[Dict[str, float]]
    peak_flops: float = PEAK_FLOPS
    collectives: str = ""  # why the collective term is missing, when it is

    @property
    def compute_s(self) -> float:
        return self.flops / self.peak_flops

    @property
    def memory_s(self) -> float:
        return self.bytes_accessed / HBM_BW

    @property
    def collective_s(self) -> Optional[float]:
        return None if self.coll_bytes is None else self.coll_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        """The largest of the terms that were measured."""
        terms = {"compute": self.compute_s, "memory": self.memory_s, "collective": self.collective_s}
        return max((k for k in terms if terms[k] is not None), key=terms.get)

    def as_dict(self) -> Dict:
        out = {
            "flops_per_device": self.flops,
            "bytes_per_device": self.bytes_accessed,
            "coll_bytes_per_device": self.coll_bytes,
            "coll_by_op": self.coll_by_op,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "peak_flops": self.peak_flops,
        }
        if self.collectives:
            out["collectives"] = self.collectives
        return out


# ---------------------------------------------------------------------------
# Counting a step on fake tensors
# ---------------------------------------------------------------------------
def _tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepCounter(TorchDispatchMode):
    """Counts, for every aten op dispatched under it, the bytes it reads
    and writes (view ops and allocations move none) and the live storage
    bytes (each storage rounded to ALLOC_ROUND), keeping their peak."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self.bytes_accessed = 0
        self._storages = WeakIdKeyDictionary()

    def _free(self, n: int, _ref) -> None:
        self.live -= n

    def track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st in self._storages:
            return
        n = -(-st.nbytes() // ALLOC_ROUND) * ALLOC_ROUND
        self._storages[st] = weakref.ref(st, functools.partial(self._free, n))
        self.live += n
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        if not func.is_view and not func.name().startswith("aten::empty"):
            ins = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
            self.bytes_accessed += sum(_tensor_bytes(t) for t in ins + outs)
        for t in outs:
            self.track(t)
        return out


class StepCounts(NamedTuple):
    flops: float
    bytes_accessed: float
    peak_bytes: int  # the external tensors included
    external_bytes: int  # what was live before the step

    @property
    def step_peak_bytes(self) -> int:
        """What the step allocated on top of what was there before it."""
        return self.peak_bytes - self.external_bytes


def count_step(fn: Callable, external: Sequence[torch.Tensor],
               counter: Optional[StepCounter] = None) -> StepCounts:
    """Run ``fn()`` (on fake tensors) under the counters; ``external`` are
    the tensors that live before the step (state, inputs)."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = counter or StepCounter()
    for t in external:
        counter.track(t)
    before = counter.live
    with counter, FlopCounterMode(display=False) as flops:
        fn()
    return StepCounts(float(flops.get_total_flops()), float(counter.bytes_accessed), counter.peak, before)
