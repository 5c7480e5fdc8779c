"""Step analysis for the dry run: collective bytes, the three-term roofline
(H100 SXM), and the counts of one step run on fake tensors (port of
``repro.utils.hlo``).

The JAX package reads FLOPs and bytes from XLA's cost analysis of a
compiled step and its collectives from the optimized HLO text. The port
has no compiled program: a step runs eagerly, and ``count_step`` runs it
under ``FakeTensorMode`` (no storage, no arithmetic) and counts what its
aten ops would do on one card:

  flops        the matmuls, convolutions and attention of
               ``torch.utils.flop_counter``'s formulas (elementwise ops
               count none)
  bytes        every non-view op's tensor inputs read once and outputs
               written once
  peak bytes   the live storage bytes at their highest, each storage
               rounded up to 512 bytes as the CUDA caching allocator
               rounds a block; tensors that exist before the step are
               registered as external and count from the start; an op
               whose CUDA kernel allocates scratch beyond its outputs
               (``_SCRATCH``: the softmax backward) adds it while it runs
  collectives  each collective the step issues, as ``(op, per-card
               result shape, dtype)`` (``CollectiveRecorder``)

A step of DTensors (the dry run's SPMD probe) is counted on the card's
local tensors: the counters let DTensor turn each op into its local ops
and collectives first, and count those (the collectives' result buffers
among the live bytes).

  compute    = flops / peak FLOP/s of the dtype
  memory     = bytes / HBM_BW
  collective = Σ bytes(op) · mult(op) / LINK_BW      (per card)

mult: all-reduce counts twice (reduce and broadcast phases of a ring);
all-gather / reduce-scatter / all-to-all / collective-permute once.
``collective_bytes`` and ``top_collectives`` take the recorded collectives
where the reference reads HLO text.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import weakref
from typing import Callable, Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

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


def top_collectives(records: Iterable[Tuple[str, Sequence[int], torch.dtype]], k: int = 15):
    """The reference's rows ``(total bytes, count, bytes each, op, shape)``
    of the k largest (op, shape, dtype) groups of recorded collectives; the
    shape as the reference's HLO text spells it (``bf16[1024,2048]``)."""
    agg: Dict = {}
    for op, shape, dtype in records:
        key = (op, tuple(int(d) for d in shape), dtype)
        agg[key] = agg.get(key, 0) + 1
    rows = [(cnt * _record_bytes(shape, dt), cnt, _record_bytes(shape, dt), op, _shape_text(shape, dt))
            for (op, shape, dt), cnt in agg.items()]
    rows.sort(reverse=True)
    return rows[:k]


_HLO_DTYPES = {torch.bfloat16: "bf16", torch.float16: "f16", torch.float32: "f32", torch.float64: "f64",
               torch.int8: "s8", torch.uint8: "u8", torch.int16: "s16", torch.int32: "s32",
               torch.int64: "s64", torch.bool: "pred"}


def _shape_text(shape: Sequence[int], dtype: torch.dtype) -> str:
    return f"{_HLO_DTYPES.get(dtype, str(dtype))}[{','.join(str(int(d)) for d in shape)}]"


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
    coll_bytes: float  # per card, weighted
    coll_by_op: Dict[str, float]
    peak_flops: float = PEAK_FLOPS

    @property
    def compute_s(self) -> float:
        return self.flops / self.peak_flops

    @property
    def memory_s(self) -> float:
        return self.bytes_accessed / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.coll_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s, "collective": self.collective_s}
        return max(terms, key=terms.get)

    def as_dict(self) -> Dict:
        return {
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


# ---------------------------------------------------------------------------
# Counting a step on fake tensors
# ---------------------------------------------------------------------------
def _tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_subclass_dispatch(types) -> bool:
    """An op on a tensor subclass (a DTensor): the counters let the subclass
    turn it into local ops first and count those."""
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor

    return any(issubclass(t, DTensor) for t in types)


def _local(t: torch.Tensor) -> torch.Tensor:
    return getattr(t, "_local_tensor", t)


# The counters wrap two private DTensor functions: the sharding propagator's
# shape work (run on fake tensors of global shapes, not the card's work) and
# the shard-to-shard move (one all-to-all, whatever a backend runs). Their
# names were checked on these torch versions (the card's machine, the CPU
# container); ``private_hooks`` fails loudly when a name is gone.
HOOKED_TORCH = ("2.11", "2.13")
_META_NAMES = ("_propagate_tensor_meta_non_cached", "_propagate_tensor_meta")
_ALLTOALL_ARGS = ("input", "gather_dim", "shard_dim", "mesh", "mesh_dim")


def private_hooks() -> Dict[str, Tuple[object, str]]:
    """``{"shape_work": (ShardingPropagator, name), "alltoall":
    (placement_types, "shard_dim_alltoall")}``: the owners and names the
    counters wrap. Raises RuntimeError, naming the torch version, when one
    is missing or the all-to-all's arguments changed; warns on a torch
    version the names were not checked on."""
    import inspect
    import warnings

    from torch.distributed.tensor import placement_types
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    version = ".".join(torch.__version__.split(".")[:2])
    if version not in HOOKED_TORCH:
        warnings.warn(f"torch {torch.__version__}: the step counters' private DTensor hooks were checked on "
                      f"torch {', '.join(HOOKED_TORCH)} only", stacklevel=2)
    meta = next((n for n in _META_NAMES if callable(getattr(ShardingPropagator, n, None))), None)
    if meta is None:
        raise RuntimeError(f"torch {torch.__version__}: ShardingPropagator has none of {_META_NAMES}; "
                           "the step counter cannot tell DTensor's shape work from the card's")
    fn = getattr(placement_types, "shard_dim_alltoall", None)
    if fn is None or tuple(inspect.signature(fn).parameters) != _ALLTOALL_ARGS:
        raise RuntimeError(f"torch {torch.__version__}: placement_types.shard_dim_alltoall{_ALLTOALL_ARGS} "
                           "is gone or changed; the collective recorder cannot name shard moves")
    return {"shape_work": (ShardingPropagator, meta), "alltoall": (placement_types, "shard_dim_alltoall")}


def _softmax_backward_scratch(grad: torch.Tensor, output: torch.Tensor, *_) -> int:
    """CUDA's softmax backward forms ``grad * output`` (laid out as
    ``grad``) and works on contiguous copies of that product and of
    ``output``: the product, and a copy of each that is not contiguous.
    Measured on the card (NVIDIA H100, torch 2.11) at (16, 8, 512, 5, 4096)
    float32, 5.37 GB a tensor, by ``tools/softmax_scratch.py``: 5.37 GB of
    scratch with both inputs contiguous, 10.74 with one not, 16.11 with
    neither."""
    n = _tensor_bytes(grad)
    return n + (0 if grad.is_contiguous() else n) + (0 if output.is_contiguous() else _tensor_bytes(output))


# scratch an op's CUDA kernel holds while it runs, beyond its outputs
_SCRATCH = {"aten::_softmax_backward_data": _softmax_backward_scratch}


class StepCounter(TorchDispatchMode):
    """Counts, for every aten op dispatched under it on the card's own
    tensors, its FLOPs, the bytes it reads and writes (view ops, allocations
    and ops that return no tensor move none) and the live storage bytes
    (each storage rounded to ALLOC_ROUND), keeping their peak."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.live = 0
        self.peak = 0
        self.flops = 0
        self.bytes_accessed = 0
        self._storages = WeakIdKeyDictionary()
        self._flop_registry = flop_registry
        self._paused = 0
        self.shape_work = 0  # DTensor shape propagations seen (and not counted)

    def __enter__(self):
        # DTensor works out an op's output shapes by running it on fake
        # tensors of the global shapes (on a cache miss): not the card's work
        owner, name = self._hook = private_hooks()["shape_work"]
        orig = self._orig_meta = getattr(owner, name)

        def meta(prop, *a, **k):
            self._paused += 1
            self.shape_work += 1
            try:
                return orig(prop, *a, **k)
            finally:
                self._paused -= 1

        setattr(owner, name, meta)
        return super().__enter__()

    def __exit__(self, *exc):
        setattr(*self._hook, self._orig_meta)
        return super().__exit__(*exc)

    def _free(self, n: int, _ref) -> None:
        self.live -= n

    def track(self, t: torch.Tensor) -> None:
        st = _local(t).untyped_storage()
        if st in self._storages:
            return
        n = -(-st.nbytes() // ALLOC_ROUND) * ALLOC_ROUND
        self._storages[st] = weakref.ref(st, functools.partial(self._free, n))
        self.live += n
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _is_subclass_dispatch(types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        if self._paused or any(t.device.type == "meta" for t in outs):
            return out  # shape work (DTensor's, or shapes on meta tensors): nothing on the card
        # an op that returns no tensor (``prim::device``, ``aten::size``: a
        # metadata query) moves no bytes; XLA's cost analysis counts none
        if outs and not func.is_view and not func.name().startswith("aten::empty"):
            ins = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
            self.bytes_accessed += sum(_tensor_bytes(t) for t in ins + outs)
        count = self._flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        for t in outs:
            self.track(t)
        scratch = _SCRATCH.get(func.name())
        if scratch is not None:
            self.peak = max(self.peak, self.live + scratch(*args))
        return out


# the funcol and c10d ops that move data between cards, by the reference's names
_COLLECTIVE_OPS = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce", "allreduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all", "shard_dim_alltoall": "all-to-all",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional", "_c10d_functional_autograd", "c10d",
                          "_dtensor")


class CollectiveRecorder(TorchDispatchMode):
    """Records every collective dispatched under it as ``(op, per-card
    result shape, dtype)``, the op named as the reference names it. It
    records what DTensor asks for, not how a backend runs it: a shard-to-
    shard move (``shard_dim_alltoall``) is one all-to-all also where a CPU
    mesh runs it as an all-gather and a chunk."""

    def __init__(self):
        super().__init__()
        self.records: List[Tuple[str, Tuple[int, ...], torch.dtype]] = []
        self._inside = 0

    def _add(self, op: str, t) -> None:
        for x in (t if isinstance(t, (list, tuple)) else [t]):
            if isinstance(x, torch.Tensor):
                self.records.append((op, tuple(int(d) for d in x.shape), x.dtype))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _is_subclass_dispatch(types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        ns = getattr(func, "namespace", "")
        op = _COLLECTIVE_OPS.get(func._overloadpacket.__name__) if ns in _COLLECTIVE_NAMESPACES else None
        if op is not None and not self._inside:
            # a c10d op writes its result in place: its output list is its first argument
            self._add(op, out if ns != "c10d" else args[0])
        return out

    def __enter__(self):
        owner, name = self._hook = private_hooks()["alltoall"]
        orig = getattr(owner, name)

        def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
            self._inside += 1
            try:
                out = orig(input, gather_dim, shard_dim, mesh, mesh_dim)
            finally:
                self._inside -= 1
            self._add("all-to-all", out)
            return out

        self._orig_alltoall = orig
        setattr(owner, name, alltoall)
        return super().__enter__()

    def __exit__(self, *exc):
        setattr(*self._hook, self._orig_alltoall)
        return super().__exit__(*exc)


class StepCounts(NamedTuple):
    flops: float
    bytes_accessed: float
    peak_bytes: int  # the external tensors included
    external_bytes: int  # what was live before the step
    collectives: Tuple = ()  # (op, per-card result shape, dtype) records

    @property
    def step_peak_bytes(self) -> int:
        """What the step allocated on top of what was there before it."""
        return self.peak_bytes - self.external_bytes


def count_step(fn: Callable, external: Sequence[torch.Tensor],
               counter: Optional[StepCounter] = None) -> StepCounts:
    """Run ``fn()`` (on fake tensors) under the counters; ``external`` are
    the tensors that live before the step (state, inputs)."""
    counter = counter or StepCounter()
    for t in external:
        counter.track(t)
    before = counter.live
    with CollectiveRecorder() as rec, counter:
        fn()
    return StepCounts(float(counter.flops), float(counter.bytes_accessed), counter.peak, before,
                      tuple(rec.records))
