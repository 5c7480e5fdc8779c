"""SPMD seams: the explicit rules the models and steps need to run as one
program over a ``DeviceMesh`` of DTensors.

The port's SPMD execution (the dry run's probe on the fake process group,
a run over several cards) hands the steps DTensors: their state placed by
``launch.sharding``, their batch split over the data axes. DTensor's
sharding propagation turns most ops into local ops and the collectives
between them. Where it cannot, or would pick a program no partitioner
needs, the models call one of these helpers. Every helper is the identity
on plain tensors, so a one-device run keeps its bits.

- ``dot``: a contraction partitioned as GSPMD partitions one (each card on
  its slices, a pending sum where a contracted dim is split).
- ``local``: a function run on the local shards, its outputs wrapped with
  the placements the caller states (a kernel's shape rule, a per-head
  attention core, a column-local sum over rows), gradients summed where a
  replicated input meets outputs that differ across cards.
- ``replicate_partial``, ``keep_shards``, ``weight``: a pending sum
  all-reduced; a tensor kept split only on given dims; a weight's data-axis
  (``fsdp``) shards gathered before use. ``place``: a card's shard of a
  tensor every card holds whole.
- ``align_heads``, ``vocab_lookup``, ``logsumexp_and_pick``: GQA heads, a
  vocab-split embedding's lookup and cross-entropy, each card on its
  shard.
- ``whole_layer``, ``replicated``: a layer with no split over ``model``
  (the SSM blocks) run whole on each card's rows; small state (the
  clustering) run whole on every card.
- ``Rows``: the data axes' split of a step's clients or batch groups. Each
  card loops over its own rows with the model split over ``model`` (the
  port's form of the reference's ``vmap`` over a data-split client axis),
  and the rows come back as one DTensor split over the data axes.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence

import torch

from repro_torch import random as rnd


def _dtensor():
    from torch.distributed.tensor import DTensor

    return DTensor


def is_dtensor(x) -> bool:
    return torch.distributed.is_available() and isinstance(x, _dtensor())


def any_dtensor(*xs) -> bool:
    return any(is_dtensor(x) for x in xs)


def _replicate():
    from torch.distributed.tensor import Replicate

    return Replicate()


def _shard(d: int):
    from torch.distributed.tensor import Shard

    return Shard(d)


def _partial(op: str = "sum"):
    from torch.distributed.tensor import Partial

    return Partial(op)


def shard_dim(p) -> Optional[int]:
    """The tensor dim a placement shards, or None (Replicate, Partial)."""
    return p.dim if p.is_shard() else None


def replicate_partial(x):
    """``x`` with every ``Partial`` placement made ``Replicate`` (an
    all-reduce over those mesh dims); a plain tensor as it is."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [_replicate() if p.is_partial() else p for p in x.placements])


def weight(w):
    """A weight's shards over the data axes (every mesh dim but ``model``:
    ``fsdp``'s ZeRO-3 split) gathered before it is used, as FSDP and GSPMD
    gather them; its split over ``model`` stays. A plain tensor as it is."""
    if not is_dtensor(w):
        return w
    names = w.device_mesh.mesh_dim_names or ()
    pl = [p if n == "model" or w.device_mesh.size(i) == 1 else _replicate()
          for i, (n, p) in enumerate(zip(names, w.placements))]
    return redistribute(w, pl)


def keep_shards(x, dims: Sequence[int]):
    """DTensor ``x`` split only on ``dims`` (where it is split on them
    already), replicated elsewhere; a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    return redistribute(replicate_partial(x), [p if p.is_shard() and p.dim in dims else _replicate()
                                               for p in x.placements])


def pad(x, pads: Sequence[int]):
    """``F.pad(x, pads)`` (zeros); a DTensor not split on a padded dim is
    padded on each card's shard (a zero pad is linear, so a pending sum may
    stay pending)."""
    import torch.nn.functional as F

    if not is_dtensor(x):
        return F.pad(x, pads)
    padded = {x.dim() - 1 - i // 2 for i, n in enumerate(pads) if n}
    if any(p.is_shard() and p.dim in padded for p in x.placements):
        return F.pad(x, pads)
    return local(lambda t: F.pad(t, pads), (x,), list(x.placements), x.device_mesh)


def redistribute(x, placements: Sequence):
    """``x`` moved to ``placements`` (no-op when it is there)."""
    if tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(x.device_mesh, list(placements))


def global_shape(local_shape: Sequence[int], mesh, placements: Sequence) -> torch.Size:
    """The logical shape of a DTensor whose local shards have ``local_shape``
    (specs shard divisible dims only: every shard has one shape)."""
    shape = list(local_shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            shape[p.dim] *= mesh.size(i)
    return torch.Size(shape)


def from_local(t: torch.Tensor, mesh, placements: Sequence):
    """A DTensor of the local shards ``t`` (every card's of one shape),
    declared contiguous: a non-contiguous ``t`` is copied (a contiguous one
    is kept, so in-place updates reach its storage)."""
    t = t.contiguous()
    shape = global_shape(t.shape, mesh, placements)
    stride = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        stride[d] = stride[d + 1] * shape[d + 1]
    return _dtensor().from_local(t, mesh, list(placements), run_check=False, shape=shape, stride=tuple(stride))


def place(full: torch.Tensor, mesh, placements: Sequence):
    """This card's shard of ``full`` (a tensor every card holds whole) as a
    DTensor on ``mesh``: nested chunks in mesh order, as DTensor nests
    them, copied so that the DTensor owns its storage."""
    local = full
    for i, p in enumerate(placements):
        if p.is_shard():
            local = local.chunk(mesh.size(i), dim=p.dim)[mesh.get_local_rank(i)]
    return from_local(local.clone(), mesh, placements)


def _to_local(x):
    return x.to_local() if is_dtensor(x) else x


class _WholeGrad(torch.autograd.Function):
    """Identity whose backward hands a partial output's local function the
    whole gradient: the gradient is made replicated over the mesh dims where
    the output is a pending sum (each summand's gradient is the sum's)."""

    @staticmethod
    def forward(ctx, x):
        ctx.placements = [_replicate() if p.is_partial() else p for p in x.placements]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return redistribute(replicate_partial(g), ctx.placements)


def _wrap(o: torch.Tensor, mesh, placements):
    out = from_local(o, mesh, placements)
    if o.requires_grad and any(p.is_partial() for p in placements):
        out = _WholeGrad.apply(out)
    return out


def local(fn: Callable, args: Sequence, out_placements, mesh):
    """``fn`` on the local shards of ``args`` (plain args pass as they are),
    each output tensor wrapped as a DTensor on ``mesh`` with its entry of
    ``out_placements`` (one list per output; a single list for a single
    tensor output). Gradients: an arg replicated over a mesh dim along which
    the outputs differ gets the sum of the cards' gradients there."""
    multi = isinstance(out_placements[0], (list, tuple))
    outs_pl = out_placements if multi else [out_placements]
    varying = [any(not pl[i].is_replicate() for pl in outs_pl) for i in range(mesh.ndim)]

    def grad_pl(a):
        return [_partial() if v and p.is_replicate() else p for v, p in zip(varying, a.placements)]

    outs = fn(*[a.to_local(grad_placements=grad_pl(a)) if is_dtensor(a) else a for a in args])
    if isinstance(outs, torch.Tensor):
        return _wrap(outs, mesh, outs_pl[0])
    return type(outs)(_wrap(o, mesh, pl) for o, pl in zip(outs, outs_pl))


def as_dtensor(x, mesh):
    """A plain tensor is the same on every card: a replicated DTensor."""
    if x is None or is_dtensor(x):
        return x
    return from_local(x, mesh, [_replicate()] * mesh.ndim)


def dot(x, w, k: int, lead: int, fn: Callable):
    """``fn(x, w)``, a contraction of x's last ``k`` dims with w's dims
    ``[lead, lead + k)`` (``lead`` 1: w's dim 0 is a row stack meeting x's
    dim 0), on DTensors, partitioned as GSPMD partitions a dot: a mesh dim
    that splits a contracted dim of one operand slices the other alike on
    each card (for free) and leaves a pending sum; one that splits w's
    output dims splits the result alike (x gathered there if it was split);
    x's row splits carry over. Each card then runs ``fn`` on its slices
    (a slice's gradient is gathered in the backward).
    DTensor's own choice would run a product of replicated operands whole
    on every card (the tied head's gradient, 13 TFLOP a chunk a card at
    granite-3-2b's width) and slice the result after."""
    mesh = (x if is_dtensor(x) else w).device_mesh
    x, w = replicate_partial(as_dtensor(x, mesh)), replicate_partial(as_dtensor(w, mesh))
    xr = x.dim() - k  # x's row dims are [0, xr), its contracted ones [xr, x.dim())
    xpl, wpl, opl = list(x.placements), list(w.placements), []
    for i in range(mesh.ndim):
        if mesh.size(i) == 1:
            opl.append(_replicate())
            continue
        xd, wd = shard_dim(xpl[i]), shard_dim(wpl[i])
        if wd is not None and lead <= wd < lead + k:  # w split on a contracted dim: x sliced alike
            xpl[i] = _shard(xr + wd - lead)
            opl.append(_partial())
        elif wd is not None and wd >= lead + k:  # w split on an output dim: x whole there
            xpl[i] = _replicate()
            opl.append(_shard(xr + wd - lead - k))
        elif wd is not None:  # w's row stack: x's rows alike
            xpl[i] = _shard(0)
            opl.append(_shard(0))
        elif xd is not None and xd >= xr:  # x split on a contracted dim, w whole: w sliced alike
            wpl[i] = _shard(lead + xd - xr)
            opl.append(_partial())
        else:
            opl.append(xpl[i] if xd is not None else _replicate())
    return local(fn, (redistribute(x, xpl), redistribute(w, wpl)), opl, mesh)


def align_heads(q, k, v):
    """q (B, S, H, hd), k and v (B, S, Hkv, hd) DTensors placed so that each
    card's share of the query heads meets its own key/value heads: q keeps
    Shard on the batch (0) or head (2) dim per mesh dim and is replicated on
    any other; where q's heads are split and k's are not split alike, k and
    v are expanded to H heads (each kv head repeated over its group) and
    split like q. Returns (q, k, v, placements)."""
    H, Hkv = q.shape[2], k.shape[2]
    mesh = q.device_mesh
    qpl = [p if p.is_shard() and p.dim in (0, 2) and mesh.size(i) > 1 else _replicate()
           for i, p in enumerate(q.placements)]
    q = redistribute(q, qpl)
    heads = [i for i, p in enumerate(qpl) if p.is_shard() and p.dim == 2]
    same = all(k.placements[i] == qpl[i] for i in heads) and Hkv % math.prod(mesh.size(i) for i in heads) == 0
    if heads and not same:
        g = H // Hkv

        def expand(t):
            t = redistribute(t, [_replicate() if p.is_partial() or (p.is_shard() and p.dim == 2) else p
                                 for p in t.placements])
            B, S, _, hd = t.shape
            return t.unsqueeze(3).expand(B, S, Hkv, g, hd).reshape(B, S, H, hd)

        k, v = expand(k), expand(v)
    return q, redistribute(k, qpl), redistribute(v, qpl), qpl


def _data_dims(mesh) -> List[int]:
    names = mesh.mesh_dim_names or ()
    return [i for i, n in enumerate(names) if n != "model" and mesh.size(i) > 1]


def whole_layer(fn: Callable, params, *xs):
    """``fn(params, *xs)`` (a layer: x, and its cache in decode) with the
    layer's weights gathered whole on every card, each card running it on
    its own batch rows (dim 0 of every tensor of ``xs``, split over the data
    axes as x is). Outputs are split like x's rows. The gradient of a
    weight sums over the data axes. A layer whose ops have no split over
    ``model`` in the port (the SSM blocks) runs this way."""
    from torch.utils._pytree import tree_flatten, tree_unflatten

    x = next(t for t in tree_flatten(xs)[0] if is_dtensor(t))
    mesh = x.device_mesh
    data = _data_dims(mesh)
    rows = [_shard(0) if i in data and x.placements[i] == _shard(0) else _replicate() for i in range(mesh.ndim)]
    repl = [_replicate()] * mesh.ndim
    grad = [_partial() if i in data else _replicate() for i in range(mesh.ndim)]
    pflat, pspec = tree_flatten(params)
    xflat, xspec = tree_flatten(xs)
    pflat = [redistribute(replicate_partial(p), repl) if is_dtensor(p) else p for p in pflat]
    xflat = [redistribute(replicate_partial(t), rows) if is_dtensor(t) else t for t in xflat]
    n = len(pflat)

    def run(*flat):
        out = fn(tree_unflatten(list(flat[:n]), pspec), *tree_unflatten(list(flat[n:]), xspec))
        return tree_flatten(out)

    local_in = [p.to_local(grad_placements=grad) if is_dtensor(p) else p for p in pflat]
    local_in += [_to_local(t) for t in xflat]
    outs, ospec = run(*local_in)
    return tree_unflatten([from_local(o, mesh, rows) if isinstance(o, torch.Tensor) else o for o in outs], ospec)


def replicated(fn: Callable, *trees):
    """``fn(*trees)`` on every card's whole copy of its (small) inputs: each
    DTensor leaf is gathered where it is split, ``fn`` runs on the local
    tensors, and every tensor it returns is a replicated DTensor."""
    from torch.utils._pytree import tree_flatten, tree_unflatten

    flat, spec = tree_flatten(trees)
    mesh = next(t.device_mesh for t in flat if is_dtensor(t))
    whole = [_replicate()] * mesh.ndim
    flat = [redistribute(replicate_partial(t), whole).to_local() if is_dtensor(t) else t for t in flat]
    outs, ospec = tree_flatten(fn(*tree_unflatten(flat, spec)))
    return tree_unflatten([from_local(o, mesh, whole) if isinstance(o, torch.Tensor) else o for o in outs], ospec)


class Rows:
    """The split of a step's leading row axis (clients, batch groups) over
    the mesh's data axes, and the ``model`` sub-mesh each card's rows train
    on."""

    def __init__(self, mesh):
        self.mesh = mesh
        names = mesh.mesh_dim_names
        self.model_dim = names.index("model")
        self.data_dims = [i for i in range(len(names)) if i != self.model_dim]
        self.model_mesh = mesh["model"]
        self.n_data = math.prod(mesh.size(i) for i in self.data_dims)

    @staticmethod
    def of(x) -> Optional["Rows"]:
        """The split of DTensor ``x``'s mesh; None for a plain tensor."""
        return Rows(x.device_mesh) if is_dtensor(x) else None

    def _model_placement(self, x):
        p = x.placements[self.model_dim]
        return _replicate() if p.is_partial() else p

    def local(self, x):
        """A full-mesh DTensor whose dim 0 is split over the data axes ->
        this card's rows, a DTensor on the ``model`` sub-mesh."""
        pl = [_shard(0) if i in self.data_dims else self._model_placement(x) for i in range(len(x.placements))]
        x = redistribute(x, pl)
        return from_local(x.to_local(), self.model_mesh, [pl[self.model_dim]])

    def params(self, x):
        """A full-mesh DTensor (a parameter, an optimizer leaf) -> the copy
        every card of a data group holds on the ``model`` sub-mesh (data-axis
        shards gathered first)."""
        pl = [_replicate() if i in self.data_dims else self._model_placement(x) for i in range(len(x.placements))]
        x = redistribute(x, pl)
        return from_local(x.to_local(), self.model_mesh, [pl[self.model_dim]])

    def full(self, x):
        """This card's rows (a ``model`` sub-mesh DTensor, rows on dim 0) ->
        one full-mesh DTensor, dim 0 split over the data axes."""
        pl = [None] * len(self.mesh.mesh_dim_names)
        for i in self.data_dims:
            pl[i] = _shard(0)
        pl[self.model_dim] = x.placements[0]
        return from_local(x.to_local(), self.mesh, pl)


def rows_like(x, n: int):
    """An uninitialized (n, *x.shape) buffer of x's dtype and device; for a
    DTensor, its rows placed like ``x`` (the new dim 0 replicated)."""
    if not is_dtensor(x):
        return torch.empty((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    pl = [_shard(p.dim + 1) if p.is_shard() else _replicate() for p in x.placements]
    loc = x.to_local()
    return from_local(torch.empty((n,) + tuple(loc.shape), dtype=loc.dtype, device=loc.device),
                      x.device_mesh, pl)


def block(shape: Sequence[int], placements: Sequence, sizes: Sequence[int], coords: Sequence[int]):
    """The block of a ``shape`` tensor placed by ``placements`` on a mesh of
    dim sizes ``sizes`` that the card at mesh coordinates ``coords`` holds,
    as an ``rnd.Shard`` (local shape and offsets). Mesh dims that split one
    dim nest in mesh order, as DTensor nests them; the specs split
    divisible dims only."""
    local, off = [int(n) for n in shape], [0] * len(shape)
    for p, n, c in zip(placements, sizes, coords):
        if p.is_shard():
            local[p.dim] //= int(n)
            off[p.dim] += int(c) * local[p.dim]
    return rnd.Shard(tuple(local), tuple(off))


def local_block(x):
    """This card's block of DTensor ``x`` (``block``)."""
    mesh = x.device_mesh
    return block(tuple(x.shape), x.placements, tuple(mesh.shape), mesh.get_coordinate())


def shard_offset(x, dim: int) -> int:
    """This card's offset along ``dim`` of DTensor ``x``."""
    return local_block(x).offsets[dim]


def vocab_lookup(emb, tokens):
    """``F.embedding(tokens, emb)`` of a DTensor table split over its vocab:
    each card looks up the tokens in its rows (zeros for the others), a
    pending sum over the vocab split (all-reduced by the caller)."""
    import torch.nn.functional as F

    mesh = emb.device_mesh
    rows = [p if p.is_shard() and p.dim == 0 and mesh.size(i) > 1 else _replicate()
            for i, p in enumerate(tokens.placements)] if is_dtensor(tokens) else [_replicate()] * mesh.ndim
    emb = redistribute(emb, [p if p.is_shard() and mesh.size(i) > 1 else _replicate()
                             for i, p in enumerate(emb.placements)])
    if is_dtensor(tokens):
        tokens = redistribute(tokens, rows)
    off, width = shard_offset(emb, 0), emb.to_local().shape[0]
    out_pl = [_partial() if p == _shard(0) and mesh.size(i) > 1
              else (_shard(tokens.dim()) if p == _shard(1) and mesh.size(i) > 1 else r)
              for i, (p, r) in enumerate(zip(emb.placements, rows))]

    def look(e, t):
        inside = (t >= off) & (t < off + width)
        y = F.embedding(torch.where(inside, t - off, torch.zeros_like(t)), e)
        return y * inside[..., None].to(y.dtype)

    return local(look, (emb, tokens), out_pl, mesh)


def logsumexp_and_pick(lg, tgt):
    """(logsumexp over the last dim, ``lg`` at ``tgt``) of float logits
    DTensor ``lg`` (..., V) and targets ``tgt`` (...), with V split over
    ``model``: a max and a sum all-reduced across the vocab shards, and each
    card picking the targets that fall in its shard (a sum of partials), as
    a vocab-parallel cross-entropy computes them."""
    mesh = lg.device_mesh
    vdim = lg.dim() - 1
    lg = redistribute(replicate_partial(lg), [p if p.is_shard() and p.dim in (0, vdim) else _replicate()
                                              for p in lg.placements])
    m = replicate_partial(lg.detach().amax(-1, keepdim=True))  # a constant shift
    lse = torch.log(replicate_partial(torch.exp(lg - m).sum(-1))) + m[..., 0]
    rows = [_shard(0) if p.is_shard() and p.dim == 0 else _replicate() for p in lg.placements]
    tgt = redistribute(replicate_partial(tgt), rows) if is_dtensor(tgt) else tgt
    off, width = shard_offset(lg, vdim), lg.to_local().shape[-1]

    def pick(lg_l, tgt_l):
        inside = (tgt_l >= off) & (tgt_l < off + width)
        idx = torch.where(inside, tgt_l - off, torch.zeros_like(tgt_l))
        got = torch.gather(lg_l, -1, idx[..., None])[..., 0]
        return torch.where(inside, got, torch.zeros_like(got))

    out_pl = [_partial() if p.is_shard() and p.dim == vdim else r for p, r in zip(lg.placements, rows)]
    return lse, replicate_partial(local(pick, (lg, tgt), out_pl, mesh))
