"""Driver of the program's federated LM round: ``repro_torch.launch.steps.make_train_step``
(local SGD of every client through the model blocks, the last-block
sketch, Auxo's clustering update, the reward-weighted segment sums and
FedYoGi), one call a step, on the traffic's token batches.

Set-up makes the weights from the seed, builds the step with its optimizer
and clustering state, and drives it through its first three steps (the
first is the warm-up), keeping what ``correct`` compares: each step's
loss, the first step's sketches with their inputs (the output of the
step's own ``GradientSketcher.batch``), each round's clustering (the
sketches ``steps.clustering_update`` was given, its assignments, counts and
centroids; the final counts), each leaf's norm of the first aggregated
delta (Yogi's m after one step over 1 - beta1) and each leaf's norm of the
change after three steps. The window continues the same object on new
batches.

Traced runs time, with CUDA events from this file: the step from its start
to ``GradientSketcher.batch`` (local training), the sketch, and every
``kernels.ops.segment_aggregate`` call with its bytes.
"""
from __future__ import annotations

import itertools
import math
import time

import numpy as np
import torch

from perfbench.entries import common
from perfbench.lib import counts
from perfbench.lib import spans as sp
from perfbench.lib import traffic as trf
from perfbench.lib import weights as wts
from perfbench.reference import fl_round as ref

KIND = "train_tokens"
SETUP_STEPS = 3


class Cell:
    def __init__(self, ctx):
        from repro_torch.launch import steps

        self.ctx, self.cfg, self.tr = ctx, ctx.config, ctx.traffic
        self.dev = ctx.device
        self.window = False
        self.spans = sp.Spans(self.dev)
        self.undo = []
        model = common.model_of(self.cfg)
        self.params = wts.nest(wts.make(self.cfg, ctx.seed, self.dev))
        self.opt = steps.yogi_init(self.params)
        self.clust = steps.clustering_init(self.tr["cluster_k"], self.tr["d_sketch"], device=self.dev)
        sc = steps.StepConfig(local_steps=self.tr["local_steps"], client_lr=self.tr["client_lr"],
                              server_lr=self.tr["server_lr"], clip_norm=self.tr["clip_norm"],
                              cluster_k=self.tr["cluster_k"], d_sketch=self.tr["d_sketch"])
        self.train_step = steps.make_train_step(model, sc)
        if ctx.fault == "cluster_unchanged":  # the clustering returns its state unchanged
            update = steps.clustering_update
            steps.clustering_update = lambda state, x, ema=0.3: (state, update(state, x, ema)[1])
            self.undo.append(lambda: setattr(steps, "clustering_update", update))
        if ctx.fault == "unchanged":  # a step that returns its state unchanged
            def unchanged(p, o, c, b):
                loss = model.loss(p, {"tokens": b["tokens"][0]})[0]
                return p, o, c, {"loss": loss.detach()}
            self.train_step = unchanged
        self.index = 0
        self.losses = []
        self.readings = {"loss": [], "rounds": []}
        undo = self._spy()
        for i in range(SETUP_STEPS):
            t0 = time.perf_counter()
            self.step()
            if i == 0:
                self.warmup_s = time.perf_counter() - t0
                m = wts.flatten(self.opt["m"])
                self.readings["grad"] = {n: float(torch.linalg.vector_norm(t)) / (1 - ref.BETA1)
                                         for n, t in m.items()}
        self.readings["loss"] = list(self.losses)
        start = wts.make(self.cfg, ctx.seed, self.dev)
        now = wts.flatten(self.params)
        self.readings["change"] = {n: float(torch.linalg.vector_norm(now[n] - start[n])) for n in now}
        del start, now
        self.readings["centroids"] = self.clust["centroids"].cpu().numpy()
        self.readings["counts"] = self.clust["counts"].cpu().numpy()
        self.losses = []
        undo()
        if ctx.trace:
            self._wrap()

    def _spy(self):
        """Keep the first step's sketches and every round's clustering as
        the step computed them."""
        from repro_torch.core.sketch import GradientSketcher
        from repro_torch.launch import steps

        batch, update = GradientSketcher.batch, steps.clustering_update

        def kept(sketcher, updates):
            out = batch(sketcher, updates)
            if "sketches" not in self.readings:  # the sketch's inputs and output, to the host
                flat = wts.flatten(updates)
                self.readings["sketch_rows"] = [
                    x.reshape(x.shape[0], -1).cpu() for x in
                    (ref.take(n, flat[n], lead=1) for n in sorted(flat)) if x is not None]
                self.readings["sketches"] = out.detach().cpu().numpy()
            return out

        def clustered(state, x, ema=0.3):
            new, met = update(state, x, ema)
            self.readings["rounds"].append({
                "sketches": x.float().cpu().numpy(), "assign": met["assign"].cpu().numpy(),
                "counts": met["cluster_counts"].cpu().numpy(), "centroids": new["centroids"].cpu().numpy()})
            return new, met

        GradientSketcher.batch, steps.clustering_update = kept, clustered

        def undo():
            GradientSketcher.batch, steps.clustering_update = batch, update
        return undo

    def _wrap(self):
        """CUDA events around the sketch and the segment sums (traced runs)."""
        from repro_torch.core.sketch import GradientSketcher
        from repro_torch.kernels import ops

        cell = self
        batch, seg = GradientSketcher.batch, ops.segment_aggregate

        def timed_batch(sketcher, updates):
            if not cell.window:
                return batch(sketcher, updates)
            a = cell.spans.event()
            cell.spans.add("local_train", cell.step_start, a)
            out = batch(sketcher, updates)
            cell.spans.add("sketch", a, cell.spans.event())
            return out

        def timed_seg(data, ids, k, weights=None):
            if not cell.window:
                return seg(data, ids, k, weights)
            a = cell.spans.event()
            out = seg(data, ids, k, weights)
            shape = data.shape if data.dim() == 3 else (1,) + tuple(data.shape)
            nbytes = counts.segment_call_bytes(shape, data.element_size(), ids.element_size(),
                                               weights is not None, k)
            cell.spans.add("segment", a, cell.spans.event(), nbytes)
            return out

        GradientSketcher.batch, ops.segment_aggregate = timed_batch, timed_seg
        self.undo += [lambda: setattr(GradientSketcher, "batch", batch),
                      lambda: setattr(ops, "segment_aggregate", seg)]

    def batch(self, index: int) -> np.ndarray:
        return trf.train_batch(self.ctx.seed, index, self.tr, self.cfg["vocab_size"])

    def step(self) -> float:
        toks = torch.from_numpy(self.batch(self.index)).to(self.dev)
        self.index += 1
        if self.ctx.fault == "half_batch":  # half of each client's sequences, the mean over the rest
            toks = toks[:, : toks.shape[1] // 2]
        self.step_start = self.spans.event() if self.window and self.ctx.trace else None
        self.params, self.opt, self.clust, met = self.train_step(self.params, self.opt, self.clust,
                                                                 {"tokens": toks})
        self.losses.append(float(met["loss"]))  # the step's end: its loss on the host
        common.sync(self.dev)
        return float(counts.fl_round_tokens(self.tr))

    def _restore(self):
        for u in reversed(self.undo):
            u()
        self.undo = []

    def finish(self) -> dict:
        self._restore()
        return {"kind": KIND, "warmup_s": self.warmup_s, "spans": self.spans.resolve(),
                "failed": sum(not math.isfinite(x) for x in self.losses)}

    def close(self):
        self._restore()
        del self.params, self.opt, self.clust, self.train_step
        common.free()

    def check(self) -> dict:
        """The program's readings against the reference's, from the seed;
        the sketch and clustering stages against the reference's on the
        program's own inputs."""
        theirs = ref.readings(self.cfg, self.tr, self.ctx.seed, self.dev, self.batch, SETUP_STEPS)
        return compare(self.readings, stages(self.readings, theirs, self.dev))


def stages(mine: dict, theirs: dict, device, project: bool = True) -> dict:
    """``theirs`` with the reference's stages run on ``mine``'s own inputs:
    the projection of its first-step sketch inputs (where it kept them,
    unless ``project`` is false: ``theirs`` holds it already) and the
    clustering of every round's sketches."""
    out = dict(theirs)
    if project and "sketch_rows" in mine:
        out["sketches"] = project_rows(mine, device)
    out["stage"] = ref.cluster_rounds([r["sketches"] for r in mine["rounds"]], len(theirs["counts"]), device)
    return out


def project_rows(readings: dict, device, tf32: bool = False) -> np.ndarray:
    """The reference's sketches of the program's first-step sketch inputs."""
    from perfbench.reference import dense_lm

    dense_lm.precision(tf32)
    try:
        rows = [r.to(device) for r in readings["sketch_rows"]]
        return ref.project(rows, readings["sketches"].shape[1]).cpu().numpy()
    finally:
        dense_lm.precision(False)


def leaf_gaps(mine: dict, theirs: dict, names) -> np.ndarray:
    """Each leaf's gap of norms, over the reference leaf's norm."""
    return np.array([abs(mine[n] - theirs[n]) / theirs[n] for n in names])


def worst_leaf(mine: dict, theirs: dict, names) -> float:
    """The worst leaf's gap of norms, against the reference leaf's norm or
    the median leaf's, whichever is larger."""
    med = float(np.median([theirs[n] for n in names]))
    return max(abs(mine[n] - theirs[n]) / max(theirs[n], med) for n in names)


def clustering_gaps(mine: dict, stage: dict, n_rounds: int):
    """(mismatches, gap) of ``mine``'s clustering against the reference's
    ``stage`` on the same sketches, under the labelling that fits best
    (labels are arbitrary): assignments, each round's counts and the final
    counts that differ, and the widest distance of a program centroid from
    the reference's (centroids are unit vectors). A round that never ran
    counts as a mismatch and as a centroid a whole unit off."""
    missing = n_rounds - len(mine["rounds"])
    best = None
    for p in itertools.permutations(range(len(stage["counts"]))):
        p = np.array(p)
        bad, gap = int(np.sum(mine["counts"] != stage["counts"][p])) + missing, 1.0 if missing else 0.0
        for m, r in zip(mine["rounds"], stage["rounds"]):
            bad += int(np.sum(p[m["assign"]] != r["assign"])) + int(np.sum(m["counts"] != r["counts"][p]))
            gap = max(gap, float(np.linalg.norm(m["centroids"] - r["centroids"][p], axis=1).max()))
        best = (bad, gap) if best is None else min(best, (bad, gap))
    return best


def compare(mine: dict, theirs: dict) -> dict:
    """The numbers ``correct`` compares (``theirs`` as ``stages`` gives
    it), and ``centroid_gap``, the centroids after the steps against the
    reference's own, which is reported and not compared (PERF.md §4 gives
    why). Leaves whose first reference gradient is under a thousandth of
    the median leaf's are left out of the change (they move by rounding
    alone)."""
    g = theirs["grad"]
    med = float(np.median(list(g.values())))
    keep = sorted(n for n, x in g.items() if x >= 1e-3 * med)
    sm, st = mine["sketches"], theirs["sketches"]
    cm, ct = mine["centroids"], theirs["centroids"]
    # cluster labels are arbitrary: the best matching of the two sets
    cent = min(float(np.abs(cm[list(p)] - ct).max()) for p in itertools.permutations(range(len(cm))))
    mismatch, gap = clustering_gaps(mine, theirs["stage"], len(theirs["loss"]))
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(mine["loss"], theirs["loss"])),
        "grad_gap": float(np.median(leaf_gaps(mine["grad"], g, sorted(g)))),
        "change_gap": float(np.median(leaf_gaps(mine["change"], theirs["change"], keep))),
        "sketch_gap": float(np.max(np.linalg.norm(sm - st, axis=1) / np.linalg.norm(st, axis=1))),
        "worst_grad_gap": worst_leaf(mine["grad"], g, sorted(g)),
        "worst_change_gap": worst_leaf(mine["change"], theirs["change"], keep),
        "cluster_mismatch": mismatch,
        "cluster_gap": gap,
        "centroid_gap": cent,
    }


def setup(ctx) -> Cell:
    return Cell(ctx)
