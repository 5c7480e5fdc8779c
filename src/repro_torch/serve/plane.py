"""§⑧ serving plane: batched routing + one batched inference per admitted
batch (port of ``repro.serve.plane``).

A ``ServingPlane`` answers client queries against the training engine's
cohort models. Per admitted batch:

1. **route** — hot clients (training fingerprint in the store) and cold
   clients (the engine's cached ``_probe_fingerprints`` probe, ONE batched
   training pass for all cache misses) are matched to cohort identities
   with one ``match_many`` matrix product; an unconfident margin falls back
   to the retained root generalist, exactly like ``serving_cohorts``.
2. **infer** — the mixed-cohort batch becomes ONE batched inference:
   gather each query's cohort slot row from the stacked bank and run
   ``task.logits`` on the stacked rows (``torch.bmm`` over rows), argmax.
   One inference per batch, however many cohorts it spans.

All reads go through ``pipeline.serve_params`` — the round-boundary
snapshot the pipeline republishes after each round — so serving never
pairs a half-applied bank with the host tables.

Deliberate delta vs ``serving_cohorts`` (as in the JAX package): the plane
skips the stale-EMA re-probe rescue and the per-client tree descent
fallback — both are host loops tuned for offline evaluation; at serving
rates an unconfident hot client simply gets the generalist.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.serve.admission import AdmissionBatcher
from repro_torch.serve.stream import QueryStream


class ServingPlane:
    def __init__(self, engine, max_batch: int = 256, max_wait: float = 1e-3):
        self.eng = engine
        self.batcher = AdmissionBatcher(max_batch=max_batch, max_wait=max_wait)
        # dispatch/observability counters (CI tripwires)
        self.infer_dispatches = 0
        self.batches_served = 0
        self.queries_served = 0
        # per-id query-input cache: the query payload is a deterministic
        # data-plane draw per client, so a standing plane derives it once
        # per id instead of per query. Bounded: cleared at 2^20 ids.
        self._x_cache: Dict[int, np.ndarray] = {}

    # ---------------------------------------------------------- snapshot
    def snapshot(self):
        """The round-boundary stacked bank params serving reads from."""
        return self.eng.pipeline.serve_params

    def _root_params(self, params):
        s0 = self.eng.pipeline.bank.slot_of["0"]
        return {k: a[s0] for k, a in params.items()}

    # ------------------------------------------------------------ routing
    def route_slots(self, ids, params=None) -> np.ndarray:
        """Bank slot serving each query id (vectorized, one probe batch).

        Mirrors ``serving_cohorts``' fingerprint → match_many → confidence
        routing, minus its offline-only host loops (see module docstring).
        """
        eng = self.eng
        params = self.snapshot() if params is None else params
        cs = np.asarray(ids, np.int64)
        bank = eng.pipeline.bank
        root = bank.slot_of["0"]
        slots = np.full(cs.size, root, np.int64)
        if cs.size == 0:
            return slots
        can_probe = (
            eng.auxo.enabled
            and eng.auxo.probe_serving
            and eng.global_mu_seen
            and len(eng.coordinator.identity) >= 2
        )
        have = np.asarray(eng.fp_seen[cs], bool)
        fps = np.zeros((cs.size, eng.auxo.d_sketch), np.float32)
        if have.any():
            fps[have] = eng.fingerprint[cs[have]]
        need = (~have) if can_probe else np.zeros(cs.size, bool)
        if need.any():
            # cold path: cached probe fingerprints against the SNAPSHOT
            # root (all cache misses batch into one training pass)
            fps[need] = eng._probe_fingerprints(cs[need], root_params=self._root_params(params))
        has_fp = have | need
        if has_fp.any():
            sub = np.flatnonzero(has_fp)
            best, margin, leaves = eng.coordinator.match_many(fps[sub])
            if leaves:
                leaf_slots = np.asarray([bank.slot_of[leaf] for leaf in leaves], np.int64)
                conf = eng.auxo.serve_confidence
                slots[sub] = np.where(margin >= conf, leaf_slots[best], root)
        return slots

    # ---------------------------------------------------------- inference
    def _query_inputs(self, ids: np.ndarray) -> np.ndarray:
        """Each client's deterministic query payload, cached per id."""
        miss = np.unique(np.asarray([c for c in ids if int(c) not in self._x_cache], np.int64))
        if miss.size:
            if len(self._x_cache) > (1 << 20):
                self._x_cache.clear()
            xs, _ = self.eng.data.probe_batches(miss, 1, 1)
            for j, c in enumerate(miss):
                self._x_cache[int(c)] = xs[j, 0, 0]
        return np.stack([self._x_cache[int(c)] for c in ids])

    @torch.no_grad()
    def _infer(self, params, slots: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """ONE batched inference: query i runs its slot's row of the bank."""
        rows = {k: a[slots] for k, a in params.items()}  # (n, ...) gathered rows
        return torch.argmax(self.eng.task.logits(rows, x[:, None, :])[:, 0], dim=-1)

    def serve_batch(self, ids, params=None) -> np.ndarray:
        """Serve one admitted batch: route + ONE batched inference.

        Returns per-query predicted classes. The query input is each
        client's deterministic data-plane draw (``probe_batches``), so two
        engines in the same training state return the same answers.
        """
        ids = np.asarray(ids, np.int64)
        if ids.size == 0:
            return np.zeros(0, np.int64)
        params = self.snapshot() if params is None else params
        slots = self.route_slots(ids, params)
        dev = self.eng.device
        x = torch.from_numpy(self._query_inputs(ids)).to(dev)
        preds = self._infer(params, torch.from_numpy(slots).to(dev), x)
        self.infer_dispatches += 1
        self.batches_served += 1
        self.queries_served += int(ids.size)
        return preds.cpu().numpy().astype(np.int64)

    # ------------------------------------------------------------- stream
    def serve_stream(self, stream: QueryStream, params=None) -> Tuple[np.ndarray, List]:
        """Admit + serve a whole stream; returns (preds, admitted batches)."""
        params = self.snapshot() if params is None else params
        batches = self.batcher.admit(stream)
        preds = [self.serve_batch(b.ids, params) for b in batches]
        return np.concatenate(preds) if preds else np.zeros(0, np.int64), batches
