"""Paged per-cohort KV cache for the serving plane's decode fast path
(port of ``repro.serve.kv_cache``).

One row of pages per LIVE cohort slot, stacked so the whole fleet decodes
in one step: k/v are (R, lanes, L, S, Hkv, hd) with R the pow2-bucketed
live-cohort count, ``lanes`` concurrent decode streams per cohort, and S a
pow2 number of ``page_size``-token pages that doubles on demand. Resident
bytes are therefore ∝ live cohorts — never ∝ N clients.

Layout: the JAX package keeps (R, L, lanes, S, Hkv, hd). The port puts the
lanes before the layers, so that one layer's slice ``k[:, :, l]`` flattens
its rows and lanes into one batch axis with a single stride and the decode
kernel reads it in place (no copy per step or per layer).

Partition/merge discipline: ``sync(live_slots)`` reconciles rows against
the current leaf slots with the scatter idiom the bank's
``spawn_children`` uses — rows of retained cohorts keep their pages and
decode positions, rows of retired parents are freed, and fresh children
start on zeroed pages at position 0.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from repro_torch import resolve_device


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


class PagedKVCache:
    def __init__(
        self,
        n_layers: int,
        lanes: int,
        n_kv_heads: int,
        head_dim: int,
        page_size: int = 128,
        dtype=torch.float32,
        device=None,
    ):
        self.L = int(n_layers)
        self.lanes = int(lanes)
        self.Hkv = int(n_kv_heads)
        self.hd = int(head_dim)
        self.page_size = int(page_size)
        self.dtype = dtype
        self.device = resolve_device(device)
        self.slots: List[int] = []  # row -> cohort bank slot
        self.k = self.v = None      # (R, lanes, L, S, Hkv, hd)
        self.index = np.zeros(0, np.int32)  # per-row decode position

    # ------------------------------------------------------------- shape
    @property
    def rows(self) -> int:
        return 0 if self.k is None else self.k.shape[0]

    @property
    def seq(self) -> int:
        return 0 if self.k is None else self.k.shape[3]

    @property
    def pages(self) -> int:
        return self.seq // self.page_size

    @property
    def nbytes(self) -> int:
        if self.k is None:
            return 0
        return int(self.k.numel() * self.k.element_size() + self.v.numel() * self.v.element_size())

    def _zeros(self, r: int, s: int) -> torch.Tensor:
        return torch.zeros(
            (r, self.lanes, self.L, s, self.Hkv, self.hd), dtype=self.dtype, device=self.device
        )

    # ---------------------------------------------------------- lifecycle
    def sync(self, live_slots: Sequence[int]):
        """Reconcile rows against the live cohort slots (partition/merge).

        Retained slots keep their pages + position, vanished slots free
        theirs, new slots allocate zeroed rows. No-op when the live set is
        unchanged.
        """
        live = [int(s) for s in live_slots]
        if live == self.slots and self.k is not None:
            return
        s = self.seq or self.page_size
        r = max(1, _next_pow2(len(live)))
        new_k, new_v = self._zeros(r, s), self._zeros(r, s)
        new_index = np.zeros(r, np.int32)
        old = {slot: i for i, slot in enumerate(self.slots)}
        src = [old[slot] for slot in live if slot in old]
        dst = [j for j, slot in enumerate(live) if slot in old]
        if src:
            new_k[dst] = self.k[src]
            new_v[dst] = self.v[src]
            new_index[dst] = self.index[src]
        self.k, self.v, self.index, self.slots = new_k, new_v, new_index, live

    def ensure(self, extra: int):
        """Grow pages (doubling) so every live row fits ``extra`` more tokens."""
        if self.k is None:
            raise RuntimeError("sync() before ensure()")
        need = int(self.index.max(initial=0)) + int(extra)
        while self.seq < need:
            s = self.seq
            self.k = torch.cat([self.k, self._zeros(self.rows, s)], dim=3)
            self.v = torch.cat([self.v, self._zeros(self.rows, s)], dim=3)
