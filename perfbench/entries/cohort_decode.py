"""Driver of the program's cohort-personalised decode:
``repro_torch.serve.CohortDecoder`` over a cohort bank the benchmark makes
from the seed, its attention through ``kernels.ops.decode_attention`` (the
decode-attention kernel on the card) handed in as the decoder's backend.

Traffic: waves of requests, one request on every lane of every live
cohort. A request is one prompt token and ``request_tokens`` greedy tokens;
each step of the window is one ``decode(call_steps)`` call, back to back,
and a wave restarts every lane at position 0 with new prompts. The paged
cache is sized for a whole request in set-up, so no step grows it.

Timing, with CUDA events from this file: a mark at every fleet step (at
its first layer's attention), whose gaps are the time between a lane's
tokens, the weight gather at each call boundary included; in traced runs
also every attention call with its bytes. After the window the wave in
flight is finished outside it, and a sample of the finished requests,
drawn from the seed, is judged against the reference.
"""
from __future__ import annotations

import time

import numpy as np

from perfbench.entries import common
from perfbench.lib import spans as sp
from perfbench.lib import traffic as trf
from perfbench.lib import weights as wts
from perfbench.reference import decode as ref

KIND = "decode_tokens"


class Cell:
    def __init__(self, ctx):
        from repro_torch.kernels import ops
        from repro_torch.serve import CohortDecoder

        self.ctx, self.cfg, self.tr = ctx, ctx.config, ctx.traffic
        self.dev = ctx.device
        self.window = False
        self.spans = sp.Spans(self.dev)
        self.attend_kernel = ops.decode_attention
        self.n_layers = wts.dims(self.cfg)["L"]
        self.rows = self.tr["live_cohorts"]
        self.lanes = self.tr["lanes"]
        self.call_steps = self.tr["call_steps"]
        if self.tr["request_tokens"] % self.call_steps:
            raise ValueError("request_tokens must be a whole number of calls")
        model = common.model_of(self.cfg)
        self.bank = wts.nest(wts.make(self.cfg, ctx.seed, self.dev, slots=self.tr["bank_slots"]))
        live = list(range(self.rows))
        self.live = live
        self.dec = CohortDecoder(model, lambda: self.bank, lambda: list(live), lanes=self.lanes,
                                 page_size=self.tr["page_size"], backend=self._attend, device=self.dev)
        self.dec.sync()
        self.dec.cache.ensure(self.tr["request_tokens"] + 1)
        self.calls = self.start = 0
        self.wave = -1
        self.pos = 0
        self.done = []  # finished waves: (sequences (R, lanes, T), last logits (R, lanes, V))
        self.failed = 0
        self.started = 0
        t0 = time.perf_counter()
        self._start_wave()
        self.dec.decode(self.call_steps)  # the warm-up: every shape of the window
        common.sync(self.dev)
        self.warmup_s = time.perf_counter() - t0
        self.pos = self.tr["request_tokens"]  # the window starts a fresh wave
        self.done.clear()
        self.started = 0

    def _attend(self, q, k, v, length):
        layer = self.calls % self.n_layers
        at = self.start + self.calls // self.n_layers + 1  # every lane's length at this step
        self.calls += 1
        if not self.window:
            return self.attend_kernel(q, k, v, length)
        if layer == 0:
            self.spans.mark("step", at)
        if not self.ctx.trace:
            return self.attend_kernel(q, k, v, length)
        a = self.spans.event()
        out = self.attend_kernel(q, k, v, length)
        self.spans.add("attention", a, self.spans.event(), (q.shape[0], at))
        return out

    def _start_wave(self):
        self.wave += 1
        self.prompts = trf.prompts(self.ctx.seed, self.wave, self.rows, self.lanes, self.cfg["vocab_size"])
        self.dec.tokens = self.prompts.copy()
        self.dec.cache.index[:] = 0
        self.pos = 0
        self.pieces = []
        self.started += self.rows * self.lanes

    def step(self) -> float:
        if self.pos >= self.tr["request_tokens"]:
            self._start_wave()
        self.start, self.calls = self.pos, 0
        toks, logits = self.dec.decode(self.call_steps)  # ends on the host: tokens and logits copied back
        if self.ctx.fault == "token":  # a token altered where it is produced, on every lane
            toks[..., -1] = (toks[..., -1] + 1) % self.cfg["vocab_size"]
        self.pieces.append(toks)
        self.pos += self.call_steps
        if not np.isfinite(logits).all():
            self.failed += 1
        if self.pos == self.tr["request_tokens"]:
            seqs = np.concatenate([self.prompts[..., None]] + self.pieces, axis=-1)
            self.done.append((seqs, logits))
        return float(self.rows * self.lanes * self.call_steps)

    def finish(self) -> dict:
        self.window = False
        while 0 < self.pos < self.tr["request_tokens"]:  # the wave in flight, outside the window
            self.step()
        return {"kind": KIND, "warmup_s": self.warmup_s, "spans": self.spans.resolve(),
                "failed": self.failed, "attempted": self.started,
                "rows": self.rows, "lanes": self.lanes}

    def close(self):
        del self.dec, self.bank
        common.free()

    def requests(self) -> list:
        """The finished requests the check judges: a sample drawn from the seed."""
        everyone = [(w, r, l) for w in range(len(self.done)) for r in range(self.rows)
                    for l in range(self.lanes)]
        pick = trf.sample(self.ctx.seed, len(everyone), self.tr["check_requests"])
        out = []
        for i in pick:
            w, r, l = everyone[i]
            seqs, last = self.done[w]
            out.append({"slot": self.live[r], "tokens": seqs[r, l], "last_logits": last[r, l]})
        return out

    def check(self) -> dict:
        return ref.readings(self.cfg, self.tr, self.ctx.seed, self.dev, self.requests())


def setup(ctx) -> Cell:
    return Cell(ctx)

