"""Plain reference of greedy cohort decode: one full forward of each
request's prompt and served tokens under its cohort's weights
(``dense_lm.logits``), against which the served tokens and the program's
last logits are judged.

- ``token_gap``: the widest gap by which a served token's reference logit
  lies below the reference's best at its position (0 where every served
  token is the reference's argmax; a near tie costs its rounding);
- ``logit_gap``: the largest difference of the program's last-step logits
  from the reference's at that position, over the largest reference logit
  magnitude there.

The control reads both with the reference itself in TF32 in the program's
place: at every position the token that TF32 puts first, its last logits.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from perfbench.lib import weights as wts
from perfbench.reference import dense_lm


def _gaps(ref: torch.Tensor, chosen: torch.Tensor) -> float:
    """ref (n, T, V), chosen (n, T): the widest gap of a chosen token below the best."""
    best = ref.max(dim=-1).values
    return float((best - ref.gather(-1, chosen[..., None].long())[..., 0]).max())


def readings(cfg: dict, tr: dict, seed: int, device, requests: List[dict], control: bool = False) -> Dict[str, float]:
    """``requests``: dicts with ``slot``, ``tokens`` (T,) (the prompt and the
    served tokens) and ``last_logits`` (V,) from the program."""
    bank = wts.make(cfg, seed, device, slots=tr["bank_slots"])
    token_gap = logit_gap = 0.0
    ctrl_token = ctrl_logit = 0.0
    by_slot: Dict[int, List[dict]] = {}
    for r in requests:
        by_slot.setdefault(int(r["slot"]), []).append(r)
    for slot, reqs in sorted(by_slot.items()):
        w = {n: t[slot] for n, t in bank.items()}
        toks = torch.from_numpy(np.stack([r["tokens"] for r in reqs])).to(device)
        dense_lm.precision(False)
        ref = dense_lm.logits(cfg, w, toks[:, :-1])  # position t predicts token t + 1
        token_gap = max(token_gap, _gaps(ref, toks[:, 1:]))
        last = torch.from_numpy(np.stack([r["last_logits"] for r in reqs])).to(device)
        ref_last = ref[:, -1]
        scale = float(ref_last.abs().max())
        logit_gap = max(logit_gap, float((last - ref_last).abs().max()) / scale)
        if control:
            dense_lm.precision(True)
            low = dense_lm.logits(cfg, w, toks[:, :-1])
            dense_lm.precision(False)
            ctrl_token = max(ctrl_token, _gaps(ref, low.argmax(dim=-1)))
            ctrl_logit = max(ctrl_logit, float((low[:, -1] - ref_last).abs().max()) / scale)
            del low
        del ref
    out = {"token_gap": token_gap, "logit_gap": logit_gap}
    if control:
        out["control"] = {"token_gap": ctrl_token, "logit_gap": ctrl_logit}
    return out
