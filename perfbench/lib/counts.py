"""Operations and bytes of the work a cell does, from the configuration's
sizes alone: the yardstick of every ``mfu`` and roofline share.

Rules: model FLOPs count each matmul parameter as applied (2 FLOPs a
multiply-add, x3 for the forward and backward passes) plus causal
attention, and nothing recomputed; bytes count each input read once and
each output written once.
"""
from __future__ import annotations

from perfbench.lib.weights import dims, n_params


def matmul_params(cfg: dict) -> int:
    """Parameters that a token multiplies: every block projection and the
    tied head (the embedding table as the output projection). Norm scales
    and the embedding lookup are no matmuls."""
    s = dims(cfg)
    L, D, H, Hkv, hd, F, V = (s[k] for k in ("L", "D", "H", "Hkv", "hd", "F", "V"))
    per_layer = D * H * hd + 2 * D * Hkv * hd + H * hd * D + 3 * D * F
    return L * per_layer + V * D


def train_flops(cfg: dict, tokens: int, seq_len: int) -> float:
    """Forward and backward FLOPs of ``tokens`` trained in sequences of
    ``seq_len``: ``6 N T`` plus causal attention ``6 L S d_attn T`` (a
    token attends to S/2 keys on average, QK and PV each 2 FLOPs a
    multiply-add)."""
    s = dims(cfg)
    d_attn = s["H"] * s["hd"]
    return 6.0 * matmul_params(cfg) * tokens + 6.0 * s["L"] * seq_len * d_attn * tokens


def fl_round_tokens(traffic: dict) -> int:
    """Client tokens a federated round trains: every client's sequences once."""
    return traffic["clients"] * traffic["seqs_per_client"] * traffic["seq_len"]


def kv_bytes(cfg: dict, lanes: int, length: int, itemsize: int = 4) -> int:
    """K and V of ``lanes`` sequences read up to ``length`` positions, every layer."""
    s = dims(cfg)
    return 2 * lanes * s["L"] * length * s["Hkv"] * s["hd"] * itemsize


def decode_step_bytes(cfg: dict, rows: int, lanes: int, length: int, itemsize: int = 4) -> int:
    """Least bytes of one fleet step: each live row's weights once (the tied
    embedding once, as the head) and every lane's K/V up to ``length``."""
    return rows * n_params(cfg) * itemsize + kv_bytes(cfg, rows * lanes, length, itemsize)


def attention_call_bytes(cfg: dict, batch: int, length: int, itemsize: int = 4) -> int:
    """One decode-attention call over ``batch`` sequences of ``length``:
    q read, K and V up to the length read, the output written, the lengths read."""
    s = dims(cfg)
    qo = 2 * batch * s["H"] * s["hd"] * itemsize
    kv = 2 * batch * length * s["Hkv"] * s["hd"] * itemsize
    return qo + kv + 4 * batch


def segment_call_bytes(data_shape, data_itemsize: int, ids_itemsize: int, weighted: bool,
                       num_segments: int) -> int:
    """One segment sum (C, P, D) -> (C, K, D) float32: data, ids and weights
    read once, the sums written once."""
    C, P, D = (int(x) for x in data_shape)
    return (C * P * D * data_itemsize + C * P * ids_itemsize + (4 * C * P if weighted else 0)
            + 4 * C * num_segments * D)
