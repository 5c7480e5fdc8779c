"""Inputs drawn from ``--seed``: token batches for training rounds and
prompts for decode waves. numpy, on the host; every seed gets the same
sizes, only the values differ.

The corpus is the one the port's federated LM example trains on: each
latent group repeats its own random phrase, every client belongs to group
``c % groups`` and adds token-substitution noise. Batch ``index`` draws its
own rows, so the rows of every step differ; the phrases are fixed per seed.
"""
from __future__ import annotations

import numpy as np


def corpus_batch(seed: int, index: int, clients: int, seqs: int, seq_len: int, vocab: int,
                 groups: int, phrase: int, noise: float) -> np.ndarray:
    """(clients, seqs, seq_len) int32 tokens of training step ``index``."""
    phrases = np.random.default_rng([int(seed), 0]).integers(0, vocab, size=(groups, phrase))
    rng = np.random.default_rng([int(seed), 1, int(index)])
    toks = np.empty((clients, seqs, seq_len), np.int32)
    reps = seq_len // phrase + 2
    for c in range(clients):
        base = np.tile(phrases[c % groups], reps)
        for j in range(seqs):
            off = int(rng.integers(0, phrase))
            row = base[off:off + seq_len].copy()
            flip = rng.random(seq_len) < noise
            row[flip] = rng.integers(0, vocab, size=int(flip.sum()))
            toks[c, j] = row
    return toks


def train_batch(seed: int, index: int, traffic: dict, vocab: int) -> np.ndarray:
    return corpus_batch(seed, index, traffic["clients"], traffic["seqs_per_client"],
                        traffic["seq_len"], vocab, traffic["groups"], traffic["phrase"],
                        traffic["noise"])


def prompts(seed: int, wave: int, rows: int, lanes: int, vocab: int) -> np.ndarray:
    """(rows, lanes) int32 first tokens of decode wave ``wave``."""
    rng = np.random.default_rng([int(seed), 2, int(wave)])
    return rng.integers(0, vocab, size=(rows, lanes)).astype(np.int32)


def sample(seed: int, n_items: int, k: int) -> list:
    """``k`` of ``n_items`` indices drawn from the seed, in ascending order."""
    rng = np.random.default_rng([int(seed), 3])
    k = min(k, n_items)
    return sorted(int(i) for i in rng.choice(n_items, size=k, replace=False))
