"""Synthetic LM token pipeline: structured streams a transformer can
actually learn (Zipf unigrams + copy/induction motifs + local n-gram
grammar), so a training run shows a real loss curve offline.

The port's own copy of repro/data/lm_data.py (numpy only, no JAX): the
same generator calls in the same order, so a seed gives the reference's
stream token for token.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class LMDataConfig:
    vocab: int = 512
    seq_len: int = 256
    batch: int = 8
    seed: int = 0
    motif_p: float = 0.35       # probability a span is a repeated motif
    bigram_alpha: float = 0.7   # strength of the bigram grammar


def _bigram_table(rng: np.random.Generator, vocab: int) -> np.ndarray:
    """Sparse random bigram transition table (each token has ~8 likely
    successors) -- gives the stream learnable local structure."""
    succ = rng.integers(0, vocab, size=(vocab, 8))
    return succ


def sequence(rng: np.random.Generator, cfg: LMDataConfig,
             succ: np.ndarray) -> np.ndarray:
    out = np.empty(cfg.seq_len + 1, np.int64)
    zipf_p = 1.0 / np.arange(1, cfg.vocab + 1) ** 1.1
    zipf_p /= zipf_p.sum()
    t = 0
    out[0] = rng.integers(0, cfg.vocab)
    while t < cfg.seq_len:
        if rng.random() < cfg.motif_p and t > 16:
            # induction motif: copy an earlier span
            start = int(rng.integers(0, t - 8))
            ln = int(rng.integers(4, min(16, t - start)))
            ln = min(ln, cfg.seq_len - t)
            out[t + 1:t + 1 + ln] = out[start:start + ln]
            t += ln
        else:
            prev = out[t]
            if rng.random() < cfg.bigram_alpha:
                out[t + 1] = succ[prev, rng.integers(0, succ.shape[1])]
            else:
                out[t + 1] = rng.choice(cfg.vocab, p=zipf_p)
            t += 1
    return out


def batches(cfg: LMDataConfig) -> Iterator[Dict[str, np.ndarray]]:
    rng = np.random.default_rng(cfg.seed)
    succ = _bigram_table(rng, cfg.vocab)
    while True:
        toks = np.stack([sequence(rng, cfg, succ)
                         for _ in range(cfg.batch)])
        yield {"tokens": toks[:, :-1].astype(np.int32),
               "labels": toks[:, 1:].astype(np.int32)}
