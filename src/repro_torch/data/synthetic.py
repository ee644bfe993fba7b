"""Deterministic synthetic token pipelines.

* ``synthetic_batches`` — uniform random tokens (throughput/compile tests).
* ``markov_batches``    — an order-2 Markov stream with a low-entropy
  transition structure: a model that learns reduces loss well below
  log(vocab), so trainer tests can assert real learning.

Both are host-side numpy generators with the reference package's seeds and
draw order, so the batches are equal arrays in both packages (the Markov
stream's draws are made in one block instead of one ``choice`` call a
token, about a hundred times faster); the trainer moves each batch to its
device.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np


def synthetic_batches(batch: int, seq: int, vocab: int, seed: int = 0,
                      encdec_dim: Optional[int] = None,
                      enc_ratio: int = 4) -> Iterator[Dict[str, np.ndarray]]:
    step = 0
    while True:
        rng = np.random.default_rng(seed * 1_000_003 + step)
        tokens = rng.integers(0, vocab, size=(batch, seq), dtype=np.int32)
        out = {"tokens": tokens, "labels": tokens.copy()}
        if encdec_dim is not None:
            out["enc_frames"] = rng.normal(
                size=(batch, max(1, seq // enc_ratio), encdec_dim)
            ).astype(np.float32)
        yield out
        step += 1


def _markov_tables(vocab: int, seed: int, branch: int = 4):
    rng = np.random.default_rng(seed)
    nxt = rng.integers(0, vocab, size=(vocab, branch)).astype(np.int32)
    probs = rng.dirichlet(np.full(branch, 0.3), size=vocab).astype(np.float32)
    return nxt, probs


def markov_batches(batch: int, seq: int, vocab: int, seed: int = 0,
                   encdec_dim: Optional[int] = None,
                   enc_ratio: int = 4, start: int = 0
                   ) -> Iterator[Dict[str, np.ndarray]]:
    """``start`` offsets the batch counter: a held-out eval split is the
    same transition tables (same ``seed``) at a disjoint step window."""
    nxt, probs = _markov_tables(vocab, seed)
    # ``Generator.choice(n, p=p)`` draws one double u and returns how many
    # entries of cdf = cumsum(float64(p)) / cdf[-1] are <= u; the reference
    # calls it once per token, row-major over (position, row), so one
    # (seq, batch) block of doubles is the same draws in the same order
    cdf = np.cumsum(probs.astype(np.float64), axis=1)
    cdf /= cdf[:, -1:]
    step = start
    while True:
        rng = np.random.default_rng(seed * 7_919 + step + 1)
        toks = np.empty((batch, seq + 1), np.int32)
        toks[:, 0] = rng.integers(0, vocab, size=batch)
        u = rng.random((seq, batch))
        for t in range(seq):
            cur = toks[:, t]
            choice = (cdf[cur] <= u[t, :, None]).sum(axis=1)
            toks[:, t + 1] = nxt[cur, choice]
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
        if encdec_dim is not None:
            out["enc_frames"] = rng.normal(
                size=(batch, max(1, seq // enc_ratio), encdec_dim)
            ).astype(np.float32)
        yield out
        step += 1
