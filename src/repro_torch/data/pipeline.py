"""Deterministic synthetic data pipeline.

Port of ``repro.data.pipeline``, bitwise: every (step, row) cell of the
corpus is a pure function of the run seed (numpy), so a run resumed
from a checkpoint at step t sees exactly the batches it would have
seen, and two workers assigned the same shard read byte-identical
microbatches (the replication code's premise).  Tokens mix a Zipf-ish
unigram draw with a learnable bigram (token 2k is often followed by
2k+1), so a small model's loss actually falls.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.assignment import Assignment, shard_batch_indices


def global_batch_for_step(cfg, *, global_batch: int, seq_len: int, step: int,
                          seed: int = 0):
    """Returns {tokens (B,S) int32, labels (B,S) int32} as numpy arrays."""
    rng = np.random.default_rng((seed * 1_000_003 + step) & 0x7FFFFFFF)
    B, S, V = global_batch, seq_len, cfg.vocab_size
    alpha = 1.2
    vocab_eff = min(V, 4096)
    ranks = np.arange(1, vocab_eff + 1, dtype=np.float64)
    probs = ranks**-alpha
    probs /= probs.sum()
    tokens = rng.choice(vocab_eff, size=(B, S + 1), p=probs).astype(np.int32)
    even = (tokens[:, :-1] % 2) == 0
    follow = np.minimum(tokens[:, :-1] + 1, vocab_eff - 1)
    mask = rng.random((B, S)) < 0.5
    tokens[:, 1:] = np.where(even & mask, follow, tokens[:, 1:])
    return {
        "tokens": tokens[:, :-1].copy(),
        "labels": tokens[:, 1:].copy(),
    }


def worker_batches(batch: dict, assignment: Assignment) -> dict:
    """{tokens (n, rows, S), labels (n, rows, S)}: worker w's rows are
    its shard's; replica-group members receive identical rows."""
    B = batch["tokens"].shape[0]
    rows = shard_batch_indices(assignment, B)
    return {k: v[rows] for k, v in batch.items()}
