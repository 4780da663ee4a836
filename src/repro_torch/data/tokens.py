"""Deterministic sharded token pipeline (a numpy copy of ``repro.data.tokens``).

Index-based (stateless) loading: batch ``i`` of host ``h`` is a pure
function of ``(seed, step, host, n_hosts)`` — so resuming from a
checkpointed step reproduces the exact stream with no iterator state to
snapshot, and host shards are disjoint by construction.  The synthetic
distribution is Zipf-ish over the vocab with a short-range Markov flavor so
the loss actually decreases during the example runs (unlike uniform noise).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["TokenPipelineConfig", "ShardedTokenPipeline"]


@dataclasses.dataclass(frozen=True)
class TokenPipelineConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3


class ShardedTokenPipeline:
    """Yields ``{"tokens", "labels"}`` batches for one host's shard."""

    def __init__(self, cfg: TokenPipelineConfig, host: int = 0, n_hosts: int = 1):
        if cfg.global_batch % n_hosts:
            raise ValueError("global_batch must divide across hosts")
        self.cfg = cfg
        self.host = host
        self.n_hosts = n_hosts
        self.local_batch = cfg.global_batch // n_hosts
        # Zipf-ish stationary distribution (clipped + renormalised)
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self._p = p / p.sum()

    def _row_rng(self, step: int, row: int) -> np.random.Generator:
        # disjoint by construction: global row id folds host shard and step
        gid = (step * self.cfg.global_batch) + self.host * self.local_batch + row
        return np.random.default_rng(np.random.SeedSequence([self.cfg.seed, gid]))

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        S = self.cfg.seq_len
        tokens = np.empty((self.local_batch, S + 1), dtype=np.int32)
        for r in range(self.local_batch):
            rng = self._row_rng(step, r)
            base = rng.choice(self.cfg.vocab, size=S + 1, p=self._p)
            # short-range structure: with p=0.5 repeat of t-1 offset by 1
            rep = rng.random(S) < 0.5
            base[1:][rep] = (base[:-1][rep] + 1) % self.cfg.vocab
            tokens[r] = base
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
