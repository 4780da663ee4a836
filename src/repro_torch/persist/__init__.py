"""Versioned persistent engine state (``rknn-store/1``).

Zero-cold-start serving: :func:`save_engine_state` exports the expensive
amortized state every layer accumulates (scenes, packed indexes, kernel
bucketing, shard partition, planner profile) through the atomic-rename
checkpoint machinery; :func:`warm_start` / :func:`restore_engine` bring
it back — at construction via ``RkNNConfig(warm_store=...)``, or into a
live engine as MVCC version N+1.

CLI: ``python -m repro_torch.persist --inspect <dir>`` / ``--verify <dir>``.
"""

from repro_torch.persist.store import (
    SCHEMA,
    adopt_categories,
    content_digest,
    expected_fingerprints,
    export_categories,
    restore_engine,
    save_engine_state,
    warm_start,
)

__all__ = [
    "SCHEMA",
    "adopt_categories",
    "content_digest",
    "expected_fingerprints",
    "export_categories",
    "restore_engine",
    "save_engine_state",
    "warm_start",
]
