"""Cross-shard reductions for user-axis sharded serving (``repro.shard.reduce``).

Hit counts are **per-user independent** (one ray per user), so the
user-axis partition makes the count matrix itself embarrassingly
parallel: each shard produces the ``[Q, N_s]`` slab for the users it
owns and :func:`assemble_counts` scatters the slabs back through the
partition permutation — bit-identical to the single-process dispatch by
construction, no arithmetic crosses a shard boundary.

What *does* cross shards is every per-query aggregate — result-set
sizes, hit totals — which in a real SPMD deployment is a ``psum`` over
the ``'users'`` axis.  :func:`tree_psum` is that collective's host-side
twin: a butterfly/tree pairwise reduction whose combine order is fixed
by shard index, so the aggregate a 4-shard mesh reports is reproducible
and (for int counts) exact.

Host numpy, carried over verbatim: the sharded dispatch
(:class:`repro_torch.shard.engine.ShardDispatch`) reassembles on the card
and is held against :func:`assemble_counts` by the tests.
"""

from __future__ import annotations

import numpy as np

__all__ = ["tree_psum", "assemble_counts", "result_sizes"]


def tree_psum(parts: list[np.ndarray]) -> np.ndarray:
    """Pairwise-tree sum of per-shard partials (the ``psum`` twin).

    Deterministic combine order: shards reduce with their power-of-two
    neighbor each round (0+1, 2+3, then 0+2, ...), exactly the butterfly
    a mesh collective runs, so results do not depend on Python iteration
    quirks and float partials reduce in a reproducible order.
    """
    if not parts:
        raise ValueError("tree_psum of zero shards")
    level = [np.asarray(p) for p in parts]
    while len(level) > 1:
        nxt = []
        for i in range(0, len(level) - 1, 2):
            nxt.append(level[i] + level[i + 1])
        if len(level) % 2:
            nxt.append(level[-1])
        level = nxt
    return level[0]


def assemble_counts(
    per_shard: list[np.ndarray],
    perm: np.ndarray,
    bounds: np.ndarray,
    n_users: int,
) -> np.ndarray:
    """``[Q, N]`` counts in original user order from per-shard slabs.

    ``per_shard[s]`` is ``[Q, bounds[s+1]-bounds[s]]`` in the order of
    ``perm[bounds[s]:bounds[s+1]]`` (the partition permutation).  Pure
    scatter — the per-user values are untouched, which is what makes the
    sharded masks bit-identical to the single-process oracle.

    This is the *reference* composition the property tests pin down; the
    hot dispatch (:meth:`repro_torch.shard.engine.ShardDispatch.__call__`)
    runs the same scatter on the card, fused with the grid kernels'
    bucket unsort, value-identical by construction.
    """
    q = per_shard[0].shape[0]
    out = np.zeros((q, int(n_users)), np.int32)
    for s, slab in enumerate(per_shard):
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        out[:, perm[lo:hi]] = slab
    return out


def result_sizes(per_shard: list[np.ndarray], k: int) -> np.ndarray:
    """``[Q]`` RkNN result-set sizes via the cross-shard reduction: each
    shard contributes its local ``(counts < k).sum`` partial and the
    partials tree-reduce — the aggregate every shard of a real mesh
    would hold after the ``psum``."""
    partials = [
        (np.asarray(slab) < int(k)).sum(axis=1).astype(np.int64)
        for slab in per_shard
    ]
    return tree_psum(partials)
