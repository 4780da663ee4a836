"""The user-axis partition of sharded serving (``repro.distributed.sharding``).

Carried over from the JAX package as host numpy: only
:func:`user_shard_bounds`, which :mod:`repro_torch.shard` and its
equivalence tests share.  The rest of that module (parameter, batch and
cache shardings of the training mesh) belongs to the LM substrate.
"""

from __future__ import annotations

import numpy as np

__all__ = ["user_shard_bounds"]


def user_shard_bounds(n_users: int, n_shards: int) -> np.ndarray:
    """``[S+1]`` int64 balanced contiguous cut points of ``n_users`` rows.

    The canonical user-axis partition shared by :mod:`repro_torch.shard`
    and its equivalence tests: shard ``s`` owns rows ``[bounds[s],
    bounds[s+1])`` of whatever ordering the caller shards (the sharded
    engine applies it to the *spatially sorted* permutation, so each
    shard covers a contiguous region of grid cells).  Balanced to within
    one row, monotone, ``bounds[0] == 0`` and ``bounds[S] == n_users``.
    """
    s = max(int(n_shards), 1)
    return (np.arange(s + 1, dtype=np.int64) * int(n_users)) // s
