"""User-axis sharded RkNN serving (``repro.shard``).

Quickstart (one card serves every shard count; ``device="cpu"`` runs the
plain PyTorch versions on the host)::

    from repro_torch.shard import ShardedEngine, user_mesh

    eng = ShardedEngine(facilities, users, shards=4)
    masks = eng.query_batch(queries, k=10).masks   # bit-identical to RkNNEngine

Every shard holds its users on its device; the counts of a batch are
reassembled on the first shard's device and copied back once.  Per-shard
state swaps with the engine's snapshot as one object (the
version-lockstep rule).
"""

from repro_torch.shard.engine import ShardDispatch, ShardedEngine, ShardState, ShardView
from repro_torch.shard.mesh import UserMesh, mesh_shards, shard_devices, user_mesh
from repro_torch.shard.reduce import assemble_counts, result_sizes, tree_psum

__all__ = [
    "ShardedEngine",
    "ShardDispatch",
    "ShardState",
    "ShardView",
    "user_mesh",
    "mesh_shards",
    "shard_devices",
    "tree_psum",
    "assemble_counts",
    "result_sizes",
    "UserMesh",
]
