"""Partitioning helpers of the port (``repro.distributed``).

Only the user-axis partition of sharded serving is here
(:func:`~repro_torch.distributed.sharding.user_shard_bounds`); the JAX
package's training-mesh rules belong to its LM substrate.
"""
