"""Hand-written CUDA kernels for the verify phase, and their plain versions.

* ``ops``        — public wrappers (``raycast_count``,
                   ``raycast_count_batch``, ``grid_count_cells``,
                   ``grid_count_cells_batch``, ``rank_count``,
                   ``rank_count_batch(_xy)``, ``bvh_count``,
                   ``bvh_count_batch(_stacked)``): kernel on CUDA tensors, plain
                   PyTorch version on CPU tensors
* ``raycast``    — launch of the dense ray-cast count kernel
                   (``csrc/raycast.cu``), one kernel with a query axis
* ``user_order`` — the spatial (Morton) order of the users and the tile
                   boxes that kernel classifies triangles on (the
                   rank-count kernel reads the same order)
* ``grid_raycast`` — the cell bucketing (with the users in Morton order
                   inside each cell and the boxes of the user blocks),
                   the plane packing and list lengths of the grid index,
                   and launch of the cell-bucketed grid count kernel
                   (``csrc/grid_raycast.cu``), one kernel with a query
                   axis and an optional ``base``
* ``rank_count`` — launch of the distance-rank count kernel
                   (``csrc/rank_count.cu``), one kernel with a query
                   axis: the exact on-card oracle and the ``brute``
                   backend's batch
* ``bvh``        — launch of the BVH stack-traversal kernel
                   (``csrc/bvh_traverse.cu``), one thread per (query,
                   user) with an early exit at ``k``, and ``bvh_batch``,
                   the checked, uploaded trees with the depth the walk's
                   stack is checked against
* ``ref``        — the plain PyTorch versions
* ``build``      — ``nvcc`` build of ``csrc/*.cu`` (which share the
                   classifier header ``csrc/tile_class.cuh``) and
                   ``ctypes`` loading

The wrappers are not re-exported here, so ``kernels.rank_count`` always
names the module (and its launch counter), never the function.
"""
