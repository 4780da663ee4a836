"""RT-RkNN core in PyTorch: the port of ``repro.core``.

Public surface:
  * :class:`repro_torch.core.engine.RkNNEngine` — stateful query engine
    (build once from ``(facilities, users, RkNNConfig)``;
    query/batch/mono/stream), on ``device`` (default ``"cuda"``)
  * :mod:`repro_torch.core.backends` — verification backend registry
    (``dense``, ``dense-ref``, ``grid``, ``grid-pallas``,
    ``grid-pallas-ref``, ``brute``)
  * :func:`repro_torch.core.rknn.rt_rknn_query` — one-shot bichromatic shim
  * :func:`repro_torch.core.rknn.rt_rknn_query_batch` — one-shot batched shim
  * :func:`repro_torch.core.rknn.rknn_mono_query` — monochromatic variant
  * :mod:`repro_torch.core.scene` — per-query occluder scene construction
  * :mod:`repro_torch.core.grid` — the uniform-grid occluder index
  * :func:`scene_from_arrays`, :func:`grid_from_arrays` — a scene or grid
    index of this package from another package's arrays
"""

from repro_torch.core.backends import (
    Backend,
    available_backends,
    get_backend,
    register_backend,
)
from repro_torch.core.engine import EngineStats, RkNNConfig, RkNNEngine
from repro_torch.core.geometry import Rect
from repro_torch.core.grid import grid_from_arrays
from repro_torch.core.rknn import (
    BACKENDS,
    RkNNBatchResult,
    RkNNResult,
    rknn_mono_query,
    rt_rknn_query,
    rt_rknn_query_batch,
)
from repro_torch.core.scene import Scene, build_scene, scene_from_arrays

__all__ = [
    "Rect",
    "Scene",
    "build_scene",
    "scene_from_arrays",
    "grid_from_arrays",
    "RkNNEngine",
    "RkNNConfig",
    "EngineStats",
    "Backend",
    "register_backend",
    "get_backend",
    "available_backends",
    "rt_rknn_query",
    "rt_rknn_query_batch",
    "rknn_mono_query",
    "RkNNResult",
    "RkNNBatchResult",
    "BACKENDS",
]
