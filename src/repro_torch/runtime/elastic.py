"""Elastic re-meshing after node loss (``repro.runtime.elastic``).

Policy: given the surviving device set, pick the largest mesh of shape
``(data', model)`` such that ``model`` keeps the tensor-parallel degree if
possible (parameters re-shard cheaply along data) and the global batch
still divides ``data'``.  State migrates through the checkpoint's
path-addressed format: a restore after the re-mesh is the normal restart
flow (:mod:`repro_torch.runtime.driver` wires the two together).

Where the JAX package builds a ``jax.sharding.Mesh``, :func:`build_remesh`
returns a :class:`DeviceMesh`: ``torch.device``\\ s in a numpy object array
of the plan's shape, with the same ``axis_names`` and ``shape``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["ElasticPlan", "DeviceMesh", "plan_remesh", "build_remesh"]


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    data: int
    model: int
    n_used: int
    n_alive: int
    dropped_batch_rows: int  # if the global batch had to shrink

    @property
    def shape(self) -> tuple[int, int]:
        return (self.data, self.model)


class DeviceMesh:
    """A 2-D ``("data", "model")`` mesh: ``devices`` is a numpy object
    array of ``torch.device``\\ s of shape ``(data, model)``."""

    __slots__ = ("devices",)
    axis_names = ("data", "model")

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2:
            raise ValueError(f"a ('data', 'model') mesh needs a 2-D device array, "
                             f"got shape {devices.shape}")
        self.devices = devices

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        return f"DeviceMesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def plan_remesh(
    n_alive: int,
    *,
    prefer_model: int = 16,
    global_batch: int = 256,
    min_model: int = 1,
) -> ElasticPlan:
    """Largest usable (data, model) grid from ``n_alive`` devices."""
    # The model degree is a memory-fit requirement (parameters are
    # model-sharded), so keep it whenever possible and halve it only when
    # the survivors cannot fill one model group; the batch, not the device
    # count, absorbs the remainder (trimmed to a multiple of the data degree).
    model = prefer_model
    while model > min_model and n_alive < model:
        model //= 2
    data = max(n_alive // model, 1)
    batch_kept = (global_batch // data) * data if data <= global_batch else global_batch
    dropped = max(global_batch - batch_kept, 0)
    return ElasticPlan(data, model, data * model, n_alive, dropped)


def build_remesh(plan: ElasticPlan, devices=None) -> DeviceMesh:
    """The plan's mesh over the first ``data * model`` of ``devices``
    (``torch.device``\\ s or names; ``None`` takes the visible cards).
    Raises ``RuntimeError`` when there are fewer."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = plan.data * plan.model
    if len(devices) < n:
        raise RuntimeError(f"need {n} devices, have {len(devices)}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    return DeviceMesh(arr.reshape(plan.data, plan.model))
