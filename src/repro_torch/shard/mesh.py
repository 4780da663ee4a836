"""Device meshes for user-axis sharded serving (``repro.shard.mesh``).

The sharded engine partitions the *user* population over a 1-D mesh whose
single axis is named ``'users'``.  The JAX package builds a
``jax.sharding.Mesh``; here a :class:`UserMesh` is a tuple of
``torch.device``\\ s with the same ``axis_names`` and ``shape``.

On a host with fewer cards than shards, :func:`shard_devices` cycles the
visible cards, so one card serves every shard count: the partition, the
per-shard compaction and the bit-identical reassembly are all kept; only
the physical parallelism collapses onto the shared card.  With
``device="cpu"`` every shard is placed on the CPU (the plain PyTorch
versions, as the parity tests run them).
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device

__all__ = ["UserMesh", "user_mesh", "mesh_shards", "shard_devices"]


class UserMesh:
    """A 1-D ``('users',)`` mesh: one ``torch.device`` per shard.

    Unlike a jax ``Mesh`` it may repeat a device (the CPU has one), so a
    test can cut users into several slabs on the host."""

    __slots__ = ("devices",)
    axis_names = ("users",)

    def __init__(self, devices):
        devs = tuple(torch.device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        self.devices = devs

    @property
    def shape(self) -> dict:
        return {"users": len(self.devices)}

    def __repr__(self) -> str:
        return f"UserMesh({[str(d) for d in self.devices]})"


def _visible_cards() -> list[torch.device]:
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def user_mesh(n_shards: int | None = None, devices=None) -> UserMesh:
    """A 1-D ``('users',)`` mesh over ``n_shards`` devices.

    ``devices=None`` takes the visible cards ``cuda:i``; ``n_shards=None``
    takes every device.  Raises if fewer devices exist than shards
    requested, as the JAX package does; pass ``shards=`` to
    :class:`repro_torch.shard.ShardedEngine` instead when oversubscribing
    one card is the intent.
    """
    devs = list(devices) if devices is not None else _visible_cards()
    n = len(devs) if n_shards is None else int(n_shards)
    if n < 1:
        raise ValueError(f"need at least one shard, got {n}")
    if n > len(devs):
        raise ValueError(
            f"user_mesh: {n} shards requested but only {len(devs)} device(s) "
            "visible; pass shards= to ShardedEngine to oversubscribe"
        )
    return UserMesh(devs[:n])


def mesh_shards(mesh: UserMesh) -> int:
    """Shard count of a serving mesh (the size of its ``'users'`` axis)."""
    if "users" not in mesh.axis_names:
        raise ValueError(
            f"expected a ('users',) serving mesh, got axes {mesh.axis_names}"
        )
    return int(mesh.shape["users"])


def shard_devices(
    n_shards: int, mesh: UserMesh | None = None, device=None
) -> list[torch.device]:
    """One device per shard.

    From a mesh: its ``'users'`` axis devices.  Without one: ``device``
    ``None`` or ``"cuda"`` cycles the visible cards (raising, as every
    entry point does, when there is none); a device with an index, or
    ``"cpu"``, holds every shard.
    """
    if mesh is not None:
        devs = list(mesh.devices)
        if len(devs) != n_shards:
            raise ValueError(
                f"mesh has {len(devs)} devices but {n_shards} shards requested"
            )
        return devs
    dev = resolve_device(device)
    if dev.type == "cuda" and (device is None or torch.device(device).index is None):
        cards = _visible_cards()
        return [cards[i % len(cards)] for i in range(int(n_shards))]
    return [dev] * int(n_shards)
