"""Atomic, versioned checkpoints and the named-category state store
(:mod:`.store`; the port of ``repro.checkpoint``, with no JAX)."""

from .store import (
    AsyncCheckpointer,
    latest_step,
    load_arrays,
    load_state,
    restore_checkpoint,
    save_checkpoint,
    save_state,
)

__all__ = [
    "save_checkpoint",
    "restore_checkpoint",
    "latest_step",
    "save_state",
    "load_state",
    "load_arrays",
    "AsyncCheckpointer",
]
