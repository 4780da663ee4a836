"""Atomic, versioned checkpointing (``repro.checkpoint.store``, no JAX).

Layout:  ``<dir>/step_<N>/{manifest.json, <leaf-id>.npy...}``
* leaves are path-addressed (stable across tree refactors that keep
  names), saved as host numpy (a tensor leaf as ``.cpu().numpy()``);
* writes go to ``step_<N>.tmp`` then atomically ``rename`` — a crash mid-
  write never corrupts the latest checkpoint (the reader picks the
  newest *complete* step);
* ``AsyncCheckpointer`` overlaps serialization with the caller's next
  steps (one in-flight snapshot, joined before the next save — the
  standard double-buffer policy);
* ``restore_checkpoint`` gives each leaf back as the template's leaf is:
  a numpy array, or a tensor on that leaf's device; with ``into=True`` it
  copies each leaf into the template's own leaf instead (``copy_``), one
  leaf on the host at a time, so a state on the card is restored without
  a second copy of it there.

Trees are nested dicts, lists and tuples, flattened here with the leaf
paths ``jax.tree_util`` gives the same trees (dict keys sorted, each
path element its key or index, joined by ``/``), so a manifest names its
leaves alike in both packages.

The same atomic-rename machinery also backs the *named-category* state
store used by :mod:`repro_torch.persist` (``save_state`` /
``load_state``): a manifest maps category names to per-category
fingerprints, JSON metadata, and ``.npy`` array leaves, so a schema like
``rknn-store/1`` can invalidate one stale category without discarding
the rest.

Completeness contract: a step only counts as restorable when its
manifest exists AND every leaf file the manifest lists is present —
stranded ``step_*.tmp`` leftovers (crash mid-write) and steps whose
leaves were lost (partial copy, interrupted gc) are skipped, never
tripped over.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading

import numpy as np
import torch

__all__ = [
    "save_checkpoint",
    "restore_checkpoint",
    "latest_step",
    "save_state",
    "load_state",
    "load_arrays",
    "AsyncCheckpointer",
]

_SAFE = re.compile(r"[^A-Za-z0-9_.\-]")


def _json_default(o):
    """Manifest metadata tolerates numpy scalars/arrays (PruneStats etc.)."""
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"Object of type {type(o).__name__} is not JSON serializable")


def _paths(tree, prefix: tuple = ()):
    """``(path, leaf)`` pairs of a nested dict / list / tuple tree in
    ``jax.tree_util`` order: dict keys sorted, sequences in order, and
    ``None`` an empty subtree (no leaf)."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _paths(tree[key], prefix + (key,))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _paths(sub, prefix + (i,))
    else:
        yield prefix, tree


def _key(path: tuple) -> str:
    return _SAFE.sub("_", "/".join(str(p) for p in path))


def _flatten(tree):
    return {_key(path): leaf for path, leaf in _paths(tree)}


def _unflatten(tree, leaves):
    """``tree``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        out = {key: _unflatten(tree[key], leaves) for key in sorted(tree)}
        return {key: out[key] for key in tree}
    if isinstance(tree, (list, tuple)):
        items = [_unflatten(sub, leaves) for sub in tree]
        make = getattr(type(tree), "_make", None)
        return make(items) if make is not None else type(tree)(items)
    return next(leaves)


def _host(leaf) -> np.ndarray:
    """A leaf as a host numpy array (a tensor through ``.cpu()``)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _snapshot(leaf) -> np.ndarray:
    """A host copy of a leaf that shares no memory with it: a tensor on a
    card is copied once, to the host; a host tensor or array is copied."""
    if isinstance(leaf, torch.Tensor) and leaf.device.type != "cpu":
        return leaf.detach().cpu().numpy()
    if isinstance(leaf, (torch.Tensor, np.ndarray)):
        return np.array(_host(leaf))
    # any other leaf: a number, or a view such as
    # repro_torch.models.convert.StackedLeaf, makes a new array
    return np.asarray(leaf)


def _write_arrays(folder: str, arrays: dict, *, prefix: str = "") -> dict:
    """Save ``{key: array}`` as ``.npy`` leaves; returns manifest entries."""
    entries = {}
    for key, leaf in arrays.items():
        arr = _host(leaf)
        fn = _SAFE.sub("_", f"{prefix}{key}".replace("/", "__")) + ".npy"
        np.save(os.path.join(folder, fn), arr)
        entries[key] = {
            "file": fn,
            "shape": list(arr.shape),
            "dtype": str(arr.dtype),
        }
    return entries


def _publish(directory: str, tmp: str, final: str, keep: int) -> str:
    """Atomic rename publish + retention gc (shared by both store kinds)."""
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    _gc(directory, keep)
    return final


def save_checkpoint(directory: str, step: int, tree, *, keep: int = 3, extra: dict | None = None) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:012d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": _write_arrays(tmp, _flatten(tree)), "extra": extra or {}}
    # manifest last: its presence marks the leaves as fully written
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, default=_json_default)
    return _publish(directory, tmp, final, keep)


def _gc(directory: str, keep: int) -> None:
    steps = sorted(_all_steps(directory))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:012d}"), ignore_errors=True)


def _manifest_files(manifest: dict):
    """Every leaf filename a manifest references (param-tree ``leaves``
    and named-category ``categories`` layouts alike)."""
    for meta in manifest.get("leaves", {}).values():
        yield meta["file"]
    for cat in manifest.get("categories", {}).values():
        for meta in cat.get("arrays", {}).values():
            yield meta["file"]


def _step_complete(folder: str) -> bool:
    """Manifest present AND every leaf it lists exists on disk."""
    path = os.path.join(folder, "manifest.json")
    try:
        with open(path) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError):
        return False
    return all(
        os.path.exists(os.path.join(folder, fn)) for fn in _manifest_files(manifest)
    )


def _all_steps(directory: str) -> list[int]:
    out = []
    for name in os.listdir(directory):
        # fullmatch excludes stranded ``step_*.tmp`` crash leftovers
        m = re.fullmatch(r"step_(\d+)", name)
        if m and _step_complete(os.path.join(directory, name)):
            out.append(int(m.group(1)))
    return out


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = _all_steps(directory)
    return max(steps) if steps else None


def restore_checkpoint(directory: str, tree_like, step: int | None = None, *,
                       into: bool = False):
    """Restore into the structure of ``tree_like`` (shapes must match).

    Each leaf comes back as ``tree_like``'s leaf is: a tensor leaf as a
    tensor of the stored dtype on that leaf's device, any other leaf as a
    numpy array.  With ``into=True`` each stored leaf is copied into
    ``tree_like``'s leaf in place instead (a numpy array by ``np.copyto``,
    anything else, such as a tensor, by ``leaf.copy_(tensor)``), and
    ``tree_like`` itself is returned.

    With ``step=None`` the newest *complete* step is used — incomplete
    ``.tmp`` leftovers and steps with missing leaf files are skipped.
    An explicitly requested step with a missing leaf raises a
    ``FileNotFoundError`` naming the leaf (not a bare ``np.load`` crash).
    """
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint under {directory}")
    folder = os.path.join(directory, f"step_{step:012d}")
    with open(os.path.join(folder, "manifest.json")) as f:
        manifest = json.load(f)
    flat = list(_paths(tree_like))
    leaves_meta = manifest["leaves"]
    missing = [_key(p) for p, _leaf in flat if _key(p) not in leaves_meta]
    if missing:
        raise KeyError(f"checkpoint missing {len(missing)} leaves, e.g. {missing[:3]}")

    out = []
    for path, leaf in flat:
        key = _key(path)
        leaf_path = os.path.join(folder, leaves_meta[key]["file"])
        if not os.path.exists(leaf_path):
            raise FileNotFoundError(
                f"checkpoint step {step} lists leaf {key!r} but "
                f"{leaves_meta[key]['file']} is missing — the step is "
                f"incomplete (crash mid-write?); restore with step=None "
                f"to fall back to the newest complete step"
            )
        arr = np.load(leaf_path)
        if tuple(arr.shape) != tuple(np.shape(leaf)):
            raise ValueError(f"shape mismatch for {key}: {arr.shape} vs {np.shape(leaf)}")
        if into:
            if isinstance(leaf, np.ndarray):
                np.copyto(leaf, arr)
            else:
                leaf.copy_(torch.from_numpy(arr))
        elif isinstance(leaf, torch.Tensor):
            out.append(torch.from_numpy(arr).to(leaf.device))
        else:
            out.append(arr)
    if into:
        return tree_like, manifest
    return _unflatten(tree_like, iter(out)), manifest


# --------------------------------------------------------------------------
# named-category state store (the repro.persist substrate)
# --------------------------------------------------------------------------


def save_state(
    directory: str,
    step: int,
    categories: dict,
    *,
    schema: str,
    keep: int = 3,
    extra: dict | None = None,
) -> str:
    """Write named state categories atomically as one versioned step.

    ``categories`` maps a category name to ``{"fingerprint": str,
    "meta": dict, "arrays": {key: np.ndarray}}``.  The manifest carries
    the schema string and the per-category fingerprints so a reader can
    invalidate one stale category without touching the rest.
    """
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:012d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"schema": schema, "step": int(step), "categories": {}, "extra": extra or {}}
    for name, cat in categories.items():
        manifest["categories"][name] = {
            "fingerprint": str(cat.get("fingerprint", "")),
            "meta": cat.get("meta", {}),
            "arrays": _write_arrays(tmp, cat.get("arrays") or {}, prefix=f"{name}__"),
        }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, default=_json_default)
    return _publish(directory, tmp, final, keep)


def load_state(
    directory: str, step: int | None = None, *, schema: str | None = None
) -> tuple[dict, str]:
    """Load the manifest of the newest complete step (arrays stay on disk
    — fetch per category with :func:`load_arrays`).  Returns
    ``(manifest, folder)``.  ``schema`` (when given) must match the
    stored schema string exactly — a future-major store is rejected
    rather than misread."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no complete state store under {directory}")
    folder = os.path.join(directory, f"step_{step:012d}")
    with open(os.path.join(folder, "manifest.json")) as f:
        manifest = json.load(f)
    if schema is not None and manifest.get("schema") != schema:
        raise ValueError(
            f"state store schema {manifest.get('schema')!r} does not match "
            f"expected {schema!r}"
        )
    return manifest, folder


def load_arrays(folder: str, entry: dict) -> dict:
    """Materialize one category's arrays (host numpy) from its manifest
    entry."""
    out = {}
    for key, meta in entry.get("arrays", {}).items():
        out[key] = np.load(os.path.join(folder, meta["file"]))
    return out


class AsyncCheckpointer:
    """One-in-flight background checkpoint writer."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, step: int, tree, extra: dict | None = None) -> int:
        """Copies ``tree`` to the host and writes it in the background;
        returns the bytes copied."""
        self.wait()
        # snapshot before async: copies, so later in-place writes to the
        # caller's arrays or tensors cannot reach the background writer
        leaves = [_snapshot(leaf) for _path, leaf in _paths(tree)]
        host_tree = _unflatten(tree, iter(leaves))

        def _run():
            try:
                save_checkpoint(self.directory, step, host_tree, keep=self.keep, extra=extra)
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()
        return sum(a.nbytes for a in leaves)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
