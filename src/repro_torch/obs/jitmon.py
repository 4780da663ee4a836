"""Retrace/compile accounting for jitted entry points (``repro.obs.jitmon``).

Carried over as written.  :func:`track_jit` wraps a callable that exposes
a compilation-cache probe (``_cache_size()``, as a ``jax.jit`` object
does) and, after every call, compares the cache size against the last
observation — growth means this call traced and compiled, so the wrapper
charges the call's wall time to ``compile.time_s{fn=...}`` and bumps
``compile.count{fn=...}`` in the process-wide registry.

The port has no such objects: its CUDA kernels are built once per
process by :mod:`repro_torch.kernels.build` and no engine path goes
through a compile cache.  Any callable without the probe comes back
unchanged, so ``compile.count`` never appears in this package's
registries; the function stays so code written against either package's
``obs`` API runs on both.
"""

from __future__ import annotations

import functools
import time

from .metrics import process_registry

__all__ = ["track_jit"]


def _cache_size(fn) -> int | None:
    probe = getattr(fn, "_cache_size", None)
    if probe is None:
        return None
    try:
        return int(probe())
    except Exception:
        return None


def track_jit(fn, name: str):
    """Wrap a callable with a compile-cache probe; compiles surface as
    ``compile.count{fn}`` and ``compile.time_s{fn}`` in
    :func:`process_registry`.

    Returns ``fn`` unchanged when the probe is unavailable (every callable
    of this package).
    """
    if _cache_size(fn) is None:
        return fn
    reg = process_registry()
    count = reg.counter("compile.count", fn=name)
    time_s = reg.counter("compile.time_s", fn=name)
    state = {"n": _cache_size(fn) or 0}

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        n = _cache_size(fn)
        if n is not None and n > state["n"]:
            count.inc(n - state["n"])
            time_s.inc(time.perf_counter() - t0)
            state["n"] = n
        return out

    wrapper.lower = getattr(fn, "lower", None)
    wrapper.__wrapped_jit__ = fn
    return wrapper
