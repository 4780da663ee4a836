"""Plain PyTorch versions of the CUDA kernels (``repro.kernels.ref``).

These run on tensors of any device.  On the CPU they are the path every
kernel wrapper takes (the parity tests hold them against the JAX
package); on the card they are what the kernels are compared with.  They
repeat the kernels' arithmetic and are no yardstick of speed.

Rounding contract: edge functions are evaluated as
``((x * a) + (y * b)) + c`` and squared distances as
``(dx * dx) + (dy * dy)``, one rounding per operation and no fused
multiply-add, exactly as ``repro_torch/csrc/*.cu`` writes them.

``calls`` counts calls into this module's functions, so a run can show
that it took no plain version.
"""

from __future__ import annotations

import torch

__all__ = [
    "raycast_count_ref",
    "raycast_count_batch_ref",
    "rank_count_ref",
    "rank_count_batch_ref",
]

#: Number of calls into the plain versions since the last reset to 0.
calls = 0


def _count() -> None:
    global calls
    calls += 1


def _edge(xs, ys, coeffs, i: int):
    """``e_i = ((x * a_i) + (y * b_i)) + c_i`` broadcast to ``[..., N, M]``."""
    a = coeffs[..., None, :, i, 0]
    b = coeffs[..., None, :, i, 1]
    c = coeffs[..., None, :, i, 2]
    return (xs[:, None] * a + ys[:, None] * b) + c


def raycast_count_batch_ref(xs, ys, coeffs):
    """Batched hit counts: ``xs, ys`` ``[N]`` f32 shared users, ``coeffs``
    ``[Q, Mp, 3, 3]`` f32 per-query edge functions (padding degenerate).
    Returns ``[Q, N]`` int32: per (query, user), the number of that query's
    triangles with all three ``a x + b y + c >= 0``."""
    _count()
    inside = _edge(xs, ys, coeffs, 0) >= 0.0
    inside &= _edge(xs, ys, coeffs, 1) >= 0.0
    inside &= _edge(xs, ys, coeffs, 2) >= 0.0
    return inside.sum(dim=-1, dtype=torch.int32)


def raycast_count_ref(xs, ys, coeffs):
    """Single-query hit counts: ``coeffs`` ``[M, 3, 3]`` → ``[N]`` int32."""
    return raycast_count_batch_ref(xs, ys, coeffs[None])[0]


def rank_count_ref(xs, ys, fx, fy, thr):
    """Distance-rank counts: per user, facilities with
    ``(x - fx)^2 + (y - fy)^2 < thr``.  ``xs, ys, thr`` ``[N]``; ``fx, fy``
    ``[M]`` (a facility at +inf is never closer).  Returns ``[N]`` int32."""
    _count()
    dx = xs[:, None] - fx[None, :]
    dy = ys[:, None] - fy[None, :]
    return (dx * dx + dy * dy < thr[:, None]).sum(dim=-1, dtype=torch.int32)


def rank_count_batch_ref(xs, ys, fx, fy, thr):
    """Batched distance-rank counts: ``fx, fy`` ``[Q, M]`` per-query
    facilities, ``thr`` ``[Q, N]``.  Returns ``[Q, N]`` int32."""
    _count()
    dx = xs[None, :, None] - fx[:, None, :]
    dy = ys[None, :, None] - fy[:, None, :]
    return (dx * dx + dy * dy < thr[:, :, None]).sum(dim=-1, dtype=torch.int32)
