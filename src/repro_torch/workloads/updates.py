"""Update-stream scenario generators for the dynamic subsystem
(``repro.workloads.updates``).

The dynamic engine's refit ladder only pays off on realistic churn
shapes, so these generators produce the regimes the update benchmarks
and tests drive:

* :func:`drifting_users` — a fraction of users random-walks each step
  (the ROADMAP's "millions of users move" serving regime).  Drift is
  confined to the interior of the initial hull and hull-extreme users
  are never moved, so the shared domain rect provably survives every
  step — the precondition for scenes surviving untouched.
* :func:`facility_churn` — facilities close and open each step (delete
  + insert at a fresh location), optionally away from a protected id
  set (the standing queries).
* :func:`facility_jitter` — small in-place facility perturbations, the
  scene/BVH *refit* showcase: kept sets stay stable, only occluder fans
  move.

All streams are deterministic by seed and return plain lists of
:class:`~repro_torch.dynamic.updates.UpdateBatch`.
"""

from __future__ import annotations

import numpy as np

from repro_torch.dynamic.updates import UpdateBatch

__all__ = ["drifting_users", "facility_churn", "facility_jitter"]


def _interior_candidates(points: np.ndarray, lo: np.ndarray, hi: np.ndarray):
    """Rows strictly inside the hull — moving one can never shrink it."""
    pts = np.asarray(points, np.float64)
    return np.flatnonzero(np.all((pts > lo) & (pts < hi), axis=1))


def drifting_users(
    users: np.ndarray,
    *,
    steps: int,
    frac: float = 0.05,
    sigma: float = 0.01,
    seed: int = 0,
    bounds: tuple[np.ndarray, np.ndarray] | None = None,
) -> list[UpdateBatch]:
    """``steps`` hull-preserving user random-walk deltas.

    Each step moves ``frac`` of the users by Gaussian noise of scale
    ``sigma`` (in domain units), clipped strictly inside ``bounds``
    (default: the initial user hull).  The stream is stateful — step
    ``i+1`` drifts from the positions step ``i`` produced.
    """
    users = np.asarray(users, dtype=np.float64).copy()
    rng = np.random.default_rng(seed)
    if bounds is None:
        lo, hi = users.min(axis=0), users.max(axis=0)
    else:
        lo, hi = (np.asarray(b, np.float64) for b in bounds)
    pad = 1e-9 * np.maximum(hi - lo, 1.0)
    out = []
    n_move = max(int(len(users) * frac), 1)
    for _ in range(steps):
        cand = _interior_candidates(users, lo, hi)
        if not len(cand):
            out.append(UpdateBatch())
            continue
        ids = rng.choice(cand, size=min(n_move, len(cand)), replace=False)
        pts = users[ids] + rng.normal(0.0, sigma, (len(ids), 2))
        pts = np.clip(pts, lo + pad, hi - pad)
        users[ids] = pts
        out.append(UpdateBatch(user_move=(ids, pts)))
    return out


def facility_churn(
    facilities: np.ndarray,
    *,
    steps: int,
    rate: float = 0.02,
    seed: int = 0,
    protect: np.ndarray | None = None,
) -> list[UpdateBatch]:
    """``steps`` facility open/close deltas at churn ``rate`` per step.

    Each step deletes ``rate·|F|`` random unprotected facilities and
    inserts the same number uniformly inside the initial facility hull,
    keeping ``|F|`` constant.  ``protect`` rows (e.g. standing query
    facilities) are never deleted; ids are tracked across steps as
    deletions shift rows.
    """
    facilities = np.asarray(facilities, dtype=np.float64).copy()
    rng = np.random.default_rng(seed)
    lo, hi = facilities.min(axis=0), facilities.max(axis=0)
    protected = (
        np.asarray(protect, np.int64).copy() if protect is not None else np.zeros(0, np.int64)
    )
    n_churn = max(int(len(facilities) * rate), 1)
    out = []
    for _ in range(steps):
        cand = np.setdiff1d(np.arange(len(facilities)), protected)
        dele = rng.choice(cand, size=min(n_churn, len(cand)), replace=False)
        ins = rng.uniform(lo, hi, (len(dele), 2))
        out.append(UpdateBatch(facility_delete=dele, facility_insert=ins))
        alive = np.ones(len(facilities), bool)
        alive[dele] = False
        index_map = np.cumsum(alive) - 1
        protected = index_map[protected]  # protected rows survive by choice
        facilities = np.concatenate([facilities[alive], ins])
    return out


def facility_jitter(
    facilities: np.ndarray,
    *,
    steps: int,
    frac: float = 0.05,
    sigma: float = 1e-4,
    seed: int = 0,
    protect: np.ndarray | None = None,
) -> list[UpdateBatch]:
    """``steps`` small in-place facility perturbations (the refit regime).

    ``sigma`` defaults tiny relative to typical facility spacing so kept
    occluder sets stay stable and the scene-refit fast path applies; the
    moves are hull-preserving like :func:`drifting_users`.
    """
    facilities = np.asarray(facilities, dtype=np.float64).copy()
    rng = np.random.default_rng(seed)
    lo, hi = facilities.min(axis=0), facilities.max(axis=0)
    pad = 1e-9 * np.maximum(hi - lo, 1.0)
    protected = set(
        int(i) for i in (protect if protect is not None else np.zeros(0, np.int64))
    )
    n_move = max(int(len(facilities) * frac), 1)
    out = []
    for _ in range(steps):
        cand = np.array(
            [i for i in _interior_candidates(facilities, lo, hi) if i not in protected],
            np.int64,
        )
        if not len(cand):
            out.append(UpdateBatch())
            continue
        ids = rng.choice(cand, size=min(n_move, len(cand)), replace=False)
        pts = np.clip(
            facilities[ids] + rng.normal(0.0, sigma, (len(ids), 2)),
            lo + pad,
            hi - pad,
        )
        facilities[ids] = pts
        out.append(UpdateBatch(facility_move=(ids, pts)))
    return out
