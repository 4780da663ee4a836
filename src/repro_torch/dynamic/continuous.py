"""Standing RkNN queries maintained across snapshot updates
(``repro.dynamic.continuous``).

A :class:`ContinuousQuery` is registered once on a
:class:`~repro_torch.dynamic.engine.DynamicEngine` and re-evaluated **only**
when an update could change its result, streaming ``(version,
RkNNResult)`` pairs through :meth:`poll`.

Maintenance is exact and incremental, in brute (distance-rank) count
semantics — the one convention every backend's *mask* agrees with:

* the **influence zone** of query ``q`` is bounded by ``2·max_u d(u, q)``
  (a facility at ``p`` can steal a user ``u`` from ``q`` only if
  ``d(u, p) < d(u, q)``, and the triangle inequality gives
  ``d(p, q) < 2·d(u, q)``).  A facility change strictly outside that
  radius is *skipped* — no distances against the user set are computed;
* a facility change inside it touches exactly the users in the bisector
  half-plane ``{u : d(u, p) < d(u, q)}`` — counts are patched by ±1 on
  that dirty region (the same strict-``<`` expanded-form arithmetic as
  :func:`repro_torch.core.brute.rank_counts_np`, so patched counts equal a
  cold recount bitwise);
* user moves/inserts recount only the touched rows against the facility
  set; deletes drop rows;
* moving or deleting the query's own facility falls back to a full
  recount (the influence geometry itself changed) — deletion kills the
  handle (``alive = False``).

An event is emitted only when the membership mask actually changed.
"""

from __future__ import annotations

import collections
import time

import numpy as np

from repro_torch.core.brute import rank_counts_np
from repro_torch.core.results import RkNNResult

__all__ = ["ContinuousQuery", "influence_dirty_mask"]


def influence_dirty_mask(handles, changed_pos: np.ndarray) -> np.ndarray:
    """One vectorized influence-zone dirty test across all live handles.

    ``changed_pos`` is the ``[C, 2]`` set of facility positions a
    facility-only update touches (both endpoints of moves, deleted rows,
    inserts).  Returns ``[H]`` bool: True when any changed position lies
    strictly inside the handle's influence radius — exactly the per-handle
    :meth:`ContinuousQuery._patch_facility` distance test, batched into
    one ``[H, C]`` distance matrix so thousands of standing queries pay
    one numpy pass per update instead of a Python loop each.
    """
    if not len(handles) or not len(changed_pos):
        return np.zeros(len(handles), bool)
    q_pts = np.stack([h.q_pt for h in handles])  # [H, 2]
    infl = np.array([h._influence for h in handles])  # [H]
    d = np.linalg.norm(
        np.asarray(changed_pos, np.float64)[None, :, :] - q_pts[:, None, :], axis=-1
    )  # [H, C]
    return (d < infl[:, None]).any(axis=1)


def _d2(users: np.ndarray, p: np.ndarray) -> np.ndarray:
    """Squared distances in the same expanded form as ``rank_counts_np``
    (bitwise-matching its comparisons matters more than elegance here)."""
    return (
        np.sum(users**2, axis=1) - 2.0 * (users @ np.asarray(p, np.float64)) + p @ p
    )


class ContinuousQuery:
    """A standing RkNN query; constructed via
    :meth:`repro_torch.dynamic.engine.DynamicEngine.register_continuous`."""

    def __init__(
        self,
        facilities: np.ndarray,
        users: np.ndarray,
        q: int | np.ndarray,
        k: int,
        version: int,
    ):
        arr = np.asarray(q)
        if arr.ndim == 0 and np.issubdtype(arr.dtype, np.integer):
            self.q_idx: int | None = int(arr)
            self.q_pt = np.asarray(facilities, np.float64)[self.q_idx].copy()
        else:
            self.q_idx = None
            self.q_pt = np.asarray(q, np.float64).reshape(2)
        self.k = int(k)
        self.alive = True
        self.version = version
        self._events: "collections.deque[tuple[int, RkNNResult]]" = (
            collections.deque(maxlen=256)
        )
        self.n_skipped = 0  # updates provably outside the influence zone
        self.n_patched = 0  # incremental half-plane patches
        self.n_full = 0  # full recounts
        self.n_events = 0  # change events ever emitted (monotone)
        self.events_dropped = 0  # evicted unpolled events (slow consumer)
        self._recount(facilities, users)

    # ------------------------------------------------------------------
    # public surface
    # ------------------------------------------------------------------
    @property
    def mask(self) -> np.ndarray:
        """Current membership mask ``[N]`` (copy)."""
        return self._counts < self.k

    @property
    def counts(self) -> np.ndarray:
        """Current exact closer-facility counts ``[N]`` (copy)."""
        return self._counts.copy()

    def result(self) -> RkNNResult:
        return RkNNResult(
            mask=self.mask,
            counts=self._counts.astype(np.int32),
            scene=None,
            t_filter_s=0.0,
            t_verify_s=0.0,
            backend="continuous",
        )

    def poll(self) -> list[tuple[int, RkNNResult]]:
        """Drain the pending ``(version, RkNNResult)`` change events.

        The buffer holds the newest 256 events; a consumer that falls
        further behind loses the oldest transitions — ``events_dropped``
        counts them (the *current* result is always :attr:`mask`).
        """
        out = list(self._events)
        self._events.clear()
        return out

    def close(self) -> None:
        """Stop maintaining this handle; the engine drops it on the next
        update.  Abandoned handles otherwise patch counts forever."""
        self.alive = False
        self._events.clear()

    # ------------------------------------------------------------------
    # maintenance (driven by DynamicEngine.apply_updates)
    # ------------------------------------------------------------------
    def _set_users(self, users: np.ndarray) -> None:
        # d2q uses the same DIRECT form as rank_counts_np's reference
        # distance (not the expanded form) so patched comparisons are
        # bitwise-identical to a cold recount's
        users = np.asarray(users, np.float64)
        self._d2q = np.sum((users - self.q_pt) ** 2, axis=1)
        self._influence = (
            2.0 * float(np.sqrt(max(self._d2q.max(), 0.0))) if len(self._d2q) else 0.0
        )

    def _recount(self, facilities: np.ndarray, users: np.ndarray) -> None:
        self._counts = rank_counts_np(users, facilities, self.q_pt, exclude=self.q_idx)
        self._set_users(users)

    def _patch_facility(self, users: np.ndarray, p: np.ndarray, delta: int) -> bool:
        """±1 the counts of users strictly closer to ``p`` than to ``q``.
        Returns False when ``p`` is provably outside the influence zone."""
        p = np.asarray(p, np.float64)
        if float(np.linalg.norm(p - self.q_pt)) >= self._influence:
            return False
        aff = _d2(users, p) < self._d2q
        if aff.any():
            self._counts[aff] += delta
        return True

    def _on_update_clean(self, ctx, had_facility_changes: bool) -> None:
        """Close out an update the batched influence-zone test proved
        cannot touch this handle: remap the tracked facility row through
        the update's id map and count the skip — bit-identical to what
        :meth:`_on_update` would have done, minus the per-position
        distance loop.  Only valid for facility-only deltas where the
        handle's own facility neither moved nor died (the engine's
        batched test forces those handles onto the exact path).
        """
        if not self.alive:
            return
        if self.q_idx is not None:
            self.q_idx = int(ctx.map_f[self.q_idx])
        if had_facility_changes:
            self.n_skipped += 1
        self.version = ctx.version

    def _on_update(self, ctx) -> None:
        """Apply one update (ctx is the engine's ``_UpdateContext``)."""
        if not self.alive:
            return
        t0 = time.perf_counter()
        old_mask = self._counts < self.k
        batch = ctx.batch
        full = False

        if self.q_idx is not None:
            new_idx = int(ctx.map_f[self.q_idx])
            if new_idx < 0:
                self.alive = False
                self.version = ctx.version
                return
            if len(batch.facility_move[0]) and np.any(
                batch.facility_move[0] == self.q_idx
            ):
                full = True  # the query facility itself moved
                self.q_pt = np.asarray(ctx.new_facilities, np.float64)[new_idx].copy()
            self.q_idx = new_idx

        if not full:
            old_users = np.asarray(ctx.old_users, np.float64)
            # facility-side patches against the (unchanged) old user rows
            mv_ids, mv_pts = batch.facility_move
            touched = skipped = 0
            for pos, delta in (
                *(
                    (np.asarray(ctx.old_facilities, np.float64)[i], -1)
                    for i in np.concatenate([batch.facility_delete, mv_ids])
                ),
                *((p, +1) for p in np.concatenate([mv_pts, batch.facility_insert])),
            ):
                if self._patch_facility(old_users, pos, delta):
                    touched += 1
                else:
                    skipped += 1
            if touched:
                self.n_patched += 1
            if skipped and not touched:
                self.n_skipped += 1

            # user-side maintenance against the NEW facility set
            new_f = np.asarray(ctx.new_facilities, np.float64)
            u_mv_ids, _ = batch.user_move
            if len(u_mv_ids) or len(batch.user_delete) or len(batch.user_insert):
                new_users = np.asarray(ctx.new_users, np.float64)
                counts = self._counts
                if len(u_mv_ids):
                    counts = counts.copy()
                    moved_rows = ctx.map_u[u_mv_ids]
                    # recount moved users at their new positions
                    counts[u_mv_ids] = rank_counts_np(
                        new_users[moved_rows], new_f, self.q_pt, exclude=self.q_idx
                    )
                alive_u = ctx.map_u >= 0
                counts = counts[alive_u]
                if len(batch.user_insert):
                    fresh = rank_counts_np(
                        new_users[len(counts):], new_f, self.q_pt, exclude=self.q_idx
                    )
                    counts = np.concatenate([counts, fresh])
                self._counts = counts
                self._set_users(new_users)

        if full:
            self.n_full += 1
            self._recount(ctx.new_facilities, ctx.new_users)

        self.version = ctx.version
        new_mask = self._counts < self.k
        if len(new_mask) != len(old_mask) or not np.array_equal(new_mask, old_mask):
            self.n_events += 1
            if len(self._events) == self._events.maxlen:
                self.events_dropped += 1
            self._events.append(
                (
                    ctx.version,
                    RkNNResult(
                        mask=new_mask.copy(),
                        counts=self._counts.astype(np.int32),
                        scene=None,
                        t_filter_s=0.0,
                        t_verify_s=time.perf_counter() - t0,
                        backend="continuous",
                    ),
                )
            )
