"""MVCC snapshot isolation of the port's ``DynamicEngine`` under real
thread concurrency, on the CPU (the JAX package's
``tests/test_concurrency.py``, carried over).

A writer thread streams mixed update batches through ``apply_updates``
while reader threads call ``query_batch`` across several backends with
no coordination — no lock, no barrier, no retry loop.  Every result
reports the snapshot version it was served from; each (version, backend)
pair is replayed on a cold port ``RkNNEngine`` built from the arrays
recorded at that version, and must give bit-identical counts and masks.

That equality is the MVCC contract at once: atomicity (a half-applied
update matches no recorded version), no stale mixing (facilities of
version N with users of N+1 match none either) and monotonic publishing
(versions seen by each reader never decrease).  Readers run with their
exceptions captured, so a torn internal state that raises fails the test
too.
"""

import sys
import threading

import numpy as np

from repro_torch.core.engine import RkNNConfig, RkNNEngine
from repro_torch.dynamic import DynamicEngine, UpdateBatch

from tests._torch_parity import CPU

#: Backends the readers rotate through: the plain grid count, the
#: cell-bucketed count (its buckets hold user coordinates), the dense count
#: over the users' order, the BVH walk and the geometry-free brute path —
#: every distinct read-path data dependency of the engine.
READ_BACKENDS = ("grid", "grid-pallas-ref", "dense-ref", "bvh", "brute")

N_BATCHES = 6
N_READERS = 3
K = 4
QS = [3, 11, 7, 0]


def _mixed_batches(F, U, rng):
    """Facility jitter + user drift + user churn, all index-stable for
    facilities so query ids stay comparable across versions."""
    batches = []
    for step in range(N_BATCHES):
        fb = rng.choice(len(F), size=4, replace=False)
        fb = fb[~np.isin(fb, QS)]  # keep query facilities pinned
        fm = (fb, np.clip(F[fb] + rng.normal(0, 0.05, (len(fb), 2)), 0, 1))
        # moves from the top half, deletes from the bottom: disjoint by
        # construction (a row may appear in at most one of move/delete)
        ub = 150 + rng.choice(len(U) - 150, size=10, replace=False)
        um = (ub, rng.random((10, 2)))
        if step % 2 == 0:  # user churn: delete 8, insert 8 (count stable)
            dead = np.arange(8) + 20 * step
            batches.append(
                UpdateBatch(
                    facility_move=fm, user_move=um,
                    user_delete=dead, user_insert=rng.random((8, 2)),
                )
            )
        else:
            batches.append(UpdateBatch(facility_move=fm, user_move=um))
    return batches


def test_concurrent_readers_see_single_consistent_versions():
    rng = np.random.default_rng(77)
    F = rng.random((40, 2))
    F[:4] = [[0.0, 0.0], [0.0, 1.0], [1.0, 0.0], [1.0, 1.0]]  # pin the hull
    U = rng.random((300, 2))
    dyn = DynamicEngine(F, U, RkNNConfig(backend="grid"), device=CPU)
    dyn.query_batch(QS, K)  # warm caches so migration has work to carry

    history = {0: (F.copy(), U.copy())}
    writer_done = threading.Event()
    errors: list[BaseException] = []
    results: list[tuple[int, str, np.ndarray, np.ndarray]] = []
    res_lock = threading.Lock()

    def writer():
        try:
            wrng = np.random.default_rng(5)
            for batch in _mixed_batches(F, U, wrng):
                dyn.apply_updates(batch)
                # sole writer: arrays are stable until OUR next apply
                history[dyn.version] = (dyn.facilities.copy(), dyn.users.copy())
        except BaseException as e:  # pragma: no cover - failure path
            errors.append(e)
        finally:
            writer_done.set()

    def reader(seed):
        try:
            last_seen = -1
            i = seed
            while not writer_done.is_set() or i % len(READ_BACKENDS) != 0:
                backend = READ_BACKENDS[i % len(READ_BACKENDS)]
                i += 1
                r = dyn.query_batch(QS, K, backend=backend)
                assert r.version >= last_seen, "version went backwards"
                last_seen = r.version
                with res_lock:
                    results.append((r.version, backend, np.asarray(r.counts).copy(),
                                    np.asarray(r.masks).copy()))
        except BaseException as e:  # pragma: no cover - failure path
            errors.append(e)

    threads = [threading.Thread(target=writer)] + [
        threading.Thread(target=reader, args=(s,)) for s in range(N_READERS)
    ]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # interleave the threads finely
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads), "deadlocked"
    assert not errors, errors
    assert len(history) == N_BATCHES + 1  # every batch published a version

    versions_seen = sorted({v for v, *_ in results})
    assert versions_seen, "readers never completed a query"
    # every result replays bit-identically on a cold engine at its version
    cold: dict[tuple[int, str], RkNNEngine] = {}
    for version, backend, counts, masks in results:
        assert version in history, f"result reports unknown version {version}"
        key = (version, backend)
        if key not in cold:
            cold[key] = RkNNEngine(*history[version], RkNNConfig(backend=backend), device=CPU)
        want = cold[key].query_batch(QS, K)
        np.testing.assert_array_equal(counts, want.counts, err_msg=f"v{version} {backend} counts")
        np.testing.assert_array_equal(masks, want.masks, err_msg=f"v{version} {backend} masks")
    # the run actually interleaved: readers answered while versions moved
    assert len(versions_seen) >= 2, "no interleaving observed"


def test_reader_holds_old_snapshot_across_update():
    """A reference to ``engine._snap`` taken before an update keeps
    answering from the OLD arrays after the update publishes — readers
    in flight are never migrated onto the new version mid-query."""
    rng = np.random.default_rng(3)
    F = rng.random((30, 2))
    U = rng.random((200, 2))
    dyn = DynamicEngine(F, U, RkNNConfig(backend="grid"), device=CPU)
    old_snap = dyn._snap
    want = dyn.query_batch(QS, K)
    dyn.apply_updates(UpdateBatch(user_move=(np.arange(50), rng.random((50, 2)))))
    assert dyn.version == 1 and old_snap.version == 0
    got = dyn._query_batch(old_snap, QS, K)  # in-flight reader's view
    np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_array_equal(got.masks, want.masks)
    assert got.version == 0  # stamped with the version it was served from
    assert dyn.query_batch(QS, K).version == 1
