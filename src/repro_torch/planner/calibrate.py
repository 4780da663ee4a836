"""On-device calibration: micro-benchmark every backend, fit cost models.

The port of ``repro.planner.calibrate``.  For each shape in the synthetic
calibration grid (:func:`repro_torch.workloads.calibration_grid`) and each
timeable concrete backend (:func:`repro_torch.core.backends.
timeable_backends` of the device: on a CUDA device the kernel backends and
``grid``, ``bvh``, ``brute``, never a plain twin), a throwaway one-shot
engine on ``device`` runs the batched query and reports the paper's
two-phase split — host filter time and device verify time — which become
the fit targets for that backend's
:class:`~repro_torch.planner.models.BackendCostModel`.  SLICE (not a
registered backend — the filter–refine baseline the hybrid frontier
compares against, host numpy in both packages) is measured alongside so
:func:`repro_torch.core.hybrid.choose_engine` can price it from the same
profile.

Each (shape, backend) cell is warmed once before timing so kernel builds
and first launches do not land in the fit, and the best of ``repeats``
runs is kept (micro-benchmark convention; scheduler noise only ever adds
time).  The one-shot shim builds a fresh engine per call, so ``t_verify_s``
includes the upload of the users and, for the kernel backends, their
spatial order: the JAX measurement's meaning, kept for parity.

CLI (it times the card)::

    PYTHONPATH=src python -m repro_torch.planner.calibrate \
        --out planner_profile.json [--full] [--repeats 2] [--activate] \
        [--runner-store DIR] [-v]

With no ``--out`` the profile is written to the default store
(:func:`repro_torch.planner.profiles.default_profile_path`).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from repro_torch.planner.models import BackendCostModel, WorkloadShape
from repro_torch.planner.profiles import (
    PROFILE_VERSION,
    PlannerProfile,
    default_profile_path,
    hardware_fingerprint,
    runner_profile_path,
    set_active_profile,
)
from repro_torch.workloads import Scenario, Workload, calibration_grid

__all__ = ["calibrate", "measure_backend", "measure_slice", "main"]


def _mean_scene_tris(w: Workload) -> float:
    """Mean occluder-scene triangle count over the workload's queries."""
    from repro_torch.core.geometry import Rect
    from repro_torch.core.scene import build_scene

    rect = Rect.from_points(w.facilities, w.users)
    sizes = [
        build_scene(w.facilities, qi, w.k, rect, users_hint=w.users).n_tris
        for qi in w.qs
    ]
    return float(max(np.mean(sizes), 1.0))


def _measured_pw(w: Workload, grid_g: int = 64) -> float:
    """Exact cell-bucketing pad-waste ratio of the workload's users."""
    from repro_torch.core.geometry import Rect
    from repro_torch.kernels.grid_raycast import measured_pad_waste

    rect = Rect.from_points(w.facilities, w.users)
    return measured_pad_waste(w.users[:, 0], w.users[:, 1], rect, grid_g)


def measure_backend(
    w: Workload, backend: str, repeats: int = 2, *, device=None
) -> tuple[float, float]:
    """(t_filter_s, t_verify_s) for one batched call of ``backend`` on
    ``device`` (``None``: CUDA)."""
    from repro_torch.core.rknn import rt_rknn_query_batch

    def once():
        return rt_rknn_query_batch(
            w.facilities, w.users, w.qs, w.k, backend=backend, device=device
        )

    once()  # warm
    best = (np.inf, np.inf)
    for _ in range(max(repeats, 1)):
        r = once()
        if r.t_filter_s + r.t_verify_s < sum(best):
            best = (r.t_filter_s, r.t_verify_s)
    return best


def measure_slice(w: Workload, repeats: int = 2) -> tuple[float, float]:
    """(t_filter_s, t_verify_s) of SLICE looped over the batch's queries."""
    from repro_torch.core.baselines.slice import slice_rknn

    best = (np.inf, np.inf)
    for _ in range(max(repeats, 1)):
        tf = tv = 0.0
        for qi in w.qs:
            _, info = slice_rknn(w.facilities, w.users, qi, w.k)
            tf += info.get("t_filter_s", 0.0)
            tv += info.get("t_verify_s", 0.0)
        if tf + tv < sum(best):
            best = (tf, tv)
    return best


def calibrate(
    backends: tuple[str, ...] | None = None,
    *,
    scenarios: list[Scenario] | None = None,
    fast: bool = True,
    repeats: int = 2,
    include_slice: bool = True,
    seed: int = 0,
    verbose: bool = False,
    device=None,
) -> PlannerProfile:
    """Micro-benchmark ``backends`` on ``device`` (``None``: CUDA, which
    raises without a card) over the shape grid and fit a profile.

    ``scenarios`` overrides the grid (tests pass tiny shapes); ``fast``
    selects the CI-sized grid.  Returns the fitted, versioned profile —
    the caller decides whether to save and/or activate it.

    The default backend set is :func:`repro_torch.core.backends.
    timeable_backends` of ``device``: on a CUDA device the plain twins
    (the correctness tools) are skipped, on the CPU the kernel backends
    (whose CPU path is the twin).  Pass ``backends=`` explicitly to
    measure others anyway.  The profile's fingerprint is the machine's,
    with ``platform`` and ``device_kind`` ``"cpu"`` when ``device`` is the
    CPU, so a CPU calibration on a machine with a card never passes for
    the card's.
    """
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    if backends is None:
        from repro_torch.core.backends import timeable_backends

        backends = timeable_backends(dev)
    if scenarios is None:
        scenarios = calibration_grid(fast=fast, seed=seed)
    workloads = [sc.generate() for sc in scenarios]
    # fit with the MEASURED mean scene size, not the (F, k)-derived
    # estimate: an estimated m is an exact function of the other features,
    # and fitting on it aliases the m exponent against F and k — the model
    # then misprices any query whose actual scene size is substituted
    # pad_waste is likewise MEASURED (exact bucketing ratio of the actual
    # user set), so clustered regimes teach the occupancy exponent instead
    # of the uniform-density fallback, which is a pure function of u
    shapes = [
        WorkloadShape(
            len(w.facilities), len(w.users), w.k, len(w.qs),
            m_tris=_mean_scene_tris(w),
            pad_waste=_measured_pw(w),
        )
        for w in workloads
    ]

    from repro_torch.core.backends import get_backend

    models: dict[str, BackendCostModel] = {}
    measured: dict[str, dict] = {}
    targets = list(backends) + (["slice"] if include_slice else [])
    for name in targets:
        tf = np.zeros(len(workloads))
        tv = np.zeros(len(workloads))
        for i, w in enumerate(workloads):
            if name == "slice":
                tf[i], tv[i] = measure_slice(w, repeats=repeats)
            else:
                tf[i], tv[i] = measure_backend(w, name, repeats=repeats, device=dev)
            if verbose:
                print(
                    f"  {name:10s} {w.name:24s} filter={tf[i]*1e3:8.2f}ms "
                    f"verify={tv[i]*1e3:8.2f}ms",
                    file=sys.stderr,
                )
        # geometry-free methods cannot depend on the scene size — pin that
        # exponent to zero instead of letting it alias against |F|; only
        # the grid family pays pad waste (the bucketed kernel stages padded
        # cell rows, the gather kernel pays the max list width L per user),
        # so every other backend pins log_pw rather than letting it alias
        # against log_u
        scene_free = name == "slice" or not get_backend(name).uses_scene
        drop: tuple[str, ...] = ("log_m",) if scene_free else ()
        if name not in ("grid", "grid-pallas", "grid-pallas-ref"):
            drop = drop + ("log_pw",)
        models[name] = BackendCostModel.fit(name, shapes, tf, tv, drop=drop)
        measured[name] = {"t_filter_s": tf.tolist(), "t_verify_s": tv.tolist()}

    hardware = hardware_fingerprint()
    if dev.type == "cpu":
        hardware.update(platform="cpu", device_kind="cpu")
    return PlannerProfile(
        models=models,
        version=PROFILE_VERSION,
        created_at=time.time(),
        hardware=hardware,
        source="calibrated",
        meta={
            "n_shapes": len(workloads),
            "repeats": repeats,
            "fast": fast,
            "backends": list(targets),
            "device": str(dev),
            # the fit's inputs, so a profile carries its own measurements
            "shapes": [
                {"name": w.name, "f": s.n_facilities, "u": s.n_users, "k": s.k,
                 "q": s.q, "m": s.m_tris, "pw": s.pad_waste}
                for w, s in zip(workloads, shapes)
            ],
            "measured": measured,
        },
    )


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="profile path (default: store)")
    ap.add_argument("--full", action="store_true", help="full shape grid")
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--no-slice", action="store_true")
    ap.add_argument(
        "--activate", action="store_true",
        help="install as the process-wide active profile after saving",
    )
    ap.add_argument(
        "--runner-store", default=None, metavar="DIR",
        help="also write the profile to DIR/<runner-class>.json (the "
        "committed per-runner-class store, src/repro_torch/planner/profiles)",
    )
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    prof = calibrate(
        fast=not args.full,
        repeats=args.repeats,
        include_slice=not args.no_slice,
        verbose=args.verbose,
    )
    path = prof.save(args.out or default_profile_path())
    if args.runner_store:
        rpath = prof.save(runner_profile_path(args.runner_store))
        print(f"runner-class profile -> {rpath}", file=sys.stderr)
    if args.activate:
        set_active_profile(prof)
    print(
        f"calibrated {len(prof.models)} backends on "
        f"{prof.meta['n_shapes']} shapes in {time.perf_counter() - t0:.1f}s "
        f"-> {path}",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
