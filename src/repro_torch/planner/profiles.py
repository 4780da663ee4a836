"""Versioned JSON store for fitted planner profiles + the active profile.

The port of ``repro.planner.profiles``.  A :class:`PlannerProfile` bundles
one :class:`BackendCostModel` per backend name (including the ``"slice"``
pseudo-backend used by the hybrid RT-vs-SLICE frontier in
:func:`repro_torch.core.hybrid.choose_engine`), stamped with a schema
version and a hardware fingerprint so a profile calibrated on one machine
is never silently trusted on another kind of hardware.  The schema and
``PROFILE_VERSION`` are the JAX package's: a JSON written by either
package loads in the other.

Process-wide state: :func:`set_active_profile` / :func:`get_active_profile`
install the profile the ``auto`` backend and ``choose_engine`` consult.
With no active (or stored) profile, :func:`builtin_profile` supplies a
prior — analytic cost formulas fitted to the power-law models over a
shape grid — so the planner always has *an* opinion, just a less
trustworthy one than calibration.

Three changes from the JAX module:

* :func:`hardware_fingerprint` reads torch, not ``jax.devices()``:
  ``platform`` is ``"gpu"`` with a CUDA card and ``"cpu"`` without one,
  ``device_kind`` is ``torch.cuda.get_device_name(0)`` (``"cpu"`` without
  a card) and ``n_devices`` is ``torch.cuda.device_count()``.  Profile I/O
  needs no card.
* The active profile, its epoch and the default store path
  (``~/.cache/repro_torch/planner_profile.json``; the environment
  variable ``REPRO_PLANNER_PROFILE`` overrides it, as in JAX) belong to
  this package alone: the two packages in one process never share an
  active profile.
* :func:`_prior_times` drops the JAX prior's 40x "interpret-mode
  penalty" on ``dense`` and ``grid-pallas``.  This package has no
  interpret mode: those two backends are the CUDA kernels, priced as the
  JAX prior prices ``dense-ref`` and ``grid-pallas-ref``.  Every other
  term and constant is the JAX prior's, which was fitted on a CPU: the
  prior is a fallback, not a measurement of any card.

Calibrated profiles of a runner class are committed under
:data:`PROFILE_STORE` (``repro_torch/planner/profiles/<runner_class>.json``)
and loaded with :func:`load_runner_profile`; nothing activates them
automatically.
"""

from __future__ import annotations

import dataclasses
import json
import os
import platform
import threading

import numpy as np

from repro_torch.planner.models import BackendCostModel, WorkloadShape, est_scene_tris

__all__ = [
    "PROFILE_VERSION",
    "PlannerProfile",
    "builtin_profile",
    "get_active_profile",
    "set_active_profile",
    "profile_epoch",
    "note_recalibrated",
    "load_profile",
    "default_profile_path",
    "runner_class",
    "runner_profile_path",
    "load_runner_profile",
    "PROFILE_STORE",
]

#: v2: the feature vector gained ``log_pw`` (cell-bucketing pad-waste
#: ratio) and fits constrain exponents non-negative — v1 coefficient
#: vectors neither parse nor price correctly, so they are rejected.
PROFILE_VERSION = 2

#: Environment override for where profiles live by default.
_PROFILE_ENV = "REPRO_PLANNER_PROFILE"

#: Committed calibrated profiles, one file per runner class.
PROFILE_STORE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "profiles")


def default_profile_path() -> str:
    env = os.environ.get(_PROFILE_ENV)
    if env:
        return env
    cache = os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache"))
    return os.path.join(cache, "repro_torch", "planner_profile.json")


def hardware_fingerprint() -> dict:
    """Coarse machine identity recorded alongside fitted coefficients."""
    try:
        import torch

        if torch.cuda.is_available():
            accel = {"platform": "gpu", "device_kind": torch.cuda.get_device_name(0),
                     "n_devices": torch.cuda.device_count()}
        else:
            accel = {"platform": "cpu", "device_kind": "cpu",
                     "n_devices": torch.cuda.device_count()}
    except Exception:  # noqa: BLE001 — profile IO must not require a device
        accel = {"platform": "unknown", "device_kind": "unknown", "n_devices": 0}
    return {
        "machine": platform.machine(),
        "system": platform.system(),
        "python": platform.python_version(),
        **accel,
    }


@dataclasses.dataclass
class PlannerProfile:
    """One calibrated (or prior) set of per-backend cost models."""

    models: dict[str, BackendCostModel]
    version: int = PROFILE_VERSION
    created_at: float = 0.0  # unix seconds; 0 for the built-in prior
    hardware: dict = dataclasses.field(default_factory=dict)
    source: str = "calibrated"  # "calibrated" | "builtin-prior"
    meta: dict = dataclasses.field(default_factory=dict)

    # ---- prediction ------------------------------------------------------
    def backends(self) -> tuple[str, ...]:
        return tuple(self.models)

    def predict_s(self, backend: str, shape: WorkloadShape) -> float:
        return self.models[backend].predict_total_s(shape)

    def rank(
        self, shape: WorkloadShape, candidates: tuple[str, ...] | None = None
    ) -> list[tuple[str, float]]:
        """Candidates sorted cheapest-first as ``(name, predicted_s)``."""
        names = candidates if candidates is not None else self.backends()
        scored = [(n, self.predict_s(n, shape)) for n in names if n in self.models]
        if not scored:
            raise ValueError(
                f"profile has no models for any of {names!r} "
                f"(knows {self.backends()!r})"
            )
        return sorted(scored, key=lambda t: t[1])

    def best_backend(
        self, shape: WorkloadShape, candidates: tuple[str, ...] | None = None
    ) -> tuple[str, float]:
        return self.rank(shape, candidates)[0]

    # ---- persistence -----------------------------------------------------
    def to_json(self) -> dict:
        return {
            "version": self.version,
            "created_at": self.created_at,
            "hardware": self.hardware,
            "source": self.source,
            "meta": self.meta,
            "models": {n: m.to_json() for n, m in self.models.items()},
        }

    def save(self, path: str) -> str:
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)
            f.write("\n")
        return path

    @classmethod
    def from_json(cls, obj: dict) -> "PlannerProfile":
        version = int(obj.get("version", -1))
        if version != PROFILE_VERSION:
            raise ValueError(
                f"planner profile version {version} is not supported "
                f"(expected {PROFILE_VERSION}); re-run calibration"
            )
        return cls(
            models={
                n: BackendCostModel.from_json(m)
                for n, m in obj.get("models", {}).items()
            },
            version=version,
            created_at=float(obj.get("created_at", 0.0)),
            hardware=dict(obj.get("hardware", {})),
            source=str(obj.get("source", "calibrated")),
            meta=dict(obj.get("meta", {})),
        )


def load_profile(path: str | None = None) -> PlannerProfile:
    """Load a stored profile, warning when its hardware fingerprint does
    not match this machine (fitted constants are hardware-specific — a
    foreign profile still loads, but never silently)."""
    with open(path or default_profile_path()) as f:
        prof = PlannerProfile.from_json(json.load(f))
    if prof.hardware:
        here = hardware_fingerprint()
        mismatched = {
            key: (prof.hardware.get(key), here.get(key))
            for key in ("platform", "device_kind", "machine")
            if key in prof.hardware and prof.hardware.get(key) != here.get(key)
        }
        if mismatched:
            import warnings

            warnings.warn(
                f"planner profile was calibrated on different hardware "
                f"({mismatched}); its cost constants are likely wrong here "
                f"— re-run repro_torch.planner.calibrate",
                RuntimeWarning,
                stacklevel=2,
            )
    return prof


# --------------------------------------------------------------------------
# active profile (process-wide)
# --------------------------------------------------------------------------

_active_lock = threading.Lock()
_active: PlannerProfile | None = None
_epoch = 0


def set_active_profile(profile: PlannerProfile | None) -> None:
    global _active, _epoch
    with _active_lock:
        _active = profile
        _epoch += 1


def get_active_profile() -> PlannerProfile | None:
    """The installed profile, or ``None`` (callers fall back to the prior)."""
    with _active_lock:
        return _active


def profile_epoch() -> int:
    """Bumped on every :func:`set_active_profile` — cached planner
    decisions key on it so recalibration invalidates them."""
    with _active_lock:
        return _epoch


def note_recalibrated() -> None:
    """Bump the epoch without swapping the profile object — the online
    re-calibration path mutates the active profile's coefficients in
    place and calls this once the cumulative drift is large enough that
    memoized plans should be re-priced."""
    global _epoch
    with _active_lock:
        _epoch += 1


# --------------------------------------------------------------------------
# per-runner-class committed profiles (PROFILE_STORE/<class>.json)
# --------------------------------------------------------------------------


def runner_class(hw: dict | None = None) -> str:
    """A filesystem-safe identity for "machines like this one" — the key
    under which CI runner classes commit calibrated profiles."""
    hw = hw or hardware_fingerprint()
    raw = "-".join(
        str(hw.get(k, "unknown"))
        for k in ("system", "machine", "platform", "device_kind")
    ).lower()
    return "".join(c if c.isalnum() or c in "-_." else "_" for c in raw)


def runner_profile_path(root: str) -> str:
    return os.path.join(root, runner_class() + ".json")


def load_runner_profile(root: str) -> PlannerProfile | None:
    """Load this runner class's committed profile, or ``None`` when the
    file is missing, unreadable, schema-stale, or was calibrated on a
    different hardware class (strict match — unlike :func:`load_profile`,
    which warns and proceeds, a *committed* profile must never silently
    misprice a different machine)."""
    path = runner_profile_path(root)
    try:
        with open(path) as f:
            prof = PlannerProfile.from_json(json.load(f))
    except (OSError, ValueError, KeyError, json.JSONDecodeError):
        return None
    here = hardware_fingerprint()
    for key in ("system", "machine", "platform", "device_kind"):
        if prof.hardware.get(key) != here.get(key):
            return None
    return prof


# --------------------------------------------------------------------------
# built-in prior
# --------------------------------------------------------------------------

_builtin: PlannerProfile | None = None


def _prior_times(name: str, s: WorkloadShape) -> tuple[float, float]:
    """Analytic (filter_s, verify_s) priors per batch on CPU-class hardware.

    Shapes (not absolute values) are what matter: they encode which terms
    dominate each backend — scene builds for geometric paths, the |F|·|U|
    distance matrix for brute, the SLICE arc filter for the hybrid
    frontier.  The constants are the JAX package's, which descend from a
    measured CPU frontier; calibration on the card replaces all of this
    with on-hardware fits.  Unlike the JAX prior, ``dense`` and
    ``grid-pallas`` pay no interpret-mode penalty: here they are the CUDA
    kernels, priced as their plain twins.
    """
    f, u, k, q = float(s.n_facilities), float(s.n_users), float(s.k), float(s.q)
    m = s.m() if s.m_tris is not None else est_scene_tris(s.n_facilities, s.k)
    scene = 2e-4 + 1.0e-6 * f + 1.5e-5 * m  # prune + occluder fan, per query
    if name in ("dense", "dense-ref"):
        return q * scene, 3e-4 + 4e-9 * q * u * m
    if name == "grid":
        # gather-bound kernel: every user pays the PADDED max list width
        # (the [Q, N, L, 3, 3] gather), so verify scales with u·pw like
        # the bucketed family — only the constant differs
        return (
            q * (scene + 2e-3 + 4e-5 * m),
            5e-4 + 1.2e-8 * q * (u * s.pw()) * max(m / 6.0, 4.0),
        )
    if name in ("grid-pallas", "grid-pallas-ref"):
        # cell-bucketed kernel: the user->cell sort is shared across the
        # batch (u-term outside q), plane packing rides the index build;
        # verify drops the per-user gather to per-cell plane staging but
        # pays for PADDED rows — u·pw, not u (occupancy feature)
        return (
            q * (scene + 2e-3 + 5e-5 * m) + 3e-8 * u,
            5e-4 + 4e-9 * q * (u * s.pw()) * max(m / 6.0, 4.0),
        )
    if name == "bvh":
        # per-lane walk: pays ~O(m) per user
        return q * (scene + 5e-4 + 1.2e-5 * m), 1e-3 + 1.5e-7 * q * u * m
    if name == "brute":
        return 1e-5, 3e-4 + 5e-9 * q * u * f
    if name == "slice":
        # old choose_engine constants: 0.002·F filter, 0.4·k^1.5·(U/F) verify (ms)
        return q * (1e-3 + 2e-6 * f), q * 4e-7 * (k**1.5) * (u / max(f, 1.0))
    raise KeyError(name)


_PRIOR_BACKENDS = (
    "dense",
    "dense-ref",
    "grid",
    "grid-pallas",
    "grid-pallas-ref",
    "bvh",
    "brute",
    "slice",
)


def builtin_profile() -> PlannerProfile:
    """The no-calibration fallback: power-law models fitted to the analytic
    priors over a shape grid (cached; deterministic)."""
    global _builtin
    if _builtin is not None:
        return _builtin
    # pad_waste varies independently of u (clustered regimes) so the
    # grid-pallas family's log_pw exponent is identifiable; None exercises
    # the uniform-density fallback the planner uses pre-measurement
    shapes = [
        WorkloadShape(f, u, k, q, m_tris=mt, pad_waste=pw)
        for f in (30, 100, 1_000, 10_000)
        for u in (1_000, 20_000, 1_000_000)
        for k in (1, 10, 100)
        for q in (1, 16, 128)
        for mt in (None, est_scene_tris(f, k) * 2.0)
        for pw in (None, 4.0, 16.0)
    ]
    models = {}
    for name in _PRIOR_BACKENDS:
        times = np.array([_prior_times(name, s) for s in shapes])
        # only the grid family pays pad waste; everyone else pins the
        # exponent to zero instead of aliasing it against log_u
        drop = (
            ()
            if name in ("grid", "grid-pallas", "grid-pallas-ref")
            else ("log_pw",)
        )
        models[name] = BackendCostModel.fit(
            name, shapes, times[:, 0], times[:, 1], drop=drop
        )
    _builtin = PlannerProfile(
        models=models,
        created_at=0.0,
        hardware={},
        source="builtin-prior",
        meta={"note": "analytic CPU-class priors of the JAX package, without its "
                      "interpret-mode penalty (a fallback, not a measurement of "
                      "any card); run repro_torch.planner.calibrate to replace"},
    )
    return _builtin


_disk_checked = False


def active_or_builtin() -> PlannerProfile:
    """The profile the planner actually uses: the active one, else (once
    per process) a ``REPRO_PLANNER_PROFILE`` file if the operator pointed
    the env var at one, else the analytic built-in prior."""
    prof = get_active_profile()
    if prof is not None:
        return prof
    global _disk_checked
    if not _disk_checked:
        _disk_checked = True
        if os.environ.get(_PROFILE_ENV):
            prof = activate_from_disk()
            if prof is not None:
                return prof
    return builtin_profile()


def activate_from_disk(path: str | None = None) -> PlannerProfile | None:
    """Best-effort load-and-activate (missing/stale files return ``None``)."""
    try:
        prof = load_profile(path)
    except (OSError, ValueError, KeyError, json.JSONDecodeError):
        return None
    set_active_profile(prof)
    return prof
