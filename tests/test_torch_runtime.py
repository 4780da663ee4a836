"""The port's training runtime (``repro_torch.runtime``: watchdog, elastic,
driver) against the JAX package's, on the CPU.

The counterparts of ``tests/test_substrate.py``'s fault-tolerance tests
(stragglers flagged with statistics that stay clean, the elastic plan, a
restart after an injected transient failure that sums 0..9 exactly once,
a device loss that triggers the re-mesh) and of
``tests/test_distribution.py``'s ``build_remesh`` on one device, each run
on both packages with the same inputs; and the ``HangTimer``, which dumps
a flight bundle before its mitigation runs and stays silent when its
block ends in time.
"""

import threading
import time
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.runtime import driver as jdriver
from repro.runtime import elastic as jelastic
from repro.runtime import watchdog as jwatchdog
from repro_torch.obs.flight import FlightRecorder
from repro_torch.runtime.driver import DeviceLoss, DriverConfig, TrainDriver
from repro_torch.runtime.elastic import DeviceMesh, ElasticPlan, build_remesh, plan_remesh
from repro_torch.runtime.watchdog import HangTimer, StepWatchdog


def _plan_tuple(plan) -> tuple:
    return (plan.data, plan.model, plan.n_used, plan.n_alive, plan.dropped_batch_rows)


def _events(events: list[str]) -> list[str]:
    """A driver's events but the watchdog's straggler flags, which depend on
    timing."""
    return [e for e in events if not e.startswith("straggler:")]


def _times(n: int, seed: int = 0) -> list[float]:
    rng = np.random.default_rng(seed)
    return [0.10 + float(rng.normal(0, 1e-4)) for _ in range(n)]


def test_watchdog_flags_stragglers_and_matches_jax():
    wd = StepWatchdog(k_sigma=3.0, min_steps=4, abs_floor_s=0.0)
    jwd = jwatchdog.StepWatchdog(k_sigma=3.0, min_steps=4, abs_floor_s=0.0)
    seq = _times(20) + [1.0] + _times(5, 1) + [0.5]
    flags = [wd.observe(t) for t in seq]
    assert flags == [jwd.observe(t) for t in seq]
    assert flags[20] and flags[-1] and sum(flags) == 2 == wd.flags
    assert wd.mean == pytest.approx(0.10, rel=0.01)  # stats not poisoned
    assert (wd.n, wd.mean, wd.sigma) == (jwd.n, jwd.mean, jwd.sigma)


def test_watchdog_start_stop_times_a_step():
    wd = StepWatchdog(min_steps=1)
    wd.start()
    assert wd.stop() is False and wd.n == 1 and wd.mean >= 0.0
    with pytest.raises(RuntimeError):
        wd.stop()


@pytest.mark.parametrize("n_alive,prefer_model,global_batch",
                         [(251, 16, 256), (9, 16, 256), (1, 1, 8), (3, 4, 7), (1000, 8, 100)])
def test_elastic_plan_matches_jax(n_alive, prefer_model, global_batch):
    p = plan_remesh(n_alive, prefer_model=prefer_model, global_batch=global_batch)
    jp = jelastic.plan_remesh(n_alive, prefer_model=prefer_model, global_batch=global_batch)
    assert _plan_tuple(p) == _plan_tuple(jp)
    assert p.shape == jp.shape


def test_elastic_plan_prefers_model_axis():
    p = plan_remesh(256 - 5, prefer_model=16, global_batch=256)
    assert p.model == 16 and p.data == 15 and p.n_used == 240
    assert p.dropped_batch_rows == 256 - 255  # batch trimmed, not devices
    p2 = plan_remesh(9, prefer_model=16, global_batch=256)
    assert p2.n_used >= 8 and p2.model in (1, 2, 4, 8)


def test_elastic_remesh_device_arrays():
    plan = plan_remesh(1, prefer_model=1, global_batch=8)
    mesh = build_remesh(plan, devices=["cpu"])
    jmesh = jelastic.build_remesh(jelastic.plan_remesh(1, prefer_model=1, global_batch=8))
    assert isinstance(mesh, DeviceMesh) and mesh.devices.size == jmesh.devices.size == 1
    assert mesh.devices.shape == jmesh.devices.shape == (1, 1)
    assert mesh.axis_names == jmesh.axis_names and mesh.shape == dict(jmesh.shape)
    assert mesh.devices[0, 0] == torch.device("cpu")
    with pytest.raises(RuntimeError, match="need 4 devices"):
        build_remesh(ElasticPlan(2, 2, 4, 4, 0), devices=["cpu"])


def _driver_run(pkg, tmp_path, x0, add, to_float):
    """``tests/test_substrate.py``'s restart test on one package."""
    armed = {"on": True}

    def inject(step):
        if step == 7 and armed["on"]:
            armed["on"] = False
            raise RuntimeError("simulated transient fault")

    drv = pkg.TrainDriver(
        str(tmp_path),
        pkg.DriverConfig(total_steps=10, save_every=5, max_retries=2, retry_backoff_s=0.0),
        init_state=lambda: {"x": x0(), "n": x0()},
        step_fn=lambda s, b: ({"x": add(s["x"], b["v"]), "n": add(s["n"], 1.0)},
                             {"x": s["x"]}),
        batch_fn=lambda step: {"v": float(step)},
        inject_failure=inject,
    )
    state, done = drv.run()
    return to_float(state["x"]), to_float(state["n"]), done, drv


def test_driver_checkpoint_restart_and_failure_injection(tmp_path):
    x, n, done, drv = _driver_run(
        types.SimpleNamespace(TrainDriver=TrainDriver, DriverConfig=DriverConfig),
        tmp_path / "port", lambda: torch.zeros(()), lambda a, b: a + b, float)
    jx, jn, jdone, jdrv = _driver_run(
        types.SimpleNamespace(TrainDriver=jdriver.TrainDriver, DriverConfig=jdriver.DriverConfig),
        tmp_path / "jax", lambda: jnp.zeros(()), lambda a, b: a + jnp.float32(b), float)
    assert done == jdone == 10
    # sum over 0..9 exactly once despite the crash at step 7 (restart from 5)
    assert x == jx == sum(range(10)) and n == jn == 10
    assert _events(drv.events) == _events(jdrv.events)
    assert any(e.startswith("retry1") for e in drv.events)
    assert any(e.startswith("restore:step_5") for e in drv.events)
    assert [m["step"] for m in drv.metrics_log] == [m["step"] for m in jdrv.metrics_log]
    assert [m["x"] for m in drv.metrics_log] == [m["x"] for m in jdrv.metrics_log]
    assert [s["step"] for s in drv.saves] == [5, 10]


def test_driver_device_loss_triggers_remesh(tmp_path):
    def run(pkg, d, x0, plan):
        armed, seen = {"on": True}, {}

        def inject(step):
            if step == 3 and armed["on"]:
                armed["on"] = False
                raise pkg.DeviceLoss(n_alive=200)

        drv = pkg.TrainDriver(
            str(d), pkg.DriverConfig(total_steps=5, save_every=2),
            init_state=lambda: {"x": x0()},
            step_fn=lambda s, b: ({"x": s["x"] + 1}, {}),
            batch_fn=lambda i: {},
            on_remesh=lambda n: seen.update(plan=plan(n, prefer_model=16, global_batch=256)),
            inject_failure=inject,
        )
        state, done = drv.run()
        return float(state["x"]), done, seen["plan"], drv.events

    x, done, plan, events = run(
        types.SimpleNamespace(TrainDriver=TrainDriver, DriverConfig=DriverConfig,
                              DeviceLoss=DeviceLoss), tmp_path / "port", lambda: torch.zeros(()),
        plan_remesh)
    jx, jdone, jplan, jevents = run(
        types.SimpleNamespace(TrainDriver=jdriver.TrainDriver, DriverConfig=jdriver.DriverConfig,
                              DeviceLoss=jdriver.DeviceLoss), tmp_path / "jax",
        lambda: jnp.zeros(()), jelastic.plan_remesh)
    assert done == jdone == 5 and x == jx == 5
    assert plan.model == 16 and plan.n_used == 192
    assert _plan_tuple(plan) == _plan_tuple(jplan)
    assert "remesh" in events and _events(events) == _events(jevents)


def test_driver_gives_up_after_max_retries(tmp_path):
    def always(step):
        raise OSError("disk gone")

    drv = TrainDriver(str(tmp_path), DriverConfig(total_steps=3, max_retries=1,
                                                  retry_backoff_s=0.0),
                      init_state=lambda: {"x": torch.zeros(())},
                      step_fn=lambda s, b: (s, {}), batch_fn=lambda i: {},
                      inject_failure=always)
    with pytest.raises(OSError):
        drv.run()
    assert _events(drv.events) == ["init:fresh", "retry1:OSError", "init:fresh",
                                   "retry2:OSError"]


def _engine():
    return types.SimpleNamespace(config=None, metrics=None)


def test_hang_timer_dumps_flight_bundle_before_mitigation(tmp_path):
    flight = FlightRecorder(_engine(), dir=str(tmp_path), min_interval_s=0.0)
    fired = threading.Event()
    seen = {}

    def on_hang():
        seen["bundle"] = flight.last_path  # the bundle is on disk already
        fired.set()

    with HangTimer(0.05, on_hang, flight=flight):
        assert fired.wait(5.0)
    assert seen["bundle"] is not None and seen["bundle"].startswith(str(tmp_path))
    assert "hang" in seen["bundle"]
    jfired = threading.Event()
    with jwatchdog.HangTimer(0.05, jfired.set):
        assert jfired.wait(5.0)


def test_hang_timer_stays_silent_when_exited_in_time(tmp_path):
    flight = FlightRecorder(_engine(), dir=str(tmp_path), min_interval_s=0.0)
    fired = threading.Event()
    with HangTimer(0.5, fired.set, flight=flight):
        pass
    time.sleep(0.7)
    assert not fired.is_set() and flight.last_path is None


def test_hang_timer_mitigates_even_if_flight_dump_fails():
    class Broken:
        def dump(self, reason):
            raise OSError("no room")

    fired = threading.Event()
    with HangTimer(0.01, fired.set, flight=Broken()):
        assert fired.wait(5.0)
