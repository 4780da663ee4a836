"""The port's training launcher (``repro_torch.launch.train.train_main``)
against the JAX package's, on the CPU.

Both start from one checkpoint: JAX's ``init_train_state`` written as
``step_0`` by the JAX store into two directories; each package's
``train_main`` restores it (its driver finds the newest step) and trains
``get_reduced("starcoder2_3b", n_layers=2)`` for 12 steps from the same
pipeline seed with ``AdamWConfig``'s defaults (``eps`` 1e-8), saving at
step 6 and step 12.  ``Policy.compute_dtype`` is float32 in both
(``monkeypatch``; no file of ``repro`` changes).  Compared: the per-step
loss and ``grad_norm`` of each driver's ``metrics_log``, and the final
checkpoints leaf by leaf in JAX's layout.

At ``eps = 1e-8`` AdamW moves an element whose gradient is rounding noise
by about ``lr`` with the noise's sign (``tests/test_torch_lm_train_step.py``
explains it), so the two packages' parameters may part by up to ``2 lr``
at such elements and stay apart.  Measured over these 12 steps: no
element further apart than 1e-4 of its leaf's scale, one further than
1e-5 (worst 1.35e-5); the test allows ``MAX_APART`` elements beyond
``PARAM_REL`` and holds the loss curve.  Tolerances (measured worst in
brackets): loss within 1e-5 relative [1.7e-7], ``grad_norm`` within 1e-5
[2.6e-7], parameters within 2e-3 of each leaf's scale but for
``MAX_APART`` elements [0 elements; 1.35e-5], ``m`` and ``v`` within 1e-4
[7.2e-7, 8.3e-7].

Also: a checkpoint written by either package restores in the other, and
the port's restart after a transient failure and a device loss gives the
uninterrupted run's steps and final state bit for bit.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import store as jstore
from repro.configs import registry as jreg
from repro.launch import train as jtrain
from repro.models import common as jcommon
from repro.models.registry import build_model as jbuild
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.steps.train import init_train_state as jinit_train_state
from repro_torch.checkpoint import store as tstore
from repro_torch.configs import registry as treg
from repro_torch.launch import train as ttrain
from repro_torch.models import common as tcommon
from repro_torch.models.convert import jax_layout_views, to_jax_layout, train_state_from_jax
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.driver import DeviceLoss
from repro_torch.runtime.elastic import build_remesh, plan_remesh
from repro_torch.steps.train import init_train_state

ARCH = "starcoder2_3b"
OVERRIDES = dict(n_layers=2)
RUN = dict(steps=12, batch=4, seq=32, save_every=6, seed=3)
LOSS_REL = 1e-5
NORM_REL = 1e-5
PARAM_REL = 2e-3
MOMENT_REL = 1e-4
MAX_APART = 8


@pytest.fixture
def float32_compute(monkeypatch):
    monkeypatch.setattr(jcommon.Policy, "compute_dtype", jnp.float32)
    monkeypatch.setattr(tcommon.Policy, "compute_dtype", torch.float32)


def _jax_init(seed: int):
    cfg = jreg.get_reduced(ARCH, **OVERRIDES)
    state = jinit_train_state(jbuild(cfg), jax.random.PRNGKey(seed), JAdamWConfig())
    return jax.tree.map(np.asarray, state)


def _jax_train_main(monkeypatch, ckpt_dir: str, **run):
    """JAX's ``train_main`` and its driver's ``metrics_log`` (the launcher
    keeps its driver local: a subclass records it)."""
    drivers = []

    class Recorded(jtrain.TrainDriver):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            drivers.append(self)

    monkeypatch.setattr(jtrain, "TrainDriver", Recorded)
    out = jtrain.train_main(ARCH, reduced_overrides=OVERRIDES, ckpt_dir=ckpt_dir, **run)
    return out, drivers[-1].metrics_log


def _events(out: dict) -> list[str]:
    """The driver's events but the watchdog's straggler flags, which depend
    on timing."""
    return [e for e in out["events"] if not e.startswith("straggler:")]


def _load(directory: str, step: int) -> dict:
    """``{leaf key: array}`` of a checkpoint step, read with numpy alone."""
    folder = os.path.join(directory, f"step_{step:012d}")
    with open(os.path.join(folder, "manifest.json")) as f:
        leaves = json.load(f)["leaves"]
    return {k: np.load(os.path.join(folder, m["file"])) for k, m in leaves.items()}


def _apart(got: dict, want: dict, prefix: str, rel: float) -> tuple[int, float]:
    """Elements of the leaves under ``prefix`` further apart than ``rel`` of
    the leaf's scale, and the largest such relative difference."""
    far, worst = 0, 0.0
    for k, w in want.items():
        if not k.startswith(prefix):
            continue
        scale = float(np.abs(w).max()) + 1e-30
        d = np.abs(got[k].astype(np.float64) - w) / scale
        far += int((d > rel).sum())
        worst = max(worst, float(d.max()))
    return far, worst


def test_train_main_follows_jax_from_one_checkpoint(tmp_path, monkeypatch, float32_compute):
    init = _jax_init(RUN["seed"])
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    for d in (jdir, tdir):
        jstore.save_checkpoint(d, 0, init)
    jout, jlog = _jax_train_main(monkeypatch, jdir, **RUN)
    tout = ttrain.train_main(ARCH, reduced_overrides=OVERRIDES, ckpt_dir=tdir, device="cpu",
                             **RUN)
    assert _events(tout) == _events(jout) == ["restore:step_0", "save:step_6", "save:step_12"]
    assert tout["steps"] == jout["steps"] == 12 and tout["params"] == jout["params"]
    assert [m["step"] for m in tout["metrics_log"]] == [m["step"] for m in jlog]
    for tm, jm in zip(tout["metrics_log"], jlog):
        assert abs(tm["loss"] - jm["loss"]) <= LOSS_REL * abs(jm["loss"]), (tm, jm)
        assert abs(tm["grad_norm"] - jm["grad_norm"]) <= NORM_REL * jm["grad_norm"], (tm, jm)
    assert tout["last_loss"] < tout["first_loss"]
    assert [s["step"] for s in tout["saves"]] == [6, 12]
    assert all(s["bytes"] > 0 for s in tout["saves"])

    got, want = _load(tdir, 12), _load(jdir, 12)
    assert got.keys() == want.keys()
    assert int(got["opt_step"]) == int(want["opt_step"]) == 12
    far, _ = _apart(got, want, "params_", PARAM_REL)
    assert far <= MAX_APART
    for prefix in ("opt_m_", "opt_v_"):
        assert _apart(got, want, prefix, MOMENT_REL)[0] == 0, prefix


def test_checkpoints_restore_across_packages(tmp_path, monkeypatch):
    """A step written by either package restores in the other: through the
    stores (values bit for bit in JAX's layout) and through each package's
    driver (its events)."""
    tcfg = treg.get_reduced(ARCH, **OVERRIDES)
    init = _jax_init(5)
    # the JAX store's step into the port's live state, in place
    jdir = str(tmp_path / "from_jax")
    jstore.save_checkpoint(jdir, 4, init)
    tstate = init_train_state(build_model(tcfg, device="cpu"), 11, AdamWConfig())
    ids = [p.data_ptr() for p in tstate["params"].parameters()]
    _, manifest = tstore.restore_checkpoint(jdir, jax_layout_views(tstate, tcfg), into=True)
    assert manifest["step"] == 4
    assert [p.data_ptr() for p in tstate["params"].parameters()] == ids
    got = to_jax_layout(tstate, tcfg)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(init), jax.tree.leaves(got)):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))
    # the port's step into a JAX state
    tdir = str(tmp_path / "from_port")
    mine = train_state_from_jax(_jax_init(6), tcfg, device="cpu")
    tstore.save_checkpoint(tdir, 9, jax_layout_views(mine, tcfg))
    restored, manifest = jstore.restore_checkpoint(tdir, init)
    assert manifest["step"] == 9
    want = to_jax_layout(mine, tcfg)
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), b)
    # each package's launcher picks up the other's newest step (here the last)
    run = dict(RUN, steps=9, save_every=9)
    jout, _ = _jax_train_main(monkeypatch, tdir, **run)
    assert _events(jout) == ["restore:step_9"] and jout["steps"] == 9
    jstore.save_checkpoint(jdir, 9, jax.tree.map(np.asarray, restored))
    tout = ttrain.train_main(ARCH, reduced_overrides=OVERRIDES, ckpt_dir=jdir, device="cpu",
                             **run)
    assert _events(tout) == ["restore:step_9"] and tout["steps"] == 9


def test_port_restart_is_bit_identical_to_uninterrupted_run(tmp_path):
    """A transient failure between the two saves and a device loss after it:
    the steps after each restore repeat the uninterrupted run's metrics bit
    for bit, and the final checkpoints are equal."""
    run = dict(RUN, steps=10, save_every=5)
    plain = ttrain.train_main(ARCH, reduced_overrides=OVERRIDES, ckpt_dir=str(tmp_path / "a"),
                              device="cpu", **run)
    armed = {7: RuntimeError("simulated transient fault"), 8: DeviceLoss(n_alive=1)}
    meshes = []

    def inject(step):
        if step in armed:
            raise armed.pop(step)

    def on_remesh(n_alive):
        meshes.append(build_remesh(plan_remesh(n_alive, prefer_model=1, global_batch=4),
                                   devices=["cpu"]))

    again = ttrain.train_main(ARCH, reduced_overrides=OVERRIDES, ckpt_dir=str(tmp_path / "b"),
                              device="cpu", inject_failure=inject, on_remesh=on_remesh, **run)
    assert _events(again) == ["init:fresh", "save:step_5", "retry1:RuntimeError",
                               "restore:step_5", "device_loss:1", "remesh", "restore:step_5",
                               "save:step_10"]
    assert len(meshes) == 1 and meshes[0].devices.shape == (1, 1)
    by_step = {m["step"]: m for m in plain["metrics_log"]}
    assert [m["step"] for m in again["metrics_log"]] == [*range(7), 5, 6, 7, 5, 6, 7, 8, 9]
    for m in again["metrics_log"]:
        assert m == by_step[m["step"]], m["step"]
    a, b = _load(str(tmp_path / "a"), 10), _load(str(tmp_path / "b"), 10)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
