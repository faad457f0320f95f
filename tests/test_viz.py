"""Smoke tests for runtime.viz — the tf_pub/RViz replacement
(reference dogbot_controller/src/client/tf_pub.cpp:179-336).

These guard the matplotlib API surface: a run plot with fields +
foothold overlay and a CycleMetrics panel both render to PNG files that
exist and are non-trivial (headless Agg backend).
"""

import os

import numpy as np
import pytest

matplotlib = pytest.importorskip("matplotlib")

from apf_quadruped.runtime import viz  # noqa: E402


def _synthetic_mu(res=64):
    rng = np.random.default_rng(3)
    mu = np.full((res, res), 0.8)
    # a slippery patch in the robot's path
    mu[30:40, 25:35] = 0.15
    mu += 0.01 * rng.standard_normal((res, res))
    return np.clip(mu, 0.05, 1.0)


def test_plot_run_full(tmp_path):
    """Run plot with every optional overlay (fields, feet, footholds)."""
    path = str(tmp_path / "run.png")
    com = np.stack([0.02 * np.sin(np.linspace(0, 3, 40)),
                    np.linspace(0.0, 1.5, 40)], axis=-1)
    feet = np.array([[0.19, -0.29], [-0.19, -0.29],
                     [-0.19, 0.29], [0.19, 0.29]])
    f_att = np.tile([[0.0, 0.2]], (4, 1))
    f_rep = np.tile([[0.1, 0.0]], (4, 1))
    footholds = feet + [[0.0, 0.35]]
    out = viz.plot_run(path, _synthetic_mu(), extent=3.0, com_traj=com,
                       target_xy=(0.0, 1.5), feet=feet, f_att=f_att,
                       f_rep=f_rep, footholds=footholds)
    assert out == path
    assert os.path.exists(path)
    # a real rendered figure, not an empty/placeholder file
    assert os.path.getsize(path) > 20_000


def test_plot_run_minimal(tmp_path):
    """Only the required arguments (every overlay optional)."""
    path = str(tmp_path / "run_min.png")
    com = np.stack([np.zeros(10), np.linspace(0, 0.5, 10)], axis=-1)
    viz.plot_run(path, _synthetic_mu(32), extent=2.0, com_traj=com)
    assert os.path.getsize(path) > 10_000


def test_plot_metrics(tmp_path):
    """CycleMetrics panel from a real (tiny) closed-loop run, so the
    field names viz.plot_metrics indexes stay in sync with
    runtime.loop.CycleMetrics."""
    import jax.numpy as jnp

    from apf_quadruped.config import (EngineConfig, GaitConfig,
                                          MpcConfig, SimConfig,
                                          SolverConfig, WbcConfig)
    from apf_quadruped.runtime import loop
    from apf_quadruped.sim import disturbance, terrain

    cfg = EngineConfig(
        gait=GaitConfig(trot_cycle=0.1),
        mpc=MpcConfig(horizon=4, dt=0.025),
        sim=SimConfig(substeps=2, terrain_res=32),
        solver=SolverConfig(iters=6),
        wbc=WbcConfig(slack_weight_trot=1e6))
    st = loop.init(cfg, dtype=jnp.float32)
    terr = terrain.flat(cfg.sim, dtype=jnp.float32)
    _, metrics = loop.run(cfg, st, terr,
                          jnp.asarray([0.0, 1.0], jnp.float32),
                          disturbance.empty(jnp.float32), n_cycles=2)
    path = str(tmp_path / "metrics.png")
    viz.plot_metrics(path, metrics)
    assert os.path.getsize(path) > 20_000


def test_apf_fast_preset():
    """The named goal-reaching preset (CASES.md goal-study recalibration)
    differs from the parity default only in the documented fields."""
    from apf_quadruped.config import ApfConfig, apf_fast

    fast = apf_fast()
    ref = ApfConfig()
    assert fast.crawl_threshold == 0.2
    assert fast.rep_field_in_step is True
    # every OTHER field keeps the reference value
    import dataclasses
    for f in dataclasses.fields(ApfConfig):
        if f.name in ("crawl_threshold", "rep_field_in_step"):
            continue
        assert getattr(fast, f.name) == getattr(ref, f.name), f.name
