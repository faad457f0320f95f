"""Closed-loop integration tests: the full APF -> MPC -> WBC -> sim stack.

The CPU-runnable analogue of the reference's end-to-end Gazebo scenario
runs (gztest*.launch) — but with assertions (SURVEY.md §4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from apf_quadruped.config import EngineConfig, SolverConfig, WbcConfig
from apf_quadruped.runtime import loop
from apf_quadruped.sim import disturbance, terrain

# THE production config: SolverConfig() defaults (iters=15,
# reltol=abstol=1e-2 — the reference's own runtime tolerance,
# main.cpp:1651-1652), shared with bench.py / wbc_latency / f32_health.
# Measured closed-loop health at this config: qp_converged 0.97 in BOTH
# f32 and f64 (the residual ~3% are genuine contact-transition ticks at
# the iteration budget, not a precision floor — identical across dtypes).
pytestmark = pytest.mark.slow  # f64 closed-loop scans (see pytest.ini tiering)

CFG = EngineConfig(solver=SolverConfig(),
                   wbc=WbcConfig(slack_weight_trot=1e6))
DT = jnp.float64


@pytest.fixture(scope="module")
def walk_result():
    st = loop.init(CFG, dtype=DT)
    terr = terrain.flat(CFG.sim, dtype=DT)
    target = jnp.asarray([0.0, 1.0], DT)
    st2, m = loop.run(CFG, st, terr, target, disturbance.empty(DT),
                      n_cycles=4)
    return st2, jax.tree.map(np.asarray, m)


def test_walks_toward_target(walk_result):
    st2, m = walk_result
    assert m.com[-1, 1] > 0.15, f"no forward progress: {m.com[:, 1]}"
    # monotone-ish forward motion
    assert (np.diff(m.com[:, 1]) > -0.02).all()


def test_stays_upright_and_at_height(walk_result):
    st2, m = walk_result
    assert float(st2.sim.R_wb[2, 2]) > 0.98
    assert abs(m.com[-1, 2] - 0.40) < 0.05


def test_solvers_healthy(walk_result):
    st2, m = walk_result
    assert m.mpc_converged.all()
    assert m.qp_converged.mean() > 0.9
    assert (m.tau_max <= 60.0 + 1e-6).all()


def test_tracking_error_small(walk_result):
    _, m = walk_result
    assert m.track_err.mean() < 0.03, f"track err {m.track_err}"


def test_robustness_index_live(walk_result):
    """The slippage index must be in a physical range (0, atan(0.5))."""
    _, m = walk_result
    assert (m.rob_mean > 0.0).all()
    assert (m.rob_mean < np.arctan(0.5) * 1.5).all()


def test_disturbance_rejection():
    """A 30 N x 0.2 s lateral shove mid-walk must not topple the robot.
    (There is no capture-step logic — matching the reference — so the
    recoverable impulse is bounded by the stance polygon.)"""
    st = loop.init(CFG, dtype=DT)
    terr = terrain.flat(CFG.sim, dtype=DT)
    sched = disturbance.impulses([(0.6, 0.8, 30.0, 0.0, 0.0)], dtype=DT)
    st2, m = loop.run(CFG, st, terr, jnp.asarray([0.0, 1.0], DT), sched,
                      n_cycles=3)
    assert float(st2.sim.R_wb[2, 2]) > 0.95
    assert np.asarray(m.com)[-1, 1] > 0.05


def test_adaptive_gait_switching():
    """'adaptive' mode: the robustness EWMA drives the gait flag in-loop —
    a state seeded with a slippery history (low margin integral) starts in
    the crawl combo, and once the index rebuilds on good ground the loop
    switches to the full-cycle trot, staying upright throughout."""
    from apf_quadruped.config import GaitConfig, MpcConfig

    cfg = CFG.replace(gait=GaitConfig(mode="adaptive"),
                      mpc=MpcConfig(horizon=40))
    st = loop.init(cfg, dtype=DT)
    # as if the previous cycles measured near-zero friction margin
    st = st._replace(apf=st.apf._replace(
        h_int=jnp.zeros(4, DT), period_st=jnp.asarray(0.5, DT)))
    terr = terrain.flat(cfg.sim, dtype=DT)
    st2, m = loop.run(cfg, st, terr, jnp.asarray([0.0, 1.0], DT),
                      disturbance.empty(DT), n_cycles=5)
    m = jax.tree.map(np.asarray, m)
    assert m.crawling[0], \
        f"slippery history must engage the crawl combo (rob {m.rob_mean})"
    assert not m.crawling[-1], f"never recovered to trot: {m.rob_mean}"
    assert float(st2.sim.R_wb[2, 2]) > 0.95
    # progress is deliberately slow here: rob < 0.34 keeps the reference's
    # fake-crawl gain drop (0.01) active through the recovery — assert
    # steady forward motion, not speed
    assert m.com[-1, 1] > 0.01, f"no forward progress: {m.com[:, 1]}"
    assert (np.diff(m.com[:, 1]) > -0.005).all()
