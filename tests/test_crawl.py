"""Crawl-gait closed loop: one leg swings at a time (reference combos
C7-C10, dead code there — live here)."""

import jax
import pytest
import jax.numpy as jnp
import numpy as np

from apf_quadruped import gait
from apf_quadruped.config import (EngineConfig, GaitConfig, MpcConfig,
                                      SolverConfig, WbcConfig)
from apf_quadruped.runtime import loop
from apf_quadruped.sim import disturbance, terrain

# crawl cycle is 1 s -> MPC knots at 0.05 s to cover it
pytestmark = pytest.mark.slow  # f64 closed-loop scans (see pytest.ini tiering)

CFG = EngineConfig(
    gait=GaitConfig(mode="crawl"),
    mpc=MpcConfig(horizon=20, dt=0.05),
    solver=SolverConfig(iters=20, reltol=1e-4, abstol=1e-3),
    wbc=WbcConfig(slack_weight_trot=1e6))
DT = jnp.float64


def test_crawl_schedule_one_leg_at_a_time():
    """walk1_4's stance mask always keeps >= 3 feet down."""
    cycle = jnp.asarray(1.0)
    t = jnp.linspace(0.0, 0.999, 64)
    c = gait.contact_state(jnp.full(64, 4), t, jnp.full(64, 1.0))
    stance_count = np.asarray(c).sum(-1)
    assert stance_count.min() >= 3.0
    assert stance_count.min() == 3.0          # some single-swing phases
    # every leg swings at some point in the cycle
    assert (np.asarray(c).min(axis=0) == 0.0).all()


def test_crawl_walks_and_stays_upright():
    st = loop.init(CFG, dtype=DT)
    terr = terrain.flat(CFG.sim, dtype=DT)
    st2, m = loop.run(CFG, st, terr, jnp.asarray([0.0, 1.0], DT),
                      disturbance.empty(DT), n_cycles=2)
    com = np.asarray(m.com)
    assert float(st2.sim.R_wb[2, 2]) > 0.97
    assert com[-1, 1] > 0.04, f"no crawl progress: {com[:, 1]}"
    assert abs(com[-1, 2] - 0.4) < 0.06
    assert (np.asarray(m.tau_max) <= 60.0 + 1e-6).all()
