"""Momentum-observer test: recovers a known external push in simulation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from apf_quadruped.config import EngineConfig
from apf_quadruped.runtime import observer
from apf_quadruped.sim import physics, terrain
from tests.test_sim import gravity_torques

CFG = EngineConfig()
DT = jnp.float64


@pytest.mark.slow
def test_observer_recovers_push():
    st = physics.initial_state(CFG, dtype=DT)
    terr = terrain.flat(CFG.sim, dtype=DT)
    tau = gravity_torques(st)
    push = jnp.asarray([25.0, 0.0, 0.0], DT)
    obs = observer.init(CFG, st.p_base, st.R_wb, st.q, st.u)

    @jax.jit
    def roll(st, obs):
        def body(carry, k):
            s, o = carry
            fd = jnp.where(k >= 40, 1.0, 0.0) * push
            s, info = physics.step(CFG, s, tau, terr, f_dist=fd)
            o = observer.update(CFG, o, s.p_base, s.R_wb, s.q, s.u,
                                info.forces, CFG.sim.dt, gain=5.0)
            return (s, o), o.w
        return jax.lax.scan(body, (st, obs), jnp.arange(200))

    (st2, obs2), ws = roll(st, obs)
    ws = np.asarray(ws)
    # before the push: estimate near zero
    assert np.abs(ws[30, 0]) < 5.0
    # well after the push starts: estimate approaches 25 N in x
    assert abs(ws[-1, 0] - 25.0) < 6.0, f"w_x = {ws[-1, 0]}"
    # other force components stay small
    assert abs(ws[-1, 1]) < 6.0
