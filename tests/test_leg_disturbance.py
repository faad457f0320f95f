"""Per-leg-link disturbance application (reference
force_plugin/src/force_plugin.cpp:130-189, 200-326:
AddForceAtRelativePosition pushes LEG links, so the lever arm delivers a
torque to the base that a base-origin force cannot).

Here the schedule's link column routes a push to a foot and
physics.step applies it through the contact Jacobian (J_c' f).
"""

import jax
import pytest
import jax.numpy as jnp
import numpy as np

from apf_quadruped.config import EngineConfig
from apf_quadruped.runtime import loop
from apf_quadruped.sim import disturbance, physics, terrain

pytestmark = pytest.mark.slow  # f64 closed-loop scans (see pytest.ini tiering)

DT = jnp.float64
CFG = EngineConfig()


def test_eval_links_routing():
    """Rows route to their application points; legacy 7-col = all base."""
    sched = jnp.concatenate([
        disturbance.impulses([(0.0, 1.0, 10.0, 0.0, 0.0)], dtype=DT),
        disturbance.leg_push(2, (0.0, 5.0, 0.0), 0.0, 1.0, dtype=DT),
    ])
    fb, ff = disturbance.eval_links(sched, jnp.asarray(0.5, DT))
    assert np.allclose(fb, [10.0, 0.0, 0.0])
    ff = np.asarray(ff)
    assert np.allclose(ff[2], [0.0, 5.0, 0.0])
    assert np.allclose(ff[[0, 1, 3]], 0.0)
    # outside the window: nothing
    fb2, ff2 = disturbance.eval_links(sched, jnp.asarray(2.0, DT))
    assert np.allclose(fb2, 0.0) and np.allclose(ff2, 0.0)
    # legacy 7-column schedule: all base
    old = jnp.zeros((1, 7), DT).at[0, 1].set(1.0).at[0, 2].set(3.0)
    fb3, ff3 = disturbance.eval_links(old, jnp.asarray(0.5, DT))
    assert np.allclose(fb3, [3.0, 0.0, 0.0]) and np.allclose(ff3, 0.0)


def test_leg_push_torques_base():
    """A force at one foot must produce a base roll/pitch response the
    same force at the base origin does not (the lever arm) — measured on
    an airborne robot so ground contact can't absorb the push."""
    st0 = physics.initial_state(CFG, (0.0, 0.0), 0.0, DT)
    st0 = st0._replace(p_base=st0.p_base + jnp.asarray([0.0, 0.0, 0.5], DT))
    terr = terrain.flat(CFG.sim, dtype=DT)
    tau0 = jnp.zeros(12, DT)
    push = jnp.asarray([20.0, 0.0, 0.0], DT)

    def rollout(f_dist=None, f_feet=None, n=20):
        st = st0
        for _ in range(n):
            st, _ = physics.step(CFG, st, tau0, terr, f_dist=f_dist,
                                 f_feet=f_feet)
        return st

    ff = jnp.zeros((4, 3), DT).at[1].set(push)    # BR foot
    om_leg = np.asarray(rollout(f_feet=ff).u[3:6])
    om_base = np.asarray(rollout(f_dist=push).u[3:6])
    # the foot-level push tips the base (roll/pitch rate) an order of
    # magnitude beyond the base-origin push (measured: 0.81 vs 0.056)
    assert np.linalg.norm(om_leg[:2]) > 5.0 * np.linalg.norm(om_base[:2]), (
        om_leg, om_base)


def test_in_loop_observer_recovers_push():
    """The IN-LOOP momentum observer (runtime.loop tick, reusing the
    WBC's M/h/Jc — reference estimate_loop, main.cpp:898-913) recovers
    an injected base push during its window: CycleMetrics.wrench_est
    magnitude within ~20% of the commanded force while walking."""
    push_x = 25.0
    sched = disturbance.impulses([(0.6, 2.0, push_x, 0.0, 0.0)], dtype=DT)
    st = loop.init(CFG, dtype=DT)
    terr = terrain.flat(CFG.sim, dtype=DT)
    st2, m = loop.run(CFG, st, terr, jnp.asarray([0.0, 1.0], DT), sched,
                      n_cycles=4)
    m = jax.tree.map(np.asarray, m)
    # cycle 0 ends at t=0.5, before the push: estimate near zero
    assert np.linalg.norm(m.wrench_est[0, 0:3]) < 0.2 * push_x
    # cycles 1 and 2 end at t=1.0 / 1.5, inside the window (tau = 1/gain
    # = 0.1 s << elapsed): x-force recovered within 20%
    for k in (1, 2):
        assert abs(m.wrench_est[k, 0] - push_x) < 0.2 * push_x, (
            k, m.wrench_est[k])
        assert abs(m.wrench_est[k, 1]) < 0.2 * push_x
    # the robot still walks through it
    assert float(st2.sim.R_wb[2, 2]) > 0.9


def test_in_loop_observer_leg_push():
    """A push applied at a LEG link (force_plugin.cpp:130-189) reaches
    the estimate's force rows, and the estimate TRACKS the time-varying
    force: the case-1 sinusoidal push f_x = 12 sin(t) at the FL foot
    (same disturbance the stability test below absorbs) is recovered at
    each cycle end within ~25%.  (A sustained CONSTANT lateral foot
    push is not testable this way: it drags the stance foot through its
    friction budget until the robot slips and falls — measured 8-18 N
    all topple it — which is exactly the slippage physics the APF layer
    exists to avoid.)"""
    amp = 12.0
    sched = disturbance.leg_push(2, (amp, 0.0, 0.0), 0.2, 2.0,
                                 omega=1.0, dtype=DT)
    st = loop.init(CFG, dtype=DT)
    terr = terrain.flat(CFG.sim, dtype=DT)
    _, m = loop.run(CFG, st, terr, jnp.asarray([0.0, 1.0], DT), sched,
                    n_cycles=4)
    m = jax.tree.map(np.asarray, m)
    # cycles 1-3 end at t = 1.0, 1.5 (inside the window; tau = 0.1 s):
    # w_x ~= 12 sin(t_end)
    for k, t_end in ((1, 1.0), (2, 1.5)):
        expect = amp * np.sin(t_end)
        assert abs(m.wrench_est[k, 0] - expect) < 0.25 * amp, (
            k, expect, m.wrench_est[k])


def test_case1_sinusoidal_leg_push_in_loop():
    """force_plugin case-1 analogue (force_plugin.cpp:132-139:
    sinusoidal push, here routed to the FL leg): the closed loop must
    absorb it — visible robustness load but no fall."""
    sched = disturbance.leg_push(2, (12.0, 0.0, 0.0), 0.2, 2.0,
                                 omega=1.0, dtype=DT)
    st = loop.init(CFG, dtype=DT)
    terr = terrain.flat(CFG.sim, dtype=DT)
    st2, m = loop.run(CFG, st, terr, jnp.asarray([0.0, 1.0], DT), sched,
                      n_cycles=4)
    m = jax.tree.map(np.asarray, m)
    assert float(st2.sim.R_wb[2, 2]) > 0.97
    assert m.com[-1, 1] > 0.1
    assert m.qp_converged.mean() > 0.85
