"""Foothold selection tests (foothold.py — the towr foothold-optimization
role, nlp_formulation.cc:128-158 / range_of_motion_constraint.cc:45-78).
"""

import jax
import jax.numpy as jnp
import numpy as np

from apf_quadruped import apf, foothold
from apf_quadruped.config import EngineConfig, FootholdConfig
from apf_quadruped.models.dogbot import LEG_SIGNS
from apf_quadruped.sim import terrain

CFG = EngineConfig()
ROBOT = CFG.robot
FH = CFG.foothold


def _nominal_targets(com=(0.0, 0.0)):
    com = jnp.asarray(com, jnp.float64)
    off = jnp.asarray(LEG_SIGNS, jnp.float64) * jnp.asarray(
        [ROBOT.stance_x, ROBOT.stance_y], jnp.float64)
    return com + off, com


def test_uniform_ground_is_identity():
    """Uniform mu: the zero-offset candidate scores strictly best, so the
    selection returns the APF step targets exactly."""
    terr = terrain.flat(CFG.sim, dtype=jnp.float64)
    step, com = _nominal_targets()
    out = foothold.optimize(FH, ROBOT, terr, step, com)
    np.testing.assert_allclose(np.asarray(out), np.asarray(step), atol=0.0)


def test_avoids_low_mu_patch():
    """A hard patch (mu 0.15) under one leg's target: the chosen foothold
    moves OFF the patch (higher mu), stays inside the RoM box, and the
    other legs stay put."""
    step, com = _nominal_targets()
    m = np.full((CFG.sim.terrain_res,) * 2, CFG.sim.mu_default)
    # patch centered exactly on the BR target (leg 0)
    bx, by = float(step[0, 0]), float(step[0, 1])
    m = terrain.add_circle(CFG.sim, m, bx, by, 0.08, 0.15)
    terr = terrain.Terrain(mu_map=jnp.asarray(m, jnp.float64),
                           extent=CFG.sim.terrain_extent,
                           res=CFG.sim.terrain_res)
    out = foothold.optimize(FH, ROBOT, terr, step, com)
    out_np, step_np = np.asarray(out), np.asarray(step)
    mu_apf = float(terrain.sample_mu(terr, step[0]))
    mu_sel = float(terrain.sample_mu(terr, out[0]))
    assert mu_apf < 0.2                      # APF target IS on the patch
    assert mu_sel > 0.6, (mu_sel, out_np[0])  # selection escaped it
    # legs 1..3 (no patch) unchanged
    np.testing.assert_allclose(out_np[1:], step_np[1:], atol=0.0)
    # RoM box containment
    nominal = np.asarray(com) + np.asarray(LEG_SIGNS) * np.asarray(
        [ROBOT.stance_x, ROBOT.stance_y])
    dev = np.asarray(ROBOT.max_dev[:2])
    assert (out_np >= nominal - dev - 1e-12).all()
    assert (out_np <= nominal + dev + 1e-12).all()


def test_large_patch_trades_distance_for_mu():
    """A patch wider than the RoM box: no escape exists; the selection must
    NOT leave the box chasing mu (w_dist + clamping contain it)."""
    step, com = _nominal_targets()
    m = np.full((CFG.sim.terrain_res,) * 2, CFG.sim.mu_default)
    m = terrain.add_circle(CFG.sim, m, float(step[0, 0]), float(step[0, 1]),
                           0.6, 0.15)
    terr = terrain.Terrain(mu_map=jnp.asarray(m, jnp.float64),
                           extent=CFG.sim.terrain_extent,
                           res=CFG.sim.terrain_res)
    out = np.asarray(foothold.optimize(FH, ROBOT, terr, step, com))
    nominal = np.asarray(com) + np.asarray(LEG_SIGNS) * np.asarray(
        [ROBOT.stance_x, ROBOT.stance_y])
    dev = np.asarray(ROBOT.max_dev[:2])
    assert (out >= nominal - dev - 1e-12).all()
    assert (out <= nominal + dev + 1e-12).all()


def test_slope_penalty_prefers_flat():
    """Two candidates with equal mu: the one on a steep wall (chimney)
    loses to flat ground via the (1 - n_z) term."""
    cfgs = CFG.sim
    terr = terrain.chimney(cfgs, dtype=jnp.float64)
    # chimney wall rises for lateral x > 0.5 in fwd band (1, 2.5); place
    # one target just on the wall side, so a flat-ward candidate exists
    step = jnp.asarray([[0.62, 1.8]], jnp.float64)
    com = jnp.asarray([0.52, 1.8], jnp.float64)
    fh = FootholdConfig(w_dist=5.0)          # cheap moves for the test
    out = np.asarray(foothold.optimize(
        fh, ROBOT, terr,
        jnp.broadcast_to(step, (4, 2)), com))
    nz_step = float(terrain.sample_normal(terr, step[0])[2])
    nz_sel = np.asarray(terrain.sample_normal(terr, jnp.asarray(out)))[:, 2]
    assert nz_sel.min() > nz_step - 1e-9     # never steeper than the target
    assert (out[:, 0] <= step[0, 0] + 1e-12).all()  # moved toward flat


def test_batched_vmap_shapes():
    terr = terrain.flat(CFG.sim, dtype=jnp.float64)
    step, com = _nominal_targets()
    B = 5
    steps = jnp.broadcast_to(step, (B, 4, 2))
    coms = jnp.broadcast_to(com, (B, 2))
    out = jax.vmap(lambda s, c: foothold.optimize(FH, ROBOT, terr, s, c))(
        steps, coms)
    assert out.shape == (B, 4, 2)
    np.testing.assert_allclose(np.asarray(out[0]), np.asarray(step))
