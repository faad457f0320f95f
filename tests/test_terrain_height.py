"""Height-field terrain tests: bilinear sampling, normals, the towr
example terrains (reference include/towr/terrain/examples/
height_map_examples.h), and height-aware contact physics.

The reference's HeightMap interface (height_map.h:100-170) exposes
GetHeight + derivative-built normals + a friction coefficient; here the
same contract is a rasterized grid with bilinear sampling (sim/terrain.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from apf_quadruped.config import EngineConfig, SimConfig
from apf_quadruped.models import rbd
from apf_quadruped.sim import physics, terrain

DT = jnp.float64
CFG_S = SimConfig(terrain_res=256)


def _h(t, x, y):
    return float(terrain.sample_height(t, jnp.asarray([x, y], DT)))


def _n(t, x, y):
    return np.asarray(terrain.sample_normal(t, jnp.asarray([x, y], DT)))


def test_flat_height_and_normal():
    t = terrain.flat(CFG_S, dtype=DT)
    assert _h(t, 0.3, -1.2) == 0.0
    assert np.allclose(_n(t, 0.3, -1.2), [0.0, 0.0, 1.0])


def test_stairs_heights():
    """Stairs: 0 before y=1.0, 0.2 on the first step, 0.4 on the second,
    back to 0 past the top (height_map_examples.h:76-87)."""
    t = terrain.stairs(CFG_S, dtype=DT)
    assert abs(_h(t, 0.0, 0.5)) < 1e-9
    assert abs(_h(t, 0.0, 1.2) - 0.2) < 0.02
    assert abs(_h(t, 0.0, 2.0) - 0.4) < 0.02
    assert abs(_h(t, 0.0, 3.0)) < 0.02


def test_block_heights():
    t = terrain.block(CFG_S, dtype=DT)
    assert abs(_h(t, 0.0, 0.3)) < 1e-9
    assert abs(_h(t, 0.5, 2.0) - 0.5) < 0.02


def test_gap_depth():
    """Gap: parabola dips to -h at the center (start 1.0, w 0.5, h 1.5)."""
    t = terrain.gap(CFG_S, dtype=DT)
    assert abs(_h(t, 0.0, 0.5)) < 1e-9
    assert _h(t, 0.0, 1.25) < -1.2
    assert abs(_h(t, 0.0, 2.0)) < 0.05


def test_slope_profile_and_normal():
    t = terrain.slope(CFG_S, dtype=DT)
    # mid-ramp: height = grade * 0.5, grade = 0.7
    assert abs(_h(t, 0.0, 1.5) - 0.35) < 0.02
    assert abs(_h(t, 0.0, 2.0) - 0.7) < 0.02
    n = _n(t, 0.0, 1.5)
    expect = np.array([0.0, -0.7, 1.0])
    expect /= np.linalg.norm(expect)
    assert np.allclose(n, expect, atol=0.05), n
    assert abs(np.linalg.norm(n) - 1.0) < 1e-6


def test_chimney_walls():
    t = terrain.chimney(CFG_S, dtype=DT)
    assert abs(_h(t, 0.0, 1.7)) < 1e-9          # center corridor flat
    assert _h(t, 1.0, 1.7) > 1.0                # side wall rises (slope 3)
    t2 = terrain.chimney_lr(CFG_S, dtype=DT)
    assert _h(t2, 1.0, 1.0) > 0.5               # left wall, first segment
    assert _h(t2, -1.0, 2.0) > 0.5              # right wall, second segment


def test_bilinear_is_continuous():
    """Bilinear sampling has no jumps bigger than one cell's worth of
    slope anywhere along a transect."""
    t = terrain.slope(CFG_S, dtype=DT)
    ys = jnp.linspace(0.0, 3.0, 601, dtype=DT)
    xy = jnp.stack([jnp.zeros_like(ys), ys], axis=-1)
    h = np.asarray(terrain.sample_height(t, xy))
    assert np.abs(np.diff(h)).max() < 0.02


def test_settle_on_slope():
    """Drop the robot on the mid-ramp: contact forces must engage, point
    within the friction cone of the SLOPE normal (not world z), and the
    feet must not sink through the surface.  (Passive joints buckle — the
    flat-ground collapse test covers that — so this asserts contact
    geometry during the early settle, not standing equilibrium.)"""
    import jax

    cfg = EngineConfig(sim=SimConfig(terrain_res=256, mu_default=1.0))
    # uniform 11-degree ramp (grade 0.2 in +y): constant analytic normal
    grade = 0.2
    X, Y = np.meshgrid(
        *(2 * [(np.arange(256) + 0.5) / 256 * 12.0 - 6.0]))
    t = terrain.Terrain(
        mu_map=jnp.full((256, 256), 1.0, DT), extent=6.0, res=256,
        h_map=jnp.asarray(grade * Y, DT))
    n_exp = np.array([0.0, -grade, 1.0]) / np.sqrt(1 + grade * grade)
    np.testing.assert_allclose(np.asarray(_n(t, 0.3, 0.8)), n_exp, atol=1e-3)

    st = physics.initial_state(cfg, xy=(0.0, 0.0), dtype=DT)
    st = st._replace(p_base=st.p_base + jnp.asarray([0, 0, 0.01], DT))
    feet = rbd.foot_positions_world(cfg.robot, st.p_base, st.R_wb, st.q)
    st = st._replace(anchor=feet[:, 0:2])

    tau = jnp.zeros(12, DT)

    @jax.jit
    def settle(st):
        def body(s, _):
            s, info = physics.step(cfg, s, tau, t)
            return s, info
        return jax.lax.scan(body, st, None, length=240)

    st, infos = settle(st)
    assert bool(jnp.isfinite(st.p_base).all())
    f_all = np.asarray(infos.forces)               # (60, 4, 3)
    k = int(f_all[..., 2].sum(axis=-1).argmax())   # max-loading tick
    f = f_all[k]
    fz_tot = f[:, 2].sum()
    assert fz_tot > 0.3 * cfg.robot.mass * 9.81, fz_tot
    # loaded feet: force within the mu=1 cone about the RAMP normal
    for i in range(4):
        fn = float(np.dot(f[i], n_exp))
        if fn > 10.0:
            ft = np.linalg.norm(f[i] - fn * n_exp)
            assert ft <= 1.0 * fn + 1e-6, (i, ft, fn)
    # final state: feet near/above the ramp surface, not sunk through
    feet = np.asarray(rbd.foot_positions_world(cfg.robot, st.p_base,
                                               st.R_wb, st.q))
    h_g = np.asarray(terrain.sample_height(t, jnp.asarray(feet[:, 0:2], DT)))
    assert (feet[:, 2] > h_g - 0.05).all()


def test_flat_path_unchanged_by_heightfield_code():
    """A zero height map must give the same contact forces as h_map=None."""
    cfg = EngineConfig()
    st = physics.initial_state(cfg, dtype=DT)
    st = st._replace(p_base=st.p_base - jnp.asarray([0, 0, 0.003], DT))
    t0 = terrain.flat(cfg.sim, dtype=DT)
    tz = t0._replace(h_map=jnp.zeros_like(t0.mu_map))
    i0, a0 = physics.contact_forces(cfg, st, t0)
    i1, a1 = physics.contact_forces(cfg, st, tz)
    assert np.allclose(np.asarray(i0.forces), np.asarray(i1.forces),
                       atol=1e-9)
    assert np.allclose(np.asarray(a0), np.asarray(a1))


@pytest.mark.slow
def test_walks_up_gentle_ramp():
    """Closed loop on a uniform 6%-grade ramp: the robot must make forward
    progress AND gain height, with footholds/CoM refs following the
    terrain (the towr TerrainConstraint role in runtime/loop.py)."""
    import jax

    from apf_quadruped.config import EngineConfig, SolverConfig, WbcConfig
    from apf_quadruped.runtime import loop
    from apf_quadruped.sim import disturbance

    cfg = EngineConfig(
        solver=SolverConfig(iters=20, reltol=1e-4, abstol=1e-3),
        wbc=WbcConfig(slack_weight_trot=1e6))
    grade = 0.06
    res, ext = cfg.sim.terrain_res, cfg.sim.terrain_extent
    Y = np.meshgrid(*(2 * [(np.arange(res) + 0.5) / res * 2 * ext - ext]))[1]
    terr = terrain.Terrain(
        mu_map=jnp.full((res, res), cfg.sim.mu_default, DT),
        extent=ext, res=res,
        h_map=jnp.asarray(grade * np.maximum(Y, 0.0), DT))

    st = loop.init(cfg, xy=(0.0, -0.3), dtype=DT)
    st2, m = loop.run(cfg, st, terr, jnp.asarray([0.0, 1.2], DT),
                      disturbance.empty(DT), n_cycles=4)
    com = np.asarray(m.com)
    assert com[-1, 1] - (-0.3) > 0.15, f"no forward progress: {com[:, 1]}"
    assert float(st2.sim.R_wb[2, 2]) > 0.97
    # height tracks the ramp: com z within 6 cm of surface + com_height
    h_end = grade * max(com[-1, 1], 0.0)
    assert abs(com[-1, 2] - (h_end + 0.40)) < 0.06, (com[-1], h_end)
