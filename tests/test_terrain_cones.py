"""Terrain-normal-aligned friction cones (planner + WBC).

The reference builds its friction pyramid on the terrain's normal/tangent
basis at each foothold (towr force_constraint.cc:72-83
GetNormalizedBasis(Normal/Tangent1/Tangent2)); the app only ever runs
FlatGround (topt.cpp:9), where that basis is the identity.  This package
adds height-field worlds (sim/terrain.py), so the cones must tilt with the
surface: these tests pin (a) the basis construction, (b) exact flat-world
invariance (identity basis = world-z rows bit-for-bit), and (c) that
tilted cones change the solution the physically-required way — forces
satisfy the pyramid about the NORMAL, not about world z.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from apf_quadruped import planner, wbc
from apf_quadruped.config import EngineConfig, MpcConfig, SolverConfig
from apf_quadruped.models import rbd, srb
from apf_quadruped.models.dogbot import nominal_stance
from apf_quadruped.models.kinematics import stance_ik
from apf_quadruped.sim import terrain

CFG = EngineConfig(
    mpc=MpcConfig(horizon=10, dt=0.05),
    solver=SolverConfig(iters=25, reltol=1e-6, abstol=1e-4),
)


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return jnp.asarray([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


# ---------------------------------------------------------------------------
# basis construction
# ---------------------------------------------------------------------------

def test_basis_from_normal_orthonormal():
    rng = np.random.default_rng(3)
    n = rng.normal(size=(16, 3))
    n[:, 2] = np.abs(n[:, 2]) + 1.0          # walkable: n_z dominant
    n = n / np.linalg.norm(n, axis=-1, keepdims=True)
    C = np.asarray(terrain.basis_from_normal(jnp.asarray(n)))
    np.testing.assert_allclose(
        np.einsum("bij,bik->bjk", C, C),
        np.broadcast_to(np.eye(3), (16, 3, 3)), atol=1e-6)
    np.testing.assert_allclose(C[..., 2], n, atol=1e-6)  # 3rd column = n
    # right-handed
    np.testing.assert_allclose(np.cross(C[..., 0], C[..., 1]), C[..., 2],
                               atol=1e-6)


def test_flat_terrain_basis_is_identity():
    t = terrain.flat(CFG.sim)
    C = np.asarray(terrain.cone_basis(t, jnp.zeros((4, 2))))
    np.testing.assert_allclose(C, np.broadcast_to(np.eye(3), (4, 3, 3)),
                               atol=1e-7)


def test_slope_terrain_normal_tilts():
    t = terrain.slope(CFG.sim)
    # on the up-ramp (fwd 1..2 m, grade 0.7): n should tilt backward (-y)
    n = np.asarray(terrain.sample_normal(t, jnp.asarray([0.0, 1.5])))
    assert n[1] < -0.4 and n[2] > 0.7
    C = np.asarray(terrain.basis_from_normal(jnp.asarray(n)))
    np.testing.assert_allclose(C[:, 2], n, atol=1e-7)


# ---------------------------------------------------------------------------
# planner
# ---------------------------------------------------------------------------

def _stand_refs(cfg, com0, cone_rot=None):
    H = cfg.mpc.horizon
    feet0 = jnp.asarray(nominal_stance(cfg.robot)) + com0
    feet0 = feet0.at[:, 2].set(0.0)
    contacts = jnp.ones((H, 4))
    feet_w = planner.foothold_schedule(feet0, feet0, contacts)
    x_ref = planner.reference_trajectory(
        cfg, jnp.zeros(3), com0, com0, jnp.asarray(0.0),
        jnp.asarray(H * cfg.mpc.dt))
    return planner.MpcRefs(contacts=contacts, feet_w=feet_w, x_ref=x_ref,
                           yaw_ref=jnp.asarray(0.0), cone_rot=cone_rot)


@pytest.mark.parametrize("backend", ["riccati", "condensed"])
def test_identity_cone_rot_matches_none(backend):
    """cone_rot = I must reproduce the None path exactly (same QP in a
    rotated-by-identity basis)."""
    cfg = CFG.replace(mpc=MpcConfig(horizon=10, dt=0.05, backend=backend))
    com0 = jnp.array([0.0, 0.0, 0.4])
    x0 = srb.pack_state(jnp.zeros(3), com0, jnp.zeros(3), jnp.zeros(3))
    eye = jnp.broadcast_to(jnp.eye(3), (cfg.mpc.horizon, 4, 3, 3))
    out_none = planner.plan(cfg, x0, _stand_refs(cfg, com0))
    out_eye = planner.plan(cfg, x0, _stand_refs(cfg, com0, cone_rot=eye))
    np.testing.assert_allclose(np.asarray(out_eye.forces),
                               np.asarray(out_none.forces),
                               rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(np.asarray(out_eye.states),
                               np.asarray(out_none.states),
                               rtol=1e-6, atol=1e-8)


def test_tilted_cones_respected_in_local_frame():
    """All four cones tilted 20 deg about y, with an aggressive lateral
    goal that SATURATES the cone: planned forces satisfy the pyramid
    about the TILTED normal, and the solution differs measurably from the
    flat-cone solve (tilting toward +x admits more +x force)."""
    tilt = np.deg2rad(20.0)
    C1 = _rot_y(tilt)
    cone = jnp.broadcast_to(C1, (CFG.mpc.horizon, 4, 3, 3))
    com0 = jnp.array([0.0, 0.0, 0.4])
    com_des = com0 + jnp.asarray([0.8, 0.0, 0.0])   # hard lateral demand
    x0 = srb.pack_state(jnp.zeros(3), com0, jnp.zeros(3), jnp.zeros(3))

    def refs_for(cr):
        r = _stand_refs(CFG, com0, cone_rot=cr)
        x_ref = planner.reference_trajectory(
            CFG, jnp.zeros(3), com0, com_des, jnp.asarray(0.0),
            jnp.asarray(CFG.mpc.horizon * CFG.mpc.dt))
        return r._replace(x_ref=x_ref)

    out = planner.plan(CFG, x0, refs_for(cone))
    f = np.asarray(out.forces)                    # (H, 4, 3) world
    f_local = np.einsum("ji,hlj->hli", np.asarray(C1), f)
    mu = CFG.mpc.mu
    # local-frame pyramid satisfied
    assert (np.abs(f_local[..., 0]) <= mu * f_local[..., 2] + 1e-4).all()
    assert (np.abs(f_local[..., 1]) <= mu * f_local[..., 2] + 1e-4).all()
    assert (f_local[..., 2] >= -1e-5).all()
    # the tilt binds: more net +x force than the flat-cone solution, which
    # saturates at mu * fz about world z
    out_flat = planner.plan(CFG, x0, refs_for(None))
    f_flat = np.asarray(out_flat.forces)
    assert (np.abs(f_flat[..., 0]) <= mu * f_flat[..., 2] + 1e-4).all()
    assert f[..., 0].sum() > f_flat[..., 0].sum() + 10.0, (
        f[..., 0].sum(), f_flat[..., 0].sum())


# ---------------------------------------------------------------------------
# WBC
# ---------------------------------------------------------------------------

WCFG = EngineConfig(solver=SolverConfig(iters=25, reltol=1e-6, abstol=1e-4))


def _standing_state(cone_rot=None):
    robot = WCFG.robot
    q = jnp.asarray(stance_ik(robot, nominal_stance(robot)))
    st = wbc.WbcState(p_base=jnp.asarray([0.0, 0.0, 0.42]),
                      R_wb=jnp.eye(3), q=q, u=jnp.zeros(18),
                      contact=jnp.ones(4))
    if cone_rot is not None:
        st = st._replace(cone_rot=cone_rot)
    return st


def _hold_refs(st):
    com = rbd.com_position(WCFG.robot, st.p_base, st.R_wb, st.q)
    feet = rbd.foot_positions_world(WCFG.robot, st.p_base, st.R_wb, st.q)
    z = jnp.zeros(3)
    return wbc.WbcRefs(com_pos=com, com_vel=z, com_acc=z, rpy=z, omega=z,
                       omega_dot=z, swing_pos=feet,
                       swing_vel=jnp.zeros((4, 3)),
                       swing_acc=jnp.zeros((4, 3)))


def test_wbc_identity_cone_matches_default():
    st = _standing_state()
    out_def = wbc.solve(WCFG, st, _hold_refs(st))
    st_eye = _standing_state(jnp.broadcast_to(jnp.eye(3), (4, 3, 3)))
    out_eye = wbc.solve(WCFG, st_eye, _hold_refs(st_eye))
    np.testing.assert_allclose(np.asarray(out_eye.tau),
                               np.asarray(out_def.tau), atol=1e-10)


def test_wbc_tilted_cone_saturation():
    """mu = 0.5 cone tilted 20 deg toward +x: a large +x CoM demand can
    now push harder along +x than the world-z cone allows (the admissible
    tangential/normal ratio rotates with the cone)."""
    tilt = np.deg2rad(20.0)
    cone = jnp.broadcast_to(_rot_y(tilt), (4, 3, 3))
    st_flat = _standing_state()
    st_tilt = _standing_state(cone)
    ref = _hold_refs(st_flat)
    ref = ref._replace(com_pos=ref.com_pos + jnp.asarray([0.06, 0.0, 0.0]))
    out_flat = wbc.solve(WCFG, st_flat, ref)
    out_tilt = wbc.solve(WCFG, st_tilt, ref)
    f_flat = np.asarray(out_flat.forces)
    f_tilt = np.asarray(out_tilt.forces)
    # tilted solution satisfies the TILTED pyramid
    C = np.asarray(_rot_y(tilt))
    fl = f_tilt @ C                      # local components (f @ C = C' f)
    mu = WCFG.wbc.mu
    assert (fl[:, 0] <= mu * fl[:, 2] + 1e-5).all()
    assert (fl[:, 2] >= -1e-6).all()
    # and achieves more +x force than the flat cone admits
    assert f_tilt[:, 0].sum() > f_flat[:, 0].sum() + 5.0, (
        f_tilt[:, 0].sum(), f_flat[:, 0].sum())
