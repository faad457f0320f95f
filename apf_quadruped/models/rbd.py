"""Floating-base rigid-body dynamics of the full 18-DoF DogBot (L2).

Replaces the reference's iDynTree KinDynComputations usage
(reference main.cpp:723-812: getFreeFloatingMassMatrix,
generalizedBiasForces, generalizedGravityForces, frame Jacobians and
bias accelerations) with a from-scratch JAX formulation specialized to
DogBot's fixed topology: a body plus four (hip, upper leg, lower leg)
roll-pitch-knee chains.  Inertial and kinematic constants are transcribed
from the robot description (dogbot.xacro:142 body 9.3 kg, :237 hip
0.836 kg, :282 upper leg 1.851 kg, :325 lower leg 0.302 kg + 0.001 kg
foot, joint origins at :246, :293, :340; total 21.26 kg, matching the
towr model's 21.261, dogbot_model.h:91).

Representation: MIXED coordinates (iDynTree's default, what the reference
uses): generalized velocity  u = [v_base_world(3), omega_world(3), qd(12)],
base position p, orientation R (world_R_base).  Dynamics:

    M(q) u' + h(q, u) = S' tau + sum_i J_ci' f_i

Construction is Jacobian/energy based rather than Featherstone-recursive —
the batch-friendly choice: link CoM velocities are LINEAR in u, so
  M = sum_b  m_b Jv_b' Jv_b + Jw_b' I_b^w Jw_b       (one jacfwd, batched)
and the Coriolis+gravity bias comes from one jvp along the state flow
(q' = qd, R' = skew(omega) R):
  h = sum_b  m_b Jv_b'(a_b + g e_z) + Jw_b'(I_b^w dw_b + w_b x I_b^w w_b)
where (a_b, dw_b) are the bias (u'=0) accelerations.  No 18x18 inverses,
no SVDs (the reference does two 6x6 SVD solves + 18x18 inversions per
millisecond, main.cpp:680, 712, 795).

All functions broadcast over leading batch dims and are jit/vmap/grad-safe.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import RobotConfig
from ..ops.rotations import rot_x, rot_y, skew
from .dogbot import LEG_SIGNS

NB = 13        # moving bodies: body + 4 x (hip, upper, lower+foot)
NV = 18        # generalized-velocity dim
GRAVITY = 9.81

# Default (DogBot) inertial constants live as RobotConfig fields
# (config.py: body_mass .. foot_y_offset, dogbot.xacro:142/237/282/325/366)
# so the same dynamics serve any roll-pitch-knee quadruped in models/zoo.py.


def _link_constants(cfg: RobotConfig, dtype=jnp.float32):
    """masses (NB,), com offsets in link frame (NB,3), inertias (NB,3,3).

    Body order: [body, then per leg (BR, BL, FL, FR): hip, upper, lower].
    The foot is lumped into the lower leg (fixed joint, as gazebo does);
    all values are static Python floats from the frozen config, so the
    arrays are compile-time constants under jit."""
    lower_m = cfg.lower_mass + cfg.foot_mass
    foot_pos = (0.0, cfg.foot_y_offset, -cfg.lower_leg_len)
    lower_com = tuple(
        (cfg.lower_mass * c + cfg.foot_mass * f) / lower_m
        for c, f in zip(cfg.lower_com, foot_pos))
    masses = [cfg.body_mass]
    coms = [(0.0, 0.0, 0.0)]
    inertias = [np.diag(cfg.body_inertia)]
    for sx, _sy in np.asarray(LEG_SIGNS):
        masses += [cfg.hip_mass, cfg.upper_mass, lower_m]
        coms += [(cfg.hip_com_x * sx, 0.0, 0.0),
                 (cfg.upper_com[0] * sx, cfg.upper_com[1], cfg.upper_com[2]),
                 lower_com]
        inertias += [np.diag(cfg.hip_inertia), np.diag(cfg.upper_inertia),
                     np.diag(cfg.lower_inertia)]
    return (jnp.asarray(masses, dtype), jnp.asarray(coms, dtype),
            jnp.asarray(np.stack(inertias), dtype))


def total_mass(cfg: RobotConfig) -> float:
    """Static Python float: sum of link masses (should equal cfg.mass)."""
    return float(cfg.body_mass + 4 * (cfg.hip_mass + cfg.upper_mass
                                      + cfg.lower_mass + cfg.foot_mass))


# DogBot's total mass (the RobotConfig defaults): 21.26 kg, matching the
# towr model's 21.261 (dogbot_model.h:91).
TOTAL_MASS = total_mass(RobotConfig())


def _leg_frames(cfg: RobotConfig, q_leg, sx, sy):
    """Link orientations (in base frame) and origins for one leg chain.

    q_leg (.., 3).  Returns (R_hip, R_up, R_low) each (..,3,3) and
    (o_hip, o_up, o_low) each (..,3): joint origins (xacro:246/293/340)."""
    R_hip = rot_y(sy * q_leg[..., 0])
    R_up = R_hip @ rot_x(sx * q_leg[..., 1])
    R_low = R_up @ rot_x(-sx * q_leg[..., 2])
    shp = q_leg.shape[:-1] + (3,)
    o_hip = jnp.broadcast_to(
        jnp.asarray([cfg.hip_offset_side * sx, cfg.hip_offset * sy, 0.0],
                    q_leg.dtype), shp)
    o_up = o_hip + jnp.einsum(
        "...ij,j->...i", R_hip,
        jnp.asarray([(cfg.leg_offset_side - cfg.hip_offset_side) * sx,
                     0.0, 0.0], q_leg.dtype))
    o_low = o_up + jnp.einsum(
        "...ij,j->...i", R_up,
        jnp.asarray([0.0, 0.0, -cfg.upper_leg_len], q_leg.dtype))
    return (R_hip, R_up, R_low), (o_hip, o_up, o_low)


def link_kinematics(cfg: RobotConfig, q):
    """Base-frame kinematics of all NB link frames.

    q: (.., 12) leg-major.  Returns (R_links (..,NB,3,3),
    p_coms (..,NB,3) link-CoM positions in base frame)."""
    dtype = q.dtype
    batch = q.shape[:-1]
    _, coms, _ = _link_constants(cfg, dtype)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=dtype), batch + (3, 3))
    Rs = [eye]
    ps = [jnp.broadcast_to(coms[0], batch + (3,))]
    qq = q.reshape(batch + (4, 3))
    for i, (sx, sy) in enumerate(np.asarray(LEG_SIGNS)):
        (R_h, R_u, R_l), (o_h, o_u, o_l) = _leg_frames(
            cfg, qq[..., i, :], float(sx), float(sy))
        for R, o, c in ((R_h, o_h, coms[1 + 3 * i]),
                        (R_u, o_u, coms[2 + 3 * i]),
                        (R_l, o_l, coms[3 + 3 * i])):
            Rs.append(R)
            ps.append(o + jnp.einsum("...ij,j->...i", R, c))
    return jnp.stack(Rs, axis=-3), jnp.stack(ps, axis=-2)


def _link_velocities(cfg: RobotConfig, p_base, R_wb, q, u):
    """World-frame (v_com, omega) of every link — LINEAR in u.

    Returns (v (..,NB,3), w (..,NB,3)).  Differentiating this once over u
    gives the stacked Jacobians; one jvp along the state flow gives the
    bias accelerations."""
    v_b, omega, qd = u[..., 0:3], u[..., 3:6], u[..., 6:18]
    R_links_b, p_coms_b = link_kinematics(cfg, q)
    # world position of link coms relative to base
    r = jnp.einsum("...ij,...bj->...bi", R_wb, p_coms_b)       # (..,NB,3)

    # relative angular velocity of each link in the BASE frame
    batch = q.shape[:-1]
    qq = qd.reshape(batch + (4, 3))
    w_rel = [jnp.zeros(batch + (3,), q.dtype)]
    q_pos = q.reshape(batch + (4, 3))
    for i, (sx, sy) in enumerate(np.asarray(LEG_SIGNS)):
        (R_h, R_u, _), _ = _leg_frames(cfg, q_pos[..., i, :],
                                       float(sx), float(sy))
        a0 = jnp.asarray([0.0, sy, 0.0], q.dtype)
        a1 = jnp.asarray([sx, 0.0, 0.0], q.dtype)
        a2 = jnp.asarray([-sx, 0.0, 0.0], q.dtype)
        w_h = a0 * qq[..., i, 0:1]
        w_u = w_h + jnp.einsum("...ij,j->...i", R_h, a1) * qq[..., i, 1:2]
        w_l = w_u + jnp.einsum("...ij,j->...i", R_u, a2) * qq[..., i, 2:3]
        w_rel += [w_h, w_u, w_l]
    w_rel = jnp.stack(w_rel, axis=-2)                           # (..,NB,3)

    w = omega[..., None, :] + jnp.einsum("...ij,...bj->...bi", R_wb, w_rel)
    # v_com = v_base + omega x r + R * d(p_com_b)/dt ; the last term is the
    # jvp of base-frame com positions along qd
    _, p_dot_b = jax.jvp(lambda qv: link_kinematics(cfg, qv)[1], (q,), (qd,))
    v = (v_b[..., None, :]
         + jnp.cross(omega[..., None, :], r)
         + jnp.einsum("...ij,...bj->...bi", R_wb, p_dot_b))
    return v, w


def _jacfwd_seeded(f, x, seed):
    """jax.jacfwd(f)(x) as vmapped JVPs whose basis tangents carry a
    device-varying zero (`seed`): jacfwd's own identity tangents are
    "unvarying" constants under shard_map(check_vma=True) and trip the
    varying-axes checker the moment they multiply sharded data; seeding
    the basis from the data fixes the type without changing values."""
    n = x.shape[-1]
    x = x + seed                             # primal varying too
    basis = jnp.eye(n, dtype=x.dtype) + seed
    out = jax.vmap(lambda e: jax.jvp(f, (x,), (e,))[1])(basis)
    return jnp.moveaxis(out, 0, -1)

def mass_matrix(cfg: RobotConfig, R_wb, q):
    """(.., NV, NV) free-floating mass matrix in mixed coordinates.

    The role of iDynTree's getFreeFloatingMassMatrix (main.cpp:770)."""
    dtype = q.dtype
    batch = q.shape[:-1]
    masses, _, I_links = _link_constants(cfg, dtype)

    def vel_flat(u):
        v, w = _link_velocities(cfg, jnp.zeros(batch + (3,), dtype),
                                R_wb, q, u)
        return jnp.concatenate([v, w], axis=-1)                # (..,NB,6)

    J = _jacfwd_seeded(vel_flat, jnp.zeros(batch + (NV,), dtype),
                       0.0 * jnp.sum(q))
    # J: (.., NB, 6, .., NV) — for batched input the jacobian would
    # produce cross terms; avoid by requiring unbatched here and
    # vmapping at call sites.
    Jv = J[..., 0:3, :]
    Jw = J[..., 3:6, :]
    R_links_b, _ = link_kinematics(cfg, q)
    R_links_w = jnp.einsum("...ij,...bjk->...bik", R_wb, R_links_b)
    I_w = jnp.einsum("...bij,bjk,...blk->...bil", R_links_w, I_links,
                     R_links_w)
    M = (jnp.einsum("b,...bin,...bim->...nm", masses, Jv, Jv)
         + jnp.einsum("...bin,...bij,...bjm->...nm", Jw, I_w, Jw))
    return M


def bias_forces(cfg: RobotConfig, p_base, R_wb, q, u):
    """(.., NV) Coriolis/centrifugal + gravity bias h(q, u).

    The role of generalizedBiasForces + generalizedGravityForces
    (main.cpp:775-780).  Convention: M u' + h = S' tau + J' f.
    """
    dtype = q.dtype
    batch = q.shape[:-1]
    masses, _, I_links = _link_constants(cfg, dtype)
    v_b, omega, qd = u[..., 0:3], u[..., 3:6], u[..., 6:18]

    def vel_fn(p, R, qv):
        return _link_velocities(cfg, p, R, qv, u)

    Rdot = jnp.einsum("...ij,...jk->...ik", skew(omega), R_wb)
    (v, w), (a_bias, dw_bias) = jax.jvp(
        vel_fn, (p_base, R_wb, q), (v_b, Rdot, qd))

    R_links_b, _ = link_kinematics(cfg, q)
    R_links_w = jnp.einsum("...ij,...bjk->...bik", R_wb, R_links_b)
    I_w = jnp.einsum("...bij,bjk,...blk->...bil", R_links_w, I_links,
                     R_links_w)

    g_vec = jnp.asarray([0.0, 0.0, GRAVITY], dtype)
    f_lin = masses[:, None] * (a_bias + g_vec)                 # (..,NB,3)
    f_ang = (jnp.einsum("...bij,...bj->...bi", I_w, dw_bias)
             + jnp.cross(w, jnp.einsum("...bij,...bj->...bi", I_w, w)))

    def vel_flat(uu):
        vv, ww = _link_velocities(cfg, p_base, R_wb, q, uu)
        return jnp.concatenate([vv, ww], axis=-1)

    J = _jacfwd_seeded(vel_flat, jnp.zeros(batch + (NV,), dtype),
                       0.0 * jnp.sum(q))
    Jv = J[..., 0:3, :]
    Jw = J[..., 3:6, :]
    return (jnp.einsum("...bin,...bi->...n", Jv, f_lin)
            + jnp.einsum("...bin,...bi->...n", Jw, f_ang))


def foot_positions_world(cfg: RobotConfig, p_base, R_wb, q):
    """(.., 4, 3) world foot-sphere centers (the xacro foot joint at
    (0, -0.035, -lowerleglen) from the lower leg, :366)."""
    from .kinematics import fk

    feet_b = fk(cfg, q)
    return p_base[..., None, :] + jnp.einsum("...ij,...lj->...li", R_wb,
                                             feet_b)


def contact_jacobian_mixed(cfg: RobotConfig, p_base, R_wb, q):
    """(.., 12, NV) stacked linear foot Jacobian in mixed coordinates:
    v_foot_i = v_base + omega x (R p_fi_b) + R J_leg_i qd_i.
    The role of the reference's 12x18 JacCOM_lin (main.cpp:932-942),
    expressed at the base instead of the CoM."""
    from .kinematics import fk, jacobians

    dtype = q.dtype
    batch = q.shape[:-1]
    feet_b = fk(cfg, q)                                        # (..,4,3)
    jl = jacobians(cfg, q)                                     # (..,4,3,3)
    r = jnp.einsum("...ij,...lj->...li", R_wb, feet_b)
    jw = jnp.einsum("...ij,...ljk->...lik", R_wb, jl)

    J = jnp.zeros(batch + (12, NV), dtype)
    eye3 = jnp.eye(3, dtype=dtype)
    for i in range(4):
        rows = slice(3 * i, 3 * i + 3)
        J = J.at[..., rows, 0:3].set(eye3)
        J = J.at[..., rows, 3:6].set(-skew(r[..., i, :]))
        J = J.at[..., rows, 6 + 3 * i:9 + 3 * i].set(jw[..., i, :, :])
    return J


def contact_bias_mixed(cfg: RobotConfig, p_base, R_wb, q, u):
    """(.., 4, 3) foot bias accelerations Jdot u (u' = 0) — the role of
    getFrameBiasAcc (main.cpp:959-971)."""
    v_b, omega, qd = u[..., 0:3], u[..., 3:6], u[..., 6:18]
    Rdot = jnp.einsum("...ij,...jk->...ik", skew(omega), R_wb)

    def foot_vel(p, R, qv):
        J = contact_jacobian_mixed(cfg, p, R, qv)
        return jnp.einsum("...mn,...n->...m", J, u)

    _, a = jax.jvp(foot_vel, (p_base, R_wb, q), (v_b, Rdot, qd))
    return a.reshape(a.shape[:-1] + (4, 3))


def com_position(cfg: RobotConfig, p_base, R_wb, q):
    """(.., 3) whole-body CoM in world (role of getCenterOfMassPosition,
    main.cpp:748)."""
    masses, _, _ = _link_constants(cfg, q.dtype)
    _, p_coms_b = link_kinematics(cfg, q)
    p_w = p_base[..., None, :] + jnp.einsum("...ij,...bj->...bi", R_wb,
                                            p_coms_b)
    return jnp.einsum("b,...bi->...i", masses, p_w) / total_mass(cfg)


def composite_inertia_com(cfg: RobotConfig, p_base, R_wb, q):
    """(.., 3, 3) whole-body rotational inertia about the CoM (the 3x3
    angular block of the reference's MassMatrixCOM, main.cpp:795):
    sum_b [ I_b^w + m_b (|r|^2 I - r r') ],  r = com_b - com."""
    masses, _, I_links = _link_constants(cfg, q.dtype)
    R_links_b, p_coms_b = link_kinematics(cfg, q)
    R_links_w = jnp.einsum("...ij,...bjk->...bik", R_wb, R_links_b)
    I_w = jnp.einsum("...bij,bjk,...blk->...bil", R_links_w, I_links,
                     R_links_w)
    p_w = p_base[..., None, :] + jnp.einsum("...ij,...bj->...bi", R_wb,
                                            p_coms_b)
    com = jnp.einsum("b,...bi->...i", masses, p_w) / total_mass(cfg)
    r = p_w - com[..., None, :]
    r2 = jnp.sum(r * r, axis=-1)
    eye = jnp.eye(3, dtype=q.dtype)
    steiner = (r2[..., None, None] * eye
               - jnp.einsum("...bi,...bj->...bij", r, r))
    return jnp.sum(I_w + masses[:, None, None] * steiner, axis=-3)


def com_jacobian(cfg: RobotConfig, R_wb, q):
    """(.., 3, NV) CoM velocity Jacobian: v_com = J_com u."""
    dtype = q.dtype
    batch = q.shape[:-1]
    masses, _, _ = _link_constants(cfg, dtype)

    def com_vel(u):
        v, _ = _link_velocities(cfg, jnp.zeros(batch + (3,), dtype),
                                R_wb, q, u)
        return jnp.einsum("b,...bi->...i", masses, v) / total_mass(cfg)

    return _jacfwd_seeded(com_vel, jnp.zeros(batch + (NV,), dtype),
                          0.0 * jnp.sum(q))
