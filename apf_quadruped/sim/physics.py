"""Articulated floating-base physics with penalty contact (L1, the gzserver
replacement).

Dynamics: the full 18-DoF model (models.rbd), semi-implicit Euler:
    u+ = u + dt M^{-1} (S' tau + J_c' f_c + J_d' f_dist - h)
    pose+ = integrate(u+)

Contact: per-foot sphere-on-plane penalty.
  * normal: spring-damper  f_n = max(0, kp * depth - kd * vz)  — the model
    gazebo_ros applies with the xacro's kp/kd contact params
    (dogbot.xacro:28-29), rescaled for the larger stable dt of a batched
    simulator.
  * tangential: ANCHOR-based stick-slip (true static friction):
        f_t = -kp_t (p - anchor) - kd_t v_t
    clamped to the cone |f_t| <= mu(x, y) f_n; when the clamp engages the
    anchor is dragged to p + f_t / kp_t (Coulomb sliding) and the foot is
    flagged as slipping.  mu comes from the terrain map — exactly the
    mechanism that makes the reference's "obstacles" slippery (mu in
    model.sdf, SURVEY.md §2.5).

Single-sample functions; vmap over scenarios at the harness level.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import EngineConfig
from ..models import rbd
from ..ops.rotations import skew
from . import terrain as terrain_mod


class SimState(NamedTuple):
    p_base: jnp.ndarray   # (3,)
    R_wb: jnp.ndarray     # (3,3)
    q: jnp.ndarray        # (12,)
    u: jnp.ndarray        # (18,) mixed velocity [v_base, omega, qd]
    t: jnp.ndarray        # () sim time
    anchor: jnp.ndarray   # (4,2) tangential friction anchors (world xy)


class ContactInfo(NamedTuple):
    forces: jnp.ndarray    # (4,3) world contact force per foot
    in_contact: jnp.ndarray  # (4,) bool
    slipping: jnp.ndarray  # (4,) bool — Coulomb clamp engaged while loaded
    # (4,3) contact force AVERAGED over the step's physics substeps —
    # the impulse-consistent measurement the momentum observer needs
    # (penalty contact oscillates at substep rate; the last substep's
    # instantaneous force is a biased sample of the tick's impulse).
    # None inside contact_forces(); filled by step().
    forces_avg: jnp.ndarray | None = None


def contact_forces(cfg: EngineConfig, st: SimState,
                   terr: terrain_mod.Terrain):
    """Penalty contact at the four feet.  Returns (ContactInfo, new_anchor).

    Generalized to height-field terrains (terrain.sample_height/normal):
    penetration is measured along the local surface normal n, the normal
    force acts along n, and the stick-slip spring lives in the tangent
    plane.  On flat ground (n = z-hat) this reduces exactly to the
    sphere-on-plane model above.
    """
    s = cfg.sim
    feet = rbd.foot_positions_world(cfg.robot, st.p_base, st.R_wb, st.q)
    Jc = rbd.contact_jacobian_mixed(cfg.robot, st.p_base, st.R_wb, st.q)
    v_feet = (Jc @ st.u).reshape(4, 3)
    p_xy = feet[:, 0:2]

    ground_z = terrain_mod.sample_height(terr, p_xy)          # (4,)
    normal = terrain_mod.sample_normal(terr, p_xy)            # (4,3)

    # vertical gap -> penetration along the normal (sphere vs. slope)
    depth = (cfg.robot.foot_radius - (feet[:, 2] - ground_z)) * normal[:, 2]
    in_c = depth > 0.0
    v_n = jnp.sum(normal * v_feet, axis=-1)
    fn = jnp.maximum(0.0, s.ground_kp * depth - s.ground_kd * v_n)
    fn = jnp.where(in_c, fn, 0.0)

    mu = terrain_mod.sample_mu(terr, p_xy)
    # tangential spring: xy anchor displacement + foot velocity, both
    # projected into the tangent plane
    d3 = jnp.concatenate([p_xy - st.anchor,
                          jnp.zeros_like(fn)[:, None]], axis=-1)
    d_t = d3 - jnp.sum(normal * d3, axis=-1, keepdims=True) * normal
    v_t = v_feet - v_n[:, None] * normal
    ft_raw = -s.tangent_kp * d_t - s.tangent_kd * v_t        # (4,3)
    ft_norm = jnp.linalg.norm(ft_raw, axis=-1)
    ft_max = mu * fn
    over = ft_norm > ft_max
    scale = jnp.where(over, ft_max / jnp.maximum(ft_norm, 1e-9), 1.0)
    ft = ft_raw * (scale * in_c)[:, None]
    slipping = in_c & over & (fn > 5.0)

    # anchor update: free feet re-anchor at the foot; sliding feet drag the
    # anchor so the spring force equals the clamped force
    anchor_slide = p_xy + ft[:, 0:2] / s.tangent_kp
    new_anchor = jnp.where(in_c[:, None],
                           jnp.where(over[:, None], anchor_slide, st.anchor),
                           p_xy)
    f = ft + fn[:, None] * normal
    return ContactInfo(forces=f, in_contact=in_c, slipping=slipping), new_anchor


def step(cfg: EngineConfig, st: SimState, tau: jnp.ndarray,
         terr: terrain_mod.Terrain,
         f_dist: jnp.ndarray | None = None,
         f_feet: jnp.ndarray | None = None) -> tuple[SimState, ContactInfo]:
    """One control-rate step = cfg.sim.substeps semi-implicit substeps.

    tau (12,) joint torques (held over the step, like the effort controller
    at 1 kHz, dogbot_controllers.yaml); f_dist (3,) optional external force
    at the base; f_feet (4,3) optional external forces at the feet applied
    through the contact Jacobian, J_c' f — the full wrench including the
    lever-arm torque (the force_plugin leg-link pushes,
    force_plugin.cpp:130-189 AddForceAtRelativePosition on leg links).
    """
    s = cfg.sim
    dt = s.dt / s.substeps
    if f_dist is None:
        f_dist = jnp.zeros(3, st.q.dtype)

    def substep(st, _):
        info, anchor = contact_forces(cfg, st, terr)
        M = rbd.mass_matrix(cfg.robot, st.R_wb, st.q)
        h = rbd.bias_forces(cfg.robot, st.p_base, st.R_wb, st.q, st.u)
        Jc = rbd.contact_jacobian_mixed(cfg.robot, st.p_base, st.R_wb, st.q)
        f_ext = info.forces
        if f_feet is not None:
            f_ext = f_ext + f_feet
        gen = (-h + Jc.T @ f_ext.reshape(12))
        gen = gen.at[6:18].add(tau)
        gen = gen.at[0:3].add(f_dist)
        # M is SPD: Cholesky instead of a general LU solve
        from ..ops.qpsolve import spd_factor, spd_solve
        du = spd_solve(spd_factor(M), gen)
        u = st.u + dt * du
        # failure containment (SURVEY.md §5.3): a blown-up lane (bad
        # torques, contact explosion) must stay FINITE so it can be flagged
        # (sweep marks it fallen) instead of poisoning a batch with NaNs
        u = jnp.clip(jnp.nan_to_num(u), -1e3, 1e3)
        p = st.p_base + dt * u[0:3]
        R = st.R_wb + dt * skew(u[3:6]) @ st.R_wb
        # re-orthonormalize (Gram-Schmidt on columns)
        c0 = R[:, 0] / jnp.linalg.norm(R[:, 0])
        c1 = R[:, 1] - jnp.dot(c0, R[:, 1]) * c0
        c1 = c1 / jnp.linalg.norm(c1)
        c2 = jnp.cross(c0, c1)
        R = jnp.stack([c0, c1, c2], axis=1)
        q = st.q + dt * u[6:18]
        return SimState(p_base=p, R_wb=R, q=q, u=u, t=st.t + dt,
                        anchor=anchor), info

    st, infos = jax.lax.scan(substep, st, None, length=s.substeps)
    last = jax.tree.map(lambda x: x[-1], infos)
    return st, last._replace(forces_avg=jnp.mean(infos.forces, axis=0))


def initial_state(cfg: EngineConfig, xy=(0.0, 0.0), yaw: float = 0.0,
                  dtype=jnp.float32) -> SimState:
    """Crouched standing spawn, feet just touching the ground (the role of
    the reference's set_model_configuration + set_model_state spawn,
    main.cpp:2851-2904)."""
    from ..models.dogbot import nominal_stance
    from ..models.kinematics import stance_ik
    from ..ops.rotations import rot_z

    feet_b = nominal_stance(cfg.robot)
    q = stance_ik(cfg.robot, feet_b)
    z0 = -feet_b[0, 2] + cfg.robot.foot_radius
    p = jnp.asarray([xy[0], xy[1], z0], dtype)
    R = rot_z(jnp.asarray(yaw, dtype))
    st = SimState(p_base=p, R_wb=R, q=jnp.asarray(q, dtype),
                  u=jnp.zeros(18, dtype), t=jnp.asarray(0.0, dtype),
                  anchor=jnp.zeros((4, 2), dtype))
    feet = rbd.foot_positions_world(cfg.robot, st.p_base, st.R_wb, st.q)
    return st._replace(anchor=feet[:, 0:2])
