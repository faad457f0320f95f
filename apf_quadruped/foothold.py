"""Decision-influenced foothold selection — the TOWR foothold-optimization
role (L5).

The reference optimizes end-effector positions as NLP decision variables
inside the kinematic range-of-motion box (reference
src/towr/nlp_formulation.cc:128-158 MakeEndeffectorVariables;
range_of_motion_constraint.cc:45-78), so IPOPT can trade a foothold
against terrain and dynamics cost.  The APF layer alone cannot: its step
targets follow the potential field verbatim (apf.navigate), so on
friction-patch worlds the robot plants feet ON slippery cells the
repulsive field was too coarse to avoid.

Here the nonconvex foothold search is re-derived the batched way: a static
K-candidate grid per swing leg inside the RoM box, scored branch-free on

    score = w_mu   * (mu_hi - mu(c))          terrain friction at the cell
          + w_dist * |c - apf_target|^2       deviation from the APF field
          + w_slope * (1 - n_z(c))            surface steepness (height maps)

with a per-lane argmin — one gather + reduce, identical shapes for every
scenario, vmappable over sweeps.  The w_dist term is the convex surrogate
of the dynamics/RoM preference the reference's RangeOfMotionConstraint +
costs encode; w_mu is what the slippage-aware machinery measures only
AFTER contact (the cone-margin EWMA) applied BEFORE contact, from the
terrain map the simulator already carries.

On uniform-friction flat ground the zero-offset candidate scores strictly
best, so the selection reduces EXACTLY to the APF step targets — the
reference parity path is untouched.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from .config import FootholdConfig, RobotConfig
from .models.dogbot import LEG_SIGNS
from .sim import terrain as terrain_mod


def candidate_grid(cfg: FootholdConfig, robot: RobotConfig,
                   dtype=jnp.float32) -> jnp.ndarray:
    """(K, 2) static candidate offsets: an n x n grid spanning
    +-spread * max_dev_xy (the towr RoM box, dogbot_model.h:80)."""
    n = cfg.grid_n
    dev = np.asarray(robot.max_dev[:2]) * cfg.spread
    ax = np.linspace(-1.0, 1.0, n)
    gx, gy = np.meshgrid(ax * dev[0], ax * dev[1], indexing="ij")
    return jnp.asarray(np.stack([gx.ravel(), gy.ravel()], -1), dtype)


def optimize(cfg: FootholdConfig, robot: RobotConfig,
             terr: terrain_mod.Terrain, step_xy: jnp.ndarray,
             com_des_xy: jnp.ndarray) -> jnp.ndarray:
    """Select footholds near the APF step targets that avoid low-friction
    (and steep) cells.

    step_xy: (.., 4, 2) APF step targets (already RoM-clamped by
    apf.navigate), com_des_xy: (.., 2).  Returns (.., 4, 2) selected
    footholds, each inside the RoM box nominal(com_des) +- max_dev.
    """
    dtype = step_xy.dtype
    offs = candidate_grid(cfg, robot, dtype)              # (K, 2)
    cand = step_xy[..., None, :] + offs                   # (.., 4, K, 2)

    # clamp every candidate to the RoM box about the commanded CoM
    # (range_of_motion_constraint.cc:45-78 semantics)
    nominal = (com_des_xy[..., None, :]
               + jnp.asarray(LEG_SIGNS, dtype)
               * jnp.asarray([robot.stance_x, robot.stance_y], dtype))
    dev = jnp.asarray(robot.max_dev[:2], dtype)
    cand = jnp.clip(cand, (nominal - dev)[..., None, :],
                    (nominal + dev)[..., None, :])

    mu = terrain_mod.sample_mu(terr, cand)                # (.., 4, K)
    d2 = jnp.sum((cand - step_xy[..., None, :]) ** 2, axis=-1)
    score = cfg.w_mu * (cfg.mu_hi - mu) + cfg.w_dist * d2
    if terr.h_map is not None:
        nz = terrain_mod.sample_normal(terr, cand)[..., 2]
        score = score + cfg.w_slope * (1.0 - nz)

    best = jnp.argmin(score, axis=-1)                     # (.., 4)
    return jnp.take_along_axis(
        cand, best[..., None, None], axis=-2)[..., 0, :]
