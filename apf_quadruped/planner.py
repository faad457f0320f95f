"""Convex SRB MPC over the gait horizon — the TOWR + IPOPT replacement.

The reference plans each replan cycle by solving a nonconvex NLP (TOWR
phase-based trajectory optimization, reference src/topt.cpp:5-101, solved
by IPOPT with a 20 s CPU budget while Gazebo is PAUSED, main.cpp:1250/1441).
Here the same role — a dynamically-consistent CoM/force trajectory over a
0.5-1 s gait cycle respecting friction cones — is filled by a CONVEX
fixed-structure MPC:

  * gait table supplies the contact schedule (gait.horizon_contacts), the
    APF layer supplies footstep targets and the CoM goal — what IPOPT's
    nonconvex foothold search provided (SURVEY.md §7.4);
  * per-knot linearized SRB dynamics (models.srb.linearize_discrete) are
    CONDENSED into a dense QP in the stacked contact forces
    U = [u_0 ... u_{H-1}] (n = 12H), eliminating the state sequence;
  * friction pyramid + normal-force bounds per stance foot per knot
    (towr force_constraint.cc:40-110 semantics) become masked inequality
    rows; swing feet get masked-off rows and zeroed dynamics columns, so
    their forces decouple and the force regularizer pins them to exactly 0
    — gait switching changes data, never shapes;
  * one batched IPM call (ops.qpsolve) solves thousands of scenarios in
    lockstep — no 20 s escape hatch needed, and the sim never pauses.

Everything is shape-static given (horizon, dt) from MpcConfig, so jit
traces once per config.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .config import EngineConfig
from .models import srb
from .ops.qpsolve import QPData, QPSolution, solve_qp

ROWS_PER_FOOT = 6   # fz<=fmax, -fz<=-fmin, +-fx-mu fz<=0, +-fy-mu fz<=0


class MpcRefs(NamedTuple):
    """Per-knot references and schedule feeding one MPC solve."""

    contacts: jnp.ndarray    # (.., H, 4) stance masks
    feet_w: jnp.ndarray      # (.., H, 4, 3) foothold positions (world)
    x_ref: jnp.ndarray       # (.., H, NX) state references
    yaw_ref: jnp.ndarray     # (..,) linearization yaw
    # optional (.., H, 4, 3, 3) terrain-aligned cone bases per foothold
    # (terrain.cone_basis; columns t1, t2, n).  None = world-z cones (the
    # reference app's FlatGround, topt.cpp:9).  When given, the friction
    # pyramid is built about the TERRAIN NORMAL at each foothold, matching
    # towr's ForceConstraint basis (force_constraint.cc:72-83) — realized
    # as a change of force variables (see _rotate_B), so the solver's
    # constant pyramid block is untouched.
    cone_rot: jnp.ndarray | None = None


class MpcPlan(NamedTuple):
    forces: jnp.ndarray      # (.., H, 4, 3) planned contact forces
    states: jnp.ndarray      # (.., H, NX) predicted state trajectory
    sol: QPSolution          # solver diagnostics (converged, gap, ...)


def foothold_schedule(feet_now_w, step_targets_w, contacts):
    """(.., H, 4, 3) per-knot foot positions: a leg keeps its current world
    position until its first swing knot in the horizon, then sits at its APF
    step target.  (The lever arm only matters at stance knots.)"""
    swung = jnp.cumsum(1.0 - contacts, axis=-2) > 0          # (.., H, 4)
    return jnp.where(swung[..., None],
                     step_targets_w[..., None, :, :],
                     feet_now_w[..., None, :, :])


def reference_trajectory(cfg: EngineConfig, rpy0, com0, com_des, yaw_des,
                         horizon_T):
    """(.., H, NX) linear CoM ramp to the APF goal at standing height.

    Mirrors what the reference passes to TOWR: initial base state, final
    base = com_des with the current orientation (topt.cpp:12-42).
    """
    H = cfg.mpc.horizon
    dtype = com0.dtype
    tau = (jnp.arange(1, H + 1, dtype=dtype) / H)            # (H,)
    com_k = com0[..., None, :] + (com_des - com0)[..., None, :] * tau[..., None]
    v_ref = (com_des - com0) / horizon_T[..., None]
    rpy_k = jnp.stack([jnp.zeros_like(yaw_des), jnp.zeros_like(yaw_des),
                       yaw_des], axis=-1)
    x = jnp.zeros(com_k.shape[:-1] + (srb.NX,), dtype)
    x = x.at[..., 0:3].set(jnp.broadcast_to(rpy_k[..., None, :], com_k.shape))
    x = x.at[..., 3:6].set(com_k)
    x = x.at[..., 9:12].set(jnp.broadcast_to(v_ref[..., None, :], com_k.shape))
    x = x.at[..., 12].set(1.0)
    return x


def _condense(A, B, x0):
    """Condense x_{k+1} = A_k x_k + B_k u_k over the horizon.

    A: (.., H, NX, NX), B: (.., H, NX, NU), x0: (.., NX).
    Returns Sx_x0: (.., H, NX) free response, Su: (.., H, NX, H*NU) with
    x_k = Sx_x0[k] + Su[k] @ U  (x_k is the state AFTER k+1 steps).
    Built by a scan carrying the running row [free, forced]: one
    (NX x NX)@(NX x H*NU) matmul per stage.
    """
    Hh = A.shape[-3]
    NX, NU = srb.NX, srb.NU
    batch = x0.shape[:-1]
    dtype = x0.dtype

    eyes = jnp.eye(NU, dtype=dtype)

    def step(carry, inp):
        free, forced = carry                   # (.., NX), (.., NX, H*NU)
        Ak, Bk, k = inp
        free = jnp.einsum("...ij,...j->...i", Ak, free)
        forced = jnp.einsum("...ij,...jm->...im", Ak, forced)
        # insert B_k into block column k
        col = jax.lax.dynamic_update_slice_in_dim(
            jnp.zeros(batch + (NX, Hh * NU), dtype), Bk, k * NU, axis=-1)
        forced = forced + col
        return (free, forced), (free, forced)

    A_t = jnp.moveaxis(A, -3, 0)
    B_t = jnp.moveaxis(B, -3, 0)
    ks = jnp.arange(Hh)
    # derive the zero init from x0 so its device-varying axes match the
    # scan output under shard_map (plain zeros are "unvarying" and trip
    # the scan carry-type check on a sharded mesh)
    forced0 = jnp.zeros(batch + (NX, Hh * NU), dtype) + 0.0 * x0[..., :, None]
    (_, _), (frees, forceds) = jax.lax.scan(step, (x0, forced0),
                                            (A_t, B_t, ks))
    Sx_x0 = jnp.moveaxis(frees, 0, -2)                     # (.., H, NX)
    Su = jnp.moveaxis(forceds, 0, -3)                      # (.., H, NX, H*NU)
    return Sx_x0, Su


def _rotate_B(B, cone_rot):
    """Change of force variables u_world = C u_local, folded into the
    input matrix: B_local = B_world @ blockdiag(C_1..C_4) per knot.

    B: (.., H, NX, 12), cone_rot: (.., H, 4, 3, 3) with f_w = C @ f_l.
    With forces expressed in the local (t1, t2, n) basis, the CONSTANT
    world-z pyramid block of _pyramid_constants enforces the cone about
    the terrain normal — per-knot cone orientation becomes dynamics data
    (B is already per-knot), never a constraint-shape change.
    """
    Bl = B.reshape(B.shape[:-1] + (4, 3))
    Bl = jnp.einsum("...xlj,...lji->...xli", Bl, cone_rot)
    return Bl.reshape(B.shape)


def _forces_to_world(u, cone_rot):
    """u: (.., H, 12) local-basis forces -> world: f_w = C @ f_l per leg."""
    ul = u.reshape(u.shape[:-1] + (4, 3))
    uw = jnp.einsum("...lji,...li->...lj", cone_rot, ul)
    return uw.reshape(u.shape)


def _forces_to_local(u, cone_rot):
    """Inverse of _forces_to_world: f_l = C' f_w per leg."""
    uw = u.reshape(u.shape[:-1] + (4, 3))
    ul = jnp.einsum("...lji,...lj->...li", cone_rot, uw)
    return ul.reshape(u.shape)


def effective_backend(cfg: EngineConfig) -> str:
    """The backend plan() will actually use (trace-time resolution).

    "auto" resolves from the platform: the lax.scan Riccati IPM on the
    GPU and on the CPU (PERF.md records why no hand-written kernel is
    in its place).  There is no default for any other platform.
    """
    backend = cfg.mpc.backend
    if backend != "auto":
        return backend
    platform = jax.default_backend()
    if platform not in ("cpu", "gpu"):
        raise ValueError(f"MpcConfig.backend='auto' has no solver for "
                         f"platform {platform!r}; name a backend")
    return "riccati"


def _pyramid_constants(cfg: EngineConfig):
    """STATIC friction-pyramid data: the pyramid coefficients are identical
    at every knot (towr force_constraint.cc:84-109 with mu from MpcConfig;
    normal bound fz <= fz_max, parameters.cc:48) — only the stance MASK is
    per-scenario data.  Returns numpy (24,12) block and (24,) rhs.
    """
    import numpy as np

    mu = cfg.mpc.mu
    rows = []
    rhs = []
    for i in range(4):
        e = [0.0] * 12

        def row(cx, cy, cz, r):
            v = list(e)
            v[3 * i + 0] = cx
            v[3 * i + 1] = cy
            v[3 * i + 2] = cz
            rows.append(v)
            rhs.append(r)

        row(0.0, 0.0, 1.0, cfg.mpc.fz_max)     # fz <= fz_max
        row(0.0, 0.0, -1.0, -cfg.mpc.fz_min)   # -fz <= -fz_min
        row(1.0, 0.0, -mu, 0.0)                # fx - mu fz <= 0
        row(-1.0, 0.0, -mu, 0.0)
        row(0.0, 1.0, -mu, 0.0)
        row(0.0, -1.0, -mu, 0.0)
    return np.asarray(rows), np.asarray(rhs)


@partial(jax.jit, static_argnames=("cfg",))
def plan(cfg: EngineConfig, state0, refs: MpcRefs, warm=None) -> MpcPlan:
    """One batched MPC solve.

    warm: optional ops.riccati.WarmStart from the previous replan cycle
    (world-frame forces; leg-permuted by the caller for phase-mirrored
    gait cycles).  Used by the riccati-family backends; ignored by the
    condensed cross-validation backend.

    state0: (.., NX) packed SRB state (srb.pack_state).
    refs: contact schedule, foothold schedule, state references.

    Two interchangeable solver backends (MpcConfig.backend):
      * "riccati": the banded-LQR interior point as ~7 lax.scans per
        iteration, O(H NX^3) per iteration (ops.riccati) — the
        production path on the GPU and the CPU
      * "condensed": dense QP in stacked forces via ops.qpsolve,
        O((12H)^3) per iteration; retained for cross-validation
    "auto" (the default) resolves at trace time (effective_backend).
    """
    # highest matmul precision for the WHOLE plan, not just the IPM: the
    # per-knot linearizations (I_w^-1 levers, condensation matmuls) and
    # the SQP defect algebra otherwise may run in TF32 on the GPU and
    # hand the solver a corrupted problem (see wbc.solve).
    with jax.default_matmul_precision("highest"):
        return _plan_impl(cfg, state0, refs, warm)


def _plan_impl(cfg: EngineConfig, state0, refs: MpcRefs,
               warm=None) -> MpcPlan:
    backend = effective_backend(cfg)
    if backend == "riccati":
        return _plan_riccati(cfg, state0, refs, warm)
    if backend == "condensed":
        return _plan_condensed(cfg, state0, refs)
    raise ValueError(f"unknown MpcConfig.backend {backend!r} (auto, "
                     f"riccati, condensed)")


def _q_diag(cfg: EngineConfig):
    """Diagonal of the state cost Q (numpy: configuration data)."""
    import numpy as np

    mpc = cfg.mpc
    return np.asarray([mpc.w_att] * 3 + [mpc.w_pos] * 3 + [mpc.w_omega] * 3
                      + [mpc.w_vel] * 3 + [0.0])


def _linearizations(cfg: EngineConfig, refs: MpcRefs):
    # one broadcast call over the (batch, H) axes — linearize_discrete is
    # shape-polymorphic, and a vmap-over-knot-index variant costs ~100x in
    # scatter overhead
    Hh = cfg.mpc.horizon
    yaw = jnp.broadcast_to(refs.yaw_ref[..., None],
                           refs.yaw_ref.shape + (Hh,))
    r_ref = refs.x_ref[..., 3:6]
    return srb.linearize_discrete(cfg.robot, yaw, r_ref, refs.feet_w,
                                  refs.contacts, cfg.mpc.dt)


def _sqp_relinearize(cfg: EngineConfig, state0, refs: MpcRefs, sol):
    """Re-linearize the SRB dynamics around the predicted trajectory
    (SQP / Gauss-Newton outer iteration — the role IPOPT's nonconvex
    search fills in the reference, SURVEY.md §7.4).

    Returns (A, B) evaluated at the solved (x, u), with the EXACT
    nonlinear one-step defect c_k = f(x_k, u_k) - A x_k - B u_k folded
    into the affine carrier column of A — so terms the per-knot
    linearization drops (gyroscopic w x Iw, roll/pitch attitude coupling,
    true vs reference lever arms) enter the next solve exactly at the
    linearization point.
    """
    dt = cfg.mpc.dt
    # states at each stage's START: [x0, x_1 .. x_{H-1}]
    xs = jnp.concatenate([state0[..., None, :], sol.x[..., :-1, :]], axis=-2)
    yaw_k = xs[..., 2]
    r_k = xs[..., 3:6]
    A, B = srb.linearize_discrete(cfg.robot, yaw_k, r_k, refs.feet_w,
                                  refs.contacts, dt)
    forces = (sol.u.reshape(sol.u.shape[:-1] + (4, 3))
              * refs.contacts[..., None])
    rpy, r, om, v = srb.unpack_state(xs)
    d_rpy, d_r, d_om, d_v = srb.srb_derivative(
        cfg.robot, rpy, r, om, v, refs.feet_w, forces)
    dx = jnp.concatenate(
        [d_rpy, d_r, d_om, d_v, jnp.zeros_like(xs[..., 12:13])], axis=-1)
    f_nl = xs + dt * dx                              # exact Euler step
    c = (f_nl
         - jnp.einsum("...ij,...j->...i", A, xs)
         - jnp.einsum("...ij,...j->...i", B, sol.u))
    return A.at[..., :, 12].add(c), B


def _plan_riccati(cfg: EngineConfig, state0, refs: MpcRefs,
                  warm=None) -> MpcPlan:
    from .ops.riccati import StageQP, solve_stage_qp
    import numpy as np

    mpc = cfg.mpc
    dtype = state0.dtype
    A, B = _linearizations(cfg, refs)
    q_diag = jnp.asarray(_q_diag(cfg), dtype)
    Q = jnp.diag(q_diag)
    qlin = -refs.x_ref * q_diag                     # (.., H, NX)
    R = mpc.w_force * jnp.eye(srb.NU, dtype=dtype)
    blk, rhs_blk = _pyramid_constants(cfg)
    mask = jnp.repeat(refs.contacts, ROWS_PER_FOOT, axis=-1)

    # opt-in BaseRom box (towr base_motion_constraint.cc:46-55: roll and
    # pitch in +-dev_rad, base z in [z0 - below, z0 + above]) as STATE
    # rows Cx x_{k+1} <= cx on the banded Riccati structure — exactly the
    # rows the condensed backend builds on its prediction matrix
    # (cross-validated in tests/test_planner.py)
    Cxd = cxd = mask_xd = None
    if mpc.base_box:
        import numpy as _np
        dims = (0, 1, 5)                               # roll, pitch, z
        Cx_np = _np.zeros((6, srb.NX))
        for i, d in enumerate(dims):
            Cx_np[i, d] = 1.0
            Cx_np[3 + i, d] = -1.0
        Cxd = jnp.asarray(Cx_np, dtype)
        z0 = state0[..., 5]
        dev = jnp.asarray(mpc.base_dev_rad, dtype)
        his = jnp.stack([dev + 0.0 * z0, dev + 0.0 * z0,
                         z0 + mpc.base_z_above], axis=-1)
        los = jnp.stack([-dev + 0.0 * z0, -dev + 0.0 * z0,
                         z0 - mpc.base_z_below], axis=-1)
        cx1 = jnp.concatenate([his, -los], axis=-1)    # (.., 6)
        cxd = jnp.broadcast_to(cx1[..., None, :],
                               state0.shape[:-1] + (mpc.horizon, 6))
        mask_xd = jnp.ones_like(cxd)

    # base-acceleration bounds (towr BaseAcc analogue): per-dim bound on
    # the velocity-state change per knot, realized as per-knot input
    # rows inside every backend (StageQP.acc_rhs)
    acc_rhs = None
    if mpc.base_acc:
        acc_rhs = jnp.asarray(
            [mpc.acc_ang_max] * 3 + [mpc.acc_lin_max] * 3, dtype) * mpc.dt

    def solve(A, B, warm):
        if refs.cone_rot is not None:
            B = _rotate_B(B, refs.cone_rot)      # solve in the cone basis
            if warm is not None:                 # warm forces arrive world
                warm = warm._replace(
                    u=_forces_to_local(warm.u, refs.cone_rot))
        qp = StageQP(A=A, B=B, Q=Q, qlin=qlin, R=R,
                     G=jnp.asarray(blk, dtype), h=jnp.asarray(rhs_blk, dtype),
                     mask=mask, x0=state0, Cx=Cxd, cx=cxd, mask_x=mask_xd,
                     acc_rhs=acc_rhs)
        sol = solve_stage_qp(qp, cfg.solver, warm=warm)
        if refs.cone_rot is not None:
            sol = sol._replace(u=_forces_to_world(sol.u, refs.cone_rot))
        return sol

    sol = solve(A, B, warm)
    if max(1, mpc.sqp_iters) > 1:
        from .ops.riccati import WarmStart
        ones = jnp.ones(state0.shape[:-1], bool)
    for _ in range(max(1, mpc.sqp_iters) - 1):       # SQP outer loop
        A, B = _sqp_relinearize(cfg, state0, refs, sol)
        # each SQP re-solve warm-starts from the previous inner solution
        sol = solve(A, B, WarmStart(u=sol.u, z=sol.z, s=sol.s, valid=ones))
    from .ops.qpsolve import QPSolution
    diag = QPSolution(x=sol.u.reshape(sol.u.shape[:-2] + (-1,)),
                      y=jnp.zeros_like(state0[..., 0:1]),
                      z=sol.z.reshape(sol.z.shape[:-2] + (-1,)),
                      s=sol.s.reshape(sol.s.shape[:-2] + (-1,)),
                      converged=sol.converged, iters=sol.iters,
                      gap=sol.gap, res_norm=sol.res_norm)
    return MpcPlan(forces=sol.u.reshape(sol.u.shape[:-1] + (4, 3)),
                   states=sol.x, sol=diag)


def _plan_condensed(cfg: EngineConfig, state0, refs: MpcRefs) -> MpcPlan:
    mpc = cfg.mpc
    Hh = mpc.horizon
    NX, NU = srb.NX, srb.NU
    dtype = state0.dtype
    batch = state0.shape[:-1]

    # per-knot linearizations
    yaw = refs.yaw_ref
    r_ref = refs.x_ref[..., 3:6]
    A, B = jax.vmap(
        lambda k: srb.linearize_discrete(
            cfg.robot, yaw, r_ref[..., k, :], refs.feet_w[..., k, :, :],
            refs.contacts[..., k, :], mpc.dt),
        out_axes=(-3, -3))(jnp.arange(Hh))

    if refs.cone_rot is not None:
        B = _rotate_B(B, refs.cone_rot)          # solve in the cone basis
    Sx_x0, Su = _condense(A, B, state0)          # (..,H,NX), (..,H,NX,H*NU)

    # cost: sum_k |x_k - xref_k|^2_Q + |u|^2_R
    q_diag = jnp.asarray(_q_diag(cfg), dtype)
    err0 = Sx_x0 - refs.x_ref                    # (.., H, NX)
    SuQ = Su * q_diag[..., None]                 # scale rows
    P = jnp.einsum("...hni,...hnj->...ij", SuQ, Su)
    P = P + mpc.w_force * jnp.eye(Hh * NU, dtype=dtype)
    qv = jnp.einsum("...hni,...hn->...i", SuQ, err0)

    # friction-pyramid inequalities: a CONSTANT block-diagonal matrix
    # (kron(I_H, pyramid)); only the stance mask is data
    import numpy as np
    blk, rhs_blk = _pyramid_constants(cfg)
    m_total = Hh * 4 * ROWS_PER_FOOT
    G_np = np.kron(np.eye(Hh), blk)                       # (m_total, H*NU)
    G = jnp.broadcast_to(jnp.asarray(G_np, dtype),
                         batch + (m_total, Hh * NU))
    h = jnp.broadcast_to(jnp.asarray(np.tile(rhs_blk, Hh), dtype),
                         batch + (m_total,))
    mask_blk = jnp.repeat(refs.contacts, ROWS_PER_FOOT, axis=-1)
    ineq_mask = mask_blk.reshape(batch + (m_total,))

    if mpc.base_box:
        # towr BaseMotionConstraint (base_motion_constraint.cc:46-55):
        # roll/pitch in +-dev_rad, base z in [z0 - below, z0 + above];
        # x/y/yaw free.  Exact on the condensed form: x_k = Sx_x0 + Su U,
        # so lo <= x_k[d] <= hi becomes two rows on U per knot per dim.
        dims = [0, 1, 5]                                  # roll, pitch, z
        z0 = state0[..., 5]
        dev = jnp.asarray(mpc.base_dev_rad, dtype)
        los = jnp.stack([-dev + 0.0 * z0, -dev + 0.0 * z0,
                         z0 - mpc.base_z_below], axis=-1)  # (.., 3)
        his = jnp.stack([dev + 0.0 * z0, dev + 0.0 * z0,
                         z0 + mpc.base_z_above], axis=-1)
        Su_d = Su[..., :, dims, :]                        # (.., H, 3, H*NU)
        Sx_d = Sx_x0[..., :, dims]                        # (.., H, 3)
        G_box = jnp.concatenate([Su_d, -Su_d], axis=-2)   # (.., H, 6, H*NU)
        h_box = jnp.concatenate([his[..., None, :] - Sx_d,
                                 Sx_d - los[..., None, :]], axis=-1)
        n_box = Hh * 2 * len(dims)
        G = jnp.concatenate(
            [G, G_box.reshape(batch + (n_box, Hh * NU))], axis=-2)
        h = jnp.concatenate([h, h_box.reshape(batch + (n_box,))], axis=-1)
        ineq_mask = jnp.concatenate(
            [ineq_mask, jnp.ones(batch + (n_box,), dtype)], axis=-1)

    if mpc.base_acc:
        # base-acceleration rows (towr BaseAcc analogue; see
        # StageQP.acc_rhs): per-knot input rows +-B_k[6:12,:] u_k <=
        # acc_rhs -+ A_k[6:12,12], block-diagonal on the stacked U
        SB = B[..., 6:12, :]                              # (.., H, 6, NU)
        off = A[..., 6:12, 12]                            # (.., H, 6)
        rhs6 = jnp.broadcast_to(
            jnp.asarray([mpc.acc_ang_max] * 3 + [mpc.acc_lin_max] * 3,
                        dtype) * mpc.dt, batch + (Hh, 6))
        eyeH = jnp.eye(Hh, dtype=dtype)
        Gacc = jnp.einsum("hk,...hrc->...hrkc", eyeH, SB).reshape(
            batch + (Hh * 6, Hh * NU))
        G = jnp.concatenate([G, Gacc, -Gacc], axis=-2)
        h = jnp.concatenate([h, (rhs6 - off).reshape(batch + (Hh * 6,)),
                             (rhs6 + off).reshape(batch + (Hh * 6,))],
                            axis=-1)
        ineq_mask = jnp.concatenate(
            [ineq_mask, jnp.ones(batch + (Hh * 12,), dtype)], axis=-1)

    # no equality rows (swing forces are decoupled + regularized to zero)
    Aeq = jnp.zeros(batch + (1, Hh * NU), dtype)
    beq = jnp.zeros(batch + (1,), dtype)
    em = jnp.zeros(batch + (1,), dtype)

    qp = QPData(P=P, q=qv, A=Aeq, b=beq, G=G, h=h,
                eq_mask=em, ineq_mask=ineq_mask)
    sol = solve_qp(qp, cfg.solver)

    states = Sx_x0 + jnp.einsum("...hnm,...m->...hn", Su, sol.x)
    U_knots = sol.x.reshape(batch + (Hh, NU))
    if refs.cone_rot is not None:
        U_knots = _forces_to_world(U_knots, refs.cone_rot)
    return MpcPlan(forces=U_knots.reshape(batch + (Hh, 4, 3)),
                   states=states, sol=sol)
