"""Structure-exploiting interior-point solver for the horizon MPC QP.

The condensed planner QP (planner.plan) is dense in U = [u_0..u_{H-1}]
(n = 12H): each IPM iteration costs a (12H)^3/3 Cholesky.  But the TRUE
structure is stage-wise (SURVEY.md §5.7): the dynamics couple neighbors
only, and every inequality touches a single knot's u_k.  This module
solves the SAME problem by a Riccati (LQR) backward/forward pass inside
the Mehrotra predictor-corrector loop:

    min   sum_k 1/2 x_{k+1}' Q x_{k+1} + q_k' x_{k+1}
              + 1/2 u_k' R u_k
    s.t.  x_{k+1} = A_k x_k + B_k u_k          (x_0 given; affine folded
                                                into the state carrier)
          G u_k <= h          per knot, masked by the stance schedule

Per IPM iteration:
  * barrier Hessian  R_k = R + G' diag(z_k/s_k) G   (12x12 per knot)
  * ONE matrix Riccati backward pass:  P_k, chol(M_k = R_k + B' P B)
  * TWO vector passes (predictor + corrector) against the stored
    factorizations — exactly qpSWIFT's kktsolve_1/kktsolve_2 split
    (qpSWIFT.c:555/584) transplanted onto the banded structure.

Per-iteration FLOPs: H * O(NX^3) ~ 2e5 vs (12H)^3/3 ~ 5e6 at H=20 — and
every operation is a small batched matmul that XLA vectorizes over the
scenario batch.  Replaces qpSWIFT's AMD+LDL' sparse path with the
factorization matched to the MPC horizon (BASELINE.json north star).

Interface mirrors ops.qpsolve: fixed iteration count, per-lane convergence
masks, NaN quarantine.  Validated against the condensed solver in
tests/test_riccati.py.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import SolverConfig
from .qpsolve import spd_factor, spd_solve


class StageQP(NamedTuple):
    """Stage-wise MPC QP data (leading batch dims allowed on everything).

    A: (.., H, NX, NX), B: (.., H, NX, NU)
    Q: (NX, NX) state cost (applied to x_{k+1}), qlin: (.., H, NX)
    R: (NU, NU) input cost
    G: (M, NU) per-knot inequality block (CONSTANT), h: (M,)
    mask: (.., H, M) row masks (stance schedule)
    x0: (.., NX)

    Optional STATE inequality rows  Cx @ x_{k+1} <= cx_k  (masked), the
    stage-structured home of towr's BaseMotionConstraint
    (base_motion_constraint.cc:44-56) and any future RoM-at-knot rows:
    Cx: (MC, NX) constant row matrix, cx: (.., H, MC) per-knot rhs,
    mask_x: (.., H, MC).  All three None = input-only rows (the default
    problem).  Inside the IPM the state rows add a per-knot barrier term
    Cx' diag(W) Cx to the Riccati cost-to-go and a Cx' z term to the
    costates — the factorization stays banded, O(H NX^3)/iter.
    """

    A: jnp.ndarray
    B: jnp.ndarray
    Q: jnp.ndarray
    qlin: jnp.ndarray
    R: jnp.ndarray
    G: jnp.ndarray
    h: jnp.ndarray
    mask: jnp.ndarray
    x0: jnp.ndarray
    Cx: jnp.ndarray | None = None
    cx: jnp.ndarray | None = None
    mask_x: jnp.ndarray | None = None
    # Optional STATE-DELTA rows |(x_{k+1} - x_k)[6:12]| <= acc_rhs
    # (MpcConfig.base_acc — towr's BaseAcc analogue).  acc_rhs: (6,)
    # per-dim bound on the velocity-state CHANGE per step (acc_max*dt).
    # Assumes the SRB state layout (dims 6:12 = [omega; v] with the
    # affine carrier at column 12): the rows reduce to per-knot INPUT
    # rows +-B_k[6:12,:] u <= acc_rhs -+ A_k[6:12,12], which the solver
    # derives from (A, B) — no extra matrix data.  Solutions gain 12
    # inequality rows: z/s come back as (.., H, M + 12) with the accel
    # rows LAST (and WarmStart.z/s are expected in the same layout).
    acc_rhs: jnp.ndarray | None = None


class StageSolution(NamedTuple):
    u: jnp.ndarray          # (.., H, NU)
    x: jnp.ndarray          # (.., H, NX) predicted states (after step k)
    z: jnp.ndarray          # (.., H, M)
    s: jnp.ndarray          # (.., H, M)
    converged: jnp.ndarray  # (..,)
    iters: jnp.ndarray      # (..,)
    gap: jnp.ndarray        # (..,)
    res_norm: jnp.ndarray   # (..,)
    # state-row duals/slacks (None unless StageQP carried Cx rows)
    zx: jnp.ndarray | None = None   # (.., H, MC)
    sx: jnp.ndarray | None = None   # (.., H, MC)


def _bmm(a, b):
    return jnp.einsum("...ij,...jk->...ik", a, b)


def _bmv(a, v):
    return jnp.einsum("...ij,...j->...i", a, v)


class WarmStart(NamedTuple):
    """Previous-solve warm start for the stage-QP IPM (closed-loop replans
    change little between cycles — PERF.md lever 1).

    u: (.., H, NU), z/s: (.., H, M) — a previous StageSolution's fields,
    possibly leg-permuted for a phase-mirrored gait cycle (runtime.loop).
    valid: (..,) bool per lane; False lanes fall back to the cold init
    (shapes stay static, so the first cycle of a scanned rollout can carry
    an all-False WarmStart).  z/s are floored to cfg.warm_floor to push
    the start back into the interior.
    """

    u: jnp.ndarray
    z: jnp.ndarray
    s: jnp.ndarray
    valid: jnp.ndarray


@partial(jax.jit, static_argnames=("cfg",))
def solve_stage_qp(qp: StageQP, cfg: SolverConfig = SolverConfig(),
                   warm: WarmStart | None = None):
    with jax.default_matmul_precision("highest"):
        return _solve_impl(qp, cfg, warm)


def _solve_impl(qp: StageQP, cfg: SolverConfig,
                warm: WarmStart | None = None) -> StageSolution:
    dt = qp.x0.dtype
    batch = qp.x0.shape[:-1]
    Hh = qp.A.shape[-3]
    NX = qp.A.shape[-1]
    NU = qp.B.shape[-1]
    M = qp.h.shape[-1]

    mask = qp.mask                                        # (.., H, M)
    G = qp.G * 1.0                                        # (M, NU)
    hvec = jnp.broadcast_to(qp.h, batch + (Hh, M))
    hvec = jnp.where(mask > 0, hvec, jnp.ones_like(hvec))
    Gm = mask[..., None] * G                              # (.., H, M, NU)

    if qp.acc_rhs is not None:
        # base-acceleration rows (StageQP.acc_rhs): per-knot input rows
        # +-B[6:12,:] u <= acc_rhs -+ A[6:12,12], appended to the
        # per-knot row set (Gm is already per-knot data here)
        SB = qp.B[..., 6:12, :]                           # (.., H, 6, NU)
        off = qp.A[..., 6:12, 12]                         # (.., H, 6)
        rhs6 = jnp.broadcast_to(qp.acc_rhs.astype(dt), batch + (Hh, 6))
        Gm = jnp.concatenate([Gm, SB, -SB], axis=-2)
        hvec = jnp.concatenate([hvec, rhs6 - off, rhs6 + off], axis=-1)
        mask = jnp.concatenate(
            [mask, jnp.ones(batch + (Hh, 12), dt)], axis=-1)
        M = M + 12

    # optional STATE rows Cx x_{k+1} <= cx; absent -> MC = 0 zero-size
    # arrays, which XLA compiles away entirely (one code path, no cost)
    has_x = qp.Cx is not None
    if has_x:
        Cx = qp.Cx.astype(dt)                             # (MC, NX)
        MC = Cx.shape[0]
        mask_x = jnp.broadcast_to(qp.mask_x, batch + (Hh, MC)).astype(dt)
        cxv = jnp.broadcast_to(qp.cx, batch + (Hh, MC)).astype(dt)
        cxv = jnp.where(mask_x > 0, cxv, jnp.ones_like(cxv))
    else:
        MC = 0
        Cx = jnp.zeros((0, NX), dt)
        mask_x = jnp.zeros(batch + (Hh, 0), dt)
        cxv = jnp.zeros(batch + (Hh, 0), dt)
    Cm = mask_x[..., None] * Cx                           # (.., H, MC, NX)
    m_eff = jnp.maximum(jnp.sum(mask, axis=(-1, -2))
                        + jnp.sum(mask_x, axis=(-1, -2)), 1.0)

    reg = jnp.asarray(cfg.static_reg, dt)
    min_slack = jnp.asarray(cfg.min_slack, dt)
    w_hi = jnp.asarray(cfg.w_clip, dt)
    frac = jnp.asarray(cfg.frac_to_boundary, dt)
    eye_u = jnp.eye(NU, dtype=dt)

    # move horizon axis to front for scans: (H, .., ...)
    def h_first(x):
        return jnp.moveaxis(x, len(batch), 0)

    def h_last(x):
        return jnp.moveaxis(x, 0, len(batch))

    A_t = h_first(qp.A)
    B_t = h_first(qp.B)
    q_t = h_first(qp.qlin)
    G_t = h_first(Gm)
    h_t = h_first(hvec)
    mask_t = h_first(mask)
    C_t = h_first(Cm)
    cx_t = h_first(cxv)
    maskx_t = h_first(mask_x)

    def rollout(u_t):
        """x_{k+1} sequence from controls (H, .., NU)."""
        def stepf(x, inp):
            Ak, Bk, uk = inp
            xn = _bmv(Ak, x) + _bmv(Bk, uk)
            return xn, xn
        _, xs = jax.lax.scan(stepf, qp.x0, (A_t, B_t, u_t))
        return xs                                         # (H, .., NX)

    def residuals(u_t, z_t, s_t, zx_t, sx_t, x_t):
        """rx: stationarity in u (via costates), rz: G u + s - h,
        rzx: Cm x_{k+1} + sx - cx.

        Stationarity: du L = R u_k + B_k' lam_{k+1} + G' z_k where lam is
        the exact adjoint of the rollout cost sum 1/2 x'Qx + q'x plus the
        state-row dual term Cm' zx at each successor state.
        """
        def bwd(lam, inp):
            Ak, xk, qk, Cmk, zxk = inp
            lam_k = (_bmv(qp.Q, xk) + qk + lam
                     + jnp.einsum("...mi,...m->...i", Cmk, zxk))
            return _bmv(jnp.swapaxes(Ak, -1, -2), lam_k), lam_k
        # derive the zero carry from x0 so its device-varying axes match
        # the scan outputs under shard_map(check_vma=True)
        lam0 = jnp.zeros(batch + (NX,), dt) + 0.0 * qp.x0
        _, lam_t = jax.lax.scan(bwd, lam0, (A_t, x_t, q_t, C_t, zx_t),
                                reverse=True)
        # lam_t[k] = Q x_k + q_k + Cm' zx_k + A_{k+1}' lam_{k+1}
        rx = (_bmv(jnp.broadcast_to(qp.R.astype(dt), batch + (NU, NU)), u_t)
              + _bmv(jnp.swapaxes(B_t, -1, -2), lam_t)
              + _bmv(jnp.swapaxes(G_t, -1, -2), z_t))  # noqa: E127
        rz = _bmv(G_t, u_t) + s_t - h_t
        rzx = _bmv(C_t, x_t) + sx_t - cx_t
        return rx, rz, rzx, lam_t

    def riccati_factor(W_t, Wx_t):
        """Backward matrix pass with barrier Hessians R_k = R + G'WG and
        state-row barrier Q-additions Cm' Wx Cm folded into the carry.

        Carry is Pbar_{k+1} = Q + P_{k+1}: the cost-to-go Hessian at
        x_{k+1} INCLUDING that stage's own state cost (every stage's cost
        is on x_{k+1}, so the terminal init is Pbar_H = Q).
        Returns per-knot factorizations and gains K_k."""
        def bwd(Pbar, inp):
            Ak, Bk, Gk, Wk, Cmk, Wxk = inp
            Pb = Pbar + jnp.einsum("...mi,...m,...mj->...ij", Cmk, Wxk, Cmk)
            Rk = qp.R + reg * eye_u + jnp.einsum(
                "...mi,...m,...mj->...ij", Gk, Wk, Gk)
            BtP = _bmm(jnp.swapaxes(Bk, -1, -2), Pb)      # (..,NU,NX)
            Mk = Rk + _bmm(BtP, Bk)
            Lk = spd_factor(Mk)
            BtPA = _bmm(BtP, Ak)
            K = spd_solve(Lk, BtPA)                       # (..,NU,NX)
            AtP = _bmm(jnp.swapaxes(Ak, -1, -2), Pb)
            Pnext = (qp.Q + _bmm(AtP, Ak)
                     - _bmm(jnp.swapaxes(K, -1, -2), BtPA))
            Pnext = 0.5 * (Pnext + jnp.swapaxes(Pnext, -1, -2))
            return Pnext, (Lk, K)
        Pbar_H = jnp.broadcast_to(qp.Q.astype(dt), batch + (NX, NX))
        Pbar_H = Pbar_H + 0.0 * qp.x0[..., 0:1, None]
        _, (L_t, K_t) = jax.lax.scan(
            bwd, Pbar_H, (A_t, B_t, G_t, W_t, C_t, Wx_t), reverse=True)
        return L_t, K_t

    def riccati_solve(L_t, K_t, rx_t, rz_over_t, vmx_t):
        """Vector (affine LQR) pass: solve the Newton system
            Hess(U) dU = rhs,  rhs_k = -(rx_k + rz_over_k)
        against the stored factorizations, with the state rows' linear
        term vmx_k = mask_x (Wx rzx + rcx/sx) entering the value gradient
        at x_{k+1} — two of these per IPM iteration (predictor +
        corrector), one riccati_factor.  Returns (du_t, dx1_t) with
        dx1_t the dx_{k+1} sequence (the state rows' step direction).
        """
        rhs_t = -(rx_t + rz_over_t)                       # (H, .., NU)

        def bwd(sv, inp):
            Ak, Bk, Lk, Kk, rk, Cmk, vmxk = inp
            # sv = value gradient at x_{k+1}; state rows add Cm' vmx there
            sv = sv + jnp.einsum("...mi,...m->...i", Cmk, vmxk)
            g_u = -rk + _bmv(jnp.swapaxes(Bk, -1, -2), sv)
            kff = spd_solve(Lk, g_u)                      # (..,NU)
            s_k = (_bmv(jnp.swapaxes(Ak, -1, -2), sv)
                   - _bmv(jnp.swapaxes(Kk, -1, -2), g_u))
            return s_k, kff
        s0 = jnp.zeros(batch + (NX,), dt) + 0.0 * qp.x0
        _, kff_t = jax.lax.scan(
            bwd, s0, (A_t, B_t, L_t, K_t, rhs_t, C_t, vmx_t), reverse=True)

        def fwd(dx, inp):
            Ak, Bk, Kk, kffk = inp
            du = -_bmv(Kk, dx) - kffk
            dxn = _bmv(Ak, dx) + _bmv(Bk, du)
            return dxn, (du, dxn)
        dx0 = jnp.zeros(batch + (NX,), dt) + 0.0 * qp.x0
        _, (du_t, dx1_t) = jax.lax.scan(fwd, dx0, (A_t, B_t, K_t, kff_t))
        return du_t, dx1_t

    # --- initial point ---------------------------------------------------
    u_t = jnp.zeros((Hh,) + batch + (NU,), dt) + 0.0 * qp.x0[..., 0:1]
    x_t = rollout(u_t)
    r0 = _bmv(G_t, u_t) - h_t
    r0x = _bmv(C_t, x_t) - cx_t
    shift = jnp.maximum(0.0, jnp.max(r0, axis=(0, -1), keepdims=True)) + 1.0
    if MC:
        shiftx = jnp.maximum(
            0.0, jnp.max(r0x, axis=(0, -1), keepdims=True)) + 1.0
    else:
        shiftx = jnp.asarray(1.0, dt)      # zero-size rows: value unused
    s_t = -r0 + shift
    z_t = jnp.maximum(r0, 0.0) + 1.0
    sx_t = -r0x + shiftx
    zx_t = jnp.maximum(r0x, 0.0) + 1.0
    if warm is not None:
        floor = jnp.asarray(cfg.warm_floor, dt)
        v = warm.valid[..., None]                         # (.., 1)
        u_t = jnp.where(v, h_first(warm.u), u_t)
        z_t = jnp.where(v, jnp.maximum(h_first(warm.z), floor), z_t)
        s_t = jnp.where(v, jnp.maximum(h_first(warm.s), floor), s_t)

    qnorm = 1.0 + jnp.sqrt(jnp.sum(q_t * q_t, axis=(0, -1)))
    hnorm = (1.0 + jnp.sqrt(jnp.sum(h_t * h_t, axis=(0, -1))
                            + jnp.sum(cx_t * cx_t, axis=(0, -1))))

    def steplen(s, ds, z, dz, sx, dsx, zx, dzx, f):
        def ratio(v, dv, mk):
            neg = (dv < 0) & (mk > 0)
            r = jnp.where(neg, -v / jnp.where(neg, dv, -jnp.ones_like(dv)),
                          jnp.inf)
            return jnp.min(r, axis=(0, -1))
        a = jnp.minimum(ratio(s, ds, mask_t), ratio(z, dz, mask_t))
        if MC:
            a = jnp.minimum(a, jnp.minimum(ratio(sx, dsx, maskx_t),
                                           ratio(zx, dzx, maskx_t)))
        return jnp.minimum(f * a, 1.0)

    def body(carry, it):
        u_t, z_t, s_t, zx_t, sx_t, done, it_conv = carry
        x_t = rollout(u_t)
        rx_t, rz_t, rzx_t, _ = residuals(u_t, z_t, s_t, zx_t, sx_t, x_t)
        mu = (jnp.sum(s_t * z_t * mask_t, axis=(0, -1))
              + jnp.sum(sx_t * zx_t * maskx_t, axis=(0, -1))) / m_eff
        res = jnp.maximum(
            jnp.sqrt(jnp.sum(rx_t * rx_t, axis=(0, -1))) / qnorm,
            jnp.sqrt(jnp.sum((rz_t * mask_t) ** 2, axis=(0, -1))
                     + jnp.sum((rzx_t * maskx_t) ** 2, axis=(0, -1)))
            / hnorm)
        now = (res < cfg.reltol) & (mu < cfg.abstol)
        it_conv = jnp.where(now & ~done, it, it_conv)
        done = done | now

        z_safe = jnp.maximum(z_t, min_slack)
        s_safe = jnp.maximum(s_t, min_slack)
        W_t = jnp.clip(z_safe / s_safe, 0.0, w_hi)
        zx_safe = jnp.maximum(zx_t, min_slack)
        sx_safe = jnp.maximum(sx_t, min_slack)
        Wx_t = jnp.clip(zx_safe / sx_safe, 0.0, w_hi)
        L_t, K_t = riccati_factor(W_t, Wx_t)

        def newton(rc, rcx):
            rz_over = _bmv(jnp.swapaxes(G_t, -1, -2),
                           W_t * rz_t + rc / s_safe)
            vmx = maskx_t * (Wx_t * rzx_t + rcx / sx_safe)
            du_t, dx1_t = riccati_solve(L_t, K_t, rx_t, rz_over, vmx)
            Gdu = _bmv(G_t, du_t)
            ds = -rz_t - Gdu
            dz = (rc - z_t * ds) / s_safe
            dsx = -rzx_t - _bmv(C_t, dx1_t)
            dzx = (rcx - zx_t * dsx) / sx_safe
            return du_t, dz, ds, dzx, dsx

        du_a, dz_a, ds_a, dzx_a, dsx_a = newton(-s_t * z_t, -sx_t * zx_t)
        a_a = steplen(s_t, ds_a, z_t, dz_a, sx_t, dsx_a, zx_t, dzx_a,
                      jnp.asarray(1.0, dt))[..., None]
        mu_aff = (jnp.sum((s_t + a_a * ds_a) * (z_t + a_a * dz_a) * mask_t,
                          axis=(0, -1))
                  + jnp.sum((sx_t + a_a * dsx_a) * (zx_t + a_a * dzx_a)
                            * maskx_t, axis=(0, -1))) / m_eff
        sigma = jnp.clip(mu_aff / jnp.maximum(mu, min_slack), 0.0,
                         1.0) ** cfg.sigma_pow
        rc = -(s_t * z_t + ds_a * dz_a - (sigma * mu)[..., None])
        rcx = -(sx_t * zx_t + dsx_a * dzx_a - (sigma * mu)[..., None])
        du_t, dz, ds, dzx, dsx = newton(rc, rcx)

        a = steplen(s_t, ds, z_t, dz, sx_t, dsx, zx_t, dzx, frac)
        a = jnp.where(done, 0.0, a)[..., None]
        u_t = u_t + a * du_t
        z_t2 = jnp.maximum(z_t + a * dz, min_slack)
        s_t2 = jnp.maximum(s_t + a * ds, min_slack)
        zx_t2 = jnp.maximum(zx_t + a * dzx, min_slack)
        sx_t2 = jnp.maximum(sx_t + a * dsx, min_slack)
        return (u_t, z_t2, s_t2, zx_t2, sx_t2, done, it_conv), None

    seed0 = qnorm + hnorm
    done0 = seed0 < 0.0
    it0 = cfg.iters + (0.0 * seed0).astype(jnp.int32)
    (u_t, z_t, s_t, zx_t, sx_t, done, it_conv), _ = jax.lax.scan(
        body, (u_t, z_t, s_t, zx_t, sx_t, done0, it0),
        jnp.arange(cfg.iters, dtype=jnp.int32))

    x_t = rollout(u_t)
    rx_t, rz_t, rzx_t, _ = residuals(u_t, z_t, s_t, zx_t, sx_t, x_t)
    mu = (jnp.sum(s_t * z_t * mask_t, axis=(0, -1))
          + jnp.sum(sx_t * zx_t * maskx_t, axis=(0, -1))) / m_eff
    res = jnp.maximum(
        jnp.sqrt(jnp.sum(rx_t * rx_t, axis=(0, -1))) / qnorm,
        jnp.sqrt(jnp.sum((rz_t * mask_t) ** 2, axis=(0, -1))
                 + jnp.sum((rzx_t * maskx_t) ** 2, axis=(0, -1))) / hnorm)
    conv = done | ((res < cfg.reltol) & (mu < cfg.abstol))

    u = h_last(u_t)
    x = h_last(x_t)
    lane_ok = (jnp.all(jnp.isfinite(u), axis=(-1, -2))
               & jnp.all(jnp.isfinite(x), axis=(-1, -2)))
    fix = lambda v: jnp.where(lane_ok[..., None, None], jnp.nan_to_num(v),
                              0.0)
    return StageSolution(
        u=fix(u), x=fix(x), z=fix(h_last(z_t)), s=fix(h_last(s_t)),
        converged=conv & lane_ok, iters=it_conv,
        gap=jnp.nan_to_num(mu, nan=jnp.inf),
        res_norm=jnp.nan_to_num(res, nan=jnp.inf),
        zx=fix(h_last(zx_t)) if has_x else None,
        sx=fix(h_last(sx_t)) if has_x else None)
