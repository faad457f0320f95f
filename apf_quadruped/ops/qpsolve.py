"""Batched dense Mehrotra predictor-corrector interior-point QP solver.

Batched re-derivation of qpSWIFT (reference dogbot_controller/src/qpSWIFT/
qpSWIFT.c:473-660 and Auxilary.c) — the C sparse AMD+LDL' interior-point
solver the reference calls at 400 Hz (main.cpp:1649-1656).  Same algorithm
family (Mehrotra predictor-corrector with adaptive centering
sigma = clamp(rho)^3 and 0.99 fraction-to-boundary, qpSWIFT.c:567, 588-590),
completely different factorization strategy:

  * qpSWIFT: one problem at a time, sparse quasi-definite KKT
    [P A' G'; A 0 0; G 0 -W], AMD ordering + sparse LDL', data-dependent
    early exit.
  * here: THOUSANDS of problems in lockstep.  The inequality block is
    eliminated analytically (W^{-1} = diag(z/s)), giving the condensed
    positive-definite system
        H(z,s) = P + G' diag(z/s) G          (n x n)
    factored by dense Cholesky, with the equality block
    handled by a dense Schur complement  S_eq = A H^{-1} A'  (p x p).
    Fixed iteration count + per-batch convergence masks replace early
    exit (converged lanes freeze: their step length is zeroed), so one
    hard scenario cannot stall the batch (SURVEY.md §5.3).

Newton system per iteration (infeasible-start):
    P dx + A'dy + G'dz = -rx        rx = Px + q + A'y + G'z
    A dx               = -ry        ry = Ax - b
    G dx + ds          = -rz        rz = Gx + s - h
    Z ds + S dz        = rc         rc = -s.z (affine)
                                    rc = -(s.z + ds_a.dz_a - sigma*mu) (corr.)
Eliminating ds, dz:
    dz = W^{-1} (G dx + rz + rc/z),   ds = (rc - s.dz)/z,
    (P + G'W^{-1}G) dx + A'dy = -rx - G'W^{-1}(rz + rc/z).

Shape contract (all padded, fixed):
  P (n,n), q (n,), A (p,n), b (p,), G (m,n), h (m,)
  eq_mask (p,) / ineq_mask (m,): 1.0 = real row, 0.0 = padding.
Masked inequality rows are replaced by the always-slack row 0'x <= 1 and
masked equality rows by 0'x = 0 with a unit diagonal in the Schur
complement — both leave the central path of the true problem untouched
(verified in tests/test_qpsolve.py).

Solves:  min 1/2 x'Px + q'x   s.t.  Ax = b,  Gx <= h.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import SolverConfig


class QPData(NamedTuple):
    """One (possibly batched) QP in padded dense form."""

    P: jnp.ndarray      # (..., n, n)
    q: jnp.ndarray      # (..., n)
    A: jnp.ndarray      # (..., p, n)
    b: jnp.ndarray      # (..., p)
    G: jnp.ndarray      # (..., m, n)
    h: jnp.ndarray      # (..., m)
    eq_mask: jnp.ndarray    # (..., p)
    ineq_mask: jnp.ndarray  # (..., m)


class QPSolution(NamedTuple):
    x: jnp.ndarray          # (..., n) primal
    y: jnp.ndarray          # (..., p) equality multipliers
    z: jnp.ndarray          # (..., m) inequality multipliers
    s: jnp.ndarray          # (..., m) slacks
    converged: jnp.ndarray  # (...,) bool — residuals below tolerance
    iters: jnp.ndarray      # (...,) int32 — first iteration at which converged
    gap: jnp.ndarray        # (...,) final duality measure s'z/m
    res_norm: jnp.ndarray   # (...,) final max relative residual norm


def _apply_masks(qp: QPData) -> QPData:
    """Neutralize padded rows: masked ineq -> 0'x <= 1, masked eq -> 0'x = 0."""
    im = qp.ineq_mask
    em = qp.eq_mask
    G = qp.G * im[..., None]
    h = jnp.where(im > 0, qp.h, jnp.ones_like(qp.h))
    A = qp.A * em[..., None]
    b = qp.b * em
    return qp._replace(G=G, h=h, A=A, b=b)


def spd_factor(H: jnp.ndarray) -> jnp.ndarray:
    """Cholesky factor L of a (batch of) SPD matrices, H = L L'."""
    return jnp.linalg.cholesky(H)


def spd_solve(L: jnp.ndarray, r: jnp.ndarray) -> jnp.ndarray:
    """Solve H x = r given L = spd_factor(H).  r: (..., n) or (..., n, k)."""
    vec = r.ndim == L.ndim - 1
    if vec:
        r = r[..., None]
    w = jax.scipy.linalg.solve_triangular(L, r, lower=True)
    x = jax.scipy.linalg.solve_triangular(
        jnp.swapaxes(L, -1, -2), w, lower=False)
    return x[..., 0] if vec else x


def _steplen(s, ds, z, dz, frac, mask):
    """Max alpha in (0, 1] keeping s + a*ds > 0, z + a*dz > 0 over REAL rows.

    Mirrors qpSWIFT findsteplength + the fraction-to-boundary scaling
    (qpSWIFT.c:564, 588-590), vectorized over the batch.  Padded rows are
    excluded so they can never throttle the step.
    """
    def ratio(v, dv):
        neg = (dv < 0) & (mask > 0)
        r = jnp.where(neg, -v / jnp.where(neg, dv, -jnp.ones_like(dv)),
                      jnp.inf)
        return jnp.min(r, axis=-1)

    a = jnp.minimum(ratio(s, ds), ratio(z, dz))
    return jnp.minimum(frac * a, 1.0)


@partial(jax.jit, static_argnames=("cfg",))
def solve_qp(qp: QPData, cfg: SolverConfig = SolverConfig()) -> QPSolution:
    """Batched Mehrotra predictor-corrector IPM with fixed iteration count.

    Works for any leading batch shape (written fully batched, no vmap
    needed — though vmap also works).  dtype follows qp.P (f32 on the
    accelerator; f64 under x64 for validation).

    All contractions run at HIGHEST matmul precision: reduced-precision
    matmul passes (bf16 or TF32 mantissas) destroy the IPM's late
    iterations (NaN lanes); full-f32 accumulation is mandatory for the
    KKT algebra.
    """
    with jax.default_matmul_precision("highest"):
        return _solve_qp_impl(qp, cfg)


def _solve_qp_impl(qp: QPData, cfg: SolverConfig) -> QPSolution:
    qp = _apply_masks(qp)
    P, q, A, b, G, h = qp.P, qp.q, qp.A, qp.b, qp.G, qp.h
    dt = P.dtype
    batch = q.shape[:-1]
    n = q.shape[-1]
    p = b.shape[-1]
    imask = qp.ineq_mask
    m_eff = jnp.maximum(jnp.sum(imask, axis=-1), 1.0)   # (...,)

    eye_n = jnp.eye(n, dtype=dt)
    eye_p = jnp.eye(p, dtype=dt)
    reg = jnp.asarray(cfg.static_reg, dt)
    eq_reg = jnp.asarray(cfg.eq_reg, dt)
    # Padding eq rows get a unit diagonal in the Schur complement so it stays
    # invertible; real rows get only eq_reg.
    schur_diag = (eq_reg + (1.0 - qp.eq_mask))[..., None] * eye_p
    frac = jnp.asarray(cfg.frac_to_boundary, dt)
    min_slack = jnp.asarray(cfg.min_slack, dt)
    w_lo = jnp.asarray(1.0 / cfg.w_clip, dt)
    w_hi = jnp.asarray(cfg.w_clip, dt)

    At = jnp.swapaxes(A, -1, -2)

    def factor(W_inv):
        H = (P + reg * eye_n
             + jnp.einsum("...mn,...m,...mk->...nk", G, W_inv, G))
        F_h = spd_factor(H)
        HiAt = spd_solve(F_h, At)                      # (..., n, p)
        S_eq = jnp.einsum("...pn,...nk->...pk", A, HiAt) + schur_diag
        F_s = spd_factor(S_eq)
        return F_h, F_s

    def kkt_solve(L_h, L_s, W_inv, rhs_x, rhs_y):
        """Solve H dx + A'dy = rhs_x, A dx = rhs_y.

        cfg.refine_steps rounds of iterative refinement follow the direct
        solve: residuals are formed against the TRUE (unregularized)
        operator H = P + G'W^{-1}G via matvecs and re-solved through the
        stored factors.  This recovers the accuracy the f32 Cholesky +
        static_reg perturbation lose — the reference runs qpSWIFT in f64
        where this is moot; in f32 it buys ~2-3 digits on the
        stationarity residual at slack weights >= 1e6 (WBC swing rows).
        """
        def solve_once(rx_, ry_):
            t = spd_solve(L_h, rx_)
            dy = spd_solve(
                L_s, jnp.einsum("...pn,...n->...p", A, t) - ry_)
            dx = t - spd_solve(L_h,
                                   jnp.einsum("...np,...p->...n", At, dy))
            return dx, dy

        def H_mv(v):
            return (jnp.einsum("...nk,...k->...n", P, v)
                    + jnp.einsum("...mn,...m->...n", G,
                                 W_inv * jnp.einsum("...mn,...n->...m",
                                                    G, v)))

        dx, dy = solve_once(rhs_x, rhs_y)
        for _ in range(cfg.refine_steps):
            r1 = rhs_x - H_mv(dx) - jnp.einsum("...np,...p->...n", At, dy)
            r2 = rhs_y - jnp.einsum("...pn,...n->...p", A, dx)
            ddx, ddy = solve_once(r1, r2)
            dx = dx + ddx
            dy = dy + ddy
        return dx, dy

    # --- initial point: CVXOPT-style least-squares init with W = I:
    # solve [P+G'G, A'; A, 0][x;y] = [-q + G'h; b], then shift slacks/duals
    # interior.  (qpSWIFT's kkt_initialize plays the same role.)
    W_one = jnp.ones(h.shape, dt)
    L_h0, L_s0 = factor(W_one)
    x, y = kkt_solve(L_h0, L_s0, W_one,
                     -q + jnp.einsum("...mn,...m->...n", G, h), b)
    r0 = jnp.einsum("...mn,...n->...m", G, x) - h          # want <= 0
    shift = jnp.maximum(0.0, jnp.max(r0, axis=-1, keepdims=True)) + 1.0
    s = -r0 + shift
    z = jnp.maximum(r0, 0.0) + 1.0

    # Residual norms for the relative-tolerance test (qpSWIFT.c:521-534).
    bnorm = 1.0 + jnp.linalg.norm(b, axis=-1)
    hnorm = 1.0 + jnp.linalg.norm(h, axis=-1)
    qnorm = 1.0 + jnp.linalg.norm(q, axis=-1)

    def residuals(x, y, z, s):
        rx = (jnp.einsum("...nk,...k->...n", P, x) + q
              + jnp.einsum("...np,...p->...n", At, y)
              + jnp.einsum("...mn,...m->...n", G, z))
        ry = jnp.einsum("...pn,...n->...p", A, x) - b
        rz = jnp.einsum("...mn,...n->...m", G, x) + s - h
        return rx, ry, rz

    def res_norm(rx, ry, rz):
        return jnp.maximum(
            jnp.linalg.norm(rx, axis=-1) / qnorm,
            jnp.maximum(jnp.linalg.norm(ry, axis=-1) / bnorm,
                        jnp.linalg.norm(rz, axis=-1) / hnorm))

    def body(carry, _):
        x, y, z, s, done, it_conv, it = carry
        rx, ry, rz = residuals(x, y, z, s)
        mu = jnp.sum(s * z * imask, axis=-1) / m_eff

        now_conv = (res_norm(rx, ry, rz) < cfg.reltol) & (mu < cfg.abstol)
        it_conv = jnp.where(now_conv & ~done, it, it_conv)
        done = done | now_conv

        z_safe = jnp.maximum(z, min_slack)
        s_safe = jnp.maximum(s, min_slack)
        # The clip guards H's conditioning only: it makes the Newton step
        # INEXACT in the stationarity row (absorbed into rx next iteration),
        # while the primal and complementarity rows below stay EXACT, so
        # neither rz contraction nor the Mehrotra mu target can be broken
        # by clipping (an unclipped dz = W^{-1}(..+rc/z) blows mu up 10x
        # when the clip bites — seen on the planner QPs).
        W_inv = jnp.clip(z_safe / s_safe, w_lo, w_hi)      # (..., m)
        L_h, L_s = factor(W_inv)

        def newton(rc):
            # W^{-1} rc / z == rc / s (stable: no huge intermediates)
            rhs_x = -rx - jnp.einsum("...mn,...m->...n",
                                     G, W_inv * rz + rc / s_safe)
            dx, dy = kkt_solve(L_h, L_s, W_inv, rhs_x, -ry)
            Gdx = jnp.einsum("...mn,...n->...m", G, dx)
            ds = -rz - Gdx                       # primal row, exact
            dz = (rc - z * ds) / s_safe          # complementarity row, exact
            return dx, dy, dz, ds

        # predictor (affine scaling step, sigma = 0)
        dx_a, dy_a, dz_a, ds_a = newton(-s * z)
        alpha_a = _steplen(s, ds_a, z, dz_a, jnp.asarray(1.0, dt), imask)
        mu_aff = jnp.sum((s + alpha_a[..., None] * ds_a)
                         * (z + alpha_a[..., None] * dz_a) * imask,
                         axis=-1) / m_eff
        rho = mu_aff / jnp.maximum(mu, min_slack)
        sigma = jnp.clip(rho, 0.0, 1.0) ** cfg.sigma_pow   # qpSWIFT.c:567

        # corrector with Mehrotra second-order term
        rc = -(s * z + ds_a * dz_a - (sigma * mu)[..., None])
        dx, dy, dz, ds = newton(rc)

        alpha = _steplen(s, ds, z, dz, frac, imask)
        alpha = jnp.where(done, 0.0, alpha)[..., None]     # freeze converged
        x = x + alpha * dx
        y = y + alpha * dy
        z = jnp.maximum(z + alpha * dz, min_slack)
        s = jnp.maximum(s + alpha * ds, min_slack)
        return (x, y, z, s, done, it_conv, it + 1), None

    # derive inits from the full problem data so their device-varying axes
    # match the loop outputs under shard_map (fresh zeros are "unvarying");
    # qnorm/bnorm/hnorm touch every input array that can carry sharding
    seed0 = qnorm + bnorm + hnorm + jnp.sum(jnp.abs(x), axis=-1)
    done0 = seed0 < 0.0                                    # all-False
    it0 = cfg.iters + (0.0 * seed0).astype(jnp.int32)
    (x, y, z, s, done, it_conv, _), _ = jax.lax.scan(
        body, (x, y, z, s, done0, it0, jnp.int32(0)), None, length=cfg.iters)

    rx, ry, rz = residuals(x, y, z, s)
    mu = jnp.sum(s * z * imask, axis=-1) / m_eff
    res = res_norm(rx, ry, rz)
    conv = done | ((res < cfg.reltol) & (mu < cfg.abstol))

    # NaN quarantine (SURVEY.md §5.3): infeasible/blown-up lanes must come
    # back finite and flagged, never poison a batch.  (The reference never
    # even checks qpSWIFT's exit flag and uses garbage x, main.cpp:1656.)
    lane_ok = (jnp.all(jnp.isfinite(x), axis=-1)
               & jnp.all(jnp.isfinite(y), axis=-1)
               & jnp.all(jnp.isfinite(z), axis=-1))
    sanitize = lambda v: jnp.where(lane_ok[..., None], jnp.nan_to_num(v), 0.0)
    conv = conv & lane_ok
    return QPSolution(x=sanitize(x), y=sanitize(y), z=sanitize(z),
                      s=sanitize(s), converged=conv, iters=it_conv,
                      gap=jnp.nan_to_num(mu, nan=jnp.inf),
                      res_norm=jnp.nan_to_num(res, nan=jnp.inf))


def make_qp(P, q, G, h, A=None, b=None, eq_mask=None, ineq_mask=None) -> QPData:
    """Convenience constructor filling default masks / empty equality block."""
    P = jnp.asarray(P)
    q = jnp.asarray(q)
    G = jnp.asarray(G)
    h = jnp.asarray(h)
    batch = q.shape[:-1]
    n = q.shape[-1]
    if A is None:
        A = jnp.zeros(batch + (1, n), P.dtype)
        b = jnp.zeros(batch + (1,), P.dtype)
        eq_mask = jnp.zeros(batch + (1,), P.dtype)
    else:
        A = jnp.asarray(A)
        b = jnp.asarray(b)
        if eq_mask is None:
            eq_mask = jnp.ones(A.shape[:-1], P.dtype)
    if ineq_mask is None:
        ineq_mask = jnp.ones(h.shape, P.dtype)
    return QPData(P=P, q=q, A=A, b=b, G=G, h=h,
                  eq_mask=jnp.asarray(eq_mask), ineq_mask=jnp.asarray(ineq_mask))
