"""Riccati-IPM solver vs the condensed dense solver on identical MPC QPs.

The two solve the same optimization problem through entirely different
factorizations (banded LQR recursion vs dense Cholesky + Schur), so
agreement to tolerance is a strong end-to-end check of both.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from apf_quadruped.config import SolverConfig
from apf_quadruped.ops.qpsolve import QPData, solve_qp
from apf_quadruped.ops.riccati import StageQP, solve_stage_qp

CFG = SolverConfig(iters=30, reltol=1e-8, abstol=1e-8,
                   static_reg=1e-9, eq_reg=1e-9, w_clip=1e9)


def make_problem(rng, B=3, H=6, NX=5, NU=3, M=4, mask_frac=0.8):
    A = np.tile(np.eye(NX), (B, H, 1, 1)) + rng.normal(size=(B, H, NX, NX)) * 0.1
    Bm = rng.normal(size=(B, H, NX, NU)) * 0.3
    Q = np.diag(rng.uniform(0.5, 2.0, NX))
    R = np.diag(rng.uniform(0.1, 1.0, NU))
    qlin = rng.normal(size=(B, H, NX))
    G = rng.normal(size=(M, NU))
    h = rng.uniform(0.5, 2.0, M)           # u=0 strictly feasible
    mask = (rng.uniform(size=(B, H, M)) < mask_frac).astype(float)
    x0 = rng.normal(size=(B, NX)) * 0.5
    return (jnp.asarray(A), jnp.asarray(Bm), jnp.asarray(Q),
            jnp.asarray(qlin), jnp.asarray(R), jnp.asarray(G),
            jnp.asarray(h), jnp.asarray(mask), jnp.asarray(x0))


def condense_to_dense(A, Bm, Q, qlin, R, G, h, mask, x0):
    """Reference condensing (numpy, independent of planner code paths)."""
    B_, H, NX, NU = Bm.shape
    M = h.shape[0]
    n = H * NU
    P_out = np.zeros((B_, n, n))
    q_out = np.zeros((B_, n))
    G_out = np.zeros((B_, H * M, n))
    h_out = np.tile(np.asarray(h), H)[None].repeat(B_, 0)
    im_out = np.asarray(mask).reshape(B_, H * M)
    A, Bm, Q, qlin, x0 = map(np.asarray, (A, Bm, Q, qlin, x0))
    Gn = np.asarray(G)
    for b in range(B_):
        # Su[k] maps U to x_{k+1}; free response f[k]
        Su = np.zeros((H, NX, n))
        f = np.zeros((H, NX))
        x = x0[b]
        for k in range(H):
            if k == 0:
                f[k] = A[b, k] @ x
                Su[k, :, :NU] = Bm[b, k]
            else:
                f[k] = A[b, k] @ f[k - 1]
                Su[k] = A[b, k] @ Su[k - 1]
                Su[k, :, k * NU:(k + 1) * NU] += Bm[b, k]
        Pb = np.kron(np.eye(H), np.asarray(R))
        qb = np.zeros(n)
        for k in range(H):
            Pb += Su[k].T @ Q @ Su[k]
            qb += Su[k].T @ (Q @ f[k] + qlin[b, k])
        P_out[b] = Pb
        q_out[b] = qb
        for k in range(H):
            G_out[b, k * M:(k + 1) * M, k * NU:(k + 1) * NU] = Gn
    return P_out, q_out, G_out, h_out, im_out


def test_riccati_matches_condensed(rng):
    prob = make_problem(rng)
    A, Bm, Q, qlin, R, G, h, mask, x0 = prob
    sol_r = solve_stage_qp(StageQP(*prob), CFG)
    assert bool(np.all(sol_r.converged)), \
        f"riccati conv {sol_r.converged}, gap {sol_r.gap}, res {sol_r.res_norm}"

    P, q, Gd, hd, im = condense_to_dense(*prob)
    B_ = P.shape[0]
    n = P.shape[1]
    qp = QPData(P=jnp.asarray(P), q=jnp.asarray(q),
                A=jnp.zeros((B_, 1, n)), b=jnp.zeros((B_, 1)),
                G=jnp.asarray(Gd), h=jnp.asarray(hd),
                eq_mask=jnp.zeros((B_, 1)), ineq_mask=jnp.asarray(im))
    sol_d = solve_qp(qp, CFG)
    assert bool(np.all(sol_d.converged))

    u_r = np.asarray(sol_r.u).reshape(B_, -1)
    u_d = np.asarray(sol_d.x)
    np.testing.assert_allclose(u_r, u_d, atol=2e-5)


def test_riccati_unconstrained_matches_lstsq(rng):
    """All rows masked off -> pure LQR; compare against the dense
    least-squares solution of the condensed system."""
    prob = make_problem(rng, B=2, H=4, mask_frac=0.0)
    sol_r = solve_stage_qp(StageQP(*prob), CFG)
    P, q, Gd, hd, im = condense_to_dense(*prob)
    for b in range(2):
        u_ls = np.linalg.solve(P[b], -q[b])
        np.testing.assert_allclose(np.asarray(sol_r.u[b]).reshape(-1), u_ls,
                                   atol=1e-6)


def test_riccati_respects_active_constraints(rng):
    """Tight bounds: solution must be feasible and tight rows active."""
    A, Bm, Q, qlin, R, G, h, mask, x0 = make_problem(rng, B=4, H=5)
    h_tight = jnp.asarray(np.full(h.shape, 0.05))
    sol = solve_stage_qp(
        StageQP(A, Bm, Q, qlin * 5.0, R, G, h_tight, mask, x0), CFG)
    viol = (np.einsum("mn,bhn->bhm", np.asarray(G), np.asarray(sol.u))
            - 0.05) * np.asarray(mask)
    assert viol.max() < 1e-6


def test_float32_stage_solver(rng):
    prob = make_problem(rng, B=8, H=10, NX=13, NU=12, M=24)
    prob32 = tuple(jnp.asarray(v, jnp.float32) for v in prob)
    sol = solve_stage_qp(StageQP(*prob32),
                         SolverConfig(iters=20, reltol=1e-3, abstol=1e-3,
                                      static_reg=1e-6, w_clip=1e6))
    assert sol.u.dtype == jnp.float32
    assert float(np.mean(sol.converged)) >= 0.9


def test_f32_matches_f64_reference(rng):
    """The f32 solve (the accelerator's precision) tracks the f64 solve
    of the same problem: the Riccati factor and its substitutions lose
    no more than f32 roundoff."""
    prob = make_problem(rng, B=4, H=5, NX=6, NU=4, M=6)
    prob32 = tuple(jnp.asarray(v, jnp.float32) for v in prob)
    cfg = SolverConfig(iters=15, reltol=1e-4, abstol=1e-4,
                       static_reg=1e-6, w_clip=1e6)
    sol = solve_stage_qp(StageQP(*prob), cfg)
    sol32 = solve_stage_qp(StageQP(*prob32), cfg)
    assert np.asarray(sol32.converged).all()
    np.testing.assert_allclose(np.asarray(sol32.u), np.asarray(sol.u),
                               atol=2e-4)