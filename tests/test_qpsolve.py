"""Batched IPM solver tests: KKT residuals, analytic cases, mask neutrality.

Validation strategy (SURVEY.md §4): the reference has no tests; golden data
is derived from the QP optimality conditions themselves and from analytic
miniature problems, at the reference's runtime tolerance (reltol = abstol =
1e-2, main.cpp:1651-1652) and tighter.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from apf_quadruped.config import SolverConfig
from apf_quadruped.ops.qpsolve import QPData, make_qp, solve_qp

# Tight tolerances for golden math checks (the reference's *runtime* setting
# is reltol = abstol = 1e-2; the f32 test below uses that).
# reltol floor ~ static_reg/eq_reg (1e-8 regularization bounds attainable
# residuals); 1e-7 is comfortably above it and far below runtime's 1e-2.
CFG = SolverConfig(iters=30, reltol=1e-7, abstol=1e-8,
                   static_reg=1e-8, eq_reg=1e-8, w_clip=1e8)


def random_qp(rng, n, m, p, batch=()):
    """Random strictly-convex QP with guaranteed strictly feasible interior."""
    sz = batch + (n, n)
    M = rng.normal(size=sz)
    P = np.einsum("...ij,...kj->...ik", M, M) / n + 0.5 * np.eye(n)
    q = rng.normal(size=batch + (n,))
    G = rng.normal(size=batch + (m, n))
    x0 = rng.normal(size=batch + (n,)) * 0.1          # strictly feasible point
    h = np.einsum("...mn,...n->...m", G, x0) + rng.uniform(0.1, 1.0, batch + (m,))
    A = rng.normal(size=batch + (p, n))
    b = np.einsum("...pn,...n->...p", A, x0)
    return P, q, G, h, A, b


def kkt_check(qp, sol, tol=1e-4):
    """Stationarity, primal feasibility, complementarity."""
    x, y, z = sol.x, sol.y, sol.z
    rx = (np.einsum("...ij,...j->...i", qp.P, x) + qp.q
          + np.einsum("...pi,...p->...i", qp.A * qp.eq_mask[..., None], y)
          + np.einsum("...mi,...m->...i", qp.G, z * qp.ineq_mask))
    assert np.abs(rx).max() < tol, f"stationarity {np.abs(rx).max()}"
    ry = (np.einsum("...pn,...n->...p", qp.A, x) - qp.b) * qp.eq_mask
    assert np.abs(ry).max() < tol, f"eq feasibility {np.abs(ry).max()}"
    viol = (np.einsum("...mn,...n->...m", qp.G, x) - qp.h) * qp.ineq_mask
    assert viol.max() < tol, f"ineq violation {viol.max()}"
    comp = np.abs(z * (qp.h - np.einsum("...mn,...n->...m", qp.G, x))) * qp.ineq_mask
    assert comp.max() < 10 * tol, f"complementarity {comp.max()}"


def test_box_qp_analytic():
    """min 1/2||x - c||^2 s.t. -1 <= x <= 1  ->  x* = clip(c, -1, 1)."""
    n = 6
    c = jnp.array([0.3, -2.0, 5.0, 0.0, -0.7, 1.5])
    P = jnp.eye(n)
    q = -c
    G = jnp.concatenate([jnp.eye(n), -jnp.eye(n)], axis=0)
    h = jnp.ones(2 * n)
    sol = solve_qp(make_qp(P, q, G, h), CFG)
    assert bool(sol.converged)
    np.testing.assert_allclose(sol.x, np.clip(np.asarray(c), -1, 1), atol=1e-5)


def test_equality_constrained():
    """min 1/2 x'x s.t. sum(x) = 1 -> x = 1/n (with inactive inequalities)."""
    n = 8
    P = jnp.eye(n)
    q = jnp.zeros(n)
    A = jnp.ones((1, n))
    b = jnp.ones(1)
    G = jnp.eye(n)
    h = jnp.full(n, 10.0)           # never active
    sol = solve_qp(make_qp(P, q, G, h, A, b), CFG)
    assert bool(sol.converged)
    np.testing.assert_allclose(sol.x, np.full(n, 1.0 / n), atol=1e-6)


def test_random_batch_kkt(rng):
    P, q, G, h, A, b = random_qp(rng, n=30, m=68, p=18, batch=(16,))
    sol = solve_qp(make_qp(P, q, G, h, A, b), CFG)
    assert bool(np.all(sol.converged)), f"{np.mean(sol.converged)} converged"
    kkt_check(make_qp(P, q, G, h, A, b), sol, tol=1e-4)


def test_mask_neutrality(rng):
    """Padding rows (masked out) must not change the solution."""
    P, q, G, h, A, b = random_qp(rng, n=12, m=20, p=4, batch=(4,))
    qp = make_qp(P, q, G, h, A, b)
    sol = solve_qp(qp, CFG)

    # pad with GARBAGE rows, masked off
    pad_G = np.concatenate([G, rng.normal(size=(4, 7, 12)) * 100], axis=1)
    pad_h = np.concatenate([h, -np.abs(rng.normal(size=(4, 7)))], axis=1)
    pad_A = np.concatenate([A, rng.normal(size=(4, 3, 12)) * 100], axis=1)
    pad_b = np.concatenate([b, rng.normal(size=(4, 3))], axis=1)
    im = np.concatenate([np.ones((4, 20)), np.zeros((4, 7))], axis=1)
    em = np.concatenate([np.ones((4, 4)), np.zeros((4, 3))], axis=1)
    sol_pad = solve_qp(QPData(P=jnp.asarray(P), q=jnp.asarray(q),
                              A=jnp.asarray(pad_A), b=jnp.asarray(pad_b),
                              G=jnp.asarray(pad_G), h=jnp.asarray(pad_h),
                              eq_mask=jnp.asarray(em), ineq_mask=jnp.asarray(im)),
                       CFG)
    assert bool(np.all(sol_pad.converged))
    np.testing.assert_allclose(sol_pad.x, sol.x, atol=1e-4)


def test_float32_convergence(rng):
    """The accelerator path is f32: the solver must hit the reference's runtime
    tolerance (1e-2) in f32 on WBC-sized problems."""
    P, q, G, h, A, b = random_qp(rng, n=30, m=70, p=18, batch=(32,))
    qp = make_qp(*(jnp.asarray(v, jnp.float32) for v in (P, q, G, h)),
                 jnp.asarray(A, jnp.float32), jnp.asarray(b, jnp.float32))
    sol = solve_qp(qp, SolverConfig(iters=25, reltol=1e-2, abstol=1e-2,
                                    static_reg=1e-6, eq_reg=1e-6, w_clip=1e6))
    assert sol.x.dtype == jnp.float32
    frac = float(np.mean(sol.converged))
    assert frac >= 0.95, f"only {frac:.2f} converged in f32"
    # compare against the f64 solve
    sol64 = solve_qp(make_qp(P, q, G, h, A, b), CFG)
    # lanes freeze once they hit the 1e-2 tolerance, so x carries O(10x tol)
    # error relative to the tight f64 solve — that is the accuracy the
    # reference itself runs at (main.cpp:1651-1652).
    err = np.abs(np.asarray(sol.x, np.float64) - sol64.x).max()
    assert err < 2e-1, f"f32 vs f64 deviation {err}"


def test_infeasible_inequalities_flagged(rng):
    """x <= -1 and -x <= -1 is infeasible: must report non-convergence,
    not NaN (failure detection, SURVEY.md §5.3)."""
    n = 4
    P = jnp.eye(n)
    q = jnp.zeros(n)
    G = jnp.concatenate([jnp.eye(n), -jnp.eye(n)], axis=0)
    h = -jnp.ones(2 * n)
    sol = solve_qp(make_qp(P, q, G, h), CFG)
    assert not bool(sol.converged)
    assert bool(np.all(np.isfinite(sol.x)))


def test_vmap_and_jit_compose(rng):
    P, q, G, h, A, b = random_qp(rng, n=10, m=12, p=3, batch=(8,))
    qp = make_qp(P, q, G, h, A, b)
    direct = solve_qp(qp, CFG)
    vmapped = jax.jit(jax.vmap(lambda d: solve_qp(d, CFG)))(qp)
    np.testing.assert_allclose(vmapped.x, direct.x, atol=1e-6)


def test_refine_steps_improves_f32_residual(rng):
    """Iterative refinement (SolverConfig.refine_steps) must tighten the
    stationarity residual on an ill-conditioned f32 QP (a 1e6-weighted
    soft-constraint block like the WBC swing rows)."""
    import jax.numpy as jnp

    from apf_quadruped.config import SolverConfig

    n, m = 12, 8
    W = rng.normal(size=(n, n))
    P = W @ W.T + np.eye(n)
    Aw = rng.normal(size=(3, n))
    P = P + 1e6 * Aw.T @ Aw          # stiff soft-constraint block
    q = rng.normal(size=n) * 10.0
    G = rng.normal(size=(m, n))
    h = rng.uniform(0.5, 1.5, m)
    qp = make_qp(jnp.asarray(P, jnp.float32), jnp.asarray(q, jnp.float32),
                 jnp.asarray(G, jnp.float32), jnp.asarray(h, jnp.float32))
    base = dict(iters=20, reltol=1e-6, abstol=1e-6, static_reg=1e-6,
                w_clip=1e6)
    r0 = float(solve_qp(qp, SolverConfig(refine_steps=0, **base)).res_norm)
    r2 = float(solve_qp(qp, SolverConfig(refine_steps=2, **base)).res_norm)
    assert r2 < r0 * 0.5, f"refinement did not help: {r0} -> {r2}"


def _spd(rng, B, n):
    M = rng.normal(size=(B, n, n))
    return np.einsum("bij,bkj->bik", M, M) + n * np.eye(n)


@pytest.mark.parametrize("n,k", [(18, 0), (30, 0), (18, 3), (30, 4)])
def test_spd_solve_matches_numpy(rng, n, k):
    """spd_factor + spd_solve at the physics (n=18) and WBC (n=30) sizes,
    vector (k=0) and matrix right-hand sides, against numpy."""
    from apf_quadruped.ops.qpsolve import spd_factor, spd_solve

    H = _spd(rng, 5, n)
    rhs = rng.normal(size=(5, n) if k == 0 else (5, n, k))
    L = spd_factor(jnp.asarray(H))
    np.testing.assert_allclose(np.asarray(L), np.linalg.cholesky(H),
                               atol=1e-10)
    X = spd_solve(L, jnp.asarray(rhs))
    ref = np.linalg.solve(H, rhs[..., None] if k == 0 else rhs)
    np.testing.assert_allclose(np.asarray(X),
                               ref[..., 0] if k == 0 else ref, atol=1e-10)


@pytest.mark.parametrize("n", [18, 30])
def test_spd_solve_vmapped_matches_explicit_batch(rng, n):
    """jax.vmap of a one-matrix factor+solve (how the sweep batches the
    physics and the WBC) agrees with the explicitly batched call."""
    from apf_quadruped.ops.qpsolve import spd_factor, spd_solve

    H = jnp.asarray(_spd(rng, 6, n), jnp.float32)
    r = jnp.asarray(rng.normal(size=(6, n)), jnp.float32)
    explicit = spd_solve(spd_factor(H), r)
    vmapped = jax.vmap(lambda h1, r1: spd_solve(spd_factor(h1), r1))(H, r)
    np.testing.assert_allclose(np.asarray(vmapped), np.asarray(explicit),
                               rtol=1e-5, atol=1e-6)


def test_solve_qp_vmapped_matches_explicit_batch_with_equalities(rng):
    """jax.vmap(solve_qp) agrees with the explicitly batched call on
    problems with equality rows (the WBC shape: the Schur complement's
    p x p factor is batched too)."""
    B, n, p, m = 6, 8, 3, 10
    A_ = rng.normal(size=(B, n, n))
    P = jnp.asarray(A_ @ A_.transpose(0, 2, 1) + n * np.eye(n), jnp.float32)
    q = jnp.asarray(rng.normal(size=(B, n)), jnp.float32)
    Aeq = jnp.asarray(rng.normal(size=(B, p, n)), jnp.float32)
    beq = jnp.asarray(rng.normal(size=(B, p)) * 0.1, jnp.float32)
    G = jnp.asarray(rng.normal(size=(B, m, n)), jnp.float32)
    h = jnp.asarray(np.abs(rng.normal(size=(B, m))) + 1.0, jnp.float32)
    qp = QPData(P=P, q=q, A=Aeq, b=beq, G=G, h=h,
                eq_mask=jnp.ones((B, p), jnp.float32),
                ineq_mask=jnp.ones((B, m), jnp.float32))
    cfg = SolverConfig(iters=25, reltol=1e-6, abstol=1e-6)
    explicit = solve_qp(qp, cfg)
    vmapped = jax.vmap(lambda one: solve_qp(one, cfg))(qp)
    assert np.asarray(explicit.converged).all()
    assert np.asarray(vmapped.converged).all()
    np.testing.assert_allclose(np.asarray(vmapped.x),
                               np.asarray(explicit.x), atol=5e-5)
