"""Stage-wise Riccati IPM (ops.riccati.solve_stage_qp): problem cases
against the condensed dense reference, warm starting, masks, NaN
quarantine and batching.

The scan solver is the production planner path on the GPU and the CPU;
the condensed dense solver (ops.qpsolve on the stacked-force QP) is an
independent factorization of the same problem, so agreement checks both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from apf_quadruped.config import SolverConfig
from apf_quadruped.ops.qpsolve import QPData, solve_qp
from apf_quadruped.ops.riccati import StageQP, WarmStart, solve_stage_qp
from test_riccati import condense_to_dense

# f32 settings of the warm-start and quarantine tests
CFG = SolverConfig(iters=15, reltol=1e-4, abstol=1e-4,
                   static_reg=1e-6, w_clip=1e6)
# tight f64 settings for the comparison with the condensed reference
CFG64 = SolverConfig(iters=60, reltol=1e-8, abstol=1e-8,
                     static_reg=1e-9, eq_reg=1e-9, w_clip=1e9)


def make_problem(rng, B=4, H=5, NX=6, NU=4, M=6, mask_frac=0.8,
                 diag_q=True, dtype=jnp.float32):
    A = np.tile(np.eye(NX), (B, H, 1, 1)) + rng.normal(size=(B, H, NX, NX)) * 0.1
    Bm = rng.normal(size=(B, H, NX, NU)) * 0.3
    if diag_q:
        Q = np.diag(rng.uniform(0.5, 2.0, NX))
        R = np.diag(rng.uniform(0.1, 1.0, NU))
    else:
        # dense SPD costs — exercises the full-matrix Q/R terms
        W1 = rng.normal(size=(NX, NX)) * 0.3
        Q = W1 @ W1.T + 0.5 * np.eye(NX)
        W2 = rng.normal(size=(NU, NU)) * 0.3
        R = W2 @ W2.T + 0.2 * np.eye(NU)
    qlin = rng.normal(size=(B, H, NX))
    G = rng.normal(size=(M, NU))
    h = rng.uniform(0.5, 2.0, M)
    mask = (rng.uniform(size=(B, H, M)) < mask_frac).astype(np.float64)
    x0 = rng.normal(size=(B, NX)) * 0.5
    cast = lambda v: jnp.asarray(v, dtype)
    return StageQP(A=cast(A), B=cast(Bm), Q=cast(Q), qlin=cast(qlin),
                   R=cast(R), G=cast(G), h=cast(h), mask=cast(mask),
                   x0=cast(x0))


def condensed_u(qp, all_converged=True):
    """(B, H, NU) solution of the same problem by the dense solver."""
    args = [np.asarray(v) for v in (qp.A, qp.B, qp.Q, qp.qlin, qp.R, qp.G,
                                    qp.h, qp.mask, qp.x0)]
    P, q, Gd, hd, im = condense_to_dense(*args)
    B_, n = P.shape[0], P.shape[1]
    sol = solve_qp(QPData(P=jnp.asarray(P), q=jnp.asarray(q),
                          A=jnp.zeros((B_, 1, n)), b=jnp.zeros((B_, 1)),
                          G=jnp.asarray(Gd), h=jnp.asarray(hd),
                          eq_mask=jnp.zeros((B_, 1)),
                          ineq_mask=jnp.asarray(im)), CFG64)
    conv = np.asarray(sol.converged)
    assert conv.all() or not all_converged
    u = np.asarray(sol.x).reshape(qp.B.shape[0], qp.A.shape[1], -1)
    return u if all_converged else (u, conv)


def _tight(qp):
    return qp._replace(h=jnp.full_like(qp.h, 0.05), qlin=qp.qlin * 5.0)


# name -> (problem kwargs, transform, atol)
CASES = {
    "diagonal_costs": (dict(), None, 2e-5),
    "nondiagonal_costs": (dict(diag_q=False), None, 2e-5),
    "mpc_sized": (dict(B=2, H=6, NX=13, NU=12, M=24), None, 2e-5),
    "all_masked": (dict(mask_frac=0.0), None, 2e-5),
    "active_constraints": (dict(), _tight, 2e-5),
    "unbatched": (dict(B=1), None, 2e-5),
    "nan_quarantine": (dict(), None, 2e-5),
    # 37 random problems: a few near-degenerate active sets differ by
    # ~6e-5 between the two factorizations at the 1e-8 stop
    "lane_boundary": (dict(B=37, H=3, NX=4, NU=3, M=4), None, 1e-4),
}


@pytest.mark.parametrize("case", list(CASES))
def test_stage_solver_matches_condensed(rng, case):
    """Problem cases through the scan solver (f64) and the condensed
    dense reference: same solution to the solvers' tolerance."""
    kw, transform, atol = CASES[case]
    qp = make_problem(rng, dtype=jnp.float64, **kw)
    if transform is not None:
        qp = transform(qp)
    if case == "active_constraints":
        # tight random bounds can leave a lane without an interior point
        # at the 1e-8 stop in either solver; compare the lanes both
        # solved, and feasibility wherever the scan solver converged
        ref, ok = condensed_u(qp, all_converged=False)
        sol = solve_stage_qp(qp, CFG64)
        conv = np.asarray(sol.converged)
        both = conv & ok
        assert both.sum() >= 2
        np.testing.assert_allclose(np.asarray(sol.u)[both], ref[both],
                                   atol=atol)
        viol = (np.einsum("mn,bhn->bhm", np.asarray(qp.G),
                          np.asarray(sol.u)) - 0.05) * np.asarray(qp.mask)
        assert viol[conv].max() < 1e-6
        return
    ref = condensed_u(qp)
    if case == "unbatched":
        one = StageQP(A=qp.A[0], B=qp.B[0], Q=qp.Q, qlin=qp.qlin[0],
                      R=qp.R, G=qp.G, h=qp.h, mask=qp.mask[0], x0=qp.x0[0])
        sol = solve_stage_qp(one, CFG64)
        assert sol.u.shape == ref.shape[1:]
        assert np.asarray(sol.converged).shape == ()
        np.testing.assert_allclose(np.asarray(sol.u), ref[0], atol=atol)
        return
    if case == "nan_quarantine":
        sol = solve_stage_qp(qp._replace(x0=qp.x0.at[1, 0].set(jnp.nan)),
                             CFG64)
        assert np.all(np.isfinite(np.asarray(sol.u)))
        assert not bool(sol.converged[1])
        assert not np.asarray(sol.u[1]).any()
        for b in (0, 2, 3):
            np.testing.assert_allclose(np.asarray(sol.u[b]), ref[b],
                                       atol=atol)
        return
    sol = solve_stage_qp(qp, CFG64)
    assert np.asarray(sol.converged).all()
    np.testing.assert_allclose(np.asarray(sol.u), ref, atol=atol)


def test_masks_and_quarantine(rng):
    """Half the rows masked (f32): a poisoned lane leaves its neighbours'
    solutions untouched."""
    qp = make_problem(rng, B=4, mask_frac=0.5)
    ref = solve_stage_qp(qp, CFG)
    bad = solve_stage_qp(qp._replace(x0=qp.x0.at[2, 1].set(jnp.nan)), CFG)
    assert np.all(np.isfinite(np.asarray(bad.u)))
    assert not bool(bad.converged[2])
    for b in (0, 1, 3):
        np.testing.assert_allclose(np.asarray(bad.u[b]),
                                   np.asarray(ref.u[b]), atol=5e-5)


def test_warm_start_invalid_equals_cold(rng):
    """An all-False WarmStart must reproduce the cold path bit-for-bit
    (the first cycle of a scanned closed loop carries exactly this)."""
    qp = make_problem(rng, B=4)
    cold = solve_stage_qp(qp, CFG)
    Hh, NU, M = qp.A.shape[-3], qp.B.shape[-1], qp.h.shape[-1]
    off = WarmStart(u=jnp.zeros((4, Hh, NU), jnp.float32),
                    z=jnp.zeros((4, Hh, M), jnp.float32),
                    s=jnp.zeros((4, Hh, M), jnp.float32),
                    valid=jnp.zeros(4, bool))
    out = solve_stage_qp(qp, CFG, warm=off)
    np.testing.assert_array_equal(np.asarray(out.u), np.asarray(cold.u))
    np.testing.assert_array_equal(np.asarray(out.iters),
                                  np.asarray(cold.iters))


def test_warm_start_cuts_iterations(rng):
    """Warm-starting from the previous solution converges in fewer
    iterations to the same solution."""
    qp = make_problem(rng, B=4)
    cold = solve_stage_qp(qp, CFG)
    assert np.asarray(cold.converged).all()
    w = WarmStart(u=cold.u, z=cold.z, s=cold.s, valid=jnp.ones(4, bool))
    hot = solve_stage_qp(qp, CFG, warm=w)
    assert np.asarray(hot.converged).all()
    assert (np.asarray(hot.iters) <= np.asarray(cold.iters)).all()
    assert np.asarray(hot.iters).mean() < np.asarray(cold.iters).mean()
    np.testing.assert_allclose(np.asarray(hot.u), np.asarray(cold.u),
                               atol=5e-3)


def test_warm_start_mixed_validity(rng):
    """Per-lane valid flags: warm lanes converge fast, cold lanes follow
    the cold path — in ONE call (the closed-loop sweep shape)."""
    qp = make_problem(rng, B=4)
    cold = solve_stage_qp(qp, CFG)
    valid = jnp.asarray([True, False, True, False])
    w = WarmStart(u=cold.u, z=cold.z, s=cold.s, valid=valid)
    out = solve_stage_qp(qp, CFG, warm=w)
    its, its_cold = np.asarray(out.iters), np.asarray(cold.iters)
    assert (its[[0, 2]] <= its_cold[[0, 2]]).all()
    np.testing.assert_array_equal(its[[1, 3]], its_cold[[1, 3]])
    np.testing.assert_allclose(np.asarray(out.u[1]), np.asarray(cold.u[1]),
                               atol=1e-6)


def test_vmap_matches_explicit_batch(rng):
    """jax.vmap of a one-problem solve (how the sweep batches the
    planner) agrees with the explicitly batched call."""
    qp = make_problem(rng, B=6)

    def one(A, B, q, mk, x0):
        return solve_stage_qp(StageQP(A=A, B=B, Q=qp.Q, qlin=q, R=qp.R,
                                      G=qp.G, h=qp.h, mask=mk, x0=x0), CFG)

    out = jax.vmap(one)(qp.A, qp.B, qp.qlin, qp.mask, qp.x0)
    ref = solve_stage_qp(qp, CFG)
    np.testing.assert_allclose(np.asarray(out.u), np.asarray(ref.u),
                               atol=1e-5)
    np.testing.assert_array_equal(np.asarray(out.iters),
                                  np.asarray(ref.iters))
