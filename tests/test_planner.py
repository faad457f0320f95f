"""Convex SRB MPC tests: stance force distribution, friction cones,
tracking behavior — the golden checks SURVEY.md §7.3 calls for (PR1 slice:
f_z ~ mg/4 at rest, KKT-feasible forces)."""

import jax.numpy as jnp
import numpy as np
import pytest

from apf_quadruped import gait, planner
from apf_quadruped.config import EngineConfig, MpcConfig, SolverConfig
from apf_quadruped.models import srb
from apf_quadruped.models.dogbot import nominal_stance

CFG = EngineConfig(
    mpc=MpcConfig(horizon=10, dt=0.05),
    # abstol is an ABSOLUTE duality-gap tolerance; with slacks of O(fz_max)
    # = O(1e3 N) a gap of 1e-4 is ~1e-7 relative — plenty below the
    # reference's runtime 1e-2 (main.cpp:1651-1652).
    solver=SolverConfig(iters=25, reltol=1e-6, abstol=1e-4),
)


def _stand_refs(cfg, com0):
    H = cfg.mpc.horizon
    feet0 = jnp.asarray(nominal_stance(cfg.robot)) + com0
    feet0 = feet0.at[:, 2].set(0.0)
    contacts = jnp.ones((H, 4))
    feet_w = planner.foothold_schedule(feet0, feet0, contacts)
    x_ref = planner.reference_trajectory(
        cfg, jnp.zeros(3), com0, com0, jnp.asarray(0.0),
        jnp.asarray(H * cfg.mpc.dt))
    return planner.MpcRefs(contacts=contacts, feet_w=feet_w, x_ref=x_ref,
                           yaw_ref=jnp.asarray(0.0))


def test_standing_force_distribution():
    """At rest at the reference, forces must be ~mg/4 vertical on each leg."""
    com0 = jnp.array([0.0, 0.0, 0.4])
    refs = _stand_refs(CFG, com0)
    x0 = srb.pack_state(jnp.zeros(3), com0, jnp.zeros(3), jnp.zeros(3))
    out = planner.plan(CFG, x0, refs)
    assert bool(out.sol.converged)
    f = np.asarray(out.forces)                      # (H, 4, 3)
    mg4 = CFG.robot.mass * srb.GRAVITY / 4
    np.testing.assert_allclose(f[..., 2], mg4, rtol=0.05)
    assert np.abs(f[..., 0:2]).max() < 3.0
    # predicted trajectory stays put
    states = np.asarray(out.states)
    np.testing.assert_allclose(
        states[:, 3:6],
        np.broadcast_to(np.asarray(com0), states[:, 3:6].shape), atol=5e-3)


def test_forces_respect_friction_cone():
    """Aggressive lateral goal: planned forces stay inside the pyramid."""
    com0 = jnp.array([0.0, 0.0, 0.4])
    com_des = jnp.array([0.5, 0.3, 0.4])
    feet0 = jnp.asarray(nominal_stance(CFG.robot)) + com0
    feet0 = feet0.at[:, 2].set(0.0)
    H = CFG.mpc.horizon
    contacts = jnp.ones((H, 4))
    refs = planner.MpcRefs(
        contacts=contacts,
        feet_w=planner.foothold_schedule(feet0, feet0, contacts),
        x_ref=planner.reference_trajectory(
            CFG, jnp.zeros(3), com0, com_des, jnp.asarray(0.0),
            jnp.asarray(H * CFG.mpc.dt)),
        yaw_ref=jnp.asarray(0.0))
    x0 = srb.pack_state(jnp.zeros(3), com0, jnp.zeros(3), jnp.zeros(3))
    out = planner.plan(CFG, x0, refs)
    assert bool(out.sol.converged)
    f = np.asarray(out.forces)
    mu = CFG.mpc.mu
    tol = 1e-3
    assert (f[..., 2] >= -tol).all()
    assert (np.abs(f[..., 0]) <= mu * f[..., 2] + 1e-2 + tol).all()
    assert (np.abs(f[..., 1]) <= mu * f[..., 2] + 1e-2 + tol).all()


def test_swing_legs_zero_force():
    """Trot schedule: swing-phase knots carry ~zero force on swing legs."""
    com0 = jnp.array([0.0, 0.0, 0.4])
    feet0 = jnp.asarray(nominal_stance(CFG.robot)) + com0
    feet0 = feet0.at[:, 2].set(0.0)
    H = CFG.mpc.horizon
    cycle = jnp.asarray(H * CFG.mpc.dt)
    contacts = gait.horizon_contacts(
        jnp.asarray(1), jnp.asarray(0.0), CFG.mpc.dt, H, cycle)
    assert float(contacts.min()) == 0.0, "schedule must contain swing knots"
    refs = planner.MpcRefs(
        contacts=contacts,
        feet_w=planner.foothold_schedule(feet0, feet0, contacts),
        x_ref=planner.reference_trajectory(
            CFG, jnp.zeros(3), com0, com0, jnp.asarray(0.0), cycle),
        yaw_ref=jnp.asarray(0.0))
    x0 = srb.pack_state(jnp.zeros(3), com0, jnp.zeros(3), jnp.zeros(3))
    out = planner.plan(CFG, x0, refs)
    assert bool(out.sol.converged)
    f = np.asarray(out.forces)
    c = np.asarray(contacts)
    assert np.abs(f[c == 0.0]).max() < 1e-6
    # stance knots still carry the weight
    total_fz = (f[..., 2] * c).sum(-1)
    assert (total_fz > 0.5 * CFG.robot.mass * srb.GRAVITY).all()


def test_tracking_moves_toward_goal():
    com0 = jnp.array([0.0, 0.0, 0.4])
    com_des = jnp.array([0.2, 0.0, 0.4])
    feet0 = jnp.asarray(nominal_stance(CFG.robot)) + com0
    feet0 = feet0.at[:, 2].set(0.0)
    H = CFG.mpc.horizon
    contacts = jnp.ones((H, 4))
    refs = planner.MpcRefs(
        contacts=contacts,
        feet_w=planner.foothold_schedule(feet0, feet0, contacts),
        x_ref=planner.reference_trajectory(
            CFG, jnp.zeros(3), com0, com_des, jnp.asarray(0.0),
            jnp.asarray(H * CFG.mpc.dt)),
        yaw_ref=jnp.asarray(0.0))
    x0 = srb.pack_state(jnp.zeros(3), com0, jnp.zeros(3), jnp.zeros(3))
    out = planner.plan(CFG, x0, refs)
    states = np.asarray(out.states)
    # CoM x must advance monotonically-ish toward the goal
    assert states[-1, 3] > 0.1
    assert states[-1, 3] < 0.3


def test_batched_plan():
    com0 = jnp.array([0.0, 0.0, 0.4])
    refs1 = _stand_refs(CFG, com0)
    B = 3
    refs = planner.MpcRefs(
        contacts=jnp.tile(refs1.contacts, (B, 1, 1)),
        feet_w=jnp.tile(refs1.feet_w, (B, 1, 1, 1)),
        x_ref=jnp.tile(refs1.x_ref, (B, 1, 1)),
        yaw_ref=jnp.zeros(B))
    x0 = jnp.tile(srb.pack_state(jnp.zeros(3), com0, jnp.zeros(3),
                                 jnp.zeros(3)), (B, 1))
    out = planner.plan(CFG, x0, refs)
    assert out.forces.shape == (B, CFG.mpc.horizon, 4, 3)
    assert bool(np.all(out.sol.converged))


def test_base_motion_box():
    """Opt-in BaseRom box (towr base_motion_constraint.cc:46-55): an
    aggressive upward CoM goal must be clipped by the hard z box
    [z0 - 0.02, z0 + 0.1] when base_box is on, while the unconstrained
    plan overshoots it."""
    # reference runtime tolerances (main.cpp:1651-1652): the box adds 60
    # active-ish rows whose slacks are O(m), so the absolute gap settles
    # higher than the pyramid-only QPs, and lanes must freeze once both
    # criteria hold (pushing far past convergence pinches the slacks and
    # breaks the KKT conditioning)
    cfg_box = EngineConfig(
        mpc=MpcConfig(horizon=10, dt=0.05, base_box=True),
        solver=SolverConfig(iters=30, reltol=1e-2, abstol=1e-2))
    cfg_free = cfg_box.replace(mpc=MpcConfig(horizon=10, dt=0.05))
    com0 = jnp.array([0.0, 0.0, 0.4])
    com_des = jnp.array([0.0, 0.0, 0.65])        # 0.25 m up: outside box
    feet0 = jnp.asarray(nominal_stance(cfg_box.robot)) + com0
    feet0 = feet0.at[:, 2].set(0.0)
    H = cfg_box.mpc.horizon
    contacts = jnp.ones((H, 4))
    refs = planner.MpcRefs(
        contacts=contacts,
        feet_w=planner.foothold_schedule(feet0, feet0, contacts),
        x_ref=planner.reference_trajectory(
            cfg_box, jnp.zeros(3), com0, com_des, jnp.asarray(0.0),
            jnp.asarray(H * cfg_box.mpc.dt)),
        yaw_ref=jnp.asarray(0.0))
    x0 = srb.pack_state(jnp.zeros(3), com0, jnp.zeros(3), jnp.zeros(3))

    free = planner.plan(cfg_free, x0, refs)
    boxed = planner.plan(cfg_box, x0, refs)
    assert bool(boxed.sol.converged)
    z_free = np.asarray(free.states)[:, 5]
    z_boxed = np.asarray(boxed.states)[:, 5]
    assert z_free.max() > 0.4 + 0.1 + 0.01, \
        f"test premise broken: free plan never leaves the box ({z_free.max()})"
    assert z_boxed.max() <= 0.4 + 0.1 + 2e-3, f"box violated: {z_boxed.max()}"
    assert z_boxed.min() >= 0.4 - 0.02 - 2e-3
    # roll/pitch stay inside +-dev_rad too
    rp = np.abs(np.asarray(boxed.states)[:, 0:2])
    assert rp.max() <= 0.05 + 2e-3


def _nl_rollout_defect(cfg, x0, refs, out):
    """Max per-knot defect between the plan's predicted states and an
    exact nonlinear SRB rollout applying the planned forces."""
    dt = cfg.mpc.dt
    xs = np.asarray(x0, np.float64)
    defects = []
    states = np.asarray(out.states)
    forces = np.asarray(out.forces) * np.asarray(refs.contacts)[..., None]
    feet = np.asarray(refs.feet_w)
    x = jnp.asarray(xs)
    for k in range(cfg.mpc.horizon):
        rpy, r, om, v = srb.unpack_state(x)
        d = srb.srb_derivative(cfg.robot, rpy, r, om, v,
                               jnp.asarray(feet[k]), jnp.asarray(forces[k]))
        x = x.at[0:3].add(dt * d[0]).at[3:6].add(dt * d[1]) \
             .at[6:9].add(dt * d[2]).at[9:12].add(dt * d[3])
        defects.append(np.abs(np.asarray(x)[:12] - states[k][:12]).max())
    return max(defects)


def test_sqp_improves_dynamic_consistency():
    """SQP outer loop (MpcConfig.sqp_iters, SURVEY.md §7.4): for a fast
    yaw-turning, tilted initial state the single convex solve linearizes
    about the wrong attitude/lever arms; re-linearizing around the
    predicted trajectory must cut the nonlinear rollout defect."""
    base = EngineConfig(
        mpc=MpcConfig(horizon=10, dt=0.05, backend="riccati"),
        solver=SolverConfig(iters=25, reltol=1e-6, abstol=1e-4))
    com0 = jnp.array([0.0, 0.0, 0.42])
    com_des = jnp.array([0.15, 0.25, 0.40])
    rpy0 = jnp.array([0.12, -0.08, 0.4])
    omega0 = jnp.array([0.4, 0.3, 1.5])      # fast yaw + tumble rates
    feet0 = jnp.asarray(nominal_stance(base.robot)) + com0
    feet0 = feet0.at[:, 2].set(0.0)
    H = base.mpc.horizon
    contacts = jnp.ones((H, 4))
    refs = planner.MpcRefs(
        contacts=contacts,
        feet_w=planner.foothold_schedule(feet0, feet0, contacts),
        x_ref=planner.reference_trajectory(
            base, rpy0, com0, com_des, rpy0[2],
            jnp.asarray(H * base.mpc.dt)),
        yaw_ref=rpy0[2])
    x0 = srb.pack_state(rpy0, com0, omega0, jnp.array([0.1, 0.3, 0.0]))

    defects = {}
    for n in (1, 4):
        cfg = base.replace(mpc=MpcConfig(horizon=10, dt=0.05,
                                         backend="riccati", sqp_iters=n))
        out = planner.plan(cfg, x0, refs)
        assert bool(out.sol.converged), f"sqp_iters={n} did not converge"
        defects[n] = _nl_rollout_defect(cfg, x0, refs, out)
    # measured convergence (CPU f64): 5.08 / 0.25 / 0.13 / 6e-3 / 1.3e-4 /
    # 3e-6 at sqp_iters 1/2/3/4/6/8 — quadratic-ish contraction
    assert defects[4] < 0.01 * defects[1], (
        f"SQP must cut the nonlinear defect: {defects}")
    assert defects[4] < 0.02, f"absolute consistency too loose: {defects}"


def test_base_box_riccati_matches_condensed():
    """base_box on the PRODUCTION Riccati path (StageQP state rows) must
    agree with the condensed backend's exact prediction-matrix rows —
    same clipped trajectory, same forces (the VERDICT r3 gap: base_box
    used to force the O((12H)^3) condensed backend)."""
    mk = dict(horizon=10, dt=0.05, base_box=True)
    # active box rows carry O(m)-scale slacks, so the ABSOLUTE gap floors
    # near 1e-3 (same effect as in test_base_motion_box above); 1e-3
    # abstol + tight reltol converges in ~10 iterations on both backends
    sol_cfg = SolverConfig(iters=60, reltol=1e-4, abstol=1e-3)
    cfg_r = EngineConfig(mpc=MpcConfig(**mk, backend="riccati"),
                         solver=sol_cfg)
    cfg_c = EngineConfig(mpc=MpcConfig(**mk, backend="condensed"),
                         solver=sol_cfg)
    com0 = jnp.array([0.0, 0.0, 0.4])
    com_des = jnp.array([0.0, 0.0, 0.65])
    feet0 = jnp.asarray(nominal_stance(cfg_r.robot)) + com0
    feet0 = feet0.at[:, 2].set(0.0)
    H = cfg_r.mpc.horizon
    contacts = jnp.ones((H, 4))
    refs = planner.MpcRefs(
        contacts=contacts,
        feet_w=planner.foothold_schedule(feet0, feet0, contacts),
        x_ref=planner.reference_trajectory(
            cfg_r, jnp.zeros(3), com0, com_des, jnp.asarray(0.0),
            jnp.asarray(H * cfg_r.mpc.dt)),
        yaw_ref=jnp.asarray(0.0))
    x0 = srb.pack_state(jnp.zeros(3), com0, jnp.zeros(3), jnp.zeros(3))

    out_r = planner.plan(cfg_r, x0, refs)
    out_c = planner.plan(cfg_c, x0, refs)
    assert bool(out_r.sol.converged) and bool(out_c.sol.converged)
    # trajectories agree everywhere; forces agree elementwise off the
    # boundary (at box-riding knots the force SPLIT is degenerate — many
    # distributions give the same clipped trajectory under the 1e-5
    # regularizer — so compare the per-knot net there instead)
    xr, xc = np.asarray(out_r.states), np.asarray(out_c.states)
    np.testing.assert_allclose(xr[:, 0:6], xc[:, 0:6], atol=1e-3)
    np.testing.assert_allclose(xr[:, 6:12], xc[:, 6:12], atol=0.02)
    fr, fc = np.asarray(out_r.forces), np.asarray(out_c.forces)
    np.testing.assert_allclose(fr[:6], fc[:6], atol=0.35)
    np.testing.assert_allclose(fr.sum(1), fc.sum(1), atol=5.0)
    # and the box binds identically on the riccati path
    z = np.asarray(out_r.states)[:, 5]
    assert z.max() <= 0.4 + 0.1 + 2e-3
    assert z.max() >= 0.4 + 0.1 - 2e-3      # it actually rides the box


def _acc_refs(cfg, com0, com_des):
    H = cfg.mpc.horizon
    feet0 = jnp.asarray(nominal_stance(cfg.robot)) + com0
    feet0 = feet0.at[:, 2].set(0.0)
    contacts = jnp.ones((H, 4))
    return planner.MpcRefs(
        contacts=contacts,
        feet_w=planner.foothold_schedule(feet0, feet0, contacts),
        x_ref=planner.reference_trajectory(
            cfg, jnp.zeros(3), com0, com_des, jnp.asarray(0.0),
            jnp.asarray(H * cfg.mpc.dt)),
        yaw_ref=jnp.asarray(0.0))


def test_base_acc_bounds_bind():
    """MpcConfig.base_acc (towr BaseAcc analogue): with a tight vertical
    acceleration bound, the planned per-knot velocity deltas respect
    |dv/dt| <= acc_lin_max while the unconstrained plan exceeds it."""
    mk = dict(horizon=10, dt=0.05)
    sol_cfg = SolverConfig(iters=40, reltol=1e-5, abstol=1e-3)
    cfg_free = EngineConfig(mpc=MpcConfig(**mk, backend="riccati"),
                            solver=sol_cfg)
    cfg_acc = EngineConfig(
        mpc=MpcConfig(**mk, backend="riccati", base_acc=True,
                      acc_lin_max=1.5, acc_ang_max=5.0),
        solver=sol_cfg)
    com0 = jnp.array([0.0, 0.0, 0.4])
    com_des = jnp.array([0.0, 0.0, 0.6])      # aggressive 0.2 m pop-up
    x0 = srb.pack_state(jnp.zeros(3), com0, jnp.zeros(3), jnp.zeros(3))

    out_f = planner.plan(cfg_free, x0, _acc_refs(cfg_free, com0, com_des))
    out_a = planner.plan(cfg_acc, x0, _acc_refs(cfg_acc, com0, com_des))
    assert bool(out_f.sol.converged) and bool(out_a.sol.converged)

    def dvdt(out):
        xs = np.concatenate([np.asarray(x0)[None], np.asarray(out.states)])
        # state dims 6:12 = [omega; v]; gravity enters the v rows through
        # the affine carrier, so add it back to read the true accel
        dv = np.diff(xs[:, 6:12], axis=0) / 0.05
        dv[:, 5] += srb.GRAVITY * 0.0  # (z accel measured incl. gravity)
        return dv

    a_free = dvdt(out_f)
    a_acc = dvdt(out_a)
    # the free plan violates the 1.5 m/s^2 bound on z; the constrained
    # one respects it (within solver tolerance)
    assert np.abs(a_free[:, 3:6]).max() > 1.5 + 0.5
    assert np.abs(a_acc[:, 3:6]).max() <= 1.5 + 0.05
    assert np.abs(a_acc[:, 0:3]).max() <= 5.0 + 0.1
    # both still converge toward the goal direction
    assert np.asarray(out_a.states)[-1, 5] > 0.45


def test_base_acc_riccati_matches_condensed():
    """base_acc cross-validation (same pattern as base_box): the Riccati
    backend's per-knot input rows and the condensed backend's
    block-diagonal rows describe the same constraint set."""
    mk = dict(horizon=10, dt=0.05, base_acc=True, acc_lin_max=1.5,
              acc_ang_max=5.0)
    sol_cfg = SolverConfig(iters=60, reltol=1e-5, abstol=1e-3)
    cfg_r = EngineConfig(mpc=MpcConfig(**mk, backend="riccati"),
                         solver=sol_cfg)
    cfg_c = EngineConfig(mpc=MpcConfig(**mk, backend="condensed"),
                         solver=sol_cfg)
    com0 = jnp.array([0.0, 0.0, 0.4])
    com_des = jnp.array([0.0, 0.05, 0.6])
    x0 = srb.pack_state(jnp.zeros(3), com0, jnp.zeros(3), jnp.zeros(3))
    out_r = planner.plan(cfg_r, x0, _acc_refs(cfg_r, com0, com_des))
    out_c = planner.plan(cfg_c, x0, _acc_refs(cfg_c, com0, com_des))
    assert bool(out_r.sol.converged) and bool(out_c.sol.converged)
    xr, xc = np.asarray(out_r.states), np.asarray(out_c.states)
    np.testing.assert_allclose(xr[:, 0:6], xc[:, 0:6], atol=1e-3)
    np.testing.assert_allclose(xr[:, 6:12], xc[:, 6:12], atol=0.02)
    fr, fc = np.asarray(out_r.forces), np.asarray(out_c.forces)
    np.testing.assert_allclose(fr.sum(1), fc.sum(1), atol=5.0)


@pytest.mark.parametrize("platform,mpc,expected", [
    ("cpu", {}, "riccati"),
    ("gpu", {}, "riccati"),
    ("gpu", {"base_box": True}, "riccati"),
    ("gpu", {"base_acc": True}, "riccati"),
    ("metal", {"backend": "condensed"}, "condensed"),
    ("cpu", {"backend": "condensed"}, "condensed"),
])
def test_effective_backend(monkeypatch, platform, mpc, expected):
    """"auto" resolves from the platform: the scan Riccati IPM on the GPU
    and the CPU; a named backend is taken as named on any platform."""
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    cfg = EngineConfig(mpc=MpcConfig(**mpc))
    assert planner.effective_backend(cfg) == expected


def test_effective_backend_unknown_platform_raises(monkeypatch):
    """No solver is assumed for a platform nobody measured."""
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: "metal")
    with pytest.raises(ValueError, match="no solver"):
        planner.effective_backend(EngineConfig())


def test_unknown_backend_raises():
    """A backend name that no longer exists (the removed kernel backends)
    fails loudly instead of silently planning with another solver."""
    cfg = CFG.replace(mpc=MpcConfig(horizon=10, dt=0.05,
                                    backend="riccati_resident"))
    com0 = jnp.array([0.0, 0.0, 0.4])
    refs = _stand_refs(cfg, com0)
    x0 = srb.pack_state(jnp.zeros(3), com0, jnp.zeros(3), jnp.zeros(3))
    with pytest.raises(ValueError, match="riccati_resident"):
        planner.plan(cfg, x0, refs)


@pytest.mark.gpu
def test_planner_on_gpu_matches_host():
    """On the card: the production planner at B=256 converges and agrees
    with the host CPU (chip_smoke.py phase (c) at a small batch)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs the GPU; chip_smoke.py runs this on the card")
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    import chip_smoke

    chip_smoke.phase_planner(B=256)
