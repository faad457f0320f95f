"""The closed-loop controller — re-derivation of the reference's ctrl_loop
(reference main.cpp:1077-2743) as a pure function scanned over time.

One REPLAN CYCLE (reference: one trot half-cycle pair, 0.5 s):
  1. robustness EWMA update + APF navigation (main.cpp:1273-1422)
  2. one convex-MPC solve over the gait horizon (replacing the TOWR NLP
     solved with Gazebo PAUSED, main.cpp:1250/1441 — the pure-JAX sim never
     pauses: the batched QP fits the budget)
  3. 400 Hz tracking: gait-phase query -> swing spline refs -> whole-body
     QP -> torques -> physics step, accumulating the friction-cone margin
     integral each tick (main.cpp:1463-2053)

The reference alternates gait combos C1/C5 (trot pair A then pair B,
topt.cpp:49-62); here the cycle index's parity selects gait flag 1/2.
Gait modes (GaitConfig.mode):
  * "trot"  — what the reference actually executes: trot + fake-crawl
    gain reduction (its `crawl` flag is hardcoded false, main.cpp:489)
  * "crawl" — static full-crawl (reference combos C7-C10, present
    upstream but never enabled)
  * "adaptive" — data-driven in-loop gait switching: the robustness
    EWMA below the 0.34 threshold (main.cpp:1320) swaps the gait flag
    to the crawl combo INSIDE the scanned loop (a jnp.where — data,
    not shapes), completing the reference's abandoned crawl path.
    Trot and crawl share a 1.0 s cycle (gait flag 15 = pair A + pair B
    is phase-identical to two 0.5 s C1/C5 replans); set
    MpcConfig.horizon=40 to cover the full cycle.

Everything is single-scenario; `vmap` over a scenario axis and `shard_map`
over a device mesh happen in runtime.sweep.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .. import apf, foothold, gait, planner, swing, wbc
from ..config import EngineConfig
from ..models import rbd, srb
from ..sim import disturbance, physics
from ..sim import terrain as terrain_mod
from . import observer


class LoopState(NamedTuple):
    sim: physics.SimState
    apf: apf.ApfState
    cycle_idx: jnp.ndarray    # () int32
    # () bool — adaptive-mode gait memory (crawl engaged); hysteresis on
    # the robustness index needs last cycle's decision
    crawling: jnp.ndarray
    # previous cycle's MPC solution carried as the next solve's warm
    # start (ops.riccati.WarmStart; PERF.md lever 1 — closed-loop plans
    # change little per replan).  Leg-permuted at store time for the
    # phase-mirrored trot pair (gait flags 1<->2); warm_valid gates the
    # first cycle's cold start so shapes stay static under lax.scan.
    warm_u: jnp.ndarray       # (H, 12) world-frame knot forces
    warm_z: jnp.ndarray       # (H, 24) duals
    warm_s: jnp.ndarray       # (H, 24) slacks
    warm_valid: jnp.ndarray   # () bool
    # () int32 — the gait flag the stored warm solution is valid FOR
    # (after any leg permutation).  A cycle whose flag differs discards
    # the warm start: stance-row mask patterns change across gait
    # switches, and a mismatched (z, s) start WORSE than cold (measured
    # on the adaptive trot->crawl switch: qp_converged 0 and a fall with
    # stale warm data vs healthy cold)
    warm_flag: jnp.ndarray
    # momentum-observer state (runtime.observer): external-wrench
    # estimate carried across cycles, updated every tracking tick from
    # the WBC's own M/h/Jc evaluation (the reference's estimate_loop
    # role, main.cpp:843-930 — disabled upstream, live here)
    obs: observer.ObserverState


class CycleMetrics(NamedTuple):
    """Per-cycle observability (SURVEY.md §5.5: the ROS-topics bus becomes
    a metrics pytree)."""

    com: jnp.ndarray          # (3,) CoM at cycle end
    com_err: jnp.ndarray      # () |com - com_des| at cycle end (xy)
    rob_mean: jnp.ndarray     # () mean robustness index
    fake_crawl: jnp.ndarray   # () bool
    qp_converged: jnp.ndarray  # () fraction of converged WBC solves
    mpc_converged: jnp.ndarray  # () bool
    # () IPM iterations the cycle's MPC solve needed (solver diagnostics;
    # warm-started replans converge in ~1-2 vs ~7 cold — PERF.md lever 1,
    # asserted across shards by __graft_entry__.dryrun_multichip)
    mpc_iters: jnp.ndarray
    crawling: jnp.ndarray     # () bool — crawl combo engaged this cycle
    slip_ticks: jnp.ndarray   # () fraction of ticks with any foot slipping
    tau_max: jnp.ndarray      # () peak |tau| over the cycle
    qdd_max: jnp.ndarray      # () peak |joint accel| commanded (rad/s^2)
    # () mean terrain mu under the cycle's chosen step targets — the
    # foothold-selection observable (higher = footholds avoid slippery
    # cells; compare foothold.enabled on/off)
    foot_mu: jnp.ndarray
    track_err: jnp.ndarray    # () mean CoM tracking error during cycle
    # () mean fraction of (leg, tick) pairs in the early-touch-down
    # latched state (swing cut short on measured contact)
    early_td_frac: jnp.ndarray
    # (6,) external-wrench estimate [f(3); tau(3)] at cycle end (the
    # reference's estimation_ee topic, main.cpp:1670-1685) and () peak
    # estimated force magnitude over the cycle — the disturbance-
    # detection observable (cross-checked against injected pushes in
    # tests/test_leg_disturbance.py)
    wrench_est: jnp.ndarray
    wrench_peak: jnp.ndarray


def _phase_gait_flag(cycle_idx):
    """Alternate trot pair A / pair B (reference C1/C5)."""
    return jnp.where(cycle_idx % 2 == 0, 1, 2).astype(jnp.int32)


@partial(jax.jit, static_argnames=("cfg",))
def run_cycle(cfg: EngineConfig, st: LoopState, terr: terrain_mod.Terrain,
              target_xy: jnp.ndarray,
              dist_sched: jnp.ndarray) -> tuple[LoopState, CycleMetrics]:
    """One replan cycle: navigate, plan, track.

    The whole cycle runs at HIGHEST matmul precision: the physics
    integrator, kinematics, and reference algebra feed the solvers, and
    reduced-precision matmuls (TF32 on the GPU) corrupt them at the ~1e-2
    level — enough to fell the robot (F32_HEALTH.md).  The flops here are
    tiny 3x3/18x18 chains; a fast reduced-precision path buys nothing.
    """
    with jax.default_matmul_precision("highest"):
        return _run_cycle_impl(cfg, st, terr, target_xy, dist_sched)


def _run_cycle_impl(cfg: EngineConfig, st: LoopState,
                    terr: terrain_mod.Terrain, target_xy: jnp.ndarray,
                    dist_sched: jnp.ndarray
                    ) -> tuple[LoopState, CycleMetrics]:
    dtype = st.sim.q.dtype
    robot = cfg.robot
    # a device-varying False: fresh constants entering scan carries /
    # LoopState outputs inherit varying axes from the sim state, keeping
    # shard_map(check_vma=True) satisfied on sharded sweeps
    vfalse = (0.0 * st.sim.q[0]) > 0.0

    # ---- 1. navigation -------------------------------------------------
    ast = apf.update_robustness(cfg.apf, st.apf)
    feet_w = rbd.foot_positions_world(robot, st.sim.p_base, st.sim.R_wb,
                                      st.sim.q)
    com_w = rbd.com_position(robot, st.sim.p_base, st.sim.R_wb, st.sim.q)
    nav = apf.navigate(cfg.apf, ast, feet_w[:, 0:2], com_w[0:2], target_xy,
                       robot=robot)

    if cfg.gait.mode == "crawl":
        cycle_s = cfg.gait.crawl_cycle
        # walk1_4 (reference combo C9, gait_type 4): all four legs swing
        # once per cycle, one at a time
        gait_flag = jnp.asarray(4, jnp.int32)
        crawling = ~vfalse
    elif cfg.gait.mode in gait.NAMED_MODE_FLAGS:
        # fixed stride from the transcribed library (pace, bound, ... —
        # gait.NAMED_MODE_FLAGS): every cycle runs the same flag, so the
        # warm start carries unpermuted (the identity branch below)
        cycle_s = cfg.gait.fixed_cycle
        gait_flag = jnp.asarray(gait.NAMED_MODE_FLAGS[cfg.gait.mode],
                                jnp.int32)
        crawling = vfalse
    elif cfg.gait.mode == "adaptive":
        # data-driven switch with hysteresis: enter the crawl combo when
        # the robustness EWMA drops below crawl_enter_threshold, return
        # to the full trot cycle once it recovers past
        # crawl_exit_threshold (the measured index is gait-dependent —
        # see ApfConfig).  Both gaits share the 1.0 s cycle length, so
        # the switch is pure data (a flag select) inside the jit.
        cycle_s = cfg.gait.crawl_cycle
        rob_mean = jnp.mean(ast.rob_foot, axis=-1)
        crawling = jnp.where(st.crawling,
                             rob_mean <= cfg.apf.crawl_exit_threshold,
                             rob_mean < cfg.apf.crawl_enter_threshold)
        gait_flag = jnp.where(crawling, 4, 15).astype(jnp.int32)
    else:
        if cfg.gait.mode != "trot":
            raise ValueError(f"unknown gait mode {cfg.gait.mode!r}")
        cycle_s = cfg.gait.trot_cycle
        gait_flag = _phase_gait_flag(st.cycle_idx)
        crawling = vfalse
    cycle = jnp.asarray(cycle_s, dtype)
    n_ticks = int(round(cycle_s / cfg.sim.dt))

    # decision-influenced foothold selection inside the RoM box (the towr
    # foothold-optimization role, foothold.py): avoid low-mu / steep
    # cells near the APF step targets.  Exactly the APF targets on
    # uniform ground.
    step_xy = nav.step_targets
    if cfg.foothold.enabled:
        step_xy = foothold.optimize(cfg.foothold, robot, terr, step_xy,
                                    nav.com_des)

    # foothold/CoM heights follow the terrain height field (the towr
    # TerrainConstraint role: feet land ON the terrain surface;
    # flat terrains sample 0 and reduce to the reference's FlatGround)
    com_des3 = jnp.concatenate(
        [nav.com_des,
         (terrain_mod.sample_height(terr, nav.com_des)
          + robot.com_height)[None]])
    step_targets3 = jnp.concatenate(
        [step_xy,
         (terrain_mod.sample_height(terr, step_xy)
          + robot.foot_radius)[:, None]], axis=-1)

    # ---- 2. MPC plan over the cycle ------------------------------------
    contacts_h = gait.horizon_contacts(
        gait_flag, jnp.asarray(0.0, dtype), cfg.mpc.dt, cfg.mpc.horizon,
        cycle, dtype=dtype)
    feet_sched = planner.foothold_schedule(feet_w, step_targets3, contacts_h)
    # terrain-aligned friction-cone bases at the scheduled footholds
    # (towr force_constraint.cc:72-83); None on flat worlds, where the
    # basis is identically I and the rotation work would be wasted
    cone_rot = (terrain_mod.cone_basis(terr, feet_sched[..., 0:2])
                if terr.h_map is not None else None)
    rpy_now = _rpy(st.sim.R_wb)
    x_ref = planner.reference_trajectory(
        cfg, rpy_now, jnp.concatenate(
            [com_w[0:2],
             (terrain_mod.sample_height(terr, com_w[0:2])
              + robot.com_height)[None]]),
        com_des3, rpy_now[2], cycle)
    v_com = rbd.com_jacobian(robot, st.sim.R_wb, st.sim.q) @ st.sim.u
    x0 = srb.pack_state(rpy_now, com_w, st.sim.u[3:6], v_com)
    riccati_backend = (planner.effective_backend(cfg).startswith("riccati")
                       and cfg.mpc.warm_start)
    warm = None
    if riccati_backend:
        from ..ops.riccati import WarmStart
        warm = WarmStart(u=st.warm_u, z=st.warm_z, s=st.warm_s,
                         valid=st.warm_valid & (st.warm_flag == gait_flag))
    plan = planner.plan(cfg, x0, planner.MpcRefs(
        contacts=contacts_h, feet_w=feet_sched, x_ref=x_ref,
        yaw_ref=rpy_now[2], cone_rot=cone_rot), warm=warm)

    # stash this solve for the next cycle's warm start.  Consecutive trot
    # cycles mirror the swing pair (flags 1<->2, strides bP..<->Pb..), so
    # the stored solution is leg-permuted BR<->BL, FL<->FR; crawl and
    # adaptive cycles share one schedule (identity).
    if riccati_backend:
        if cfg.gait.mode == "trot":
            perm = (1, 0, 3, 2)                  # mirrored pair
            flag_for = jnp.where(gait_flag == 1, 2, 1).astype(jnp.int32)
        else:
            perm = (0, 1, 2, 3)                  # same schedule next cycle
            flag_for = gait_flag
        Hh = cfg.mpc.horizon
        u_next = plan.forces[:, perm, :].reshape(Hh, 12)

        def permute_rows(v):
            # the first 24 rows are the per-leg pyramid (4 legs x 6) and
            # permute with the mirrored swing pair; any extra rows
            # (base_acc) are leg-agnostic and carry through unpermuted
            v = v.reshape(Hh, -1)
            pyr = v[:, :24].reshape(Hh, 4, 6)[:, perm, :].reshape(Hh, 24)
            return jnp.concatenate([pyr, v[:, 24:]], axis=-1)
        z_next = permute_rows(plan.sol.z)
        s_next = permute_rows(plan.sol.s)
        warm_next = (u_next, z_next, s_next, ~vfalse, flag_for)
    else:
        warm_next = (st.warm_u, st.warm_z, st.warm_s, st.warm_valid,
                     st.warm_flag)

    # ---- 3. 400 Hz tracking -------------------------------------------
    liftoff_feet = feet_w                     # positions at cycle start
    # knot-time state sequence including t=0 (plan.states[k] is the state
    # AFTER step k+1, i.e. at time (k+1) dt) for first-order-hold refs —
    # the reference samples smooth splines every tick (main.cpp:1485-1489);
    # zero-order hold at 25 ms knots injects step discontinuities into the
    # 2.5 ms tracking loop
    states_knots = jnp.concatenate([x0[None], plan.states], axis=0)

    def tick(carry, k):
        sim_st, ast, td_flag, td_pos, prev_contact, obs = carry
        t = k.astype(dtype) * cfg.sim.dt
        info = gait.phase_info(gait_flag, t, cycle, dtype=dtype)
        contact = info["contact"]

        # swing spline refs (phase within the leg's current swing window)
        dur = jnp.maximum(info["t_end"] - info["t_start"], 1e-3)
        tau_ph = (t - info["t_start"]) / dur
        sw_pos, sw_vel, sw_acc = swing.swing_ref(
            liftoff_feet, step_targets3, cfg.mpc.swing_height, tau_ph, dur)

        if cfg.gait.early_td or terr.h_map is not None:
            feet_now = rbd.foot_positions_world(
                robot, sim_st.p_base, sim_st.R_wb, sim_st.q)

        if cfg.gait.early_td:
            # early touch-down (reference main.cpp:2027-2028, 3249-3264:
            # contact && t > dur - 0.05 -> flag_exit cuts the swing
            # short).  Per-leg data, not shapes: a swing foot with
            # MEASURED contact (previous physics step) inside the last
            # early_td_window of its swing phase latches td_flag — its
            # swing ref freezes at the touch-down point and the WBC
            # treats it as stance until its scheduled stance begins.
            near_end = t > info["t_end"] - cfg.gait.early_td_window
            is_swing = contact < 0.5
            touched = prev_contact & is_swing & near_end
            newly = touched & ~td_flag
            td_pos = jnp.where(newly[:, None], feet_now, td_pos)
            td_flag = (td_flag | touched) & is_swing
            sw_pos = jnp.where(td_flag[:, None], td_pos, sw_pos)
            sw_vel = jnp.where(td_flag[:, None], 0.0, sw_vel)
            sw_acc = jnp.where(td_flag[:, None], 0.0, sw_acc)
            contact = jnp.maximum(contact, td_flag.astype(dtype))

        # MPC refs: first-order hold between knots for the state, zero-
        # order hold for forces (u_k is constant over its interval)
        tk = t / cfg.mpc.dt
        k0 = jnp.clip(tk.astype(jnp.int32), 0, cfg.mpc.horizon - 1)
        wk = jnp.clip(tk - k0.astype(dtype), 0.0, 1.0)
        xk = (1.0 - wk) * states_knots[k0] + wk * states_knots[k0 + 1]
        fk = plan.forces[k0]
        com_acc = jnp.sum(fk, axis=0) / robot.mass + jnp.asarray(
            [0.0, 0.0, -srb.GRAVITY], dtype)

        ref = wbc.WbcRefs(
            com_pos=xk[3:6], com_vel=xk[9:12], com_acc=com_acc,
            rpy=xk[0:3], omega=xk[6:9],
            omega_dot=jnp.zeros(3, dtype),
            swing_pos=sw_pos, swing_vel=sw_vel, swing_acc=sw_acc)
        wst = wbc.WbcState(p_base=sim_st.p_base, R_wb=sim_st.R_wb,
                           q=sim_st.q, u=sim_st.u, contact=contact,
                           crawl=crawling)
        if terr.h_map is not None:
            # tilt the WBC friction pyramids to the local surface normal
            # (the sim contact already acts along it, physics.py:69-99)
            wst = wst._replace(
                cone_rot=terrain_mod.cone_basis(terr, feet_now[:, 0:2]))
        out = wbc.solve(cfg, wst, ref)

        fd, ff = disturbance.eval_links(dist_sched, sim_st.t)
        sim_st, cinfo = physics.step(cfg, sim_st, out.tau, terr, f_dist=fd,
                                     f_feet=ff)

        # robustness margin accumulation from MEASURED contact forces
        # (the reference integrates bumper-sensor forces, main.cpp:1536)
        ast = apf.accumulate_margin(cfg.apf, ast, cinfo.forces,
                                    jnp.asarray(cfg.sim.dt, dtype))

        # momentum-observer tick reusing the WBC's dynamics evaluation
        # (estimate_loop's role, main.cpp:898-913 — one M/h/Jc per tick)
        obs = observer.update_from_dyn(
            obs, out.M, out.h_bias, out.Jc, sim_st.u, cinfo.forces_avg,
            jnp.asarray(cfg.sim.dt, dtype), cfg.observer.gain,
            mdot_u=observer.mdot_u(cfg, sim_st.R_wb, sim_st.q, sim_st.u))

        com_now = rbd.com_position(robot, sim_st.p_base, sim_st.R_wb,
                                   sim_st.q)
        track_err = jnp.linalg.norm(com_now - xk[3:6])
        return ((sim_st, ast, td_flag, td_pos, cinfo.in_contact, obs),
                (out.sol.converged, cinfo.slipping.any(),
                 jnp.abs(out.tau).max(), track_err,
                 jnp.mean(td_flag.astype(dtype)),
                 jnp.abs(out.udot[6:18]).max(),
                 jnp.linalg.norm(obs.w[0:3])))

    carry0 = (st.sim, ast, jnp.zeros(4, bool) ^ vfalse, liftoff_feet,
              jnp.zeros(4, bool) ^ vfalse, st.obs)
    (sim_st, ast, _, _, _, obs), (conv, slip, taumax, terr_track, td_frac,
                                  qddmax, wpeak) = (
        jax.lax.scan(tick, carry0, jnp.arange(n_ticks)))

    com_end = rbd.com_position(robot, sim_st.p_base, sim_st.R_wb, sim_st.q)
    metrics = CycleMetrics(
        com=com_end,
        com_err=jnp.linalg.norm(com_end[0:2] - nav.com_des),
        rob_mean=nav.rob_mean,
        fake_crawl=nav.fake_crawl,
        qp_converged=jnp.mean(conv.astype(dtype)),
        mpc_converged=plan.sol.converged,
        mpc_iters=plan.sol.iters.astype(jnp.int32),
        crawling=crawling,
        slip_ticks=jnp.mean(slip.astype(dtype)),
        tau_max=jnp.max(taumax),
        qdd_max=jnp.max(qddmax),
        foot_mu=jnp.mean(terrain_mod.sample_mu(terr, step_xy)),
        track_err=jnp.mean(terr_track),
        early_td_frac=jnp.mean(td_frac),
        wrench_est=obs.w,
        wrench_peak=jnp.max(wpeak))
    return LoopState(sim=sim_st, apf=ast, cycle_idx=st.cycle_idx + 1,
                     crawling=crawling, warm_u=warm_next[0],
                     warm_z=warm_next[1], warm_s=warm_next[2],
                     warm_valid=warm_next[3],
                     warm_flag=warm_next[4], obs=obs), metrics


def _rpy(R):
    from ..ops.rotations import rot_to_rpy
    return rot_to_rpy(R)


@partial(jax.jit, static_argnames=("cfg", "n_cycles"))
def run(cfg: EngineConfig, st: LoopState, terr: terrain_mod.Terrain,
        target_xy: jnp.ndarray, dist_sched: jnp.ndarray,
        n_cycles: int) -> tuple[LoopState, CycleMetrics]:
    """n_cycles replan cycles (n_cycles * 0.5 s of walking)."""

    def body(s, _):
        return run_cycle(cfg, s, terr, target_xy, dist_sched)

    return jax.lax.scan(body, st, None, length=n_cycles)


def init(cfg: EngineConfig, xy=(0.0, 0.0), yaw: float = 0.0,
         dtype=jnp.float32) -> LoopState:
    Hh = cfg.mpc.horizon
    # warm z/s row count: 24 pyramid rows + 12 base_acc rows if enabled
    nrow = 24 + (12 if cfg.mpc.base_acc else 0)
    return LoopState(sim=physics.initial_state(cfg, xy, yaw, dtype),
                     apf=apf.init_state((), dtype),
                     cycle_idx=jnp.asarray(0, jnp.int32),
                     crawling=jnp.asarray(cfg.gait.mode == "crawl"),
                     warm_u=jnp.zeros((Hh, 12), dtype),
                     warm_z=jnp.zeros((Hh, nrow), dtype),
                     warm_s=jnp.zeros((Hh, nrow), dtype),
                     warm_valid=jnp.asarray(False),
                     warm_flag=jnp.asarray(0, jnp.int32),
                     # spawn is at rest (u = 0) so the momentum offset
                     # p0 = (M u)[0:6] is exactly zero
                     obs=observer.ObserverState(y_int=jnp.zeros(6, dtype),
                                                w=jnp.zeros(6, dtype),
                                                p0=jnp.zeros(6, dtype)))
