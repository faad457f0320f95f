"""Smoke test of the main path on the GPU, phase by phase.

    python chip_smoke.py               # phases (a)-(f) on one card
    python chip_smoke.py --devices 4   # phase (g) only, on four cards

Phases (each prints one line; any failure ends the run with a non-zero
exit, and no phase's error is caught):

  (a) device: the JAX backend must be the GPU;
  (b) planner golden: a standing DogBot plans fz = m g / 4 per foot;
  (c) planner at B=2048 on the production backend ("auto": the lax.scan
      Riccati IPM), and 64 of its lanes on the card against the same
      solve on the host CPU;
  (d) vmapped wbc.solve at B=1024, and 64 lanes against the host CPU;
  (e) closed-loop sweep, 1024 scenarios x 4 replan cycles;
  (f) f32 health: trot_flat at the card's precision;
  (g) with --devices 4 only: sweep.run_sharded over a 4-card mesh
      against sweep.run_batch on one card, 4096 scenarios x 4 cycles.

Every comparison runs at jax.default_matmul_precision("highest"): the
entry points set it themselves, so TF32 cannot enter.  The last line of
standard output is one JSON object naming the device.
"""

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

# the host CPU backend stays available beside the GPU for the
# card-vs-host comparisons of phases (c) and (d)
_plat = os.environ.get("JAX_PLATFORMS", "")
if _plat and "cpu" not in _plat.split(","):
    os.environ["JAX_PLATFORMS"] = _plat + ",cpu"

import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "benchmarks"))

REL_TOL = 1e-3        # max|du| / max(1, max|u_ref|), also for x (see PERF.md)
ITERS_AGREE = 0.99    # share of lanes with identical IPM iteration counts


def say(phase, msg, **kw):
    print(f"[{phase}] {msg}" + ("" if not kw else " " + json.dumps(kw)),
          flush=True)


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))


def phase_device():
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"[a] FAIL: JAX backend is {backend!r}, not 'gpu'")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    say("a", "device ok", kind=jax.devices()[0].device_kind,
        count=len(jax.devices()), jax=jax.__version__)
    print(smi, flush=True)


def phase_golden():
    import jax.numpy as jnp

    from apf_quadruped import planner
    from apf_quadruped.config import EngineConfig, MpcConfig, SolverConfig
    from apf_quadruped.models import srb
    from apf_quadruped.models.dogbot import nominal_stance

    cfg = EngineConfig(mpc=MpcConfig(horizon=10, dt=0.05),
                       solver=SolverConfig(iters=25, reltol=1e-6,
                                           abstol=1e-4))
    com0 = jnp.array([0.0, 0.0, 0.4], jnp.float32)
    feet0 = jnp.asarray(nominal_stance(cfg.robot), jnp.float32) + com0
    feet0 = feet0.at[:, 2].set(0.0)
    H = cfg.mpc.horizon
    contacts = jnp.ones((H, 4), jnp.float32)
    refs = planner.MpcRefs(
        contacts=contacts,
        feet_w=planner.foothold_schedule(feet0, feet0, contacts),
        x_ref=planner.reference_trajectory(
            cfg, jnp.zeros(3, jnp.float32), com0, com0,
            jnp.asarray(0.0, jnp.float32),
            jnp.asarray(H * cfg.mpc.dt, jnp.float32)),
        yaw_ref=jnp.asarray(0.0, jnp.float32))
    x0 = srb.pack_state(jnp.zeros(3), com0, jnp.zeros(3), jnp.zeros(3))
    out = planner.plan(cfg, x0.astype(jnp.float32), refs)
    fz = np.asarray(out.forces)[..., 2]
    mg4 = cfg.robot.mass * srb.GRAVITY / 4
    assert bool(out.sol.converged), "standing plan did not converge"
    np.testing.assert_allclose(fz, mg4, rtol=0.05)
    say("b", "planner golden ok", fz_mean=float(fz.mean()),
        mg4=float(mg4), backend=planner.effective_backend(cfg))


def _plan_fn(cfg):
    import jax

    from apf_quadruped import planner

    return jax.jit(lambda x0, refs: planner.plan(cfg, x0, refs))


def _on_cpu(tree):
    import jax

    return jax.device_put(tree, jax.devices("cpu")[0])


def phase_planner(B=2048):
    import jax

    from apf_quadruped import planner
    from apf_quadruped.config import EngineConfig, MpcConfig, SolverConfig
    from bench import make_batch, solves_per_s

    cfg = EngineConfig(mpc=MpcConfig(horizon=20, dt=0.025),
                       solver=SolverConfig())
    x0, refs = make_batch(cfg, B)
    f = _plan_fn(cfg)
    t0 = time.perf_counter()
    out = jax.block_until_ready(f(x0, refs))
    t_first = time.perf_counter() - t0
    conv = np.asarray(out.sol.converged)
    assert conv.all(), f"converged {conv.mean()}"
    assert np.isfinite(np.asarray(out.forces)).all()
    assert np.isfinite(np.asarray(out.states)).all()
    rate = solves_per_s(f, x0, refs, B)

    # f32 on the card vs f32 on the host CPU, 64 lanes, same solver
    sub = jax.tree.map(lambda v: v[:64], (x0, refs))
    gpu = f(*sub)
    with jax.default_device(jax.devices("cpu")[0]):
        cpu = _plan_fn(cfg)(*_on_cpu(sub))
    np.testing.assert_array_equal(np.asarray(gpu.sol.converged),
                                  np.asarray(cpu.sol.converged))
    agree = float(np.mean(np.asarray(gpu.sol.iters)
                          == np.asarray(cpu.sol.iters)))
    du = rel_err(gpu.forces, cpu.forces)
    dx = rel_err(gpu.states, cpu.states)
    assert agree >= ITERS_AGREE, f"iteration counts agree on {agree}"
    assert du <= REL_TOL and dx <= REL_TOL, (du, dx)
    say("c", "planner ok", B=B, backend=planner.effective_backend(cfg),
        conv=float(conv.mean()), solves_per_s=rate,
        mean_iters=float(np.mean(out.sol.iters)), first_call_s=t_first,
        host_iters_agree=agree, host_rel_du=du, host_rel_dx=dx)


def _wbc_batch(cfg, B, seed=0):
    """B jittered standing states with their CoM held as the reference."""
    import jax
    import jax.numpy as jnp

    from apf_quadruped import wbc
    from apf_quadruped.models import rbd
    from apf_quadruped.sim import physics

    dtype = jnp.float32
    rng = np.random.default_rng(seed)
    st0 = physics.initial_state(cfg, (0.0, 0.0), 0.0, dtype)
    q = jnp.asarray(np.asarray(st0.q)[None]
                    + rng.normal(size=(B, 12)) * 0.02, dtype)
    sts = wbc.WbcState(
        p_base=jnp.broadcast_to(st0.p_base, (B, 3)).astype(dtype),
        R_wb=jnp.broadcast_to(st0.R_wb, (B, 3, 3)).astype(dtype),
        q=q, u=jnp.asarray(rng.normal(size=(B, 18)) * 0.01, dtype),
        contact=jnp.ones((B, 4), dtype), crawl=jnp.zeros(B, bool),
        cone_rot=jnp.broadcast_to(jnp.eye(3, dtype=dtype), (B, 4, 3, 3)))
    com = jax.vmap(lambda p, R, qq: rbd.com_position(cfg.robot, p, R, qq)
                   )(sts.p_base, sts.R_wb, sts.q)
    z3 = jnp.zeros((B, 3), dtype)
    z43 = jnp.zeros((B, 4, 3), dtype)
    refs = wbc.WbcRefs(com_pos=com, com_vel=z3, com_acc=z3, rpy=z3,
                       omega=z3, omega_dot=z3, swing_pos=z43,
                       swing_vel=z43, swing_acc=z43)
    return sts, refs


def phase_wbc(B=1024):
    import jax

    from apf_quadruped import wbc
    from apf_quadruped.config import EngineConfig, SolverConfig

    cfg = EngineConfig(solver=SolverConfig())
    sts, refs = _wbc_batch(cfg, B)

    def make():
        return jax.jit(jax.vmap(lambda s, r: wbc.solve(cfg, s, r)))

    f = make()
    out = jax.block_until_ready(f(sts, refs))
    conv = float(np.mean(np.asarray(out.sol.converged)))
    assert conv >= 0.99, f"WBC converged fraction {conv}"
    assert np.isfinite(np.asarray(out.tau)).all()
    t0 = time.perf_counter()
    for _ in range(20):
        out = f(sts, refs)
    jax.block_until_ready(out)
    per_call = (time.perf_counter() - t0) / 20
    sub = jax.tree.map(lambda v: v[:64], (sts, refs))
    gpu = f(*sub)
    with jax.default_device(jax.devices("cpu")[0]):
        cpu = make()(*_on_cpu(sub))
    dtau = rel_err(gpu.tau, cpu.tau)
    dud = rel_err(gpu.udot, cpu.udot)
    assert dtau <= REL_TOL and dud <= REL_TOL, (dtau, dud)
    say("d", "wbc ok", B=B, converged=conv, ms_per_call=per_call * 1e3,
        host_rel_dtau=dtau, host_rel_dudot=dud)


def _sweep_stats(res):
    return {"goal_dist": float(np.mean(res.goal_dist)),
            "fell": float(np.mean(np.asarray(res.fell, np.float32))),
            "qp_converged": float(np.mean(res.qp_converged)),
            "slip_frac": float(np.mean(res.slip_frac))}


def phase_sweep(n=1024, n_cycles=4):
    import jax

    from apf_quadruped.config import EngineConfig, SolverConfig
    from apf_quadruped.runtime import sweep

    cfg = EngineConfig(solver=SolverConfig())
    scn = sweep.random_scenarios(cfg, n=n, seed=0)
    t0 = time.perf_counter()
    run = sweep.run_batch.lower(cfg, scn, n_cycles).compile()
    t_compile = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = jax.block_until_ready(run(scn))
    secs = time.perf_counter() - t0
    stats = _sweep_stats(res)
    assert np.isfinite(np.asarray(res.final_com)).all()
    assert stats["qp_converged"] > 0.9, stats
    assert stats["fell"] < 0.25, stats
    iters = np.asarray(res.metrics.mpc_iters)            # (n, n_cycles)
    cold, warm = float(iters[:, 0].mean()), float(iters[:, 1:].mean())
    assert warm < cold, (warm, cold)
    say("e", "sweep ok", scenarios=n, cycles=n_cycles,
        s_per_cycle=secs / n_cycles,
        sim_s_per_wall_s=n * n_cycles * cfg.gait.trot_cycle / secs,
        compile_s=t_compile, mpc_iters_cold=cold, mpc_iters_warm=warm,
        **stats)


def phase_f32_health():
    from f32_health import production_cfg, trot_flat

    row = trot_flat(production_cfg())
    assert row["qp_converged"] >= 0.97, row
    assert row["track_err_m"] < 0.03, row
    assert row["upright"] > 0.98, row
    say("f", "f32 health ok", **row)


def phase_four_cards(n=4096, n_cycles=4, rtol=1e-2):
    """Sharded vs one-card sweep stats.  rtol plus an absolute slack of
    eight lanes (8/n, 0.2% at n=4096) is looser than the 1e-4 of
    benchmarks/multihost.py: there both runs execute the same sharded
    program; here the per-device batch differs (1024 vs 4096 lanes), XLA
    compiles different code for each, and last-bit differences change a
    few 400 Hz convergence flags and, rarely, a lane's outcome (a fall)
    in a 4-cycle closed loop.  On 4 virtual CPU devices with 8 scenarios
    the two already differ by 6e-4 relative in qp_converged (2 of 3200
    ticks) and 2.6% in slip_frac."""
    import jax

    from apf_quadruped.config import EngineConfig, SolverConfig
    from apf_quadruped.runtime import sweep

    devices = jax.devices()
    assert len(devices) == 4, f"need 4 devices, have {len(devices)}"
    cfg = EngineConfig(solver=SolverConfig())
    scn = sweep.random_scenarios(cfg, n=n, seed=0)
    one = jax.device_put(scn, devices[0])
    # the two programs compile (and run) side by side: compilation is
    # most of this phase's time, and the comparison needs no timing
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as ex:
        four = ex.submit(lambda: jax.block_until_ready(
            sweep.run_sharded(cfg, scn, n_cycles, devices=devices)))
        single = ex.submit(lambda: jax.block_until_ready(
            sweep.run_batch(cfg, one, n_cycles)))
        res4, stats4 = four.result()
        res1 = single.result()
    wall = time.perf_counter() - t0
    stats4 = {k: float(v) for k, v in stats4.items()}
    stats1 = _sweep_stats(res1)
    for k in stats1:
        np.testing.assert_allclose(stats4[k], stats1[k], rtol=rtol,
                                   atol=8.0 / n, err_msg=k)
    say("g", "four-card sweep matches one card", scenarios=n,
        cycles=n_cycles, stats_4=stats4, stats_1=stats1,
        lanes_same_com=float(np.mean(np.all(np.abs(
            np.asarray(res4.final_com) - np.asarray(res1.final_com))
            < 1e-3, axis=-1))),
        wall_s_both_with_compile=wall)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4))
    args = ap.parse_args()

    import jax

    from apf_quadruped.runtime import cache
    cache.enable()

    phase_device()
    if args.devices == 4:
        phase_four_cards()
    else:
        phase_golden()
        phase_planner()
        phase_wbc()
        phase_sweep()
        phase_f32_health()
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
