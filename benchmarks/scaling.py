"""Scaling-efficiency harness (BASELINE north star: >85% at >= 2 hosts).

Two modes, one metric — solves/s/device on the headline planner solve
(H=20 Riccati IPM, the bench.py workload):

  --mode mesh   weak scaling over a device MESH: fixed per-device batch,
                mesh sizes 1,2,4,8; efficiency(n) =
                throughput(n) / (n * throughput(1)).  Runs today on the
                virtual 8-device CPU mesh (the same fake-device config the
                driver uses for dryrun_multichip) and unchanged on real
                cards — the sharding is a one-axis scenario mesh, so
                the only cross-device traffic is result gathering
                (SURVEY.md §2.6: DP-over-scenarios is the only axis).
                Multi-host: launch one process per host with
                apf_quadruped.parallel.distributed.ensure_initialized()
                and the same code measures the path between hosts.
  --mode batch  batch scaling on ONE device: efficiency(B) =
                t(B0) * (B/B0) / t(B) — how close larger batches stay to
                linear cost in batch (the knee measurement of PERF.md).
  --mode overhead  sharding-overhead isolation for hosts where virtual
                devices timeshare the same cores (weak scaling there only
                measures core oversubscription, not the mesh): run the
                SAME total batch (a) plain-jit on one device and (b)
                shard_map over all devices, on the same silicon.
                overhead = 1 - t_plain / t_mesh.  Since the scenario mesh
                has zero cross-device traffic inside the solve (only the
                final stats pmean), overhead ~ 0 here predicts weak-scaling
                efficiency ~ 1 on real chips, where each mesh device IS
                extra hardware.

Prints one JSON line per point, then a final summary line with the
headline efficiency the driver can capture.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_MARK = "APF_SCALING_REEXEC"


def _reexec_cpu(n_devices: int) -> None:
    """Re-exec into a clean CPU env with a virtual n-device mesh (jax may
    already be imported, so in-process environ tweaks are too late — same
    dance as tests/conftest.py).  The child forces JAX_PLATFORMS=cpu, so it
    never opens a GPU: one JAX process per card holds."""
    env = dict(os.environ)
    env[_MARK] = "1"
    env["JAX_PLATFORMS"] = "cpu"
    flags = env.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        env["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={n_devices}"
        ).strip()
    os.execve(sys.executable, [sys.executable] + sys.argv, env)


def build_plan_fn(backend: str, iters: int):
    import jax
    import jax.numpy as jnp

    from apf_quadruped import planner
    from apf_quadruped.config import EngineConfig, MpcConfig, SolverConfig

    # production SolverConfig() defaults except the iteration budget
    # (VERDICT r2 #7: every artifact speaks about one config)
    cfg = EngineConfig(
        mpc=MpcConfig(horizon=20, dt=0.025, backend=backend),
        solver=SolverConfig(iters=iters))
    return cfg, jax.jit(lambda x0, refs: planner.plan(cfg, x0, refs))


def build_inputs(cfg, B):
    import jax.numpy as jnp

    from apf_quadruped import gait, planner
    from apf_quadruped.models import srb
    from apf_quadruped.models.dogbot import nominal_stance

    dtype = jnp.float32
    rng = np.random.default_rng(0)
    com0 = jnp.asarray(
        np.array([0.0, 0.0, 0.4]) + rng.normal(size=(B, 3)) * 0.01, dtype)
    yaw = jnp.asarray(rng.normal(size=B) * 0.1, dtype)
    feet0 = jnp.asarray(nominal_stance(cfg.robot))[None] + com0[:, None, :]
    feet0 = feet0.at[..., 2].set(0.0).astype(dtype)
    com_des = com0 + jnp.asarray([0.0, 0.06, 0.0], dtype)
    cycle = jnp.full(B, cfg.mpc.horizon * cfg.mpc.dt, dtype)
    contacts = gait.horizon_contacts(
        jnp.ones(B, jnp.int32), jnp.zeros(B, dtype), cfg.mpc.dt,
        cfg.mpc.horizon, cycle, dtype=dtype)
    refs = planner.MpcRefs(
        contacts=contacts,
        feet_w=planner.foothold_schedule(feet0, feet0, contacts),
        x_ref=planner.reference_trajectory(
            cfg, jnp.zeros((B, 3), dtype), com0, com_des, yaw, cycle),
        yaw_ref=yaw)
    x0 = srb.pack_state(
        jnp.stack([jnp.zeros_like(yaw), jnp.zeros_like(yaw), yaw], -1),
        com0, jnp.zeros((B, 3), dtype), jnp.zeros((B, 3), dtype))
    return x0, refs


def timed(f, x0, refs, reps):
    import jax

    out = jax.block_until_ready(f(x0, refs))
    conv = float(np.mean(np.asarray(out.sol.converged)))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = f(x0, refs)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps, conv


def mode_mesh(args):
    import jax

    from apf_quadruped.parallel import mesh as mesh_mod

    n_avail = len(jax.devices())
    cfg, f = build_plan_fn(args.backend, args.iters)
    b = args.per_device_batch
    results = {}
    for n in [m for m in (1, 2, 4, 8) if m <= n_avail]:
        m = mesh_mod.scenario_mesh(jax.devices()[:n])
        x0, refs = build_inputs(cfg, b * n)
        x0, refs = mesh_mod.shard_batch(m, (x0, refs))
        dt_call, conv = timed(f, x0, refs, args.reps)
        thru = b * n / dt_call
        results[n] = thru
        print(json.dumps({
            "mode": "mesh", "n_devices": n, "B_total": b * n,
            "solves_per_s": round(thru, 1),
            "solves_per_s_per_device": round(thru / n, 1),
            "ms_per_call": round(dt_call * 1e3, 3),
            "conv": round(conv, 4),
            "efficiency_vs_1dev": round(thru / (n * results[1]), 4),
        }), flush=True)
    n_max = max(results)
    eff = results[n_max] / (n_max * results[1])
    print(json.dumps({
        "metric": f"scaling_efficiency_mesh_{n_max}dev",
        "value": round(eff, 4), "unit": "fraction",
        "vs_baseline": round(eff / 0.85, 3),
        "platform": jax.devices()[0].platform,
    }), flush=True)


def mode_batch(args):
    import jax

    cfg, f = build_plan_fn(args.backend, args.iters)
    batches = list(map(int, args.batches.split(",")))
    results = {}
    for B in batches:
        x0, refs = build_inputs(cfg, B)
        dt_call, conv = timed(f, x0, refs, args.reps)
        results[B] = dt_call
        b0 = batches[0]
        eff = (results[b0] * B / b0) / dt_call
        print(json.dumps({
            "mode": "batch", "B": B,
            "solves_per_s": round(B / dt_call, 1),
            "ms_per_call": round(dt_call * 1e3, 3),
            "conv": round(conv, 4),
            "efficiency_vs_linear": round(eff, 4),
        }), flush=True)
    b0, bN = batches[0], batches[-1]
    eff = (results[b0] * bN / b0) / results[bN]
    print(json.dumps({
        "metric": f"batch_scaling_efficiency_B{b0}_to_B{bN}",
        "value": round(eff, 4), "unit": "fraction",
        "platform": jax.devices()[0].platform,
    }), flush=True)


def mode_overhead(args):
    import jax

    from apf_quadruped.parallel import mesh as mesh_mod

    n = len(jax.devices())
    cfg, f = build_plan_fn(args.backend, args.iters)
    B = args.per_device_batch * n
    x0, refs = build_inputs(cfg, B)

    # (a) plain jit, one device (the others idle — same silicon when
    # virtual devices timeshare one host)
    dev0 = jax.devices()[0]
    plain = jax.tree.map(lambda a: jax.device_put(a, dev0), (x0, refs))
    t_plain, conv_p = timed(f, *plain, args.reps)

    # (b) shard_map over the full scenario mesh, same total batch
    m = mesh_mod.scenario_mesh(jax.devices())
    sx0, srefs = mesh_mod.shard_batch(m, (x0, refs))
    t_mesh, conv_m = timed(f, sx0, srefs, args.reps)

    overhead = 1.0 - t_plain / t_mesh
    print(json.dumps({
        "mode": "overhead", "n_devices": n, "B_total": B,
        "ms_plain_1dev": round(t_plain * 1e3, 3),
        "ms_mesh": round(t_mesh * 1e3, 3),
        "conv_plain": round(conv_p, 4), "conv_mesh": round(conv_m, 4),
    }), flush=True)
    print(json.dumps({
        "metric": f"sharding_overhead_{n}dev_sametotal",
        "value": round(overhead, 4), "unit": "fraction",
        "platform": jax.devices()[0].platform,
        "note": "mesh vs plain at equal total batch on shared silicon; "
                "~0 => weak scaling ~1 on real chips (no cross-device "
                "traffic inside the solve)",
    }), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("mesh", "batch", "overhead"),
                    default="mesh")
    ap.add_argument("--backend", default=None,
                    help="default: auto (planner.effective_backend)")
    ap.add_argument("--iters", type=int, default=12)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--per-device-batch", type=int, default=32)
    ap.add_argument("--batches", default="256,512,1024,2048")
    args = ap.parse_args()

    if args.mode in ("mesh", "overhead") and not os.environ.get(_MARK):
        # mesh mode needs >= 8 devices; off-pod that means the virtual CPU
        # mesh (re-exec with a clean env, as the test conftest does)
        _reexec_cpu(8)

    import jax

    from apf_quadruped.runtime import cache
    cache.enable()

    if args.backend is None:
        args.backend = "auto"
    {"mesh": mode_mesh, "batch": mode_batch,
     "overhead": mode_overhead}[args.mode](args)


if __name__ == "__main__":
    main()
