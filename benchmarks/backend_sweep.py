"""Sweep MPC solver backends x batch sizes on the current device.

Usage: python benchmarks/backend_sweep.py [--backends riccati,condensed]
       [--batches 128,256,512,1024] [--horizon 20] [--iters 12]

Prints one JSON line per (backend, batch) with solves/s, mean convergence,
and per-call latency — the exploration harness behind bench.py's number:
find the throughput knee.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_inputs(cfg, B, dtype):
    import jax.numpy as jnp

    from apf_quadruped import gait, planner
    from apf_quadruped.models import srb
    from apf_quadruped.models.dogbot import nominal_stance

    rng = np.random.default_rng(0)
    com0 = jnp.asarray(
        np.array([0.0, 0.0, 0.4]) + rng.normal(size=(B, 3)) * 0.01, dtype)
    yaw = jnp.asarray(rng.normal(size=B) * 0.1, dtype)
    vel = jnp.asarray(rng.normal(size=(B, 3)) * 0.05, dtype)
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
        com0, jnp.zeros((B, 3), dtype), vel)
    return x0, refs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--backends",
                    default="riccati,condensed")
    ap.add_argument("--batches", default="128,256,512,1024")
    ap.add_argument("--horizon", type=int, default=20)
    ap.add_argument("--iters", type=int, default=15)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()

    import jax

    from apf_quadruped.runtime import cache
    cache.enable()

    import jax.numpy as jnp

    from apf_quadruped import planner
    from apf_quadruped.config import EngineConfig, MpcConfig, SolverConfig

    for backend in args.backends.split(","):
        for B in map(int, args.batches.split(",")):
            # production SolverConfig() defaults, --iters only (default =
            # the SolverConfig default so all artifacts share one config)
            cfg = EngineConfig(
                mpc=MpcConfig(horizon=args.horizon, dt=0.025,
                              backend=backend),
                solver=SolverConfig(iters=args.iters))
            x0, refs = build_inputs(cfg, B, jnp.float32)
            f = jax.jit(lambda x0, refs: planner.plan(cfg, x0, refs))
            t0 = time.perf_counter()
            out = jax.block_until_ready(f(x0, refs))
            t_compile = time.perf_counter() - t0
            conv = float(np.mean(np.asarray(out.sol.converged)))
            t0 = time.perf_counter()
            for _ in range(args.reps):
                out = f(x0, refs)
            jax.block_until_ready(out)
            dt_call = (time.perf_counter() - t0) / args.reps
            print(json.dumps({
                "backend": backend, "B": B, "H": args.horizon,
                "iters": args.iters,
                "solves_per_s": round(B / dt_call, 1),
                "ms_per_call": round(dt_call * 1e3, 3),
                "conv": round(conv, 4),
                "compile_s": round(t_compile, 1),
            }), flush=True)


if __name__ == "__main__":
    main()
