"""Warm-start + early-exit benchmark (PERF.md levers 1 and 3).

Simulates the closed-loop replan sequence on the production MPC problem
(planner.plan, H=20, auto backend): solve cycle k, perturb the state
the way half a second of walking does (CoM advance + small pose noise),
then solve cycle k+1 COLD vs WARM-started from cycle k's solution.
Prints one JSON line with iterations-to-converge and solves/s for both.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax

    from apf_quadruped.runtime import cache
    cache.enable()

    import jax.numpy as jnp

    from apf_quadruped import gait, planner
    from apf_quadruped.config import EngineConfig, MpcConfig, SolverConfig
    from apf_quadruped.models import srb
    from apf_quadruped.models.dogbot import nominal_stance
    from apf_quadruped.ops.riccati import WarmStart

    cfg = EngineConfig(mpc=MpcConfig(horizon=20, dt=0.025),
                       solver=SolverConfig())
    dtype = jnp.float32
    B = 2048
    rng = np.random.default_rng(0)

    def make_inputs(step):
        com0 = jnp.asarray(
            np.array([0.0, 0.06 * step, 0.4])
            + rng.normal(size=(B, 3)) * 0.01, dtype)
        yaw = jnp.asarray(rng.normal(size=B) * 0.1, dtype)
        vel = jnp.asarray(np.array([0.0, 0.12, 0.0])
                          + rng.normal(size=(B, 3)) * 0.05, dtype)
        feet0 = (jnp.asarray(nominal_stance(cfg.robot))[None]
                 + com0[:, None, :]).at[..., 2].set(0.0).astype(dtype)
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

    x0_a, refs_a = make_inputs(0)
    x0_b, refs_b = make_inputs(1)      # the "next replan cycle"

    f_cold = jax.jit(lambda x0, refs: planner.plan(cfg, x0, refs))
    f_warm = jax.jit(
        lambda x0, refs, w: planner.plan(cfg, x0, refs, warm=w))

    sol_a = jax.block_until_ready(f_cold(x0_a, refs_a))
    Hh = cfg.mpc.horizon
    warm = WarmStart(
        u=sol_a.forces.reshape(B, Hh, 12),
        z=sol_a.sol.z.reshape(B, Hh, 24),
        s=sol_a.sol.s.reshape(B, Hh, 24),
        valid=jnp.ones(B, bool))

    cold_b = jax.block_until_ready(f_cold(x0_b, refs_b))
    warm_b = jax.block_until_ready(f_warm(x0_b, refs_b, warm))

    def timeit(fn, n=30):
        jax.block_until_ready(fn())
        t0 = time.perf_counter()
        for _ in range(n):
            r = fn()
        jax.block_until_ready(r)
        return (time.perf_counter() - t0) / n

    t_cold = timeit(lambda: f_cold(x0_b, refs_b))
    t_warm = timeit(lambda: f_warm(x0_b, refs_b, warm))

    print(json.dumps({
        "metric": "warmstart_mpc_h20_b2048",
        "iters_cold": round(float(np.asarray(cold_b.sol.iters).mean()), 2),
        "iters_warm": round(float(np.asarray(warm_b.sol.iters).mean()), 2),
        "conv_cold": round(float(np.asarray(cold_b.sol.converged).mean()), 3),
        "conv_warm": round(float(np.asarray(warm_b.sol.converged).mean()), 3),
        "solves_per_s_cold": round(B / t_cold, 1),
        "solves_per_s_warm": round(B / t_warm, 1),
        "speedup": round(t_cold / t_warm, 3),
    }))


if __name__ == "__main__":
    main()
