"""Planner benchmark: batched MPC solves/s at horizon 20 on one device.

Prints ONE JSON line: {"metric", "value", "unit", "device"}.

Each "solve" is a full planner.plan: per-knot SRB linearization and the
batched Riccati interior-point solve with friction-pyramid constraints
(the role IPOPT+TOWR fills in the reference with a 20 s budget and the
sim paused, topt.cpp:97 / main.cpp:1250), on the backend "auto" resolves
to for the platform (planner.effective_backend).  PERF.md records what
was measured on the GPU.

    python bench.py
"""

import json
import time

import numpy as np


def make_batch(cfg, B, seed=0):
    """(x0, refs) for B standing-trot DogBot plans: CoMs jittered around
    0.4 m, small yaw and velocity, all lanes on the first trot pair."""
    import jax.numpy as jnp

    from apf_quadruped import gait, planner
    from apf_quadruped.models import srb
    from apf_quadruped.models.dogbot import nominal_stance

    dtype = jnp.float32
    rng = np.random.default_rng(seed)
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


def solves_per_s(f, x0, refs, B, n_rep=20, n_burst=3):
    """Median over bursts of B * n_rep / seconds, each burst fenced by
    block_until_ready."""
    import jax

    rates = []
    for _ in range(n_burst):
        t0 = time.perf_counter()
        for _ in range(n_rep):
            out = f(x0, refs)
        jax.block_until_ready(out)
        rates.append(B * n_rep / (time.perf_counter() - t0))
    return float(np.median(rates))


def main():
    import jax

    from apf_quadruped.runtime import cache
    cache.enable()

    from apf_quadruped import planner
    from apf_quadruped.config import EngineConfig, MpcConfig, SolverConfig

    # the production configuration: H=20, dt=0.025 (0.5 s trot),
    # SolverConfig() defaults (iters=15, reltol=abstol=1e-2 — the
    # reference's own runtime tolerance, main.cpp:1651-1652)
    cfg = EngineConfig(mpc=MpcConfig(horizon=20, dt=0.025),
                       solver=SolverConfig())
    B = 2048
    x0, refs = make_batch(cfg, B)
    f = jax.jit(lambda x0, refs: planner.plan(cfg, x0, refs))
    out = jax.block_until_ready(f(x0, refs))           # compile + warm
    conv = float(np.mean(np.asarray(out.sol.converged)))
    rate = solves_per_s(f, x0, refs, B)
    dev = jax.devices()[0]
    print(json.dumps({
        "metric": f"batched_mpc_solves_per_s_h{cfg.mpc.horizon}"
                  f"_b{B}_conv{conv:.2f}",
        "value": rate,
        "unit": "solves/s/device",
        "backend": planner.effective_backend(cfg),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
