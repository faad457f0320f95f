"""f32 closed-loop health check on the accelerator.

Runs the full closed loop (APF -> MPC -> WBC -> sim) at PRODUCTION f32
settings on whatever backend JAX resolves (the GPU on the card; the CPU
when forced) and prints one JSON line per scenario plus a summary with
pass/fail health asserts:

  * qp_converged  — mean fraction of 400 Hz WBC solves converged
  * mpc_converged — every replan's Riccati IPM converged
  * track_err     — mean CoM tracking error during cycles (m)
  * upright       — R_wb[2,2] at the end (cos of tilt)
  * progress      — forward CoM motion toward the 1 m target

The closed-loop test suite runs f64 on the CPU (tests/conftest.py); this
shows the SAME loop healthy at f32 on the device, where reduced-precision
matmuls (bf16 or TF32) would corrupt it.  chip_smoke.py runs trot_flat as
its phase (f).  Results recorded in F32_HEALTH.md.

    python benchmarks/f32_health.py
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def production_cfg():
    """THE production config: SolverConfig() defaults (iters=15,
    reltol=abstol=1e-2 — the reference's own runtime tolerance), the
    same as tests/test_loop.py, bench.py and wbc_latency.py."""
    from apf_quadruped.config import EngineConfig, SolverConfig, WbcConfig

    return EngineConfig(solver=SolverConfig(),
                        wbc=WbcConfig(slack_weight_trot=1e6))


def trot_flat(cfg, n_cycles=4):
    """4 trot cycles on flat ground toward a 1 m target; one result row."""
    import jax
    import jax.numpy as jnp

    from apf_quadruped.runtime import loop
    from apf_quadruped.sim import disturbance, terrain

    dt = jnp.float32
    st = loop.init(cfg, dtype=dt)
    terr = terrain.flat(cfg.sim, dtype=dt)
    st2, m = loop.run(cfg, st, terr, jnp.asarray([0.0, 1.0], dt),
                      disturbance.empty(dt), n_cycles=n_cycles)
    st2 = jax.block_until_ready(st2)
    m = jax.tree.map(np.asarray, m)
    row = {
        "case": "trot_flat", "platform": jax.devices()[0].platform,
        "dtype": "float32",
        "qp_converged": float(m.qp_converged.mean()),
        "mpc_converged": bool(m.mpc_converged.all()),
        "track_err_m": float(m.track_err.mean()),
        "upright": float(st2.sim.R_wb[2, 2]),
        "com_y_end": float(m.com[-1, 1]),
        "tau_max": float(m.tau_max.max()),
        "rob_mean": float(m.rob_mean[-1]),
    }
    row["healthy"] = bool(
        row["qp_converged"] > 0.9 and row["mpc_converged"]
        and row["track_err_m"] < 0.03 and row["upright"] > 0.98
        and row["com_y_end"] > 0.10 and row["tau_max"] <= 60.0 + 1e-4)
    return row


def adaptive_crawl_recovery(cfg, n_cycles=5):
    """Adaptive gait seeded slippery: must engage crawl, recover trot."""
    import jax
    import jax.numpy as jnp

    from apf_quadruped.config import GaitConfig, MpcConfig
    from apf_quadruped.runtime import loop
    from apf_quadruped.sim import disturbance, terrain

    dt = jnp.float32
    cfg_a = cfg.replace(gait=GaitConfig(mode="adaptive"),
                        mpc=MpcConfig(horizon=40))
    st = loop.init(cfg_a, dtype=dt)
    st = st._replace(apf=st.apf._replace(
        h_int=jnp.zeros(4, dt), period_st=jnp.asarray(0.5, dt)))
    terr = terrain.flat(cfg_a.sim, dtype=dt)
    st2, m = loop.run(cfg_a, st, terr, jnp.asarray([0.0, 1.0], dt),
                      disturbance.empty(dt), n_cycles=n_cycles)
    m = jax.tree.map(np.asarray, jax.block_until_ready(m))
    row = {
        "case": "adaptive_crawl_recovery",
        "platform": jax.devices()[0].platform, "dtype": "float32",
        "qp_converged": float(m.qp_converged.mean()),
        "mpc_converged": bool(m.mpc_converged.all()),
        "engaged_crawl": bool(m.crawling[0]),
        "recovered_trot": bool(~m.crawling[-1]),
        "upright": float(st2.sim.R_wb[2, 2]),
        "com_y_end": float(m.com[-1, 1]),
    }
    row["healthy"] = bool(
        row["qp_converged"] > 0.9 and row["mpc_converged"]
        and row["engaged_crawl"] and row["recovered_trot"]
        and row["upright"] > 0.95 and row["com_y_end"] > 0.01)
    return row


def main():
    import jax

    from apf_quadruped.runtime import cache
    cache.enable()

    cfg = production_cfg()
    rows = []
    for case in (trot_flat, adaptive_crawl_recovery):
        rows.append(case(cfg))
        print(json.dumps(rows[-1]), flush=True)
    ok = all(r["healthy"] for r in rows)
    print(json.dumps({"metric": "f32_closed_loop_healthy",
                      "value": 1.0 if ok else 0.0, "unit": "bool",
                      "platform": jax.devices()[0].platform,
                      "kind": jax.devices()[0].device_kind,
                      "cases": len(rows)}), flush=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
