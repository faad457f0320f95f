"""Secondary benchmark: whole-body tracking QP latency vs the 400 Hz budget.

The reference solves one 30-var QP (qpSWIFT) every 2.5 ms on a desktop CPU
(reference main.cpp:1107 `ros::Rate r(400)`, QP_SETUP_dense at :1649).
Here the same formulation (wbc.solve) runs BATCHED: one fused solve for B
scenarios.  Two numbers matter:

  * p99 wall-clock of one batched solve — must fit the 2.5 ms real-time
    budget (BASELINE.md north-star table);
  * effective WBC solves/s = B / mean latency.

Prints one JSON line per batch size.  (The repo-root bench.py remains the
headline planner-throughput benchmark.)
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

    from apf_quadruped import wbc
    from apf_quadruped.config import EngineConfig, SolverConfig
    from apf_quadruped.models import rbd
    from apf_quadruped.sim import physics

    # THE production config: SolverConfig() defaults (iters=15,
    # reltol=abstol=1e-2), same as bench.py / backend_sweep / f32_health
    cfg = EngineConfig(solver=SolverConfig())
    dtype = jnp.float32
    rng = np.random.default_rng(0)

    for B in (1, 128, 1024):
        st0 = physics.initial_state(cfg, (0.0, 0.0), 0.0, dtype)
        jitter = rng.normal(size=(B, 12)) * 0.02
        q = jnp.asarray(np.asarray(st0.q)[None] + jitter, dtype)
        sts = wbc.WbcState(
            p_base=jnp.broadcast_to(st0.p_base, (B, 3)).astype(dtype),
            R_wb=jnp.broadcast_to(st0.R_wb, (B, 3, 3)).astype(dtype),
            q=q,
            u=jnp.asarray(rng.normal(size=(B, 18)) * 0.01, dtype),
            contact=jnp.ones((B, 4), dtype),
            crawl=jnp.zeros(B, bool),
            cone_rot=jnp.broadcast_to(jnp.eye(3, dtype=dtype),
                                      (B, 4, 3, 3)))
        com = jax.vmap(lambda p, R, qq: rbd.com_position(cfg.robot, p, R, qq)
                       )(sts.p_base, sts.R_wb, sts.q)
        z3 = jnp.zeros((B, 3), dtype)
        refs = wbc.WbcRefs(
            com_pos=com, com_vel=z3, com_acc=z3,
            rpy=z3, omega=z3, omega_dot=z3,
            swing_pos=jnp.zeros((B, 4, 3), dtype),
            swing_vel=jnp.zeros((B, 4, 3), dtype),
            swing_acc=jnp.zeros((B, 4, 3), dtype))

        f = jax.jit(jax.vmap(lambda s, r: wbc.solve(cfg, s, r)))
        out = jax.block_until_ready(f(sts, refs))
        conv = float(np.mean(np.asarray(out.sol.converged)))

        # each sample includes one dispatch; the MARGINAL scanned latency
        # below is the real-time-relevant number
        times = []
        for _ in range(50):
            t0 = time.perf_counter()
            out = jax.block_until_ready(f(sts, refs))
            times.append(time.perf_counter() - t0)
        times = np.asarray(times)
        mean_ms = float(times.mean() * 1e3)
        p99_ms = float(np.percentile(times, 99) * 1e3)
        print(json.dumps({
            "metric": f"wbc_batched_solve_latency_B{B}",
            "value": p99_ms, "unit": "ms_p99",
            "mean_ms": round(mean_ms, 4),
            "solves_per_s": round(B / (times.mean()), 1),
            "converged_frac": round(conv, 4),
            "vs_baseline": round(2.5 / p99_ms, 3)}), flush=True)

    # --- marginal per-solve DEVICE latency at B=1 ------------------------
    # One wall-clock dispatch costs a fixed launch overhead regardless of
    # work, but the production 400 Hz loop never dispatches per tick: runtime/loop.run_cycle lax.scans the solve on
    # device (as the reference's ctrl_loop stays inside one process,
    # main.cpp:1107).  The real-time-relevant number is the MARGINAL time
    # per solve inside a scan: fit t(K) = a + b*K over two chain lengths.
    st0 = physics.initial_state(cfg, (0.0, 0.0), 0.0, dtype)
    com1 = rbd.com_position(cfg.robot, st0.p_base, st0.R_wb, st0.q)
    z3s = jnp.zeros(3, dtype)
    ref1 = wbc.WbcRefs(com_pos=com1, com_vel=z3s, com_acc=z3s,
                       rpy=z3s, omega=z3s, omega_dot=z3s,
                       swing_pos=jnp.zeros((4, 3), dtype),
                       swing_vel=jnp.zeros((4, 3), dtype),
                       swing_acc=jnp.zeros((4, 3), dtype))

    def chain(K):
        dq = jnp.asarray(rng.normal(size=(K, 12)) * 0.01, dtype)

        @jax.jit
        def run(dq):
            def tick(acc, dqk):
                stk = wbc.WbcState(
                    p_base=st0.p_base, R_wb=st0.R_wb, q=st0.q + dqk,
                    u=jnp.zeros(18, dtype), contact=jnp.ones(4, dtype),
                    crawl=jnp.asarray(False))
                out = wbc.solve(cfg, stk, ref1)
                return acc + out.tau, out.sol.converged
            acc, conv = jax.lax.scan(tick, jnp.zeros(12, dtype), dq)
            return acc, conv
        out = jax.block_until_ready(run(dq))
        ts = []
        for _ in range(20):
            t0 = time.perf_counter()
            out = jax.block_until_ready(run(dq))
            ts.append(time.perf_counter() - t0)
        return np.asarray(ts), float(np.mean(np.asarray(out[1])))

    t64, _ = chain(64)
    t256, conv_c = chain(256)
    marg = (t256 - t64.mean()) / (256 - 64)       # per-sample distribution
    marg_ms = float(np.mean(marg) * 1e3)
    marg_p99 = float(np.percentile(marg, 99) * 1e3)
    print(json.dumps({
        "metric": "wbc_solve_marginal_latency_scanned_B1",
        "value": marg_p99, "unit": "ms_p99",
        "mean_ms": round(marg_ms, 4),
        "converged_frac": round(conv_c, 4),
        "dispatch_overhead_ms": round(
            float(t64.mean() * 1e3 - 64 * marg_ms), 2),
        "vs_baseline": round(2.5 / max(marg_p99, 1e-9), 3)}), flush=True)


if __name__ == "__main__":
    main()
