"""Case-world behavioral study: does the slippage-aware machinery help?

The reference paper's core experiment (dogbot_gazebo/worlds/case{1..4}.world
+ gztest_case*.launch): walk the robot through friction-patch fields and
show that the slippage-robustness machinery — the per-foot cone-margin
EWMA driving the fake-crawl gain reduction (main.cpp:1320), optionally the
repulsive field in the step targets (#define REP_FIELD) and the in-loop
adaptive trot<->crawl switch — measurably reduces slipping and falls.

Here that experiment runs as ONE batched device sweep per (case, config):
B lanes of the full closed loop (APF -> MPC -> WBC -> sim) with jittered
spawns/targets, vmapped on-chip (runtime/sweep.py).  Where the reference
gathered a handful of Gazebo runs, one device gathers hundreds at once.

Configs:
  naive     — slippage machinery OFF (crawl_threshold=-1: fake-crawl can
              never fire; no repulsive step field)
  aware     — the reference's executed default (fake-crawl at 0.34)
  aware_rep — + repulsive field in the step targets (#define REP_FIELD 1,
              main.cpp:62)
  adaptive  — + in-loop trot<->crawl gait switching (our extension
              completing the reference's abandoned crawl path)

Prints one JSON line per (case, config) with mean slip fraction, fall
rate, forward progress, and robustness; results recorded in CASES.md.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_config(name: str):
    from apf_quadruped.config import (ApfConfig, EngineConfig,
                                          FootholdConfig, GaitConfig)

    if name == "naive":
        # ALL slippage-aware machinery off, incl. foothold selection
        return EngineConfig(apf=ApfConfig(crawl_threshold=-1.0),
                            foothold=FootholdConfig(enabled=False))
    if name == "aware_nofh":
        # the r3 "aware" config: fake-crawl on, foothold selection OFF —
        # isolates the foothold optimizer's contribution vs "aware"
        return EngineConfig(foothold=FootholdConfig(enabled=False))
    if name == "aware":
        return EngineConfig()
    if name == "aware_rep":
        return EngineConfig(apf=ApfConfig(rep_field_in_step=True))
    if name == "fh_fast":
        # foothold selection carries the slippage avoidance; the
        # fake-crawl brake only fires on genuinely bad ground
        # (config.apf_fast — goal_study.py measured the reference gains
        # never reaching a 1.5 m goal in 120 s)
        from apf_quadruped.config import apf_fast
        return EngineConfig(apf=apf_fast())
    if name == "nofh_fast":
        # ablation of fh_fast: identical gains/threshold, foothold
        # selection OFF — isolates the foothold optimizer's contribution
        from apf_quadruped.config import apf_fast
        return EngineConfig(apf=apf_fast(),
                            foothold=FootholdConfig(enabled=False))
    if name == "adaptive":
        # horizon 40 covers the shared 1 s trot/crawl cycle (loop.py)
        from apf_quadruped.config import MpcConfig
        return EngineConfig(apf=ApfConfig(rep_field_in_step=True),
                            gait=GaitConfig(mode="adaptive"),
                            mpc=MpcConfig(horizon=40))
    raise ValueError(name)


def build_scenarios(cfg, case: int, B: int, seed: int, dtype):
    import jax.numpy as jnp

    from apf_quadruped.runtime.sweep import Scenario
    from apf_quadruped.sim import disturbance, terrain

    rng = np.random.default_rng(seed + case)
    terr = terrain.case_world(cfg.sim, case, dtype=dtype)
    mu = jnp.broadcast_to(terr.mu_map, (B,) + terr.mu_map.shape)
    targets = np.stack([rng.uniform(-0.15, 0.15, B),
                        np.full(B, 4.0)], axis=-1)
    spawns = np.stack([rng.uniform(-0.12, 0.12, B),
                       rng.uniform(-0.05, 0.05, B)], axis=-1)
    # the no-disturbance schedule, batched (disturbance.empty keeps the
    # 8-column row layout defined in one place)
    sched = jnp.broadcast_to(disturbance.empty(dtype)[None],
                             (B,) + disturbance.empty(dtype).shape)
    return Scenario(mu_map=mu,
                    target_xy=jnp.asarray(targets, dtype),
                    dist_sched=sched,
                    spawn_xy=jnp.asarray(spawns, dtype),
                    spawn_yaw=jnp.zeros(B, dtype))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", default="1,2,3,4")
    ap.add_argument("--configs", default="naive,aware,aware_rep,adaptive")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--cycles", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint", default="",
                    help="checkpoint directory: every chunk saves the "
                         "sweep cursor + states there (runtime.sweep."
                         "run_resumable), and a killed run resumes "
                         "mid-cell with identical results")
    args = ap.parse_args()

    import jax

    from apf_quadruped.runtime import cache
    cache.enable()

    import jax.numpy as jnp

    from apf_quadruped.runtime import sweep

    dtype = jnp.float32
    chunk = 2          # cycles per compiled step (small program, reused)
    for config_name in args.configs.split(","):
        cfg = build_config(config_name)
        # adaptive mode shares the 1 s crawl cycle; halve the cycle count
        # so every config sees the same simulated seconds
        n_cycles = (args.cycles // 2 if cfg.gait.mode == "adaptive"
                    else args.cycles)
        for case in map(int, args.cases.split(",")):
            scn = build_scenarios(cfg, case, args.batch, args.seed, dtype)
            t0 = time.perf_counter()
            # chunked driver with optional per-cell checkpoint/resume: a
            # preempted sweep restarted with the same --checkpoint picks
            # up at the saved cursor and produces identical stats
            ck = (os.path.join(args.checkpoint,
                               f"{config_name}_case{case}")
                  if args.checkpoint else None)
            states, m = sweep.run_resumable(cfg, scn, n_cycles=n_cycles,
                                            chunk=chunk, ckpt_dir=ck)
            jax.block_until_ready(states)
            wall = time.perf_counter() - t0
            cycles_run = n_cycles
            slip = np.asarray(m.slip_ticks)          # (B, n_cycles)
            conv = np.asarray(m.qp_converged)
            fmu = np.asarray(m.foot_mu)
            # steady-state tail: the last chunk's mean robustness
            rob_tail = np.asarray(m.rob_mean)[:, -chunk:]
            final_com = np.asarray(states.sim.p_base)  # base ~ CoM xy
            upright = np.asarray(states.sim.R_wb)[:, 2, 2]
            progress = final_com[:, 1] - np.asarray(scn.spawn_xy)[:, 1]
            goal = np.linalg.norm(final_com[:, 0:2]
                                  - np.asarray(scn.target_xy), axis=-1)
            print(json.dumps({
                "case": case, "config": config_name,
                "B": args.batch, "cycles": cycles_run,
                "sim_s": round(cycles_run * (1.0 if cfg.gait.mode ==
                                             "adaptive" else 0.5), 1),
                "fell_pct": round(100 * float(np.mean(upright < 0.7)), 2),
                "slip_frac": round(float(np.mean(slip)), 4),
                "progress_m": round(float(np.mean(progress)), 3),
                "goal_dist": round(float(np.mean(goal)), 3),
                "rob_final": round(float(np.mean(rob_tail)), 3),
                # mean terrain mu under the CHOSEN step targets: the
                # foothold-selection observable (aware vs aware_nofh)
                "foot_mu": round(float(np.mean(fmu)), 3),
                "qp_conv": round(float(np.mean(conv)), 3),
                "wall_s": round(wall, 1),
            }), flush=True)


if __name__ == "__main__":
    main()
