"""Goal-reaching case study: does the aware controller actually ARRIVE?

CASES.md's fixed-10 s sweeps measure falls/slip/progress — the paper's
core claim — but not goal attainment, which is the navigation layer's
job (the reference robot crosses its courses).  This study runs each
(case, config) cell in chunks until every lane is within `goal_radius`
of its target or the cycle cap is hit, and reports success rate and
time-to-goal statistics.

The target sits at y = `goal_y` (default 1.5 m, past the first patch
row of every case world): the APF step saturation (0.06 m/cycle,
main.cpp:2767-2789) bounds nominal approach speed at ~0.12 m/s, so
distant goals measure patience, not navigation.  One JSON line per cell.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from case_study import build_config, build_scenarios  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", default="1,2,3,4")
    ap.add_argument("--configs", default="naive,aware,adaptive")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--max-cycles", type=int, default=60)
    ap.add_argument("--goal-y", type=float, default=1.5)
    ap.add_argument("--goal-radius", type=float, default=0.3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import jax

    from apf_quadruped.runtime import cache
    cache.enable()

    import jax.numpy as jnp

    from apf_quadruped.runtime import sweep

    dtype = jnp.float32
    chunk = 2
    for config_name in args.configs.split(","):
        cfg = build_config(config_name)
        cycle_s = 1.0 if cfg.gait.mode == "adaptive" else 0.5
        max_cycles = (args.max_cycles // 2 if cfg.gait.mode == "adaptive"
                      else args.max_cycles)
        for case in map(int, args.cases.split(",")):
            scn = build_scenarios(cfg, case, args.batch, args.seed, dtype)
            scn = scn._replace(target_xy=scn.target_xy.at[:, 1].set(
                args.goal_y))
            B = args.batch
            t0 = time.perf_counter()
            states = sweep.init_batch(cfg, scn)
            reach_cycle = np.full(B, -1, np.int64)
            fell = np.zeros(B, bool)
            cyc = 0
            while cyc < max_cycles:
                states, m = sweep.step_batch(cfg, scn, states, chunk)
                cyc += chunk
                com = np.asarray(states.sim.p_base)[:, 0:2]
                dist = np.linalg.norm(com - np.asarray(scn.target_xy),
                                      axis=-1)
                fell |= np.asarray(states.sim.R_wb)[:, 2, 2] < 0.7
                newly = (reach_cycle < 0) & (dist < args.goal_radius) & ~fell
                reach_cycle[newly] = cyc
                if ((reach_cycle >= 0) | fell).all():
                    break
            wall = time.perf_counter() - t0
            com = np.asarray(states.sim.p_base)[:, 0:2]
            dist = np.linalg.norm(com - np.asarray(scn.target_xy), axis=-1)
            ok = reach_cycle >= 0
            t_goal = reach_cycle[ok] * cycle_s
            print(json.dumps({
                "case": case, "config": config_name, "B": B,
                "goal_y": args.goal_y, "radius": args.goal_radius,
                "cap_s": round(max_cycles * cycle_s, 1),
                "success_pct": round(100.0 * ok.mean(), 1),
                "fell_pct": round(100.0 * fell.mean(), 1),
                "t_goal_mean_s": (round(float(t_goal.mean()), 1)
                                  if ok.any() else None),
                "t_goal_p90_s": (round(float(np.percentile(t_goal, 90)), 1)
                                 if ok.any() else None),
                "resid_dist_m": round(float(dist[~ok].mean()), 2)
                                if (~ok).any() else 0.0,
                "wall_s": round(wall, 1),
            }), flush=True)


if __name__ == "__main__":
    main()
