"""CLI entry points — the roslaunch replacement.

    python -m apf_quadruped run   --case 2 --target 0,2 --cycles 8
    python -m apf_quadruped sweep --batch 64 --cycles 6
    python -m apf_quadruped bench

`run` drives one scenario through the closed loop and writes trajectory +
metric plots; `sweep` shards a scenario batch over all local devices and
prints aggregate statistics (the reference's per-case gztest launches,
minus Gazebo, times N).
"""

from __future__ import annotations

import argparse
import json
import sys


def _cfg(args):
    from .config import (EngineConfig, GaitConfig, MpcConfig, SolverConfig,
                         WbcConfig)

    gait_mode = getattr(args, "gait", "trot")
    # f32-safe tolerances (the CLI runs f32 on device): reltol/abstol 1e-2
    # is the reference's own runtime setting (main.cpp:1651-1652) AND the
    # f32-reachable one — tighter (1e-4) tolerances are only reachable at
    # f64, and unreachable tolerances prevent lanes from freezing, letting
    # the IPM iterate past convergence into f32 Cholesky breakdown
    # (measured in F32_HEALTH.md).
    robot_name = getattr(args, "robot", "dogbot")
    if robot_name != "dogbot":
        # zoo robot: full closed-loop config (leg chain + tuned APF
        # thresholds) from models/zoo.py, with the CLI flags layered on
        from .models import zoo

        base = zoo.engine_config_for(robot_name)
    else:
        base = EngineConfig()
    # crawl/adaptive share a 1 s cycle -> horizon 40; trot and the fixed
    # strides (gait.NAMED_MODE_FLAGS) run 0.5 s cycles -> horizon 20
    horizon = 40 if gait_mode in ("crawl", "adaptive") else 20
    return base.replace(
        gait=GaitConfig(mode=gait_mode),
        mpc=MpcConfig(horizon=horizon,
                      sqp_iters=getattr(args, "sqp", 1)),
        solver=SolverConfig(iters=args.iters, reltol=1e-2, abstol=1e-2),
        wbc=WbcConfig(slack_weight_trot=1e6))


def cmd_run(args):
    import jax.numpy as jnp
    import numpy as np

    from .runtime import loop, viz
    from .sim import disturbance, terrain

    cfg = _cfg(args)
    dtype = jnp.float32
    if args.world:
        terr = terrain.HEIGHT_WORLDS[args.world](cfg.sim, dtype=dtype)
    elif args.case > 0:
        terr = terrain.case_world(cfg.sim, args.case, dtype=dtype)
    else:
        terr = terrain.flat(cfg.sim, dtype=dtype)
    target = jnp.asarray([float(v) for v in args.target.split(",")], dtype)
    st = loop.init(cfg, dtype=dtype)
    st2, m = loop.run(cfg, st, terr, target, disturbance.empty(dtype),
                      n_cycles=args.cycles)
    com = np.asarray(m.com)
    for i in range(len(com)):
        print(f"cycle {i}: com=({com[i, 0]:+.3f}, {com[i, 1]:+.3f}, "
              f"{com[i, 2]:.3f}) rob={float(m.rob_mean[i]):.3f} "
              f"crawl={int(m.fake_crawl[i])} "
              f"qp={float(m.qp_converged[i]):.2f} "
              f"slip={float(m.slip_ticks[i]):.2f} "
              f"track={float(m.track_err[i]):.3f}")
    goal_err = float(np.linalg.norm(com[-1, :2] - np.asarray(target)))
    print(f"final distance to target: {goal_err:.3f} m; "
          f"upright R22={float(st2.sim.R_wb[2, 2]):.4f}")
    if args.plot:
        p1 = viz.plot_run(args.plot, terr.mu_map, cfg.sim.terrain_extent,
                          com, target_xy=np.asarray(target),
                          title=f"case {args.case}, {args.cycles} cycles")
        p2 = viz.plot_metrics(args.plot.replace(".png", "_metrics.png"), m)
        print(f"wrote {p1} and {p2}")


def cmd_sweep(args):
    import numpy as np

    from .runtime import sweep

    cfg = _cfg(args)
    scn = sweep.random_scenarios(cfg, n=args.batch, seed=args.seed)
    if args.checkpoint:
        # resumable chunked driver: a killed sweep restarted with the
        # same --checkpoint picks up at the saved cursor
        states, m = sweep.run_resumable(cfg, scn, n_cycles=args.cycles,
                                        ckpt_dir=args.checkpoint)
        upright = np.asarray(states.sim.R_wb)[:, 2, 2]
        com = np.asarray(states.sim.p_base)[:, 0:2]
        gd = np.linalg.norm(com - np.asarray(scn.target_xy), axis=-1)
        print(f"scenarios={args.batch} cycles={args.cycles} "
              f"goal_dist mean={gd.mean():.3f} "
              f"p90={np.percentile(gd, 90):.3f} "
              f"fell={int((upright < 0.7).sum())} "
              f"qp_conv={float(np.mean(np.asarray(m.qp_converged))):.2f} "
              f"slip={float(np.mean(np.asarray(m.slip_ticks))):.3f}")
        return
    if args.sharded:
        res, stats = sweep.run_sharded(cfg, scn, n_cycles=args.cycles)
        print(json.dumps({k: float(v) for k, v in stats.items()}))
    else:
        res = sweep.run_batch(cfg, scn, n_cycles=args.cycles)
    gd = np.asarray(res.goal_dist)
    print(f"scenarios={args.batch} cycles={args.cycles} "
          f"goal_dist mean={gd.mean():.3f} p90={np.percentile(gd, 90):.3f} "
          f"fell={int(np.asarray(res.fell).sum())} "
          f"qp_conv={float(np.mean(np.asarray(res.qp_converged))):.2f} "
          f"slip={float(np.mean(np.asarray(res.slip_frac))):.3f}")


def cmd_bench(args):
    import bench

    bench.main()


def main(argv=None):
    p = argparse.ArgumentParser(prog="apf_quadruped")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("run", help="single closed-loop scenario")
    pr.add_argument("--case", type=int, default=0,
                    help="case world 1-4, 5 = nav_case1a (0 = flat)")
    pr.add_argument("--world", type=str, default="",
                    help="height-map world (block/stairs/gap/slope/"
                         "chimney/chimney_lr; overrides --case)")
    pr.add_argument("--target", type=str, default="0,1.5")
    pr.add_argument("--cycles", type=int, default=8)
    pr.add_argument("--iters", type=int, default=15)
    pr.add_argument("--plot", type=str, default="",
                    help="write trajectory PNG here")
    from .gait import NAMED_MODE_FLAGS
    pr.add_argument("--gait",
                    choices=("trot", "crawl", "adaptive")
                    + tuple(NAMED_MODE_FLAGS),
                    default="trot",
                    help="gait mode (adaptive = in-loop robustness "
                         "switch; stride names run that stride fixed)")
    pr.add_argument("--sqp", type=int, default=1,
                    help="SQP outer iterations per MPC solve")
    pr.add_argument("--robot", choices=("dogbot", "anymal", "hyq"),
                    default="dogbot",
                    help="closed-loop robot model (models/zoo.py)")
    pr.set_defaults(fn=cmd_run)

    ps = sub.add_parser("sweep", help="batched scenario sweep")
    ps.add_argument("--batch", type=int, default=64)
    ps.add_argument("--cycles", type=int, default=6)
    ps.add_argument("--iters", type=int, default=15)
    ps.add_argument("--seed", type=int, default=0)
    ps.add_argument("--robot", choices=("dogbot", "anymal", "hyq"),
                    default="dogbot",
                    help="closed-loop robot model (models/zoo.py)")
    ps.add_argument("--sharded", action="store_true",
                    help="shard over all local devices")
    ps.add_argument("--checkpoint", default="",
                    help="checkpoint dir: save the sweep cursor/states "
                         "every chunk and resume a killed run "
                         "(runtime.sweep.run_resumable)")
    ps.set_defaults(fn=cmd_sweep)

    pb = sub.add_parser("bench", help="planner benchmark (bench.py)")
    pb.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    from .runtime import cache
    cache.enable()
    args.fn(args)


if __name__ == "__main__":
    main()
