"""Multi-HOST execution of the sharded sweep (SURVEY.md §5.8).

Launches N real OS processes, each owning a private set of virtual CPU
devices (--xla_force_host_platform_device_count), joined into one JAX
process group via `parallel.distributed.ensure_initialized` (localhost
coordinator).  Every process then runs the SAME `sweep.run_sharded` call
over the GLOBAL mesh — the code path a multi-host run takes, where pmean
reductions cross the process boundary over the network (here: TCP
between the processes).

This is the first actual execution of the process_count>1 branch of
`parallel/distributed.py`: the parent also runs the
identical sweep single-process on an 8-device mesh and asserts the
pmean-reduced stats agree to fp tolerance.

Usage:  python benchmarks/multihost.py [--nprocs 2] [--devices-per-proc 4]
Prints one JSON line per worker plus a final parity verdict; exits
nonzero on mismatch.  Artifact: MULTIHOST.md.
"""

import argparse
import json
import os
import socket
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)

# FULL production config (EngineConfig defaults — horizon 20, 0.5 s trot
# cycle, SolverConfig() production solver): measured on the 8-device
# virtual mesh this sweep runs healthy (qp_converged 0.96, fell 0.0)
# in ~30 s, so there is no reason to run degraded smoke settings.
N_SCENARIOS = 8
N_CYCLES = 2


def _cfg():
    from apf_quadruped.config import EngineConfig, SolverConfig

    return EngineConfig(solver=SolverConfig())


def _stats_of_sweep():
    import jax

    from apf_quadruped.runtime import sweep

    cfg = _cfg()
    scn = sweep.random_scenarios(cfg, n=N_SCENARIOS, seed=0,
                                 use_native=False)
    res, stats = sweep.run_sharded(cfg, scn, n_cycles=N_CYCLES)
    jax.block_until_ready(res)
    return {k: float(v) for k, v in stats.items()}


def worker(rank: int, nprocs: int, port: int):
    from apf_quadruped.parallel import distributed

    multi = distributed.ensure_initialized(
        coordinator=f"localhost:{port}", num_processes=nprocs,
        process_id=rank)
    info = distributed.process_info()
    assert multi, f"expected a multi-process group, got {info}"
    assert info["process_count"] == nprocs, info
    stats = _stats_of_sweep()
    print(json.dumps({"mode": "multihost", "rank": rank, **info,
                      "stats": stats}), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--devices-per-proc", type=int, default=4)
    ap.add_argument("--worker", type=int, default=None)
    ap.add_argument("--port", type=int, default=None)
    args = ap.parse_args()

    if args.worker is not None:
        worker(args.worker, args.nprocs, args.port)
        return

    # pick a free coordinator port
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    env = dict(os.environ)
    # the workers run on the CPU only, so they never share a GPU: one JAX
    # process per card holds
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={args.devices_per_proc}")

    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--worker", str(rank), "--nprocs", str(args.nprocs),
             "--port", str(port),
             "--devices-per-proc", str(args.devices_per_proc)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        for rank in range(args.nprocs)
    ]
    outs = [p.communicate(timeout=1200)[0] for p in procs]
    rcs = [p.returncode for p in procs]

    worker_stats = []
    for rank, out in enumerate(outs):
        line = next((ln for ln in out.splitlines()
                     if ln.startswith('{"mode": "multihost"')), None)
        if line is None:
            print(f"--- worker {rank} output ---\n{out}", flush=True)
        else:
            rec = json.loads(line)
            worker_stats.append(rec)
            print(line, flush=True)
    if any(rc != 0 for rc in rcs) or len(worker_stats) != args.nprocs:
        print(json.dumps({"metric": "multihost_parity", "value": 0.0,
                          "unit": "bool", "error": f"worker rcs {rcs}"}),
              flush=True)
        sys.exit(1)

    # single-process reference on the SAME total device count
    total = args.nprocs * args.devices_per_proc
    env1 = dict(env)
    env1["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={total}"
    single = subprocess.run(
        [sys.executable, "-c",
         "import sys, json; sys.path.insert(0, %r); "
         "import benchmarks.multihost as mh; "
         "print(json.dumps(mh._stats_of_sweep()))" % REPO],
        env=env1, capture_output=True, text=True, timeout=1200)
    ref = json.loads(single.stdout.strip().splitlines()[-1])
    print(json.dumps({"mode": "single", "devices": total, "stats": ref}),
          flush=True)

    tol = 1e-4
    ok = True
    for rec in worker_stats:
        for k, v in ref.items():
            dv = abs(rec["stats"][k] - v)
            if dv > tol * max(1.0, abs(v)):
                ok = False
                print(f"MISMATCH rank {rec['rank']} {k}: "
                      f"{rec['stats'][k]} vs {v}", flush=True)
    healthy = ref["qp_converged"] > 0.9 and ref["fell"] < 0.25
    print(json.dumps({
        "metric": "multihost_parity", "value": 1.0 if (ok and healthy) else 0.0,
        "unit": "bool", "nprocs": args.nprocs,
        "devices_per_proc": args.devices_per_proc,
        "qp_converged": ref["qp_converged"], "fell": ref["fell"],
        "healthy": healthy}), flush=True)
    sys.exit(0 if (ok and healthy) else 1)


if __name__ == "__main__":
    main()
