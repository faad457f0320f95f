"""Batched scenario sweeps: vmap within a chip, shard_map across the mesh.

The batched replacement for "roslaunch it N times": thousands of
(terrain, target, disturbance) scenarios run in lockstep through the full
closed loop (runtime.loop), with sweep statistics pmean-reduced across
devices (SURVEY.md §5.8).  Orbax checkpointing of sweep state lives in
runtime.checkpoint.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import EngineConfig
from ..parallel import mesh as mesh_mod
from ..sim import disturbance, terrain as terrain_mod
from . import loop


class Scenario(NamedTuple):
    """One batch row: terrain mu-map + navigation target + disturbances +
    spawn pose."""

    mu_map: jnp.ndarray       # (res, res)
    target_xy: jnp.ndarray    # (2,)
    dist_sched: jnp.ndarray   # (n_events, 8) — sim.disturbance rows
    spawn_xy: jnp.ndarray     # (2,)
    spawn_yaw: jnp.ndarray    # ()


class SweepResult(NamedTuple):
    final_com: jnp.ndarray     # (B, 3)
    goal_dist: jnp.ndarray     # (B,) final xy distance to target
    upright: jnp.ndarray       # (B,) final R[2,2]
    fell: jnp.ndarray          # (B,) bool
    rob_mean: jnp.ndarray      # (B,) last-cycle robustness
    qp_converged: jnp.ndarray  # (B,) mean WBC convergence
    slip_frac: jnp.ndarray     # (B,) mean slipping fraction
    metrics: loop.CycleMetrics  # stacked (B, n_cycles, ...)


def random_scenarios(cfg: EngineConfig, n: int, seed: int = 0,
                     n_patches: int = 4, dtype=jnp.float32,
                     use_native: bool | None = None) -> Scenario:
    """Randomized slippery-patch navigation scenarios (the case-world
    generator generalized).

    Generation runs in the native C++ rasterizer (runtime.native) when
    available — the host-side data-loader component — with a pure-numpy
    fallback (same distributions, different RNG streams)."""
    from . import native

    if use_native is None:
        use_native = native.available()
    if use_native:
        mu = native.terrains(n, cfg.sim.terrain_res, cfg.sim.terrain_extent,
                             cfg.sim.mu_default, n_patches, seed=seed + 1)
        targets = native.targets(n, seed=seed + 2)
        dist = native.disturbances(n, 2, horizon_s=4.0, seed=seed + 3)
        return Scenario(mu_map=jnp.asarray(mu, dtype),
                        target_xy=jnp.asarray(targets, dtype),
                        dist_sched=jnp.asarray(dist, dtype),
                        spawn_xy=jnp.zeros((n, 2), dtype),
                        spawn_yaw=jnp.zeros(n, dtype))

    rng = np.random.default_rng(seed)
    terr = terrain_mod.random_patches(cfg.sim, rng, n_patches=n_patches,
                                      batch=n, dtype=dtype)
    targets = np.stack([rng.uniform(-0.6, 0.6, n), rng.uniform(1.2, 2.2, n)],
                       axis=-1)
    dist = disturbance.random_pushes(rng, horizon_s=4.0, n=2, f_max=40.0,
                                     batch=n, dtype=dtype)
    return Scenario(mu_map=terr.mu_map,
                    target_xy=jnp.asarray(targets, dtype),
                    dist_sched=dist,
                    spawn_xy=jnp.zeros((n, 2), dtype),
                    spawn_yaw=jnp.zeros(n, dtype))


def _run_one(cfg: EngineConfig, scn: Scenario, n_cycles: int, dtype):
    terr = terrain_mod.Terrain(mu_map=scn.mu_map,
                               extent=cfg.sim.terrain_extent,
                               res=cfg.sim.terrain_res)
    st = loop.init(cfg, dtype=dtype)
    st = st._replace(sim=st.sim._replace(
        p_base=st.sim.p_base.at[0:2].set(scn.spawn_xy)))
    # the init state is scenario-independent (hence "unvarying" under
    # shard_map); stamp it with a zero varying seed so scan carries match
    seed = 0.0 * (jnp.sum(scn.target_xy) + scn.spawn_yaw
                  + jnp.sum(scn.mu_map) + jnp.sum(scn.dist_sched))
    st = mesh_mod.seed_varying(st, seed)
    st2, metrics = loop.run(cfg, st, terr, scn.target_xy, scn.dist_sched,
                            n_cycles)
    com = metrics.com[-1]
    return st2, metrics, com


@partial(jax.jit, static_argnames=("cfg",))
def init_batch(cfg: EngineConfig, scn: Scenario):
    """Batched initial LoopStates for a scenario batch (spawns applied)."""
    dtype = scn.target_xy.dtype

    def one(s):
        st = loop.init(cfg, dtype=dtype)
        st = st._replace(sim=st.sim._replace(
            p_base=st.sim.p_base.at[0:2].set(s.spawn_xy)))
        seed = 0.0 * (jnp.sum(s.target_xy) + s.spawn_yaw
                      + jnp.sum(s.mu_map) + jnp.sum(s.dist_sched))
        return mesh_mod.seed_varying(st, seed)

    return jax.vmap(one)(scn)


@partial(jax.jit, static_argnames=("cfg", "n_cycles", "mesh"))
def step_batch_sharded(cfg: EngineConfig, scn: Scenario, states,
                       n_cycles: int, mesh):
    """step_batch over a device mesh: the scenario batch AND the loop
    states are sharded on the scenario axis; each shard advances its
    lanes locally (shard_map, no cross-device traffic inside a chunk).
    The chunked driver for MULTI-HOST sweeps (run_resumable(devices=...))
    — on a pod slice each process computes only its local shard."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from ..parallel.mesh import SCENARIO_AXIS

    def per_shard(s, st):
        def one(si, sti):
            terr = terrain_mod.Terrain(mu_map=si.mu_map,
                                       extent=cfg.sim.terrain_extent,
                                       res=cfg.sim.terrain_res)
            return loop.run(cfg, sti, terr, si.target_xy, si.dist_sched,
                            n_cycles)

        return jax.vmap(one)(s, st)

    f = shard_map(per_shard, mesh=mesh,
                  in_specs=(P(SCENARIO_AXIS), P(SCENARIO_AXIS)),
                  out_specs=(P(SCENARIO_AXIS), P(SCENARIO_AXIS)),
                  check_vma=True)
    return f(scn, states)


@partial(jax.jit, static_argnames=("cfg", "n_cycles"))
def step_batch(cfg: EngineConfig, scn: Scenario, states, n_cycles: int):
    """Advance a batch of LoopStates n_cycles and return (states',
    stacked CycleMetrics).

    The chunked driver: long experiments call this repeatedly with a
    SMALL n_cycles, threading the state — the compiled program stays
    small (one n_cycles-scan) and is reused across chunks, cases, and
    sweeps, instead of baking the whole experiment length into one giant
    XLA program (benchmarks/case_study.py)."""

    def one(s, st):
        terr = terrain_mod.Terrain(mu_map=s.mu_map,
                                   extent=cfg.sim.terrain_extent,
                                   res=cfg.sim.terrain_res)
        return loop.run(cfg, st, terr, s.target_xy, s.dist_sched, n_cycles)

    return jax.vmap(one)(scn, states)


def _concat_metrics(parts):
    """Concatenate per-chunk CycleMetrics (B, n, ...) along the cycle
    axis."""
    return jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=1), *parts)


def run_resumable(cfg: EngineConfig, scn: Scenario, n_cycles: int,
                  chunk: int = 2, ckpt_dir: str | None = None,
                  devices=None, _crash_after: int | None = None):
    """Chunked batch driver with orbax checkpoint/resume (SURVEY.md §5.4
    — the persistence role of the reference's Gazebo state logs,
    DogBotV4/log/*/gzserver/state.log, made useful: a preempted sweep
    resumes mid-run and finishes with results IDENTICAL to an
    uninterrupted one; tests/test_sweep.py pins that equality).

    Drives init_batch/step_batch in `chunk`-cycle pieces (small compiled
    program, reused across chunks).  After every chunk the sweep cursor,
    the batched LoopStates, and the accumulated CycleMetrics are saved
    to `ckpt_dir` (no directory = no persistence, plain chunked run).
    On entry, an existing checkpoint resumes from its cursor.

    Returns (final LoopStates, CycleMetrics stacked (B, n_cycles, ...)).

    devices: None = single-device vmap; a device list = shard the batch
    (and the carried states) over the scenario mesh per chunk
    (step_batch_sharded) — the MULTI-HOST form of SURVEY.md §5.4's
    promise: checkpoints gather to host (np.asarray), resume re-shards.

    _crash_after: test hook — raise after that many chunks (simulating
    preemption AFTER the save, like a SIGKILL between chunks).
    """
    from ..parallel import mesh as mesh_mod
    from . import checkpoint, loop

    mesh = None
    if devices is not None:
        mesh = mesh_mod.scenario_mesh(devices)
        scn = mesh_mod.shard_batch(mesh, scn)
    states = init_batch(cfg, scn)
    if mesh is not None:
        states = mesh_mod.shard_batch(mesh, states)
    treedef = jax.tree.structure(states)
    mdef = jax.tree.structure(loop.CycleMetrics(*loop.CycleMetrics._fields))
    done = 0
    parts = []
    if ckpt_dir is not None and checkpoint.exists(ckpt_dir):
        raw = checkpoint.restore(ckpt_dir)
        done = int(raw["cycles_done"])
        states = jax.tree.unflatten(
            treedef, [jnp.asarray(x) for x in raw["state_leaves"]])
        if mesh is not None:
            states = mesh_mod.shard_batch(mesh, states)
        if done > 0:
            parts = [jax.tree.unflatten(
                mdef, [jnp.asarray(x) for x in raw["metric_leaves"]])]
    chunks_run = 0
    while done < n_cycles:
        n = min(chunk, n_cycles - done)
        if mesh is not None:
            states, m = step_batch_sharded(cfg, scn, states, n, mesh)
        else:
            states, m = step_batch(cfg, scn, states, n)
        parts.append(m)
        done += n
        chunks_run += 1
        if ckpt_dir is not None:
            acc = _concat_metrics(parts)
            parts = [acc]
            checkpoint.save(ckpt_dir, {
                "cycles_done": done,
                "state_leaves": [np.asarray(x)
                                 for x in jax.tree.leaves(states)],
                "metric_leaves": [np.asarray(x)
                                  for x in jax.tree.leaves(acc)]})
        if _crash_after is not None and chunks_run >= _crash_after \
                and done < n_cycles:
            raise RuntimeError(f"simulated preemption after {done} cycles")
    if not parts:
        raise ValueError(
            f"run_resumable: nothing to run or return (n_cycles="
            f"{n_cycles} with no prior checkpoint progress)")
    return states, _concat_metrics(parts)


@partial(jax.jit, static_argnames=("cfg", "n_cycles"))
def run_batch(cfg: EngineConfig, scn: Scenario, n_cycles: int) -> SweepResult:
    """vmap over the scenario batch (single device)."""
    dtype = scn.target_xy.dtype

    def one(s):
        st2, metrics, com = _run_one(cfg, s, n_cycles, dtype)
        return SweepResult(
            final_com=com,
            goal_dist=jnp.linalg.norm(com[0:2] - s.target_xy),
            upright=st2.sim.R_wb[2, 2],
            fell=st2.sim.R_wb[2, 2] < 0.7,
            rob_mean=metrics.rob_mean[-1],
            qp_converged=jnp.mean(metrics.qp_converged),
            slip_frac=jnp.mean(metrics.slip_ticks),
            metrics=metrics)

    return jax.vmap(one)(scn)


def run_sharded(cfg: EngineConfig, scn: Scenario, n_cycles: int,
                devices=None):
    """shard_map the batch over the scenario mesh; per-shard vmap inside;
    mean sweep stats psum-reduced across devices."""
    m = mesh_mod.scenario_mesh(devices)
    scn_sharded = mesh_mod.shard_batch(m, scn)

    def per_shard(s):
        res = run_batch(cfg, s, n_cycles)
        stats = {
            "goal_dist": jnp.mean(res.goal_dist),
            "fell": jnp.mean(res.fell.astype(jnp.float32)),
            "qp_converged": jnp.mean(res.qp_converged),
            "slip_frac": jnp.mean(res.slip_frac),
        }
        return res, stats

    fn = mesh_mod.sharded_map(m, per_shard)
    return jax.jit(fn)(scn_sharded)
