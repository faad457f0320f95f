"""Scenario-sweep tests: batched closed loop, virtual 8-device sharding,
checkpoint round-trip."""

import tempfile

import jax
import pytest
import jax.numpy as jnp
import numpy as np

from apf_quadruped.config import (EngineConfig, GaitConfig, MpcConfig,
                                      SimConfig, SolverConfig, WbcConfig)
from apf_quadruped.runtime import checkpoint, loop, sweep

# tiny config: these tests check plumbing, not behavior
pytestmark = pytest.mark.slow  # f64 closed-loop scans (see pytest.ini tiering)

CFG = EngineConfig(
    gait=GaitConfig(trot_cycle=0.1),
    mpc=MpcConfig(horizon=4, dt=0.025),
    sim=SimConfig(substeps=1, terrain_res=16),
    solver=SolverConfig(iters=5),
    wbc=WbcConfig(slack_weight_trot=1e6),
)


def test_run_batch_shapes():
    scn = sweep.random_scenarios(CFG, n=4, seed=1)
    res = sweep.run_batch(CFG, scn, n_cycles=2)
    assert res.final_com.shape == (4, 3)
    assert res.goal_dist.shape == (4,)
    assert np.isfinite(np.asarray(res.final_com)).all()
    assert res.metrics.com.shape == (4, 2, 3)


def test_run_sharded_8_devices():
    assert len(jax.devices()) == 8, "conftest must provide 8 CPU devices"
    scn = sweep.random_scenarios(CFG, n=8, seed=2)
    res, stats = sweep.run_sharded(CFG, scn, n_cycles=1)
    assert res.final_com.shape == (8, 3)
    assert np.isfinite(float(stats["goal_dist"]))
    # pmean-reduced scalar equals the full-batch mean
    np.testing.assert_allclose(float(stats["goal_dist"]),
                               float(np.mean(np.asarray(res.goal_dist))),
                               rtol=1e-5)


def test_sharded_matches_single_device():
    """Same scenarios through the sharded and single-device paths.

    f32 + different XLA partitioning changes reduction orders, and the
    contact-switching closed loop amplifies those ulps over a cycle —
    agreement is physical (cm-level), not bitwise.
    """
    scn = sweep.random_scenarios(CFG, n=8, seed=3)
    res1 = sweep.run_batch(CFG, scn, n_cycles=1)
    res8, _ = sweep.run_sharded(CFG, scn, n_cycles=1)
    np.testing.assert_allclose(np.asarray(res8.final_com),
                               np.asarray(res1.final_com), atol=0.05)
    assert np.asarray(res8.fell).sum() == np.asarray(res1.fell).sum()


def test_checkpoint_roundtrip():
    st = loop.init(CFG, dtype=jnp.float32)
    with tempfile.TemporaryDirectory() as d:
        path = d + "/ckpt"
        checkpoint.save(path, st)
        assert checkpoint.exists(path)
        st2 = checkpoint.restore(path, like=st)
        for a, b in zip(jax.tree.leaves(st), jax.tree.leaves(st2)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b))


def test_resumable_sweep_survives_kill():
    """run_resumable is the checkpoint/resume SUBSYSTEM (SURVEY.md §5.4):
    kill the chunked driver after chunk 1, resume from the checkpoint
    directory, and the final states AND the full stacked metrics must be
    IDENTICAL to an uninterrupted run."""
    scn = sweep.random_scenarios(CFG, n=4, seed=7)
    states_ref, m_ref = sweep.run_resumable(CFG, scn, n_cycles=6, chunk=2)

    with tempfile.TemporaryDirectory() as d:
        ck = d + "/sweep_ckpt"
        with pytest.raises(RuntimeError, match="simulated preemption"):
            sweep.run_resumable(CFG, scn, n_cycles=6, chunk=2, ckpt_dir=ck,
                                _crash_after=1)
        assert checkpoint.exists(ck)
        # resume: picks up at cycle 2, finishes the remaining 4
        states, m = sweep.run_resumable(CFG, scn, n_cycles=6, chunk=2,
                                        ckpt_dir=ck)
        for a, b in zip(jax.tree.leaves(states), jax.tree.leaves(states_ref)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        for a, b in zip(jax.tree.leaves(m), jax.tree.leaves(m_ref)):
            assert np.asarray(a).shape == np.asarray(b).shape
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert m.com.shape[1] == 6


def test_resumable_no_dir_matches_run_batch():
    """Without a checkpoint dir, run_resumable is the plain chunked
    driver and reproduces run_batch exactly."""
    scn = sweep.random_scenarios(CFG, n=4, seed=3)
    res = sweep.run_batch(CFG, scn, n_cycles=2)
    states, m = sweep.run_resumable(CFG, scn, n_cycles=2, chunk=1)
    np.testing.assert_allclose(np.asarray(m.com),
                               np.asarray(res.metrics.com),
                               rtol=0, atol=1e-12)
    assert np.isfinite(np.asarray(states.sim.q)).all()


def test_chunked_step_matches_run_batch():
    """Driving the batch in 2 chunks of 1 cycle through
    init_batch/step_batch must reproduce run_batch(n_cycles=2) exactly
    (same states, same stacked metrics) — the chunked driver is what
    long experiments (benchmarks/case_study.py) use to keep compiled
    programs small."""
    scn = sweep.random_scenarios(CFG, n=4, seed=3)
    res = sweep.run_batch(CFG, scn, n_cycles=2)

    states = sweep.init_batch(CFG, scn)
    states, m1 = sweep.step_batch(CFG, scn, states, 1)
    states, m2 = sweep.step_batch(CFG, scn, states, 1)
    com_chunked = np.stack([np.asarray(m1.com)[:, 0],
                            np.asarray(m2.com)[:, 0]], axis=1)
    np.testing.assert_allclose(com_chunked, np.asarray(res.metrics.com),
                               rtol=0, atol=1e-12)
    assert np.isfinite(np.asarray(states.sim.q)).all()


def test_resumable_sharded_survives_kill():
    """The MULTI-HOST form of the checkpoint/resume subsystem:
    run_resumable(devices=...) chunks the sweep over the 8-device mesh
    (step_batch_sharded), checkpoints gather to host, resume re-shards —
    kill/resume must reproduce the uninterrupted sharded run exactly,
    and agree with the single-device vmap path physically."""
    assert len(jax.devices()) == 8
    scn = sweep.random_scenarios(CFG, n=8, seed=11)
    devs = jax.devices()
    st_ref, m_ref = sweep.run_resumable(CFG, scn, n_cycles=4, chunk=2,
                                        devices=devs)
    with tempfile.TemporaryDirectory() as d:
        ck = d + "/shard_ckpt"
        with pytest.raises(RuntimeError, match="simulated preemption"):
            sweep.run_resumable(CFG, scn, n_cycles=4, chunk=2, ckpt_dir=ck,
                                devices=devs, _crash_after=1)
        st2, m2 = sweep.run_resumable(CFG, scn, n_cycles=4, chunk=2,
                                      ckpt_dir=ck, devices=devs)
    for a, b in zip(jax.tree.leaves(st2), jax.tree.leaves(st_ref)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(jax.tree.leaves(m2), jax.tree.leaves(m_ref)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert m2.com.shape == (8, 4, 3)
    assert np.isfinite(np.asarray(st2.sim.q)).all()
    # (sharded-vs-single-device physical equivalence is pinned at 1
    # cycle by test_sharded_matches_single — at 4 cycles of this tiny
    # edge-of-stability config, partitioning ulps diverge chaotically)
