"""Test harness config: force CPU with an 8-device virtual mesh.

Multi-chip sharding logic is tested on a fake-device CPU mesh
(--xla_force_host_platform_device_count), mirroring how the driver
dry-runs the multi-chip path.

A run asked for on another platform (JAX_PLATFORMS set to something other
than cpu) is re-executed once in a clean CPU environment; JAX may already
be imported by then, so an in-process environ tweak would be too late
(marker APF_TESTS_REEXEC guards recursion).  Tests that need the GPU are
marked `gpu` and skip here; chip_smoke.py runs the same checks on the
card.
"""

import os
import sys

_MARK = "APF_TESTS_REEXEC"


def _needs_reexec() -> bool:
    if os.environ.get(_MARK):
        return False
    return os.environ.get("JAX_PLATFORMS", "") not in ("", "cpu")


if _needs_reexec():
    env = dict(os.environ)
    env[_MARK] = "1"
    env["JAX_PLATFORMS"] = "cpu"
    flags = env.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        env["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
    os.execve(sys.executable,
              [sys.executable, "-m", "pytest"] + sys.argv[1:], env)

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)
