"""Native C++ scenario generator: build, bindings, distribution sanity."""

import numpy as np
import pytest

from apf_quadruped.runtime import native


@pytest.fixture(scope="module")
def lib_available():
    if not native.available():
        pytest.skip("no C++ toolchain / library")


def test_terrains(lib_available):
    mu = native.terrains(batch=8, res=64, extent=6.0, mu_default=0.8,
                         n_patches=4, seed=42)
    assert mu.shape == (8, 64, 64)
    assert mu.dtype == np.float32
    # default friction everywhere far from patches (y < 0 corner)
    assert (mu[:, 0, 0] == np.float32(0.8)).all()
    # patches present: some cells below default
    assert (mu.min(axis=(1, 2)) < 0.55).all()
    # deterministic in seed
    mu2 = native.terrains(batch=8, res=64, extent=6.0, mu_default=0.8,
                          n_patches=4, seed=42)
    np.testing.assert_array_equal(mu, mu2)
    # different per scenario
    assert not np.array_equal(mu[0], mu[1])


def test_disturbances(lib_available):
    d = native.disturbances(batch=4, n_events=3, horizon_s=4.0, f_max=40.0,
                            seed=7)
    # 8 columns: the native 7 (t0, t1, fx, fy, fz, omega, phase) plus the
    # appended application-link column (0 = base)
    assert d.shape == (4, 3, 8)
    assert (d[..., 0] >= 0.5).all()
    assert (d[..., 1] <= 4.0).all()
    assert (np.abs(d[..., 2:4]) <= 40.0).all()
    assert (d[..., 4:] == 0).all()


def test_targets(lib_available):
    t = native.targets(16, seed=3)
    assert t.shape == (16, 2)
    assert (np.abs(t[:, 0]) <= 0.6).all()
    assert ((t[:, 1] >= 1.2) & (t[:, 1] <= 2.2)).all()


def test_sweep_uses_native(lib_available):
    from apf_quadruped.config import EngineConfig, SimConfig
    from apf_quadruped.runtime import sweep

    cfg = EngineConfig(sim=SimConfig(terrain_res=32))
    scn = sweep.random_scenarios(cfg, n=4, seed=0, use_native=True)
    assert scn.mu_map.shape == (4, 32, 32)
    assert np.isfinite(np.asarray(scn.mu_map)).all()


def test_stale_library_is_rebuilt(tmp_path, monkeypatch):
    """A library older than its source (left by another checkout) is
    rebuilt before it is loaded."""
    import os
    import shutil

    from apf_quadruped.runtime import native

    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain")
    so = tmp_path / "libscenariogen.so"
    so.write_bytes(b"not a library")
    os.utime(so, (0, 0))                         # older than the source
    monkeypatch.setattr(native, "_SO_PATH", str(so))
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_LIB_TRIED", False)
    assert native._load() is not None
    assert so.stat().st_mtime > os.path.getmtime(native._SRC)
