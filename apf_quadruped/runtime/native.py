"""ctypes bindings for the native C++ scenario generator (native/
scenario_gen.cpp) — the host-side data-loader component (the role Gazebo's
C++ world/model machinery plays in the reference).

Builds with g++ on first use if the shared library is missing or older
than its source (a library left by another checkout is never trusted);
falls back to the pure-numpy generators in sim.terrain / sim.disturbance when no
toolchain is available (same distributions, different RNG streams).
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_LIB = None
_LIB_TRIED = False
_SO_PATH = os.path.join(os.path.dirname(__file__), "libscenariogen.so")
_SRC = os.path.join(os.path.dirname(__file__), os.pardir, os.pardir,
                    "native", "scenario_gen.cpp")


def _load():
    global _LIB, _LIB_TRIED
    if _LIB is not None or _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    stale = os.path.exists(_SRC) and (
        not os.path.exists(_SO_PATH)
        or os.path.getmtime(_SRC) > os.path.getmtime(_SO_PATH))
    if stale:
        # build beside the target and rename, so a concurrent process
        # never loads a half-written library
        tmp = f"{_SO_PATH}.{os.getpid()}.tmp"
        try:
            subprocess.run(
                ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                 "-o", tmp, _SRC],
                check=True, capture_output=True, timeout=120)
            os.replace(tmp, _SO_PATH)
        except Exception:
            return None
    if not os.path.exists(_SO_PATH):
        return None
    try:
        lib = ctypes.CDLL(_SO_PATH)
    except OSError:
        return None
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.generate_terrains.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_uint64]
    lib.generate_terrains.restype = ctypes.c_int
    lib.generate_disturbances.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_uint64]
    lib.generate_disturbances.restype = ctypes.c_int
    lib.generate_targets.argtypes = [f32p, ctypes.c_int, ctypes.c_uint64]
    lib.generate_targets.restype = ctypes.c_int
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def terrains(batch: int, res: int, extent: float, mu_default: float = 0.8,
             n_patches: int = 4, mu_range=(0.15, 0.5), area: float = 3.5,
             seed: int = 0) -> np.ndarray:
    """(batch, res, res) float32 mu grids from the native rasterizer."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native scenario generator unavailable")
    out = np.empty((batch, res, res), np.float32)
    rc = lib.generate_terrains(out, batch, res, extent, mu_default,
                               n_patches, mu_range[0], mu_range[1], area,
                               seed)
    if rc != 0:
        raise RuntimeError(f"generate_terrains failed rc={rc}")
    return out


def disturbances(batch: int, n_events: int, horizon_s: float,
                 f_max: float = 40.0, dur: float = 0.3,
                 seed: int = 0) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError("native scenario generator unavailable")
    out = np.empty((batch, n_events, 7), np.float32)
    rc = lib.generate_disturbances(out, batch, n_events, horizon_s, f_max,
                                   dur, seed)
    if rc != 0:
        raise RuntimeError(f"generate_disturbances failed rc={rc}")
    # append the application-link column (0 = base) to match the
    # (n_events, 8) schedule layout of sim.disturbance
    return np.concatenate([out, np.zeros_like(out[..., :1])], axis=-1)


def targets(batch: int, seed: int = 0) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError("native scenario generator unavailable")
    out = np.empty((batch, 2), np.float32)
    rc = lib.generate_targets(out, batch, seed)
    if rc != 0:
        raise RuntimeError(f"generate_targets failed rc={rc}")
    return out
