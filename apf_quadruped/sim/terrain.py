"""Terrain: friction-coefficient maps + height fields.

In the reference, "obstacles" are thin boxes/cylinders whose ONLY functional
property is reduced contact friction (mu in the <surface><friction> block:
easy 0.8, medium 0.5, hard 0.15-0.3 — reference dogbot_gazebo/models/
{box,circle,...}_{easy,medium,hard}/model.sdf), laid out by the case1-4
worlds (dogbot_gazebo/worlds/case*.world).  Here a terrain IS a mu grid:
scenario generation rasterizes patch primitives into a (res x res) array,
and the contact model samples mu at each foot — fully batched, so thousands
of random worlds run per chip.

Height fields re-derive towr's HeightMap interface (reference
include/towr/terrain/height_map.h:100-170: GetHeight + derivative-based
normals/tangent bases + per-terrain friction coeff) the batched way: instead
of C++ virtual dispatch over analytic terrain classes, a terrain is a
rasterized (res x res) height grid sampled BILINEARLY, with normals from
the bilinear gradient — branch-free, batched, one compiled program for
every terrain.  The towr example terrains (height_map_examples.h:
Block:57-71, Stairs:76-87, Gap:92-115, Slope:120-131, Chimney:136-148,
ChimneyLR:152-166) are provided as grid builders with the reference's
parameter values, rotated into this package's +y-forward convention.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

from ..config import SimConfig


class Terrain(NamedTuple):
    """mu_map: (.., res, res) friction grid over [-extent, extent]^2.
    h_map: optional (.., res, res) ground-height grid (None = FlatGround
    at z=0, the terrain the reference app actually uses — topt.cpp:9)."""

    mu_map: jnp.ndarray
    extent: float
    res: int
    h_map: Optional[jnp.ndarray] = None


def flat(cfg: SimConfig, mu: float | None = None, batch=(),
         dtype=jnp.float32) -> Terrain:
    m = cfg.mu_default if mu is None else mu
    return Terrain(
        mu_map=jnp.full(batch + (cfg.terrain_res, cfg.terrain_res), m, dtype),
        extent=cfg.terrain_extent, res=cfg.terrain_res)


def sample_mu(t: Terrain, xy: jnp.ndarray) -> jnp.ndarray:
    """mu at world xy ((.., 2)) by nearest-cell lookup (patch mu is
    piecewise constant in the reference worlds too)."""
    scale = t.res / (2.0 * t.extent)
    ij = jnp.clip(((xy + t.extent) * scale), 0, t.res - 1).astype(jnp.int32)
    return t.mu_map[..., ij[..., 1], ij[..., 0]]


def _bilinear(grid: jnp.ndarray, xy: jnp.ndarray, extent: float, res: int):
    """Bilinear sample of (.., res, res) grid at world xy (.., 2).

    Returns (value, d/dx, d/dy).  Grid cell centers sit at
    (i + 0.5) / res * 2*extent - extent (matching _grid below).
    """
    scale = res / (2.0 * extent)                      # cells per meter
    u = (xy + extent) * scale - 0.5                   # continuous cell coords
    u = jnp.clip(u, 0.0, res - 1.000001)
    i0 = jnp.floor(u).astype(jnp.int32)
    f = u - i0
    i1 = jnp.minimum(i0 + 1, res - 1)
    ix0, iy0 = i0[..., 0], i0[..., 1]
    ix1, iy1 = i1[..., 0], i1[..., 1]
    fx, fy = f[..., 0], f[..., 1]
    g00 = grid[..., iy0, ix0]
    g10 = grid[..., iy0, ix1]
    g01 = grid[..., iy1, ix0]
    g11 = grid[..., iy1, ix1]
    v0 = g00 * (1 - fx) + g10 * fx
    v1 = g01 * (1 - fx) + g11 * fx
    val = v0 * (1 - fy) + v1 * fy
    ddx = ((g10 - g00) * (1 - fy) + (g11 - g01) * fy) * scale
    ddy = (v1 - v0) * scale
    return val, ddx, ddy


def sample_height(t: Terrain, xy: jnp.ndarray) -> jnp.ndarray:
    """Ground height at world xy ((.., 2)); 0 for flat terrains.
    (towr HeightMap::GetHeight, height_map.h:100.)"""
    if t.h_map is None:
        return jnp.zeros(xy.shape[:-1], xy.dtype)
    val, _, _ = _bilinear(t.h_map, xy, t.extent, t.res)
    return val


def sample_normal(t: Terrain, xy: jnp.ndarray) -> jnp.ndarray:
    """Unit surface normal at world xy: n ∝ (-dh/dx, -dh/dy, 1).
    (towr HeightMap::GetNormalizedBasis(Normal), height_map.cc via
    GetHeightDeriv — same construction from the height gradient.)"""
    if t.h_map is None:
        n = jnp.zeros(xy.shape[:-1] + (3,), xy.dtype)
        return n.at[..., 2].set(1.0)
    _, ddx, ddy = _bilinear(t.h_map, xy, t.extent, t.res)
    n = jnp.stack([-ddx, -ddy, jnp.ones_like(ddx)], axis=-1)
    return n / jnp.linalg.norm(n, axis=-1, keepdims=True)


def basis_from_normal(n: jnp.ndarray) -> jnp.ndarray:
    """(.., 3, 3) rotation C with COLUMNS (t1, t2, n): f_world = C @ f_local,
    where f_local = (tangential1, tangential2, normal) components.

    The towr ForceConstraint builds its friction pyramid on exactly this
    per-foothold basis (reference force_constraint.cc:72-83:
    GetNormalizedBasis(Normal/Tangent1/Tangent2)); here the tangents come
    from projecting world-x onto the tangent plane (well-defined for any
    walkable slope, where n_z dominates).  For n = z-hat, C = I.
    """
    ex = jnp.zeros_like(n).at[..., 0].set(1.0)
    t1 = ex - jnp.sum(ex * n, axis=-1, keepdims=True) * n
    t1 = t1 / jnp.linalg.norm(t1, axis=-1, keepdims=True)
    t2 = jnp.cross(n, t1)
    return jnp.stack([t1, t2, n], axis=-1)


def cone_basis(t: Terrain, xy: jnp.ndarray) -> jnp.ndarray:
    """(.., 3, 3) terrain-aligned friction-cone basis at world xy;
    identity on flat terrains."""
    return basis_from_normal(sample_normal(t, xy))


def _grid(cfg: SimConfig):
    xs = (np.arange(cfg.terrain_res) + 0.5) / cfg.terrain_res
    xs = xs * 2 * cfg.terrain_extent - cfg.terrain_extent
    return np.meshgrid(xs, xs)             # X (res,res), Y (res,res)


def add_circle(cfg: SimConfig, mu_map: np.ndarray, cx, cy, r, mu) -> np.ndarray:
    X, Y = _grid(cfg)
    mask = (X - cx) ** 2 + (Y - cy) ** 2 <= r * r
    out = mu_map.copy()
    out[..., mask] = mu
    return out


def add_box(cfg: SimConfig, mu_map: np.ndarray, cx, cy, lx, ly, mu) -> np.ndarray:
    X, Y = _grid(cfg)
    mask = (np.abs(X - cx) <= lx / 2) & (np.abs(Y - cy) <= ly / 2)
    out = mu_map.copy()
    out[..., mask] = mu
    return out


# --- the reference case-study worlds as terrain builders ----------------
# Patch mu values from the model.sdf files: circle_big_hard 0.2,
# circle_hard 0.3, box_hard 0.15, *_medium 0.5, *_easy 0.8.

def case_world(cfg: SimConfig, case: int, dtype=jnp.float32) -> Terrain:
    """Friction layouts mirroring dogbot_gazebo/worlds/case{1..4}.world +
    nav_case1a.world: case1 = corridor of big slippery circles, case2 =
    boxes + circles, case3 = one medium square, case4 = one hard box,
    case5 = nav_case1a's graded easy/medium/hard circle line.
    (Coordinates follow
    the world files' spirit: patches straddle the straight-line path from
    the spawn to a forward goal along +y.)"""
    m = np.full((cfg.terrain_res, cfg.terrain_res), cfg.mu_default)
    if case == 1:
        for i, (cx, cy) in enumerate([(-0.4, 1.0), (0.45, 1.8), (-0.3, 2.6),
                                      (0.5, 3.4), (0.0, 4.2)]):
            m = add_circle(cfg, m, cx, cy, 0.45, 0.2)
    elif case == 2:
        for cx, cy in [(-0.4, 1.0), (0.4, 1.6), (0.0, 2.3), (-0.45, 3.0),
                       (0.4, 3.6)]:
            m = add_box(cfg, m, cx, cy, 0.6, 0.5, 0.15)
        for cx, cy in [(0.0, 1.0), (0.0, 4.3)]:
            m = add_circle(cfg, m, cx, cy, 0.3, 0.3)
    elif case == 3:
        m = add_box(cfg, m, 0.0, 1.5, 0.8, 0.8, 0.5)
    elif case == 4:
        m = add_box(cfg, m, 0.0, 1.5, 0.9, 0.7, 0.15)
    elif case == 5:
        # nav_case1a.world: graded big circles — easy (mu 0.8) at
        # (0.3, 1.7), medium (0.5) at (0, 3.6), hard (0.2) at (0, 5.7)
        m = add_circle(cfg, m, 0.3, 1.7, 0.45, 0.8)
        m = add_circle(cfg, m, 0.0, 3.6, 0.45, 0.5)
        m = add_circle(cfg, m, 0.0, 5.7, 0.45, 0.2)
    return Terrain(mu_map=jnp.asarray(m, dtype), extent=cfg.terrain_extent,
                   res=cfg.terrain_res)


# --- towr example height maps as grid builders --------------------------
# Parameters from reference include/towr/terrain/examples/
# height_map_examples.h (cited per builder).  towr's walking direction is
# +x; this package walks +y, so the towr "x" coordinate maps to our y and
# the towr "y" (lateral) to our x.

def _height_world(cfg: SimConfig, fn, dtype=jnp.float32,
                  mu: float | None = None) -> Terrain:
    """Rasterize height fn(fwd, lat) -> z onto the grid.  fwd = our +y."""
    X, Y = _grid(cfg)
    h = fn(Y, X)                                      # fwd = y, lat = x
    m = np.full_like(h, cfg.mu_default if mu is None else mu)
    return Terrain(mu_map=jnp.asarray(m, dtype), extent=cfg.terrain_extent,
                   res=cfg.terrain_res, h_map=jnp.asarray(h, dtype))


def block(cfg: SimConfig, dtype=jnp.float32) -> Terrain:
    """One step up (towr Block, height_map_examples.h:57-71: start 0.7,
    length 3.5, height 0.5, 0.03 m slope-smoothed edge)."""
    start, length, height, eps = 0.7, 3.5, 0.5, 0.03

    def fn(f, l):
        ramp = np.clip((f - start) / eps, 0.0, 1.0)
        inside = (f <= start + length).astype(float)
        return height * ramp * inside

    return _height_world(cfg, fn, dtype)


def stairs(cfg: SimConfig, dtype=jnp.float32) -> Terrain:
    """Two steps (towr Stairs, height_map_examples.h:76-87: first step at
    1.0 width 0.4 height 0.2, second step height 0.4, top width 1.0)."""
    s1, w1, h1, h2, wtop = 1.0, 0.4, 0.2, 0.4, 1.0

    def fn(f, l):
        h = np.zeros_like(f)
        h = np.where(f >= s1, h1, h)
        h = np.where(f >= s1 + w1, h2, h)
        h = np.where(f >= s1 + w1 + wtop, 0.0, h)
        return h

    return _height_world(cfg, fn, dtype)


def gap(cfg: SimConfig, dtype=jnp.float32) -> Terrain:
    """Parabolic gap (towr Gap, height_map_examples.h:92-115: start 1.0,
    width 0.5, depth 1.5, z = a f^2 + b f + c inside the gap)."""
    start, w, depth = 1.0, 0.5, 1.5
    xc = start + w / 2.0
    a = 4.0 * depth / (w * w)
    b = -8.0 * depth * xc / (w * w)
    c = -depth * (w - 2 * xc) * (w + 2 * xc) / (w * w)

    def fn(f, l):
        inside = (f > start) & (f < start + w)
        return np.where(inside, a * f * f + b * f + c, 0.0)

    return _height_world(cfg, fn, dtype)


def slope(cfg: SimConfig, dtype=jnp.float32) -> Terrain:
    """Up-then-down ramp (towr Slope, height_map_examples.h:120-131:
    start 1.0, up 1.0 m to height 0.7, down 1.0 m)."""
    start, up_len, down_len, hc = 1.0, 1.0, 1.0, 0.7
    grade = hc / up_len

    def fn(f, l):
        h = np.clip((f - start) * grade, 0.0, hc)
        down = f - (start + up_len)
        h = np.where(down > 0, np.maximum(hc - down * (hc / down_len), 0.0),
                     h)
        return h

    return _height_world(cfg, fn, dtype)


def chimney(cfg: SimConfig, dtype=jnp.float32) -> Terrain:
    """Tilted side-wall corridor (towr Chimney, height_map_examples.h:
    136-148: for x_start<f<x_end, z = slope*(lat - y_start) on one side;
    slope 3.0, y_start 0.5, length 1.5)."""
    start, length, y_start, grade = 1.0, 1.5, 0.5, 3.0

    def fn(f, l):
        inside = (f > start) & (f < start + length)
        wall = np.maximum(0.0, grade * (l - y_start))
        return np.where(inside, wall, 0.0)

    return _height_world(cfg, fn, dtype)


def chimney_lr(cfg: SimConfig, dtype=jnp.float32) -> Terrain:
    """Two-walled chimney (towr ChimneyLR, height_map_examples.h:152-166:
    left wall over the first length, right wall over the second; slope 2,
    y_start 0.5)."""
    start, length, y_start, grade = 0.5, 1.0, 0.5, 2.0

    def fn(f, l):
        seg1 = (f > start) & (f <= start + length)
        seg2 = (f > start + length) & (f <= start + 2 * length)
        wall_l = np.maximum(0.0, grade * (l - y_start))
        wall_r = np.maximum(0.0, grade * (-l - y_start))
        return np.where(seg1, wall_l, 0.0) + np.where(seg2, wall_r, 0.0)

    return _height_world(cfg, fn, dtype)


HEIGHT_WORLDS = {"block": block, "stairs": stairs, "gap": gap,
                 "slope": slope, "chimney": chimney, "chimney_lr": chimney_lr}


def random_patches(cfg: SimConfig, rng: np.random.Generator, n_patches=5,
                   mu_range=(0.15, 0.5), area=3.5, batch=1,
                   dtype=jnp.float32) -> Terrain:
    """Batched random slippery-patch worlds for scenario sweeps."""
    maps = np.empty((batch, cfg.terrain_res, cfg.terrain_res))
    for b in range(batch):
        m = np.full((cfg.terrain_res, cfg.terrain_res), cfg.mu_default)
        for _ in range(n_patches):
            cx, cy = rng.uniform(-area / 2, area / 2), rng.uniform(0.6, area)
            mu = rng.uniform(*mu_range)
            if rng.uniform() < 0.5:
                m = add_circle(cfg, m, cx, cy, rng.uniform(0.2, 0.5), mu)
            else:
                m = add_box(cfg, m, cx, cy, rng.uniform(0.3, 0.8),
                            rng.uniform(0.3, 0.8), mu)
        maps[b] = m
    return Terrain(mu_map=jnp.asarray(maps, dtype), extent=cfg.terrain_extent,
                   res=cfg.terrain_res)
