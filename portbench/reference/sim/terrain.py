"""Terrain: friction-coefficient maps + height fields.

Port of apf_quadruped_tpu/sim/terrain.py.  A terrain is a (res x res) mu
grid over [-extent, extent]^2, optionally with a height grid sampled
bilinearly (normals from the bilinear gradient).  In the port the grids
carry the scenario axis in front, (B, res, res), and a sample at world
points xy (B, .., 2) looks each lane up in its own grid; grids without a
batch axis serve points of any shape.  The world builders are numpy, as
in the JAX module, and give the same arrays.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import SimConfig


class Terrain(NamedTuple):
    """mu_map: (.., res, res) friction grid over [-extent, extent]^2.
    h_map: optional (.., res, res) ground-height grid (None = flat ground
    at z = 0)."""

    mu_map: torch.Tensor
    extent: float
    res: int
    h_map: Optional[torch.Tensor] = None


def _lookup(grid: torch.Tensor, iy: torch.Tensor,
            ix: torch.Tensor) -> torch.Tensor:
    """grid (G.., res, res) at integer cells (G.., ..) -> (G.., ..)."""
    res = grid.shape[-1]
    gb = grid.shape[:-2]
    flat = grid.reshape(gb + (res * res,))
    idx = (iy * res + ix).reshape(gb + (-1,))
    return torch.gather(flat, -1, idx).reshape(iy.shape)


def _tensor(v, dtype, device, batch=()):
    t = torch.as_tensor(np.asarray(v), dtype=dtype, device=device)
    return t.expand(batch + t.shape).contiguous() if batch else t


def flat(cfg: SimConfig, mu: float | None = None, batch=(),
         dtype=torch.float32, device=None) -> Terrain:
    m = cfg.mu_default if mu is None else mu
    return Terrain(mu_map=torch.full(batch + (cfg.terrain_res,
                                              cfg.terrain_res), m,
                                     dtype=dtype, device=device),
                   extent=cfg.terrain_extent, res=cfg.terrain_res)


def sample_mu(t: Terrain, xy: torch.Tensor) -> torch.Tensor:
    """mu at world xy (.., 2) by nearest-cell lookup."""
    scale = t.res / (2.0 * t.extent)
    ij = torch.clamp((xy + t.extent) * scale, 0, t.res - 1).to(torch.int64)
    return _lookup(t.mu_map, ij[..., 1], ij[..., 0])


def _bilinear(grid: torch.Tensor, xy: torch.Tensor, extent: float, res: int):
    """Bilinear sample of grid at world xy (.., 2): (value, d/dx, d/dy).
    Cell centers sit at (i + 0.5) / res * 2 extent - extent."""
    scale = res / (2.0 * extent)
    u = torch.clamp((xy + extent) * scale - 0.5, 0.0, res - 1.000001)
    i0 = torch.floor(u).to(torch.int64)
    f = u - i0
    i1 = torch.clamp(i0 + 1, max=res - 1)
    ix0, iy0, ix1, iy1 = i0[..., 0], i0[..., 1], i1[..., 0], i1[..., 1]
    fx, fy = f[..., 0], f[..., 1]
    g00 = _lookup(grid, iy0, ix0)
    g10 = _lookup(grid, iy0, ix1)
    g01 = _lookup(grid, iy1, ix0)
    g11 = _lookup(grid, iy1, ix1)
    v0 = g00 * (1 - fx) + g10 * fx
    v1 = g01 * (1 - fx) + g11 * fx
    val = v0 * (1 - fy) + v1 * fy
    ddx = ((g10 - g00) * (1 - fy) + (g11 - g01) * fy) * scale
    ddy = (v1 - v0) * scale
    return val, ddx, ddy


def sample_height(t: Terrain, xy: torch.Tensor) -> torch.Tensor:
    """Ground height at world xy (.., 2); 0 on flat terrains."""
    if t.h_map is None:
        return torch.zeros(xy.shape[:-1], dtype=xy.dtype, device=xy.device)
    return _bilinear(t.h_map, xy, t.extent, t.res)[0]


def sample_normal(t: Terrain, xy: torch.Tensor) -> torch.Tensor:
    """Unit surface normal at world xy: n ~ (-dh/dx, -dh/dy, 1)."""
    if t.h_map is None:
        n = torch.zeros(xy.shape[:-1] + (3,), dtype=xy.dtype,
                        device=xy.device)
        n[..., 2] = 1.0
        return n
    _, ddx, ddy = _bilinear(t.h_map, xy, t.extent, t.res)
    n = torch.stack([-ddx, -ddy, torch.ones_like(ddx)], dim=-1)
    return n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)


def basis_from_normal(n: torch.Tensor) -> torch.Tensor:
    """(.., 3, 3) rotation C with COLUMNS (t1, t2, n): f_world = C f_local;
    t1 is world x projected onto the tangent plane.  C = I for n = z."""
    ex = torch.zeros_like(n)
    ex[..., 0] = 1.0
    t1 = ex - (ex * n).sum(dim=-1, keepdim=True) * n
    t1 = t1 / torch.linalg.vector_norm(t1, dim=-1, keepdim=True)
    t2 = torch.linalg.cross(n, t1)
    return torch.stack([t1, t2, n], dim=-1)


def cone_basis(t: Terrain, xy: torch.Tensor) -> torch.Tensor:
    """(.., 3, 3) terrain-aligned friction-cone basis at world xy."""
    return basis_from_normal(sample_normal(t, xy))


# --- numpy world builders -------------------------------------------------

def _grid(cfg: SimConfig):
    xs = (np.arange(cfg.terrain_res) + 0.5) / cfg.terrain_res
    xs = xs * 2 * cfg.terrain_extent - cfg.terrain_extent
    return np.meshgrid(xs, xs)             # X (res,res), Y (res,res)


def add_circle(cfg: SimConfig, mu_map: np.ndarray, cx, cy, r, mu) -> np.ndarray:
    X, Y = _grid(cfg)
    out = mu_map.copy()
    out[..., (X - cx) ** 2 + (Y - cy) ** 2 <= r * r] = mu
    return out


def add_box(cfg: SimConfig, mu_map: np.ndarray, cx, cy, lx, ly, mu) -> np.ndarray:
    X, Y = _grid(cfg)
    out = mu_map.copy()
    out[..., (np.abs(X - cx) <= lx / 2) & (np.abs(Y - cy) <= ly / 2)] = mu
    return out


def case_world(cfg: SimConfig, case: int, batch=(), dtype=torch.float32,
               device=None) -> Terrain:
    """The reference case-study friction layouts (case1..4 worlds and
    nav_case1a as case 5), as in the JAX module."""
    m = np.full((cfg.terrain_res, cfg.terrain_res), cfg.mu_default)
    if case == 1:
        for cx, cy in [(-0.4, 1.0), (0.45, 1.8), (-0.3, 2.6), (0.5, 3.4),
                       (0.0, 4.2)]:
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
        m = add_circle(cfg, m, 0.3, 1.7, 0.45, 0.8)
        m = add_circle(cfg, m, 0.0, 3.6, 0.45, 0.5)
        m = add_circle(cfg, m, 0.0, 5.7, 0.45, 0.2)
    return Terrain(mu_map=_tensor(m, dtype, device, batch),
                   extent=cfg.terrain_extent, res=cfg.terrain_res)


# --- the towr example height maps (fwd = our +y, lat = our x) -------------

def _height_world(cfg: SimConfig, fn, batch=(), dtype=torch.float32,
                  device=None, mu: float | None = None) -> Terrain:
    X, Y = _grid(cfg)
    h = fn(Y, X)
    m = np.full_like(h, cfg.mu_default if mu is None else mu)
    return Terrain(mu_map=_tensor(m, dtype, device, batch),
                   extent=cfg.terrain_extent, res=cfg.terrain_res,
                   h_map=_tensor(h, dtype, device, batch))


def block(cfg: SimConfig, **kw) -> Terrain:
    """One step up (towr Block: start 0.7, length 3.5, height 0.5, 0.03 m
    edge ramp)."""
    start, length, height, eps = 0.7, 3.5, 0.5, 0.03
    return _height_world(cfg, lambda f, l: height * np.clip(
        (f - start) / eps, 0.0, 1.0) * (f <= start + length), **kw)


def stairs(cfg: SimConfig, **kw) -> Terrain:
    """Two steps (towr Stairs: first at 1.0, width 0.4, heights 0.2 and
    0.4, top width 1.0)."""
    s1, w1, h1, h2, wtop = 1.0, 0.4, 0.2, 0.4, 1.0

    def fn(f, l):
        h = np.where(f >= s1, h1, np.zeros_like(f))
        h = np.where(f >= s1 + w1, h2, h)
        return np.where(f >= s1 + w1 + wtop, 0.0, h)

    return _height_world(cfg, fn, **kw)


def gap(cfg: SimConfig, **kw) -> Terrain:
    """Parabolic gap (towr Gap: start 1.0, width 0.5, depth 1.5)."""
    start, w, depth = 1.0, 0.5, 1.5
    xc = start + w / 2.0
    a = 4.0 * depth / (w * w)
    b = -8.0 * depth * xc / (w * w)
    c = -depth * (w - 2 * xc) * (w + 2 * xc) / (w * w)
    return _height_world(cfg, lambda f, l: np.where(
        (f > start) & (f < start + w), a * f * f + b * f + c, 0.0), **kw)


def slope(cfg: SimConfig, **kw) -> Terrain:
    """Up-then-down ramp (towr Slope: start 1.0, up 1.0 m to 0.7, down
    1.0 m)."""
    start, up_len, down_len, hc = 1.0, 1.0, 1.0, 0.7

    def fn(f, l):
        h = np.clip((f - start) * (hc / up_len), 0.0, hc)
        down = f - (start + up_len)
        return np.where(down > 0, np.maximum(hc - down * (hc / down_len),
                                             0.0), h)

    return _height_world(cfg, fn, **kw)


def chimney(cfg: SimConfig, **kw) -> Terrain:
    """Tilted side-wall corridor (towr Chimney: 1.0 to 2.5, slope 3.0 from
    lateral 0.5)."""
    start, length, y_start, grade = 1.0, 1.5, 0.5, 3.0
    return _height_world(cfg, lambda f, l: np.where(
        (f > start) & (f < start + length),
        np.maximum(0.0, grade * (l - y_start)), 0.0), **kw)


def chimney_lr(cfg: SimConfig, **kw) -> Terrain:
    """Two-walled chimney (towr ChimneyLR: left wall over the first
    length, right wall over the second; slope 2, lateral 0.5)."""
    start, length, y_start, grade = 0.5, 1.0, 0.5, 2.0

    def fn(f, l):
        seg1 = (f > start) & (f <= start + length)
        seg2 = (f > start + length) & (f <= start + 2 * length)
        return (np.where(seg1, np.maximum(0.0, grade * (l - y_start)), 0.0)
                + np.where(seg2, np.maximum(0.0, grade * (-l - y_start)),
                           0.0))

    return _height_world(cfg, fn, **kw)


HEIGHT_WORLDS = {"block": block, "stairs": stairs, "gap": gap,
                 "slope": slope, "chimney": chimney, "chimney_lr": chimney_lr}


def random_patches(cfg: SimConfig, rng: np.random.Generator, n_patches=5,
                   mu_range=(0.15, 0.5), area=3.5, batch=1,
                   dtype=torch.float32, device=None) -> Terrain:
    """Batched random slippery-patch worlds for scenario sweeps; draws from
    `rng` in the JAX module's order, so a seed gives the same maps."""
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
    return Terrain(mu_map=_tensor(maps, dtype, device),
                   extent=cfg.terrain_extent, res=cfg.terrain_res)
