"""Maps and queries that the kNN tests hold `maps.voxel_map.knn` to, on
any device (imports no jax, so the tests marked `cuda` use it too).

`tie_map` is the grid of tests/test_torch_plane_knn.py built by the port's
insert: points on a 0.125 m grid (exact in binary) in a 3 m block, each
point twice, so candidate distances tie exactly, within a slab and across
stencil offsets. `add_stale` then writes junk past each slab's count (the
points a voxel has dropped or never held): large values, NaN and inf, which
must never enter. `queries` puts grid corners (8-way ties), random points,
points on voxel boundaries, points in empty space and non-finite points
side by side.
"""

import numpy as np
import torch

from fastlivo_tpu_torch.maps import voxel_map as vm

GRID = 0.125


def map_cfg(nearby_type=18, max_points=32, resolution=0.5, capacity=1 << 12, **kw):
    return vm.VoxelMapConfig(resolution=resolution, capacity=capacity, max_points=max_points,
                             nearby_type=nearby_type, **kw)


def tie_points(seed=2):
    ax = np.arange(-1.5, 1.5, GRID, dtype=np.float64)
    g = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3) + 0.5 * GRID
    pts = np.concatenate([g, g])
    return pts[np.random.default_rng(seed).permutation(len(pts))]


def build(cfg, dtype, device, pts, chunks=8):
    """A map of `pts` (numpy), inserted in `chunks` batches."""
    m = vm.make_map(cfg, dtype, device=device)
    for chunk in np.array_split(pts, chunks):
        p = torch.as_tensor(chunk, dtype=dtype).to(device)
        m = vm.insert(m, p, torch.ones(len(chunk), dtype=torch.bool, device=device), cfg)
    return m


def add_stale(m, cfg, seed=5):
    """The map with junk in every slab entry at or past its voxel's count."""
    c, s = cfg.capacity, cfg.max_points
    rng = np.random.default_rng(seed)
    junk = rng.uniform(-2.0, 2.0, (c, s, 3))
    junk[rng.random((c, s)) < 0.2] = np.nan
    junk[rng.random((c, s)) < 0.1] = np.inf
    junk = torch.as_tensor(junk, dtype=m.slab.dtype).to(m.slab.device)
    stale = torch.arange(s, device=m.counts.device)[None, :] >= m.counts[:, None]
    pts = torch.where(stale[..., None], junk, m.points)
    return m._replace(slab=pts.reshape(c, s * 3).contiguous())


def tie_map(cfg, dtype, device):
    return add_stale(build(cfg, dtype, device, tie_points()), cfg)


def queries(dtype, device, resolution=0.5, seed=3, n=300):
    """Grid corners, random points, exact voxel boundaries (multiples of
    the resolution in `dtype`), empty space, and NaN / inf rows."""
    rng = np.random.default_rng(seed)
    on_grid = rng.integers(-14, 14, (n, 3)) * GRID
    off_grid = rng.uniform(-1.6, 1.6, (n, 3))
    bounds = rng.integers(-4, 4, (n, 3)) * resolution
    empty = rng.uniform(4.0, 6.0, (40, 3))
    odd = np.array([[np.nan, 0.0, 0.0], [0.1, np.inf, 0.2], [-np.inf, -np.inf, -np.inf], [1e30, 0.0, 0.0]])
    q = np.concatenate([on_grid, off_grid, bounds, empty, odd])
    return torch.as_tensor(q, dtype=dtype).to(device)


def street(dtype, device, n_queries=65536, seed=7):
    """A street-sized arena (2^19 slots, 0.5 m voxels, 32 points each)
    holding a 200 x 30 m ground and two 10 m walls, and `n_queries` scan
    points near them, sorted by voxel as the downsample leaves them."""
    cfg = map_cfg(capacity=1 << 19, lookup_unique_cap=65536)
    rng = np.random.default_rng(seed)

    def surface(n):
        u = rng.random((n, 2))
        side = rng.integers(0, 3, n)
        x = u[:, 0] * 200.0 - 100.0
        ground = np.stack([x, u[:, 1] * 30.0 - 15.0, rng.normal(0.0, 0.03, n)], -1)
        wall = np.stack([x, np.where(side == 1, 15.0, -15.0) + rng.normal(0.0, 0.03, n), u[:, 1] * 10.0], -1)
        return np.where((side == 0)[:, None], ground, wall)

    m = build(cfg, dtype, device, surface(8 * 65536), chunks=8)
    q = surface(n_queries) + rng.normal(0.0, 0.05, (n_queries, 3))
    q = q[np.lexsort(np.floor(q / 0.15).T[::-1])]
    return m, cfg, torch.as_tensor(q, dtype=dtype).to(device)
