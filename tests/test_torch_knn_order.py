"""The order `maps.voxel_map.knn` keeps among equal distances, pinned on
the CPU: a rendering of the CUDA kernel's merge (csrc/voxel_knn.cu), one
candidate at a time, equals the plain op-by-op `knn` bit for bit.

The kernel walks the stencil offsets in order and, within an offset's
slab, the slots in order; a candidate enters the sorted best k only if its
distance is strictly below the k-th best, and goes in after every entry
with an equal distance. The plain path merges by a stable sort of (old
best, new candidates). The two agree on maps full of exact ties (the grid
of tests/knn_maps.py, each point twice, junk past every slab's count) for
both dtypes, k 5 and 8, every stencil and slabs of 8 and 32; a merge that
lets an equal distance in (`<=`) does not.
"""

import pytest
import torch

import knn_maps
from fastlivo_tpu_torch.maps import voxel_map as vm

torch.set_num_threads(1)


def register_knn(m, queries, cfg, k, max_dist2, strict=True):
    """The kernel's merge, rendered for all queries at once: each stencil
    offset, then each slab slot, inserted into the running sorted best k.
    `strict=False` is the mutant: equal distances enter, before the
    entries they equal."""
    n, s = queries.shape[0], cfg.max_points
    vox = vm.voxel_coord(queries, cfg.resolution)
    best_d2 = torch.full((n, k), torch.inf, dtype=queries.dtype)
    best_pts = torch.zeros((n, k, 3), dtype=queries.dtype)
    lane = torch.arange(k)[None, :]
    for off in vm.nearby_offsets(cfg.nearby_type):
        found, _ = vm.probe(m, vox + torch.tensor(off, dtype=torch.int32), cfg)
        slot = torch.clamp(found, min=0).long()
        cnt = torch.where(found >= 0, m.counts[slot], 0)
        rows = m.slab[slot].reshape(n, s, 3)
        for i in range(s):
            p = rows[:, i]
            d2 = torch.sum((p - queries) ** 2, dim=-1)  # the plain path's rounding
            if strict:
                enter = (i < cnt) & (d2 < best_d2[:, -1])
                pos = torch.sum(best_d2 <= d2[:, None], dim=1)
            else:
                enter = (i < cnt) & (d2 <= best_d2[:, -1])
                pos = torch.sum(best_d2 < d2[:, None], dim=1)
            up_d2 = torch.cat([best_d2[:, :1], best_d2[:, :-1]], dim=1)
            up_pts = torch.cat([best_pts[:, :1], best_pts[:, :-1]], dim=1)
            at, after = lane == pos[:, None], lane > pos[:, None]
            new_d2 = torch.where(at, d2[:, None], torch.where(after, up_d2, best_d2))
            new_pts = torch.where(at[..., None], p[:, None, :], torch.where(after[..., None], up_pts, best_pts))
            best_d2 = torch.where(enter[:, None], new_d2, best_d2)
            best_pts = torch.where(enter[:, None, None], new_pts, best_pts)
    return best_pts, best_d2, best_d2 <= max_dist2


def _same(got, want):
    """Bit for bit, NaN and inf included."""
    return all(torch.equal(a.view(torch.uint8), b.view(torch.uint8)) for a, b in zip(got, want))


@pytest.fixture(scope="module")
def tie_maps():
    return {
        (dtype, s): knn_maps.tie_map(knn_maps.map_cfg(max_points=s), dtype, "cpu")
        for dtype in (torch.float32, torch.float64) for s in (8, 32)
    }


@pytest.mark.parametrize("max_points", [8, 32])
@pytest.mark.parametrize("nearby_type", [0, 6, 18, 26])
@pytest.mark.parametrize("k,max_dist2", [(5, 25.0), (8, 0.05)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_register_merge_equals_plain_knn(tie_maps, dtype, k, max_dist2, nearby_type, max_points):
    cfg = knn_maps.map_cfg(nearby_type=nearby_type, max_points=max_points)
    m = tie_maps[(dtype, max_points)]
    q = knn_maps.queries(dtype, "cpu")
    want = vm.knn(m, q, cfg, k, max_dist2)
    assert _same(register_knn(m, q, cfg, k, max_dist2), want)
    pts, d2, valid = want
    # The maps are adversarial: exact ties among the entries kept, finite
    # entries beyond max_dist2, and entries left at inf with zero points.
    assert (d2[:, 1:] == d2[:, :-1]).any()
    assert (torch.isfinite(d2) & ~valid).any() == (max_dist2 < 1.0)
    assert torch.isinf(d2).any() and not pts[torch.isinf(d2)].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_register_merge_on_an_empty_map(dtype):
    cfg = knn_maps.map_cfg()
    m = vm.make_map(cfg, dtype, device="cpu")
    q = knn_maps.queries(dtype, "cpu")
    want = vm.knn(m, q, cfg, 5, 25.0)
    assert _same(register_knn(m, q, cfg, 5, 25.0), want)
    assert torch.isinf(want[1]).all() and not want[0].any() and not want[2].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_a_merge_that_admits_equal_distances_fails(tie_maps, dtype):
    """Mutation check: the same rendering with `<=` for `<` (ties enter
    ahead of the entries they equal) gives other neighbors on the tie map."""
    cfg = knn_maps.map_cfg()
    m = tie_maps[(dtype, 32)]
    q = knn_maps.queries(dtype, "cpu")
    want = vm.knn(m, q, cfg, 5, 25.0)
    assert _same(register_knn(m, q, cfg, 5, 25.0), want)
    assert not _same(register_knn(m, q, cfg, 5, 25.0, strict=False), want)
