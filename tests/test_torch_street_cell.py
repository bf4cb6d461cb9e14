"""The KITTI car's cell, `kitti_lio_hdl64.urban_drive`, on the CPU at a small
size (6,000 points a sweep, a 1 s speed ramp), and the counts its per-layer
metrics read:

- with budgets that hold the sweep the cell ends `correct` against the
  reference, the window builder's stride and the downsample drop nothing,
  no voxel is left unclaimed and the map grows; with budgets too small the
  counters hold exactly the stride's drop and the downsample's overflow,
  recounted from the builder's groups and the downsample's inputs;
- a LIO step's summary carries the insert's counts, equal to a recount
  from the map before and after the insert: points added, fresh voxels,
  and voxels left unclaimed, which an arena too small to claim every voxel
  leaves;
- each reader divides its counter by the LIO updates, and reads nothing
  where the program keeps no such counter.

Imports no jax: the card tests (`tests/test_torch_cuda.py`) run
`check_insert_counts` on the GPU.
"""

import copy
import time

import pytest
import torch

import chip_smoke
from fastlivo_tpu_torch.io.sync import WindowBuilder
from fastlivo_tpu_torch.maps import voxel_map as vm
from fastlivo_tpu_torch.models import pipeline as pl
from fastlivo_tpu_torch.ops import voxelize
from fastlivo_tpu_torch.state import NavState
from fastlivo_tpu_torch.utils import timing
from livobench import harness, program_counters

torch.set_num_threads(2)

CELL = "kitti_lio_hdl64.urban_drive"
SEED = 2147483659
POINTS = 6000  # points a sweep at the tests' size
# The tests' size: a smaller arena and IMU window. The unique-voxel table is
# set in the configuration's tree, as the configuration sets it: the
# reference has no such table and takes no override of it.
SMALL = {"map.capacity": 1 << 16, "imu.imu_int_frame": 32}
UNIQUE_CAP = 8192
HOLDS = 6144  # lio.max_points that holds a whole sweep: a window of 12,288 raw points, 6,144 voxels
TOO_SMALL = 2048  # a window of 4,096 raw points and 2,048 voxels, under the sweep's 6,000 and ~4,000
COUNTERS = ("io.build.points_dropped", "lio.downsample.voxels_dropped", "map.points_added", "map.fresh_voxels",
            "map.unclaimed_voxels")


def run_small(max_points: int, seconds: float = 1.5):
    """(result, the counters the run added) of one CPU run of the cell. The
    suite's conftest loads jax into every test process, so the harness's
    check that the run loaded none is not made here (livobench/tests holds
    the benchmark's isolation)."""
    c = harness.Cell(harness.load_json(harness.ROOT / "BENCHMARK.json"), CELL)
    c.config_file = copy.deepcopy(c.config_file)
    c.config_file["config"]["mapping"]["lookup_unique_cap"] = UNIQUE_CAP
    traffic = copy.deepcopy(c.traffic)
    traffic["lidar"]["points_per_sweep"] = POINTS
    traffic["trajectory"]["ramp_s"] = 1.0
    before = timing.counters()
    forbidden, harness.forbidden_modules = harness.forbidden_modules, list
    try:
        result, _ = harness.run_cell(c, SEED, seconds, False, "cpu", time.perf_counter(),
                                     overrides={"lio.max_points": max_points, **SMALL}, traffic=traffic)
    finally:
        harness.forbidden_modules = forbidden
    after = timing.counters()
    return result, {k: after.get(k, 0) - before.get(k, 0) for k in after}


@pytest.mark.parametrize("max_points", [HOLDS, TOO_SMALL], ids=["holds_the_sweep", "too_small"])
def test_the_counters_hold_what_the_budgets_drop(max_points, monkeypatch):
    strided, overflow = [], []  # per group built; per update's downsample
    build = WindowBuilder.build
    downsample = voxelize.voxel_downsample

    def counting_build(self, group):
        strided.append(max(len(group.lidar.pts) - self.n_pts, 0))
        return build(self, group)

    def counting_downsample(pts, mask, leaf, out_size, counted=False):
        if counted:  # an update's, not the warm-up's
            voxels = torch.unique(torch.floor(pts[mask] / leaf), dim=0).shape[0]
            overflow.append(max(voxels - out_size, 0))
        return downsample(pts, mask, leaf, out_size, counted)

    monkeypatch.setattr(WindowBuilder, "build", counting_build)
    monkeypatch.setattr(voxelize, "voxel_downsample", counting_downsample)
    result, added = run_small(max_points)
    updates = added["pipeline.lio_updates"]
    assert updates >= 5 and all(added[k] >= 0 for k in COUNTERS)
    assert added["io.build.points"] == POINTS * len(strided)
    assert added["io.build.points_dropped"] == sum(strided)
    assert len(overflow) == updates and added["lio.downsample.voxels_dropped"] == sum(overflow)
    if max_points == HOLDS:
        assert result["correct"], result["checks"]
        assert added["io.build.points_dropped"] == added["lio.downsample.voxels_dropped"] == 0
        assert added["map.unclaimed_voxels"] == 0
        assert added["map.fresh_voxels"] >= 100 * updates  # new street every scan
        assert added["map.points_added"] >= added["map.fresh_voxels"]
    else:
        assert added["io.build.points_dropped"] == len(strided) * (POINTS - 2 * TOO_SMALL)
        assert added["lio.downsample.voxels_dropped"] >= 100 * updates


def _keys(m: vm.VoxelHashMap) -> set:
    return set(map(tuple, m.keys[m.occupied].cpu().tolist()))


def check_insert_counts(device, capacity: int, n_raw: int = 8192):
    """One LIO step after a bootstrap on `chip_smoke.Scene`'s room, in an
    arena of `capacity` slots: the summary's insert counts equal the
    insert's own and a recount from the arena before and after it. Returns
    them (points added, fresh voxels, unclaimed voxels)."""
    scene = chip_smoke.Scene(n_raw, 8, seed=5)
    map_cfg = vm.VoxelMapConfig(resolution=0.5, capacity=capacity, max_points=32, lookup_unique_cap=n_raw // 2)
    cfg = pl.StepConfig(map_cfg=map_cfg, ds_capacity=n_raw // 2, imu_window=8)
    state = NavState(**{k: torch.as_tensor(v).to(device) for k, v in scene.initial_state().items()})
    i3, z3 = torch.eye(3, device=device), torch.zeros(3, device=device)
    lmap = pl.bootstrap_map(vm.make_map(map_cfg, device=device), chip_smoke.to_scan_input(scene.bootstrap_scan(), device),
                            state, i3, z3, cfg)
    calls = []
    insert = vm.insert

    def kept_insert(m, pts, mask, map_cfg, dedup=None, counted=False):
        out = insert(m, pts, mask, map_cfg, dedup, counted)
        calls.append((m, pts, mask, out))
        return out

    vm.insert = kept_insert
    try:
        _, m1, _, _, summary = pl.lio_scan_step(state, lmap, chip_smoke.to_scan_input(scene.lio_scan(1), device),
                                                i3, z3, cfg)
    finally:
        vm.insert = insert
    assert len(calls) == 1
    m0, pts, add, (m_out, counts) = calls[0]
    assert m_out is m1
    s = m0.slab.shape[1] // 3
    live = torch.arange(s, device=device)[None, :] < m1.counts[:, None]
    added = int((live & (m1.slot_stamps == int(m0.epoch))).sum())
    voxels = set(map(tuple, vm.voxel_coord(pts[add], map_cfg.resolution).cpu().tolist()))
    recount = (added, len(_keys(m1) - _keys(m0)), len(voxels - _keys(m1)))
    assert tuple(int(x) for x in counts) == recount
    assert tuple(int(x) for x in summary[12:15].tolist()) == recount
    assert summary.shape[0] == 11 + len(pl.SUMMARY_COUNTERS)
    return recount


@pytest.mark.parametrize("capacity", [1 << 14, 16], ids=["roomy_arena", "arena_too_small"])
def test_the_summary_carries_the_insert_counts(capacity):
    added, fresh, unclaimed = check_insert_counts("cpu", capacity)
    assert added > 0 and fresh > 0
    if capacity == 16:  # two buckets of eight slots for thousands of new voxels
        assert unclaimed > 0 and fresh <= capacity
    else:
        assert unclaimed == 0


READERS = {
    "sweep_points_dropped_per_scan": "io.build.points_dropped",
    "ds_voxels_dropped_per_scan": "lio.downsample.voxels_dropped",
    "map_fresh_voxels_per_scan": "map.fresh_voxels",
    "map_claim_rounds_per_scan": "map.claim_rounds",
    "map_unclaimed_voxels_per_scan": "map.unclaimed_voxels",
}


@pytest.mark.parametrize("metric", sorted(READERS))
def test_each_reader_divides_its_counter_by_the_lio_updates(metric, monkeypatch):
    counters = {"pipeline.lio_updates": 8, READERS[metric] + "_other": 1000}  # names match whole
    monkeypatch.setattr(program_counters, "snapshot", lambda: dict(counters))
    assert harness.reader(metric)({}) is None  # a program without the counter: nothing to read
    counters[READERS[metric]] = 20
    assert harness.reader(metric)({}) == 2.5
    counters["pipeline.lio_updates"] = 0
    assert harness.reader(metric)({}) is None
