"""A cell at a size the CPU tests can hold: the shipped configuration with
smaller point budgets, arena, camera and visual map, and its traffic with
fewer points per sweep and no set-up lap (the street: a 1 s speed ramp)."""

from __future__ import annotations

import copy
import time

from livobench import harness

SMALL = {
    "avia_livo": {
        "lio.max_points": 1024, "map.capacity": 16384, "imu.imu_int_frame": 32,
        "camera.width": 160, "camera.height": 128, "camera.fx": 107.95, "camera.fy": 107.925,
        "camera.cx": 79.5, "camera.cy": 63.5, "vio.max_visual_points": 1024, "vio.grid_size": 20,
    },
    "kitti_lio_hdl64": {"lio.max_points": 6144, "map.capacity": 1 << 16, "imu.imu_int_frame": 32},
    "avia_lio_f64": {"lio.max_points": 1024, "map.capacity": 16384, "imu.imu_int_frame": 32},
}
# The street's table of unique voxels is set in its configuration's tree, as
# the configuration sets it: the reference has no such table to override.
TREE_MAPPING = {"kitti_lio_hdl64": {"lookup_unique_cap": 8192}}
POINTS = {"avia_livo": 3000, "kitti_lio_hdl64": 6000, "avia_lio_f64": 3000}
RAMP_S = {"kitti_lio_hdl64": 1.0}
ROOM = "avia_livo.handheld_room"
STREET = "kitti_lio_hdl64.urban_drive"
ROOM_LIO = "avia_lio_f64.handheld_room"


def cell(name: str) -> harness.Cell:
    c = harness.Cell(harness.load_json(harness.ROOT / "BENCHMARK.json"), name)
    c.config_file = copy.deepcopy(c.config_file)
    c.config_file["config"]["mapping"].update(TREE_MAPPING.get(c.workload["config"], {}))
    return c


def small_traffic(c: harness.Cell, config: str = None) -> dict:
    """The cell's traffic at the small size of `config` (the cell's own
    configuration by default)."""
    tr = copy.deepcopy(c.traffic)
    config = config or c.workload["config"]
    tr["lidar"]["points_per_sweep"] = POINTS[config]
    tr["trajectory"]["setup_laps"] = 0
    tr["trajectory"]["ramp_s"] = RAMP_S.get(config, tr["trajectory"]["ramp_s"])
    return tr


def run_small(name: str, seed: int = 2147483659, seconds: float = 2.0, trace: bool = False):
    """(result, check lines) of one CPU run of the cell at the small size."""
    c = cell(name)
    return harness.run_cell(
        c, seed, seconds, trace, "cpu", time.perf_counter(),
        overrides=SMALL[c.workload["config"]], traffic=small_traffic(c),
    )
