"""A cell at a size the CPU tests can hold: the shipped configuration with
smaller point budgets, arena, camera and visual map, and its traffic with
fewer points per sweep and no set-up lap.

`ROOM` is held out of BENCHMARK.json (PERF.md, Open questions: the
program's float32 LIO cannot be held to the reference there); the tests
still drive it, through the files it keeps under livobench/, for the VIO
half of the check."""

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
    "kitti_lio_f64": {"lio.max_points": 1024, "map.capacity": 16384, "imu.imu_int_frame": 32},
    "avia_lio_f64": {"lio.max_points": 1024, "map.capacity": 16384, "imu.imu_int_frame": 32},
}
POINTS = {"avia_livo": 3000, "kitti_lio_f64": 6000, "avia_lio_f64": 3000}
ROOM = "avia_livo.handheld_room"
STREET = "kitti_lio_f64.urban_drive"
ROOM_LIO = "avia_lio_f64.handheld_room"
HELD_OUT = {
    ROOM: ({"name": ROOM, "config": "avia_livo", "traffic": "handheld_room", "chips": 1},
           {"name": "avia_livo", "file": "livobench/configs/avia_livo.json"}),
}


def cell(name: str) -> harness.Cell:
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    if name in HELD_OUT:
        work, conf = HELD_OUT[name]
        bench["workloads"] = bench["workloads"] + [work]
        bench["configs"] = bench["configs"] + [conf]
    return harness.Cell(bench, name)


def small_traffic(c: harness.Cell) -> dict:
    tr = copy.deepcopy(c.traffic)
    tr["lidar"]["points_per_sweep"] = POINTS[c.workload["config"]]
    tr["trajectory"]["setup_laps"] = 0
    return tr


def run_small(name: str, seed: int = 2147483659, seconds: float = 2.0, trace: bool = False):
    """(result, check lines) of one CPU run of the cell at the small size."""
    c = cell(name)
    return harness.run_cell(
        c, seed, seconds, trace, "cpu", time.perf_counter(),
        overrides=SMALL[c.workload["config"]], traffic=small_traffic(c),
    )
