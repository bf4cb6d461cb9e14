"""The configuration's values as the reference reads them.

A configuration file (`livobench/configs/<name>.json`) holds the shipped
YAML's tree; every value it does not name is the configuration's default,
listed here. `read(tree, overrides)` returns them as `section.field`
namespaces; the dotted overrides are for the CPU tests' small sizes.

Only what the reference implements is read: `lio.measurement_model` is
kept, and `reference/lio.py` implements the models in its `MODELS` (one:
`point_to_plane`) and refuses the others. Sections the reference has no
part of (`std`, `gnss`, `lightglue`) are not read here: a configuration
that turns them on names a check that holds them (`livobench/check.py`,
`mechanisms`), or the run stops.
"""

from __future__ import annotations

import copy
from types import SimpleNamespace

DEFAULTS = {
    "preprocess": {"point_filter_num": 2, "blind": 0.1, "max_range": 100.0},
    "extrinsics": {"extrinsic_t": (0.04165, 0.02326, -0.0284), "extrinsic_r": (1, 0, 0, 0, 1, 0, 0, 0, 1)},
    "camera": {"width": 640, "height": 512, "fx": 431.8, "fy": 431.7, "cx": 319.5, "cy": 255.5,
               "d0": 0.0, "d1": 0.0, "d2": 0.0, "d3": 0.0, "d4": 0.0,
               "rcl": (1, 0, 0, 0, 1, 0, 0, 0, 1), "pcl": (0.0, 0.0, 0.0)},
    "imu": {"cov_gyr": 0.01, "cov_acc": 0.01, "cov_bias_gyr": 1e-4, "cov_bias_acc": 1e-4,
            "init_count": 50, "zero_velocity_thresh": 0.1, "imu_int_frame": 128,
            "acc_scale_factor": 1.0, "axis_remap": (1, 0, 0, 0, 1, 0, 0, 0, 1)},
    "map": {"resolution": 0.5, "capacity": 1 << 19, "max_points_per_voxel": 32, "nearby_type": 18,
            "num_match_points": 5},
    "lio": {"max_iteration": 10, "filter_size_surf": 0.15, "filter_size_map": 0.3,
            "laser_point_cov": 0.00015, "plane_threshold": 0.1, "residual_limit": 2.0,
            "converge_rot_deg": 0.01, "converge_trans_cm": 0.015, "max_points": 16384,
            "measurement_model": "point_to_plane", "init_time": 0.5, "max_jump_m": 1.0,
            "max_search_dist2": 25.0, "scan_batch": 1},
    "vio": {"img_enable": True, "grid_size": 40, "patch_size": 8, "outlier_threshold": 300.0,
            "ncc_en": False, "img_point_cov": 100.0, "pyr_levels": 3, "max_iterations": 10,
            "max_visual_points": 40960, "max_obs_per_point": 8, "exposure_en": True,
            "delta_time": 0.0, "depth_continuous_thresh": 1.5, "border_px": 40,
            "converge_rot_deg": 0.001, "converge_trans_cm": 0.001, "stored_patch": 12,
            "stored_levels": 3},
}

# Top-level YAML keys -> (section, field).
FLAT = {
    "point_filter_num": ("preprocess", "point_filter_num"),
    "max_iteration": ("lio", "max_iteration"),
    "filter_size_surf": ("lio", "filter_size_surf"),
    "filter_size_map": ("lio", "filter_size_map"),
    "laser_point_cov": ("lio", "laser_point_cov"),
    "grid_size": ("vio", "grid_size"),
    "patch_size": ("vio", "patch_size"),
    "img_enable": ("vio", "img_enable"),
    "outlier_threshold": ("vio", "outlier_threshold"),
    "ncc_en": ("vio", "ncc_en"),
    "img_point_cov": ("vio", "img_point_cov"),
    "delta_time": ("vio", "delta_time"),
}
NESTED = {"preprocess": "preprocess", "camera": "camera", "imu": "imu"}
MAPPING = {"extrinsic_T": ("extrinsics", "extrinsic_t"), "extrinsic_R": ("extrinsics", "extrinsic_r")}


def _set(values: dict, section: str, name: str, value):
    if name not in values[section]:
        return
    old = values[section][name]
    if isinstance(old, bool):
        value = bool(value)
    elif isinstance(old, float) and isinstance(value, (int, float)):
        value = float(value)
    elif isinstance(old, int) and isinstance(value, (int, float)):
        value = int(value)
    elif isinstance(value, list):
        value = tuple(value)
    values[section][name] = value


def read(tree: dict, overrides: dict | None = None) -> SimpleNamespace:
    values = copy.deepcopy(DEFAULTS)
    for key, value in tree.items():
        if key in FLAT:
            _set(values, *FLAT[key], value)
        elif key == "mapping":
            for k2, v2 in value.items():
                if k2 in MAPPING:
                    _set(values, *MAPPING[k2], v2)
                else:
                    for section in ("lio", "map", "imu"):
                        _set(values, section, k2, v2)
        elif key in NESTED and isinstance(value, dict):
            for k2, v2 in value.items():
                _set(values, NESTED[key], k2.lower() if key == "camera" else k2, v2)
    for dotted, value in (overrides or {}).items():
        section, name = dotted.split(".", 1)
        if name not in values[section]:
            raise KeyError(f"no parameter {dotted}")
        _set(values, section, name, value)
    return SimpleNamespace(**{k: SimpleNamespace(**v) for k, v in values.items()})
