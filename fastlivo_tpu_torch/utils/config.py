"""Runtime configuration tree (a copy of fastlivo_tpu/utils/config.py) and
the reader for the YAML files under configs/.

Field names mirror the reference YAML keys, so reference-format configs
load directly. The YAML is read by `read_yaml`, which parses the subset
those files use — comments, scalars, one level of namespaces and flow
lists that may span several lines — with PyYAML's scalar rules (YAML 1.1
booleans; a float needs a dot). It needs no YAML package, and it rejects
any other construct instead of guessing.
"""

from __future__ import annotations

import dataclasses
import math
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


@dataclass
class LidarParams:
    lidar_type: int = 1  # 1 Avia, 2 Velodyne16, 3 Ouster64, 4 XT32
    scan_line: int = 6
    blind: float = 0.1  # min range (m)
    max_range: float = 100.0
    point_filter_num: int = 2  # keep every Nth point
    feature_extract_en: bool = False
    normal_extract_en: bool = False


@dataclass
class ImuParams:
    cov_gyr: float = 0.01
    cov_acc: float = 0.01
    cov_bias_gyr: float = 1e-4
    cov_bias_acc: float = 1e-4
    init_count: int = 50  # samples for static init
    zero_velocity_thresh: float = 0.1  # accel-norm std gate for static detection
    imu_int_frame: int = 128  # max IMU samples per measurement window (static shape)
    acc_scale_factor: float = 1.0
    axis_remap: Tuple[float, ...] = (1, 0, 0, 0, 1, 0, 0, 0, 1)


@dataclass
class MapParams:
    resolution: float = 0.5  # voxel side (m)
    capacity: int = 1 << 19  # number of voxel slots
    max_points_per_voxel: int = 32
    nearby_type: int = 18  # 0 | 6 | 18 | 26 neighbor voxels for kNN
    num_match_points: int = 5  # kNN for the plane fit
    probe_depth: int = 8
    surfel_decay: float = 0.9
    surfel_freeze_n: float = 0.0
    lookup_unique_cap: int = 16384


@dataclass
class LioParams:
    max_iteration: int = 10
    filter_size_surf: float = 0.15  # scan downsample leaf (m)
    filter_size_map: float = 0.3  # map insert gate leaf (m)
    laser_point_cov: float = 0.00015
    plane_threshold: float = 0.1
    residual_limit: float = 2.0
    converge_rot_deg: float = 0.01
    converge_trans_cm: float = 0.015
    max_points: int = 16384  # static per-scan downsampled point budget
    cube_len: float = 2000.0
    measurement_model: str = "point_to_plane"  # | "vgicp" | "surfel"
    vgicp_source_cov: float = 0.01
    vgicp_source_mode: str = "neighborhood"  # | "isotropic"
    vgicp_source_k: int = 8
    surfel_min_points: float = 6.0
    surfel_planarity_max: float = 0.01
    surfel_conf_weight: bool = True
    init_time: float = 0.5  # EKF warm-up after the first scan (s)
    max_jump_m: float = 1.0  # update health gate
    min_effective: int = 50  # low-constraint diagnostics threshold
    scan_batch: int = 1


@dataclass
class VioParams:
    img_enable: bool = True
    lidar_enable: bool = True
    grid_size: int = 40
    patch_size: int = 8
    outlier_threshold: float = 300.0
    ncc_en: bool = False
    ncc_thre: float = 0.0
    img_point_cov: float = 100.0
    pyr_levels: int = 3
    max_iterations: int = 10
    max_visual_points: int = 40960
    max_obs_per_point: int = 8
    exp_time: float = 0.0
    exposure_en: bool = True
    delta_time: float = 0.0  # camera-IMU time offset
    max_grid_points: int = 1024
    depth_continuous_thresh: float = 1.5


@dataclass
class CameraParams:
    width: int = 640
    height: int = 512
    fx: float = 431.8
    fy: float = 431.7
    cx: float = 319.5
    cy: float = 255.5
    d0: float = 0.0  # radial-tangential distortion (k1, k2, p1, p2, k3)
    d1: float = 0.0
    d2: float = 0.0
    d3: float = 0.0
    d4: float = 0.0
    rcl: Tuple[float, ...] = (1, 0, 0, 0, 1, 0, 0, 0, 1)  # p_c = Rcl p_l + Pcl
    pcl: Tuple[float, ...] = (0.0, 0.0, 0.0)


@dataclass
class GnssParams:
    gnss_en: bool = False
    rtk_file: str = ""
    antenna_lever: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    outlier_gate_m: float = 2.0
    init_window: int = 20


@dataclass
class LoopParams:
    loop_en: bool = False
    sub_frame_num: int = 10
    ds_size: float = 0.25
    plane_detection_thre: float = 0.01
    plane_merge_normal_thre: float = 0.1
    voxel_size: float = 2.0
    voxel_init_num: int = 10
    proj_image_resolution: float = 0.5
    proj_dis_min: float = 0.0
    proj_dis_max: float = 2.0
    corner_thre: float = 10.0
    descriptor_near_num: int = 10
    descriptor_min_len: float = 2.0
    descriptor_max_len: float = 50.0
    non_max_suppression_radius: float = 2.0
    std_side_resolution: float = 0.2
    skip_near_num: int = 50
    candidate_num: int = 50
    rough_dis_threshold: float = 0.01
    vertex_diff_threshold: float = 0.5
    icp_threshold: float = 0.5
    normal_threshold: float = 0.2
    dis_threshold: float = 0.5
    visual_verify_en: bool = False
    match_ratio_thresh: float = 0.2
    background: bool = True
    pose_check_max_rot: float = 0.35


@dataclass
class KeyframeParams:
    trans_thresh_m: float = 1.0
    rot_thresh_rad: float = 0.2


@dataclass
class ExtrinsicParams:
    """LiDAR-IMU extrinsics."""

    extrinsic_t: Tuple[float, float, float] = (0.04165, 0.02326, -0.0284)
    extrinsic_r: Tuple[float, ...] = (1, 0, 0, 0, 1, 0, 0, 0, 1)


@dataclass
class RuntimeParams:
    dense_map_en: bool = False
    pcd_save_en: bool = False
    img_save_en: bool = False
    out_dir: str = "Log"
    profile: bool = False
    num_devices: int = 1
    dtype: str = "float32"


@dataclass
class ParallelParams:
    n_devices: int = 1
    map_sharded: bool = False
    n_hosts: int = 1


@dataclass
class FastLivoConfig:
    preprocess: LidarParams = field(default_factory=LidarParams)
    imu: ImuParams = field(default_factory=ImuParams)
    map: MapParams = field(default_factory=MapParams)
    lio: LioParams = field(default_factory=LioParams)
    vio: VioParams = field(default_factory=VioParams)
    camera: CameraParams = field(default_factory=CameraParams)
    gnss: GnssParams = field(default_factory=GnssParams)
    loop: LoopParams = field(default_factory=LoopParams)
    keyframe: KeyframeParams = field(default_factory=KeyframeParams)
    extrinsics: ExtrinsicParams = field(default_factory=ExtrinsicParams)
    runtime: RuntimeParams = field(default_factory=RuntimeParams)
    parallel: ParallelParams = field(default_factory=ParallelParams)


# Reference YAML keys (flat) -> config fields.
_REFERENCE_KEY_MAP = {
    "point_filter_num": ("preprocess", "point_filter_num"),
    "max_iteration": ("lio", "max_iteration"),
    "filter_size_surf": ("lio", "filter_size_surf"),
    "filter_size_map": ("lio", "filter_size_map"),
    "grid_size": ("vio", "grid_size"),
    "patch_size": ("vio", "patch_size"),
    "img_enable": ("vio", "img_enable"),
    "lidar_enable": ("vio", "lidar_enable"),
    "outlier_threshold": ("vio", "outlier_threshold"),
    "ncc_en": ("vio", "ncc_en"),
    "ncc_thre": ("vio", "ncc_thre"),
    "img_point_cov": ("vio", "img_point_cov"),
    "delta_time": ("vio", "delta_time"),
    "cube_side_length": ("lio", "cube_len"),
    "laser_point_cov": ("lio", "laser_point_cov"),
    "dense_map_enable": ("runtime", "dense_map_en"),
    "pcd_save_enable": ("runtime", "pcd_save_en"),
}

_NAMESPACE_MAP = {
    "preprocess": "preprocess",
    "mapping": None,  # handled specially below
    "camera": "camera",
    "gnss": "gnss",
    "std": "loop",
    "lightglue": "loop",
    "pcd_save": "runtime",
    "imu": "imu",
}


def _coerce(value: Any, target_type: Any) -> Any:
    if target_type is bool and isinstance(value, (int, float)):
        return bool(value)
    if target_type is float and isinstance(value, (int, float)):
        return float(value)
    if target_type is int and isinstance(value, (int, float)):
        return int(value)
    if isinstance(value, list):
        return tuple(value)
    return value


def _set_field(cfg: Any, name: str, value: Any) -> bool:
    for f in dataclasses.fields(cfg):
        if f.name == name:
            target = f.type if isinstance(f.type, type) else type(getattr(cfg, name))
            setattr(cfg, name, _coerce(value, target))
            return True
    return False


def apply_reference_yaml(cfg: FastLivoConfig, tree: Dict[str, Any]) -> FastLivoConfig:
    """Overlay a reference-format YAML dict (config/*.yaml keys) onto cfg."""
    for key, value in tree.items():
        if isinstance(value, dict):
            if key == "mapping":
                for k2, v2 in value.items():
                    if k2 == "extrinsic_T":
                        cfg.extrinsics.extrinsic_t = tuple(v2)
                    elif k2 == "extrinsic_R":
                        cfg.extrinsics.extrinsic_r = tuple(v2)
                    else:
                        for sub in (cfg.lio, cfg.map, cfg.imu):
                            if _set_field(sub, k2, v2):
                                break
                continue
            ns = _NAMESPACE_MAP.get(key)
            if ns is None:
                continue
            sub = getattr(cfg, ns)
            for k2, v2 in value.items():
                _set_field(sub, k2.lower() if key == "camera" else k2, v2)
        else:
            dest = _REFERENCE_KEY_MAP.get(key)
            if dest is not None:
                _set_field(getattr(cfg, dest[0]), dest[1], value)
    return cfg


def load_config(path: Optional[str] = None, overrides: Optional[Dict[str, Any]] = None) -> FastLivoConfig:
    """Build a config, optionally overlaying a reference-format YAML file and
    a flat `section.field` override dict."""
    cfg = FastLivoConfig()
    if path is not None:
        apply_reference_yaml(cfg, read_yaml(path))
    if overrides:
        for dotted, value in overrides.items():
            section, name = dotted.split(".", 1)
            _set_field(getattr(cfg, section), name, value)
    return cfg


# ---------------------------------------------------------------------------
# The YAML subset of configs/*.yaml.
# ---------------------------------------------------------------------------

_BOOL = {
    **dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"), True),
    **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"), False),
}
_NULL = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?$")
_INF = re.compile(r"[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)$")
_KEY = re.compile(r"[A-Za-z_][A-Za-z0-9_]*$")


def _scalar(tok: str, where: str) -> Any:
    if len(tok) >= 2 and tok[0] == tok[-1] and tok[0] in "\"'":
        body = tok[1:-1]
        if tok[0] in body or "\\" in body:
            raise ValueError(f"{where}: escapes in quoted scalars are not supported")
        return body
    if tok and tok[0] in "[]{}&*!|>%@`\"'":
        raise ValueError(f"{where}: unsupported YAML construct {tok!r}")
    if tok in _NULL:
        return None
    if tok in _BOOL:
        return _BOOL[tok]
    if _INT.match(tok):
        return int(tok.replace("_", ""))
    if _FLOAT.match(tok):
        return float(tok.replace("_", ""))
    if _INF.match(tok):
        return -math.inf if tok[0] == "-" else math.inf
    if _NAN.match(tok):
        return math.nan
    return tok


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "\"'":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _value(raw: str, where: str) -> Any:
    if not raw.startswith("["):
        return _scalar(raw, where)
    if not raw.endswith("]") or raw.count("[") != 1 or raw.count("]") != 1:
        raise ValueError(f"{where}: only flat flow lists are supported: {raw!r}")
    body = raw[1:-1].strip()
    if not body:
        return []
    items = [t.strip() for t in body.split(",")]
    if items[-1] == "":
        items.pop()
    return [_scalar(t, where) for t in items]


def _entries(text: str, name: str) -> List[Tuple[int, str, str, str]]:
    """(indent, key, raw value, location) per mapping entry, with comments
    stripped and flow lists joined across lines."""
    out = []
    lines = text.splitlines()
    i = 0
    while i < len(lines):
        where = f"{name}:{i + 1}"
        line = _strip_comment(lines[i])
        i += 1
        if not line.strip():
            continue
        if "\t" in line[: len(line) - len(line.lstrip())]:
            raise ValueError(f"{where}: tab indentation")
        indent = len(line) - len(line.lstrip(" "))
        key, sep, raw = line.strip().partition(":")
        if not sep or not _KEY.match(key) or (raw and not raw[0] == " "):
            raise ValueError(f"{where}: expected 'key: value', got {line.strip()!r}")
        raw = raw.strip()
        while raw.startswith("[") and raw.count("[") > raw.count("]"):
            if i >= len(lines):
                raise ValueError(f"{where}: unterminated flow list")
            raw += " " + _strip_comment(lines[i]).strip()
            i += 1
        out.append((indent, key, raw, where))
    return out


def parse_yaml(text: str, name: str = "<yaml>") -> Dict[str, Any]:
    """Parse the configs/*.yaml subset into the dict `yaml.safe_load` gives."""
    tree: Dict[str, Any] = {}
    ns: Optional[Dict[str, Any]] = None  # the namespace being filled
    ns_indent = 0
    open_key: Optional[str] = None  # top-level key with an empty value
    for indent, key, raw, where in _entries(text, name):
        if indent == 0:
            ns, open_key = None, None
            if raw:
                tree[key] = _value(raw, where)
            else:
                tree[key], open_key = None, key
            continue
        if ns is None:
            if open_key is None:
                raise ValueError(f"{where}: unexpected indentation")
            ns = tree[open_key] = {}
            ns_indent, open_key = indent, None
        elif indent != ns_indent:
            raise ValueError(f"{where}: only one level of namespaces is supported")
        ns[key] = _value(raw, where) if raw else None
    return tree


def read_yaml(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return parse_yaml(f.read(), path)
