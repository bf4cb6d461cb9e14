"""The per-scan and per-frame programs of the single-device LIVO cycle and
the host pipeline that drives them (port of fastlivo_tpu/models/pipeline.py:
`StepConfig` with `from_config`, `lio_scan_step` with every measurement
model, `lio_scan_multi`, `vio_scan_step`, `bootstrap_map`, `step_summary`
and `LivoPipeline`).

The chain per scan is the JAX package's:

    IMU propagate -> undistort -> voxel downsample -> iterated ESKF
    -> health gate -> insert gate -> map insert

`LivoPipeline` also carries the back end: GNSS fusion (an (18,18)/(18,)
observation block per scan, linearized at the propagated prior), the STD
loop-closure back end with its pose graph and visual gate, loop-corrected
map re-anchoring (`reanchor_map`), the annotated-frame dump and the
deferred-fetch scan batching of `lio.scan_batch`. The multi-device
branches are a later slice (ROADMAP.md section 1, item 14); the pipeline
raises `NotImplementedError` for them.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from fastlivo_tpu_torch import device as _device
from fastlivo_tpu_torch.io import export
from fastlivo_tpu_torch.maps import visual_map as vmap_mod
from fastlivo_tpu_torch.maps import voxel_map as vm
from fastlivo_tpu_torch.models import imu as imu_mod
from fastlivo_tpu_torch.models import lio
from fastlivo_tpu_torch.models import vio as vio_mod
from fastlivo_tpu_torch.ops import so3, voxelize
from fastlivo_tpu_torch.ops.camera import Pinhole
from fastlivo_tpu_torch.state import NavState


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to fastlivo_tpu_torch yet (ROADMAP.md section 1, item {item})"
    )


_NO_MULTI_DEVICE = (
    "multi-device steps (axis_name, map_sharded) are not ported to "
    "fastlivo_tpu_torch yet (ROADMAP.md section 1, item 14)"
)


@dataclass(frozen=True)
class StepConfig:
    """All static shapes/params of the per-scan program (same fields and
    defaults as the JAX package)."""

    map_cfg: vm.VoxelMapConfig = field(default_factory=vm.VoxelMapConfig)
    lio_cfg: lio.LioConfig = field(default_factory=lio.LioConfig)
    ds_leaf: float = 0.15
    ds_capacity: int = 16384
    imu_window: int = 128
    cov_gyr: float = 0.01
    cov_acc: float = 0.01
    cov_bias_gyr: float = 1e-4
    cov_bias_acc: float = 1e-4
    cam: Optional[Pinhole] = None
    vio_cfg: vio_mod.VioConfig = field(default_factory=vio_mod.VioConfig)
    vm_cfg: vmap_mod.VisualMapConfig = field(default_factory=vmap_mod.VisualMapConfig)
    map_sharded: bool = False

    @staticmethod
    def from_config(cfg) -> "StepConfig":
        """From a `utils.config.FastLivoConfig`."""
        par = cfg.parallel
        return StepConfig(
            map_sharded=bool(par.n_devices > 1 and par.map_sharded),
            cam=Pinhole.from_config(cfg.camera) if cfg.vio.img_enable else None,
            vio_cfg=vio_mod.VioConfig(
                grid_size=cfg.vio.grid_size,
                patch_size=cfg.vio.patch_size,
                max_iterations=cfg.vio.max_iterations,
                outlier_threshold=cfg.vio.outlier_threshold,
                img_point_cov=cfg.vio.img_point_cov,
                depth_continuous_thresh=cfg.vio.depth_continuous_thresh,
                ncc_en=cfg.vio.ncc_en,
                ncc_thre=cfg.vio.ncc_thre,
                levels=cfg.vio.pyr_levels,
                exposure_en=cfg.vio.exposure_en,
            ),
            vm_cfg=vmap_mod.VisualMapConfig(
                capacity=cfg.vio.max_visual_points,
                max_obs=cfg.vio.max_obs_per_point,
                patch_size=cfg.vio.patch_size,
            ),
            map_cfg=vm.VoxelMapConfig(
                resolution=cfg.map.resolution,
                capacity=cfg.map.capacity,
                max_points=cfg.map.max_points_per_voxel,
                nearby_type=cfg.map.nearby_type,
                probe_depth=cfg.map.probe_depth,
                surfel_decay=cfg.map.surfel_decay,
                surfel_freeze_n=cfg.map.surfel_freeze_n,
                lookup_unique_cap=cfg.map.lookup_unique_cap,
            ),
            lio_cfg=lio.LioConfig(
                max_iteration=cfg.lio.max_iteration,
                num_match_points=cfg.map.num_match_points,
                laser_point_cov=cfg.lio.laser_point_cov,
                plane_threshold=cfg.lio.plane_threshold,
                residual_limit=cfg.lio.residual_limit,
                converge_rot_deg=cfg.lio.converge_rot_deg,
                converge_trans_cm=cfg.lio.converge_trans_cm,
                filter_size_map=cfg.lio.filter_size_map,
                measurement_model=cfg.lio.measurement_model,
                max_jump_m=cfg.lio.max_jump_m,
                min_effective=cfg.lio.min_effective,
                vgicp_source_cov=cfg.lio.vgicp_source_cov,
                vgicp_source_mode=cfg.lio.vgicp_source_mode,
                vgicp_source_k=cfg.lio.vgicp_source_k,
                surfel_min_points=cfg.lio.surfel_min_points,
                surfel_planarity_max=cfg.lio.surfel_planarity_max,
                surfel_conf_weight=cfg.lio.surfel_conf_weight,
            ),
            ds_leaf=cfg.lio.filter_size_surf,
            ds_capacity=cfg.lio.max_points,
            imu_window=cfg.imu.imu_int_frame,
            cov_gyr=cfg.imu.cov_gyr,
            cov_acc=cfg.imu.cov_acc,
            cov_bias_gyr=cfg.imu.cov_bias_gyr,
            cov_bias_acc=cfg.imu.cov_bias_acc,
        )


class ScanInput(NamedTuple):
    """One LiDAR measurement group (fixed shapes, padded)."""

    pts: torch.Tensor  # (N, 3) raw points, LiDAR frame
    t_offs: torch.Tensor  # (N,)
    mask: torch.Tensor  # (N,)
    imu: imu_mod.ImuWindow
    t_end: torch.Tensor  # ()
    acc_scale: torch.Tensor  # ()


def _maybe_dedup(pts_w, mask, map_cfg):
    """Unique-voxel dedup shared between the insert gate and the insert."""
    n = pts_w.shape[0]
    cap = min(map_cfg.lookup_unique_cap or n, n)
    return vm.unique_voxels(vm.voxel_coord(pts_w, map_cfg.resolution), mask, cap)


def _propagate(state, scan: ScanInput, cfg: StepConfig):
    return imu_mod.propagate(
        state, scan.imu, scan.t_end, scan.acc_scale,
        cfg.cov_gyr, cfg.cov_acc, cfg.cov_bias_gyr, cfg.cov_bias_acc,
    )


def lio_scan_step(
    state: NavState,
    lidar_map: vm.VoxelHashMap,
    scan: ScanInput,
    rot_il: torch.Tensor,
    t_il: torch.Tensor,
    cfg: StepConfig,
    extra_hth: Optional[torch.Tensor] = None,
    extra_hty: Optional[torch.Tensor] = None,
    axis_name: Optional[str] = None,
) -> Tuple[NavState, vm.VoxelHashMap, lio.LioInfo, Tuple[torch.Tensor, torch.Tensor], torch.Tensor]:
    """One full scan-end measurement update (one device).

    Returns (posterior state, updated map, LioInfo, (world_cloud,
    world_mask), packed summary — see `step_summary`). A rejected update
    (non-finite, or a correction above lio_cfg.max_jump_m) returns the
    propagated state and leaves the map untouched.
    """
    if axis_name is not None or cfg.map_sharded:
        raise NotImplementedError(_NO_MULTI_DEVICE)
    state_prop, poses = _propagate(state, scan, cfg)
    pts_und = imu_mod.undistort(
        scan.pts, scan.t_offs, scan.mask, poses, state_prop, rot_il, t_il
    )
    ds_pts, ds_mask = voxelize.voxel_downsample(pts_und, scan.mask, cfg.ds_leaf, cfg.ds_capacity)

    posterior, info, (nbr, nv) = lio.lio_update(
        state_prop, lidar_map, ds_pts, ds_mask, rot_il, t_il, cfg.map_cfg, cfg.lio_cfg,
        extra_hth=extra_hth, extra_hty=extra_hty,
    )

    jump = torch.linalg.vector_norm(posterior.pos - state_prop.pos)
    finite = torch.all(torch.isfinite(posterior.pos)) & torch.all(torch.isfinite(posterior.cov))
    accept = finite & (jump <= cfg.lio_cfg.max_jump_m)
    posterior = NavState(*(torch.where(accept, a, b) for a, b in zip(posterior, state_prop)))

    _, p_w = lio.transform_to_world(ds_pts, posterior.rot, posterior.pos, rot_il, t_il)
    ds_mask = ds_mask & accept
    p_w = torch.where(torch.isfinite(p_w), p_w, 0.0)
    if cfg.lio_cfg.measurement_model == "surfel":
        # No kNN cache: gate on the point's own voxel slab.
        dd = _maybe_dedup(p_w, ds_mask, cfg.map_cfg)
        add = vm.slab_insert_gate(
            lidar_map, p_w, ds_mask, cfg.map_cfg,
            cfg.lio_cfg.filter_size_map, cfg.lio_cfg.num_match_points, dedup=dd,
        )
        lidar_map = vm.insert(lidar_map, p_w, add, cfg.map_cfg, dedup=dd)
    else:
        add = lio.map_insert_gate(p_w, ds_mask, nbr, nv, cfg.lio_cfg.filter_size_map)
        lidar_map = vm.insert(lidar_map, p_w, add, cfg.map_cfg)

    summary = step_summary(posterior, info, jump, accept)
    return posterior, lidar_map, info, (p_w, ds_mask), summary


def lio_scan_multi(
    state: NavState,
    lidar_map: vm.VoxelHashMap,
    scans: ScanInput,
    rot_il: torch.Tensor,
    t_il: torch.Tensor,
    cfg: StepConfig,
    axis_name: Optional[str] = None,
) -> Tuple[NavState, vm.VoxelHashMap, torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """K scan-end measurement updates chained: `scans` is a ScanInput whose
    leaves carry a leading K axis. Returns (posterior state, map, summaries
    (K, 11), (world clouds (K, N, 3), masks (K, N))), the results of K
    sequential `lio_scan_step` calls."""
    summaries, clouds, masks = [], [], []
    for k in range(scans.pts.shape[0]):
        scan = ScanInput(
            pts=scans.pts[k], t_offs=scans.t_offs[k], mask=scans.mask[k],
            imu=imu_mod.ImuWindow(*(x[k] for x in scans.imu)),
            t_end=scans.t_end[k], acc_scale=scans.acc_scale[k],
        )
        state, lidar_map, _, (p_w, msk), summary = lio_scan_step(
            state, lidar_map, scan, rot_il, t_il, cfg, axis_name=axis_name
        )
        summaries.append(summary)
        clouds.append(p_w)
        masks.append(msk)
    return state, lidar_map, torch.stack(summaries), (torch.stack(clouds), torch.stack(masks))


def step_summary(state_out: NavState, info, jump: torch.Tensor, accept: torch.Tensor) -> torch.Tensor:
    """[pos(3), quat wxyz(4), n_eff, jump_m, accepted, res_mean]."""
    q = so3.rot_to_quat(state_out.rot)
    dtype = state_out.pos.dtype
    return torch.cat(
        [
            state_out.pos,
            q,
            torch.stack(
                [info.n_effective.to(dtype), jump, accept.to(dtype), info.res_mean]
            ),
        ]
    )


def vio_scan_step(
    state: NavState,
    visual_map: vmap_mod.VisualMap,
    scan: ScanInput,
    img: torch.Tensor,
    world_cloud: torch.Tensor,
    world_mask: torch.Tensor,
    rot_ci: torch.Tensor,
    t_ci: torch.Tensor,
    cfg: StepConfig,
) -> Tuple[NavState, vmap_mod.VisualMap, vio_mod.VioInfo, torch.Tensor]:
    """One image-bounded update: propagate to the image time, then the
    photometric iterated EKF against the last scan's world cloud. Returns
    (posterior, visual map, VioInfo, [pos(3), quat wxyz(4), n_selected])."""
    state_prop, _ = _propagate(state, scan, cfg)
    posterior, visual_map, info = vio_mod.vio_update(
        state_prop, visual_map, img, world_cloud, world_mask,
        cfg.cam, rot_ci, t_ci, cfg.vm_cfg, cfg.vio_cfg,
    )
    q = so3.rot_to_quat(posterior.rot)
    summary = torch.cat([posterior.pos, q, info.n_selected.to(posterior.pos.dtype)[None]])
    return posterior, visual_map, info, summary


def bootstrap_map(
    lidar_map: vm.VoxelHashMap,
    scan: ScanInput,
    state: NavState,
    rot_il: torch.Tensor,
    t_il: torch.Tensor,
    cfg: StepConfig,
    axis_name: Optional[str] = None,
) -> vm.VoxelHashMap:
    """First-scan map initialization: downsample and insert at the current
    pose, no filter update."""
    if axis_name is not None or cfg.map_sharded:
        raise NotImplementedError(_NO_MULTI_DEVICE)
    ds_pts, ds_mask = voxelize.voxel_downsample(scan.pts, scan.mask, cfg.ds_leaf, cfg.ds_capacity)
    _, p_w = lio.transform_to_world(ds_pts, state.rot, state.pos, rot_il, t_il)
    return vm.insert(lidar_map, p_w, ds_mask, cfg.map_cfg)


def scan_to_device(scan: ScanInput, device) -> ScanInput:
    """A ScanInput with NumPy (or tensor) leaves, on `device`."""

    def t(x):
        return torch.as_tensor(x).to(device)

    return ScanInput(
        pts=t(scan.pts), t_offs=t(scan.t_offs), mask=t(scan.mask),
        imu=imu_mod.ImuWindow(*(t(x) for x in scan.imu)),
        t_end=t(scan.t_end), acc_scale=t(scan.acc_scale),
    )


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class LivoPipeline:
    """Host-side orchestrator, one device: owns the device state and feeds
    the per-scan and per-frame programs the measurement groups of the
    synchronizer (`io.sync`), one group at a time.

    `device=None` means the GPU and raises without one. Every processed
    update leaves one small summary (pose, and the effective count or the
    selected-patch count), kept in `trajectory`, `n_effective` and
    `n_selected`. With `lio.scan_batch` 1 each summary is read back when
    its update runs. Otherwise (and without GNSS, whose observation needs
    each scan's prior on the host) the updates are dispatched without a
    read: their summaries go into one device buffer, read in one copy by
    `flush_scans` every `scan_batch` scans, or, with 0, only at `finish`,
    a checkpoint or `reanchor_map`."""

    def __init__(self, cfg, dtype=torch.float32, device=None):
        self.device = _device.resolve(device)
        if cfg.parallel.n_devices > 1 or cfg.parallel.map_sharded:
            raise _not_ported("multi-device execution (parallel.n_devices, parallel.map_sharded)", 14)
        self.cfg = cfg
        self.step_cfg = StepConfig.from_config(cfg)
        self.dtype = dtype
        dev = self.device

        rot = np.asarray(cfg.extrinsics.extrinsic_r, np.float32).reshape(3, 3)
        self.rot_il = torch.tensor(rot, dtype=dtype, device=dev)
        self.t_il = torch.tensor(cfg.extrinsics.extrinsic_t, dtype=dtype, device=dev)
        # Camera-IMU from camera-LiDAR and LiDAR-IMU: p_c = Rcl p_l + Pcl.
        rcl = np.asarray(cfg.camera.rcl, np.float32).reshape(3, 3)
        pcl = np.asarray(cfg.camera.pcl, np.float32)
        rot_ci = rcl @ rot.T
        self.rot_ci = torch.tensor(rot_ci, dtype=dtype, device=dev)
        self.t_ci = torch.tensor(
            pcl - rot_ci @ np.asarray(cfg.extrinsics.extrinsic_t, np.float32), dtype=dtype, device=dev
        )

        self.state = NavState.identity(dtype, dev)
        self.map = vm.make_map(self.step_cfg.map_cfg, dtype, dev)
        self.visual_map = vmap_mod.make_visual_map(self.step_cfg.vm_cfg, dtype, dev)
        self.initializer = imu_mod.StaticInitializer(
            init_count=cfg.imu.init_count, zero_velocity_thresh=cfg.imu.zero_velocity_thresh
        )
        self.first_scan = True
        self._first_scan_t: Optional[float] = None
        self._init_time = cfg.lio.init_time
        self.trajectory: list = []  # (t, pos, quat wxyz) per update, for TUM export
        self.n_effective: List[int] = []  # per LIO update
        self.n_selected: List[int] = []  # per VIO update
        # VIO updates before the first LIO update: they see no world cloud.
        self.vio_before_lio = 0
        self.health = {"rejected": 0, "low_constraint": 0, "resets": 0}
        self._min_effective = self.step_cfg.lio_cfg.min_effective
        # The last accepted scan's world cloud, for the next VIO frames.
        self.world_cloud = torch.zeros((self.step_cfg.ds_capacity, 3), dtype=dtype, device=dev)
        self.world_mask = torch.zeros((self.step_cfg.ds_capacity,), dtype=torch.bool, device=dev)
        # Insert epoch -> timestamp: every bootstrap and every scan step
        # inserts once (the arena epoch advances by one), so the list index
        # is the epoch; reanchor_map maps epochs to keyframe segments.
        self._epoch_stamps: List[float] = []
        self._last_vio_img: Optional[np.ndarray] = None  # for the loop gate
        self._img_frame_idx = 0

        # Loop closure + pose graph back end; detection runs on a worker
        # thread unless loop.background is off, and finish() drains it.
        self.loop_backend = None
        if cfg.loop.loop_en:
            from fastlivo_tpu_torch.backend.loop_manager import LoopBackend

            self.loop_backend = LoopBackend(cfg, background=cfg.loop.background, device=dev)
        # GNSS fusion: observation blocks on the pipeline's device.
        self.gnss = None
        self.gnss_blocks = 0  # LIO updates that carried a GNSS block
        if cfg.gnss.gnss_en:
            from fastlivo_tpu_torch.models.gnss import GnssFusion

            self.gnss = GnssFusion(
                antlever=np.asarray(cfg.gnss.antenna_lever),
                outlier_gate_m=cfg.gnss.outlier_gate_m,
                init_window=cfg.gnss.init_window,
                device=dev,
            )
            if cfg.gnss.rtk_file:
                self.gnss.load_rtk_file(cfg.gnss.rtk_file)

        # Deferred-fetch batching. The pending queue holds, in dispatch
        # order, ("scan", t_abs, cloud, mask, last_img) and ("img", t_abs);
        # row i of _sum_buf is entry i's summary (zero-padded to 11). When a
        # scan is rejected mid-batch, the VIO frames dispatched after it see
        # its masked-off world cloud (an empty photometric update) instead
        # of the host rollback to the last accepted cloud; both recover at
        # the next accepted scan. Clouds are kept for the loop back end only:
        # with scan_batch 0 a whole run's clouds would pin device memory.
        self.scan_batch = int(cfg.lio.scan_batch)
        self._batch_eligible = self.scan_batch != 1 and not cfg.gnss.gnss_en
        self._pending: list = []
        self._pending_n_scans = 0
        self._retain_clouds = self.loop_backend is not None
        self._sum_cap = 65536  # deferred measurements per flush (1.8 h at 10 Hz)
        self._batch_prev_cloud = None
        if self._batch_eligible:
            self._sum_buf = torch.zeros((self._sum_cap, 11), dtype=dtype, device=dev)

    def _init_feed(self, scan: ScanInput):
        mask = _host(scan.imu.mask)
        if self.initializer.push(_host(scan.imu.gyr)[mask], _host(scan.imu.acc)[mask]):
            self.state = self.initializer.initial_state(self.dtype, self.device)

    def _advance(self, scan: ScanInput):
        """Propagate through a group's IMU window without a measurement
        update: the window builder's clock moves on whether or not an
        update runs."""
        self.state, _ = imu_mod.propagate(self.state, scan.imu, scan.t_end, scan.acc_scale)

    def _record(self, t_abs: float, summary: torch.Tensor) -> np.ndarray:
        """One host read of a step summary; its pose joins the trajectory."""
        s = summary.cpu().numpy()
        self.trajectory.append((t_abs, s[0:3], s[3:7]))
        return s

    def process_scan(self, scan: ScanInput, t_abs: float):
        """Feed one scan-end measurement group. Returns LioInfo, or None
        during static initialization and the EKF warm-up."""
        if not self.initializer.done:
            self._init_feed(scan)
            return None
        scan = scan_to_device(scan, self.device)
        if self.first_scan:
            self._first_scan_t = t_abs
        # EKF warm-up: propagate and insert, no update, until init_time has
        # passed since the first scan.
        if self.first_scan or (
            self._first_scan_t is not None and t_abs - self._first_scan_t < self._init_time
        ):
            self._advance(scan)
            self.map = bootstrap_map(self.map, scan, self.state, self.rot_il, self.t_il, self.step_cfg)
            self._epoch_stamps.append(t_abs)
            self.first_scan = False
            return None

        if self._batch_eligible:
            # Dispatch now, read the summary at the next flush.
            if self._pending_n_scans == 0:
                # Rollback target if every scan of this batch is rejected.
                self._batch_prev_cloud = (self.world_cloud, self.world_mask)
            self.state, self.map, _, (self.world_cloud, self.world_mask), summary = lio_scan_step(
                self.state, self.map, scan, self.rot_il, self.t_il, self.step_cfg
            )
            self._epoch_stamps.append(t_abs)
            self._defer(summary)
            if self._retain_clouds:
                self._pending.append(("scan", t_abs, self.world_cloud, self.world_mask, self._last_vio_img))
            else:
                self._pending.append(("scan", t_abs, None, None, None))
            self._pending_n_scans += 1
            if len(self._pending) >= self._sum_cap or 0 < self.scan_batch <= self._pending_n_scans:
                self.flush_scans()
            return None

        prev_cloud = (self.world_cloud, self.world_mask)
        extra = None
        if self.gnss is not None:
            # The GNSS block is linearized at the propagated prior: one
            # extra propagate and one host read of (rot, pos) per scan.
            sp, _ = _propagate(self.state, scan, self.step_cfg)
            extra = self.gnss.observe(t_abs, _host(sp.rot), _host(sp.pos))
            self.gnss_blocks += extra is not None
        self.state, self.map, info, (self.world_cloud, self.world_mask), summary = lio_scan_step(
            self.state, self.map, scan, self.rot_il, self.t_il, self.step_cfg,
            extra_hth=None if extra is None else extra[0],
            extra_hty=None if extra is None else extra[1],
        )
        self._epoch_stamps.append(t_abs)
        s = self._record(t_abs, summary)
        n_eff, accepted = int(s[7]), bool(s[9] > 0.5)
        self.n_effective.append(n_eff)
        # The health gate ran on the device (a rejected update returned the
        # propagated state and left the map untouched); here the counters
        # and the world-cloud rollback to the last accepted scan.
        if n_eff < self._min_effective:
            self.health["low_constraint"] += 1
        if not accepted:
            self.health["rejected"] += 1
            self.health["resets"] += 1
            self.world_cloud, self.world_mask = prev_cloud
        if self.loop_backend is not None:
            # One device-to-host copy of the masked world cloud per scan.
            wc = self.world_cloud[self.world_mask].cpu().numpy()
            self.loop_backend.on_scan(
                _host(self.state.rot), s[0:3], wc, stamp=t_abs, img=self._last_vio_img,
            )
        return info

    def process_image(self, scan: ScanInput, img, t_abs: float):
        """Feed one image-bounded measurement group (VIO update at the image
        time). Returns VioInfo, or None before initialization."""
        if not self.initializer.done:
            # Image-bounded groups carry part of each sweep's IMU window;
            # the static initialization needs them too.
            self._init_feed(scan)
            return None
        scan = scan_to_device(scan, self.device)
        if self.step_cfg.cam is None or self.first_scan:
            self._advance(scan)
            return None
        self._last_vio_img = np.asarray(_host(img), dtype=np.float32)
        img = torch.tensor(self._last_vio_img, dtype=self.dtype, device=self.device)
        self.state, self.visual_map, info, summary = vio_scan_step(
            self.state, self.visual_map, scan, img, self.world_cloud, self.world_mask,
            self.rot_ci, self.t_ci, self.step_cfg,
        )
        if self.cfg.runtime.img_save_en:
            self._dump_annotated_frame(img)
        if self._batch_eligible:
            self.vio_before_lio += not (self.n_effective or self._pending_n_scans)
            self._defer(summary)
            self._pending.append(("img", t_abs))
            # Backstop for image-heavy streams; the scan count normally sets
            # the flush cadence.
            n = len(self._pending)
            if n >= self._sum_cap or (self.scan_batch > 0 and n >= 8 * self.scan_batch + 8):
                self.flush_scans()
            return None
        self.n_selected.append(int(self._record(t_abs, summary)[7]))
        self.vio_before_lio += not self.n_effective
        return info

    def _dump_annotated_frame(self, img: torch.Tensor):
        """Keypatch-annotated frame to <runtime.out_dir>/img/ (the
        reference's /rgb_img stream). Debug path: one candidate re-selection
        and one host read per frame."""
        from fastlivo_tpu_torch.io import annotate

        uv, valid, inlier = vio_mod.candidate_overlay(
            self.state, self.visual_map, img, self.world_cloud, self.world_mask,
            self.step_cfg.cam, self.rot_ci, self.t_ci, self.step_cfg.vm_cfg, self.step_cfg.vio_cfg,
        )
        annotate.save_annotated(
            self.cfg.runtime.out_dir, self._img_frame_idx, self._last_vio_img,
            _host(uv), _host(valid), _host(inlier),
        )
        self._img_frame_idx += 1

    def _defer(self, summary: torch.Tensor):
        """Queue the summary of the update about to join the pending queue
        (a device-side copy, no host read)."""
        self._sum_buf[len(self._pending), : summary.shape[0]] = summary

    def flush_scans(self):
        """Drain the pending (already dispatched) updates: one host read of
        their summaries, then the per-update bookkeeping in dispatch order
        (trajectory, counters, health, the loop back end on accepted scans,
        the world-cloud rollback)."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        self._pending_n_scans = 0
        # A copy: on the CPU, .cpu() would alias the buffer the next
        # batch overwrites.
        rows = self._sum_buf[: len(pending)].cpu().numpy().copy()
        last_ok = None
        for k, entry in enumerate(pending):
            kind, t_abs = entry[0], entry[1]
            s = rows[k]
            self.trajectory.append((t_abs, s[0:3], s[3:7]))
            if kind == "img":
                self.n_selected.append(int(s[7]))
                continue
            _, _, cloud, mask, img = entry
            n_eff, accepted = int(s[7]), bool(s[9] > 0.5)
            self.n_effective.append(n_eff)
            if n_eff < self._min_effective:
                self.health["low_constraint"] += 1
            if not accepted:
                self.health["rejected"] += 1
                self.health["resets"] += 1
                continue
            last_ok = k
            if cloud is not None:  # kept only for the loop back end
                rot = so3.quat_to_rot(torch.as_tensor(s[3:7], dtype=torch.float64)).numpy()
                self.loop_backend.on_scan(rot, s[0:3], cloud[mask].cpu().numpy(), stamp=t_abs, img=img)
        if not self._retain_clouds:
            # No clouds were kept; world_cloud already holds the last
            # dispatched scan's (empty-masked if it was rejected).
            return
        if last_ok is not None:
            self.world_cloud, self.world_mask = pending[last_ok][2:4]
        elif any(e[0] == "scan" for e in pending):
            self.world_cloud, self.world_mask = self._batch_prev_cloud

    def reanchor_map(self) -> bool:
        """Re-anchor the live voxel arena with the loop-corrected keyframe
        poses: every arena point moves by the rigid correction of the
        keyframe nearest in time to its insert epoch, and the arena is
        rebuilt by `vm.reanchor`. Returns True if a correction was applied."""
        if self.loop_backend is None or not self.loop_backend.loops:
            return False
        if not self._epoch_stamps:
            return False
        self.flush_scans()
        g = self.loop_backend.graph
        rots_c, trans_c = self.loop_backend.corrected_trajectory()
        rots_d = np.asarray(g.rots)
        trans_d = np.asarray(g.trans)
        kf_stamps = np.asarray(g.stamps)
        if len(kf_stamps) == 0:
            return False
        # Per-keyframe rigid correction: corrected = R_seg @ drifted + t_seg.
        r_seg = rots_c @ rots_d.transpose(0, 2, 1)
        t_seg = trans_c - np.einsum("kij,kj->ki", r_seg, trans_d)
        # Each insert epoch goes to the nearest keyframe by timestamp.
        ep = np.asarray(self._epoch_stamps)
        hi = np.clip(np.searchsorted(kf_stamps, ep), 0, len(kf_stamps) - 1)
        lo = np.clip(hi - 1, 0, len(kf_stamps) - 1)
        seg = np.where(np.abs(ep - kf_stamps[lo]) < np.abs(ep - kf_stamps[hi]), lo, hi)
        dev = self.device
        self.map = vm.reanchor(
            self.map,
            self.step_cfg.map_cfg,
            torch.as_tensor(seg, dtype=torch.int32, device=dev),
            torch.as_tensor(r_seg, dtype=self.dtype, device=dev),
            torch.as_tensor(t_seg, dtype=self.dtype, device=dev),
        )
        # The rebuild advances the epoch by its chunk count; the re-anchored
        # content is attributed to the newest keyframe (consistent with the
        # corrected trajectory), so a second correction segments correctly.
        new_epoch = int(self.map.epoch)
        if new_epoch > len(self._epoch_stamps):
            self._epoch_stamps.extend(
                [float(kf_stamps[-1])] * (new_epoch - len(self._epoch_stamps))
            )
        return True

    def finish(self, out_dir: Optional[str] = None):
        """End-of-run outputs: drain the loop back end, then write
        `tum.txt`, `loop_tum.txt` (the loop-corrected keyframes, when the
        back end ran) and `map.pcd` to out_dir (when given). Returns the
        corrected keyframe trajectory (rots, trans), or None."""
        self.flush_scans()
        corrected = None
        if self.loop_backend is not None:
            self.loop_backend.finish()
            corrected = self.loop_backend.corrected_trajectory()
        if out_dir is not None:
            os.makedirs(out_dir, exist_ok=True)
            export.write_tum(os.path.join(out_dir, "tum.txt"), self.trajectory)
            if corrected is not None and len(corrected[1]):
                rots, trans = corrected
                stamps = self.loop_backend.graph.stamps
                quats = so3.rot_to_quat(torch.as_tensor(np.asarray(rots), dtype=torch.float32)).numpy()
                traj = [
                    (stamps[i] if i < len(stamps) else float(i), trans[i], quats[i])
                    for i in range(len(trans))
                ]
                export.write_tum(os.path.join(out_dir, "loop_tum.txt"), traj)
            export.write_pcd(os.path.join(out_dir, "map.pcd"), export.map_to_cloud(self.map))
        return corrected

    @property
    def acc_scale(self) -> float:
        return self.initializer.acc_scale if self.initializer.done else 1.0
