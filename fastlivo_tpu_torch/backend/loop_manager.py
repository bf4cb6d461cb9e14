"""Back-end manager: keyframing, loop detection, pose-graph correction
(port of fastlivo_tpu/backend/loop_manager.py).

The corrected trajectory never touches the live filter: loop results only
affect the pose graph and its exported trajectory (loop_tum.txt beside
tum.txt). With `background=True` STD detection runs on one worker thread
(the reference's std::thread loop). Its device work shares the default
CUDA stream with the main path, so the two serialise on the card; futures
complete in submission order (`max_workers=1`), so results stay
deterministic.
"""

from __future__ import annotations

import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from fastlivo_tpu_torch import device as _device
from fastlivo_tpu_torch.backend.pose_graph import PoseGraph
from fastlivo_tpu_torch.backend.std_loop import StdConfig, StdLoopDetector
from fastlivo_tpu_torch.native import voxel_mask
from fastlivo_tpu_torch.ops.camera import Pinhole


@dataclass
class LoopEvent:
    kf_from: int
    kf_to: int
    score: float
    rot: np.ndarray
    trans: np.ndarray


class LoopBackend:
    def __init__(self, cfg, background: bool = False, device=None):
        self.device = _device.resolve(device)
        self.std_cfg = StdConfig.from_params(cfg.loop)
        self.detector = StdLoopDetector(self.std_cfg, device=self.device)
        self.graph = PoseGraph()
        self.sub_frame_num = cfg.loop.sub_frame_num
        self.trans_thresh = cfg.keyframe.trans_thresh_m
        self.rot_thresh = cfg.keyframe.rot_thresh_rad
        self.ds_size = cfg.loop.ds_size

        self._cloud_buf: List[np.ndarray] = []
        self._std_frame_kf: List[int] = []  # STD frame index -> keyframe idx
        self._last_kf: int = 0
        self.loops: List[LoopEvent] = []
        self._executor = ThreadPoolExecutor(max_workers=1) if background else None
        self._pending: List[Tuple[Future, int, Optional[np.ndarray]]] = []

        # Visual verification of loop candidates (the reference's
        # SuperPoint+LightGlue match-ratio gate).
        self.visual_verify_en = cfg.loop.visual_verify_en
        self.match_ratio_thresh = cfg.loop.match_ratio_thresh
        self.pose_check_max_rot = cfg.loop.pose_check_max_rot
        self._frame_imgs: List[Optional[np.ndarray]] = []  # per STD frame
        self._last_img: Optional[np.ndarray] = None
        self._matcher = None
        self.rejected_loops: List[Tuple[int, int, float]] = []
        # Per key cloud: its size and the host seconds of its STD detection;
        # per visual-gate match: its seconds and match ratio.
        self.key_cloud_sizes: List[int] = []
        self.detect_s: List[float] = []
        self.match_s: List[float] = []
        self.match_ratios: List[float] = []
        # Camera model + camera-from-body rotation for the essential-matrix
        # pose cross-check (R_cb = Rcl @ R_il^T).
        c = cfg.camera
        self._cam = Pinhole(width=c.width, height=c.height, fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy)
        rcl = np.asarray(c.rcl, np.float64).reshape(3, 3)
        r_il = np.asarray(cfg.extrinsics.extrinsic_r, np.float64).reshape(3, 3)
        self._rot_ci = rcl @ r_il.T

    # ------------------------------------------------------------------

    def on_scan(
        self, rot: np.ndarray, pos: np.ndarray, world_cloud: np.ndarray,
        stamp: float = 0.0, img: Optional[np.ndarray] = None,
    ):
        """Feed every LIO posterior pose + registered world cloud (and the
        most recent camera frame, when there is one)."""
        kf = self.graph.maybe_add_keyframe(
            rot, pos, self.trans_thresh, self.rot_thresh, stamp=stamp
        )
        if kf is not None:
            self._last_kf = kf
        if img is not None:
            self._last_img = img
        self._cloud_buf.append(self._downsample(world_cloud))
        if len(self._cloud_buf) >= self.sub_frame_num:
            key_cloud = np.concatenate(self._cloud_buf)
            self._cloud_buf = []
            self.key_cloud_sizes.append(len(key_cloud))
            kf_idx = self._last_kf
            # The camera frame is captured at key-cloud time: a background
            # result completes scans later, when _last_img has moved on.
            key_img = self._last_img
            if self._executor is None:
                self._handle_result(self._detect(key_cloud), kf_idx, key_img)
            else:
                self._pending.append(
                    (self._executor.submit(self._detect, key_cloud), kf_idx, key_img)
                )
        self._poll()

    def _detect(self, key_cloud: np.ndarray):
        t0 = time.perf_counter()
        out = self.detector.detect(key_cloud)
        self.detect_s.append(time.perf_counter() - t0)
        return out

    def _poll(self):
        # Take finished detections from the head of the queue only: each is
        # handled once, in submission order, however the worker races this.
        while self._pending and self._pending[0][0].done():
            fut, kf_idx, key_img = self._pending.pop(0)
            self._handle_result(fut.result(), kf_idx, key_img)

    def _handle_result(self, result, kf_idx: int, key_img=None):
        self._std_frame_kf.append(kf_idx)
        self._frame_imgs.append(key_img)
        if result is None:
            return
        fid, score, rot, t = result

        match_res = None
        if self.visual_verify_en:
            img_cur = self._frame_imgs[-1]
            img_old = self._frame_imgs[fid] if fid < len(self._frame_imgs) else None
            if img_cur is not None and img_old is not None:
                from fastlivo_tpu_torch.backend.visual_verify import default_matcher, verify_loop

                if self._matcher is None:
                    self._matcher = default_matcher(device=self.device)
                t0 = time.perf_counter()
                ok, res = verify_loop(img_cur, img_old, self._matcher, self.match_ratio_thresh)
                self.match_s.append(time.perf_counter() - t0)
                self.match_ratios.append(res.match_ratio)
                if not ok:
                    self.rejected_loops.append((fid, kf_idx, res.match_ratio))
                    return
                match_res = res
        kf_from = self._std_frame_kf[fid]
        # The STD transform maps current-frame coords to the matched frame's
        # coords: a relative pose between the two keyframes' world anchors.
        r_i, t_i = self.graph.rots[kf_from], self.graph.trans[kf_from]
        r_j, t_j = self.graph.rots[kf_idx], self.graph.trans[kf_idx]
        r_j_corr = rot @ r_j
        t_j_corr = rot @ t_j + t
        rel_r = r_i.T @ r_j_corr
        rel_t = r_i.T @ (t_j_corr - t_i)

        # Cross-check the STD/ICP rotation against the image-derived one;
        # in camera frames the STD rotation is R_cb rel_r R_cb^T.
        if match_res is not None and self.pose_check_max_rot > 0:
            from fastlivo_tpu_torch.backend.visual_verify import essential_pose

            ep = essential_pose(match_res, self._cam)
            if ep is not None:
                r_vis, _t_unit, n_inl = ep
                if n_inl >= 12:
                    r_std_cam = self._rot_ci @ rel_r @ self._rot_ci.T
                    dr = r_vis.T @ r_std_cam
                    ang = float(np.arccos(np.clip((np.trace(dr) - 1.0) / 2.0, -1.0, 1.0)))
                    if ang > self.pose_check_max_rot:
                        self.rejected_loops.append((fid, kf_idx, -ang))
                        return
        # Loop transforms are decimeter-accurate (corner-resolution bound);
        # weight them like ~0.3 m sigma.
        self.graph.add_loop(kf_from, kf_idx, rel_r, rel_t, weight=score * 3.0)
        self.loops.append(LoopEvent(kf_from, kf_idx, score, rot, t))

    # ------------------------------------------------------------------

    def drain(self):
        """Wait for and handle every pending background detection."""
        for fut, kf_idx, key_img in self._pending:
            self._handle_result(fut.result(), kf_idx, key_img)
        self._pending = []

    def finish(self):
        """Drain pending background detections."""
        if self._executor is not None:
            self.drain()
            self._executor.shutdown(wait=True)

    def corrected_trajectory(self) -> Tuple[np.ndarray, np.ndarray]:
        """Optimize and return (rots (K,3,3), trans (K,3)): the
        loop-corrected keyframe trajectory."""
        return self.graph.optimize()

    def _downsample(self, cloud: np.ndarray) -> np.ndarray:
        if len(cloud) == 0:
            return cloud
        return cloud[voxel_mask(cloud, self.ds_size)]
