"""Drive the PyTorch port of the LIVO cycle on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--out record.json]

Phases (any failure raises and the script exits nonzero; it prints no
result line without a CUDA device):

0. device check: the card's name and power limit (nvidia-smi), then the
   CUDA kernels are built from fastlivo_tpu_torch/csrc with nvcc.
1. kernels: each CUDA kernel against its plain PyTorch version on the
   card (bitwise), with CUDA-event times for the kernel, the plain version
   and one PyTorch library call. K1 `extract_windows` at the window shapes
   of the TPU kernel; the fused `patch_sample` at every main-path form
   (select, update on each level, the level-batched stored patches) on a
   rendered frame's padded pyramid, with clamped, out-of-set and
   non-finite inputs among the candidates: N = 1, 208 and 4096 on a
   640x512 frame and N = 832 (the 32x26 grid) on a 1280x1024 frame of
   configs/mars_lvig_gnss.yaml's camera. Each call must be one launch.
   Then the wrapper's host cost split by stage at N = 208
   (time.perf_counter_ns per stage of `ops/patch_sample._launch`).
   `imu_propagate` (`models.imu.propagate`) against `propagate_plain` at
   the cell's window (M = 128, 21 valid samples) in float64 and float32,
   within `IMU_RTOL` of each output's largest magnitude, one launch a call.
2. LIVO: bootstrap_map, then lio_scan_step (surfel) + vio_scan_step pairs
   at the flagship sizes (81,920 raw points, 65,536 budget, 2^18 arena,
   640x512 camera) on a periodic circular room trajectory with matching
   IMU samples and rendered frames. Launch counts are reset just before
   the timed pairs and read just after: every patch read goes through
   `patch_sample`, and K1 is no longer on this path. Over the profiled
   pairs, `patch_sample`'s counter must equal the kernel runs the device
   trace records (the photometric update's run as graph replays).
3. determinism: the same short sequence twice from one seed; trajectories
   and the map's counts/meta must match bitwise.
4. CLI: `run.run_log`, the body of `python -m fastlivo_tpu_torch.run`, on
   an 8 s generated log (24,000 points per scan, 200 Hz IMU, 640x512
   frames at 10 Hz) with configs/avia_livo.yaml at its full widths
   (point-to-plane LIO, 2^19 arena, 16,384 budget, visual map 40,960 x 8)
   and only the synthetic rig's extrinsics overridden. Launch counts are
   reset just before that run and read just after. Gates: no rejected
   update, n_effective >= min_effective on every update, n_selected > 0
   on every frame once the visual map has points, ATE < 0.10 m, tum.txt
   and map.pcd read back, a second run of the first 20 scans writes the
   same tum.txt rows bit for bit. Then a profile of two LIO steps (knn's
   device share, kernels and host syncs per step) and a LIO-only VGICP run
   of 20 scans (no rejection, ATE < 0.10 m).
5. the back end, on a street circuit (`io.synthetic.circuit_trajectory`,
   seed 11, gyro bias 0.01 rad/s on z and 0.03 rad/s white gyro noise,
   200 Hz IMU), both through `run.run_log`:
   5a. configs/urbannav_loop.yaml (point-to-plane LIO, STD loop closure
       on a worker thread, no camera) as shipped, on an 80 s log of 64,000
       points per scan. Gates: no rejection, a loop, the loop-corrected keyframe ATE
       below the odometry keyframe ATE, `reanchor_map()` applies and keeps
       more than half the occupied voxels, all finite. Records LIO step,
       wall, STD host ms per key cloud and `fit_voxel_planes` device ms,
       `reanchor` ms, host syncs per step.
   5b. configs/mars_lvig_gnss.yaml (GNSS from an RTK file the phase writes
       with samples until 8 s, LIVO at 1280x1024) with the kitchen sink's
       loop settings and the learned visual gate, on a 31 s log of 24,000
       points per scan and 10 Hz frames. Gates: GNSS initialises and goes
       into an update, no rejection, ATE < 0.10 m, the gate runs
       SuperPointLightGlue and passes a loop, `patch_sample` launches
       (counts reset just before the run, read just after).
   5c. one learned match of two 1280x1024 frames of the 5b log timed with
       CUDA events (SuperPoint x2, LightGlue, host readback), its FLOPs
       from the shapes and share of the f32 peak; the card against the
       CPU port (maps within 1e-3, the same keypoints and matches); the
       revisit pair passes `verify_loop`, a distant pair fails it.

6. a recorded bag: the phase writes its own ROS bag V2.0 files.
   6a. phase 4's 8 s room log as a bag (livox CustomMsg 24,000 points per
       scan, 200 Hz sensor_msgs/Imu, 640x512 mono8 sensor_msgs/Image at
       10 Hz, uncompressed chunks), converted by the port's `bag_to_flvo`
       (lidar type 1, default LidarParams), then `run.run_log` with
       configs/avia_livo.yaml (rig overrides only); launch counts reset just
       before the run and read just after. Gates: the converted message
       counts equal those written, the run decoded the log natively, the
       native and NumPy decoders give the same records bit for bit, no
       rejected update, ATE < 0.10 m, `patch_sample` launches.
   6b. the bag's first 2 s rewritten with lz4 (the port's `io.lz4f`) and
       bz2 chunks: each converts to the uncompressed bag's log byte for
       byte.
   6d. feature selection: the 6a bag's first 3 s with every sweep
       ray-cast ring by ring (24,000 points, consecutive points neighbours
       on a surface, as a 16-ring spinning LiDAR records them), converted,
       then 20 scan-end groups with preprocess.feature_extract_en 1. Gates:
       every scan keeps more than half of its points (far above the
       100-point fallback), no rejection, n_effective >= min_effective on
       every update, every state finite (the kept share, the host ms of
       `classify_features` and the ATE are recorded).
   6e. `colorize_cloud` of the 6a run's map cloud through the log's last
       frame on the card and on the CPU: the same visible mask, values
       within 1e-4, some points visible.

7. multi-device on torch.distributed, every rank a child process of this
   script started with a timeout (a child that fails fails the phase):
   7a. NCCL at world 1, flagship sizes: bootstrap, then 20 LIVO pairs on
       one device and through `parallel.make_sharded_lio_step` map-sharded
       and points-sharded, pair by pair in turns on the same inputs. Gates:
       each sharded pair's summaries and the final arena equal the
       one-device ones bit for bit (else within 1e-6 m, the merged surfel
       lookup's own difference from the one-device lookup recorded beside),
       `patch_sample` launches on the sharded pairs (counts reset just
       before each sharded pair, read just after). Records pair ms per mode
       and collectives per LIO step.
   7b. two gloo ranks sharing cuda:0, the same sequence map-sharded. Gates:
       the trajectory within 8e-3 m of 7a's, every occupied key on its
       owner, each rank's load above 0.5 of the mean. Records arena bytes
       per rank. With two or more GPUs, NCCL at world 2 too (else a line
       says why not).
   7c. the CLI under `python -m torch.distributed.run` (`run.main`, phase
       4's log and avia_livo.yaml with the rig overrides): world 1 (NCCL,
       parallel.map_sharded) with phase 4's gates and its tum.txt equal to
       phase 4's bit for bit (else within 1e-6 m); then the first 30
       scan-end groups at world 2 (gloo on cuda:0): ATE < 0.10 m, within
       2e-2 m of world 1's rows. World 2 runs the loop back end and ends
       with `LivoPipeline.reanchor_map` while only rank 0 holds a loop:
       both ranks apply rank 0's shift (within 1e-5 m), keep every key on
       its owner and agree on the epoch.
   7d. (in 7b's world) a sharded `reanchor` of a 2^16-slot-per-rank arena
       that moves most voxels to another owner: no point dropped, every
       key on its owner; its ms.

8. matcher training (`backend/train_matcher.py`, the sequence of its
   `main`) at the JAX script's default recipe, uncut: 384 pairs (768
   rendered at 320x256) on the card, SuperPoint at its full architecture
   for 3,000 steps at batch 8, LightGlue (3 layers, 256 keypoints) for
   2,500 steps at batch 4 (each loop replays a CUDA graph of its step
   after 3 eager steps), the f16 npz files into a temporary directory.
   Launch counts are reset just before and read just after (the path runs
   neither kernel). Gates: finite losses, each network's mean loss over
   the last 50 steps below its first 5 steps' mean, n_valid > 0, the first
   32-pair chunk's overlap flags equal the CPU port's; on the three pairs
   of tests/test_superpoint_lightglue.py::test_trained_matcher_beats_classical
   (rendered by the port) the saved artifact beats OrientedPatchMatcher's
   match ratio on every pair and by > 1.5x on the mean (the committed
   weights' ratios recorded beside); the saved artifact gives the matches
   of the in-memory model with f16-rounded weights; one SuperPoint and one
   LightGlue step on the card against the CPU port (losses within rtol
   1e-4; in float32 all gradients together within 1e-4 relative L2, in
   float64 every gradient tensor); 12 graphed steps of each network
   against the same steps run eagerly, no farther apart than two eager
   runs. Records ms per step (CUDA events, median after 20 steps) and the
   eager ms per step, FLOPs per step and their f32 peak share, host syncs
   inside the step loops (and where), peak memory, seconds per stage,
   `evaluate()`'s six adversarial pairs, whether two card steps repeat bit
   for bit.

The last two lines of standard output are the kernels' JSON record and
`{"ok": true, "device": {...}}`. The scene helpers (`Scene`) are plain
numpy so the CPU tests can feed the same inputs to both packages.
"""

from __future__ import annotations

import bz2
import json
import math
import os
import re
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np

# ---------------------------------------------------------------------------
# Scene: a 16 m room, a periodic circular trajectory, matching IMU samples.
# ---------------------------------------------------------------------------

PAIR_DT = 0.1  # one LIO scan end and one camera frame per 0.1 s
HALF_DT = 0.5 * PAIR_DT  # frame lands half-way between scan ends
N_POOL = 40  # trajectory period in pairs
RADIUS = 1.0
OMEGA = 2.0 * math.pi / (N_POOL * PAIR_DT)
# Camera looks along body -x: voxel_downsample keeps the first ds_capacity
# voxels in lexicographic order, so at these budgets the +x wall never
# reaches the world cloud and a +x camera would get an empty depth image.
ROT_CI = np.array([[0.0, 1.0, 0.0], [0.0, 0.0, -1.0], [-1.0, 0.0, 0.0]], np.float32)
GRAVITY = 9.81


def pose_at(t):
    """Body position at time t (identity attitude throughout)."""
    th = OMEGA * np.asarray(t, np.float64)
    return np.stack([RADIUS * np.cos(th), RADIUS * np.sin(th), np.zeros_like(th)], -1)


def vel_at(t):
    th = OMEGA * np.asarray(t, np.float64)
    return np.stack(
        [-RADIUS * OMEGA * np.sin(th), RADIUS * OMEGA * np.cos(th), np.zeros_like(th)], -1
    )


def specific_force(t):
    """Accelerometer reading: centripetal acceleration minus gravity."""
    th = OMEGA * np.asarray(t, np.float64)
    a = -RADIUS * OMEGA**2 * np.stack([np.cos(th), np.sin(th), np.zeros_like(th)], -1)
    a[..., 2] += GRAVITY
    return a


class Scene:
    """Numpy inputs for bootstrap + LIVO pairs. Pair k >= 1 runs the LIO
    update of the scan ending at t_k = k * PAIR_DT (IMU window
    [t_k - HALF_DT, t_k]) and then the VIO update of the frame at
    t_k + HALF_DT (IMU window [t_k, t_k + HALF_DT]). The bootstrap scan is
    taken at rest-pose time HALF_DT, where the initial state sits."""

    def __init__(self, n_raw: int, imu_m: int, seed: int = 0):
        self.n_raw = n_raw
        self.imu_m = imu_m
        self.rng = np.random.default_rng(seed)

    def room_points(self, n):
        per = n // 5
        pts = []
        for face in range(5):
            u = self.rng.uniform(-8, 8, size=(per, 2))
            if face == 0:
                p = np.stack([u[:, 0], u[:, 1], np.full(per, -1.5)], 1)
            else:
                axis, val = [(0, -8), (0, 8), (1, -8), (1, 8)][face - 1]
                p = np.zeros((per, 3))
                p[:, axis] = val
                p[:, 1 - axis] = u[:, 0]
                p[:, 2] = u[:, 1] + 4
            pts.append(p)
        w = np.concatenate(pts)
        pad = n - len(w)
        if pad:
            w = np.concatenate([w, w[:pad]])
        return w

    def imu_window(self, t0):
        stamps = np.linspace(0.0, HALF_DT, self.imu_m)
        return dict(
            stamps=stamps.astype(np.float32),
            gyr=np.zeros((self.imu_m, 3), np.float32),
            acc=specific_force(t0 + stamps).astype(np.float32),
            mask=np.ones(self.imu_m, bool),
        )

    def initial_state(self):
        """NavState fields at time HALF_DT."""
        return dict(
            rot=np.eye(3, dtype=np.float32),
            pos=pose_at(HALF_DT).astype(np.float32),
            vel=vel_at(HALF_DT).astype(np.float32),
            bg=np.zeros(3, np.float32),
            ba=np.zeros(3, np.float32),
            grav=np.array([0.0, 0.0, -GRAVITY], np.float32),
            cov=(np.eye(18) * 1e-4).astype(np.float32),
        )

    def bootstrap_scan(self):
        w = self.room_points(self.n_raw)
        return self._scan(w - pose_at(HALF_DT), np.zeros(self.n_raw), HALF_DT)

    def lio_scan(self, k):
        """Scan ending at t_k; each point seen from the pose at its time."""
        t_end = k * PAIR_DT
        t0 = t_end - HALF_DT
        t_offs = np.sort(self.rng.uniform(0.0, HALF_DT, self.n_raw))
        w = self.room_points(self.n_raw)
        return self._scan(w - pose_at(t0 + t_offs), t_offs, t0)

    def vio_window(self, k):
        """IMU-only ScanInput fields for the frame at t_k + HALF_DT."""
        return self._scan(np.zeros((1, 3)), np.zeros(1), k * PAIR_DT)

    def _scan(self, pts, t_offs, t0):
        return dict(
            pts=pts.astype(np.float32),
            t_offs=np.asarray(t_offs, np.float32),
            mask=np.ones(len(pts), bool),
            imu=self.imu_window(t0),
            t_end=np.float32(HALF_DT),
            acc_scale=np.float32(1.0),
        )

    @staticmethod
    def frame_pose(k):
        """(rcw, pcw) of the camera at t_k + HALF_DT."""
        p = pose_at(k * PAIR_DT + HALF_DT).astype(np.float32)
        return ROT_CI, (-ROT_CI @ p).astype(np.float32)


# ---------------------------------------------------------------------------
# Torch-side runners (imported lazily: the tests import this module too).
# ---------------------------------------------------------------------------


def to_scan_input(d, device):
    import torch

    from fastlivo_tpu_torch.models.imu import ImuWindow
    from fastlivo_tpu_torch.models.pipeline import ScanInput

    t = lambda a: torch.as_tensor(np.asarray(a)).to(device)  # noqa: E731
    return ScanInput(
        pts=t(d["pts"]), t_offs=t(d["t_offs"]), mask=t(d["mask"]),
        imu=ImuWindow(**{k: t(v) for k, v in d["imu"].items()}),
        t_end=t(d["t_end"]), acc_scale=t(d["acc_scale"]),
    )


def flagship_config():
    from fastlivo_tpu_torch.maps import visual_map as vmap_mod
    from fastlivo_tpu_torch.maps import voxel_map as vm
    from fastlivo_tpu_torch.models import lio, vio
    from fastlivo_tpu_torch.models.pipeline import StepConfig
    from fastlivo_tpu_torch.ops.camera import Pinhole

    return StepConfig(
        map_cfg=vm.VoxelMapConfig(
            resolution=0.5, capacity=1 << 18, max_points=32, nearby_type=18,
            lookup_unique_cap=8192,
        ),
        lio_cfg=lio.LioConfig(measurement_model="surfel"),
        ds_capacity=65536,
        imu_window=32,
        cam=Pinhole(width=640, height=512, fx=400.0, fy=400.0, cx=320.0, cy=256.0),
        vio_cfg=vio.VioConfig(),
        vm_cfg=vmap_mod.VisualMapConfig(capacity=4096, max_obs=4),
    )


def gpu_identity():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def eager_time_ms(fn, iters=50, warmup=5):
    """Per-call time of `fn` launched eagerly back to back (CUDA events):
    what the main path pays, host launch cost included."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def graph_time_ms(fn, iters=20, reps=10):
    """Device time per call: `iters` calls captured in one CUDA graph and
    replayed `reps` times (CUDA events), so host launch cost is excluded."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (iters * reps)


HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)

# The padded pyramid levels of a 640x512 frame (32 px of padding per side).
K1_SHAPES = [(576, 704), (320, 384), (192, 224)]
K1_WINS = [13, 30, 38]
K1_NS = [1, 208, 4096]


def k1_starts(rng, n, hp, wp, win):
    """Clipped corners that touch every border (first rows) then random."""
    edge = [(0, 0), (wp - win, 0), (0, hp - win), (wp - win, hp - win)]
    pts = rng.integers(0, [wp - win + 1, hp - win + 1], size=(n, 2))
    k = min(n, len(edge))
    pts[:k] = edge[:k]
    return pts.astype(np.int32)


def phase_kernels(device):
    """K1 against its plain version at every (level, win, n): bitwise, then
    timed (device time from a CUDA graph, and eager per-call time) beside
    its plain version and the unfold-index library call."""
    import torch

    from fastlivo_tpu_torch.ops import pallas_windows as pw

    rng = np.random.default_rng(1)
    rows = []
    for hp, wp in K1_SHAPES:
        img = torch.as_tensor(rng.uniform(0, 255, (hp, wp)).astype(np.float32)).to(device)
        for win in K1_WINS:
            for n in K1_NS:
                k1_np = k1_starts(rng, n, hp, wp, win)
                starts = torch.as_tensor(k1_np).to(device)
                got = pw.extract_windows_cuda(img, starts, win)
                want = pw.extract_windows_plain(img, starts, win)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                if not torch.equal(got, want):
                    raise AssertionError(f"K1 mismatch at {hp}x{wp} win={win} n={n}: {err}")
                ov = starts[:, 1].long()
                ou = starts[:, 0].long()
                fns = dict(
                    kernel=lambda: pw.extract_windows_cuda(img, starts, win),
                    plain=lambda: pw.extract_windows_plain(img, starts, win),
                    library=lambda: img.unfold(0, win, 1).unfold(1, win, 1)[ov, ou],
                )
                row = dict(hp=hp, wp=wp, win=win, n=n, max_abs_err=err)
                for name, fn in fns.items():
                    row[f"{name}_ms"] = graph_time_ms(fn)
                    row[f"{name}_eager_ms"] = eager_time_ms(fn)
                # Least bytes: each image pixel some window covers read once,
                # the corners read once, every output window written once.
                # (Windows overlap, so this is below 2 * n * win^2 * 4,
                # which is also reported.)
                cover = np.zeros((hp, wp), bool)
                for u0, v0 in k1_np:
                    cover[v0:v0 + win, u0:u0 + win] = True
                moved = cover.sum() * 4 + 8 * n + n * win * win * 4
                row["bound_ms"] = moved / HBM_BYTES_PER_S * 1e3
                row["bound_2nw2_ms"] = 2.0 * n * win * win * 4 / HBM_BYTES_PER_S * 1e3
                rows.append(row)
    return rows, phase_imu(device)


# IMU propagation (models/imu.py): the window of imu.imu_int_frame as
# shipped, filled as a 10 Hz sweep of 200 Hz IMU fills it in
# avia_lio_f64.handheld_room, and at the edges.
IMU_M = 128
IMU_VALID = (1, 2, 21, 128)
IMU_CELL_VALID = 21
# case name -> (state dtype, window dtype), the kernel's three kinds
IMU_DTYPES = {"f32": ("float32", "float32"), "f64": ("float64", "float64"),
              "f64_w32": ("float64", "float32")}
# Kernel against propagate_plain on the card, as a share of each output's
# largest magnitude: the two sum every 3x3 and 18x18 product in another
# order (cuBLAS against the kernel's FMAs) through up to 127 chained
# intervals, so they agree to the state dtype's rounding times the chain.
IMU_RTOL = {"float32": 1e-5, "float64": 1e-12}


def imu_case(device, n_valid, kind="f64", bias=True, seed=0, m=IMU_M):
    """A window as `io.sync.WindowBuilder` fills it (n_valid samples at
    200 Hz, the padded tail repeating the last stamp with zero rates and
    mask False) and a state to propagate through it, on `device`: (state,
    window, t_end, acc_scale) for `models.imu.propagate`."""
    import torch

    from fastlivo_tpu_torch.models.imu import ImuWindow
    from fastlivo_tpu_torch.state import NavState

    sdt, wdt = (getattr(torch, d) for d in IMU_DTYPES[kind])
    rng = np.random.default_rng(seed)
    stamps = np.zeros(m)
    stamps[:n_valid] = 0.0013 + 0.005 * np.arange(n_valid)
    stamps[n_valid:] = stamps[n_valid - 1]
    gyr = np.zeros((m, 3))
    acc = np.zeros((m, 3))
    gyr[:n_valid] = rng.normal(size=(n_valid, 3)) * 0.8
    acc[:n_valid] = rng.normal(size=(n_valid, 3)) * 1.5 + [0.3, -0.2, 9.81]
    a = rng.normal(size=(18, 18))
    b = 1.0 if bias else 0.0
    st = NavState(
        rot=_rotvec(rng.normal(size=3)), pos=rng.normal(size=3) * 3.0, vel=rng.normal(size=3),
        bg=rng.normal(size=3) * 0.02 * b, ba=rng.normal(size=3) * 0.1 * b,
        grav=np.array([0.05, -0.03, -9.81]), cov=a @ a.T * 1e-5 + np.eye(18) * 1e-4,
    )
    state = NavState(*(torch.as_tensor(x, dtype=sdt, device=device) for x in st))
    window = ImuWindow(
        stamps=torch.as_tensor(stamps, dtype=wdt, device=device),
        gyr=torch.as_tensor(gyr, dtype=wdt, device=device),
        acc=torch.as_tensor(acc, dtype=wdt, device=device),
        mask=torch.as_tensor(np.arange(m) < n_valid, device=device),
    )
    t_end = torch.tensor(stamps[n_valid - 1] + 0.0021, dtype=wdt, device=device)
    return state, window, t_end, torch.tensor(0.98, dtype=wdt, device=device)


def imu_errors(got, want):
    """Per output (the new state's fields, then the pose table's), the
    largest difference as a share of the largest magnitude in `want`."""
    import torch

    out = {}
    for prefix, g, w in (("state", got[0], want[0]), ("poses", got[1], want[1])):
        for name, a, b in zip(g._fields, g, w):
            scale = max(float(b.abs().max()), torch.finfo(b.dtype).tiny)
            out[f"{prefix}.{name}"] = float((a - b).abs().max()) / scale
    return out


def imu_propagate_bytes(state, window):
    """Least bytes one propagation moves: the state and window read once,
    the new state's rot, pos, vel, cov and the 5 x M pose rows written once."""
    m = window.stamps.shape[0]
    t, w = state.pos.element_size(), window.stamps.element_size()
    return (9 + 15 + 324) * t + (7 * m + 2) * w + m + (339 + 21 * m) * t


def phase_imu(device):
    """`models.imu.propagate` (one kernel launch) against `propagate_plain`
    on the card at the cell's window (M = 128, 21 valid) in float64 and
    float32: the relative errors, then both timed (graphed device time and
    eager per-call time), the byte bound and the launches."""
    import torch

    from fastlivo_tpu_torch.models import imu

    rows = []
    for kind in ("f64", "f32"):
        args = imu_case(device, IMU_CELL_VALID, kind)
        fns = dict(kernel=lambda: imu.propagate(*args), plain=lambda: imu.propagate_plain(*args))
        before = read_launches()["imu_propagate"]
        got = fns["kernel"]()
        if read_launches()["imu_propagate"] != before + 1:
            raise AssertionError(f"imu_propagate {kind}: not one launch")
        want = fns["plain"]()
        torch.cuda.synchronize()
        errs = imu_errors(got, want)
        tol = IMU_RTOL[IMU_DTYPES[kind][0]]
        if max(errs.values()) > tol:
            raise AssertionError(f"imu_propagate {kind}: {errs} above {tol}")
        n_steps = int((args[1].stamps[1:] > args[1].stamps[:-1]).sum())
        row = dict(kind=kind, m=IMU_M, n_valid=IMU_CELL_VALID, max_rel_err=max(errs.values()),
                   rel_err=errs, cov_steps=n_steps, dependent_fmas=n_steps * 2 * 18,
                   bytes=imu_propagate_bytes(args[0], args[1]))
        row["kernel_ms"] = graph_time_ms(fns["kernel"])
        row["kernel_eager_ms"] = eager_time_ms(fns["kernel"])
        row["plain_ms"] = graph_time_ms(fns["plain"], iters=2, reps=5)
        row["plain_eager_ms"] = eager_time_ms(fns["plain"], iters=10, warmup=2)
        row["bound_ms"] = row["bytes"] / HBM_BYTES_PER_S * 1e3
        rows.append(row)
    return rows


# The kNN (maps/voxel_map.py): the cells' map (0.5 m voxels, 2^19 slots,
# 32 points, the 19-voxel stencil) holding three room scans, searched by a
# fourth at the rooms' budget (16,384 points after the 0.15 m downsample)
# and the street's (65,536), as the LIO's point-to-plane search (k 5).
KNN_NS = (16384, 65536)
KNN_DTYPES = ("float32", "float64")


def knn_case(device, n, dtype, seed=0):
    """(map, queries, cfg) of one kNN search at `n` queries."""
    import torch

    from fastlivo_tpu_torch.maps import voxel_map as vm
    from fastlivo_tpu_torch.ops import voxelize

    dt = getattr(torch, dtype)
    cfg = vm.VoxelMapConfig(lookup_unique_cap=n)
    scene = Scene(2 * n, 32, seed=seed)
    ones = torch.ones(2 * n, dtype=torch.bool, device=device)

    def scan():
        w = torch.as_tensor(scene.room_points(2 * n), dtype=dt).to(device)
        return voxelize.voxel_downsample(w, ones, 0.15, n)

    m = vm.make_map(cfg, dt, device=device)
    for _ in range(3):
        m = vm.insert(m, *scan(), cfg)
    return m, scan()[0], cfg


def knn_bytes(m, q, cfg, k=5):
    """Least bytes of one search: the queries read and the outputs written
    once, each bucket row the stencil probes and each slab row and count
    it finds read once; and the bytes read without reuse (every query's
    every stencil voxel)."""
    import torch

    from fastlivo_tpu_torch.maps import voxel_map as vm

    t = q.element_size()
    offs = torch.tensor(vm.nearby_offsets(cfg.nearby_type), dtype=torch.int32, device=q.device)
    vox = (vm.voxel_coord(q, cfg.resolution)[None] + offs[:, None]).reshape(-1, 3)
    found, _ = vm.probe(m, vox, cfg)
    buckets = torch.cat([vm._hash(vox, cfg.n_buckets), vm._hash2(vox, cfg.n_buckets)])
    row_b = cfg.probe_depth * 8 * t
    slab_b = 4 + cfg.max_points * 3 * t
    n_found = int((found >= 0).sum())
    least = (q.numel() * t + q.shape[0] * k * (4 * t + 1) + int(torch.unique(buckets).numel()) * row_b
             + int(torch.unique(found[found >= 0]).numel()) * slab_b)
    no_reuse = q.numel() * t + q.shape[0] * k * (4 * t + 1) + vox.shape[0] * 2 * row_b + n_found * slab_b
    return least, no_reuse


def profiled_device_ms(fn, calls=3):
    """Device time per call of `fn` (the kernels torch.profiler records)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return sum(e.time_range.end - e.time_range.start for e in dev) * 1e-3 / calls, len(dev) / calls


def phase_knn(device):
    """`maps.voxel_map.knn` (one kernel launch) against `knn_plain` on the
    card at the rooms' and the street's budgets, float32 and float64: bit
    for bit, then timed (graphed device time and eager per-call time; the
    plain path eager and by the profiler), the byte bound, the launches."""
    import torch

    from fastlivo_tpu_torch.maps import voxel_map as vm

    rows = []
    for n in KNN_NS:
        for dtype in KNN_DTYPES:
            m, q, cfg = knn_case(device, n, dtype)
            fns = dict(kernel=lambda: vm.knn(m, q, cfg), plain=lambda: vm.knn_plain(m, q, cfg))
            before = read_launches()["voxel_map.knn"]
            got = fns["kernel"]()
            if read_launches()["voxel_map.knn"] != before + 1:
                raise AssertionError(f"knn {dtype} n={n}: not one launch")
            want = fns["plain"]()
            torch.cuda.synchronize()
            if not all(same_bits(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"knn {dtype} n={n}: the kernel differs from knn_plain")
            least, no_reuse = knn_bytes(m, q, cfg)
            row = dict(dtype=dtype, n=n, k=5, offsets=len(vm.nearby_offsets(cfg.nearby_type)),
                       valid_share=float(got[2].float().mean()), bytes=least, bytes_no_reuse=no_reuse)
            row["kernel_ms"] = graph_time_ms(fns["kernel"])
            row["kernel_eager_ms"] = eager_time_ms(fns["kernel"])
            row["kernel_host_us"] = host_ns(fns["kernel"], iters=200, warmup=20) * 1e-3
            row["plain_eager_ms"] = eager_time_ms(fns["plain"], iters=10, warmup=2)
            row["plain_device_ms"], row["plain_kernels"] = profiled_device_ms(fns["plain"])
            row["bound_ms"] = least / HBM_BYTES_PER_S * 1e3
            row["bound_no_reuse_ms"] = no_reuse / HBM_BYTES_PER_S * 1e3
            rows.append(row)
    return rows


# The fused patch sampler's main-path forms (models/vio.py): select reads
# level 0 without gradients, each update iteration one level with
# gradients, maintain the stored 12x12 patches of all levels in one launch.
PS_PAD = 32
PS_NS = [1, 208, 4096]  # on the flagship 640x512 frame
PS_WIDE_N = 832  # one candidate per 40-px cell of a 1280x1024 frame (32 x 26)
PS_STRIDES = (1, 2, 4)
PS_SPLIT_N = 208
PS_SPLIT_ITERS = 2000


def patch_sample_frame(device, cam=None):
    """A rendered room frame and its padded pyramid: the flagship camera
    (704x576, 384x320, 224x192) unless `cam` is given."""
    import torch

    from fastlivo_tpu_torch.io import render
    from fastlivo_tpu_torch.models import vio

    cam = cam or flagship_config().cam
    rcw, pcw = Scene.frame_pose(1)
    img = render.render_room(
        cam, torch.as_tensor(rcw).to(device), torch.as_tensor(pcw).to(device),
        half=8.0, floor_z=-1.5,
    )
    return cam, vio.pyramid_padded(img, 3)


def patch_sample_centers(rng, n, cam):
    """Level-0 centers and strides. First the hard cases: windows clamped
    on each of the four sides, near-border centers, a stride outside the
    set and non-finite centers; then random in-frame centers."""
    w, h = cam.width, cam.height
    edge = [
        (-100.25, h / 2), (w + 90.5, h / 2 + 0.75), (w / 2 + 0.25, -120.5), (w / 2 - 0.5, h + 77.25),
        (1.5, 2.25), (w - 1.25, h - 0.5), (math.nan, 100.0), (200.0, math.inf),
    ]
    c = rng.uniform([0.0, 0.0], [w, h], size=(n, 2))
    s = rng.choice(PS_STRIDES, n)
    k = min(n, len(edge))
    c[:k] = np.reshape(edge[:k], (k, 2))
    s[1:6:4] = 3  # not in PS_STRIDES: the lattice of PS_STRIDES[0]
    return c.astype(np.float32), s.astype(np.int32)


def patch_sample_cases(pyr, cam, n, seed=0):
    """Every main-path form of `patch_sample` at n candidates: the kernel
    call, its plain version, and the inputs (for the bound and the
    yardstick)."""
    import torch

    from fastlivo_tpu_torch.ops import patch_sample as ps

    dev = pyr[0].device
    c_np, s_np = patch_sample_centers(np.random.default_rng(seed + n), n, cam)
    px = torch.as_tensor(c_np).to(dev)
    strides = torch.as_tensor(s_np).to(dev)
    cases = [dict(
        name="select", levels=pyr[:1], centers=[px], strides=strides, patch=8,
        stride_set=PS_STRIDES, grads=False, grad_units=None,
        kernel=lambda: ps.patch_sample(pyr[0], px, strides, 8, PS_PAD),
        plain=lambda: ps.patch_sample_plain(pyr[0], px, strides, 8, PS_PAD),
    )]
    for lvl in range(len(pyr)):
        c = px / (1 << lvl)
        gu = strides.to(torch.float32) * (2.0**lvl)
        img = pyr[lvl]
        cases.append(dict(
            name=f"update_L{lvl}", levels=[img], centers=[c], strides=strides, patch=8,
            stride_set=PS_STRIDES, grads=True, grad_units=gu,
            kernel=lambda img=img, c=c, gu=gu: ps.patch_sample(
                img, c, strides, 8, PS_PAD, grad_units=gu),
            plain=lambda img=img, c=c, gu=gu: ps.patch_sample_plain(
                img, c, strides, 8, PS_PAD, grad_units=gu),
        ))
    cases.append(dict(
        name="stored", levels=pyr, centers=[px / (1 << lvl) for lvl in range(len(pyr))],
        strides=None, patch=12, stride_set=(1,), grads=False, grad_units=None,
        kernel=lambda: ps.patch_sample_levels(pyr, px, 12, PS_PAD),
        plain=lambda: ps.patch_sample_levels_plain(pyr, px, 12, PS_PAD),
    ))
    return cases


def lattice_points(img, centers, strides, patch, stride_set, grads):
    """Padded-pixel (x, y) of the top-left tap of every lattice point, each
    (N, n_lat, n_lat) int, and the shared fraction (N, 2), from the same
    clipped window origins as the sampler."""
    import torch

    hp, wp = img.shape
    g = 1 if grads else 0
    n_lat = patch + 2 * g
    win = (n_lat - 1) * max(stride_set) + 2
    i0 = torch.floor(centers)
    frac = centers - i0
    i0 = i0.to(torch.int32)
    if strides is None:
        strides = torch.full_like(i0[:, 0], stride_set[0])
    org = i0 - strides[:, None] * (patch // 2 + g)
    ou = torch.clamp(org[:, 0] + PS_PAD, 0, wp - win)
    ov = torch.clamp(org[:, 1] + PS_PAD, 0, hp - win)
    s_eff = torch.full_like(strides, stride_set[0])
    for s in stride_set[1:]:
        s_eff = torch.where(strides == s, s, s_eff)
    r = torch.arange(n_lat, device=img.device, dtype=torch.int32)
    x = ou[:, None, None] + s_eff[:, None, None] * r[None, None, :]
    y = ov[:, None, None] + s_eff[:, None, None] * r[None, :, None]
    return x.expand(-1, n_lat, -1).long(), y.expand(-1, -1, n_lat).long(), frac


def patch_sample_bound_bytes(case):
    """Least bytes: every image pixel some tap touches read once, the
    candidates' inputs read once, every output written once."""
    import torch

    touched = 0
    for img, c in zip(case["levels"], case["centers"]):
        x, y, _ = lattice_points(
            img, c, case["strides"], case["patch"], case["stride_set"], case["grads"]
        )
        mask = torch.zeros(img.shape, dtype=torch.bool, device=img.device)
        for dy in (0, 1):
            for dx in (0, 1):
                mask[y + dy, x + dx] = True
        touched += int(mask.sum())
    n = case["centers"][0].shape[0]
    inputs = n * (8 + (4 if case["strides"] is not None else 0) + (4 if case["grads"] else 0))
    outputs = n * len(case["levels"]) * case["patch"] ** 2 * 4 * (3 if case["grads"] else 1)
    return touched * 4 + inputs + outputs


def patch_sample_library(case):
    """The yardstick: one F.grid_sample call (bilinear, zeros padding,
    align_corners=True) at the same lattice points, every level of the case
    batched into one zero-padded (L, 1, H0, W0) input. Values only, no
    gradients; the port never calls it."""
    import torch
    import torch.nn.functional as F

    levels = case["levels"]
    h0, w0 = levels[0].shape
    src = torch.zeros((len(levels), 1, h0, w0), dtype=torch.float32, device=levels[0].device)
    grids = []
    for lvl, (img, c) in enumerate(zip(levels, case["centers"])):
        src[lvl, 0, : img.shape[0], : img.shape[1]] = img
        x, y, frac = lattice_points(
            img, c, case["strides"], case["patch"], case["stride_set"], case["grads"]
        )
        gx = (x + frac[:, 0, None, None]) * (2.0 / (w0 - 1)) - 1.0
        gy = (y + frac[:, 1, None, None]) * (2.0 / (h0 - 1)) - 1.0
        grids.append(torch.stack([gx, gy], dim=-1).reshape(x.shape[0], -1, 2))
    grid = torch.nan_to_num(torch.stack(grids)).to(torch.float32)
    return lambda: F.grid_sample(
        src, grid, mode="bilinear", padding_mode="zeros", align_corners=True
    )


def same_bits(a, b):
    """Bitwise equal, NaN positions included."""
    import torch

    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
        torch.nan_to_num(a), torch.nan_to_num(b)
    )


def host_ns(fn, iters=PS_SPLIT_ITERS, warmup=100):
    """Host ns per call of `fn` in a loop (time.perf_counter_ns)."""
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter_ns()
    for _ in range(iters):
        fn()
    return (time.perf_counter_ns() - t0) / iters


def patch_sample_host_split(case):
    """The CUDA wrapper's host cost by stage of `ops/patch_sample._launch`,
    each stage timed alone in a loop (ns per call): the checks, the output
    buffer, the C arguments, the stream query, the ctypes call with its
    launch; then the whole wrapper call and an empty lambda (the loop's own
    cost, inside every number)."""
    import torch

    from fastlivo_tpu_torch.ops import patch_sample as ps

    levels, centers, strides = case["levels"], case["centers"][0], case["strides"]
    patch, sset, gu = case["patch"], case["stride_set"], case["grad_units"]
    n = centers.shape[0]
    params = ps._validate(levels, centers, strides, patch, sset, gu, PS_PAD)
    out, _ = ps._outputs(centers, n, len(levels), patch, gu is not None)
    args = ps._arguments(levels, centers, strides, gu, n, params, out)
    fn, stream = ps._kernel_fn(), ps._stream(centers)
    stages = dict(
        checks=lambda: ps._validate(levels, centers, strides, patch, sset, gu, PS_PAD),
        outputs=lambda: ps._outputs(centers, n, len(levels), patch, gu is not None),
        arguments=lambda: ps._arguments(levels, centers, strides, gu, n, params, out),
        stream=lambda: ps._stream(centers),
        ctypes_launch=lambda: fn(*args, stream),
        call=case["kernel"],
        loop=lambda: None,
    )
    split = {name: host_ns(f) for name, f in stages.items()}
    torch.cuda.synchronize()
    return split


def phase_patch_sample(device):
    """`patch_sample` against its plain version on the card at every
    main-path form and N (bitwise, NaN positions included, one launch per
    call), then timed beside its plain version and the grid_sample
    yardstick; the wrapper's host split at N = PS_SPLIT_N."""
    import torch

    from fastlivo_tpu_torch.ops.camera import Pinhole

    cam, pyr = patch_sample_frame(device)
    wide_cam, wide_pyr = patch_sample_frame(device, Pinhole(*GNSS_CAMERA))
    rows, split = [], {}
    runs = [(cam, pyr, n) for n in PS_NS] + [(wide_cam, wide_pyr, PS_WIDE_N)]
    for cam, pyr, n in runs:
        for case in patch_sample_cases(pyr, cam, n):
            before = read_launches()["patch_sample"]
            got = case["kernel"]()
            if read_launches()["patch_sample"] != before + 1:
                raise AssertionError(f"patch_sample {case['name']} n={n}: not one launch")
            want = case["plain"]()
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            err = max(float((a.nan_to_num() - b.nan_to_num()).abs().max()) for a, b in zip(got, want))
            if not all(a.shape == b.shape and same_bits(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"patch_sample mismatch: {case['name']} n={n}: {err}")
            fns = dict(kernel=case["kernel"], plain=case["plain"], library=patch_sample_library(case))
            row = dict(case=case["name"], n=n, levels=[list(img.shape) for img in case["levels"]],
                       patch=case["patch"], grads=case["grads"], max_abs_err=err,
                       nan_outputs=int(torch.isnan(got[0]).sum()))
            for name, fn in fns.items():
                row[f"{name}_ms"] = graph_time_ms(fn)
                row[f"{name}_eager_ms"] = eager_time_ms(fn)
            row["bound_ms"] = patch_sample_bound_bytes(case) / HBM_BYTES_PER_S * 1e3
            rows.append(row)
            if n == PS_SPLIT_N:
                split[case["name"]] = patch_sample_host_split(case)
    return rows, split


KERNELS = ("extract_windows", "imu_propagate", "patch_sample", "voxel_map.knn")  # the wrappers' `<kernel>.launches` counters
_LAUNCH_BASE = {}  # the counters at the last reset_launches


def reset_launches():
    """Start every kernel wrapper's launch count from 0 (the tracer's
    counters are cumulative: a reading is a difference)."""
    from fastlivo_tpu_torch.utils import timing

    _LAUNCH_BASE.clear()
    _LAUNCH_BASE.update(timing.counters())


def read_launches():
    """Every kernel wrapper's launches since reset_launches, by kernel name."""
    from fastlivo_tpu_torch.utils import timing

    now = timing.counters()
    return {k: now.get(f"{k}.launches", 0) - _LAUNCH_BASE.get(f"{k}.launches", 0) for k in KERNELS}


def _summary_np(x):
    return np.asarray(x.detach().cpu().numpy(), np.float64)


class LivoRun:
    """bootstrap_map at construction, then one LIVO pair per `pair` call.
    With a `mesh` (`fastlivo_tpu_torch.parallel`), the LIO step and the
    bootstrap run through the sharded builders on this rank's scan slice
    (cfg.map_sharded picks the mode); the VIO step sees the whole cloud, as
    in LivoPipeline."""

    def __init__(self, cfg, scene: Scene, device, mesh=None):
        import torch

        from fastlivo_tpu_torch import convert
        from fastlivo_tpu_torch.maps import visual_map as vmap_mod
        from fastlivo_tpu_torch.maps import voxel_map as vm
        from fastlivo_tpu_torch.models import pipeline as pl

        self.cfg, self.scene, self.device, self.pl, self.mesh = cfg, scene, device, pl, mesh
        self.i3 = torch.eye(3, dtype=torch.float32, device=device)
        self.z3 = torch.zeros(3, dtype=torch.float32, device=device)
        self.rot_ci = torch.as_tensor(ROT_CI).to(device)
        self.state = convert.nav_state_from_numpy(scene.initial_state(), device)
        self.vmap = vmap_mod.make_visual_map(cfg.vm_cfg, device=device)
        boot_scan = to_scan_input(scene.bootstrap_scan(), device)
        if mesh is None:
            self.lmap = pl.bootstrap_map(
                vm.make_map(cfg.map_cfg, device=device), boot_scan, self.state, self.i3, self.z3, cfg,
            )
        else:
            from fastlivo_tpu_torch import parallel

            self._step = parallel.make_sharded_lio_step(mesh, cfg)
            self.lmap = parallel.make_sharded_bootstrap(mesh, cfg)(
                parallel.make_sharded_map(cfg.map_cfg, mesh, device=device),
                parallel.shard_scan(boot_scan, mesh), self.state, self.i3, self.z3,
            )
        self.next_k = 1

    def make_inputs(self, n):
        """Inputs of the next n pairs, frames rendered on the device
        (set-up, made before any timed work)."""
        import torch

        from fastlivo_tpu_torch.io import render

        out = []
        for k in range(self.next_k, self.next_k + n):
            rcw, pcw = self.scene.frame_pose(k)
            img = render.render_room(
                self.cfg.cam, torch.as_tensor(rcw).to(self.device),
                torch.as_tensor(pcw).to(self.device), half=8.0, floor_z=-1.5,
            )
            out.append(dict(
                k=k, scan=to_scan_input(self.scene.lio_scan(k), self.device),
                vwin=to_scan_input(self.scene.vio_window(k), self.device), img=img,
            ))
        self.next_k += n
        return out

    def lio(self, inp):
        if self.mesh is None:
            self.state, self.lmap, _, cloud, lsum = self.pl.lio_scan_step(
                self.state, self.lmap, inp["scan"], self.i3, self.z3, self.cfg
            )
            return cloud, lsum
        from fastlivo_tpu_torch import parallel

        self.state, self.lmap, _, cloud, lsum = self._step(
            self.state, self.lmap, parallel.shard_scan(inp["scan"], self.mesh), self.i3, self.z3
        )
        if not self.cfg.map_sharded:  # points mode returns this rank's slice
            cloud = tuple(self.mesh.axis.all_gather(c) for c in cloud)
        return cloud, lsum

    def vio(self, inp, cloud):
        self.state, self.vmap, _, vsum = self.pl.vio_scan_step(
            self.state, self.vmap, inp["vwin"], inp["img"], cloud[0], cloud[1],
            self.rot_ci, self.z3, self.cfg,
        )
        return vsum

    def pair(self, inp, timed=False):
        import torch

        rec = dict(k=inp["k"])
        if timed:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
        cloud, rec["lio"] = self.lio(inp)
        if timed:
            ev[1].record()
        rec["vio"] = self.vio(inp, cloud)
        if timed:
            ev[2].record()
            rec["ev"] = ev
        return rec


def finish(records):
    """Synchronize once, then read summaries and event times."""
    import torch

    torch.cuda.synchronize()
    for rec in records:
        rec["lio"] = _summary_np(rec["lio"])
        rec["vio"] = _summary_np(rec["vio"])
        ev = rec.pop("ev", None)
        if ev is not None:
            rec["lio_ms"] = ev[0].elapsed_time(ev[1])
            rec["vio_ms"] = ev[1].elapsed_time(ev[2])
    return records


POS_BOUND_M = 0.10  # position vs the true trajectory, every scan and frame
# Kernels per LIVO pair in the flagship profile before the fused sampler
# (K1 plus the eager lattice chain; PERF.md), printed beside this run's.
KERNELS_PER_PAIR_UNFUSED = 7309


def check_records(records):
    for rec in records:
        k = rec["k"]
        lio, vio = rec["lio"], rec["vio"]
        if not (np.all(np.isfinite(lio)) and np.all(np.isfinite(vio))):
            raise AssertionError(f"pair {k}: non-finite summary")
        if lio[9] != 1.0:
            raise AssertionError(f"pair {k}: LIO update rejected (jump {lio[8]})")
        if lio[7] <= 0:
            raise AssertionError(f"pair {k}: n_effective {lio[7]}")
        t_scan = k * PAIR_DT
        for t, pos in ((t_scan, lio[0:3]), (t_scan + HALF_DT, vio[0:3])):
            err = float(np.linalg.norm(pos - pose_at(t)))
            if err > POS_BOUND_M:
                raise AssertionError(f"pair {k}: position {err:.4f} m off the trajectory")


def _device_us(evt):
    return getattr(evt, "self_device_time_total", None) or getattr(evt, "self_cuda_time_total", 0)


# csrc/patch_sample.cu's kernels, as the device trace names them.
PS_KERNEL_RE = re.compile(r"\b(values|grads)_kernel\b")


def kernel_runs(key_averages, pattern):
    """Executions of the device kernels whose name matches `pattern`, as
    CUPTI recorded them (the kernel nodes of a replayed CUDA graph too)."""
    from torch.autograd import DeviceType

    return sum(e.count for e in key_averages if e.device_type == DeviceType.CUDA and pattern.search(e.key))


def profile_pairs(run, inputs):
    """torch.profiler over a few pairs: device time per pair (summed over
    kernel events only: an operator's entry repeats its kernels' time) and
    the operators that take it; `patch_sample`'s launches as its counter
    counts them and as the device trace records them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    counted = read_launches()["patch_sample"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        finish([run.pair(inp) for inp in inputs])
    counted = read_launches()["patch_sample"] - counted
    ka = prof.key_averages()
    kernels = [e for e in ka if e.device_type == DeviceType.CUDA]
    ops = [e for e in ka if e.device_type == DeviceType.CPU and _device_us(e) > 0]
    top = sorted(ops, key=_device_us, reverse=True)[:15]
    return dict(
        pairs=len(inputs),
        device_ms_per_pair=sum(_device_us(e) for e in kernels) / 1e3 / len(inputs),
        kernels_per_pair=sum(e.count for e in kernels) / len(inputs),
        top_ops=[dict(name=e.key[:90], calls=e.count, device_ms=_device_us(e) / 1e3) for e in top],
        patch_sample_counted=counted, patch_sample_ran=kernel_runs(ka, PS_KERNEL_RE),
    )


def count_call_syncs(fn):
    """Host synchronizations in one call (torch's sync debug mode)."""
    return syncs_and_result(fn)[0]


def syncs_and_result(fn):
    """(host synchronizations in one call of `fn`, its result), counted by
    torch's sync debug mode (one warning per synchronizing call)."""
    import warnings

    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught), out


def count_syncs(run, inp):
    """Host synchronizations in one LIO step and one VIO step, counted by
    torch's sync debug mode (one warning per synchronizing call)."""
    out = {}

    def lio():
        out["cloud"], out["lsum"] = run.lio(inp)

    def vio():
        out["vsum"] = run.vio(inp, out["cloud"])

    syncs = dict(lio=count_call_syncs(lio), vio=count_call_syncs(vio))
    finish([dict(k=inp["k"], lio=out["lsum"], vio=out["vsum"])])
    return syncs


def phase_livo(device, n_warm=3, n_timed=20, n_profile=2):
    """Flagship LIVO: warm-up pairs, then the timed pairs with the launch
    counts reset just before and read just after; then a profiled window
    and one pair under the sync counter."""
    import torch

    run = LivoRun(flagship_config(), Scene(n_raw=81920, imu_m=32, seed=0), device)
    warm = run.make_inputs(n_warm)
    timed_in = run.make_inputs(n_timed)
    extra = run.make_inputs(n_profile + 1)
    records = [run.pair(inp) for inp in warm]
    torch.cuda.synchronize()
    reset_launches()
    timed = [run.pair(inp, timed=True) for inp in timed_in]
    torch.cuda.synchronize()
    launches = read_launches()
    records = finish(records + timed)
    check_records(records)
    if min(r["vio"][7] for r in timed) <= 0:
        raise AssertionError("n_selected is 0 on a timed pair")
    n_ps = launches["patch_sample"]
    # Per frame: 1 (select) + one per update iteration (3..30) + 2 (maintain).
    if not len(timed) * 6 <= n_ps <= len(timed) * 33:
        raise AssertionError(f"patch_sample launched {n_ps} times in {len(timed)} frames")
    if launches["extract_windows"] != 0:
        raise AssertionError(f"extract_windows launched {launches['extract_windows']} times")
    # One propagation in each LIO and each VIO step.
    if launches["imu_propagate"] != 2 * len(timed):
        raise AssertionError(f"imu_propagate launched {launches['imu_propagate']} times in {len(timed)} pairs")

    prof = profile_pairs(run, extra[:n_profile])
    # The counter against the device: the photometric update's launches
    # run as kernel nodes of replayed graphs.
    if prof["patch_sample_counted"] != prof["patch_sample_ran"]:
        raise AssertionError(f"patch_sample counted {prof['patch_sample_counted']} launches, the device trace "
                             f"recorded {prof['patch_sample_ran']} runs")
    syncs = count_syncs(run, extra[n_profile])
    lio_ms = [r["lio_ms"] for r in timed]
    vio_ms = [r["vio_ms"] for r in timed]
    pair_ms = float(np.median(np.add(lio_ms, vio_ms)))
    prof["device_idle_share"] = 1.0 - prof["device_ms_per_pair"] / pair_ms
    prof["kernels_per_pair_unfused"] = KERNELS_PER_PAIR_UNFUSED
    return dict(
        lio_ms=float(np.median(lio_ms)), vio_ms=float(np.median(vio_ms)), pair_ms=pair_ms,
        lio_ms_all=lio_ms, vio_ms_all=vio_ms,
        n_effective=[int(r["lio"][7]) for r in records],
        n_selected=[int(r["vio"][7]) for r in records],
        max_pos_err_m=max(
            float(np.linalg.norm(r["lio"][0:3] - pose_at(r["k"] * PAIR_DT))) for r in records
        ),
        launches=launches, frames=len(timed), host_syncs=syncs, profile=prof,
    )


def phase_determinism(device, n_pairs=4):
    """Two runs from one seed at the flagship sizes: bitwise equal."""
    outs = []
    for _ in range(2):
        run = LivoRun(flagship_config(), Scene(81920, 32, seed=7), device)
        recs = finish([run.pair(inp) for inp in run.make_inputs(n_pairs)])
        check_records(recs)
        traj = np.stack([np.concatenate([r["lio"], r["vio"]]) for r in recs])
        outs.append((traj, run.lmap.counts.cpu().numpy(), run.lmap.meta.cpu().numpy(),
                     run.vmap.pos.cpu().numpy()))
    for a, b, name in zip(outs[0], outs[1], ("trajectory", "counts", "meta", "visual pos")):
        if not np.array_equal(a, b):
            raise AssertionError(f"determinism: {name} differs between two runs")
    return dict(pairs=n_pairs, identical=True)


# ---------------------------------------------------------------------------
# Phase 4: the CLI over a shipped configuration.
# ---------------------------------------------------------------------------

CLI_CONFIG = "configs/avia_livo.yaml"
# A Livox Avia's 240k points/s at 10 Hz, 200 Hz IMU, the config's camera.
CLI_LOG = dict(duration=8.0, imu_rate=200.0, scan_rate=10.0, pts_per_scan=24000,
               n_boxes=0, seed=0, cam_rate=10.0, cam_offset=0.055)
CLI_CAMERA = (640, 512, 431.8, 431.7, 319.5, 255.5)  # avia_livo.yaml intrinsics
CLI_ATE_M = 0.10
CLI_REPEAT_SCANS = 20
CLI_PROFILE_SCAN = 15  # scan-end group of the first profiled LIO step


def cli_rig_overrides():
    """The synthetic rig: camera forward in the IMU frame, LiDAR at the IMU."""
    from fastlivo_tpu_torch.io import synthetic

    return {
        "camera.rcl": tuple(synthetic.R_IC_FORWARD.T.reshape(-1).tolist()),
        "camera.pcl": (0.0, 0.0, 0.0),
        "extrinsics.extrinsic_r": (1, 0, 0, 0, 1, 0, 0, 0, 1),
        "extrinsics.extrinsic_t": (0.0, 0.0, 0.0),
    }


def cli_config(extra=None):
    from fastlivo_tpu_torch.utils.config import load_config

    return load_config(CLI_CONFIG, {**cli_rig_overrides(), **(extra or {})})


def write_cli_log(path, device, **sizes):
    """The phase's log (CLI_LOG, updated by `sizes`), frames rendered on
    `device`, written with logio. Returns the log's parameters."""
    from fastlivo_tpu_torch.io import logio, synthetic
    from fastlivo_tpu_torch.ops.camera import Pinhole

    params = {**CLI_LOG, **sizes}
    cam = params.pop("camera", CLI_CAMERA)
    logio.write_sequence(path, synthetic.generate(camera=Pinhole(*cam), device=device, **params))
    return dict(params, camera=list(cam))


def tum_ate(path):
    """ATE (m, no alignment) of a tum.txt against the generator's analytic
    trajectory at the file's own stamps, and the number of poses."""
    from fastlivo_tpu_torch.io import export, synthetic
    from fastlivo_tpu_torch.utils.metrics import ate_rmse

    stamps, pos, quat = export.read_tum(path)
    if not (np.all(np.isfinite(pos)) and np.all(np.isfinite(quat))):
        raise AssertionError(f"{path}: non-finite poses")
    gt = np.stack([synthetic.default_trajectory().pos_fn(t) for t in stamps])
    return float(ate_rmse(pos, gt)), len(stamps)


def check_cli_run(pipe, out_dir, frames=False):
    """The phase's gates on one run; returns (ATE, poses, map points).
    With `frames`, the camera frames are gated too."""
    from fastlivo_tpu_torch.io import export

    if pipe.health["rejected"]:
        raise AssertionError(f"CLI run: {pipe.health['rejected']} LIO updates rejected")
    if not pipe.n_effective:
        raise AssertionError("CLI run: no LIO update ran")
    low = min(pipe.n_effective)
    if low < pipe.step_cfg.lio_cfg.min_effective:
        raise AssertionError(f"CLI run: n_effective {low} below min_effective")
    if frames:
        # Frames before the first LIO update see an empty world cloud, and
        # the frame after it an empty visual map; every frame after those
        # must select patches.
        sel = pipe.n_selected
        first = next((i for i, n in enumerate(sel) if n > 0), len(sel))
        if first == len(sel) or min(sel[first:]) <= 0 or first > pipe.vio_before_lio + 1:
            raise AssertionError(f"CLI run: n_selected {sel}")
    ate, n_poses = tum_ate(os.path.join(out_dir, "tum.txt"))
    if ate >= CLI_ATE_M:
        raise AssertionError(f"CLI run: ATE {ate:.4f} m")
    n_map = len(export.read_pcd(os.path.join(out_dir, "map.pcd")))
    if n_map == 0:
        raise AssertionError("CLI run: empty map.pcd")
    return ate, n_poses, n_map


def profile_call(fn):
    """torch.profiler around one call, with the tracer's profiler ranges
    on: (kernel events, the knn range's device µs), kernel events summed
    per name. A program range's device-side copy (a device event with a
    span's name) is not a kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from fastlivo_tpu_torch.utils import timing

    torch.cuda.synchronize()
    timing.enable(ranges=True)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        timing.disable()
    ranges = {s.name for s in timing.drain().spans}
    kernels, knn_us = {}, 0.0
    for e in prof.key_averages():
        if e.key == "voxel_map.knn":
            if e.device_type == DeviceType.CPU:
                knn_us += getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        elif e.device_type == DeviceType.CUDA and e.key not in ranges:
            us, n = kernels.get(e.key, (0.0, 0))
            kernels[e.key] = (us + _device_us(e), n + e.count)
    return kernels, knn_us


def cli_profile(log, cfg, device, first=CLI_PROFILE_SCAN, n_prof=2):
    """Replays the log through the runner's own stream into a pipeline and
    profiles `n_prof` LIO steps from scan-end group `first` on, then counts
    the host syncs of the next one (torch's sync debug mode, and the
    program's own by site from the tracer's `sync.<site>` counters)."""
    import torch

    from fastlivo_tpu_torch import run
    from fastlivo_tpu_torch.models.pipeline import LivoPipeline
    from fastlivo_tpu_torch.utils import timing

    pipe = LivoPipeline(cfg, device=device)
    kernels, knn_us, n_scans, syncs = {}, 0.0, 0, None
    for item in run.replay(log, cfg, pipe, timing.StageTimer()):
        if item is None:
            continue
        group, scan_input, t_abs = item
        if not group.is_lidar_end:
            pipe.process_image(scan_input, group.measures[-1].img.img, t_abs)
            continue
        n_scans += 1
        step = lambda: pipe.process_scan(scan_input, t_abs)  # noqa: E731
        if first <= n_scans < first + n_prof:
            got, us = profile_call(step)
            knn_us += us
            for k, (t, n) in got.items():
                kernels[k] = (kernels.get(k, (0.0, 0))[0] + t, kernels.get(k, (0.0, 0))[1] + n)
        elif n_scans == first + n_prof:
            before = timing.counters()
            syncs = count_call_syncs(step)
            sites = {k: v for k, v in timing.counter_delta(timing.counters(), before).items()
                     if k.startswith("sync.")}
            break
        else:
            step()
    if syncs is None or len(pipe.n_effective) < n_prof + 1:
        raise AssertionError(f"CLI profile: the log ended before LIO step {first + n_prof}")
    torch.cuda.synchronize()
    device_us = sum(t for t, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: kv[1][0], reverse=True)[:12]
    return dict(
        lio_steps=n_prof, first_scan=first,
        device_ms_per_step=device_us / 1e3 / n_prof,
        kernels_per_step=sum(n for _, n in kernels.values()) / n_prof,
        knn_device_ms_per_step=knn_us / 1e3 / n_prof,
        knn_share=knn_us / device_us if device_us else None,
        host_syncs_per_step=syncs,
        program_syncs_per_step=sites,
        top_kernels=[dict(name=k[:90], calls=n, device_ms=t / 1e3) for k, (t, n) in top],
    )


def phase_cli(device, log_dir, sizes=None, extra=None):
    """`run.run_log` on a generated log with the shipped avia_livo.yaml
    (the CLI's path), launch counts reset just before and read just after;
    its outputs read back and gated; a second run of the first
    CLI_REPEAT_SCANS scans must write the same tum.txt rows bit for bit; a
    profile of two LIO steps; and a LIO-only VGICP run of 20 scans."""
    import torch

    from fastlivo_tpu_torch import run

    log = os.path.join(log_dir, "cli.flvo")
    t0 = time.perf_counter()
    params = write_cli_log(log, device, **(sizes or {}))
    log_s = time.perf_counter() - t0
    out = {}

    reset_launches()
    main_dir = os.path.join(log_dir, "main")
    t0 = time.perf_counter()
    pipe = run.run_log(log, cli_config(extra), out_dir=main_dir, progress=False, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_launches()
    ate, n_poses, n_map = check_cli_run(pipe, main_dir, frames=True)
    # After the warm-up every scan-end group is an update and every frame
    # one VIO step: the last stages of each kind are the updates.
    n_lio, n_vio = len(pipe.n_effective), len(pipe.n_selected)
    lio_ms = pipe.timer.device_ms("lio_step")[-n_lio:]
    vio_ms = pipe.timer.device_ms("vio_step")[-n_vio:]
    n_scan_groups = len(pipe.timer.samples["lio_step"])
    out["main"] = dict(
        log=dict(params, seconds=log_s),
        scans=n_scan_groups, lio_updates=n_lio, vio_updates=n_vio,
        health=pipe.health, ate_m=ate, poses=n_poses, map_points=n_map,
        n_effective_min=min(pipe.n_effective), n_selected=pipe.n_selected,
        lio_step_ms=float(np.median(lio_ms)) if lio_ms else None,
        vio_step_ms=float(np.median(vio_ms)) if vio_ms else None,
        wall_ms_per_scan=wall_s * 1e3 / max(n_scan_groups, 1),
        launches=launches,
        patch_sample_per_frame=launches["patch_sample"] / max(n_vio, 1),
    )

    rep_dir = os.path.join(log_dir, "repeat")
    run.run_log(log, cli_config(extra), out_dir=rep_dir, max_scans=CLI_REPEAT_SCANS,
                progress=False, device=device)
    with open(os.path.join(rep_dir, "tum.txt"), "rb") as f:
        rep = f.read().splitlines(keepends=True)
    with open(os.path.join(main_dir, "tum.txt"), "rb") as f:
        full = f.read().splitlines(keepends=True)
    if not rep or rep != full[: len(rep)]:
        raise AssertionError("CLI repeat: tum.txt of the first scans differs from the full run's")
    out["repeat"] = dict(scans=CLI_REPEAT_SCANS, poses=len(rep), identical=True)

    if device.type == "cuda":
        prof = cli_profile(log, cli_config(extra), device)
        prof["device_idle_share"] = 1.0 - prof["device_ms_per_step"] / out["main"]["lio_step_ms"]
        out["profile"] = prof

    vg_dir = os.path.join(log_dir, "vgicp")
    vg_cfg = cli_config({**(extra or {}), "lio.measurement_model": "vgicp", "vio.img_enable": 0})
    t0 = time.perf_counter()
    vg = run.run_log(log, vg_cfg, out_dir=vg_dir, max_scans=CLI_REPEAT_SCANS, progress=False,
                     device=device)
    vg_ate, vg_poses, _ = check_cli_run(vg, vg_dir)
    vg_ms = vg.timer.device_ms("lio_step")[-len(vg.n_effective):]
    out["vgicp"] = dict(
        scans=CLI_REPEAT_SCANS, lio_updates=len(vg.n_effective), health=vg.health,
        ate_m=vg_ate, poses=vg_poses, n_effective_min=min(vg.n_effective),
        lio_step_ms=float(np.median(vg_ms)) if vg_ms else None,
        wall_s=time.perf_counter() - t0,
    )
    return out


# ---------------------------------------------------------------------------
# Phase 5: the full-stack back end (STD loop closure, GNSS, the learned
# visual gate, map re-anchoring) on one street circuit.
# ---------------------------------------------------------------------------

STREET_LOG = dict(imu_rate=200.0, scan_rate=10.0, seed=11, max_range=12.0,
                  gyro_bias=(0.0, 0.0, 0.01), imu_noise_gyr=0.03)
LOOP_CONFIG = "configs/urbannav_loop.yaml"
GNSS_CONFIG = "configs/mars_lvig_gnss.yaml"
LOOP_PTS = 64000  # a Hesai XT32's 640k points/s at 10 Hz
GNSS_PTS = 24000  # a Livox Avia's 240k points/s at 10 Hz
GNSS_CAMERA = (1280, 1024, 1293.57, 1293.48, 626.91, 522.799)  # mars_lvig_gnss.yaml
GNSS_OUTAGE_S = 8.0  # samples only before this (the kitchen sink's urban canyon)
# 5a drives three laps and a revisit. The shipped skip_near_num holds back
# the last 50 key clouds (of 10 scans, one a second), so nothing is
# searched before 50 s. The third lap then finds first-lap clouds 4-8 m
# back along the street (the same place is 47 clouds back); on an H100
# the 7 loops of a 60 s log left the corrected keyframe ATE above the
# odometry's (11.9 against 11.4 cm). From 72 s the fourth lap revisits
# first-lap places 70 clouds back, and those loops correct the drift.
LOOP_LOG_S = 80.0
# 5b drives 5 s past the 26 s lap: in 26 s the revisit covers only the
# first 3 m of the lap, and the STD candidates it draws are lap-1 key
# clouds 9 m further down the street, whose views the learned gate rightly
# rejects (match ratios 0.02-0.14 at 1280x1024). By 31 s the revisit has
# reached those places (x = 9.5 m at 29 s).
GNSS_LOG_S = 31.0
# The kitchen sink's loop settings (tests/test_kitchen_sink.py:79-86).
KITCHEN_LOOP = {
    "loop.loop_en": True, "loop.background": True, "loop.sub_frame_num": 5,
    "loop.skip_near_num": 12, "loop.corner_thre": 6.0, "loop.icp_threshold": 0.25,
    "loop.visual_verify_en": True, "keyframe.trans_thresh_m": 1.0,
}
STREET_ATE_M = 0.10
F32_PEAK_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores (data sheet)


def write_street_log(path, device, pts_per_scan, duration, camera=None):
    """The phase's circuit log (STREET_LOG for `duration` seconds), frames
    rendered on `device` when a camera is given, written with logio.
    Returns (sequence, params)."""
    from fastlivo_tpu_torch.io import logio, synthetic
    from fastlivo_tpu_torch.ops.camera import Pinhole

    params = dict(STREET_LOG, pts_per_scan=pts_per_scan, duration=duration)
    kw = dict(params, gyro_bias=np.asarray(params["gyro_bias"]), trajectory=synthetic.circuit_trajectory())
    if camera is not None:
        kw.update(camera=Pinhole(*camera), cam_rate=10.0, cam_offset=0.055, device=device)
        params.update(camera=list(camera), cam_rate=10.0, cam_offset=0.055)
    seq = synthetic.generate_street(**kw)
    logio.write_sequence(path, seq)
    return seq, params


def circuit_ate(stamps, pos):
    """ATE (m, no alignment) against the circuit's analytic trajectory."""
    from fastlivo_tpu_torch.io import synthetic
    from fastlivo_tpu_torch.utils.metrics import ate_rmse

    traj = synthetic.circuit_trajectory()
    gt = np.stack([traj.pos_fn(t) for t in stamps])
    return float(ate_rmse(np.asarray(pos), gt))


def loop_report(pipe):
    """Keyframe ATEs (odometry and loop-corrected) and the back end's
    counters."""
    be = pipe.loop_backend
    g = be.graph
    _, trans_c = be.corrected_trajectory()
    return dict(
        keyframes=len(g.stamps), std_frames=len(be._std_frame_kf), loops=len(be.loops),
        loop_pairs=[(e.kf_from, e.kf_to, e.score) for e in be.loops],
        rejected_loops=[(a, b, float(r)) for a, b, r in be.rejected_loops],
        kf_ate_odometry_m=circuit_ate(g.stamps, g.trans),
        kf_ate_corrected_m=circuit_ate(g.stamps, trans_c),
        key_cloud_points_median=float(np.median(be.key_cloud_sizes)) if be.key_cloud_sizes else None,
        std_detect_host_ms_median=float(np.median(be.detect_s)) * 1e3 if be.detect_s else None,
        std_detect_host_ms_all=[s * 1e3 for s in be.detect_s],
        match_ms=[s * 1e3 for s in be.match_s], match_ratios=be.match_ratios,
        matcher=type(be._matcher).__name__ if be._matcher is not None else None,
    )


def time_fit_voxel_planes(pipe, n_points, device):
    """Device ms of `fit_voxel_planes` (CUDA events, median of 10 after 2)
    on n_points of the final map: the STD stage that runs on the card."""
    import torch

    from fastlivo_tpu_torch.backend import std_loop
    from fastlivo_tpu_torch.io import export

    cloud = export.map_to_cloud(pipe.map)
    pick = np.random.default_rng(0).permutation(len(cloud))[: int(n_points)]
    pts = torch.as_tensor(cloud[pick].astype(np.float32)).to(device)
    mask = torch.ones(len(pts), dtype=torch.bool, device=device)
    cfg = pipe.loop_backend.std_cfg

    def fit():
        return std_loop.fit_voxel_planes(pts, mask, cfg.voxel_size, cfg.max_planes,
                                         cfg.voxel_init_num, cfg.plane_detection_thre)

    return cuda_median_ms(fit), len(pts)


def cuda_median_ms(fn, reps=10, warmup=2):
    """Median CUDA-event ms of `fn` over `reps` calls after `warmup`."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def run_street(log, cfg, out_dir, device):
    """`run.run_log` with every launch counter reset just before and read
    just after; returns (pipe, launches, wall seconds)."""
    import torch

    from fastlivo_tpu_torch import run

    reset_launches()
    t0 = time.perf_counter()
    pipe = run.run_log(log, cfg, out_dir=out_dir, progress=False, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return pipe, read_launches(), wall


def check_street_run(pipe, out_dir, name, loop_files=True):
    """Shared gates: no rejection, outputs read back; returns (ATE, poses)."""
    from fastlivo_tpu_torch.io import export

    if pipe.health["rejected"]:
        raise AssertionError(f"{name}: {pipe.health['rejected']} LIO updates rejected")
    if not pipe.n_effective:
        raise AssertionError(f"{name}: no LIO update ran")
    stamps, pos, quat = export.read_tum(os.path.join(out_dir, "tum.txt"))
    if not (np.all(np.isfinite(pos)) and np.all(np.isfinite(quat))):
        raise AssertionError(f"{name}: non-finite poses in tum.txt")
    for f in ("loop_tum.txt", "map.pcd") if loop_files else ("map.pcd",):
        if not os.path.exists(os.path.join(out_dir, f)):
            raise AssertionError(f"{name}: {f} not written")
    return circuit_ate(stamps, pos), len(stamps)


def step_times(pipe, wall_s):
    n_lio, n_vio = len(pipe.n_effective), len(pipe.n_selected)
    lio_ms = pipe.timer.device_ms("lio_step")[-n_lio:] if n_lio else []
    vio_ms = pipe.timer.device_ms("vio_step")[-n_vio:] if n_vio else []
    n_groups = len(pipe.timer.samples["lio_step"])
    return dict(
        scans=n_groups, lio_updates=n_lio, vio_updates=n_vio,
        lio_step_ms=float(np.median(lio_ms)) if lio_ms else None,
        vio_step_ms=float(np.median(vio_ms)) if vio_ms else None,
        wall_ms_per_scan=wall_s * 1e3 / max(n_groups, 1),
    )


def phase_loop(device, log_dir):
    """5a: configs/urbannav_loop.yaml as shipped (point-to-plane LIO, STD
    loop closure, no camera) through `run.run_log` on the circuit log.
    Gates: no rejected update, a loop, the corrected keyframe ATE below the
    odometry keyframe ATE, reanchor_map() applies, the map keeps more than
    half its occupied voxels and only finite points."""
    import torch

    from fastlivo_tpu_torch.maps import voxel_map as vm
    from fastlivo_tpu_torch.utils.config import load_config

    log = os.path.join(log_dir, "street_loop.flvo")
    t0 = time.perf_counter()
    _, params = write_street_log(log, device, LOOP_PTS, LOOP_LOG_S)
    log_s = time.perf_counter() - t0
    overrides = cli_rig_overrides()
    out_dir = os.path.join(log_dir, "loop")
    pipe, launches, wall = run_street(log, load_config(LOOP_CONFIG, overrides), out_dir, device)
    ate, n_poses = check_street_run(pipe, out_dir, "5a")
    rep = loop_report(pipe)
    rep["candidate_stamps"] = std_pair_stamps(pipe.loop_backend)
    failed = [msg for bad, msg in (
        (rep["loops"] < 1, f"no loop detected ({rep['std_frames']} STD frames)"),
        (not rep["kf_ate_corrected_m"] < rep["kf_ate_odometry_m"],
         f"corrected keyframe ATE {rep['kf_ate_corrected_m']:.4f} m not below "
         f"odometry {rep['kf_ate_odometry_m']:.4f} m"),
    ) if bad]
    if failed:
        print(json.dumps({"phase5a_failed": dict(ate_m=ate, log=params, **step_times(pipe, wall), **rep)},
                         default=str), flush=True)
        raise AssertionError("5a: " + "; ".join(failed))
    occ_before = int(vm.num_occupied(pipe.map))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    applied = pipe.reanchor_map()
    torch.cuda.synchronize()
    reanchor_ms = (time.perf_counter() - t0) * 1e3
    occ_after = int(vm.num_occupied(pipe.map))
    if not applied:
        raise AssertionError("5a: reanchor_map() applied no correction")
    if not occ_after > 0.5 * occ_before:
        raise AssertionError(f"5a: reanchor kept {occ_after} of {occ_before} occupied voxels")
    if not bool(torch.all(torch.isfinite(pipe.map.points))):
        raise AssertionError("5a: non-finite map points after reanchor")
    cap = pipe.step_cfg.map_cfg
    out = dict(
        config=LOOP_CONFIG, overrides={k: str(v) for k, v in overrides.items()},
        log=dict(params, seconds=log_s), health=pipe.health, ate_m=ate, poses=n_poses,
        **step_times(pipe, wall), **rep,
        reanchor_ms=reanchor_ms, reanchor_chunks=-(-(cap.capacity * cap.max_points) // 65536),
        occupied_before=occ_before, occupied_after=occ_after, launches=launches,
    )
    out["std_fit_device_ms"], out["std_fit_points"] = time_fit_voxel_planes(
        pipe, rep["key_cloud_points_median"] or 1, device
    )
    out["profile"] = cli_profile(log, load_config(LOOP_CONFIG, overrides), device)
    out["profile"]["device_idle_share"] = 1.0 - out["profile"]["device_ms_per_step"] / out["lio_step_ms"]
    return out


def std_pair_stamps(be):
    """Keyframe stamps of every loop and every rejected candidate:
    (stamp of the matched frame, stamp of the current frame, match ratio
    or, for a rejected pose check, minus the angle; None for a loop)."""
    st = be.graph.stamps
    out = [(st[e.kf_from], st[e.kf_to], None) for e in be.loops]
    out += [(st[be._std_frame_kf[f]], st[k], r) for f, k, r in be.rejected_loops]
    return out


def write_rtk(path, seq):
    """The GNSS stream of the log (5 Hz, 0.05 m noise, on the log's time
    base) up to the outage, as an RTK result file."""
    from fastlivo_tpu_torch.io import synthetic
    from fastlivo_tpu_torch.models import gnss

    samples = [s for s in synthetic.generate_gnss(seq, rate=5.0, seed=3, t_unix0=0.0, noise_m=0.05)
               if s.time < GNSS_OUTAGE_S]
    gnss.write_rtk_file(path, samples)
    return len(samples)


def phase_gnss(device, log_dir):
    """5b: configs/mars_lvig_gnss.yaml (GNSS + LIVO at 1280x1024) with the
    loop back end and its learned visual gate on. Gates: GNSS initialises
    and goes into an update, no rejected update, ATE < 0.10 m, the gate
    runs SuperPointLightGlue and passes a loop, patch_sample launches."""
    from fastlivo_tpu_torch.backend import visual_verify as vv
    from fastlivo_tpu_torch.utils.config import load_config

    log = os.path.join(log_dir, "street_gnss.flvo")
    t0 = time.perf_counter()
    seq, params = write_street_log(log, device, GNSS_PTS, GNSS_LOG_S, GNSS_CAMERA)
    rtk = os.path.join(log_dir, "rtk.txt")
    n_rtk = write_rtk(rtk, seq)
    log_s = time.perf_counter() - t0
    # The rig, the RTK file and the kitchen sink's loop and gate settings.
    overrides = {**cli_rig_overrides(), "gnss.rtk_file": rtk, **KITCHEN_LOOP}
    out_dir = os.path.join(log_dir, "gnss")
    pipe, launches, wall = run_street(log, load_config(GNSS_CONFIG, overrides), out_dir, device)
    ate, n_poses = check_street_run(pipe, out_dir, "5b")
    rep = loop_report(pipe)
    rep["candidate_stamps"] = std_pair_stamps(pipe.loop_backend)
    be = pipe.loop_backend
    passed = sum(r >= be.match_ratio_thresh for r in be.match_ratios)
    failed = [msg for bad, msg in (
        (not pipe.gnss.initialized or pipe.gnss_blocks < 1,
         f"GNSS initialized={pipe.gnss.initialized}, blocks={pipe.gnss_blocks}"),
        (ate >= STREET_ATE_M, f"ATE {ate:.4f} m"),
        (not isinstance(be._matcher, vv.SuperPointLightGlue) or not be.match_s,
         f"the learned gate did not run (matcher {rep['matcher']})"),
        (passed < 1 or not be.loops, f"no loop passed the gate ({len(be.loops)} loops)"),
        (launches["patch_sample"] <= 0, "patch_sample was never launched"),
    ) if bad]
    if failed:
        print(json.dumps({"phase5b_failed": dict(ate_m=ate, gnss_blocks=pipe.gnss_blocks, **rep)},
                         default=str), flush=True)
        raise AssertionError("5b: " + "; ".join(failed))
    out = dict(
        config=GNSS_CONFIG, overrides={k: str(v) for k, v in overrides.items()},
        log=dict(params, seconds=log_s, rtk_samples=n_rtk), health=pipe.health, ate_m=ate,
        poses=n_poses, gnss_initialized=pipe.gnss.initialized, gnss_blocks=pipe.gnss_blocks,
        gnss_yaw_rad=float(np.arctan2(pipe.gnss.rot_we[1, 0], pipe.gnss.rot_we[0, 0])),
        **step_times(pipe, wall), **rep, gate_passed=passed, launches=launches,
        patch_sample_per_frame=launches["patch_sample"] / max(len(pipe.n_selected), 1),
    )
    out["profile"] = cli_profile(log, load_config(GNSS_CONFIG, overrides), device)
    out["profile"]["device_idle_share"] = 1.0 - out["profile"]["device_ms_per_step"] / out["lio_step_ms"]
    return out, seq


def superpoint_flops(h, w):
    """Multiply-adds x 2 of one SuperPoint pass at (h, w), from the shapes:
    each convolution at its resolution, cout x cin x k^2 per output pixel."""
    from fastlivo_tpu_torch.backend.superpoint_lightglue import _CONVS

    scale = {"conv1": 1, "conv2": 2, "conv3": 4, "conv4": 8, "convP": 8, "convD": 8}
    total = 0
    for name, cin, cout, k in _CONVS:
        s = scale[name[:5]]
        total += 2 * (h // s) * (w // s) * cin * cout * k * k
    return total


def lightglue_flops(n0, n1, n_layers, d=256):
    """Products of one LightGlue pass (per attention block: q/k/v/o
    projections, scores and messages, the two-layer MLP; two self and two
    cross blocks per layer), plus the final projections and similarity."""
    def block(nq, nk):
        proj = 2 * nq * d * d * 2 + 2 * nk * d * d * 2  # q, o / k, v
        att = 2 * nq * nk * d * 2  # scores + messages
        mlp = 2 * nq * (2 * d) * (2 * d) + 2 * nq * (2 * d) * d
        return proj + att + mlp

    per_layer = block(n0, n0) + block(n1, n1) + block(n0, n1) + block(n1, n0)
    return n_layers * per_layer + 2 * (n0 + n1) * d * d + 2 * n0 * n1 * d


def street_pairs(seq):
    """(revisit pair, distant pair) of the log's frames: the last frame and
    the first-lap frame nearest to it in position and heading; the same
    first-lap frame and the frame half a lap away."""
    from fastlivo_tpu_torch.io import synthetic

    traj = synthetic.circuit_trajectory()
    stamps = np.array([f.stamp for f in seq.frames])
    last = len(stamps) - 1
    p_last = traj.pos_fn(stamps[last])
    lap1 = np.nonzero((stamps > 1.0) & (stamps < 12.0))[0]
    near = lap1[np.argmin([np.linalg.norm(traj.pos_fn(stamps[i]) - p_last) for i in lap1])]
    far = int(np.argmin(np.abs(stamps - (stamps[near] + 12.0))))
    return (int(near), last), (int(near), far)


def phase_matcher(device, seq, reps=10, warmup=2):
    """5c: one SuperPointLightGlue.match with the committed weights on two
    full-width frames of the 5b log: CUDA-event times (median of `reps`
    after `warmup`) split into SuperPoint x2, LightGlue and the host
    readback; FLOPs from the shapes and the share of the f32 peak; the card
    against the port on the CPU (score map and dense descriptors within
    1e-3, identical keypoints and match sets); the revisit pair passes
    `verify_loop` and the distant pair fails it."""
    import torch

    from fastlivo_tpu_torch.backend import superpoint_lightglue as spl
    from fastlivo_tpu_torch.backend import visual_verify as vv

    (i0, i1), (j0, j1) = street_pairs(seq)
    imgs = [seq.frames[i].img for i in (i0, i1, j0, j1)]
    m_gpu = vv.default_matcher(device=device)
    impl = m_gpu._impl
    a, b = impl.prepare(imgs[0], imgs[1])

    def split_once():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        with torch.no_grad():
            ev[0].record()
            k0, d0, v0 = spl.extract_keypoints(impl.sp, a, impl.max_keypoints)
            ev[1].record()
            k1, d1, v1 = spl.extract_keypoints(impl.sp, b, impl.max_keypoints)
            ev[2].record()
            size = torch.tensor([a.shape[1], a.shape[0]], dtype=torch.float32, device=a.device)
            p, _, _ = spl.lightglue_forward(impl.lg, k0, d0, v0, k1, d1, v1, size)
            ev[3].record()
            res = impl.select(k0, v0, k1, v1, p)
            ev[4].record()
        torch.cuda.synchronize()
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(4)], res, int(v0.sum()), int(v1.sum())

    for _ in range(warmup):
        split_once()
    rows = [split_once() for _ in range(reps)]
    times = np.array([r[0] for r in rows])
    med = np.median(times, axis=0)
    total = cuda_median_ms(lambda: impl.match(imgs[0], imgs[1]), reps=reps, warmup=warmup)
    h, w = a.shape
    n0, n1 = rows[-1][2], rows[-1][3]
    sp_flops = superpoint_flops(h, w)
    lg_flops = lightglue_flops(impl.max_keypoints, impl.max_keypoints, impl.n_layers)
    device_ms = float(med[0] + med[1] + med[2])

    cpu = vv.default_matcher(device="cpu")
    comp = matcher_card_vs_cpu(device, images=imgs[:2], gpu=m_gpu, cpu=cpu)
    ok_rev, res_rev = vv.verify_loop(imgs[0], imgs[1], m_gpu)
    ok_far, res_far = vv.verify_loop(imgs[2], imgs[3], m_gpu)
    if comp["score_max_abs_err"] >= 1e-3 or comp["desc_max_abs_err"] >= 1e-3:
        raise AssertionError(f"5c: card vs CPU {comp}")
    if not (comp["keypoints_equal"] and comp["matches_equal"]):
        raise AssertionError(f"5c: card and CPU keypoints or matches differ: {comp}")
    if not ok_rev or ok_far:
        raise AssertionError(
            f"5c: revisit ratio {res_rev.match_ratio:.3f} (pass {ok_rev}), "
            f"distant {res_far.match_ratio:.3f} (pass {ok_far})"
        )
    return dict(
        image=[h, w], frames=dict(revisit=[i0, i1], distant=[j0, j1]),
        keypoints_valid=[n0, n1], layers=impl.n_layers, max_keypoints=impl.max_keypoints,
        superpoint_ms=[float(med[0]), float(med[1])], lightglue_ms=float(med[2]),
        host_readback_ms=float(med[3]), match_ms=total,
        flops=dict(superpoint_per_pass=sp_flops, lightglue=lg_flops, total=2 * sp_flops + lg_flops),
        f32_peak_share=(2 * sp_flops + lg_flops) / (device_ms * 1e-3) / F32_PEAK_FLOPS,
        superpoint_f32_peak_share=sp_flops / (float(med[0]) * 1e-3) / F32_PEAK_FLOPS,
        bound_ms=(2 * sp_flops + lg_flops) / F32_PEAK_FLOPS * 1e3,
        card_vs_cpu=comp, revisit_ratio=res_rev.match_ratio, distant_ratio=res_far.match_ratio,
    )


def matcher_card_vs_cpu(device, images=None, gpu=None, cpu=None, width=None, height=None):
    """The committed matcher on the card and on the CPU at the same inputs:
    score map and dense descriptor errors, keypoints and match sets. Without
    `images`, a street frame pair at (width, height) is rendered."""
    import torch

    from fastlivo_tpu_torch.backend import superpoint_lightglue as spl
    from fastlivo_tpu_torch.backend import visual_verify as vv

    if images is None:
        images = street_frames(device, width, height)
    gpu = gpu or vv.default_matcher(device=device)
    cpu = cpu or vv.default_matcher(device="cpu")
    ga, gb = gpu._impl.prepare(*images)
    ca, cb = cpu._impl.prepare(*images)
    with torch.no_grad():
        gs, gd = spl.superpoint_forward(gpu._impl.sp, ga)
        cs, cd = spl.superpoint_forward(cpu._impl.sp, ca)
        gk = spl.extract_keypoints(gpu._impl.sp, ga, gpu._impl.max_keypoints)
        ck = spl.extract_keypoints(cpu._impl.sp, ca, cpu._impl.max_keypoints)
    rg, rc = gpu.match(*images), cpu.match(*images)
    # Keypoints come in score order, and two scores a rounding apart may
    # swap places between the devices: compare the sets.
    kg = rows_set(gk[0].cpu().numpy()[gk[2].cpu().numpy()])
    kc = rows_set(ck[0].numpy()[ck[2].numpy()])
    mg = rows_set(np.concatenate([rg.pts1, rg.pts2], axis=1))
    mc = rows_set(np.concatenate([rc.pts1, rc.pts2], axis=1))
    return dict(
        score_max_abs_err=float((gs.cpu() - cs).abs().max()),
        desc_max_abs_err=float((gd.cpu() - cd).abs().max()),
        keypoints_equal=kg == kc, keypoints_differing=len(kg ^ kc),
        keypoints_same_order=bool(torch.equal(gk[0].cpu(), ck[0])),
        matches_equal=mg == mc, matches_differing=len(mg ^ mc),
        matches=len(rg.pts1), n_keypoints=rg.n_keypoints,
    )


def rows_set(a):
    return set(map(tuple, np.asarray(a).tolist()))


def street_frames(device, width, height):
    """Two street frames a short way apart along the circuit's first
    straight (a revisit-like pair), rendered on `device`."""
    import torch

    from fastlivo_tpu_torch.io import render, synthetic
    from fastlivo_tpu_torch.ops.camera import Pinhole

    cam = Pinhole(width, height, 0.8 * width, 0.8 * width, width / 2 - 0.5, height / 2 - 0.5)
    boxes = torch.as_tensor(synthetic.street_boxes()).to(device)
    rot_ci = synthetic.R_IC_FORWARD.T
    out = []
    for x in (2.0, 2.4):
        rcw = rot_ci.astype(np.float32)
        pcw = (-rcw @ np.array([x, 0.1, 0.0])).astype(np.float32)
        img = render.render_street(cam, torch.as_tensor(rcw).to(device), torch.as_tensor(pcw).to(device), boxes)
        out.append(img.cpu().numpy())
    return out


# ---------------------------------------------------------------------------
# Phase 6: a recorded bag through the converter and the CLI. The phase
# writes its bags itself (the JAX package has no bag writer): ROS bag V2.0,
# chunked, with the ROS1 wire format of sensor_msgs/Imu, sensor_msgs/Image
# and livox_ros_driver/CustomMsg.
# ---------------------------------------------------------------------------

BAG_TOPICS = dict(lidar="/livox/lidar", imu="/livox/imu", img="/left_camera/image")
BAG_CHUNK_BYTES = 768 * 1024  # rosbag record's default chunk threshold
BAG_CODEC_S = 2.0  # 6b rewrites this much of the bag with lz4 and bz2 chunks
FEATURE_SCANS = 20  # 6d: scan-end groups with feature selection
FEATURE_S = 3.0  # 6d: seconds of the 6a bag rewritten with ring sweeps
FEATURE_RINGS, FEATURE_PER_RING = 16, 1500  # 24,000 points per sweep, as 6a's
FEATURE_KEPT_MIN = 0.5  # 6d: least share of each scan that the selection keeps
COLOR_TOL = 1e-4  # 6e: card against CPU, intensity units
_U32 = struct.Struct("<I")
_CUSTOM_POINT = np.dtype([
    ("offset_time", "<u4"), ("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
    ("reflectivity", "u1"), ("tag", "u1"), ("line", "u1"),
])


def ros_stamp(t):
    """(secs, nsecs) of a time in seconds."""
    secs = int(math.floor(t))
    nsecs = int(round((t - secs) * 1e9))
    if nsecs >= 1_000_000_000:
        secs, nsecs = secs + 1, nsecs - 1_000_000_000
    return secs, nsecs


def _ros_header(t, frame):
    f = frame.encode()
    return struct.pack("<III", 0, *ros_stamp(t)) + _U32.pack(len(f)) + f


def ros_imu(s):
    """sensor_msgs/Imu: header, orientation and covariances zero."""
    zero9 = bytes(72)
    return (_ros_header(s.stamp, "imu") + struct.pack("<4d", 0.0, 0.0, 0.0, 1.0) + zero9
            + np.asarray(s.gyr, "<f8").tobytes() + zero9 + np.asarray(s.acc, "<f8").tobytes() + zero9)


def ros_livox(scan, rng):
    """livox_ros_driver/CustomMsg of a sweep: timebase = the header stamp in
    ns, offset_time in ns, tag 0x10, lines 0-5 in turn."""
    n = len(scan.pts)
    rec = np.zeros(n, _CUSTOM_POINT)
    rec["offset_time"] = np.round(scan.t_offs_ms.astype(np.float64) * 1e6).astype(np.uint32)
    rec["x"], rec["y"], rec["z"] = scan.pts[:, 0], scan.pts[:, 1], scan.pts[:, 2]
    rec["reflectivity"] = rng.integers(0, 256, n)
    rec["tag"] = 0x10
    rec["line"] = np.arange(n) % 6
    secs, nsecs = ros_stamp(scan.stamp)
    return (_ros_header(scan.stamp, "livox_frame") + struct.pack("<QI", secs * 1_000_000_000 + nsecs, n)
            + bytes(4) + _U32.pack(n) + rec.tobytes())


def ros_mono8(frame):
    """sensor_msgs/Image, mono8, the frame clipped and truncated to u8 as
    logio.LogWriter stores it."""
    img = np.clip(np.asarray(frame.img), 0, 255).astype(np.uint8)
    h, w = img.shape
    enc = b"mono8"
    return (_ros_header(frame.stamp, "camera") + struct.pack("<II", h, w) + _U32.pack(len(enc)) + enc
            + b"\x00" + struct.pack("<II", w, h * w) + img.tobytes())


def bag_messages(seq, rng):
    """The sequence's records as (topic, type, bag time, raw message) in
    logio.write_sequence's order (by stamp; IMU, LiDAR, image on ties)."""
    msgs = [(s.stamp, 0, BAG_TOPICS["imu"], "sensor_msgs/Imu", ros_imu(s)) for s in seq.imu]
    msgs += [(s.stamp, 1, BAG_TOPICS["lidar"], "livox_ros_driver/CustomMsg", ros_livox(s, rng))
             for s in seq.scans]
    msgs += [(f.stamp, 2, BAG_TOPICS["img"], "sensor_msgs/Image", ros_mono8(f)) for f in seq.frames]
    msgs.sort(key=lambda m: (m[0], m[1]))
    return [(topic, typ, t, raw) for t, _, topic, typ, raw in msgs]


def _bag_fields(fields):
    return b"".join(_U32.pack(len(k) + 1 + len(v)) + k + b"=" + v for k, v in fields.items())


def _bag_record(fields, data):
    h = _bag_fields(fields)
    return _U32.pack(len(h)) + h + _U32.pack(len(data)) + data


def write_bag(path, messages, compression="none"):
    """A ROS bag V2.0: the magic line, the bag header record, then chunk
    records of about BAG_CHUNK_BYTES, each compressed with `compression`
    (none, bz2, or lz4 through the port's io.lz4f), holding each topic's
    connection record before its first message and the message records
    (record time: u32 secs, then u32 nsecs). No index records: the reader
    streams the chunks. Returns the compressed chunk payloads, the raw
    chunk bytes and the compression seconds."""
    from fastlivo_tpu_torch.io import lz4f

    conns, chunks, buf = {}, [], bytearray()
    for topic, msg_type, t, raw in messages:
        if topic not in conns:
            conns[topic] = len(conns)
            buf += _bag_record(
                {b"op": b"\x07", b"conn": _U32.pack(conns[topic]), b"topic": topic.encode()},
                _bag_fields({b"topic": topic.encode(), b"type": msg_type.encode(), b"md5sum": b"*",
                             b"message_definition": b""}),
            )
        buf += _bag_record(
            {b"op": b"\x02", b"conn": _U32.pack(conns[topic]), b"time": struct.pack("<II", *ros_stamp(t))},
            raw,
        )
        if len(buf) >= BAG_CHUNK_BYTES:
            chunks.append(bytes(buf))
            buf = bytearray()
    if buf:
        chunks.append(bytes(buf))
    codec = {"none": lambda b: b, "bz2": bz2.compress, "lz4": lz4f.compress}[compression]
    t0 = time.perf_counter()
    packed = [codec(c) for c in chunks]
    compress_s = time.perf_counter() - t0
    with open(path, "wb") as f:
        f.write(b"#ROSBAG V2.0\n")
        f.write(_bag_record({b"op": b"\x03", b"index_pos": struct.pack("<Q", 0),
                             b"conn_count": _U32.pack(len(conns)), b"chunk_count": _U32.pack(len(chunks))}, b""))
        for raw, data in zip(chunks, packed):
            f.write(_bag_record({b"op": b"\x05", b"compression": compression.encode(),
                                 b"size": _U32.pack(len(raw))}, data))
    return dict(chunks=packed, raw_bytes=sum(map(len, chunks)), compress_s=compress_s)


def convert_bag(bag, log):
    """The port's bag_to_flvo with the CLI's defaults (lidar type 1, default
    LidarParams); returns (counts, seconds)."""
    from fastlivo_tpu_torch.io import rosbag

    t0 = time.perf_counter()
    counts = rosbag.bag_to_flvo(bag, log, BAG_TOPICS["lidar"], BAG_TOPICS["imu"], BAG_TOPICS["img"],
                                lidar_type=1)
    return counts, time.perf_counter() - t0


def same_records(a, b, what):
    """Two decoded record lists are equal bit for bit; returns their length."""
    if len(a) != len(b):
        raise AssertionError(f"{what}: {len(a)} records against {len(b)}")
    for i, (x, y) in enumerate(zip(a, b)):
        if type(x) is not type(y) or x.stamp != y.stamp:
            raise AssertionError(f"{what}: record {i} differs")
        for name in ("gyr", "acc", "pts", "t_offs_ms", "intensity", "img"):
            xv, yv = getattr(x, name, None), getattr(y, name, None)
            if (xv is None) != (yv is None) or (
                yv is not None and (xv.dtype != yv.dtype or not np.array_equal(xv, yv))
            ):
                raise AssertionError(f"{what}: record {i} {name} differs")
    return len(a)


def decode_both(log, cfg):
    """The log decoded with the config's gates by the native decoder and by
    the NumPy decoder: equal records, and ms per scan of each (the whole
    log's decode over its scans)."""
    from fastlivo_tpu_torch import native
    from fastlivo_tpu_torch.io import logio
    from fastlivo_tpu_torch.io.sensors import LidarScan

    lib = native.get_lib()
    if lib is None:
        raise AssertionError("6a: the native log codec did not build")
    with open(log, "rb") as f:
        buf = f.read()
    gates = (cfg.preprocess.blind, cfg.preprocess.max_range, cfg.preprocess.point_filter_num)
    recs, secs = {}, {}
    for name, fn in (("native", lambda: logio._read_native(memoryview(buf), lib, *gates)),
                     ("numpy", lambda: logio._read_python(memoryview(buf), *gates))):
        t0 = time.perf_counter()
        recs[name] = list(fn())
        secs[name] = time.perf_counter() - t0
    n = same_records(recs["native"], recs["numpy"], "6a native against NumPy decode")
    n_scans = sum(isinstance(r, LidarScan) for r in recs["native"])
    points = [len(r.pts) for r in recs["native"] if isinstance(r, LidarScan)]
    return dict(records=n, scans=n_scans, points_per_scan_median=float(np.median(points)),
                native_ms_per_scan=secs["native"] * 1e3 / n_scans,
                numpy_ms_per_scan=secs["numpy"] * 1e3 / n_scans)


def phase_bag(device, log_dir):
    """6a: the phase-4 room log written as a bag (Avia CustomMsg 24,000
    points per scan, 200 Hz IMU, 640x512 mono8 at 10 Hz, uncompressed
    chunks), converted by the port's bag_to_flvo, decoded both ways, and
    run by run.run_log with configs/avia_livo.yaml at its full widths (rig
    overrides only); launch counts reset just before the run and read just
    after. Then 6b, 6d and 6e on the same bag and log."""
    import torch

    from fastlivo_tpu_torch import run
    from fastlivo_tpu_torch.io import logio, synthetic
    from fastlivo_tpu_torch.ops.camera import Pinhole

    t0 = time.perf_counter()
    seq = synthetic.generate(camera=Pinhole(*CLI_CAMERA), device=device, **CLI_LOG)
    msgs = bag_messages(seq, np.random.default_rng(6))
    gen_s = time.perf_counter() - t0
    bag = os.path.join(log_dir, "avia.bag")
    t0 = time.perf_counter()
    write_bag(bag, msgs)
    write_s = time.perf_counter() - t0
    bag_mb = os.path.getsize(bag) / 1e6
    log = os.path.join(log_dir, "avia.flvo")
    counts, conv_s = convert_bag(bag, log)
    written = dict(imu=len(seq.imu), scans=len(seq.scans), images=len(seq.frames))
    if counts != written:
        raise AssertionError(f"6a: converted {counts}, wrote {written}")
    cfg = cli_config()
    decode = decode_both(log, cfg)

    main_dir = os.path.join(log_dir, "bag_main")
    runs_before = dict(logio.DECODER_RUNS)
    reset_launches()
    t0 = time.perf_counter()
    pipe = run.run_log(log, cfg, out_dir=main_dir, progress=False, device=device)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_launches()
    decoders = {k: logio.DECODER_RUNS[k] - runs_before[k] for k in runs_before}
    if decoders != {"native": 1, "numpy": 0}:
        raise AssertionError(f"6a: the run's log decoders were {decoders}, not the native one")
    ate, n_poses, n_map = check_cli_run(pipe, main_dir, frames=True)
    if launches["patch_sample"] <= 0:
        raise AssertionError("6a: patch_sample was never launched")
    out = {"6a": dict(
        bag_mb=bag_mb, bag_messages=len(msgs), counts=counts, generate_s=gen_s, write_s=write_s,
        convert_s=conv_s, convert_mb_per_s=bag_mb / conv_s, log_mb=os.path.getsize(log) / 1e6,
        decode=decode, decoders=decoders, health=pipe.health, ate_m=ate, poses=n_poses, map_points=n_map,
        n_effective_min=min(pipe.n_effective), **step_times(pipe, wall_s), launches=launches,
        patch_sample_per_frame=launches["patch_sample"] / max(len(pipe.n_selected), 1),
    )}
    print(json.dumps({"phase6a_bag": out["6a"]}), flush=True)
    out["6b"] = phase_bag_codecs(msgs, log_dir)
    del msgs
    out["6d"] = phase_bag_features(seq, device, log_dir)
    out["6e"] = phase_bag_colorize(pipe, seq, device)
    return out


def phase_bag_codecs(msgs, log_dir):
    """6b: the first BAG_CODEC_S seconds of the bag written with
    uncompressed, lz4 and bz2 chunks; each converts to the same log byte for
    byte. Records compression, conversion and lz4 decompression rates."""
    from fastlivo_tpu_torch.io import lz4f

    head = [m for m in msgs if m[2] < BAG_CODEC_S]
    out, logs = {}, {}
    for comp in ("none", "lz4", "bz2"):
        bag = os.path.join(log_dir, f"head_{comp}.bag")
        stats = write_bag(bag, head, comp)
        log = os.path.join(log_dir, f"head_{comp}.flvo")
        counts, conv_s = convert_bag(bag, log)
        with open(log, "rb") as f:
            logs[comp] = f.read()
        out[comp] = dict(bag_mb=os.path.getsize(bag) / 1e6, raw_mb=stats["raw_bytes"] / 1e6,
                         chunks=len(stats["chunks"]), compress_s=stats["compress_s"], convert_s=conv_s,
                         counts=counts)
        if comp == "lz4":
            t0 = time.perf_counter()
            n = sum(len(lz4f.decompress(c)) for c in stats["chunks"])
            dec_s = time.perf_counter() - t0
            out[comp].update(decompress_mb_per_s=n / 1e6 / dec_s,
                             compress_mb_per_s=stats["raw_bytes"] / 1e6 / stats["compress_s"])
    for comp in ("lz4", "bz2"):
        if logs[comp] != logs["none"] or out[comp]["counts"] != out["none"]["counts"]:
            raise AssertionError(f"6b: the {comp} bag converts to another log than the uncompressed one")
    out["identical_logs"] = True
    out["log_mb"] = len(logs["none"]) / 1e6
    return out


def ring_sweep(stamp, rings=FEATURE_RINGS, per_ring=FEATURE_PER_RING, buckets=64, half=10.0, floor_z=-1.5):
    """A 0.1 s sweep of the generator's room (walls at +-half, floor at
    floor_z, no boxes) from `stamp`, ray-cast ring by ring as a spinning
    LiDAR records it: elevations -25..15 deg, azimuth 0..360 deg per ring,
    times evenly over the sweep, each point cast from the pose of its time
    bucket. Consecutive points are neighbours on a surface, so the LOAM
    selection keeps most of them; the generator's own scans shuffle points
    against time."""
    from fastlivo_tpu_torch.io import synthetic
    from fastlivo_tpu_torch.io.sensors import LidarScan

    traj = synthetic.default_trajectory()
    n = rings * per_ring
    elev = np.repeat(np.radians(np.linspace(-25.0, 15.0, rings)), per_ring)
    azim = np.tile(np.linspace(0.0, 2 * np.pi, per_ring, endpoint=False), rings)
    d_body = np.stack([np.cos(elev) * np.cos(azim), np.cos(elev) * np.sin(azim), np.sin(elev)], 1)
    bucket = np.arange(n) * buckets // n
    rng_hit = np.empty(n)
    for b in range(buckets):
        sel = bucket == b
        rot, pos = traj.pose(stamp + (b + 0.5) * 0.1 / buckets)
        d = d_body[sel] @ rot.T
        with np.errstate(divide="ignore"):
            hits = [(np.where(d[:, a] > 0, half, -half) - pos[a]) / d[:, a] for a in (0, 1)]
            hits.append(np.where(d[:, 2] < 0, (floor_z - pos[2]) / d[:, 2], np.inf))
        hits = np.stack(hits)
        rng_hit[sel] = np.where(hits > 0, hits, np.inf).min(axis=0)
    t_offs_ms = (np.arange(n) * (100.0 / n)).astype(np.float32)
    return LidarScan(stamp=stamp, pts=(rng_hit[:, None] * d_body).astype(np.float32), t_offs_ms=t_offs_ms)


def phase_bag_features(seq, device, log_dir):
    """6d: the 6a bag's first FEATURE_S seconds with every sweep replaced by
    a ring sweep (`ring_sweep`, 24,000 points), converted as 6a, then
    FEATURE_SCANS scan-end groups with preprocess.feature_extract_en 1.
    Gates: every scan keeps more than FEATURE_KEPT_MIN of its points, no
    rejected update, n_effective >= min_effective on every update, every
    state finite. Records the share of points kept, classify_features host
    ms per scan and the ATE (not gated)."""
    import types

    import torch

    from fastlivo_tpu_torch import run
    from fastlivo_tpu_torch.io import features, logio
    from fastlivo_tpu_torch.io.sensors import LidarScan

    head = types.SimpleNamespace(
        imu=[s for s in seq.imu if s.stamp < FEATURE_S],
        scans=[ring_sweep(s.stamp) for s in seq.scans if s.stamp < FEATURE_S],
        frames=[f for f in seq.frames if f.stamp < FEATURE_S],
    )
    bag = os.path.join(log_dir, "rings.bag")
    write_bag(bag, bag_messages(head, np.random.default_rng(6)))
    log = os.path.join(log_dir, "rings.flvo")
    counts, conv_s = convert_bag(bag, log)

    cfg = cli_config({"preprocess.feature_extract_en": 1})
    shares = []
    p = cfg.preprocess
    for rec in logio.read_log(log, blind=p.blind, max_range=p.max_range, point_filter_num=p.point_filter_num):
        if isinstance(rec, LidarScan) and len(shares) < FEATURE_SCANS:
            plane, edge = features.classify_features(rec)
            shares.append((int((plane | edge).sum()), len(rec.pts)))
    kept_min = min(k / n for k, n in shares)
    if not kept_min > FEATURE_KEPT_MIN:
        raise AssertionError(f"6d: a scan keeps only {kept_min:.3f} of its points")

    out_dir = os.path.join(log_dir, "features")
    pipe = run.run_log(log, cfg, out_dir=out_dir, max_scans=FEATURE_SCANS, progress=False, device=device)
    torch.cuda.synchronize()
    if pipe.health["rejected"] or not pipe.n_effective:
        raise AssertionError(f"6d: health {pipe.health}, {len(pipe.n_effective)} updates")
    if min(pipe.n_effective) < pipe.step_cfg.lio_cfg.min_effective:
        raise AssertionError(f"6d: n_effective {pipe.n_effective} below min_effective")
    if not all(bool(torch.all(torch.isfinite(x))) for x in pipe.state):
        raise AssertionError("6d: non-finite filter state")
    ate, n_poses = tum_ate(os.path.join(out_dir, "tum.txt"))
    host_ms = [s * 1e3 for s in pipe.timer.samples["features"]]
    return dict(scans=FEATURE_SCANS, counts=counts, convert_s=conv_s, lio_updates=len(pipe.n_effective),
                health=pipe.health, n_effective=pipe.n_effective,
                min_effective=pipe.step_cfg.lio_cfg.min_effective,
                kept_share=sum(k for k, _ in shares) / sum(n for _, n in shares), kept_share_min=kept_min,
                points_per_scan=float(np.mean([n for _, n in shares])),
                classify_host_ms_median=float(np.median(host_ms)), classify_host_ms_max=float(max(host_ms)),
                ate_m=ate, poses=n_poses)


def phase_bag_colorize(pipe, seq, device):
    """6e: colorize_cloud of the 6a run's final map cloud through the log's
    last frame (true camera pose), on the card and on the CPU: the same
    visible mask, values within COLOR_TOL, some points visible."""
    import torch

    from fastlivo_tpu_torch.io import export, synthetic
    from fastlivo_tpu_torch.ops.camera import Pinhole

    cloud = export.map_to_cloud(pipe.map)
    frame = seq.frames[-1]
    rot_wi, pos = synthetic.default_trajectory().pose(frame.stamp)
    rcw = synthetic.R_IC_FORWARD.T @ rot_wi.T
    pcw = -rcw @ pos
    cam = Pinhole(*CLI_CAMERA)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vals_g, vis_g = export.colorize_cloud(cloud, frame.img, rcw, pcw, cam, device=device)
    card_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    vals_c, vis_c = export.colorize_cloud(cloud, frame.img, rcw, pcw, cam, device="cpu")
    cpu_ms = (time.perf_counter() - t0) * 1e3
    err = float(np.abs(vals_g[vis_g] - vals_c[vis_c]).max()) if vis_g.any() and np.array_equal(vis_g, vis_c) else None
    if not np.array_equal(vis_g, vis_c) or err is None or not err <= COLOR_TOL:
        raise AssertionError(f"6e: card and CPU differ (visible {int(vis_g.sum())} / {int(vis_c.sum())}, err {err})")
    return dict(points=len(cloud), visible=int(vis_g.sum()), max_abs_err=err, card_ms=card_ms, cpu_ms=cpu_ms,
                frame_stamp=frame.stamp)


# ---------------------------------------------------------------------------
# Phase 7: multi-device LIVO on torch.distributed. Every rank is a child
# process of this script (`--rank-job`, or `--cli-job` under torchrun),
# started with a timeout; a child that fails or outlives it fails the phase.
# ---------------------------------------------------------------------------

P7_PAIRS = 20  # LIVO pairs per run, after the bootstrap
P7_RAW = 81920  # raw points per scan (the flagship's)
P7_TRAJ_TOL_M = 8e-3  # world 2 against world 1 (tests/test_sharded.py:366)
P7_EQ_TOL_M = 1e-6  # world 1 against one device, where not bit for bit
P7_CLI_W2_SCANS = 30
P7_CLI_W2_TOL_M = 2e-2  # tests/test_pipeline_sharded.py:88
P7_RE_CAP = 1 << 16  # 7d: slots per rank
P7_RE_POINTS = 16000  # ~12% of the two ranks' slots: the bounded probe drops none
P7_RANK_TIMEOUT_S = 300
# 7c: rank 0's loop correction, a shift by whole 0.5 m voxels (the map
# resolution of the config), so every point keeps its voxel's fill and the
# re-anchored arena must hold exactly the shifted points.
P7_REANCHOR_SHIFT = (1.0, -0.5, 0.5)


def reanchor_with_rank0_loop(pipe, shift=P7_REANCHOR_SHIFT):
    """`pipe.reanchor_map()` in a process group when only rank 0's loop back
    end holds a loop (a detection the other ranks' background workers have
    not delivered yet), rank 0's corrected keyframes being its drifted ones
    moved by `shift`. Every rank must follow rank 0. This rank's verdict,
    map epoch, occupied keys and map cloud before and after (numpy)."""
    from fastlivo_tpu_torch.backend.loop_manager import LoopEvent

    lb = pipe.loop_backend
    if pipe.rank == 0:
        g = lb.graph
        lb.loops.append(LoopEvent(0, len(g.stamps) - 1, 1.0, np.eye(3), np.zeros(3)))
        # inv(R^T), not R: the keyframe rotations come from f32 states, so
        # R R^T is the identity only to ~1e-7; this makes the correction's
        # rotation the identity to f64 rounding.
        lb.corrected_trajectory = lambda: (
            np.linalg.inv(np.asarray(g.rots).transpose(0, 2, 1)), np.asarray(g.trans) + np.asarray(shift)
        )
    else:
        lb.loops.clear()
    before = pipe.map_cloud()
    went = pipe.reanchor_map()
    return dict(went=went, epoch=int(pipe.map.epoch), before=before, after=pipe.map_cloud(),
                keys=pipe.map.keys[pipe.map.occupied].cpu().numpy())


def reanchor_gap(res, shift=P7_REANCHOR_SHIFT):
    """Largest gap between the stored points after the re-anchoring and the
    shifted points before it (rows sorted), or None when the counts differ."""
    want = (res["before"] + np.asarray(shift, np.float32)).astype(np.float32)
    got = res["after"]
    if len(got) != len(want):
        return None
    return float(np.abs(got[np.lexsort(got.T)] - want[np.lexsort(want.T)]).max()) if len(got) else 0.0


def free_port():
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def wait_children(procs, timeout, what):
    """Wait for every (Popen, log path); kill them all on a timeout or a
    failure, and raise with the failed child's log tail."""
    deadline = time.monotonic() + timeout
    failed = None
    for p, log in procs:
        try:
            rc = p.wait(max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            rc = None
        if rc != 0 and failed is None:
            failed = (rc, log)
            break
    for p, _ in procs:
        if p.poll() is None:
            p.kill()
            p.wait(30)
    if failed is not None:
        rc, log = failed
        with open(log) as f:
            tail = f.read()[-4000:]
        raise AssertionError(f"{what}: a child {'timed out' if rc is None else f'exited {rc}'}:\n{tail}")


def launch_ranks(job, world, backend, devices, out_dir, timeout=P7_RANK_TIMEOUT_S):
    """`world` children running `job` (this script with --rank-job), a
    torch.distributed world on 127.0.0.1; their JSON results in rank order."""
    env0 = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()), WORLD_SIZE=str(world))
    procs, outs = [], []
    for r in range(world):
        out = os.path.join(out_dir, f"{job}_{backend}_w{world}_r{r}.json")
        log = out[:-5] + ".log"
        env = dict(env0, RANK=str(r), LOCAL_RANK=str(r))
        cmd = [sys.executable, os.path.abspath(__file__), "--rank-job", job, "--job-out", out,
               "--backend", backend, "--job-device", devices[r]]
        with open(log, "w") as f:
            procs.append((subprocess.Popen(cmd, env=env, stdout=f, stderr=subprocess.STDOUT), log))
        outs.append(out)
    wait_children(procs, timeout, f"{job} ({backend}, world {world})")
    res = []
    for out in outs:
        with open(out) as f:
            res.append(json.load(f))
    return res


def torchrun_cli(world, out_json, run_args, out_dir, timeout=P7_RANK_TIMEOUT_S):
    """`python -m torch.distributed.run --nproc-per-node W` on this script's
    --cli-job, which calls `fastlivo_tpu_torch.run.main` (the body of
    `-m fastlivo_tpu_torch.run`) with `run_args` (handed over in a file, out
    of reach of torchrun's and this script's own parsers); every rank's
    JSON."""
    log = out_json + ".log"
    with open(out_json + ".args", "w") as f:
        json.dump(run_args, f)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(world),
           "--master-addr", "127.0.0.1", "--master-port", str(free_port()),
           os.path.abspath(__file__), "--cli-job", out_json]
    with open(log, "w") as f:
        p = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)
    wait_children([(p, log)], timeout, f"torchrun CLI world {world}")
    res = []
    for r in range(world):
        with open(f"{out_json}.r{r}") as f:
            res.append(json.load(f))
    return res


def _init_rank(backend):
    import torch.distributed as dist

    dist.init_process_group(backend, init_method="env://", rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return dist


def arena_bytes(m):
    return int(sum(t.numel() * t.element_size() for t in m))


def job_p7_world1(device, backend):
    """7a: the flagship LIVO sequence on one device and through the sharded
    builders at world 1 (NCCL), both modes, pair by pair in turns on the
    same inputs. Gates: every sharded pair's summaries and the final arena
    equal the single-device ones bit for bit (else within P7_EQ_TOL_M, with
    the surfel lookup's own difference shown); patch_sample launches on the
    sharded pairs."""
    import dataclasses

    import torch

    from fastlivo_tpu_torch import parallel
    from fastlivo_tpu_torch.maps import voxel_map as vm

    _init_rank(backend)
    mesh = parallel.make_mesh(1)
    cfg = flagship_config()
    runs = {
        "single": LivoRun(cfg, Scene(P7_RAW, 32, seed=0), device),
        "map_sharded": LivoRun(dataclasses.replace(cfg, map_sharded=True), Scene(P7_RAW, 32, seed=0), device, mesh),
        "points": LivoRun(cfg, Scene(P7_RAW, 32, seed=0), device, mesh),
    }
    inputs = {k: r.make_inputs(P7_PAIRS) for k, r in runs.items()}
    # The op the map-sharded mode swaps in: the merged surfel lookup against
    # the one-device lookup, on the bootstrap arena and the first scan.
    q = inputs["single"][0]["scan"].pts[:cfg.ds_capacity] + torch.as_tensor(
        pose_at(HALF_DT), dtype=torch.float32, device=device)
    lk1 = vm.surfel_lookup(runs["single"].lmap, q, cfg.map_cfg)
    lk2 = vm.sharded_surfel_lookup(runs["single"].lmap, q, cfg.map_cfg, mesh.map_axis)
    lookup_diff = {f: float((a.float().nan_to_num(posinf=0.0) - b.float().nan_to_num(posinf=0.0)).abs().max())
                   for f, a, b in zip(lk1._fields, lk1, lk2)}
    lookup_bitwise = all(same_bits(a.float(), b.float()) for a, b in zip(lk1, lk2))
    mesh.axis.counts.clear()
    recs = {k: [] for k in runs}
    launches = {k: 0 for k in KERNELS}
    collectives = {}
    for i in range(P7_PAIRS):
        for k, run in runs.items():
            if k != "single":
                torch.cuda.synchronize()
                reset_launches()
                before = dict(mesh.axis.counts)
            recs[k].append(run.pair(inputs[k][i], timed=True))
            if k != "single":
                torch.cuda.synchronize()
                for name, n in read_launches().items():
                    launches[name] += n
                for op, n in mesh.axis.counts.items():
                    collectives.setdefault(k, {}).setdefault(op, 0)
                    collectives[k][op] += n - before.get(op, 0)
    out = dict(lookup_diff=lookup_diff, lookup_bitwise=lookup_bitwise, launches=launches,
               frames=2 * P7_PAIRS)
    ref = finish(recs["single"])
    check_records(ref)
    out["single"] = dict(pair_ms=float(np.median([r["lio_ms"] + r["vio_ms"] for r in ref])),
                         lio_ms=float(np.median([r["lio_ms"] for r in ref])))
    for k in ("map_sharded", "points"):
        got = finish(recs[k])
        check_records(got)
        summ = lambda rs: np.stack([np.concatenate([r["lio"], r["vio"]]) for r in rs])  # noqa: E731
        a, b = summ(got), summ(ref)
        n_lio = len(got[0]["lio"])  # the VIO summary's position follows the LIO summary
        pos_err = float(max(np.abs(a[:, 0:3] - b[:, 0:3]).max(),
                            np.abs(a[:, n_lio:n_lio + 3] - b[:, n_lio:n_lio + 3]).max()))
        m1, m2 = runs["single"].lmap, runs[k].lmap
        bitwise = bool(np.array_equal(a, b) and torch.equal(m1.meta, m2.meta) and torch.equal(m1.counts, m2.counts))
        out[k] = dict(
            bitwise=bitwise, max_pos_diff_m=pos_err,
            pair_ms=float(np.median([r["lio_ms"] + r["vio_ms"] for r in got])),
            lio_ms=float(np.median([r["lio_ms"] for r in got])),
            collectives_per_step={op: n / P7_PAIRS for op, n in collectives[k].items()},
            traj=[r["lio"][0:3].tolist() + r["vio"][0:3].tolist() for r in got],
            arena_bytes=arena_bytes(m2),
        )
        if not bitwise and not pos_err <= P7_EQ_TOL_M:
            raise AssertionError(f"7a {k}: world 1 differs from one device by {pos_err} m "
                                 f"(surfel lookup diff {lookup_diff})")
    if launches["patch_sample"] <= 0:
        raise AssertionError("7a: patch_sample was never launched on the sharded pairs")
    import torch.distributed as dist

    dist.destroy_process_group()
    return out


def job_p7_world2(device, backend):
    """7b and 7d on `world` ranks (gloo sharing one GPU, or NCCL one rank
    per GPU): the flagship sequence map-sharded; then a sharded reanchor of
    a 2^16-slot-per-rank arena."""
    import dataclasses

    import torch

    from fastlivo_tpu_torch import parallel
    from fastlivo_tpu_torch.maps import voxel_map as vm

    dist = _init_rank(backend)
    mesh = parallel.make_mesh()
    ax = mesh.map_axis
    run = LivoRun(dataclasses.replace(flagship_config(), map_sharded=True), Scene(P7_RAW, 32, seed=0), device, mesh)
    inputs = run.make_inputs(P7_PAIRS)
    torch.cuda.synchronize()
    reset_launches()
    recs = finish([run.pair(inp, timed=True) for inp in inputs])
    launches = read_launches()
    check_records(recs)
    m = run.lmap
    keys = m.keys[m.occupied]
    out = dict(
        rank=ax.index, world=ax.size, backend=backend, device=str(device),
        traj=[r["lio"][0:3].tolist() + r["vio"][0:3].tolist() for r in recs],
        pair_ms=float(np.median([r["lio_ms"] + r["vio_ms"] for r in recs])),
        lio_ms=float(np.median([r["lio_ms"] for r in recs])),
        occupied=int(keys.shape[0]), owned=bool((vm.owner_of(keys, ax.size) == ax.index).all()),
        arena_bytes=arena_bytes(m), launches=launches,
    )
    del run, m

    # 7d: one point per voxel, a correction that moves most voxels to
    # another owner; nothing may be dropped.
    cfg_re = vm.VoxelMapConfig(resolution=0.4, capacity=P7_RE_CAP, max_points=8)
    rng = np.random.default_rng(7)
    vox = np.unique(np.floor(rng.uniform(-20, 20, (P7_RE_POINTS, 3)) / cfg_re.resolution).astype(np.int32), axis=0)
    pts = torch.as_tensor(((vox + 0.5) * cfg_re.resolution).astype(np.float32), device=device)
    th = 0.05
    rot = torch.tensor([[math.cos(th), -math.sin(th), 0.0], [math.sin(th), math.cos(th), 0.0], [0.0, 0.0, 1.0]],
                       device=device)
    trans = torch.tensor([10.3, -7.7, 3.9], device=device)
    ok = torch.ones(len(vox), dtype=torch.bool, device=device)
    m = vm.sharded_insert(vm.make_map(cfg_re, device=device), pts, ok, cfg_re, ax)
    n_before = int(ax.psum(vm.num_points(m)))
    step_cfg = dataclasses.replace(flagship_config(), map_cfg=cfg_re, map_sharded=True)
    re = parallel.make_sharded_reanchor(mesh, step_cfg)
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = re(m, torch.zeros((1024,), dtype=torch.int32, device=device), rot[None], trans[None])
    torch.cuda.synchronize()
    re_ms = (time.perf_counter() - t0) * 1e3
    n_after = int(ax.psum(vm.num_points(m)))
    valid = (torch.arange(cfg_re.max_points, device=device)[None, :] < m.counts[:, None]) & m.occupied[:, None]
    stored = ax.all_gather_ragged(m.points[valid]).cpu().numpy()
    want = (pts @ rot.T + trans).cpu().numpy()
    moved = int((vm.owner_of(torch.as_tensor(vox, device=device), ax.size)
                 != vm.owner_of(vm.voxel_coord(pts @ rot.T + trans, cfg_re.resolution), ax.size)).sum())
    gap = (float(np.abs(stored[np.lexsort(stored.T)] - want[np.lexsort(want.T)]).max())
           if len(stored) == len(want) else None)
    out["reanchor"] = dict(
        points=len(vox), before=n_before, after=n_after, moved_owner=moved, ms=re_ms,
        chunks=-(-(cfg_re.capacity * cfg_re.max_points) // 65536),
        owned=bool((vm.owner_of(m.keys[m.occupied], ax.size) == ax.index).all()), max_point_gap_m=gap,
    )
    if n_after != n_before or n_before != len(vox) or gap is None or gap > 1e-5:
        raise AssertionError(f"7d: reanchor dropped or moved points wrongly: {out['reanchor']}")
    dist.destroy_process_group()
    return out


RANK_JOBS = {"p7_world1": job_p7_world1, "p7_world2": job_p7_world2}


def run_rank_job(args):
    """A child of phase 7: one rank of `args.rank_job`; its JSON result."""
    import torch

    device = torch.device(args.job_device)
    torch.cuda.set_device(device)
    from fastlivo_tpu_torch.ops import cuda_build

    cuda_build.build_all()  # built by the parent; loads the cached libraries
    out = RANK_JOBS[args.rank_job](device, args.backend)
    with open(args.job_out, "w") as f:
        json.dump(out, f, default=str)
    return 0


def run_cli_job(out_json):
    """A torchrun rank of the CLI (`fastlivo_tpu_torch.run.main` on the
    arguments in `out_json`.args), its gates and launch counts written per
    rank."""
    import torch

    from fastlivo_tpu_torch import run

    from fastlivo_tpu_torch.parallel.distributed import initialize_distributed

    with open(out_json + ".args") as f:
        run_args = json.load(f)
    # This job makes the process group, so run.main leaves it up for the
    # re-anchoring below.
    opts = dict(zip(run_args, run_args[1:]))
    initialize_distributed(backend=opts.get("--dist-backend"), device=opts.get("--device"))
    reset_launches()
    pipe = run.main(run_args)
    torch.cuda.synchronize()
    out = dict(rank=pipe.rank, shards=pipe.n_map_shards, launches=read_launches(), health=pipe.health,
               lio_updates=len(pipe.n_effective), vio_updates=len(pipe.n_selected),
               n_effective_min=min(pipe.n_effective) if pipe.n_effective else None,
               n_selected=pipe.n_selected, vio_before_lio=pipe.vio_before_lio,
               min_effective=pipe.step_cfg.lio_cfg.min_effective,
               arena_bytes=arena_bytes(pipe.map), device=str(pipe.device))
    if pipe.loop_backend is not None and pipe.mesh is not None:
        from fastlivo_tpu_torch.maps import voxel_map as vm

        t0 = time.perf_counter()
        re = reanchor_with_rank0_loop(pipe)
        out["reanchor"] = dict(
            went=re["went"], epoch=re["epoch"], points=len(re["before"]), max_gap_m=reanchor_gap(re),
            owned=bool((vm.owner_of(torch.as_tensor(re["keys"]), pipe.n_map_shards) == pipe.rank).all()),
            seconds=time.perf_counter() - t0,
        )
    with open(f"{out_json}.r{pipe.rank}", "w") as f:
        json.dump(out, f, default=str)
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


def p7_cli_gates(res, tag):
    """Phase 4's per-run gates on a CLI rank's record."""
    if res["health"]["rejected"]:
        raise AssertionError(f"{tag}: {res['health']['rejected']} LIO updates rejected")
    if not res["lio_updates"] or res["n_effective_min"] < res["min_effective"]:
        raise AssertionError(f"{tag}: n_effective {res['n_effective_min']} below min_effective")
    sel = res["n_selected"]
    first = next((i for i, n in enumerate(sel) if n > 0), len(sel))
    if first == len(sel) or min(sel[first:]) <= 0 or first > res["vio_before_lio"] + 1:
        raise AssertionError(f"{tag}: n_selected {sel}")
    if res["launches"]["patch_sample"] <= 0:
        raise AssertionError(f"{tag}: patch_sample was never launched")


def phase_multi(device, cli_dir, work_dir):
    """Phase 7 (see the module docstring)."""
    import torch

    from fastlivo_tpu_torch.io import export

    out = {}
    t0 = time.perf_counter()
    out["7a"] = launch_ranks("p7_world1", 1, "nccl", ["cuda:0"], work_dir)[0]
    out["7a"]["seconds"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    w2 = launch_ranks("p7_world2", 2, "gloo", ["cuda:0", "cuda:0"], work_dir)
    ref = np.asarray(out["7a"]["map_sharded"]["traj"])
    occ = [r["occupied"] for r in w2]
    b = dict(
        ranks=[{k: v for k, v in r.items() if k != "traj"} for r in w2],
        max_traj_diff_vs_world1_m=max(float(np.abs(np.asarray(r["traj"]) - ref).max()) for r in w2),
        load_min_over_mean=min(occ) / float(np.mean(occ)),
    )
    if not b["max_traj_diff_vs_world1_m"] <= P7_TRAJ_TOL_M:
        raise AssertionError(f"7b: world 2 trajectory {b['max_traj_diff_vs_world1_m']} m off world 1")
    if not all(r["owned"] for r in w2) or not b["load_min_over_mean"] > 0.5:
        raise AssertionError(f"7b: ownership {[r['owned'] for r in w2]}, load {occ}")
    if any(r["launches"]["patch_sample"] <= 0 for r in w2):
        raise AssertionError("7b: patch_sample was never launched")
    if torch.cuda.device_count() >= 2:
        nccl = launch_ranks("p7_world2", 2, "nccl", ["cuda:0", "cuda:1"], work_dir)
        b["nccl_world2"] = dict(
            max_traj_diff_vs_world1_m=max(float(np.abs(np.asarray(r["traj"]) - ref).max()) for r in nccl),
            pair_ms=[r["pair_ms"] for r in nccl], occupied=[r["occupied"] for r in nccl])
        if not b["nccl_world2"]["max_traj_diff_vs_world1_m"] <= P7_TRAJ_TOL_M:
            raise AssertionError(f"7b: NCCL world 2 off world 1: {b['nccl_world2']}")
    else:
        b["nccl_world2"] = "not run: 1 GPU, and NCCL takes one rank per GPU"
        print("7b: NCCL at world 2 not run: this machine has 1 GPU and NCCL takes one rank per GPU",
              flush=True)
    b["seconds"] = time.perf_counter() - t0
    out["7b"] = b
    out["7d"] = w2[0]["reanchor"]

    t0 = time.perf_counter()
    log = os.path.join(cli_dir, "cli.flvo")
    rig = [f"--set={k}={v!r}" for k, v in cli_rig_overrides().items()]
    base = ["--config", CLI_CONFIG, "--log-path", log, *rig, "--set=parallel.map_sharded=True"]
    d1 = os.path.join(work_dir, "cli_w1")
    r1 = torchrun_cli(1, os.path.join(work_dir, "cli_w1.json"),
                      [*base, "--out", d1, "--set=parallel.n_devices=1"], work_dir)[0]
    p7_cli_gates(r1, "7c world 1")
    ate1, n1 = tum_ate(os.path.join(d1, "tum.txt"))
    if ate1 >= CLI_ATE_M or not len(export.read_pcd(os.path.join(d1, "map.pcd"))):
        raise AssertionError(f"7c world 1: ATE {ate1} m, or an empty map.pcd")
    with open(os.path.join(cli_dir, "main", "tum.txt"), "rb") as f:
        rows4 = f.read().splitlines()
    with open(os.path.join(d1, "tum.txt"), "rb") as f:
        rows1 = f.read().splitlines()
    _, p4, _ = export.read_tum(os.path.join(cli_dir, "main", "tum.txt"))
    _, p1, _ = export.read_tum(os.path.join(d1, "tum.txt"))
    same = rows1 == rows4
    gap = float(np.abs(p1 - p4).max()) if len(p1) == len(p4) else None
    if not same and not (gap is not None and gap <= P7_EQ_TOL_M):
        raise AssertionError(f"7c world 1: tum.txt differs from phase 4's (max gap {gap} m)")
    d2 = os.path.join(work_dir, "cli_w2")
    r2 = torchrun_cli(2, os.path.join(work_dir, "cli_w2.json"),
                      [*base, "--out", d2, "--set=parallel.n_devices=2", "--dist-backend", "gloo",
                       "--device", "cuda:0", "--max-scans", str(P7_CLI_W2_SCANS),
                       "--set=loop.loop_en=True"], work_dir)
    ate2, n2 = tum_ate(os.path.join(d2, "tum.txt"))
    t2, p2, _ = export.read_tum(os.path.join(d2, "tum.txt"))
    gap2 = float(np.abs(p2 - p1[: len(p2)]).max())
    if ate2 >= CLI_ATE_M or not gap2 <= P7_CLI_W2_TOL_M or any(r["health"]["rejected"] for r in r2):
        raise AssertionError(f"7c world 2: ATE {ate2} m, {gap2} m off world 1, health {[r['health'] for r in r2]}")
    # reanchor_map when only rank 0's loop back end holds a loop: both ranks
    # apply rank 0's shift (exact on the CPU; 1e-5 m here) and keep ownership.
    re2 = [r["reanchor"] for r in r2]
    if not (all(r["went"] and r["owned"] and r["max_gap_m"] is not None and r["max_gap_m"] <= 1e-5
                for r in re2) and len({r["epoch"] for r in re2}) == 1):
        raise AssertionError(f"7c world 2: reanchor_map did not follow rank 0: {re2}")
    out["7c"] = dict(
        world1=dict(ate_m=ate1, poses=n1, tum_bitwise_vs_phase4=same, max_gap_vs_phase4_m=gap,
                    launches=r1["launches"], patch_sample_per_frame=r1["launches"]["patch_sample"] / max(r1["vio_updates"], 1),
                    shards=r1["shards"], lio_updates=r1["lio_updates"], vio_updates=r1["vio_updates"],
                    arena_bytes=r1["arena_bytes"]),
        world2=dict(ate_m=ate2, poses=n2, max_gap_vs_world1_m=gap2, scans=P7_CLI_W2_SCANS,
                    shards=[r["shards"] for r in r2], arena_bytes=[r["arena_bytes"] for r in r2],
                    launches=[r["launches"] for r in r2], reanchor=re2),
        seconds=time.perf_counter() - t0,
    )
    return out


# ---------------------------------------------------------------------------
# Phase 8: matcher training on the card (backend/train_matcher.py), the JAX
# script's default recipe at its full widths.
# ---------------------------------------------------------------------------

P8_RECIPE = dict(pairs=384, steps_sp=3000, steps_lg=2500, batch=8, lg_layers=3, seed=0)
P8_WARMUP = 20  # steps left out of the per-step median
P8_TOL = 1e-4  # card against CPU: loss rtol, gradient relative L2
P8_GATE_MARGIN = 1.5  # learned mean match ratio over the classical mean


def _rotvec(v):
    """Rotation matrix of a rotation vector (Rodrigues, float64)."""
    v = np.asarray(v, np.float64)
    th = np.linalg.norm(v)
    if th == 0.0:
        return np.eye(3)
    k = v / th
    kx = np.array([[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]], [-k[1], k[0], 0.0]])
    return np.eye(3) + np.sin(th) * kx + (1.0 - np.cos(th)) * kx @ kx


def matcher_gate_pairs(device):
    """The three viewpoint + illumination pairs of
    tests/test_superpoint_lightglue.py::test_trained_matcher_beats_classical,
    rendered by the port on `device` (NumPy images)."""
    import torch

    from fastlivo_tpu_torch.io import render
    from fastlivo_tpu_torch.ops.camera import Pinhole

    cam = Pinhole(width=320, height=256, fx=200.0, fy=200.0, cx=160.0, cy=128.0)

    def view(rot_wc, pos):
        rcw = np.asarray(rot_wc, np.float32).T
        pcw = -rcw @ np.asarray(pos, np.float32)
        return render.render_room(cam, torch.as_tensor(rcw).to(device), torch.as_tensor(pcw).to(device)).cpu().numpy()

    base = _rotvec([-np.pi / 2, 0.0, 0.0])
    rng = np.random.default_rng(5)
    pairs = []
    for _ in range(3):
        yaw = rng.uniform(0, 2 * np.pi)
        r1 = base @ _rotvec([0.0, 0.0, yaw])
        o1 = np.array([rng.uniform(-2, 2), rng.uniform(-2, 2), 1.5])
        img1 = view(r1, o1)
        img2 = view(r1 @ _rotvec([0.05, 0.03, 0.8]), o1 + np.array([0.7, 0.4, -0.3]))
        pairs.append((img1, 255.0 * np.clip(img2 / 255.0, 0, 1) ** 1.6 * 0.8 + 20.0))
    return pairs


def train_step_card_vs_cpu(device, ds, lg_ds, batch_sp, batch_lg, seed=0, lg_layers=3):
    """One SuperPoint and one LightGlue training step's loss and gradients
    on the card and on the CPU port, from `init_*(seed)` weights and the
    same batch (the first rows of `ds` / `lg_ds`, augmentation drawn once on
    the CPU), in float32 (TF32 off, as training runs) and in float64.

    Per network and dtype: the loss's relative error, the gradients' global
    relative L2 error, and each gradient tensor's relative L2 error (the
    largest, and its tensor). Gradients that are zero in exact arithmetic
    (LightGlue's cross-attention key biases: a softmax ignores a constant
    per query) are rounding noise on both devices; they are counted apart,
    by their norm against the global gradient norm. Also: whether two card
    SuperPoint steps in float32 repeat bit for bit."""
    import torch

    from fastlivo_tpu_torch import convert
    from fastlivo_tpu_torch.backend import superpoint_lightglue as spl
    from fastlivo_tpu_torch.backend import train_matcher as tm

    aug = tm.superpoint_sampler(batch_sp, batch_sp, seed + 1, "cpu")(0)
    sp_np, lg_np = spl.init_superpoint(seed), spl.init_lightglue(seed, n_layers=lg_layers)

    def cast(t, dev, dtype):
        return t.to(dev, dtype) if t.is_floating_point() else t.to(dev)

    def sp_step(dev, dtype):
        sp = convert.superpoint_from_numpy(sp_np, device=dev).to(dtype)
        b = {k: cast(ds[k][:batch_sp], dev, dtype) for k in ("img0", "img1", "det0", "det1", "corr01", "corr10")}
        loss = tm.superpoint_loss(sp, tm.augment(b["img0"], cast(aug["aug0"], dev, dtype)),
                                  tm.augment(b["img1"], cast(aug["aug1"], dev, dtype)),
                                  b["det0"], b["det1"], b["corr01"], b["corr10"])
        grads = torch.autograd.grad(loss, list(sp.parameters()))
        return loss.detach().cpu(), {n: g.cpu() for (n, _), g in zip(sp.named_parameters(), grads)}

    def lg_step(dev, dtype):
        lg = convert.lightglue_from_numpy(lg_np, device=dev).to(dtype)
        b = {k: cast(v[:batch_lg], dev, dtype) for k, v in lg_ds.items()}
        size = torch.tensor([tm.CAM_W, tm.CAM_H], dtype=dtype, device=dev)
        loss = tm.lightglue_loss(lg, b, size)
        grads = torch.autograd.grad(loss, list(lg.parameters()))
        return loss.detach().cpu(), {n: g.cpu() for (n, _), g in zip(lg.named_parameters(), grads)}

    def compare(card, cpu):
        (lc, gc), (lh, gh) = card, cpu
        norm = torch.linalg.vector_norm
        g_all = float(norm(torch.stack([norm(g.double()) for g in gh.values()])))
        d_all = float(norm(torch.stack([norm((gc[n] - gh[n]).double()) for n in gh])))
        zero = [n for n in gh if float(norm(gh[n].double())) <= 1e-9 * g_all]
        rel = {n: float(norm((gc[n] - gh[n]).double()) / norm(gh[n].double())) for n in gh if n not in zero}
        worst = max(rel, key=rel.get)
        return dict(loss_card=float(lc), loss_cpu=float(lh), loss_rel_err=abs(float(lc) - float(lh)) / abs(float(lh)),
                    grad_global_rel_l2=d_all / g_all, grad_rel_l2_max=rel[worst], grad_rel_l2_worst=worst,
                    n_grads=len(gh), zero_grads=zero,
                    zero_grads_max_over_global=max([float(norm(gc[n].double())) / g_all for n in zero], default=0.0))

    out = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        sp_card = sp_step(device, dtype)
        out[f"superpoint_{tag}"] = compare(sp_card, sp_step("cpu", dtype))
        out[f"lightglue_{tag}"] = compare(lg_step(device, dtype), lg_step("cpu", dtype))
        if dtype is torch.float32:
            again = sp_step(device, dtype)
            out["superpoint_f32"]["card_repeats_bitwise"] = bool(
                torch.equal(sp_card[0], again[0]) and all(torch.equal(sp_card[1][n], again[1][n]) for n in again[1]))
    return out


def card_vs_cpu_failures(cmp, tol=P8_TOL):
    """The gates on `train_step_card_vs_cpu`: every loss within `tol`
    relative; in float32 all gradients together within `tol` relative L2;
    in float64 every gradient tensor within `tol` relative L2 and the
    exactly-zero ones below 1e-9 of the global norm on the card too."""
    bad = []
    for key, c in cmp.items():
        if c["loss_rel_err"] > tol or c["grad_global_rel_l2"] > tol:
            bad.append(key)
        elif key.endswith("f64") and (c["grad_rel_l2_max"] > tol or c["zero_grads_max_over_global"] > 1e-9):
            bad.append(key)
    return bad


def graphed_vs_eager(device, ds, lg_ds, n_valid, batch_sp, batch_lg, steps=12, seed=0, lg_layers=3):
    """`steps` training steps of each network through `train_matcher.fit`
    (CUDA-graph replay after its eager warm-up) against the same steps run
    eagerly, twice, from the same draws: per-step loss relative errors,
    final weight differences (largest, and the share above 1e-5: Adam's
    early steps move a weight by about lr sign(g), so a rounding of a
    near-zero g moves it by up to 2 lr), and ms per step (CUDA events over
    the steps after the warm-up). The eager runs differ from each other
    too (cuDNN's weight gradients and the index backward use atomics)."""
    import torch

    from fastlivo_tpu_torch import convert
    from fastlivo_tpu_torch.backend import superpoint_lightglue as spl
    from fastlivo_tpu_torch.backend import train_matcher as tm
    from fastlivo_tpu_torch.backend.optim import ClipAdamCosine

    sp_draw = tm.superpoint_sampler(n_valid, batch_sp, seed + 1, device)
    lg_draw = tm.lightglue_sampler(n_valid, batch_lg, seed + 2, device)
    sp_draws = [sp_draw(i) for i in range(steps)]
    lg_draws = [lg_draw(i) for i in range(steps)]
    size = torch.tensor([tm.CAM_W, tm.CAM_H], dtype=torch.float32, device=device)

    def sp_loss(sp, b):
        idx = b["idx"]
        return tm.superpoint_loss(sp, tm.augment(ds["img0"][idx], b["aug0"]), tm.augment(ds["img1"][idx], b["aug1"]),
                                  ds["det0"][idx], ds["det1"][idx], ds["corr01"][idx], ds["corr10"][idx])

    def lg_loss(lg, b):
        return tm.lightglue_loss(lg, {k: v[b["idx"]] for k, v in lg_ds.items()}, size)

    def timed(fn):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = fn()
        ev[1].record()
        torch.cuda.synchronize()
        return out, ev[0].elapsed_time(ev[1])

    def eager(make, lr, draws, loss):
        mod = make()
        params = list(mod.parameters())
        opt = ClipAdamCosine(params, lr, steps)
        losses = []
        for b in draws[:tm.GRAPH_WARMUP]:
            l = loss(mod, b)
            opt.step(torch.autograd.grad(l, params))
            losses.append(l.detach())

        def rest():
            for b in draws[tm.GRAPH_WARMUP:]:
                l = loss(mod, b)
                opt.step(torch.autograd.grad(l, params))
                losses.append(l.detach())

        _, ms = timed(rest)
        return torch.stack(losses).cpu(), [p.detach().cpu() for p in params], ms / (steps - tm.GRAPH_WARMUP)

    def compare(a, b, lr):
        diff = torch.cat([(x - y).abs().reshape(-1) for x, y in zip(a[1], b[1])])
        return dict(loss_rel_err_max=float(((a[0] - b[0]).abs() / b[0].abs()).max()),
                    weight_max_abs_diff=float(diff.max()), weight_share_above_1e5=float((diff > 1e-5).float().mean()),
                    two_lr=2 * lr)

    out = {}
    for name, make, lr, draws, loss, train in (
        ("superpoint", lambda: convert.superpoint_from_numpy(spl.init_superpoint(seed), device=device), tm.SP_LR,
         sp_draws, sp_loss, lambda: tm.train_superpoint(ds, n_valid, steps, batch_sp, seed, sampler=lambda i: sp_draws[i])),
        ("lightglue", lambda: convert.lightglue_from_numpy(spl.init_lightglue(seed, n_layers=lg_layers), device=device),
         tm.LG_LR, lg_draws, lg_loss, lambda: tm.train_lightglue(lg_ds, n_valid, steps, batch_lg, seed,
                                                                 n_layers=lg_layers, sampler=lambda i: lg_draws[i])),
    ):
        e1, e2 = eager(make, lr, draws, loss), eager(make, lr, draws, loss)
        (mod, losses), g_ms = timed(train)
        graphed = (losses.cpu(), [p.detach().cpu() for p in mod.parameters()])
        out[name] = dict(graphed_vs_eager=compare(graphed, e1, lr), eager_vs_eager=compare(e2, e1, lr),
                         eager_ms_per_step=e1[2], steps=steps)
    return out


def graph_failures(cmp, tol=P8_TOL):
    """Graphed against eager, no farther apart than two eager runs are:
    every step's loss within `tol` relative; the share of final weights
    more than 1e-5 apart at most twice the eager runs' share plus 1e-3
    (SuperPoint's eager runs differ in ~4% of the weights after 12 steps),
    and every weight within 2 lr x steps."""
    bad = []
    for name, c in cmp.items():
        g, e = c["graphed_vs_eager"], c["eager_vs_eager"]
        if not (g["loss_rel_err_max"] <= tol and g["weight_share_above_1e5"] <= 2 * e["weight_share_above_1e5"] + 1e-3
                and g["weight_max_abs_diff"] <= g["two_lr"] * c["steps"]):
            bad.append(name)
    return bad


class StepClock:
    """Per-step CUDA events and host syncs of a training loop, through the
    trainer's injected sampler, which is called at the start of every step:
    it records one event there (and one more ends the loop), and turns
    torch's sync debug mode on at step 0, so the module set-up before the
    loop is not counted."""

    def __init__(self, sampler):
        self.sampler = sampler
        self.events = []

    def draw(self, step):
        import torch

        if step == 0:
            torch.cuda.set_sync_debug_mode("warn")
        self._mark()
        return self.sampler(step)

    def _mark(self):
        import torch

        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append(ev)

    def run(self, fn):
        """(host syncs inside the loop, where each was made, fn's result)."""
        import warnings

        import torch

        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                out = fn()
                self._mark()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        where = [f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught if "synchroniz" in str(w.message)]
        return len(where), where, out

    def step_ms(self, warmup=P8_WARMUP):
        import torch

        torch.cuda.synchronize()
        ms = [a.elapsed_time(b) for a, b in zip(self.events[:-1], self.events[1:])]
        return dict(median_ms=float(np.median(ms[warmup:])), mean_ms=float(np.mean(ms[warmup:])),
                    first_ms=float(ms[0]), steps=len(ms), loop_s=float(sum(ms)) / 1e3)


def phase_train(device, out_dir):
    """Phase 8 (see the module docstring)."""
    import torch

    from fastlivo_tpu_torch import convert
    from fastlivo_tpu_torch.backend import superpoint_lightglue as spl
    from fastlivo_tpu_torch.backend import train_matcher as tm
    from fastlivo_tpu_torch.backend import visual_verify as vv

    r = P8_RECIPE
    batch_lg = max(r["batch"] // 2, 1)
    out = dict(recipe=r, image=[tm.CAM_H, tm.CAM_W])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    ds, n_valid = tm.build_dataset(r["pairs"], r["seed"], device=device)
    n_valid = int(n_valid)  # the one host read before training
    out["dataset_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    sp_clock = StepClock(tm.superpoint_sampler(n_valid, r["batch"], r["seed"] + 1, device))
    sp_syncs, sp_sync_at, (sp, sp_losses) = sp_clock.run(lambda: tm.train_superpoint(
        ds, n_valid, r["steps_sp"], r["batch"], r["seed"], sampler=sp_clock.draw))
    torch.cuda.synchronize()
    out["superpoint_train_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lg_ds = tm.build_lg_dataset(ds, sp)
    torch.cuda.synchronize()
    out["lg_dataset_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lg_clock = StepClock(tm.lightglue_sampler(n_valid, batch_lg, r["seed"] + 2, device))
    lg_syncs, lg_sync_at, (lg, lg_losses) = lg_clock.run(lambda: tm.train_lightglue(
        lg_ds, n_valid, r["steps_lg"], batch_lg, r["seed"], n_layers=r["lg_layers"], sampler=lg_clock.draw))
    torch.cuda.synchronize()
    out["lightglue_train_s"] = time.perf_counter() - t0
    sp_l, lg_l = sp_losses.cpu().numpy(), lg_losses.cpu().numpy()  # the first reads of the losses
    t0 = time.perf_counter()
    rows = tm.evaluate(sp, lg)
    out["evaluate_s"] = time.perf_counter() - t0
    sp_path, lg_path = os.path.join(out_dir, "superpoint_synth.npz"), os.path.join(out_dir, "lightglue_synth.npz")
    tm.save_f16(sp_path, convert.superpoint_state_to_numpy(sp))
    tm.save_f16(lg_path, convert.lightglue_state_to_numpy(lg))
    torch.cuda.synchronize()
    out["launches"] = read_launches()
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()

    sp_t, lg_t = sp_clock.step_ms(), lg_clock.step_ms()
    g = tm.G
    sp_flops = 3 * (2 * r["batch"] * superpoint_flops(tm.CAM_H, tm.CAM_W) + 2 * r["batch"] * 2 * g * g * spl.DESC_DIM)
    lg_flops = 3 * batch_lg * lightglue_flops(tm.MAX_KP, tm.MAX_KP, r["lg_layers"])
    out.update(
        n_valid=n_valid, rendered_pairs=int(ds["img0"].shape[0]),
        dustbin_share=float((ds["det0"] == 64).float().mean()), gt_share=float((lg_ds["gt"] >= 0).float().mean()),
        superpoint=dict(**sp_t, syncs_in_loop=sp_syncs, syncs_at=sp_sync_at, flops_per_step=sp_flops,
                        f32_peak_share=sp_flops / (sp_t["median_ms"] * 1e-3) / F32_PEAK_FLOPS,
                        bound_ms=sp_flops / F32_PEAK_FLOPS * 1e3,
                        loss_first5=float(sp_l[:5].mean()), loss_last50=float(sp_l[-50:].mean())),
        lightglue=dict(**lg_t, syncs_in_loop=lg_syncs, syncs_at=lg_sync_at, flops_per_step=lg_flops,
                       f32_peak_share=lg_flops / (lg_t["median_ms"] * 1e-3) / F32_PEAK_FLOPS,
                       bound_ms=lg_flops / F32_PEAK_FLOPS * 1e3,
                       loss_first5=float(lg_l[:5].mean()), loss_last50=float(lg_l[-50:].mean())),
        evaluate=[dict(learned=a, learned_matches=b, classical=c, classical_matches=d) for a, b, c, d in rows],
    )
    failed = []  # every gate runs; the phase raises at the end with its record printed
    for name, l in (("superpoint", sp_l), ("lightglue", lg_l)):
        if not np.all(np.isfinite(l)):
            failed.append(f"non-finite {name} losses")
        elif not l[-50:].mean() < l[:5].mean():
            failed.append(f"{name} loss did not fall: {l[:5].mean()} -> {l[-50:].mean()}")
    if n_valid <= 0:
        failed.append("no overlap-valid pair")
    cpu_ds, _ = tm.build_dataset(16, r["seed"], chunk=32, device="cpu")
    out["first_chunk_valid_equal_cpu"] = bool(torch.equal(ds["ok"][:32].cpu(), cpu_ds["ok"]))
    if not out["first_chunk_valid_equal_cpu"]:
        failed.append(f"first chunk's valid flags {ds['ok'][:32].tolist()} vs CPU {cpu_ds['ok'].tolist()}")

    # The quality gate on the saved f16 artifacts (the committed weights'
    # criterion), the committed weights beside them.
    trained = vv.SuperPointLightGlue(weights_path=(sp_path, lg_path), device=device)
    committed = vv.default_matcher(device=device)
    classical = vv.OrientedPatchMatcher(device=device)
    pairs = matcher_gate_pairs(device)
    ratios = dict(trained=[], committed=[], classical=[])
    for a, b in pairs:
        ratios["trained"].append(trained.match(a, b).match_ratio)
        ratios["committed"].append(committed.match(a, b).match_ratio)
        ratios["classical"].append(classical.match(a, b).match_ratio)
    out["gate_ratios"] = ratios
    wins = all(t > c for t, c in zip(ratios["trained"], ratios["classical"]))
    margin = float(np.mean(ratios["trained"]) / max(np.mean(ratios["classical"]), 1e-12))
    out["gate_mean_over_classical"] = margin
    if not wins or not margin > P8_GATE_MARGIN:
        failed.append(f"the trained matcher does not beat the classical one: {ratios}")

    # The npz round trip: the loaded artifact matches as the in-memory model
    # with f16-rounded weights.
    def f16(mod):
        with torch.no_grad():
            for p in mod.parameters():
                p.copy_(p.half().float())
        return mod.eval()

    sp16 = f16(convert.superpoint_from_numpy(convert.superpoint_state_to_numpy(sp), device=device))
    lg16 = f16(convert.lightglue_from_numpy(convert.lightglue_state_to_numpy(lg), device=device))
    mem = spl.SuperPointLightGlueMatcher(sp16, lg16)
    same = []
    for a, b in pairs:
        ra, rb = trained.match(a, b), mem.match(a, b)
        same.append(rows_set(np.concatenate([ra.pts1, ra.pts2], 1)) == rows_set(np.concatenate([rb.pts1, rb.pts2], 1)))
    out["npz_matches_equal_in_memory_f16"] = same
    if not all(same):
        failed.append(f"the saved artifact's matches differ from the in-memory f16 model's: {same}")

    out["card_vs_cpu"] = train_step_card_vs_cpu(device, ds, lg_ds, r["batch"], batch_lg, r["seed"], r["lg_layers"])
    bad = card_vs_cpu_failures(out["card_vs_cpu"])
    if bad:
        failed.append(f"card vs CPU steps {bad}")
    out["graphed_vs_eager"] = graphed_vs_eager(device, ds, lg_ds, n_valid, r["batch"], batch_lg, seed=r["seed"],
                                               lg_layers=r["lg_layers"])
    bad = graph_failures(out["graphed_vs_eager"])
    if bad:
        failed.append(f"graphed training differs from eager steps: {bad}")
    if failed:
        print(json.dumps({"phase8_train": out}, default=str), flush=True)
        raise AssertionError(f"8: {failed}")
    return out


def main(argv=None):
    import argparse
    import contextlib

    import torch

    ap = argparse.ArgumentParser(description="Drive the port on one NVIDIA GPU and check it.")
    ap.add_argument("--out", help="also write every phase's full record to this JSON file")
    # Phase 7's children (started by this script, not by hand).
    ap.add_argument("--rank-job", choices=sorted(RANK_JOBS), help=argparse.SUPPRESS)
    ap.add_argument("--job-out", help=argparse.SUPPRESS)
    ap.add_argument("--backend", help=argparse.SUPPRESS)
    ap.add_argument("--job-device", help=argparse.SUPPRESS)
    ap.add_argument("--cli-job", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if args.rank_job:
        return run_rank_job(args)
    if args.cli_job:
        return run_cli_job(args.cli_job)
    from fastlivo_tpu_torch import native
    from fastlivo_tpu_torch.ops import cuda_build

    device = torch.device("cuda")
    ident = gpu_identity()
    print(ident, flush=True)
    t0 = time.perf_counter()
    libs = cuda_build.build_all()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_lib = native.get_lib()  # g++, for the log codec of phase 6
    if host_lib is None:
        raise AssertionError("the native host library (fastlivo_tpu_torch/native/src/livo_host.cc) did not build")
    print(json.dumps({"build_s": build_s, "libraries": sorted(p.name for p in libs.values()),
                      "native_build_s": time.perf_counter() - t0,
                      "native_library": os.path.basename(host_lib._name)}), flush=True)

    k1, imu_rows = phase_kernels(device)
    knn_rows = phase_knn(device)
    print(json.dumps({"knn": knn_rows, "gpu": ident}), flush=True)
    psr, ps_split = phase_patch_sample(device)
    print(json.dumps({"patch_sample_host_ns": ps_split, "n": PS_SPLIT_N, "gpu": ident}), flush=True)

    livo = phase_livo(device)
    print(json.dumps({"livo": livo, "gpu": ident}), flush=True)

    det = phase_determinism(device)
    print(json.dumps({"determinism": det}), flush=True)

    stack = contextlib.ExitStack()  # phase 4's log and tum.txt stay for phase 7c
    cli_dir = stack.enter_context(tempfile.TemporaryDirectory(prefix="chip_smoke_cli_"))
    cli = phase_cli(device, cli_dir)
    print(json.dumps({"cli": cli, "gpu": ident}), flush=True)
    cli_launches = cli["main"]["launches"]
    if cli_launches["patch_sample"] <= 0:
        raise AssertionError("CLI run: patch_sample was never launched")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_street_") as log_dir:
        t0 = time.perf_counter()
        loop = phase_loop(device, log_dir)
        loop["phase_s"] = time.perf_counter() - t0
        print(json.dumps({"phase5a_loop": loop, "gpu": ident}), flush=True)
        t0 = time.perf_counter()
        gnss, seq = phase_gnss(device, log_dir)
        gnss["phase_s"] = time.perf_counter() - t0
        print(json.dumps({"phase5b_gnss": gnss, "gpu": ident}), flush=True)
    t0 = time.perf_counter()
    matcher = phase_matcher(device, seq)
    matcher["phase_s"] = time.perf_counter() - t0
    del seq
    print(json.dumps({"phase5c_matcher": matcher, "gpu": ident}), flush=True)
    gnss_launches = gnss["launches"]

    with tempfile.TemporaryDirectory(prefix="chip_smoke_bag_") as log_dir:
        t0 = time.perf_counter()
        bag = phase_bag(device, log_dir)
        bag["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"phase6_bag": bag, "gpu": ident}, default=str), flush=True)
    bag_launches = bag["6a"]["launches"]

    with stack, tempfile.TemporaryDirectory(prefix="chip_smoke_p7_") as p7_dir:
        t0 = time.perf_counter()
        multi = phase_multi(device, cli_dir, p7_dir)
        multi["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"phase7_multi": multi, "gpu": ident}, default=str), flush=True)
    p7_launches = multi["7a"]["launches"]

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as train_dir:
        t0 = time.perf_counter()
        train = phase_train(device, train_dir)
        train["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"phase8_train": train, "gpu": ident}, default=str), flush=True)
    p8_launches = train["launches"]

    kernels = []
    for r in k1:
        kernels.append(dict(
            name="extract_windows", route="cuda",
            source="fastlivo_tpu_torch/csrc/extract_windows.cu",
            replaces="fastlivo_tpu/ops/pallas_windows.py:66",
            launches=livo["launches"]["extract_windows"], on_main_path=False,
            launches_cli=cli_launches["extract_windows"],
            launches_5b=gnss_launches["extract_windows"],
            launches_6a=bag_launches["extract_windows"],
            launches_7=p7_launches["extract_windows"],
            launches_8=p8_launches["extract_windows"],
            max_abs_err=r["max_abs_err"],
            ms=r["kernel_ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by="bytes", library_ms=r["library_ms"],
            img=[r["hp"], r["wp"]], win=r["win"], n=r["n"],
            kernel_us=r["kernel_ms"] * 1e3, plain_us=r["plain_ms"] * 1e3,
            library_us=r["library_ms"] * 1e3, bound_us=r["bound_ms"] * 1e3,
            bound_2nw2_us=r["bound_2nw2_ms"] * 1e3,
            eager_us=dict(kernel=r["kernel_eager_ms"] * 1e3, plain=r["plain_eager_ms"] * 1e3,
                          library=r["library_eager_ms"] * 1e3),
        ))
    for r in psr:
        kernels.append(dict(
            name="patch_sample", route="cuda",
            source="fastlivo_tpu_torch/csrc/patch_sample.cu",
            replaces="fastlivo_tpu/ops/pallas_windows.py:66",
            fuses="fastlivo_tpu/ops/image.py:229",
            launches=livo["launches"]["patch_sample"], on_main_path=True,
            launches_profiled=livo["profile"]["patch_sample_counted"],
            runs_profiled=livo["profile"]["patch_sample_ran"],
            launches_cli=cli_launches["patch_sample"],
            launches_cli_per_frame=cli["main"]["patch_sample_per_frame"],
            launches_5b=gnss_launches["patch_sample"],
            launches_5b_per_frame=gnss["patch_sample_per_frame"],
            launches_6a=bag_launches["patch_sample"],
            launches_6a_per_frame=bag["6a"]["patch_sample_per_frame"],
            launches_7=p7_launches["patch_sample"],
            launches_7_per_frame=p7_launches["patch_sample"] / multi["7a"]["frames"],
            launches_8=p8_launches["patch_sample"],
            max_abs_err=r["max_abs_err"],
            ms=r["kernel_ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by="bytes", library_ms=r["library_ms"],
            case=r["case"], n=r["n"], levels=r["levels"], patch=r["patch"], grads=r["grads"],
            nan_outputs=r["nan_outputs"],
            kernel_us=r["kernel_ms"] * 1e3, plain_us=r["plain_ms"] * 1e3,
            library_us=r["library_ms"] * 1e3, bound_us=r["bound_ms"] * 1e3,
            eager_us=dict(kernel=r["kernel_eager_ms"] * 1e3, plain=r["plain_eager_ms"] * 1e3,
                          library=r["library_eager_ms"] * 1e3),
        ))
    for r in imu_rows:
        kernels.append(dict(
            name="imu_propagate", route="cuda",
            source="fastlivo_tpu_torch/csrc/imu_propagate.cu",
            replaces="fastlivo_tpu/models/imu.py:57 (lax.scan; no Pallas kernel)",
            launches=livo["launches"]["imu_propagate"], on_main_path=True,
            launches_cli=cli_launches["imu_propagate"],
            launches_5b=gnss_launches["imu_propagate"],
            launches_6a=bag_launches["imu_propagate"],
            launches_7=p7_launches["imu_propagate"],
            launches_8=p8_launches["imu_propagate"],
            max_rel_err=r["max_rel_err"], kind=r["kind"], m=r["m"], n_valid=r["n_valid"],
            cov_steps=r["cov_steps"], dependent_fmas=r["dependent_fmas"],
            ms=r["kernel_ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by="dependent chain",
            kernel_us=r["kernel_ms"] * 1e3, plain_us=r["plain_ms"] * 1e3, bound_bytes_us=r["bound_ms"] * 1e3,
            eager_us=dict(kernel=r["kernel_eager_ms"] * 1e3, plain=r["plain_eager_ms"] * 1e3),
        ))
    for r in knn_rows:
        kernels.append(dict(
            name="voxel_knn", route="cuda",
            source="fastlivo_tpu_torch/csrc/voxel_knn.cu",
            replaces="fastlivo_tpu/maps/voxel_map.py:640 (a lax.top_k loop; no Pallas kernel)",
            launches=livo["launches"]["voxel_map.knn"], on_main_path=True,
            launches_cli=cli_launches["voxel_map.knn"],
            launches_5b=gnss_launches["voxel_map.knn"],
            launches_6a=bag_launches["voxel_map.knn"],
            launches_7=p7_launches["voxel_map.knn"],
            launches_8=p8_launches["voxel_map.knn"],
            dtype=r["dtype"], n=r["n"], k=r["k"], offsets=r["offsets"],
            ms=r["kernel_ms"], plain_ms=r["plain_eager_ms"], bound_ms=r["bound_ms"], bound_by="bytes",
            kernel_us=r["kernel_ms"] * 1e3, plain_us=r["plain_eager_ms"] * 1e3,
            plain_device_us=r["plain_device_ms"] * 1e3, bound_us=r["bound_ms"] * 1e3,
            bound_no_reuse_us=r["bound_no_reuse_ms"] * 1e3,
            eager_us=dict(kernel=r["kernel_eager_ms"] * 1e3, plain=r["plain_eager_ms"] * 1e3),
        ))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"gpu": ident, "kernels": kernels, "patch_sample_host_ns": ps_split, "livo": livo, "determinism": det, "cli": cli,
                       "phase5a_loop": loop, "phase5b_gnss": gnss, "phase5c_matcher": matcher,
                       "phase6_bag": bag, "phase7_multi": multi, "phase8_train": train}, f, indent=1,
                      default=str)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
