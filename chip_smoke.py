"""Drive the PyTorch port of the LIVO cycle on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure raises and the script exits nonzero; it prints no
result line without a CUDA device):

0. device check: the card's name and power limit (nvidia-smi), then the
   CUDA kernels are built from fastlivo_tpu_torch/csrc with nvcc.
1. kernels: each CUDA kernel against its plain PyTorch version on the
   card, at the shapes the LIVO path gives it (bitwise), with CUDA-event
   times for the kernel, the plain version and one PyTorch library call.
2. LIVO: bootstrap_map, then lio_scan_step (surfel) + vio_scan_step pairs
   at the flagship sizes (81,920 raw points, 65,536 budget, 2^18 arena,
   640x512 camera) on a periodic circular room trajectory with matching
   IMU samples and rendered frames. Launch counts are reset just before
   the timed pairs and read just after.
3. determinism: the same short sequence twice from one seed; trajectories
   and the map's counts/meta must match bitwise.

The last two lines of standard output are the kernels' JSON record and
`{"ok": true, "device": {...}}`. The scene helpers (`Scene`) are plain
numpy so the CPU tests can feed the same inputs to both packages.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
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
    return rows


def _summary_np(x):
    return np.asarray(x.detach().cpu().numpy(), np.float64)


class LivoRun:
    """bootstrap_map at construction, then one LIVO pair per `pair` call."""

    def __init__(self, cfg, scene: Scene, device):
        import torch

        from fastlivo_tpu_torch import convert
        from fastlivo_tpu_torch.maps import visual_map as vmap_mod
        from fastlivo_tpu_torch.maps import voxel_map as vm
        from fastlivo_tpu_torch.models import pipeline as pl

        self.cfg, self.scene, self.device, self.pl = cfg, scene, device, pl
        self.i3 = torch.eye(3, dtype=torch.float32, device=device)
        self.z3 = torch.zeros(3, dtype=torch.float32, device=device)
        self.rot_ci = torch.as_tensor(ROT_CI).to(device)
        self.state = convert.nav_state_from_numpy(scene.initial_state(), device)
        self.vmap = vmap_mod.make_visual_map(cfg.vm_cfg, device=device)
        self.lmap = pl.bootstrap_map(
            vm.make_map(cfg.map_cfg, device=device),
            to_scan_input(scene.bootstrap_scan(), device), self.state, self.i3, self.z3, cfg,
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
        self.state, self.lmap, _, cloud, lsum = self.pl.lio_scan_step(
            self.state, self.lmap, inp["scan"], self.i3, self.z3, self.cfg
        )
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


def profile_pairs(run, inputs):
    """torch.profiler over a few pairs: device time per pair (summed over
    kernel events only: an operator's entry repeats its kernels' time) and
    the operators that take it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        finish([run.pair(inp) for inp in inputs])
    ka = prof.key_averages()
    kernels = [e for e in ka if e.device_type == DeviceType.CUDA]
    ops = [e for e in ka if e.device_type == DeviceType.CPU and _device_us(e) > 0]
    top = sorted(ops, key=_device_us, reverse=True)[:15]
    return dict(
        pairs=len(inputs),
        device_ms_per_pair=sum(_device_us(e) for e in kernels) / 1e3 / len(inputs),
        kernels_per_pair=sum(e.count for e in kernels) / len(inputs),
        top_ops=[dict(name=e.key[:90], calls=e.count, device_ms=_device_us(e) / 1e3) for e in top],
    )


def count_syncs(run, inp):
    """Host synchronizations in one LIO step and one VIO step, counted by
    torch's sync debug mode (one warning per synchronizing call)."""
    import warnings

    import torch

    def syncs(caught):
        return sum("synchroniz" in str(w.message) for w in caught)

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            cloud, lsum = run.lio(inp)
        n_lio = syncs(caught)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            vsum = run.vio(inp, cloud)
        n_vio = syncs(caught)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    finish([dict(k=inp["k"], lio=lsum, vio=vsum)])
    return dict(lio=n_lio, vio=n_vio)


def phase_livo(device, n_warm=3, n_timed=20, n_profile=2):
    """Flagship LIVO: warm-up pairs, then the timed pairs with the launch
    counts reset just before and read just after; then a profiled window
    and one pair under the sync counter."""
    import torch

    from fastlivo_tpu_torch.ops import pallas_windows as pw

    run = LivoRun(flagship_config(), Scene(n_raw=81920, imu_m=32, seed=0), device)
    warm = run.make_inputs(n_warm)
    timed_in = run.make_inputs(n_timed)
    extra = run.make_inputs(n_profile + 1)
    records = [run.pair(inp) for inp in warm]
    torch.cuda.synchronize()
    for key in pw.LAUNCHES:
        pw.LAUNCHES[key] = 0
    timed = [run.pair(inp, timed=True) for inp in timed_in]
    torch.cuda.synchronize()
    launches = dict(pw.LAUNCHES)
    records = finish(records + timed)
    check_records(records)
    if min(r["vio"][7] for r in timed) <= 0:
        raise AssertionError("n_selected is 0 on a timed pair")
    n_k1 = launches["extract_windows"]
    # Per frame: 1 (select) + one per update iteration (3..30) + 6 (maintain).
    if not len(timed) * 10 <= n_k1 <= len(timed) * 37:
        raise AssertionError(f"extract_windows launched {n_k1} times in {len(timed)} frames")

    prof = profile_pairs(run, extra[:n_profile])
    syncs = count_syncs(run, extra[n_profile])
    lio_ms = [r["lio_ms"] for r in timed]
    vio_ms = [r["vio_ms"] for r in timed]
    pair_ms = float(np.median(np.add(lio_ms, vio_ms)))
    prof["device_idle_share"] = 1.0 - prof["device_ms_per_pair"] / pair_ms
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


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from fastlivo_tpu_torch.ops import cuda_build

    device = torch.device("cuda")
    ident = gpu_identity()
    print(ident, flush=True)
    t0 = time.perf_counter()
    libs = cuda_build.build_all()
    print(json.dumps({"build_s": time.perf_counter() - t0,
                      "libraries": sorted(p.name for p in libs.values())}), flush=True)

    k1 = phase_kernels(device)

    livo = phase_livo(device)
    print(json.dumps({"livo": livo, "gpu": ident}), flush=True)

    det = phase_determinism(device)
    print(json.dumps({"determinism": det}), flush=True)

    kernels = []
    for r in k1:
        kernels.append(dict(
            name="extract_windows", route="cuda",
            source="fastlivo_tpu_torch/csrc/extract_windows.cu",
            replaces="fastlivo_tpu/ops/pallas_windows.py:66",
            launches=livo["launches"]["extract_windows"],
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
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
