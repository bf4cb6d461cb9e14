"""The benchmark's runner: one cell of BENCHMARK.json, one seed, one run.

    python3 livobench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (counted in `setup_s`, from process start to the window): imports,
the CUDA context, the pool of records for the cell's traffic drawn from
the seed on the card, the port's `LivoPipeline` for the cell's
configuration, then the records of the lead-in (rest, static
initialization, EKF warm-up, the speed ramp) and of `setup_laps` whole
laps, through the same path as the window. The first run in a checkout
also builds the port's CUDA kernel there (`fastlivo_tpu_torch/_build/`).

The window replays the pool lap after lap for `--seconds` through the
port's on-line path, closed-loop with one caller: each record is pushed
into `io.sync.MeasurementSynchronizer` only after the previous group's
update returned; each group is built by `io.sync.WindowBuilder` and goes to
`LivoPipeline.process_scan` (scan end) or `process_image` (frame), which
return with the update's pose on the host (`lio.scan_batch` 1). An update's
latency runs from the push of the record that completed its group to that
return.

With `--trace 1` the window is the same, and inside it a few scan cycles
run under `torch.profiler` and a few more under torch's sync debug mode;
the per-layer metrics come from those and from the harness's spans.

After the window the program's state is freed and the configuration's
checks (`check.py`, `livobench/checks/`) hold what they kept of it to the
plain reference (`livobench/reference/`): they decide `correct`.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "fastlivo_tpu")  # top-level module names, whole
PROFILE_CYCLES = 3  # scan cycles under torch.profiler in a traced run
SYNC_CYCLES = 2  # scan cycles under the sync debug mode in a traced run
PROFILE_AT = 0.3  # share of the window after which the profiled cycles start
CACHE = ROOT / "_livobench_cache"  # build and kernel caches, inside the checkout
HOST_CORES = 4  # the run's process keeps to the last four cores it may use


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def _ms(x):
    return "-" if x is None else f"{x * 1e3:.3f}"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# The cell.
# ---------------------------------------------------------------------------


class Cell:
    """A workload of BENCHMARK.json with its configuration file, traffic
    file, limits file and metric entries (those that name it, or name no
    cells), each read from the benchmark's folder under `root`, and the
    folder of its checks."""

    def __init__(self, bench: dict, name: str, root: Path = ROOT):
        here = root / HERE.relative_to(ROOT)
        works = {w["name"]: w for w in bench["workloads"]}
        if name not in works:
            raise SystemExit(f"livobench: no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.workload = works[name]
        conf = {c["name"]: c for c in bench["configs"]}[self.workload["config"]]
        self.config_file = load_json(root / conf["file"])
        # The float type the program runs in: the configuration file's
        # `precision`, float32 where it names none.
        self.precision = self.config_file.get("precision", "float32")
        self.traffic = load_json(here / "traffic" / f"{self.workload['traffic']}.json")
        self.checks_dir = here / "checks"
        limits = here / "limits" / f"{name}.json"
        self.limits = load_json(limits) if limits.exists() else None
        self.end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [
            m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)
        ]


def program_config(tree: dict, overrides: dict):
    """The port's own reading of a configuration tree."""
    from fastlivo_tpu_torch.utils import config as pc

    cfg = pc.load_config(None)
    pc.apply_reference_yaml(cfg, tree)
    for dotted, value in overrides.items():
        section, field = dotted.split(".", 1)
        pc._set_field(getattr(cfg, section), field, value)
    return cfg


def reference_config(tree: dict, overrides: dict):
    """The reference's reading of the same tree."""
    from livobench.reference import params

    return params.read(tree, overrides)


def reader(metric: str):
    """The `read(rec)` of livobench/metrics/<metric>.py."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"livobench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ---------------------------------------------------------------------------
# The replay.
# ---------------------------------------------------------------------------


class Replay:
    """The port's on-line path for one pool: synchronizer, window builder
    and pipeline, fed one record at a time, as `run.replay` composes them.
    With `precision` float64 the pipeline holds its state in float64 and
    each window's arrays are handed to it in float64."""

    def __init__(self, cfg, device, precision: str = "float32"):
        import torch

        from fastlivo_tpu_torch.io import sensors
        from fastlivo_tpu_torch.io.sync import MeasurementSynchronizer, WindowBuilder
        from fastlivo_tpu_torch.models.pipeline import LivoPipeline

        self.sensors = sensors
        self.f64 = precision == "float64"
        self.pipe = LivoPipeline(cfg, dtype=torch.float64 if self.f64 else torch.float32, device=device)
        ident = (1, 0, 0, 0, 1, 0, 0, 0, 1)
        self.sync = MeasurementSynchronizer(
            img_enabled=cfg.vio.img_enable,
            img_delta_time=cfg.vio.delta_time,
            imu_acc_scale=cfg.imu.acc_scale_factor,
            imu_axis_remap=None if tuple(cfg.imu.axis_remap) == ident else cfg.imu.axis_remap,
        )
        self.builder = WindowBuilder(n_pts=cfg.lio.max_points * 2, imu_window=cfg.imu.imu_int_frame)
        self.group = -1  # ordinal of the last group, from the first record on

    def push(self, r):
        s = self.sensors
        if r.kind == "imu":
            self.sync.push_imu(s.ImuSample(stamp=r.stamp, gyr=r.data[0], acc=r.data[1]))
        elif r.kind == "lidar":
            self.sync.push_lidar(s.LidarScan(stamp=r.stamp, pts=r.data[0], t_offs_ms=r.data[1]))
        else:
            self.sync.push_image(s.ImageFrame(stamp=r.stamp, img=r.data[0]))

    def next_group(self):
        g = self.sync.next_group()
        if g is not None:
            self.group += 1
        return g

    def build(self, g):
        scan, t_abs = self.builder.build(g)
        if self.f64:
            f = np.float64
            scan = scan._replace(pts=scan.pts.astype(f), t_offs=scan.t_offs.astype(f), t_end=f(scan.t_end),
                                 imu=scan.imu._replace(stamps=scan.imu.stamps.astype(f),
                                                       gyr=scan.imu.gyr.astype(f), acc=scan.imu.acc.astype(f)))
            return scan._replace(acc_scale=f(self.pipe.acc_scale)), t_abs
        return scan._replace(acc_scale=np.float32(self.pipe.acc_scale)), t_abs

    def update(self, g, scan, t_abs):
        if g.is_lidar_end:
            return self.pipe.process_scan(scan, t_abs)
        return self.pipe.process_image(scan, g.measures[-1].img.img, t_abs)


def _setup_replay(rep: Replay, pool, keeper, laps: int):
    """The lead-in and `laps` laps; `keeper` (the cell's `check.Checks`)
    keeps the program's first LIO update and the VIO update after it."""
    end = pool.lap0 + laps * pool.period
    for r in pool.stream():
        if r.stamp >= end - 1e-9:
            return
        rep.push(r)
        while (g := rep.next_group()) is not None:
            scan, t_abs = rep.build(g)
            out = rep.update(g, scan, t_abs)
            if keeper.start is None:
                if g.is_lidar_end and out is not None:
                    keeper.first_lio(rep.pipe, rep.group, out)
            elif keeper.wants_vio(rep.group):
                if g.is_lidar_end:
                    keeper.drop_vio()
                else:
                    keeper.after_vio(rep.pipe)


class Window:
    """What the window records: per-update latency and step time by kind,
    the synchronizer and builder's time, and what the traced cycles hold."""

    def __init__(self):
        self.lat = {"lio": [], "vio": []}
        self.step = {"lio": [], "vio": []}
        self.sync_s = 0.0
        self.attempted = 0
        self.trace = None
        self.syncs = None
        self.first_stamp = None  # the window's first record
        self.tenths = [0] * 10  # LIO updates in each tenth of the window


def run_window(rep: Replay, pool, keeper, seconds: float, traced: bool, cuda: bool):
    """Replay laps from the set-up's end for `seconds`; returns a Window.
    `keeper` (the cell's `check.Checks`) keeps the checked cycles.

    Traced, the instruments switch only as a LIO update is about to run,
    so each holds whole scan cycles (a LIO update and the frames after
    it): PROFILE_CYCLES under the profiler recording the device alone
    from PROFILE_AT of the window on (busy time, window, kernels), then
    PROFILE_CYCLES under the profiler recording host operations and the
    harness's spans too (the `voxel_map.knn` range, idle gaps by host
    span), then SYNC_CYCLES under the sync counter. Their start and stop
    are kept out of the window and out of the latencies; the step spans of
    instrumented cycles are left out of the step medians."""
    import torch

    from livobench import profiling as tr

    w = Window()
    stream = pool.stream(first_lap=pool.setup_laps, with_lead=False)
    rejected0 = rep.pipe.health["rejected"]
    mode = "plain"  # traced: then "device", "host", "syncs", "done"
    prof = syncs = None
    dev_rec = None
    n_lio = n_vio = 0  # updates run under the current instrument
    off = contextlib.nullcontext()

    def span(name):
        return prof.span(name) if mode == "host" else off

    clock = time.perf_counter
    t0 = clock()
    deadline = t0 + seconds
    for r in stream:
        t_push = clock()
        if t_push >= deadline:
            break
        if w.first_stamp is None:
            w.first_stamp = r.stamp
        with span("push"):
            rep.push(r)
        t1 = clock()
        w.sync_s += t1 - t_push
        while True:
            with span("sync"):
                g = rep.next_group()
            t2 = clock()
            w.sync_s += t2 - t1
            if g is None:
                break
            with span("build"):
                scan, t_abs = rep.build(g)
            t3 = clock()
            w.sync_s += t3 - t2
            kind = "lio" if g.is_lidar_end else "vio"
            if kind == "lio" and traced:
                if mode == "plain" and t3 - t0 >= PROFILE_AT * seconds:
                    prof = tr.Profile(cuda, host=False)
                    prof.start()
                    mode, n_lio, n_vio = "device", 0, 0
                elif mode == "device" and n_lio >= PROFILE_CYCLES:
                    dev_rec = prof.stop(n_lio, n_vio)
                    prof = tr.Profile(cuda, host=True)
                    prof.start()
                    mode, n_lio, n_vio = "host", 0, 0
                elif mode == "host" and n_lio >= PROFILE_CYCLES:
                    w.trace = tr.merge(dev_rec, prof.stop(n_lio, n_vio))
                    syncs = tr.SyncCount(cuda)
                    syncs.start()
                    mode, n_lio = "syncs", 0
                elif mode == "syncs" and n_lio >= SYNC_CYCLES:
                    w.syncs = syncs.stop(n_lio)
                    mode = "done"
            instrumented = mode in ("device", "host", "syncs")
            if kind == "lio" and not instrumented and keeper.due(t3 - t0):
                # Kept states are copied to the host: never inside the
                # instruments, whose device time and syncs they would join.
                keeper.before_lio(rep.pipe, rep.group)
            aside = clock() - t3  # the harness's own work: out of the window
            deadline += aside
            w.attempted += 1
            t_up = clock()
            with span(kind):
                out = rep.update(g, scan, t_abs)
            t4 = clock()
            if kind == "lio" and keeper.open is not None:
                keeper.after_lio(rep.pipe, out)
            elif keeper.wants_vio(rep.group):
                if kind == "lio":
                    keeper.drop_vio()
                else:
                    keeper.after_vio(rep.pipe)
            n_lio += kind == "lio"
            n_vio += kind == "vio"
            if t4 <= deadline:
                w.lat[kind].append(t4 - t_push - aside)
                if kind == "lio":
                    w.tenths[min(int(10 * (t4 - t0) / seconds), 9)] += 1
                if not instrumented:
                    w.step[kind].append(t4 - t_up)
            t5 = clock()
            deadline += t5 - t4  # the kept states' copies
            t1 = t5
    if mode == "device":
        w.trace = tr.merge(prof.stop(max(n_lio, 1), n_vio), None)
    elif mode == "host":
        w.trace = tr.merge(dev_rec, prof.stop(max(n_lio, 1), n_vio))
    elif mode == "syncs":
        w.syncs = syncs.stop(max(n_lio, 1))
    if cuda:
        torch.cuda.synchronize()
    w.window_s = seconds
    w.rejected = rep.pipe.health["rejected"] - rejected0
    return w


def window_ate(pipe, pool, first_stamp: float) -> float:
    """ATE of the window's poses against the motion, in the filter's world
    (the rig's frame at rest)."""
    from livobench.stats import ate_rmse

    rows = [(t, p) for t, p, _ in pipe.trajectory if t >= first_stamp]
    if not rows:
        return float("nan")
    t = np.array([r[0] for r in rows])
    rot0, pos0 = pool.motion.pose(0.0)
    _, pos = pool.motion.pose(t)
    gt = (pos - pos0) @ rot0[0]  # R0^T (p - p0)
    return ate_rmse(np.stack([r[1] for r in rows]), gt)


# ---------------------------------------------------------------------------
# One run.
# ---------------------------------------------------------------------------


def window_times(seed: int, seconds: float, n: int):
    """When, in window seconds, the checked cycles are taken: n draws from
    the seed, spread over the window's first nine tenths, in order."""
    rng = np.random.default_rng([int(seed), 7])
    return sorted(float(x) for x in rng.uniform(0.05, 0.9, n) * seconds)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, overrides: dict | None = None, traffic: dict | None = None):
    """Run one cell; returns (result dict, check lines). `overrides`
    (dotted config fields) and `traffic` (a replacement traffic dict) are
    for the CPU tests' small sizes only."""
    import torch

    from livobench import check, pool as pool_mod
    from livobench.stats import quantile

    overrides = overrides or {}
    traffic = traffic or cell.traffic
    tree = cell.config_file["config"]
    cuda = torch.device(device).type == "cuda"
    t_in = time.perf_counter()
    if cuda:
        torch.cuda.reset_peak_memory_stats()  # the CUDA context
    t_ctx = time.perf_counter()
    rcfg = reference_config(tree, overrides)
    keeper = check.Checks(cell.config_file, rcfg, window_times(seed, seconds, int(traffic["check"]["samples"])),
                          cell.checks_dir)
    limits = cell.limits or {}
    if not limits:
        raise SystemExit(f"livobench: no limits/{cell.name}.json: nothing would decide `correct`")
    unknown = [n for n in limits if n not in keeper.numbers]
    if unknown:
        raise SystemExit(f"livobench: limits/{cell.name}.json names {', '.join(unknown)}, which no check of "
                         f"the cell returns")
    pool = pool_mod.build_pool(traffic, rcfg, seed, device)
    if cuda:
        torch.cuda.synchronize()
    t_pool = time.perf_counter()
    cfg = program_config(tree, overrides)
    rep = Replay(cfg, device, cell.precision)
    _setup_replay(rep, pool, keeper, pool.setup_laps)
    if keeper.start is None:
        raise RuntimeError("no LIO update ran in set-up")
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    _log(f"livobench: set-up {setup_s:.3f} s: imports {t_in - t_start:.3f}, CUDA context "
         f"{t_ctx - t_in:.3f}, pool {t_pool - t_ctx:.3f}, pipeline, lead-in and "
         f"{pool.setup_laps} lap(s) {time.perf_counter() - t_pool:.3f}")
    w = run_window(rep, pool, keeper, seconds, trace, cuda)
    w.setup_s = setup_s
    found = forbidden_modules()
    if found:
        raise SystemExit(f"livobench: loaded after the window: {', '.join(found)}")
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    _log(f"livobench: window ATE {window_ate(rep.pipe, pool, w.first_stamp):.6f} m against the "
         "generator's motion (not compared)")
    n_lio, n_vio = len(w.lat["lio"]), len(w.lat["vio"])
    _log(f"livobench: window {seconds:g} s: {n_lio} LIO updates, {n_vio} VIO updates "
         f"(latency samples), {w.attempted} attempted, {w.rejected} rejected, "
         f"{len(keeper.cycles)} checked cycles; latency medians LIO "
         f"{_ms(quantile(w.lat['lio'], 0.5))} VIO {_ms(quantile(w.lat['vio'], 0.5))} ms; "
         f"LIO updates per tenth of the window {w.tenths}")

    _log(f"livobench: after the window: {arena_fill(rep.pipe)}")
    if w.trace is not None:
        t = w.trace
        host = (f"{t['host_window_s'] / t['host_scans']:.4f}" if t["host_scans"] else "-")
        _log(f"livobench: traced cycles: {t['window_s'] / t['scans']:.4f} s each recording the device "
             f"alone, {host} s recording host operations too; untraced LIO+VIO step medians "
             f"{_ms(quantile(w.step['lio'], 0.5))} + {_ms(quantile(w.step['vio'], 0.5))} ms")
    rec = {
        "window_s": w.window_s, "setup_s": w.setup_s, "scans": n_lio, "frames": n_vio,
        "lio_latency_s": w.lat["lio"], "vio_latency_s": w.lat["vio"],
        "lio_step_s": w.step["lio"], "vio_step_s": w.step["vio"], "sync_s": w.sync_s,
        "trace": w.trace, "syncs": w.syncs,
    }
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    keeper.after_window(rep.pipe)

    # The check: the program's state goes, the reference comes.
    del rep
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    gaps = keeper.gaps(rcfg, tree, pool, device, log=_log)
    _log(f"livobench: the check took {time.perf_counter() - t_check:.3f} s")
    for name in sorted(set(gaps) - set(limits)):
        _log(f"livobench: {name} {gaps[name]!r} (read, not compared: no limit holds it; PERF.md)")
    ok, lines = check.judge(gaps, limits)
    result = {
        "correct": bool(ok),
        "attempted": w.attempted,
        "failed": w.rejected,
        "metrics": metrics,
        "device": device_info(cuda, peak, w.trace),
    }
    if trace and w.trace is not None:
        result["breakdown"] = {"device_ops": w.trace["device_ops"], "idle_gaps": w.trace["idle_gaps"]}
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim, _ in lines}
    return result, lines


def arena_fill(pipe) -> str:
    """How full the voxel arena and the visual map are."""
    from livobench.check import ARENA_EMPTY

    m = pipe.map
    slots = m.counts.shape[0]
    used = int((m.meta.reshape(slots, -1)[:, 0] != ARENA_EMPTY).sum())
    out = (f"voxel arena {used} of {slots} slots ({used / slots:.4f}), "
           f"{int(m.counts.sum())} points of {slots * (m.slab.shape[1] // 3)}")
    if pipe.step_cfg.cam is not None:
        out += f"; visual map {int(pipe.visual_map.active.sum())} of {pipe.visual_map.active.shape[0]} points"
    return out


def device_info(cuda: bool, peak: int, trace):
    import torch

    if cuda:
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
                "memory_peak_bytes": int(peak)}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if trace is not None:
        info["busy_s"] = trace["busy_s"]
        info["window_s"] = trace["window_s"]
    return info


def card_line():
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def pin_host():
    """Keep the process to a fixed set of cores (the last HOST_CORES of
    those it may use) and torch's host math to one thread."""
    import torch

    cores = sorted(os.sched_getaffinity(0))[-HOST_CORES:]
    os.sched_setaffinity(0, cores)
    torch.set_num_threads(1)
    return cores


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(CACHE / sub)
    bench = load_json(ROOT / "BENCHMARK.json")
    cell = Cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.workload["chips"]:
        _log(f"livobench: {cell.name} needs {cell.workload['chips']} CUDA device(s); "
             f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    _log(f"livobench: {cell.name} seed {args.seed}: torch imported at "
         f"{time.perf_counter() - t_start:.3f} s")
    warnings.filterwarnings("ignore", category=UserWarning, module="torch.profiler")
    _log(f"livobench: host cores {pin_host()}, one host math thread")
    result, lines = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    _log(f"livobench: on {card_line()}")
    # The numbers compared, each beside its limit: the last lines of both streams.
    for name, value, lim, good in lines:
        _log(f"check {name} {value!r} limit {lim!r} {'ok' if good else 'FAIL'}")
    print(json.dumps(result), flush=True)
    return 0
