"""The port's tracer (`fastlivo_tpu_torch/utils/timing.py`) on the CPU,
over the LIO pipeline on the port's synthetic room (the recipe of
tests/test_torch_scan_batch.py at smaller widths):

- (a) off, a run records no spans, the counters still count, and the poses
  equal a traced run's bit for bit;
- (b) on, each LIO update after the warm-up is one `pipeline.process_scan`
  span whose children are the copy in, the step's five phases and the
  read-back, all of the update's id, each ESKF phase under `lio.eskf`,
  each `voxel_map.knn` under a `lio.eskf.search` and the claim rounds, where
  the insert ran any, in one `map.claim` under `lio.insert`;
- (c) per update, `lio.eskf.trips` is LioInfo.iterations and
  `lio.eskf.searches` the kNN searches (one plus the re-matches);
- (d) under torch.profiler with profiler ranges on, the spans are ranges and
  `voxel_map.knn` nests inside `lio.eskf.search`; with ranges off only
  `voxel_map.knn` (a range in every profile) appears;
- (e) a full buffer counts `dropped` and does not grow;
- (f) self time is the duration less the union of the children's intervals;
- the CLI's `--profile` carries the spans (VIO's too) into its chrome trace
  and prints the span table and the counters per scan;
- with the camera on, each VIO update is one `pipeline.process_image` span
  holding one `pipeline.image_to_device`, `vio.selected` adds up
  `LivoPipeline.n_selected` (read back per update or at a flush), and the
  poses equal an untraced run's bit for bit.
"""

import contextlib
import json
import os
from typing import NamedTuple

import numpy as np
import pytest
import torch

from fastlivo_tpu_torch import run as trun
from fastlivo_tpu_torch.io import logio as TLOG
from fastlivo_tpu_torch.io import synthetic as TSYN
from fastlivo_tpu_torch.io.sync import MeasurementSynchronizer, WindowBuilder
from fastlivo_tpu_torch.maps import voxel_map as TV
from fastlivo_tpu_torch.models.pipeline import LivoPipeline
from fastlivo_tpu_torch.ops.camera import Pinhole
from fastlivo_tpu_torch.utils import timing
from fastlivo_tpu_torch.utils.config import load_config

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SETS = {"lio.max_points": 2048, "map.capacity": 1 << 14, "imu.imu_int_frame": 32, "vio.img_enable": False}
STEP = ("pipeline.to_device", "lio.propagate", "lio.undistort", "lio.downsample", "lio.eskf", "lio.insert",
        "pipeline.readback")
ESKF = {"lio.eskf.search", "lio.eskf.innovation", "lio.eskf.solve"}


class Update(NamedTuple):
    ordinal: int  # the pipeline's update id
    info: object  # LioInfo, or None in the initialization and warm-up
    delta: dict  # the counters it added
    knn_calls: int


def drive(seq, around=None):
    """Push the sequence's records in time order through the synchronizer,
    the builder and the pipeline; `around(k)` wraps the k-th update."""
    cfg = load_config(None, SETS)
    pipe = LivoPipeline(cfg, device="cpu")
    sync = MeasurementSynchronizer(img_enabled=False)
    builder = WindowBuilder(cfg.lio.max_points * 2, cfg.imu.imu_int_frame)
    imu = iter(seq.imu)
    pending = next(imu)
    updates = []
    for scan in seq.scans:
        sync.push_lidar(scan)
        while pending is not None and pending.stamp < scan.end_time + 0.05:
            sync.push_imu(pending)
            pending = next(imu, None)
        while (group := sync.next_group()) is not None:
            scan_input, t_abs = builder.build(group)
            scan_input = scan_input._replace(acc_scale=np.float32(pipe.acc_scale))
            before, knn0 = timing.counters(), KNN_CALLS[0]
            with around(len(updates)) if around else contextlib.nullcontext():
                info = pipe.process_scan(scan_input, t_abs)
            delta = timing.counter_delta(timing.counters(), before)
            updates.append(Update(pipe.n_updates, info, delta, KNN_CALLS[0] - knn0))
    return pipe, updates


KNN_CALLS = [0]


@pytest.fixture(scope="module")
def seq():
    return TSYN.generate(duration=2.0, imu_rate=100.0, scan_rate=10.0, pts_per_scan=2000, seed=3, device="cpu")


@pytest.fixture(scope="module")
def runs(seq):
    """(off run, off trace, on run, on trace), kNN calls counted apart."""
    knn = TV.knn

    def counted(*args, **kwargs):
        KNN_CALLS[0] += 1
        return knn(*args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TV, "knn", counted)
        timing.disable()
        timing.drain()
        off = drive(seq)
        off_trace = timing.drain()
        timing.enable()
        try:
            on = drive(seq)
        finally:
            timing.disable()
        on_trace = timing.drain()
    return off, off_trace, on, on_trace


def _lio(updates):
    return [u for u in updates if u.info is not None]


def test_off_records_no_spans_counts_and_matches_on_bitwise(runs):
    (pipe_off, up_off), off_trace, (pipe_on, up_on), on_trace = runs
    assert off_trace.spans == [] and off_trace.dropped == 0
    assert on_trace.spans and on_trace.dropped == 0
    lio = _lio(up_off)
    assert len(lio) >= 6
    for u in lio:
        assert u.delta["lio.eskf.trips"] >= 1 and u.delta["sync.eskf_flags"] == u.delta["lio.eskf.trips"]
        assert u.delta["pipeline.lio_updates"] == 1 and u.delta["sync.readback"] == 1
        assert u.delta["sync.to_device"] == 9  # one per leaf of the ScanInput
    assert [u.delta for u in up_off] == [u.delta for u in up_on]
    assert len(pipe_off.trajectory) == len(pipe_on.trajectory)
    for (ta, pa, qa), (tb, pb, qb) in zip(pipe_off.trajectory, pipe_on.trajectory):
        assert ta == tb and np.array_equal(pa, pb) and np.array_equal(qa, qb)
    assert np.array_equal(pipe_off.map.counts.numpy(), pipe_on.map.counts.numpy())


def test_each_lio_update_is_one_span_of_its_phases(runs):
    _, _, (_, updates), trace = runs
    spans = trace.spans
    kids = {}
    for i, s in enumerate(spans):
        kids.setdefault(s.parent, []).append(i)
    top = {s.update: i for i, s in enumerate(spans) if s.name == "pipeline.process_scan"}
    assert sorted(top) == [u.ordinal for u in updates]  # one span per update
    for u in _lio(updates):
        i = top[u.ordinal]
        assert spans[i].parent == -1
        children = [spans[k] for k in kids.get(i, [])]
        assert tuple(c.name for c in children) == STEP
        assert all(c.update == u.ordinal for c in children)
        eskf = kids[i][STEP.index("lio.eskf")]
        inner = [spans[k] for k in kids[eskf]]
        assert {c.name for c in inner} == ESKF and all(c.update == u.ordinal for c in inner)
        assert sum(c.name == "lio.eskf.solve" for c in inner) == u.info.iterations
        claims = [spans[k].name for k in kids.get(kids[i][STEP.index("lio.insert")], [])]
        # The insert's claim rounds, one span round them all, when a voxel is new.
        assert claims == (["map.claim"] if u.delta.get("map.claim_rounds") else [])
    for i, s in enumerate(spans):
        if s.name == "voxel_map.knn":
            assert spans[s.parent].name == "lio.eskf.search" and s.update == spans[s.parent].update
        if s.name == "map.claim":  # the warm-up's inserts sit in the update's own span
            assert spans[s.parent].name in ("lio.insert", "pipeline.process_scan")
        if s.name.startswith("io."):
            assert s.parent == -1 and s.update == -1
        assert s.t0_ns <= s.t1_ns
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.t0_ns <= s.t0_ns and s.t1_ns <= p.t1_ns
    names = {s.name for s in spans}
    assert {"io.push", "io.next_group", "io.build"} <= names


def test_eskf_counters_per_update(runs):
    (_, updates), _, _, trace = runs
    lio = _lio(updates)
    assert any(u.delta["lio.eskf.searches"] > 1 for u in lio)  # a re-match happened
    for u in lio:
        assert u.delta["lio.eskf.trips"] == int(u.info.iterations)
        assert u.delta["lio.eskf.searches"] == u.knn_calls  # one plus the re-matches
        assert 1 <= u.delta["lio.eskf.searches"] <= 2
    on_lio = _lio(runs[2][1])
    per_update = {}
    for s in runs[3].spans:
        if s.name == "lio.eskf.search":
            per_update[s.update] = per_update.get(s.update, 0) + 1
    assert [per_update[u.ordinal] for u in on_lio] == [u.delta["lio.eskf.searches"] for u in on_lio]


def test_summary_counts_add_no_sync(runs):
    """The downsample's and the insert's counts ride the summary that is
    read back anyway: a LIO update's host synchronizations are the copy in,
    one flag read a trip, the insert's claim checks and the read-back, and
    the counts equal what its summary carried (the builder's are counted on
    the host)."""
    (_, updates), _, _, _ = runs
    for u in _lio(updates):
        syncs = {k: v for k, v in u.delta.items() if k.startswith("sync.")}
        assert syncs == {"sync.to_device": 9, "sync.eskf_flags": u.delta["lio.eskf.trips"],
                         "sync.claim_any": max(u.delta.get("map.claim_rounds", 0), 1), "sync.readback": 1}
        assert u.delta.get("lio.downsample.voxels_dropped", 0) == u.delta.get("map.unclaimed_voxels", 0) == 0
        assert u.delta["map.points_added"] > 0
        assert (u.delta.get("map.fresh_voxels", 0) > 0) == (u.delta.get("map.claim_rounds", 0) > 0)


def test_profiler_ranges_nest(seq):
    """The tracer on for the whole drive; profiler ranges switched on for
    one LIO update after the warm-up (the 15th group) and left off for the
    next, each under torch.profiler on the CPU."""
    from torch.profiler import ProfilerActivity, profile

    got = {14: {}, 15: {}}

    @contextlib.contextmanager
    def around(k):
        if k not in got:
            yield
            return
        timing.set_ranges(k == 14)
        try:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                yield
        finally:
            timing.set_ranges(False)
        for e in prof.events():
            got[k].setdefault(e.name, []).append((e.time_range.start, e.time_range.end))

    timing.enable()
    try:
        _, updates = drive(seq, around)
    finally:
        timing.disable()
    spans = timing.drain().spans
    assert all(u.info is not None for u in updates[14:16])
    ranged, plain = got[14], got[15]
    for name in STEP + tuple(ESKF) + ("pipeline.process_scan", "voxel_map.knn"):
        assert name in ranged, name
    for a, b in ranged["voxel_map.knn"]:
        assert any(s <= a and b <= e for s, e in ranged["lio.eskf.search"])
    program = set(STEP) | ESKF | {"pipeline.process_scan", "io.push", "io.next_group", "io.build"}
    assert not program & set(plain) and "voxel_map.knn" in plain
    # The clock spans ran all along, ranges or not.
    scans = [s.update for s in spans if s.name == "pipeline.process_scan"]
    assert scans == [u.ordinal for u in updates]


def test_full_buffer_counts_dropped_and_keeps_its_size():
    timing.enable(capacity=3)
    try:
        with timing.span("a"):
            with timing.span("a.b"):
                pass
            with timing.span("a.c"):
                with timing.span("a.c.d"):
                    pass
        with timing.span("e", update=7):
            pass
        assert len(timing._S.names) == 3 and len(timing._S.t0) == 3
    finally:
        timing.disable()
    trace = timing.drain()
    assert [s.name for s in trace.spans] == ["a", "a.b", "a.c"] and trace.dropped == 2
    assert [s.parent for s in trace.spans] == [-1, 0, 0]
    assert timing.drain() == timing.Trace([], 0)


def test_self_time_is_duration_less_children_union():
    S = timing.Span
    spans = [
        S("root", -1, 1, 0, 100),
        S("a", 0, 1, 10, 40),
        S("b", 0, 1, 30, 50),  # overlaps a: the union counts 30..40 once
        S("c", 0, 1, 90, 120),  # clipped to the root's end
        S("a.x", 1, 1, 12, 20),
        S("leaf", -1, -1, 200, 205),
    ]
    assert timing.self_ns(spans) == [100 - (40 + 10), 30 - 8, 20, 30, 8, 5]


def test_self_time_of_a_recorded_run(runs):
    spans = runs[3].spans
    own = timing.self_ns(spans)
    has_kids = {s.parent for s in spans}
    for i, (s, o) in enumerate(zip(spans, own)):
        assert 0 <= o <= s.t1_ns - s.t0_ns
        if i not in has_kids:
            assert o == s.t1_ns - s.t0_ns


def test_stage_timer_records_through_the_tracer():
    timer = timing.StageTimer()
    timing.enable()
    try:
        with timer.stage("lio_step"):
            with timing.span("pipeline.process_scan", update=3):
                pass
    finally:
        timing.disable()
    spans = timing.drain().spans
    assert [(s.name, s.parent, s.update) for s in spans] == [("lio_step", -1, -1), ("pipeline.process_scan", 0, 3)]
    assert timer.summary()["lio_step"]["n"] == 1
    d = (spans[0].t1_ns - spans[0].t0_ns) * 1e-9
    assert timer.samples["lio_step"][0] <= d


CAM = (160, 128, 100.0, 100.0, 80.0, 64.0)
CAM_SETS = {"lio.max_points": 2048, "map.capacity": 1 << 14, "imu.imu_int_frame": 32,
            "vio.max_visual_points": 1024, "vio.max_obs_per_point": 4, "camera.width": CAM[0],
            "camera.height": CAM[1], "camera.fx": CAM[2], "camera.fy": CAM[3], "camera.cx": CAM[4],
            "camera.cy": CAM[5], "camera.rcl": tuple(TSYN.R_IC_FORWARD.T.reshape(-1).tolist()),
            "camera.pcl": (0.0, 0.0, 0.0), "extrinsics.extrinsic_t": (0.0, 0.0, 0.0)}


@pytest.fixture(scope="module")
def camera_log(tmp_path_factory):
    seq = TSYN.generate(duration=1.2, imu_rate=100.0, pts_per_scan=2000, seed=2, n_boxes=0,
                        camera=Pinhole(*CAM), cam_rate=10.0, cam_offset=0.055, device="cpu")
    log = str(tmp_path_factory.mktemp("camera") / "seq.flvo")
    TLOG.write_sequence(log, seq)
    return log


def _camera_run(log, traced):
    cfg = load_config(os.path.join(REPO, "configs", "avia_livo.yaml"), CAM_SETS)
    before = timing.counters()
    if traced:
        timing.enable()
    try:
        pipe = trun.run_log(log, cfg, progress=False, device="cpu")
    finally:
        timing.disable()
    return pipe, timing.drain(), timing.counter_delta(timing.counters(), before)


def test_camera_spans_and_selected_count(camera_log):
    off, off_trace, off_delta = _camera_run(camera_log, False)
    on, trace, delta = _camera_run(camera_log, True)
    assert off_trace.spans == [] and trace.dropped == 0
    assert off_delta == delta
    assert len(off.trajectory) == len(on.trajectory)
    for (ta, pa, qa), (tb, pb, qb) in zip(off.trajectory, on.trajectory):
        assert ta == tb and np.array_equal(pa, pb) and np.array_equal(qa, qb)
    assert off.n_selected == on.n_selected and max(on.n_selected) > 0
    assert delta["vio.selected"] == sum(on.n_selected)
    spans = trace.spans
    frames = [i for i, s in enumerate(spans) if s.name == "pipeline.image_to_device"]
    assert len(frames) == delta["pipeline.vio_updates"] == len(on.n_selected) > 0
    opened = {}
    for i in frames:
        p = spans[spans[i].parent]
        assert p.name == "pipeline.process_image" and spans[i].update == p.update
        opened[spans[i].parent] = opened.get(spans[i].parent, 0) + 1
    assert set(opened.values()) == {1}


def test_cli_profile_carries_the_spans(tmp_path, camera_log, capsys):
    log = camera_log
    argv = ["--log", log, "--config", os.path.join(REPO, "configs", "avia_livo.yaml"), "--device", "cpu",
            "--out", str(tmp_path / "out"), "--profile", str(tmp_path / "prof")]
    for k, v in CAM_SETS.items():
        argv += ["--set", f"{k}={v!r}"]
    pipe = trun.main(argv)
    assert not timing._S.on
    assert len(pipe.n_effective) >= 2 and max(pipe.n_selected) > 0
    with open(tmp_path / "prof" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    want = {"pipeline.process_scan", "pipeline.process_image", "lio.eskf.search", "voxel_map.knn", "vio.select",
            "vio.update", "vio.maintain", "io.next_group", "lio_step", "pipeline.image_to_device"}
    assert want <= names
    out = capsys.readouterr().out
    assert "spans dropped: 0" in out
    for name in ("lio.eskf.trips", "vio.trips", "sync.eskf_flags", "sync.vio_flags", "sync.to_device",
                 "pipeline.lio_updates", "lio.eskf.solve", "pipeline.image_to_device", "vio.selected"):
        assert name in out, name
