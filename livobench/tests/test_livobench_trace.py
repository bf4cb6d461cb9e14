"""The port's tracer and counters under the benchmark's runner, on the CPU
at the small size.

The counter readers (`program_syncs_per_scan`, `eskf_trips_per_scan`)
return numbers in a traced run, and None, without raising, for a port that
keeps no counters. With the tracer switched on around the window, as a
harness that reads the program's spans would, the spans sit inside the
harness's own: the synchronizer's spans sum to no more than
`sync_ms_per_scan`, and the IMU, ESKF and insert medians to no more than
the `pipeline.process_scan` median."""

import statistics

from fastlivo_tpu_torch.utils import timing
from livobench import harness
from livobench.tests import small

COUNTER_READERS = ("program_syncs_per_scan", "eskf_trips_per_scan")


def _medians_ms(spans):
    """Per LIO update (a `pipeline.process_scan` span with an ESKF), the
    medians over updates of each phase's total: process, IMU, ESKF, insert."""
    phases = {"process": ("pipeline.process_scan",), "imu": ("lio.propagate", "lio.undistort"),
              "eskf": ("lio.eskf",), "insert": ("lio.insert",)}
    lio = {s.update for s in spans if s.name == "lio.eskf"}
    totals = {k: {u: 0 for u in lio} for k in phases}
    for s in spans:
        for k, names in phases.items():
            if s.name in names and s.update in lio:
                totals[k][s.update] += s.t1_ns - s.t0_ns
    return {k: statistics.median(v.values()) * 1e-6 for k, v in totals.items()}


def test_counter_readers_and_program_spans_in_a_traced_run(monkeypatch):
    real = harness.run_window
    got = {}

    def window_with_the_tracer_on(*args, **kwargs):
        timing.enable()
        try:
            w = real(*args, **kwargs)
        finally:
            timing.disable()
        got["trace"], got["window"] = timing.drain(), w
        return w

    monkeypatch.setattr(harness, "run_window", window_with_the_tracer_on)
    result, _ = small.run_small(small.ROOM_LIO, seconds=6.0, trace=True)
    assert result["correct"]
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(COUNTER_READERS) <= set(m)
    max_iteration = small.cell(small.ROOM_LIO).config_file["config"]["max_iteration"]
    assert 1 <= m["eskf_trips_per_scan"] <= max_iteration
    # Each update: nine leaves copied in, one flag read per trip, one read-back.
    assert m["program_syncs_per_scan"] >= 10 + m["eskf_trips_per_scan"]

    trace, w = got["trace"], got["window"]
    assert trace.dropped == 0
    scans = len(w.lat["lio"])
    io_ms = sum(s.t1_ns - s.t0_ns for s in trace.spans if s.name.startswith("io.")) * 1e-6
    assert 0 < io_ms / scans <= m["sync_ms_per_scan"]
    med = _medians_ms(trace.spans)
    assert 0 < med["imu"] + med["eskf"] + med["insert"] <= med["process"]


def test_counter_readers_are_silent_without_counters(monkeypatch):
    monkeypatch.delattr(timing, "counters")
    for name in COUNTER_READERS:
        assert harness.reader(name)({}) is None
