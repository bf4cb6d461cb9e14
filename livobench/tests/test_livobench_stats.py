"""The percentile and rate arithmetic, and what each reader takes."""

import statistics

import numpy as np
import pytest

from livobench import harness
from livobench.stats import quantile, spread


@pytest.mark.parametrize("n", [1, 2, 3, 10, 101, 1000])
@pytest.mark.parametrize("q", [0.0, 0.5, 0.9, 1.0])
def test_quantile_is_numpys_linear(n, q):
    v = np.random.default_rng(n).exponential(size=n)
    assert quantile(list(v), q) == pytest.approx(float(np.quantile(v, q)), rel=1e-12, abs=0)


def test_quantile_without_samples_is_none():
    assert quantile([], 0.9) is None


def test_spread_is_statistics_quartiles_over_the_median():
    v = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, med, q3 = statistics.quantiles(v, n=4)
    assert spread(v) == pytest.approx((q3 - q1) / med)


def _rec(**kw):
    rec = {
        "window_s": 40.0, "setup_s": 21.5, "scans": 160, "frames": 160,
        "lio_latency_s": [0.1 + 0.001 * i for i in range(160)],
        "vio_latency_s": [0.2] * 160, "lio_step_s": [0.08] * 150, "vio_step_s": [0.09] * 150,
        "sync_s": 0.32, "trace": None, "syncs": None,
    }
    rec.update(kw)
    return rec


def test_end_to_end_readers():
    rec = _rec()
    assert harness.reader("scans_per_s")(rec) == 4.0
    # p90 of 0.100 .. 0.259 s: position 0.9 * 159 = 143.1
    assert harness.reader("lio_latency_ms_p90")(rec) == pytest.approx((0.1 + 0.001 * 143.1) * 1e3)
    assert harness.reader("setup_s")(rec) == 21.5
    assert harness.reader("sync_ms_per_scan")(rec) == pytest.approx(2.0)
    assert harness.reader("lio_step_ms_p50")(rec) == pytest.approx(80.0)


def test_a_window_without_updates_reports_nothing():
    rec = _rec(scans=0, frames=0, lio_latency_s=[], vio_latency_s=[], lio_step_s=[], vio_step_s=[],
               )
    for name in ("scans_per_s", "lio_latency_ms_p90", "sync_ms_per_scan", "lio_step_ms_p50"):
        assert harness.reader(name)(rec) is None, name


def test_trace_readers():
    trace = {"scans": 3, "frames": 3, "window_s": 0.9, "busy_s": 0.09, "kernels": 21000,
             "knn_device_s": 0.036, "knn_scans": 4, "device_ops": [], "idle_gaps": []}
    rec = _rec(trace=trace, syncs={"scans": 2, "syncs": 110, "counted": True})
    assert harness.reader("device_idle_share")(rec) == pytest.approx(0.9)
    assert harness.reader("kernels_per_scan")(rec) == 7000
    assert harness.reader("knn_device_ms_per_scan")(rec) == pytest.approx(9.0)
    assert harness.reader("host_syncs_per_scan")(rec) == 55
    # Off the card nothing was traced on a device: the readers stay silent.
    cpu = dict(trace, busy_s=0.0, kernels=0, knn_device_s=0.0)
    rec = _rec(trace=cpu, syncs={"scans": 2, "syncs": 0, "counted": False})
    for name in ("device_idle_share", "kernels_per_scan", "knn_device_ms_per_scan", "host_syncs_per_scan"):
        assert harness.reader(name)(rec) is None, name


def test_window_times_are_drawn_from_the_seed_inside_the_window():
    a = harness.window_times(2**31 + 11, 40.0, 3)
    assert a == harness.window_times(2**31 + 11, 40.0, 3)
    assert a != harness.window_times(2**31 + 12, 40.0, 3)
    assert a == sorted(a) and all(2.0 <= x <= 36.0 for x in a)


def test_patch_sample_bound_bytes_counts_each_byte_once():
    import torch

    from livobench import roofline

    img = torch.zeros((80, 80))
    centers = torch.tensor([[10.5, 10.5], [10.75, 10.25], [40.5, 40.5]])
    case = {"levels": [img], "centers": [centers], "strides": None, "patch": 2,
            "stride_set": (1,), "grads": False}
    # Two candidates share a 3x3 block of taps, the third has its own.
    assert roofline.patch_sample_bound_bytes(case) == (9 + 9) * 4 + 3 * 8 + 3 * 4 * 4
