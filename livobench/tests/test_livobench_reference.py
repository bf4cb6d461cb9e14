"""The reference against the port on the CPU at a small size, and runs
whose timed path is broken underneath: `correct` has to come out false.

The faults are planted in the port's modules when the window begins (the
set-up and the start check run the port as it is), so what catches them
is the check of the window's own updates. The cell is the float64 room;
the VIO half of the check is driven on the held-out float32 room with the
camera, whose VIO numbers are held to bounds read at this size."""

import math

import pytest
import torch

from livobench import check, harness
from livobench.tests import small

# The VIO numbers at this size (CPU readings 1e-7 m, 1e-7 rad, 1e-3 texel
# units; the TF32 control 3e-6 m, 2e-4 rad, 1 texel unit and above).
VIO_BOUNDS = {"vio_pos_gap_m": 1e-5, "vio_rot_gap_rad": 1e-5, "patch_gap": 0.05}


def test_the_port_follows_the_reference_at_a_small_size():
    result, lines = small.run_small(small.ROOM_LIO, seconds=8.0)
    assert result["correct"] and result["attempted"] > 0 and result["failed"] == 0
    assert {n for n, *_ in lines} == set(small.cell(small.ROOM_LIO).limits)
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"scans_per_s", "lio_latency_ms_p90", "setup_s"}


def test_a_traced_run_reports_the_layers_and_the_same_check():
    result, _ = small.run_small(small.ROOM_LIO, seconds=8.0, trace=True)
    assert result["correct"]
    # Off the card only the spans read; device readers stay silent.
    assert {"sync_ms_per_scan", "lio_step_ms_p50"} <= set(result["metrics"])
    assert "busy_s" in result["device"] and "breakdown" in result


def _vio_gaps(seconds=8.0):
    """The held-out camera room's numbers at the small size, each read
    against an infinite limit."""
    c = small.cell(small.ROOM)
    c.limits = dict.fromkeys(check.load("lio").NUMBERS + check.load("vio").NUMBERS, math.inf)
    _, lines = harness.run_cell(c, 2147483659, seconds, False, "cpu", 0.0,
                                overrides=small.SMALL["avia_livo"], traffic=small.small_traffic(c))
    return {n: v for n, v, _, _ in lines}


def test_the_vio_follows_the_reference_at_a_small_size():
    g = _vio_gaps()
    assert all(g[n] <= b for n, b in VIO_BOUNDS.items()), g


# ---------------------------------------------------------------------------
# Faults.
# ---------------------------------------------------------------------------


def _unchanged_lio(real):
    from fastlivo_tpu_torch.models import pipeline as pp

    def step(state, lidar_map, scan, *a, **kw):
        _, _, info, cloud, _ = real(state, lidar_map, scan, *a, **kw)
        one = torch.ones((), dtype=state.pos.dtype, device=state.pos.device)
        return state, lidar_map, info, cloud, pp.step_summary(state, info, 0 * one, one > 0)

    return step


def _half_batch(real):
    def step(state, lidar_map, scan, *a, **kw):
        keep = torch.arange(scan.mask.shape[0], device=scan.mask.device) % 2 == 0
        return real(state, lidar_map, scan._replace(mask=scan.mask & keep), *a, **kw)

    return step


def _altered_pose(real):
    def step(*a, **kw):
        state, m, info, cloud, summary = real(*a, **kw)
        return state._replace(pos=state.pos + 1e-3), m, info, cloud, summary

    return step


def _altered_map(real):
    def insert(m, pts, mask, *a, **kw):
        return real(m, pts + 0.01, mask, *a, **kw)

    return insert


def _unchanged_vio(real):
    def step(state, visual_map, *a, **kw):
        _, _, info, summary = real(state, visual_map, *a, **kw)
        return state, visual_map, info, summary

    return step


def _altered_patches(real):
    def sample(*a, **kw):
        return real(*a, **kw) + 1.0

    return sample


LIO_FAULTS = {
    "lio_state_unchanged": ("fastlivo_tpu_torch.models.pipeline", "lio_scan_step", _unchanged_lio),
    "half_the_points_left_out": ("fastlivo_tpu_torch.models.pipeline", "lio_scan_step", _half_batch),
    "lio_pose_altered": ("fastlivo_tpu_torch.models.pipeline", "lio_scan_step", _altered_pose),
    "map_points_altered": ("fastlivo_tpu_torch.maps.voxel_map", "insert", _altered_map),
}
VIO_FAULTS = {
    "vio_state_unchanged": ("fastlivo_tpu_torch.models.pipeline", "vio_scan_step", _unchanged_vio),
    "kernel_values_altered": ("fastlivo_tpu_torch.ops.patch_sample", "patch_sample_levels", _altered_patches),
}


def _break_window(monkeypatch, fault):
    import importlib

    module, name, make = fault
    mod = importlib.import_module(module)
    real = getattr(mod, name)
    window = harness.run_window

    def broken_window(*a, **kw):
        monkeypatch.setattr(mod, name, make(real))
        return window(*a, **kw)

    monkeypatch.setattr(harness, "run_window", broken_window)


@pytest.mark.parametrize("fault", sorted(LIO_FAULTS))
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    _break_window(monkeypatch, LIO_FAULTS[fault])
    result, lines = small.run_small(small.ROOM_LIO, seconds=8.0)
    failed = [n for n, v, lim, good in lines if not good]
    assert not result["correct"], lines
    assert failed and all(math.isfinite(lim) for _, _, lim, _ in lines)


@pytest.mark.parametrize("fault", sorted(VIO_FAULTS))
def test_a_broken_vio_path_is_found_out(fault, monkeypatch):
    _break_window(monkeypatch, VIO_FAULTS[fault])
    g = _vio_gaps()
    assert any(g[n] > b for n, b in VIO_BOUNDS.items()), g
