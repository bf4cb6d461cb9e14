"""The LIO update's trips, factored into `models.lio.eskf_trip`, against
the loop they were factored from (tests/eskf_trip_loop.py): on the CPU
the update runs each trip op by op and gives the loop's posterior,
LioInfo and neighbor cache bit for bit, with the same trips, searches and
flag reads, and makes no graph. The card's graphed trips are held to the
same loop in tests/test_torch_cuda.py."""

import pytest
import torch

import chip_smoke
import eskf_trip_loop as loop
from fastlivo_tpu_torch.models import lio
from fastlivo_tpu_torch.state import NavState
from fastlivo_tpu_torch.utils import timing

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cases():
    """The map and two updates of `eskf_trip_loop.lio_case` in each dtype."""
    return {dt: loop.lio_case("cpu", dt) for dt in (torch.float32, torch.float64)}


def _counted(fn):
    """fn()'s result and what it added to the port's counters."""
    before = timing.counters()
    out = fn()
    return out, timing.counter_delta(timing.counters(), before)


def _same(a, b):
    return chip_smoke.same_bits(a, b) if a.is_floating_point() else torch.equal(a, b)


@pytest.mark.parametrize("name", sorted(loop.CASES))
def test_factored_trips_equal_the_loop_bitwise(cases, name):
    dtype, fields, gnss = loop.CASES[name]
    cfg = lio.LioConfig(**fields)
    n_graphs = len(lio._TRIP_GRAPHS)
    for k, upd in enumerate(cases[dtype][1]):
        args = (*upd["args"], loop.MAP_CFG, cfg)
        extras = loop.gnss_extras(upd["args"][0], upd["truth"]) if gnss else (None, None)
        (want, want_info, want_nbr), want_n = _counted(lambda: loop.loop_lio_update(*args, *extras))
        (got, got_info, got_nbr), got_n = _counted(lambda: lio.lio_update(*args, *extras))
        for field in NavState._fields:
            assert _same(getattr(got, field), getattr(want, field)), (k, field)
        for field in lio.LioInfo._fields:
            assert _same(getattr(got_info, field), getattr(want_info, field)), (k, field)
        assert _same(got_nbr[0], want_nbr[0]) and _same(got_nbr[1], want_nbr[1]), k
        assert got_n == want_n, (k, got_n, want_n)
        trips = int(want_info.iterations)
        assert want_n["lio.eskf.trips"] == want_n["sync.eskf_flags"] == trips >= 2
        assert want_n["lio.eskf.searches"] >= 2 and int(want_info.n_effective) >= 200
        if name == "max_iteration":
            assert trips == cfg.max_iteration
    assert len(lio._TRIP_GRAPHS) == n_graphs


def _scan(n=2048, dtype=torch.float32, k=5, src_cov=False, point_cov=False, extras=False):
    z = torch.zeros
    return lio.TripScan(
        state_prop=NavState.identity(dtype, "cpu"), p_inv=z(18, 18, dtype=dtype), pts_body=z(n, 3, dtype=dtype),
        pts_mask=z(n, dtype=torch.bool), rot_il=z(3, 3, dtype=dtype), t_il=z(3, dtype=dtype),
        nbr=z(n, k, 3, dtype=dtype), nbr_valid=z(n, k, dtype=torch.bool),
        src_cov=z(n, 3, 3, dtype=dtype) if src_cov else None, point_cov=z((), dtype=dtype) if point_cov else None,
        extra_hth=z(18, 18, dtype=dtype) if extras else None, extra_hty=z(18, dtype=dtype) if extras else None,
    )


@pytest.mark.parametrize("change", ["none", "n", "dtype", "k", "src_cov", "point_cov", "extras", "config"])
def test_trip_graph_key(change):
    """The key of the graph cache: equal for equal shapes and settings
    (fresh tensors), another for another point count, dtype, neighbor
    count, LioConfig, or where the source covariances, the surfel's
    constant variance or the GNSS extras come or go."""
    cfg = lio.LioConfig()
    base = lio.trip_graph_key(_scan(), cfg)
    kw = {"n": dict(n=2047), "dtype": dict(dtype=torch.float64), "k": dict(k=4), "src_cov": dict(src_cov=True),
          "point_cov": dict(point_cov=True), "extras": dict(extras=True)}.get(change, {})
    if change == "config":
        cfg = lio.LioConfig(max_iteration=4)
    key = lio.trip_graph_key(_scan(**kw), cfg)
    assert (key == base) == (change == "none")
    assert hash(key) == hash(lio.trip_graph_key(_scan(**kw), cfg))
