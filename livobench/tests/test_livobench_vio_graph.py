"""The reader of `vio_graph_trip_share`: the port's `vio.graph_replays`
over its `vio.trips`, and None, without raising, where the port keeps no
counters, counts no trip or does not count replays (a port that runs the
trips op by op)."""

import pytest

from livobench import harness, program_counters

CASES = [
    (None, None),
    ({}, None),
    ({"vio.trips": 0, "vio.graph_replays": 0}, None),
    ({"vio.trips": 1203, "pipeline.vio_updates": 120}, None),
    ({"vio.trips": 1200, "vio.graph_replays": 1200, "vio.graph_captures": 3}, 1.0),
    ({"vio.trips": 1000, "vio.graph_replays": 990}, 0.99),
]


@pytest.mark.parametrize("counters,share", CASES)
def test_share_of_trips_replayed(monkeypatch, counters, share):
    monkeypatch.setattr(program_counters, "snapshot", lambda: counters)
    got = harness.reader("vio_graph_trip_share")({})
    assert got == share
