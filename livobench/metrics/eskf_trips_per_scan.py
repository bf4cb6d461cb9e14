"""Trips of the iterated ESKF per LIO update: the port's `lio.eskf.trips`
counter over its `pipeline.lio_updates`, from the process's start to the
window's end, set-up included (program counter)."""

from livobench.program_counters import per_lio_update


def read(rec):
    return per_lio_update(lambda name: name == "lio.eskf.trips")
