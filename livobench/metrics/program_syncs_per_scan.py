"""Host synchronizations the port itself asks for, per LIO update: the sum
of its `sync.<site>` counters (the copies of each group to the device, the
ESKF's flag read per trip, the map insert's claim reads, the summary
read-back, ...) over its `pipeline.lio_updates`, from the process's start
to the window's end, set-up included (program counter)."""

from livobench.program_counters import per_lio_update


def read(rec):
    return per_lio_update(lambda name: name.startswith("sync."))
