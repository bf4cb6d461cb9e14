"""Claim rounds of the map insert per LIO update (`maps.voxel_map.insert`
runs them only when a voxel is not yet in the arena, at most
`claim_rounds` an insert, the warm-up's inserts too): the port's
`map.claim_rounds` counter over its `pipeline.lio_updates`, from the
process's start to the window's end, set-up included (program counter).
None where the port keeps no such counter."""

from livobench.program_counters import per_lio_update, snapshot

COUNTER = "map.claim_rounds"


def read(rec):
    if COUNTER not in (snapshot() or {}):
        return None
    return per_lio_update(lambda name: name == COUNTER)
