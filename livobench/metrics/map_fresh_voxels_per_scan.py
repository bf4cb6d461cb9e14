"""Map voxels per LIO update that the insert claimed fresh, not yet in the
arena (`maps.voxel_map.insert`'s claim rounds): the port's
`map.fresh_voxels` counter over its `pipeline.lio_updates`, from the
process's start to the window's end, set-up included (program counter).
None where the port keeps no such counter."""

from livobench.program_counters import per_lio_update, snapshot

COUNTER = "map.fresh_voxels"


def read(rec):
    if COUNTER not in (snapshot() or {}):
        return None
    return per_lio_update(lambda name: name == COUNTER)
