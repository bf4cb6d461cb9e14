"""Map voxels per LIO update that the insert left unclaimed after its
`claim_rounds` cap, whose points were not stored (the reference's map
has no such cap, so each is a divergence): the port's
`map.unclaimed_voxels` counter over its `pipeline.lio_updates`, from the
process's start to the window's end, set-up included (program counter).
None where the port keeps no such counter."""

from livobench.program_counters import per_lio_update, snapshot

COUNTER = "map.unclaimed_voxels"


def read(rec):
    if COUNTER not in (snapshot() or {}):
        return None
    return per_lio_update(lambda name: name == COUNTER)
