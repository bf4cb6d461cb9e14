"""The harness's spans around the synchronizer's pushes and `next_group`
and the window builder's `build`, summed over the window, per scan-end
update."""


def read(rec):
    return rec["sync_s"] * 1e3 / rec["scans"] if rec["scans"] else None
