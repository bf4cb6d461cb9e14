"""Device time of the kernels launched inside the port's `voxel_map.knn`
profiler range, per scan cycle of the profile that records host
operations (device trace)."""


def read(rec):
    t = rec["trace"]
    if not t or not t["knn_device_s"] or not t["knn_scans"]:
        return None
    return t["knn_device_s"] * 1e3 / t["knn_scans"]
