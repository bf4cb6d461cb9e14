"""Device kernels launched per profiled scan cycle (device trace)."""


def read(rec):
    t = rec["trace"]
    if not t or not t["kernels"]:
        return None
    return t["kernels"] / t["scans"]
