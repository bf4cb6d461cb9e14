"""1 - (busy device time / wall time) of the cycles profiled with the
device's activity alone, no host events recorded (device trace): how far
the host holds the card back."""


def read(rec):
    t = rec["trace"]
    if not t or not t["busy_s"] or not t["window_s"]:
        return None
    return 1.0 - t["busy_s"] / t["window_s"]
