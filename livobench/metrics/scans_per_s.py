"""Scan-end updates completed inside the window, each with every frame
before it, per second of window (host clock)."""


def read(rec):
    return rec["scans"] / rec["window_s"] if rec["scans"] else None
