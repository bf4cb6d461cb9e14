"""Host synchronizations per scan cycle (its LIO update, with the frame
after it where there is a camera), counted by torch's sync debug mode over
a few steady cycles: a lower bound (it sees no event waits or ctypes
calls)."""


def read(rec):
    s = rec["syncs"]
    if not s or not s["counted"] or not s["scans"]:
        return None
    return s["syncs"] / s["scans"]
