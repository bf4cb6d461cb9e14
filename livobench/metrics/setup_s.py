"""Process start to the window's first record (host clock): imports, the
CUDA context, kernel build or load, the pool, the pipeline, static
initialization, EKF warm-up and the set-up laps."""


def read(rec):
    return rec["setup_s"]
