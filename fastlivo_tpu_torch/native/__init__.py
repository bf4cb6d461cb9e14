"""ctypes bindings for the native host runtime (port of
fastlivo_tpu/native/__init__.py).

`src/livo_host.cc` is compiled at first use with

    g++ -O3 -shared -fPIC -std=c++17

into `fastlivo_tpu_torch/_build/` (listed in .gitignore). The library's
file name carries a hash of its source and flags, so an edited source is
rebuilt. When g++ or the build fails, `get_lib()` returns None and every
caller falls back to its NumPy path, which gives the same output. Nothing
here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "src" / "livo_host.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lib: Optional[ctypes.CDLL] = None
_tried = False


class RecordIndex(ctypes.Structure):
    _fields_ = [
        ("type", ctypes.c_uint8),
        ("offset", ctypes.c_uint64),
        ("stamp", ctypes.c_double),
        ("count", ctypes.c_uint32),
    ]


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"liblivo_host_{digest}.so"


def _build(lib: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(
            ["g++", *GXX_FLAGS, "-o", str(tmp), str(SRC)],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, lib)
        return True
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """The native library (built first if needed), or None."""
    global _lib, _tried
    if _lib is not None:
        return _lib
    if _tried:
        return None
    _tried = True
    path = library_path()
    if not path.exists() and not _build(path):
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None

    lib.flvo_index.restype = ctypes.c_int64
    lib.flvo_index.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64,
        ctypes.POINTER(RecordIndex), ctypes.c_uint64,
    ]
    lib.flvo_decode_lidar.restype = ctypes.c_int64
    lib.flvo_decode_lidar.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64,
        ctypes.c_float, ctypes.c_float, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.flvo_decode_imu.restype = None
    lib.flvo_decode_imu.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
    ]
    lib.flvo_decode_image.restype = None
    lib.flvo_decode_image.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint8)
    ]
    lib.flvo_voxel_mask.restype = ctypes.c_int64
    lib.flvo_voxel_mask.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_float,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    _lib = lib
    return lib


def voxel_mask_numpy(pts: np.ndarray, leaf: float) -> np.ndarray:
    """The NumPy version of `flvo_voxel_mask`, equal to it bit for bit:
    keys from floor(p * (1/leaf)) in f32, each axis wrapped to 21 bits,
    first occurrence kept."""
    pts = np.ascontiguousarray(pts, np.float32)
    inv = np.float32(1.0) / np.float32(leaf)
    k = np.floor(pts * inv).astype(np.int64) & 0x1FFFFF
    key = (k[:, 0] << 42) | (k[:, 1] << 21) | k[:, 2]
    _, first = np.unique(key, return_index=True)
    mask = np.zeros(len(pts), bool)
    mask[first] = True
    return mask


def voxel_mask(pts: np.ndarray, leaf: float) -> np.ndarray:
    """First-point-per-voxel boolean mask. Native when available."""
    pts = np.ascontiguousarray(pts, np.float32)
    lib = get_lib()
    if lib is None:
        return voxel_mask_numpy(pts, leaf)
    mask = np.zeros(len(pts), np.uint8)
    lib.flvo_voxel_mask(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(pts),
        leaf,
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return mask.astype(bool)
