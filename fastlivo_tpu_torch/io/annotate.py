"""Annotated debug-image output (host-side, cold path; the port's own copy
of fastlivo_tpu/io/annotate.py).

Parity with the reference's keypatch-annotated image stream — it draws a
square per tracked VIO candidate on the grayscale frame and publishes
/rgb_img (reference: src/lidar_selection.cpp:982-1002 display_keypatch;
published at laser_mapping.cpp:107-112). Here the annotated frames are
written as PNG files under <out_dir>/img/ (this framework is file-based;
no ROS), green = photometric inlier, red = tracked but gated out.

The PNG writer is self-contained (zlib + struct): no imageio or PIL is
needed, and matplotlib would drag a figure pipeline into a per-frame dump.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

GREEN = (40, 220, 60)
RED = (230, 50, 40)


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 array as an RGB PNG."""
    h, w, c = rgb.shape
    assert c == 3 and rgb.dtype == np.uint8

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (
            struct.pack(">I", len(payload))
            + tag
            + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    raw = b"".join(
        b"\x00" + rgb[r].tobytes() for r in range(h)
    )  # filter 0 per row
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def draw_keypoints(
    gray: np.ndarray,
    uv: np.ndarray,
    valid: np.ndarray,
    inlier: np.ndarray,
    half: int = 4,
) -> np.ndarray:
    """Grayscale frame -> RGB uint8 with a hollow square per candidate
    (green inlier / red outlier), like the reference's cv::rectangle calls
    (lidar_selection.cpp:987-995)."""
    g = np.asarray(gray, np.float32)
    if g.max() <= 1.5:  # normalized input
        g = g * 255.0
    img = np.clip(g, 0, 255).astype(np.uint8)
    rgb = np.stack([img, img, img], axis=-1)
    h, w = img.shape
    uv = np.asarray(uv)
    valid = np.asarray(valid, bool)
    inlier = np.asarray(inlier, bool)
    for k in np.nonzero(valid)[0]:
        u = int(round(float(uv[k, 0])))
        v = int(round(float(uv[k, 1])))
        if not (0 <= u < w and 0 <= v < h):
            continue
        color = GREEN if inlier[k] else RED
        u0, u1 = max(u - half, 0), min(u + half, w - 1)
        v0, v1 = max(v - half, 0), min(v + half, h - 1)
        rgb[v0, u0 : u1 + 1] = color
        rgb[v1, u0 : u1 + 1] = color
        rgb[v0 : v1 + 1, u0] = color
        rgb[v0 : v1 + 1, u1] = color
    return rgb


def save_annotated(
    out_dir: str,
    frame_idx: int,
    gray: np.ndarray,
    uv: np.ndarray,
    valid: np.ndarray,
    inlier: np.ndarray,
) -> str:
    """Write one annotated frame to <out_dir>/img/frame_%06d.png."""
    d = os.path.join(out_dir, "img")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"frame_{frame_idx:06d}.png")
    write_png(path, draw_keypoints(gray, uv, valid, inlier))
    return path
