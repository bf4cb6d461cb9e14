"""Trajectory and point-cloud export (port of fastlivo_tpu/io/export.py):
TUM trajectories, PCD map dumps and the colorized cloud."""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np
import torch

from fastlivo_tpu_torch import device as _device


def write_tum(path: str, trajectory: Iterable[Tuple[float, np.ndarray, np.ndarray]]) -> None:
    """TUM format: `t x y z qx qy qz qw` per line. Quaternions arrive as
    (w, x, y, z) from `so3.rot_to_quat` and are reordered here."""
    with open(path, "w") as f:
        for t, pos, q_wxyz in trajectory:
            w, x, y, z = (float(v) for v in q_wxyz)
            f.write(
                f"{t:.6f} {pos[0]:.6f} {pos[1]:.6f} {pos[2]:.6f} "
                f"{x:.6f} {y:.6f} {z:.6f} {w:.6f}\n"
            )


def read_tum(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (stamps (N,), positions (N, 3), quats_wxyz (N, 4))."""
    data = np.loadtxt(path).reshape(-1, 8)
    return data[:, 0], data[:, 1:4], data[:, [7, 4, 5, 6]]


def write_pcd(
    path: str,
    pts: np.ndarray,
    intensity: np.ndarray | None = None,
    binary: bool = True,
) -> None:
    """Minimal PCD v0.7 writer (x y z [intensity])."""
    n = len(pts)
    fields = "x y z" + (" intensity" if intensity is not None else "")
    count = "1 1 1" + (" 1" if intensity is not None else "")
    size = "4 4 4" + (" 4" if intensity is not None else "")
    typ = "F F F" + (" F" if intensity is not None else "")
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        f"FIELDS {fields}\n"
        f"SIZE {size}\n"
        f"TYPE {typ}\n"
        f"COUNT {count}\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
        f"DATA {'binary' if binary else 'ascii'}\n"
    )
    arr = pts.astype(np.float32)
    if intensity is not None:
        arr = np.concatenate([arr, intensity.astype(np.float32)[:, None]], axis=1)
    with open(path, "wb") as f:
        f.write(header.encode())
        if binary:
            f.write(np.ascontiguousarray(arr).tobytes())
        else:
            np.savetxt(f, arr, fmt="%.6f")


def read_pcd(path: str) -> np.ndarray:
    """Points (N, 3) of a PCD written by `write_pcd` (binary or ascii)."""
    with open(path, "rb") as f:
        raw = f.read()
    end = raw.index(b"\nDATA ") + 1
    end = raw.index(b"\n", end) + 1
    header = raw[:end].decode().split("\n")
    spec = dict(line.split(" ", 1) for line in header if line and not line.startswith("#"))
    n = int(spec["POINTS"])
    n_fields = len(spec["FIELDS"].split())
    if spec["DATA"] == "binary":
        data = np.frombuffer(raw, "<f4", n * n_fields, end).reshape(n, n_fields)
    else:
        data = np.loadtxt(raw[end:].decode().splitlines(), dtype=np.float32).reshape(n, n_fields)
    return data[:, :3].copy()


def colorize_cloud(
    pts_world: np.ndarray,
    img: np.ndarray,
    rcw: np.ndarray,
    pcw: np.ndarray,
    cam,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-point intensity/color by reprojection into the current frame
    (parity with publish_frame_world_rgb / RGBpointBodyToWorld, which colors
    the world cloud through the live camera). Projection and bilinear
    sampling run on `device` (None means the GPU); the camera transform is
    taken in the inputs' NumPy result type, one elementwise op at a time, so
    the card and the CPU give the same bits. Returns (values (N,) or (N, C),
    visible_mask (N,)) as NumPy arrays."""
    from fastlivo_tpu_torch.ops import image as img_ops

    dev = _device.resolve(device)
    dtype = torch.float64 if np.result_type(pts_world, rcw, pcw) == np.float64 else torch.float32
    p = torch.tensor(np.asarray(pts_world), dtype=dtype, device=dev)
    r = torch.tensor(np.asarray(rcw), dtype=dtype, device=dev)
    p_c = p[:, 0:1] * r[:, 0] + p[:, 1:2] * r[:, 1] + p[:, 2:3] * r[:, 2]
    p_c = p_c + torch.tensor(np.asarray(pcw), dtype=dtype, device=dev)
    uv = cam.project(p_c.to(torch.float32))
    vis = (p_c[:, 2] > 0.1) & (
        (uv[:, 0] >= 1) & (uv[:, 0] < cam.width - 1) & (uv[:, 1] >= 1) & (uv[:, 1] < cam.height - 1)
    )
    image = torch.tensor(np.asarray(img), dtype=torch.float32, device=dev)
    if image.ndim == 2:
        vals = img_ops.bilinear(image, uv)
    else:
        vals = torch.stack([img_ops.bilinear(image[..., c], uv) for c in range(image.shape[-1])], dim=-1)
    return vals.cpu().numpy(), vis.cpu().numpy()


def map_to_cloud(lidar_map, max_points: int | None = None) -> np.ndarray:
    """All valid points of a VoxelHashMap arena as (N, 3) float32 (selected
    on the map's device, then copied to the host)."""
    pts = lidar_map.points
    s = pts.shape[1]
    valid = torch.arange(s, device=pts.device)[None, :] < lidar_map.counts[:, None]
    cloud = pts[valid].cpu().numpy()
    if max_points is not None and len(cloud) > max_points:
        idx = np.random.default_rng(0).choice(len(cloud), max_points, replace=False)
        cloud = cloud[idx]
    return cloud
