"""Checkpoint and resume of a LivoPipeline: the filter state, both map
arenas and the host bookkeeping in one npz.

The schema is the port's own (not the JAX package's layout): device
arrays are keyed "<group>/<NamedTuple field>" (groups `state`, `map`,
`vmap`), and a JSON header holds the schema version and the host state.
Resuming mid-log and replaying the rest gives the trajectory of a
straight-through run (the runner skips the groups before the checkpoint).
"""

from __future__ import annotations

import json
from typing import Any, Dict, NamedTuple

import numpy as np
import torch

SCHEMA = "fastlivo_tpu_torch.pipeline"
SCHEMA_VERSION = 1


def _put(blobs: Dict[str, np.ndarray], group: str, tup: NamedTuple):
    for name, value in tup._asdict().items():
        blobs[f"{group}/{name}"] = value.detach().cpu().numpy()


def _take(data, group: str, template: NamedTuple, device):
    out = {}
    for name, ref in template._asdict().items():
        arr = data[f"{group}/{name}"]
        if arr.shape != tuple(ref.shape) or str(arr.dtype) != str(ref.dtype).replace("torch.", ""):
            raise ValueError(
                f"checkpoint {group}/{name} is {arr.dtype}{arr.shape}, the pipeline needs "
                f"{ref.dtype}{tuple(ref.shape)}: resume with the config it was written with"
            )
        out[name] = torch.from_numpy(arr).to(device)
    return type(template)(**out)


def save_pipeline(path: str, pipe, meta: Dict[str, Any] | None = None):
    """Write a checkpoint of `pipe` (device arenas + host bookkeeping)."""
    blobs: Dict[str, np.ndarray] = {}
    _put(blobs, "state", pipe.state)
    _put(blobs, "map", pipe.map)
    _put(blobs, "vmap", pipe.visual_map)
    blobs["world_cloud"] = pipe.world_cloud.cpu().numpy()
    blobs["world_mask"] = pipe.world_mask.cpu().numpy()
    traj = pipe.trajectory
    blobs["traj_t"] = np.asarray([t for t, _, _ in traj], np.float64)
    blobs["traj_pos"] = np.stack([p for _, p, _ in traj]) if traj else np.zeros((0, 3), np.float32)
    blobs["traj_quat"] = np.stack([q for _, _, q in traj]) if traj else np.zeros((0, 4), np.float32)
    blobs["n_effective"] = np.asarray(pipe.n_effective, np.int64)
    blobs["n_selected"] = np.asarray(pipe.n_selected, np.int64)
    blobs["epoch_stamps"] = np.asarray(pipe._epoch_stamps, np.float64)
    # As arrays, dtype kept: acc_scale is computed from them in that dtype.
    blobs["init_mean_acc"] = np.asarray(pipe.initializer.mean_acc)
    blobs["init_mean_gyr"] = np.asarray(pipe.initializer.mean_gyr)
    header = {
        "schema": SCHEMA,
        "schema_version": SCHEMA_VERSION,
        "first_scan": pipe.first_scan,
        "first_scan_t": pipe._first_scan_t,
        "init_done": pipe.initializer.done,
        "health": pipe.health,
        "vio_before_lio": pipe.vio_before_lio,
        "meta": meta or {},
    }
    blobs["header"] = np.frombuffer(json.dumps(header).encode(), np.uint8)
    np.savez_compressed(path, **blobs)


def load_pipeline(path: str, pipe) -> Dict[str, Any]:
    """Restore a checkpoint into a freshly constructed LivoPipeline of the
    same config. Returns the stored meta dict."""
    with np.load(path, allow_pickle=False) as data:
        header = json.loads(bytes(data["header"]).decode())
        if header.get("schema") != SCHEMA or header.get("schema_version") != SCHEMA_VERSION:
            raise ValueError(
                f"{path}: not a {SCHEMA} v{SCHEMA_VERSION} checkpoint "
                f"(schema {header.get('schema')!r} v{header.get('schema_version')})"
            )
        dev = pipe.device
        pipe.state = _take(data, "state", pipe.state, dev)
        pipe.map = _take(data, "map", pipe.map, dev)
        pipe.visual_map = _take(data, "vmap", pipe.visual_map, dev)
        pipe.world_cloud = torch.from_numpy(data["world_cloud"]).to(dev)
        pipe.world_mask = torch.from_numpy(data["world_mask"]).to(dev)
        pos, quat = data["traj_pos"], data["traj_quat"]
        pipe.trajectory = [(float(t), pos[i], quat[i]) for i, t in enumerate(data["traj_t"])]
        pipe.n_effective = [int(v) for v in data["n_effective"]]
        pipe.n_selected = [int(v) for v in data["n_selected"]]
        if "epoch_stamps" in data:  # insert epoch -> stamp, for reanchor_map
            pipe._epoch_stamps = [float(v) for v in data["epoch_stamps"]]
        pipe.initializer.mean_acc = np.array(data["init_mean_acc"])
        pipe.initializer.mean_gyr = np.array(data["init_mean_gyr"])
    pipe.first_scan = bool(header["first_scan"])
    pipe._first_scan_t = header["first_scan_t"]
    pipe.initializer.done = bool(header["init_done"])
    pipe.health = dict(header["health"])
    pipe.vio_before_lio = int(header["vio_before_lio"])
    return header["meta"]
