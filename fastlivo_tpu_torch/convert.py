"""Carry state between the JAX package and the port as numpy arrays.

`d` maps each NamedTuple field name to a numpy array (for the JAX
package's state: `{k: np.asarray(v) for k, v in state._asdict().items()}`).
Dtypes and shapes are kept exactly, including the packed `meta` rows and
the symmetric-6 `surf_s2` of the voxel map.

The matcher's weights (the committed npz artifacts, or `init_superpoint` /
`init_lightglue` output, the port's or the JAX package's) become the state
of the port's SuperPoint and LightGlue modules, and trained modules go back
to the npz names and layouts (`*_state_to_numpy`), so the JAX package
loads what the port trains.

Sharded arenas: the JAX package holds a map-sharded arena as one global
array per field (capacity x W rows, shard-major); each port rank holds one
shard. `split_sharded_map` cuts the former into the latter,
`join_sharded_maps` puts them back, and `checkpoint_from_jax` rewrites a
JAX pipeline checkpoint (sharded or not) as a port checkpoint.
"""

from __future__ import annotations

import json
from typing import Dict, List, NamedTuple, Type

import numpy as np
import torch

from fastlivo_tpu_torch import device as _device
from fastlivo_tpu_torch.maps.visual_map import VisualMap
from fastlivo_tpu_torch.maps.voxel_map import VoxelHashMap
from fastlivo_tpu_torch.state import NavState


def _from_numpy(cls: Type[NamedTuple], d: Dict[str, np.ndarray], device):
    dev = _device.resolve(device)
    missing = set(cls._fields) - set(d)
    if missing:
        raise KeyError(f"{cls.__name__}: missing fields {sorted(missing)}")
    return cls(**{k: torch.from_numpy(np.array(d[k], copy=True)).to(dev) for k in cls._fields})


def _to_numpy(obj: NamedTuple) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in obj._asdict().items()}


def nav_state_from_numpy(d: Dict[str, np.ndarray], device=None) -> NavState:
    return _from_numpy(NavState, d, device)


def voxel_map_from_numpy(d: Dict[str, np.ndarray], device=None) -> VoxelHashMap:
    return _from_numpy(VoxelHashMap, d, device)


def visual_map_from_numpy(d: Dict[str, np.ndarray], device=None) -> VisualMap:
    return _from_numpy(VisualMap, d, device)


def nav_state_to_numpy(s: NavState) -> Dict[str, np.ndarray]:
    return _to_numpy(s)


def voxel_map_to_numpy(m: VoxelHashMap) -> Dict[str, np.ndarray]:
    return _to_numpy(m)


def visual_map_to_numpy(m: VisualMap) -> Dict[str, np.ndarray]:
    return _to_numpy(m)


def split_sharded_map(d: Dict[str, np.ndarray], n_shards: int) -> List[Dict[str, np.ndarray]]:
    """A global sharded arena (numpy fields, capacity x n_shards rows) ->
    the n_shards per-rank arenas, in rank order. The scalar epoch is
    replicated."""
    out = [dict() for _ in range(n_shards)]
    for k, v in d.items():
        v = np.asarray(v)
        if v.ndim and v.shape[0] % n_shards:
            raise ValueError(f"{k}: {v.shape[0]} rows do not split into {n_shards} shards")
        for i in range(n_shards):
            out[i][k] = v.copy() if v.ndim == 0 else v.reshape(n_shards, -1, *v.shape[1:])[i].copy()
    return out


def join_sharded_maps(shards: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """The per-rank arenas (numpy fields, rank order) -> the global arena,
    shard-major as the JAX package lays it out. Every shard must carry the
    same epoch."""
    out = {}
    for k in shards[0]:
        parts = [np.asarray(s[k]) for s in shards]
        if parts[0].ndim == 0:
            if any(p != parts[0] for p in parts):
                raise ValueError(f"{k}: shards disagree ({[int(p) for p in parts]})")
            out[k] = parts[0].copy()
        else:
            out[k] = np.concatenate(parts)
    return out


def checkpoint_from_jax(jax_path: str, out_path: str):
    """Rewrite a JAX pipeline checkpoint (fastlivo_tpu.utils.checkpoint) as
    a port checkpoint (fastlivo_tpu_torch.utils.checkpoint), arrays as they
    are: the arena stays global, with the blob's shard count, so it loads
    into a port pipeline at that count. Host state the JAX blob does not
    hold starts empty (per-update counts, insert-epoch stamps, health)."""
    from fastlivo_tpu_torch.utils import checkpoint as ckpt

    with np.load(jax_path, allow_pickle=False) as data:
        header = json.loads(bytes(data["header"]).decode())
        blobs = {}
        for group, cls in (("state", NavState), ("map", VoxelHashMap), ("vmap", VisualMap)):
            for i, name in enumerate(cls._fields):
                blobs[f"{group}/{name}"] = np.asarray(data[f"{group}/{i}"])
        for key in ("world_cloud", "world_mask", "traj_t", "traj_pos", "traj_quat"):
            blobs[key] = np.asarray(data[key])
    blobs["traj_t"] = blobs["traj_t"].astype(np.float64)
    blobs["n_effective"] = np.zeros((0,), np.int64)
    blobs["n_selected"] = np.zeros((0,), np.int64)
    blobs["init_mean_acc"] = np.asarray(header["mean_acc"])
    blobs["init_mean_gyr"] = np.asarray(header["mean_gyr"])
    port_header = {
        "schema": ckpt.SCHEMA,
        "schema_version": ckpt.SCHEMA_VERSION,
        "first_scan": header["first_scan"],
        "first_scan_t": None,  # the JAX blob does not keep it
        "init_done": header["init_done"],
        "health": {"rejected": 0, "low_constraint": 0, "resets": 0},
        "vio_before_lio": 0,
        "n_map_shards": int(header.get("n_map_shards", 1)),
        "meta": header.get("meta", {}),
    }
    blobs["header"] = np.frombuffer(json.dumps(port_header).encode(), np.uint8)
    np.savez_compressed(out_path, **blobs)


def _f32(a) -> torch.Tensor:
    """f16 artifacts (and anything else floating) promoted to f32."""
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def superpoint_state_from_numpy(d: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """SuperPoint npz arrays (or `init_superpoint` output) -> the state
    dict of `backend.superpoint_lightglue.SuperPoint`: HWIO convolution
    kernels become OIHW, floats become f32, '.' in names becomes '_'."""
    out = {}
    for k, v in d.items():
        t = _f32(v)
        if k.endswith(".w"):
            t = t.permute(3, 2, 0, 1).contiguous()
        out[k.replace(".", "_")] = t
    return out


def lightglue_state_from_numpy(d: Dict[str, np.ndarray], n_layers: int | None = None):
    """LightGlue npz arrays (or `init_lightglue` output) -> (state dict of
    `backend.superpoint_lightglue.LightGlue`, depth). The depth is the
    artifact's `n_layers` entry (else the official 9) unless `n_layers`
    asks for fewer; deeper layers are left out. Floats become f32."""
    if n_layers is None:
        n_layers = int(d["n_layers"]) if "n_layers" in d else 9
    out = {}
    for k, v in d.items():
        if k == "n_layers":
            continue
        if k.startswith("l") and k.split(".")[0][1:].isdigit() and int(k.split(".")[0][1:]) >= n_layers:
            continue
        out[k.replace(".", "_")] = _f32(v)
    return out, n_layers


def superpoint_from_numpy(d: Dict[str, np.ndarray], device=None):
    """A `SuperPoint` module on `device` (None: the GPU) holding `d`."""
    from fastlivo_tpu_torch.backend import superpoint_lightglue as spl

    sp = spl.SuperPoint()
    sp.load_state_dict(superpoint_state_from_numpy(d))
    return sp.to(_device.resolve(device))


def lightglue_from_numpy(d: Dict[str, np.ndarray], n_layers: int | None = None, device=None):
    """A `LightGlue` module on `device` (None: the GPU) holding `d`, at the
    depth `lightglue_state_from_numpy` gives."""
    from fastlivo_tpu_torch.backend import superpoint_lightglue as spl

    state, depth = lightglue_state_from_numpy(d, n_layers)
    lg = spl.LightGlue(n_layers=depth)
    lg.load_state_dict(state)
    return lg.to(_device.resolve(device))


def _np32(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy().copy()


def superpoint_state_to_numpy(sp) -> Dict[str, np.ndarray]:
    """The inverse of `superpoint_state_from_numpy`: a SuperPoint module's
    weights as f32 NumPy under the npz names, kernels back to HWIO."""
    from fastlivo_tpu_torch.backend import superpoint_lightglue as spl

    state = sp.state_dict()
    out = {}
    for name, _, _, _ in spl._CONVS:
        out[f"{name}.w"] = np.ascontiguousarray(_np32(state[f"{name}_w"]).transpose(2, 3, 1, 0))
        out[f"{name}.b"] = _np32(state[f"{name}_b"])
    return out


def lightglue_state_to_numpy(lg) -> Dict[str, np.ndarray]:
    """The inverse of `lightglue_state_from_numpy`: a LightGlue module's
    weights as f32 NumPy under the npz names (from `lightglue_keys`, never
    by rewriting '_'), with the int32 `n_layers` entry after `kenc.w` as
    `init_lightglue` places it."""
    from fastlivo_tpu_torch.backend import superpoint_lightglue as spl

    state = lg.state_dict()
    dim = state["final_proj_w"].shape[0]
    out = {}
    for name, _ in spl.lightglue_keys(lg.n_layers, dim):
        out[name] = _np32(state[name.replace(".", "_")])
        if name == "kenc.w":
            out["n_layers"] = np.asarray(lg.n_layers, np.int32)
    return out
