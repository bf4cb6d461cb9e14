"""Carry state between the JAX package and the port as numpy arrays.

`d` maps each NamedTuple field name to a numpy array (for the JAX
package's state: `{k: np.asarray(v) for k, v in state._asdict().items()}`).
Dtypes and shapes are kept exactly, including the packed `meta` rows and
the symmetric-6 `surf_s2` of the voxel map.

The matcher's weights (the committed npz artifacts, or the JAX package's
`init_superpoint` / `init_lightglue` output as NumPy) become the state of
the port's SuperPoint and LightGlue modules.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Type

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
