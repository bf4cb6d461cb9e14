"""Fixed-capacity visual point map (port of fastlivo_tpu/maps/visual_map.py):
a ring-allocated point table with per-point observation rings holding the
observing pose and a stored patch pyramid."""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Tuple

import torch

from fastlivo_tpu_torch import device as _device
from fastlivo_tpu_torch.ops.scatter import set2_drop, set_drop


@dataclass(frozen=True)
class VisualMapConfig:
    capacity: int = 20480
    max_obs: int = 6
    patch_size: int = 8
    stored_patch: int = 12
    levels: int = 3


class VisualMap(NamedTuple):
    pos: torch.Tensor  # (P, 3)
    score: torch.Tensor  # (P,)
    active: torch.Tensor  # (P,) bool
    cursor: torch.Tensor  # () int32
    obs_patch: torch.Tensor  # (P, K, L*S*S)
    obs_px: torch.Tensor  # (P, K, 2)
    obs_rcw: torch.Tensor  # (P, K, 3, 3)
    obs_pcw: torch.Tensor  # (P, K, 3)
    obs_valid: torch.Tensor  # (P, K) bool
    obs_cursor: torch.Tensor  # (P,) int32


def make_visual_map(cfg: VisualMapConfig, dtype=torch.float32, device=None) -> VisualMap:
    dev = _device.resolve(device)
    p, k, l, s = cfg.capacity, cfg.max_obs, cfg.levels, cfg.stored_patch
    return VisualMap(
        pos=torch.zeros((p, 3), dtype=dtype, device=dev),
        score=torch.zeros((p,), dtype=dtype, device=dev),
        active=torch.zeros((p,), dtype=torch.bool, device=dev),
        cursor=torch.zeros((), dtype=torch.int32, device=dev),
        obs_patch=torch.zeros((p, k, l * s * s), dtype=dtype, device=dev),
        obs_px=torch.zeros((p, k, 2), dtype=dtype, device=dev),
        obs_rcw=torch.zeros((p, k, 3, 3), dtype=dtype, device=dev),
        obs_pcw=torch.zeros((p, k, 3), dtype=dtype, device=dev),
        obs_valid=torch.zeros((p, k), dtype=torch.bool, device=dev),
        obs_cursor=torch.zeros((p,), dtype=torch.int32, device=dev),
    )


def obs_cam_pos(rcw: torch.Tensor, pcw: torch.Tensor) -> torch.Tensor:
    """Camera center in world: -R^T t (batched over leading dims)."""
    return -(rcw.transpose(-1, -2) @ pcw[..., None])[..., 0]


def add_points(
    m: VisualMap,
    cfg: VisualMapConfig,
    pos: torch.Tensor,
    score: torch.Tensor,
    patches: torch.Tensor,
    px: torch.Tensor,
    rcw: torch.Tensor,
    pcw: torch.Tensor,
    mask: torch.Tensor,
) -> VisualMap:
    """Allocate new points at the ring cursor with one initial observation
    each (masked rows are dropped)."""
    n = pos.shape[0]
    dev = pos.device
    rank = torch.cumsum(mask.to(torch.int32), dim=0, dtype=torch.int32) - 1
    slot = (m.cursor + rank) % cfg.capacity
    slot = torch.where(mask, slot, cfg.capacity)
    k0 = torch.zeros((n,), dtype=torch.int64, device=dev)
    obs_valid_row = torch.zeros((n, cfg.max_obs), dtype=torch.bool, device=dev)
    obs_valid_row[:, 0] = True
    return m._replace(
        pos=set_drop(m.pos, slot, pos),
        score=set_drop(m.score, slot, score),
        active=set_drop(m.active, slot, True),
        cursor=(m.cursor + torch.sum(mask.to(torch.int32))).to(torch.int32) % cfg.capacity,
        obs_patch=set2_drop(m.obs_patch, slot, k0, patches.reshape(n, -1)),
        obs_px=set2_drop(m.obs_px, slot, k0, px),
        obs_rcw=set2_drop(m.obs_rcw, slot, k0, rcw.expand(n, 3, 3)),
        obs_pcw=set2_drop(m.obs_pcw, slot, k0, pcw.expand(n, 3)),
        obs_valid=set_drop(m.obs_valid, slot, obs_valid_row),
        obs_cursor=set_drop(m.obs_cursor, slot, 1),
    )


def add_observations(
    m: VisualMap,
    cfg: VisualMapConfig,
    idx: torch.Tensor,
    score: torch.Tensor,
    patches: torch.Tensor,
    px: torch.Tensor,
    rcw: torch.Tensor,
    pcw: torch.Tensor,
    mask: torch.Tensor,
) -> VisualMap:
    """Append an observation to each masked point's ring (replacing the
    oldest when full). The masked indices are distinct (one point per
    grid cell), so the adds and sets have no duplicate targets."""
    n = idx.shape[0]
    i = torch.where(mask, idx, cfg.capacity)
    k = m.obs_cursor[torch.clamp(idx, 0, cfg.capacity - 1).long()] % cfg.max_obs
    return m._replace(
        score=set_drop(m.score, i, score),
        obs_patch=set2_drop(m.obs_patch, i, k, patches.reshape(n, -1)),
        obs_px=set2_drop(m.obs_px, i, k, px),
        obs_rcw=set2_drop(m.obs_rcw, i, k, rcw.expand(n, 3, 3)),
        obs_pcw=set2_drop(m.obs_pcw, i, k, pcw.expand(n, 3)),
        obs_valid=set2_drop(m.obs_valid, i, k, True),
        obs_cursor=set_drop(m.obs_cursor, i, m.obs_cursor[torch.clamp(idx, 0, cfg.capacity - 1).long()] + 1),
    )


def closest_view_obs(
    m: VisualMap, idx: torch.Tensor, cam_pos: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best observation per point by viewing-angle cosine (reject cos <= 0.5)."""
    idx = idx.long()
    pts = m.pos[idx]
    view = cam_pos - pts
    view = view / (torch.linalg.vector_norm(view, dim=-1, keepdim=True) + 1e-9)
    obs_c = obs_cam_pos(m.obs_rcw[idx], m.obs_pcw[idx])
    od = obs_c - pts[:, None, :]
    od = od / (torch.linalg.vector_norm(od, dim=-1, keepdim=True) + 1e-9)
    cos = torch.sum(od * view[:, None, :], dim=-1)
    cos = torch.where(m.obs_valid[idx], cos, -2.0)
    best = torch.argmax(cos, dim=-1)
    best_cos = torch.gather(cos, 1, best[:, None])[:, 0]
    return best, best_cos > 0.5


def num_active(m: VisualMap) -> torch.Tensor:
    return torch.sum(m.active.to(torch.int32))
