"""Fixed-capacity voxel-hash LiDAR map (port of
fastlivo_tpu/maps/voxel_map.py: the arena, `reanchor`, and the sharded
arena's ownership hash, local insert and collective lookups).

Same arena layout, hashes and algorithms as the JAX package — bucketized
two-choice hash table of packed 8-word slot rows, per-voxel point slabs,
running surfel moments — so the two packages' maps can be converted into
each other (`fastlivo_tpu_torch.convert`) and compared field by field.

PyTorch idiom where JAX semantics need care:
- hashes stay int32 end to end, so the products wrap exactly as in JAX;
- `jnp.lexsort` is three stable sorts (`ops.voxelize.lexsort3`);
- `mode="drop"` scatters go through `ops.scatter.set_drop` (a trash row);
- segment sums reduce over the shared sorted order
  (`ops.scatter.segment_sum_sorted`), the same on every run;
- the claim phase's `lax.cond` / `lax.while_loop` are Python control flow
  that reads one flag per trip from the device (the JAX trip count);
- a sharded arena's collectives go through a `parallel.axis.Axis` (the
  JAX `axis_name`); the claim rounds hold none, so their trip counts may
  differ between ranks;
- `knn` is one launch of `csrc/voxel_knn.cu` for CUDA tensors and the
  op-by-op `knn_plain` for CPU tensors (the kernel's reference on the card).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from fastlivo_tpu_torch import device as _device
from fastlivo_tpu_torch.ops import cuda_build, linalg
from fastlivo_tpu_torch.ops.scatter import (
    reduce_drop,
    segment_sum_sorted,
    set2_drop,
    set_drop,
)
from fastlivo_tpu_torch.ops.voxelize import lexsort3
from fastlivo_tpu_torch.utils import timing

INT32_MAX = torch.iinfo(torch.int32).max

_HP = (98317, 1222827239, 51787565)
_HP2 = (40503, 1610612741, 179424673)
_W = 8  # packed meta row: [kx, ky, kz, stamp, n, s1x, s1y, s1z]
_EMPTY = float(1 << 26)
_COORD_MAX = (1 << 22) - 1


@dataclass(frozen=True)
class VoxelMapConfig:
    """Static map geometry (same fields and defaults as the JAX package)."""

    resolution: float = 0.5
    capacity: int = 1 << 19
    max_points: int = 32
    probe_depth: int = 8
    nearby_type: int = 18
    claim_rounds: int = 8
    lookup_unique_cap: int = 16384
    surfel_decay: float = 0.9
    surfel_freeze_n: float = 0.0

    def __post_init__(self):
        if self.capacity & (self.capacity - 1):
            raise ValueError("capacity must be 2^k")
        if self.capacity % self.probe_depth:
            raise ValueError("capacity must be a multiple of probe_depth")
        if self.capacity < 2 * self.probe_depth:
            raise ValueError("capacity too small")

    @property
    def n_buckets(self) -> int:
        return self.capacity // self.probe_depth


class VoxelHashMap(NamedTuple):
    """The map arena; field names, shapes and dtypes as in the JAX package.

      meta: (B, probe_depth * 8) f32 packed slot rows
      counts: (C,) int32 valid points per voxel slab
      slab: (C, max_points * 3) f32 point slabs
      slab_stamps: (C * max_points,) int32 insert epoch per point slot
      surf_s2: (C, 6) f32 symmetric [xx, yy, zz, xy, xz, yz] moments
      epoch: () int32
    """

    meta: torch.Tensor
    counts: torch.Tensor
    slab: torch.Tensor
    slab_stamps: torch.Tensor
    surf_s2: torch.Tensor
    epoch: torch.Tensor

    @property
    def _meta_slot(self) -> torch.Tensor:
        return self.meta.reshape(self.counts.shape[0], _W)

    @property
    def keys(self) -> torch.Tensor:
        return self._meta_slot[:, 0:3].to(torch.int32)

    @property
    def occupied(self) -> torch.Tensor:
        return self._meta_slot[:, 0] != _EMPTY

    @property
    def stamps(self) -> torch.Tensor:
        return self._meta_slot[:, 3].to(torch.int32)

    @property
    def surf_n(self) -> torch.Tensor:
        return self._meta_slot[:, 4]

    @property
    def surf_s1(self) -> torch.Tensor:
        return self._meta_slot[:, 5:8]

    @property
    def points(self) -> torch.Tensor:
        return self.slab.reshape(self.counts.shape[0], -1, 3)

    @property
    def slot_stamps(self) -> torch.Tensor:
        return self.slab_stamps.reshape(self.counts.shape[0], -1)


def make_map(cfg: VoxelMapConfig, dtype=torch.float32, device=None) -> VoxelHashMap:
    dev = _device.resolve(device)
    c, s, b = cfg.capacity, cfg.max_points, cfg.n_buckets
    meta = torch.zeros((b, cfg.probe_depth * _W), dtype=dtype, device=dev)
    meta[:, 0::_W] = _EMPTY
    return VoxelHashMap(
        meta=meta,
        counts=torch.zeros((c,), dtype=torch.int32, device=dev),
        slab=torch.zeros((c, s * 3), dtype=dtype, device=dev),
        slab_stamps=torch.zeros((c * s,), dtype=torch.int32, device=dev),
        surf_s2=torch.zeros((c, 6), dtype=dtype, device=dev),
        epoch=torch.zeros((), dtype=torch.int32, device=dev),
    )


def voxel_coord(pts: torch.Tensor, resolution: float) -> torch.Tensor:
    """World position -> integer voxel coordinate (floor), clipped so it is
    exact in the f32 meta rows."""
    v = torch.floor(pts / resolution)
    return torch.clamp(v, -_COORD_MAX, _COORD_MAX).to(torch.int32)


def voxel_corner(vox: torch.Tensor, resolution: float, dtype=torch.float32) -> torch.Tensor:
    """Voxel coordinate -> its world-space corner (moment anchor)."""
    return vox.to(dtype) * resolution


_SYM6_EXPAND = (0, 3, 4, 3, 1, 5, 4, 5, 2)


def _sym6_of(p: torch.Tensor) -> torch.Tensor:
    """Outer product p p^T of (..., 3) vectors, packed as (..., 6)."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    return torch.stack([x * x, y * y, z * z, x * y, x * z, y * z], dim=-1)


def _mat33_of_sym6(s: torch.Tensor) -> torch.Tensor:
    """(..., 6) symmetric-6 -> (..., 3, 3)."""
    idx = torch.tensor(_SYM6_EXPAND, device=s.device)
    return s[..., idx].reshape(*s.shape[:-1], 3, 3)


def _hash_with(vox: torch.Tensor, primes, n_buckets: int) -> torch.Tensor:
    # int32 tensor * Python int stays int32: the products wrap like JAX's.
    h = (vox[..., 0] * primes[0]) ^ (vox[..., 1] * primes[1]) ^ (vox[..., 2] * primes[2])
    return (h & 0x7FFFFFFF) % n_buckets


def _hash(vox: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """Spatial hash of (..., 3) int32 voxel coords into [0, n_buckets)."""
    return _hash_with(vox, _HP, n_buckets)


def _hash2(vox: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """Second, independent bucket hash (two-choice table)."""
    return _hash_with(vox, _HP2, n_buckets)


# Shard-ownership hash: its own primes, uncorrelated with the slot hashes
# so that per-shard occupancy stays uniform.
_HP_OWNER = (73856093, 19349669, 83492791)


def owner_of(vox: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Shard owner of each (..., 3) int32 voxel coord, in [0, n_shards):
    every voxel (slab, LRU stamp, surfel moments) lives on exactly one
    shard, so per-shard map memory is capacity_global / n_shards."""
    return _hash_with(vox, _HP_OWNER, n_shards)


class ProbeRows(NamedTuple):
    found: torch.Tensor  # (N,) slot holding exactly this voxel, or -1
    cand: torch.Tensor  # (N,) insertion candidate slot (empty or LRU-oldest)
    n: torch.Tensor  # (N,) moment count of the found slot (0 if miss)
    s1: torch.Tensor  # (N, 3) moment sum of the found slot (local)
    stamp: torch.Tensor  # (N,) LRU stamp of the found slot


def probe_rows(m: VoxelHashMap, vox: torch.Tensor, cfg: VoxelMapConfig) -> ProbeRows:
    """Bucket probe: two contiguous row gathers per query (both hash
    choices), then a lane reduction."""
    pd = cfg.probe_depth
    nb = cfg.n_buckets
    b1 = _hash(vox, nb).long()
    b2 = _hash2(vox, nb).long()
    rows1 = m.meta[b1].reshape(-1, pd, _W)
    rows2 = m.meta[b2].reshape(-1, pd, _W)
    w = torch.cat([rows1, rows2], dim=1)  # (N, 2pd, 8)
    nl = 2 * pd
    vox_f = vox.to(m.meta.dtype)

    lane = torch.arange(nl, device=vox.device)
    slot_of_lane = torch.where(
        lane[None, :] < pd,
        b1[:, None] * pd + lane[None, :],
        b2[:, None] * pd + (lane[None, :] - pd),
    )

    match = torch.all(w[..., 0:3] == vox_f[:, None, :], dim=-1) & (w[..., 0] != _EMPTY)
    first_match = torch.amin(torch.where(match, lane[None, :], nl), dim=1)
    has = first_match < nl
    lane_c = torch.clamp(first_match, max=nl - 1)
    found = torch.where(
        has, torch.gather(slot_of_lane, 1, lane_c[:, None])[:, 0], -1
    )

    empty = w[..., 0] == _EMPTY
    n_empty1 = torch.sum(empty[:, :pd], dim=1)
    n_empty2 = torch.sum(empty[:, pd:], dim=1)
    use2 = n_empty2 > n_empty1
    in_choice = torch.where(use2[:, None], lane[None, :] >= pd, lane[None, :] < pd)
    first_empty = torch.amin(torch.where(empty & in_choice, lane[None, :], nl), dim=1)
    oldest = torch.argmin(w[..., 3], dim=1)
    cand_lane = torch.where(first_empty < nl, first_empty, oldest)
    cand = torch.gather(slot_of_lane, 1, cand_lane[:, None])[:, 0]

    row_f = torch.gather(w, 1, lane_c[:, None, None].expand(-1, 1, _W))[:, 0, :]
    n = torch.where(has, row_f[:, 4], 0.0)
    s1 = torch.where(has[:, None], row_f[:, 5:8], 0.0)
    stamp = torch.where(has, row_f[:, 3], 0.0)
    return ProbeRows(
        found=found.to(torch.int32), cand=cand.to(torch.int32), n=n, s1=s1, stamp=stamp
    )


def probe(m: VoxelHashMap, vox: torch.Tensor, cfg: VoxelMapConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(found, cand) slots for a batch of voxels."""
    r = probe_rows(m, vox, cfg)
    return r.found, r.cand


class VoxelDedup(NamedTuple):
    """Per-scan unique-voxel table + the sort that built it."""

    uvox: torch.Tensor  # (cap, 3) int32 unique voxel coords
    uvalid: torch.Tensor  # (cap,) bool
    inv: torch.Tensor  # (n,) int32 point -> unique row (== cap on miss)
    order: torch.Tensor  # (n,) int64 sort permutation (points by voxel)
    seg: torch.Tensor  # (n,) int32 segment id per SORTED position (cap=invalid)


def unique_voxels(vox: torch.Tensor, mask: torch.Tensor, cap: int) -> VoxelDedup:
    """Deduplicate (N, 3) voxel coords into a static-size unique table
    (uvox[inv[i]] is point i's voxel; inv == cap for masked points and for
    voxels beyond the cap)."""
    n = vox.shape[0]
    dev = vox.device
    vox_m = torch.where(mask[:, None], vox, INT32_MAX)
    order = lexsort3(vox_m[:, 0], vox_m[:, 1], vox_m[:, 2])
    vox_s = vox_m[order]
    mask_s = mask[order]
    is_start = torch.cat(
        [torch.ones((1,), dtype=torch.bool, device=dev), torch.any(vox_s[1:] != vox_s[:-1], dim=-1)]
    ) & mask_s
    seg = torch.cumsum(is_start.to(torch.int32), dim=0, dtype=torch.int32) - 1
    seg = torch.where(mask_s & (seg >= 0) & (seg < cap), seg, cap)
    # Duplicate rows of seg carry equal values (one voxel), so any winner
    # of the set-scatter is the right one.
    uvox = set_drop(torch.zeros((cap, 3), dtype=torch.int32, device=dev), seg, vox_s)
    uvalid = set_drop(torch.zeros((cap,), dtype=torch.bool, device=dev), seg, True)
    inv = torch.empty((n,), dtype=torch.int32, device=dev)
    inv[order] = seg
    return VoxelDedup(uvox=uvox, uvalid=uvalid, inv=inv, order=order, seg=seg)


def _dedup_ranks(dedup: VoxelDedup, ok: torch.Tensor) -> torch.Tensor:
    """Within-voxel rank of each point among the `ok` points of its voxel
    (original order), reusing the dedup's sort."""
    n = ok.shape[0]
    dev = ok.device
    ok_s = ok[dedup.order].to(torch.int32)
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    is_start = torch.cat(
        [torch.ones((1,), dtype=torch.bool, device=dev), dedup.seg[1:] != dedup.seg[:-1]]
    )
    start_pos = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    excl = torch.cumsum(ok_s, dim=0, dtype=torch.int32) - ok_s
    rank_s = excl - excl[start_pos.long()]
    out = torch.empty((n,), dtype=torch.int32, device=dev)
    out[dedup.order] = rank_s
    return out


def _pack_rows(vox_f, stamp, n, s1):
    """Packed meta rows [kx, ky, kz, stamp, n, s1x, s1y, s1z]."""
    return torch.cat([vox_f, stamp[:, None], n[:, None], s1], dim=1)


def _scatter_slot_rows(meta: torch.Tensor, slots: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Scatter full 8-word slot rows into the bucketed meta table through
    its (C, 8) view (out-of-range slots drop)."""
    b, wide = meta.shape
    c = b * wide // _W
    return set_drop(meta.reshape(c, _W), slots, rows).reshape(b, wide)


class InsertCounts(NamedTuple):
    """What one insert did, as device int32 scalars (no host read)."""

    points_added: torch.Tensor  # points stored into the slabs
    fresh_voxels: torch.Tensor  # voxels not in the arena that a claim round took a slot for
    # voxels left without a slot after `claim_rounds`, their points not stored
    # (a claim may also take the slot of a voxel the scan found mapped)
    unclaimed_voxels: torch.Tensor


def insert(
    m: VoxelHashMap,
    pts: torch.Tensor,
    mask: torch.Tensor,
    cfg: VoxelMapConfig,
    dedup: VoxelDedup | None = None,
    counted: bool = False,
):
    """Batched map insert: probe, claim rounds (only when some voxel is
    unmapped; inside the span `map.claim`), slab scatter from the shared
    sort's ranks, and segment-sum moment updates — the JAX package's
    phases and semantics. Returns the map, or with `counted` (map,
    InsertCounts)."""
    n = pts.shape[0]
    dev = pts.device
    c, s = cfg.capacity, cfg.max_points
    dtype = m.meta.dtype
    vox = voxel_coord(pts, cfg.resolution)
    cap_u = min(cfg.lookup_unique_cap or n, n)
    if dedup is None:
        dedup = unique_voxels(vox, mask, cap_u)
    uvox, inv = dedup.uvox, dedup.inv
    u = uvox.shape[0]
    # A shared dedup may have been built with a wider mask: only voxels
    # holding a point accepted by THIS mask may claim or accumulate.
    uvalid = set_drop(
        torch.zeros((u,), dtype=torch.bool, device=dev),
        torch.where(mask & (inv < u), inv, u),
        True,
    )
    uids = torch.arange(u, dtype=torch.int32, device=dev)
    epoch_f = m.epoch.to(dtype)
    uvox_f = uvox.to(dtype)

    pr = probe_rows(m, uvox, cfg)
    need0 = uvalid & (pr.found < 0)

    meta = m.meta
    timing.sync_point("claim_any")
    if bool(need0.any()):  # host read: the JAX lax.cond
        with timing.span("map.claim"):
            fresh_rows = _pack_rows(
                uvox_f,
                torch.zeros((u,), dtype=dtype, device=dev) + epoch_f,
                torch.zeros((u,), dtype=dtype, device=dev),
                torch.zeros((u, 3), dtype=dtype, device=dev),
            )

            def claim_round(meta, cand, need):
                timing.count("map.claim_rounds")
                claim = torch.full((c,), INT32_MAX, dtype=torch.int32, device=dev)
                claim = reduce_drop(claim, torch.where(need, cand, c), uids, "amin")
                winner = need & (claim[cand.long()] == uids)
                wslot = torch.where(winner, cand, c)
                return _scatter_slot_rows(meta, wslot, fresh_rows)

            meta = claim_round(meta, pr.cand, need0)
            round_i = 1
            need_any = True
            while need_any and round_i < cfg.claim_rounds:  # the JAX while_loop
                found, cand = probe(m._replace(meta=meta), uvox, cfg)
                need = uvalid & (found < 0)
                meta = claim_round(meta, cand, need)
                timing.sync_point("claim_any")
                need_any = bool(need.any())  # host read per trip
                round_i += 1
    m1 = m._replace(meta=meta)

    pr2 = probe_rows(m1, uvox, cfg)
    found_u = torch.where(uvalid, pr2.found, -1)
    has_u = found_u >= 0
    slot_u = torch.where(has_u, found_u, c)

    fresh_u = has_u & (pr2.n == 0.0)
    fresh_slot = torch.where(fresh_u, found_u, c)
    counts = set_drop(m.counts, fresh_slot, 0)
    surf_s2 = set_drop(m.surf_s2, fresh_slot, 0.0)

    # ---- slab phase: conflict-free destinations from the shared sort.
    inv_c = torch.clamp(inv, max=u - 1).long()
    ok = mask & (inv < u) & has_u[inv_c]
    ranks = _dedup_ranks(dedup, ok)
    slot_uc = torch.clamp(slot_u, max=c - 1).long()
    cnt_base = counts[slot_uc][inv_c]
    dest = cnt_base + ranks
    ok = ok & (dest < s)
    slot_pt = torch.where(ok, found_u[inv_c], c)
    dest_c = torch.clamp(dest, 0, s - 1)
    col = dest_c[:, None] * 3 + torch.arange(3, dtype=torch.int32, device=dev)[None, :]
    slab = set2_drop(
        m.slab, slot_pt[:, None].expand(n, 3), col,
        torch.where(ok[:, None], pts, 0.0),
    )
    fs = torch.where(ok, slot_pt * s + dest_c, c * s)
    slab_stamps = set_drop(m.slab_stamps, fs, m.epoch)

    # Per-voxel accepted-point counts over the shared sort (non-ok lanes
    # add 0, so the sorted segment ids can be used as they are).
    ok_s2 = ok[dedup.order]
    added_u = segment_sum_sorted(ok_s2.to(torch.int32), dedup.seg, u)
    counts = set_drop(counts, slot_u, torch.clamp(counts[slot_uc] + added_u, max=s))

    # ---- moment phase (voxel-local coordinates).
    mok = mask & (inv < u)
    mok_s = mok[dedup.order]
    pts_s = pts[dedup.order]
    vox_s = vox[dedup.order]
    pts_l = torch.where(
        mok_s[:, None], pts_s - voxel_corner(vox_s, cfg.resolution, dtype), 0.0
    )
    d_n = segment_sum_sorted(mok_s.to(dtype), dedup.seg, u)
    d_s1 = segment_sum_sorted(pts_l, dedup.seg, u)
    d_s2 = segment_sum_sorted(_sym6_of(pts_l), dedup.seg, u)

    n_old = torch.where(fresh_u, 0.0, pr2.n)
    s1_old = torch.where(fresh_u[:, None], 0.0, pr2.s1)
    s2_old = torch.where(fresh_u[:, None], 0.0, m.surf_s2[slot_uc])
    g = torch.tensor(cfg.surfel_decay, dtype=dtype, device=dev)
    if cfg.surfel_freeze_n > 0.0:
        f = torch.clamp(1.0 - n_old / cfg.surfel_freeze_n, 0.0, 1.0)
    else:
        f = torch.ones((u,), dtype=dtype, device=dev)
    touched = has_u & (d_n > 0)
    n_new = torch.where(touched, g * n_old + f * d_n, n_old)
    s1_new = torch.where(touched[:, None], g * s1_old + f[:, None] * d_s1, s1_old)
    s2_new = torch.where(touched[:, None], g * s2_old + f[:, None] * d_s2, s2_old)

    rows = _pack_rows(uvox_f, epoch_f.expand(u), n_new, s1_new)
    meta = _scatter_slot_rows(meta, slot_u, rows)
    surf_s2 = set_drop(surf_s2, slot_u, s2_new)

    out = m._replace(
        meta=meta,
        counts=counts,
        slab=slab,
        slab_stamps=slab_stamps,
        surf_s2=surf_s2,
        epoch=m.epoch + 1,
    )
    if not counted:
        return out
    return out, InsertCounts(
        points_added=torch.sum(ok, dtype=torch.int32),
        fresh_voxels=torch.sum(need0 & has_u, dtype=torch.int32),
        unclaimed_voxels=torch.sum(uvalid & ~has_u, dtype=torch.int32),
    )


def nearby_offsets(nearby_type: int) -> Tuple[Tuple[int, int, int], ...]:
    """Neighbor-voxel stencils: center + 6 faces (+12 edges) (+8 corners)."""
    center = [(0, 0, 0)]
    faces = [(-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1), (0, 0, 1)]
    edges = [
        (1, 1, 0), (-1, 1, 0), (1, -1, 0), (-1, -1, 0),
        (1, 0, 1), (-1, 0, 1), (1, 0, -1), (-1, 0, -1),
        (0, 1, 1), (0, -1, 1), (0, 1, -1), (0, -1, -1),
    ]
    corners = [
        (1, 1, 1), (-1, 1, 1), (1, -1, 1), (1, 1, -1),
        (-1, -1, 1), (-1, 1, -1), (1, -1, -1), (-1, -1, -1),
    ]
    if nearby_type == 0:
        return tuple(center)
    if nearby_type == 6:
        return tuple(center + faces)
    if nearby_type == 18:
        return tuple(center + faces + edges)
    if nearby_type == 26:
        return tuple(center + faces + edges + corners)
    raise ValueError(f"nearby_type must be 0/6/18/26, got {nearby_type}")


def knn_plain(
    m: VoxelHashMap,
    queries: torch.Tensor,
    cfg: VoxelMapConfig,
    k: int = 5,
    max_dist2: float = 25.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`knn` op by op on any device (the CPU path, and the kernel's
    reference on the card): one batched probe for the whole stencil, then
    one slab-row gather per offset merged into a running best-k (old best
    first, then the new candidates). The merge is a stable sort, so equal
    distances (the many `inf` of empty slots among them) keep
    `lax.top_k`'s lower-index-first order."""
    n = queries.shape[0]
    s = cfg.max_points
    dev = queries.device
    vox_q = voxel_coord(queries, cfg.resolution)

    best_d2 = torch.full((n, k), torch.inf, dtype=queries.dtype, device=dev)
    best_pts = torch.zeros((n, k, 3), dtype=queries.dtype, device=dev)

    offs = torch.tensor(nearby_offsets(cfg.nearby_type), dtype=torch.int32, device=dev)
    n_off = offs.shape[0]
    vox_all = (vox_q[None, :, :] + offs[:, None, :]).reshape(-1, 3)
    found_all, _ = probe(m, vox_all, cfg)
    found_all = found_all.reshape(n_off, n)

    slot_arange = torch.arange(s, dtype=torch.int32, device=dev)
    for j in range(n_off):
        found = found_all[j]
        has = found >= 0
        slot = torch.clamp(found, 0, cfg.capacity - 1).long()
        cnt = torch.where(has, m.counts[slot], 0)
        cand = m.slab[slot].reshape(n, s, 3)
        cand_valid = slot_arange[None, :] < cnt[:, None]
        d2 = torch.sum((cand - queries[:, None, :]) ** 2, dim=-1)
        d2 = torch.where(cand_valid, d2, torch.inf)
        all_d2 = torch.cat([best_d2, d2], dim=1)
        all_pts = torch.cat([best_pts, cand], dim=1)
        sorted_d2, order = torch.sort(all_d2, dim=1, stable=True)
        best_d2 = sorted_d2[:, :k]
        best_pts = torch.gather(all_pts, 1, order[:, :k, None].expand(n, k, 3))

    valid = best_d2 <= max_dist2
    return best_pts, best_d2, valid


_KNN_KINDS = {torch.float32: 0, torch.float64: 1}
KNN_MAX_K = 16  # the kernel keeps the best k one a lane, in half a warp
_KNN_FN = None


def _knn_fn():
    """The C entry point `voxel_knn` (csrc/voxel_knn.cu), built and loaded
    at first use, with its argument types set."""
    global _KNN_FN
    if _KNN_FN is None:
        fn = cuda_build.load("voxel_knn").voxel_knn
        fn.argtypes = (
            [ctypes.c_int, ctypes.c_void_p, ctypes.c_int]  # kind, queries, n
            + [ctypes.c_void_p] * 3  # meta, counts, slab
            + [ctypes.c_int] * 3  # n_buckets, probe_depth, max_points
            + [ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int]  # offsets, n_off, k
            + [ctypes.c_double] * 2  # resolution, max_dist2
            + [ctypes.c_void_p] * 4  # out_pts, out_d2, out_valid, stream
        )
        fn.restype = ctypes.c_int
        _KNN_FN = fn
    return _KNN_FN


@functools.lru_cache(maxsize=None)
def _stencil_c(nearby_type: int):
    offs = [c for off in nearby_offsets(nearby_type) for c in off]
    return (ctypes.c_int * len(offs))(*offs), len(offs) // 3


def _knn_check(m: VoxelHashMap, queries: torch.Tensor, cfg: VoxelMapConfig, k: int) -> int:
    """The kernel's `kind` for these inputs; raises ValueError on what the
    kernel does not take: k outside [1, KNN_MAX_K], a dtype other than
    float32 or float64 (queries, meta and slab alike), shapes other than
    cfg's, a tensor on another device than the queries, or one not
    contiguous."""
    if not 1 <= k <= KNN_MAX_K:
        raise ValueError(f"knn: k must be in [1, {KNN_MAX_K}] on CUDA, got {k}")
    dtype = queries.dtype
    kind = _KNN_KINDS.get(dtype)
    if kind is None:
        raise ValueError(f"knn: queries must be float32 or float64, got {dtype}")
    n = queries.shape[0]
    c, s = cfg.capacity, cfg.max_points
    expect = (
        ("queries", queries, (n, 3), dtype),
        ("meta", m.meta, (cfg.n_buckets, cfg.probe_depth * _W), dtype),
        ("counts", m.counts, (c,), torch.int32),
        ("slab", m.slab, (c, s * 3), dtype),
    )
    dev = queries.device
    for name, t, shape, want in expect:
        if t.shape != shape or t.dtype != want:
            raise ValueError(f"knn: {name} must be {shape} {want}, got {tuple(t.shape)} {t.dtype}")
        if t.device != dev:
            raise ValueError(f"knn: {name} is on {t.device}, queries on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"knn: {name} must be contiguous")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"knn: inputs on {dev}, current device cuda:{torch.cuda.current_device()}")
    return kind


def _voxel_knn_cuda(queries, meta, counts, slab, kind, n_buckets, probe_depth, max_points, nearby_type, k,
                    resolution, max_dist2):
    """The op `fastlivo_torch::voxel_knn` on CUDA: the outputs, then one
    launch on the current stream."""
    n = queries.shape[0]
    dev = queries.device
    pts = torch.empty((n, k, 3), dtype=queries.dtype, device=dev)
    d2 = torch.empty((n, k), dtype=queries.dtype, device=dev)
    valid = torch.empty((n, k), dtype=torch.bool, device=dev)
    offs, n_off = _stencil_c(nearby_type)
    err = _knn_fn()(
        kind, queries.data_ptr(), n, meta.data_ptr(), counts.data_ptr(), slab.data_ptr(), n_buckets,
        probe_depth, max_points, offs, n_off, k, resolution, max_dist2, pts.data_ptr(), d2.data_ptr(),
        valid.data_ptr(), torch._C._cuda_getCurrentRawStream(dev.index),
    )
    if err != 0:
        raise RuntimeError(f"voxel_knn kernel launch failed: cudaError {err}")
    return pts, d2, valid


# The launch goes through the dispatcher as an op of its own, so that the
# profiler links the kernel to an op inside the `voxel_map.knn` range and
# the range's device time counts it (a launch made straight under a
# record_function range is linked to no op).
_KNN_LIB = torch.library.Library("fastlivo_torch", "DEF")
_KNN_LIB.define(
    "voxel_knn(Tensor queries, Tensor meta, Tensor counts, Tensor slab, int kind, int n_buckets, "
    "int probe_depth, int max_points, int nearby_type, int k, float resolution, float max_dist2) "
    "-> (Tensor, Tensor, Tensor)"
)
_KNN_LIB.impl("voxel_knn", _voxel_knn_cuda, "CUDA")


def _knn_launch(m, queries, cfg, k, max_dist2):
    """One kernel launch on the current stream (none for 0 queries)."""
    kind = _knn_check(m, queries, cfg, k)
    n = queries.shape[0]
    if n == 0:
        dev, dt = queries.device, queries.dtype
        return (torch.empty((0, k, 3), dtype=dt, device=dev), torch.empty((0, k), dtype=dt, device=dev),
                torch.empty((0, k), dtype=torch.bool, device=dev))
    out = torch.ops.fastlivo_torch.voxel_knn(
        queries, m.meta, m.counts, m.slab, kind, cfg.n_buckets, cfg.probe_depth, cfg.max_points,
        cfg.nearby_type, k, cfg.resolution, max_dist2,
    )
    timing.count_launch("voxel_map.knn.launches")
    return out


@timing.traced("voxel_map.knn", ranged=True)  # a profiler range in every profile
def knn(
    m: VoxelHashMap,
    queries: torch.Tensor,
    cfg: VoxelMapConfig,
    k: int = 5,
    max_dist2: float = 25.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """k nearest map points per query over the neighbor-voxel stencil: one
    launch of `csrc/voxel_knn.cu` for CUDA tensors (the bits `knn_plain`
    gives on the same tensors), `knn_plain` for CPU tensors. Among equal
    distances the earlier stencil offset, then the lower slab slot, ranks
    first (`lax.top_k`'s order); an entry without a neighbor has d2 `inf`
    and a zero point, one beyond max_dist2 its point and valid False.

    Returns (neighbors (N, k, 3), d2 (N, k), valid (N, k))."""
    if queries.is_cuda:
        return _knn_launch(m, queries, cfg, k, max_dist2)
    if queries.device.type == "cpu":
        return knn_plain(m, queries, cfg, k, max_dist2)
    raise ValueError(f"knn: unsupported device {queries.device}")


def slab_insert_gate(
    m: VoxelHashMap,
    pts_world: torch.Tensor,
    pts_mask: torch.Tensor,
    cfg: VoxelMapConfig,
    filter_size_map: float,
    k_full: int = 5,
    dedup: VoxelDedup | None = None,
) -> torch.Tensor:
    """Map-insert gate from the point's OWN voxel slab (no kNN): add when
    there is no stored neighbor, the nearest lies outside the point's
    filter voxel, or no stored point is closer to the filter-voxel center."""
    n = pts_world.shape[0]
    s = cfg.max_points
    vox = voxel_coord(pts_world, cfg.resolution)
    cap_u = min(cfg.lookup_unique_cap or n, n)
    if dedup is None:
        dedup = unique_voxels(vox, pts_mask, cap_u)
    u = dedup.uvox.shape[0]
    found_u, _ = probe(m, dedup.uvox, cfg)
    inv_c = torch.clamp(dedup.inv, max=u - 1).long()
    found = torch.where(dedup.inv < u, found_u[inv_c], -1)
    has = found >= 0
    slot = torch.clamp(found, 0, cfg.capacity - 1).long()
    cnt = torch.where(has, m.counts[slot], 0)
    slab = m.slab[slot].reshape(n, s, 3)
    valid = torch.arange(s, dtype=torch.int32, device=pts_world.device)[None, :] < cnt[:, None]

    center = (torch.floor(pts_world / filter_size_map) + 0.5) * filter_size_map
    d2 = torch.sum((slab - pts_world[:, None, :]) ** 2, dim=-1)
    d2 = torch.where(valid, d2, torch.inf)
    j = torch.argmin(d2, dim=1)
    nn = torch.gather(slab, 1, j[:, None, None].expand(-1, 1, 3))[:, 0, :]
    has_nbr = torch.any(valid, dim=1)
    outside = torch.all(torch.abs(nn - center) > 0.5 * filter_size_map, dim=-1)
    dist_self = torch.sum((pts_world - center) ** 2, dim=-1)
    dist_nbrs = torch.where(
        valid, torch.sum((slab - center[:, None, :]) ** 2, dim=-1), torch.inf
    )
    nbr_closer = torch.any(dist_nbrs < dist_self[:, None] + 1e-6, dim=1)
    full_k = cnt >= k_full
    need_add = ~(full_k & nbr_closer)
    return pts_mask & (~has_nbr | outside | need_add)


class SurfelResult(NamedTuple):
    normal: torch.Tensor  # (N, 3) unit plane normal (0 when invalid)
    d: torch.Tensor  # (N,) plane offset: n.x + d = 0
    valid: torch.Tensor  # (N,) bool
    min_eig: torch.Tensor  # (N,) smallest covariance eigenvalue
    n_pts: torch.Tensor  # (N,) accumulated moment count of the voxel


class _StencilWin(NamedTuple):
    d2: torch.Tensor
    slot: torch.Tensor
    has: torch.Tensor
    n: torch.Tensor
    mean: torch.Tensor  # world coords
    mean_l: torch.Tensor  # voxel-local coords


def _stencil_candidate(
    m: VoxelHashMap,
    vox_q: torch.Tensor,
    ref_pts: torch.Tensor,
    valid_q: torch.Tensor,
    cfg: VoxelMapConfig,
    min_points: float,
    dtype,
) -> _StencilWin:
    """Per-query 7-voxel stencil probe + nearest-valid-mean winner (first
    offset wins ties)."""
    n = vox_q.shape[0]
    offs = torch.tensor(nearby_offsets(6), dtype=torch.int32, device=vox_q.device)
    n_off = offs.shape[0]
    vox_all = (vox_q[None, :, :] + offs[:, None, :]).reshape(-1, 3)
    pr = probe_rows(m, vox_all, cfg)
    cnt = pr.n
    ok = (cnt >= min_points) & (pr.found >= 0) & valid_q.repeat(n_off)
    mean_l = pr.s1 / torch.clamp(cnt, min=1.0)[:, None]
    mean = mean_l + voxel_corner(vox_all, cfg.resolution, dtype)
    d2 = torch.sum((mean.reshape(n_off, n, 3) - ref_pts[None, :, :]) ** 2, dim=-1)
    d2 = torch.where(ok.reshape(n_off, n), d2, torch.inf)
    best_off = torch.argmin(d2, dim=0)

    def take(a):
        a = a.reshape(n_off, n, -1)
        return torch.gather(a, 0, best_off[None, :, None].expand(1, n, a.shape[-1]))[0]

    best_d2 = take(d2[..., None])[:, 0]
    best_slot = take(pr.found[:, None])[:, 0]
    has = torch.isfinite(best_d2)
    return _StencilWin(
        d2=best_d2,
        slot=torch.where(has, best_slot, 0),
        has=has,
        n=take(cnt[:, None])[:, 0],
        mean=take(mean),
        mean_l=take(mean_l),
    )


def _surfel_win(m, queries, cfg, min_points) -> _StencilWin:
    n = queries.shape[0]
    dtype = queries.dtype
    vox_q = voxel_coord(queries, cfg.resolution)
    cap = cfg.lookup_unique_cap
    if cap and cap < n:
        dd = unique_voxels(vox_q, torch.ones((n,), dtype=torch.bool, device=queries.device), cap)
        ucenter = voxel_corner(dd.uvox, cfg.resolution, dtype) + 0.5 * cfg.resolution
        uwin = _stencil_candidate(m, dd.uvox, ucenter, dd.uvalid, cfg, min_points, dtype)
        inv_c = torch.clamp(dd.inv, max=cap - 1).long()
        okq = dd.inv < cap
        has = okq & uwin.has[inv_c]
        return _StencilWin(
            d2=torch.where(has, uwin.d2[inv_c], torch.inf),
            slot=torch.where(has, uwin.slot[inv_c], 0),
            has=has,
            n=torch.where(has, uwin.n[inv_c], 0.0),
            mean=torch.where(has[:, None], uwin.mean[inv_c], 0.0),
            mean_l=torch.where(has[:, None], uwin.mean_l[inv_c], 0.0),
        )
    return _stencil_candidate(
        m, vox_q, queries, torch.ones((n,), dtype=torch.bool, device=queries.device),
        cfg, min_points, dtype,
    )


def surfel_candidate(
    m: VoxelHashMap, queries: torch.Tensor, cfg: VoxelMapConfig, min_points: float = 6.0
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(best_d2, best_slot, has) among the query voxel and its 6 face
    neighbors (populated voxels, nearest mean)."""
    win = _surfel_win(m, queries, cfg, min_points)
    return win.d2, win.slot, win.has


def _plane_from_win(m: VoxelHashMap, win: _StencilWin, planarity_max: float) -> SurfelResult:
    """Plane from a stencil winner: the mean + the smallest eigenvector of
    the moment covariance (closed-form eigh3)."""
    dtype = m.meta.dtype
    cnt = torch.clamp(win.n, min=1.0)
    s2 = _mat33_of_sym6(m.surf_s2[win.slot.long()])
    cov = s2 / cnt[:, None, None] - win.mean_l[:, :, None] * win.mean_l[:, None, :]
    cov = cov + torch.eye(3, dtype=dtype, device=cov.device) * 1e-9
    min_eig, normal = linalg.eigh3_smallest(cov)
    d = -torch.sum(normal * win.mean, dim=-1)
    valid = win.has & (min_eig <= planarity_max)
    normal = torch.where(valid[:, None], normal, 0.0)
    d = torch.where(valid, d, 0.0)
    return SurfelResult(
        normal=normal,
        d=d,
        valid=valid,
        min_eig=torch.where(win.has, min_eig, torch.inf),
        n_pts=win.n * win.has.to(dtype),
    )


def surfel_plane(
    m: VoxelHashMap,
    slot: torch.Tensor,
    has: torch.Tensor,
    cfg: VoxelMapConfig,
    planarity_max: float = 0.01,
) -> SurfelResult:
    """Plane parameters from a voxel slot's running moments (the compat
    entry: gathers the slot's packed meta row; the lookups call
    _plane_from_win with the moments at hand)."""
    dtype = m.meta.dtype
    row = m._meta_slot[slot.long()]
    cnt = torch.clamp(row[:, 4], min=1.0)
    mean_l = row[:, 5:8] / cnt[:, None]
    mean = mean_l + row[:, 0:3] * cfg.resolution
    win = _StencilWin(
        d2=torch.zeros_like(cnt),
        slot=slot,
        has=has,
        n=row[:, 4] * has.to(dtype),
        mean=mean,
        mean_l=mean_l,
    )
    return _plane_from_win(m, win, planarity_max)


def surfel_lookup(
    m: VoxelHashMap,
    queries: torch.Tensor,
    cfg: VoxelMapConfig,
    min_points: float = 6.0,
    planarity_max: float = 0.01,
) -> SurfelResult:
    """Per-query surfel plane from the running voxel moments; with
    cfg.lookup_unique_cap the chain runs once per unique scan voxel."""
    n = queries.shape[0]
    cap = cfg.lookup_unique_cap
    if cap and cap < n:
        dtype = queries.dtype
        vox_q = voxel_coord(queries, cfg.resolution)
        dd = unique_voxels(vox_q, torch.ones((n,), dtype=torch.bool, device=queries.device), cap)
        ucenter = voxel_corner(dd.uvox, cfg.resolution, dtype) + 0.5 * cfg.resolution
        uwin = _stencil_candidate(m, dd.uvox, ucenter, dd.uvalid, cfg, min_points, dtype)
        ures = _plane_from_win(m, uwin, planarity_max)
        inv_c = torch.clamp(dd.inv, max=cap - 1).long()
        okq = dd.inv < cap
        return SurfelResult(
            normal=torch.where(okq[:, None], ures.normal[inv_c], 0.0),
            d=torch.where(okq, ures.d[inv_c], 0.0),
            valid=okq & ures.valid[inv_c],
            min_eig=torch.where(okq, ures.min_eig[inv_c], torch.inf),
            n_pts=torch.where(okq, ures.n_pts[inv_c], 0.0),
        )
    win = _surfel_win(m, queries, cfg, min_points)
    return _plane_from_win(m, win, planarity_max)


# ---------------------------------------------------------------------------
# Sharded arena (the map partitioned over a mesh axis by `owner_of`).
#
# Each rank's arena stores only the voxels it owns. Queries are replicated
# (the downsampled scan is small); each rank resolves them against its own
# shard, where voxels it does not own are simply absent, and the per-shard
# results merge with collectives: surfel by a minimum on candidate distance
# (two MIN all-reduces and one SUM of the winner's payload), kNN by a
# gather of every shard's best k and a second best-k. Inserts are local:
# each rank scatters only the points whose voxel it owns.
# ---------------------------------------------------------------------------


def owned_mask(pts: torch.Tensor, resolution: float, axis) -> torch.Tensor:
    """True for points whose voxel this rank owns on `axis`."""
    return owner_of(voxel_coord(pts, resolution), axis.size) == axis.index


def sharded_insert(
    m: VoxelHashMap,
    pts: torch.Tensor,
    mask: torch.Tensor,
    cfg: VoxelMapConfig,
    axis,
    dedup: VoxelDedup | None = None,
) -> VoxelHashMap:
    """Shard-local insert: every rank sees the full gated scan and scatters
    only its owned voxels. `insert` re-derives per-voxel validity from the
    narrowed mask, so a replicated dedup table can be passed through."""
    return insert(m, pts, mask & owned_mask(pts, cfg.resolution, axis), cfg, dedup=dedup)


def sharded_surfel_lookup(
    m: VoxelHashMap,
    queries: torch.Tensor,
    cfg: VoxelMapConfig,
    axis,
    min_points: float = 6.0,
    planarity_max: float = 0.01,
) -> SurfelResult:
    """Surfel lookup over a sharded arena; `queries` replicated over `axis`,
    the result replicated too. Each rank finds its best local candidate and
    fits its plane (only the owner holds the moments); the winner per query
    is the least mean distance, lowest rank on ties (two distinct voxels on
    two shards can tie), and its 7-wide payload is summed over the axis."""
    dtype = queries.dtype
    win = _surfel_win(m, queries, cfg, min_points)
    res = _plane_from_win(m, win, planarity_max)

    d2m = torch.where(win.has, win.d2, torch.inf)
    gmin = axis.pmin(d2m)
    contender = torch.where((d2m == gmin) & win.has, axis.index, axis.size).to(torch.int32)
    gidx = axis.pmin(contender)
    win_dev = (contender == gidx) & (gidx < axis.size)

    payload = torch.cat(
        [
            res.normal,
            res.d[:, None],
            res.valid.to(dtype)[:, None],
            torch.where(torch.isfinite(res.min_eig), res.min_eig, 0.0)[:, None],
            res.n_pts[:, None],
        ],
        dim=1,
    )
    merged = axis.psum(torch.where(win_dev[:, None], payload, 0.0))
    any_win = axis.psum(win_dev.to(torch.int32)) > 0
    return SurfelResult(
        normal=merged[:, 0:3],
        d=merged[:, 3],
        valid=(merged[:, 4] > 0.5) & any_win,
        min_eig=torch.where(any_win, merged[:, 5], torch.inf),
        n_pts=merged[:, 6],
    )


def sharded_knn(
    m: VoxelHashMap,
    queries: torch.Tensor,
    cfg: VoxelMapConfig,
    axis,
    k: int = 5,
    max_dist2: float = 25.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """kNN over a sharded arena; `queries` replicated, result replicated.
    Every shard's best k are gathered ((size, N, k) in rank order, as JAX's
    all_gather) and the best k taken again by a stable sort, which keeps
    `lax.top_k`'s lower-index-first order among equal distances."""
    n = queries.shape[0]
    pts_l, d2_l, _ = knn(m, queries, cfg, k=k, max_dist2=max_dist2)
    d2_all = axis.all_gather(d2_l).reshape(axis.size, n, k).transpose(0, 1).reshape(n, -1)
    pts_all = axis.all_gather(pts_l).reshape(axis.size, n, k, 3).transpose(0, 1).reshape(n, -1, 3)
    best_d2, idx = torch.sort(d2_all, dim=1, stable=True)
    best_d2 = best_d2[:, :k]
    best_pts = torch.gather(pts_all, 1, idx[:, :k, None].expand(n, k, 3))
    return best_pts, best_d2, best_d2 <= max_dist2


def reanchor(
    m: VoxelHashMap,
    cfg: VoxelMapConfig,
    seg_of_epoch: torch.Tensor,
    rots: torch.Tensor,
    trans: torch.Tensor,
    chunk: int = 65536,
    axis=None,
) -> VoxelHashMap:
    """Rigidly re-anchor the live arena after a loop correction: every
    stored point moves by the correction of the segment its slot's insert
    epoch maps to, p' = R_seg p + t_seg, and the arena is rebuilt by
    re-inserting the slab in chunks (points change voxels under the
    correction). Surfel moments are rebuilt from the slab points.

    As in JAX every chunk is inserted and the epoch advances by one per
    chunk, n_chunks in all.

    Args:
      seg_of_epoch: (E,) int32 insert epoch -> correction segment.
      rots/trans: (K, 3, 3), (K, 3) per-segment corrections.
      axis: the axis a sharded arena partitions over. A corrected point may
        land in a voxel another shard owns, so each transformed chunk is
        gathered over the axis and inserted shard-locally: no point is
        dropped on an ownership change. Every shard inserts the same number
        of chunks, so the epochs stay in lockstep.
    """
    c, s = cfg.capacity, cfg.max_points
    chunk = min(chunk, c * s)
    dev = m.slab.device
    slot_valid = (
        torch.arange(s, dtype=torch.int32, device=dev)[None, :] < m.counts[:, None]
    ) & m.occupied[:, None]

    n_chunks = -(-(c * s) // chunk)
    pad = n_chunks * chunk - c * s
    flat_pts = F.pad(m.slab.reshape(c * s, 3), (0, 0, 0, pad))
    flat_ok = F.pad(slot_valid.reshape(c * s), (0, pad))
    flat_ep = F.pad(m.slab_stamps, (0, pad))

    fresh = make_map(cfg, m.slab.dtype, dev)
    for i in range(n_chunks):
        lo = i * chunk
        p_chunk = flat_pts[lo: lo + chunk]
        ep_chunk = flat_ep[lo: lo + chunk]
        seg = seg_of_epoch[torch.clamp(ep_chunk, 0, seg_of_epoch.shape[0] - 1).long()].long()
        p_chunk = torch.einsum("nij,nj->ni", rots[seg], p_chunk) + trans[seg]
        ok_chunk = flat_ok[lo: lo + chunk]
        fresh = fresh._replace(epoch=m.epoch + i)
        if axis is None:
            fresh = insert(fresh, p_chunk, ok_chunk, cfg)
        else:
            fresh = sharded_insert(fresh, axis.all_gather(p_chunk), axis.all_gather(ok_chunk), cfg, axis)
    return fresh._replace(epoch=m.epoch + n_chunks)


def num_occupied(m: VoxelHashMap) -> torch.Tensor:
    return torch.sum(m.occupied.to(torch.int32))


def num_points(m: VoxelHashMap) -> torch.Tensor:
    return torch.sum(m.counts)
