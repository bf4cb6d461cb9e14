"""The LIO check: the port's point-to-plane LIO updates held to the plain
reference (`livobench/reference/lio.py`, float64).

The LIVO filter is sequential, and a reference run on its own from the
first record would drift from the program by rounding over thousands of
updates. So the reference checks the start from scratch, and follows the
window step by step from the program's own state:

- the start: the reference replays the records itself (its own grouping,
  static initialization, propagation, warm-up map) up to and including
  the first LIO update, and compares it with the program's;
- the window: at a few LIO updates drawn from the seed the keeper holds
  the program's state before the update (filter state, voxel map) and
  after it (state, map). The reference builds those groups from the
  records itself and runs its own LIO update from the kept state before it.

Numbers compared, each the largest over the checked updates:

- `lio_pos_gap_m`, `lio_rot_gap_rad`: the LIO posterior's position and
  attitude against the reference's;
- `map_gap_m`: the points the update added to the voxel map against the
  reference's scan placed by its posterior: the 90th percentile, over the
  added points, of the distance to the nearest reference point (one side
  adding points and the other none reads infinite);
- `lio_start_pos_gap_m`: `lio_pos_gap_m` of the start alone, where the
  reference follows no kept state and meets the program's whole chain from
  the records on in its own precision. It is the number that tells the
  float64 program from its float32 path: at the room's revisits a window
  update of the sound program can read up to ~2e-5 m (a gate that flips
  for a few points), as far as the float32 path reads (PERF.md).

The reference's replay (`replay`, made once an arithmetic by the run's
`check.Shared`) also leaves, for each checked update, its scan cloud and
the group after it, for a check that follows the next update from there
(`vio`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from livobench.check import ARENA_EMPTY, clone, compare, largest, pose_gaps, quantile, sound
from livobench.reference import lio as rlio
from livobench.reference import records
from livobench.reference.arith import Arith

NUMBERS = ("lio_pos_gap_m", "lio_rot_gap_rad", "map_gap_m", "lio_start_pos_gap_m")
HOLDS = tuple(f"lio.{m}" for m in rlio.MODELS)


@dataclass
class Kept:
    """The program's states around one checked LIO update. The state is a
    NavState (rot, pos, vel, bg, ba, grav, cov); the map the voxel arena
    (meta, counts, slab (slots, 3 cap), slab_stamps, the insert epoch of
    each point, surf_s2, epoch). The program's first update keeps no state
    before it: the reference replays that from the records."""

    pre_state: tuple = None
    pre_map: tuple = None
    lio_state: tuple = None
    lio_map: tuple = None
    lio_trips: tuple = None  # (ESKF trips, points in the last trip's residuals), as the program reports them


@dataclass
class Scan:
    """What the reference's replay leaves of one checked LIO update: its
    downsampled LiDAR-frame points, whether its update was accepted, and
    the group after it (with its ordinal) where that is an image group."""

    ds: torch.Tensor
    accept: bool
    next_group: object = None
    next_index: int = -1


@dataclass
class Followed:
    """The reference's answers, keyed as the program's are, its scans by
    the updates' groups, and the accelerometer scale of its static
    initialization."""

    answers: Dict[tuple, dict]
    scans: Dict[int, Scan]
    scale: float


class Keeper:
    """The program's states around each kept LIO update, by its group."""

    def __init__(self, tree: dict):
        self.kept: Dict[int, Kept] = {}

    def first_lio(self, pipe, group: int, info):
        self.kept[group] = Kept()
        self.after_lio(pipe, group, info)

    def before_lio(self, pipe, group: int):
        self.kept[group] = Kept(pre_state=clone(pipe.state), pre_map=clone(pipe.map))

    def after_lio(self, pipe, group: int, info):
        k = self.kept[group]
        k.lio_state, k.lio_map = clone(pipe.state), clone(pipe.map)
        k.lio_trips = (int(info.iterations), int(info.n_effective))


def followed(kept: Keeper, shared) -> Dict[int, Kept]:
    """The window's checked updates that ran, by group."""
    return {g: kept.kept[g] for g in shared.cycles if kept.kept[g].lio_state is not None}


# ---------------------------------------------------------------------------
# What the program wrote, read from its kept state.
# ---------------------------------------------------------------------------


def arena_map(m: tuple, res: float, ar: Arith, device) -> rlio.PointMap:
    meta, counts, slab = (x.to(device) for x in m[:3])
    rows = meta.reshape(counts.shape[0], -1)
    return rlio.PointMap.of_arena(rows[:, 0:3].to(torch.int64), rows[:, 0] != ARENA_EMPTY, counts,
                                  slab.reshape(counts.shape[0], -1, 3), res, ar)


def arena_added(m: tuple) -> torch.Tensor:
    """The points the last insert added (stamped with the epoch before)."""
    _, counts, slab, stamps, _, epoch = m
    c = counts.shape[0]
    s = slab.shape[1] // 3
    live = torch.arange(s)[None, :] < counts[:, None]
    return slab.reshape(c, s, 3)[live & (stamps.reshape(c, s) == int(epoch) - 1)]


def pose(st) -> dict:
    return {"rot": st[0].double(), "pos": st[1].double()}


def program_outputs(keeper: Keeper, shared) -> Dict[tuple, dict]:
    """The program's answers at the checked updates, keyed as the
    reference's are."""

    def lio(g, k):
        return {**pose(k.lio_state), "group": g, "pts": arena_added(k.lio_map).double(), "trips": k.lio_trips}

    out = {("lio", "start"): lio(shared.start, keeper.kept[shared.start])}
    for g, k in followed(keeper, shared).items():
        out[("lio", g)] = lio(g, k)
    return out


# ---------------------------------------------------------------------------
# The reference's answers.
# ---------------------------------------------------------------------------


class Rig:
    """The LiDAR-IMU extrinsics (p_imu = R_il p_lidar + t_il)."""

    def __init__(self, p, ar: Arith, device):
        self.r_il = ar.t(np.asarray(p.extrinsics.extrinsic_r, np.float64).reshape(3, 3), device)
        self.t_il = ar.t(np.asarray(p.extrinsics.extrinsic_t, np.float64), device)


def replay(p, pool, keeper: Keeper, shared, device, ar: Arith) -> Followed:
    """The reference's answers at the updates the keeper holds: the start
    replayed from scratch, the window's from the program's kept states."""
    dev = torch.device(device)
    rig = Rig(p, ar, dev)
    lp, mp = p.lio, p.map
    init = records.StaticInit(p.imu.init_count, p.imu.zero_velocity_thresh)
    by_group = followed(keeper, shared)
    last = max([g + 1 for g in by_group] + [shared.start + 1])
    out: Dict[tuple, dict] = {}
    scans: Dict[int, Scan] = {}
    state, scale, first_t = None, 1.0, None
    pmap = rlio.PointMap.empty(mp.resolution, mp.max_points_per_voxel, ar, dev)
    started = False
    after = None  # the group of the LIO update whose next group comes now

    def lio_step(prior_state, pmap_in, g):
        prior, tr = rlio.propagate(ar, prior_state, g, scale, p.imu)
        pts = rlio.undistort(ar, ar.t(g.pts, dev), ar.t(g.pt_t, dev), tr, prior, rig.r_il, rig.t_il)
        ds = rlio.downsample(pts, lp.filter_size_surf, lp.max_points)
        post, accept, nb, nv, trips = rlio.update(ar, prior, ds, pmap_in, rig.r_il, rig.t_il, p)
        p_w = rlio.world_points(ar, ds, post, rig.r_il, rig.t_il)
        add = rlio.insert_gate(p_w, nb, nv, lp.filter_size_map) & accept
        went = pmap_in.insert(p_w, add)
        return post, ds, accept, p_w[went], trips, p_w

    def answer(key, gi, g, prior_state, pmap_in):
        post, ds, accept, added, trips, cand = lio_step(prior_state, pmap_in, g)
        out[("lio", key)] = {"rot": post.rot.double(), "pos": post.pos.double(), "group": gi,
                             "pts": added.double().cpu(), "trips": trips, "cloud": cand.double().cpu()}
        scans[gi] = Scan(ds, bool(accept))
        return post

    for gi, g in enumerate(records.groups(pool.stream(), p)):
        if gi > last:
            break
        if after is not None:
            if not g.lidar_end:
                scans[after].next_group, scans[after].next_index = g, gi
            after = None
            if not g.lidar_end:
                continue
        if not init.done:
            if init.push(g):
                z = np.zeros(3)
                state = rlio.state_of((np.eye(3), z, z, init.mean_gyr, z, init.gravity, 1e-3 * np.eye(18)), ar, dev)
                scale = float(np.float32(init.acc_scale))
            continue
        if not started:
            if not g.lidar_end:
                state, _ = rlio.propagate(ar, state, g, scale, p.imu)
                continue
            if first_t is None or g.t_abs - first_t < lp.init_time:  # the warm-up: propagate, insert all
                first_t = g.t_abs if first_t is None else first_t
                state, _ = rlio.propagate(ar, state, g, scale, p.imu)
                ds = rlio.downsample(ar.t(g.pts, dev), lp.filter_size_surf, lp.max_points)
                p_w = rlio.world_points(ar, ds, state, rig.r_il, rig.t_il)
                pmap.insert(p_w, torch.ones(p_w.shape[0], dtype=torch.bool, device=dev))
                continue
            state = answer("start", gi, g, state, pmap)
            started, after = True, gi
            continue
        if g.lidar_end and gi in by_group:
            k = by_group[gi]
            answer(gi, gi, g, rlio.state_of(k.pre_state, ar, dev), arena_map(k.pre_map, mp.resolution, ar, dev))
            after = gi
    return Followed(out, scans, scale)


# ---------------------------------------------------------------------------
# Gaps.
# ---------------------------------------------------------------------------


def _nearest(a: torch.Tensor, b: torch.Tensor, chunk: int = 1024) -> torch.Tensor:
    return torch.cat([torch.cdist(a[i:i + chunk], b).min(1).values for i in range(0, a.shape[0], chunk)])


def placement_gap(added: torch.Tensor, candidates: torch.Tensor, q: float = 0.9) -> float:
    """The q-th quantile, over the points one side added to the map, of
    the distance to the nearest of the other side's scan points in the
    world (the points its insert chose from); infinite where one side
    added points and the other none. The insert's choice among near-equal
    points flips with the last bit of a pose in a filled map, so the
    points are held to where they lie, not to which were chosen."""
    if added.shape[0] == 0:
        return 0.0 if candidates.shape[0] == 0 else math.inf
    if candidates.shape[0] == 0:
        return math.inf
    return quantile(_nearest(added, candidates), q)


def gaps(rcfg, tree, pool, kept: Keeper, device, arith: Arith, log, shared) -> Dict[str, float]:
    want = shared.replay(Arith()).answers
    got = program_outputs(kept, shared) if sound(arith) else shared.replay(arith).answers
    out = largest(compare(
        got, want, "lio", NUMBERS[:3],
        lambda a, b: (*pose_gaps(a, b), placement_gap(a["pts"], b["cloud"] if b["pts"].shape[0] else b["pts"])),
        log,
        lambda a, b: (f"; trips and residual points {a.get('trips')} against {b.get('trips')}, "
                      f"points added {a['pts'].shape[0]} against {b['pts'].shape[0]}"),
    ))
    a, b = got.get(("lio", "start")), want.get(("lio", "start"))
    same = a is not None and b is not None and a["group"] == b["group"]
    out["lio_start_pos_gap_m"] = pose_gaps(a, b)[0] if same else math.inf
    return out
