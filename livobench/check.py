"""What decides `correct`: the port's updates held to the plain reference
(`livobench/reference/`, written from the mathematics in float64).

The LIVO filter is sequential, and a reference run on its own from the
first record would drift from the program by rounding over thousands of
updates. So the reference checks the start from scratch, and follows the
window step by step from the program's own state:

- the start: the reference replays the records itself (its own grouping,
  static initialization, propagation, warm-up map) up to and including
  the first LIO update, and compares it with the program's; the VIO
  update after it is followed as in the window;
- the window: at a few LIO updates drawn from the seed the harness keeps
  the program's state before the update (filter state, voxel map, visual
  map), after it (state, map) and after the next VIO update (state,
  visual map). The reference builds those groups from the records itself
  and runs its own LIO update from the kept state before it, and its own
  VIO update from the program's state after the LIO update, on its own
  scan cloud.

Numbers compared, each the largest over the checked updates:

- `lio_pos_gap_m`, `lio_rot_gap_rad`: the LIO posterior's position and
  attitude against the reference's;
- `map_gap_m`: the points the update added to the voxel map against the
  reference's scan placed by its posterior: the 90th percentile, over the
  added points, of the distance to the nearest reference point (one side
  adding points and the other none reads infinite);
- `vio_pos_gap_m`, `vio_rot_gap_rad`: the VIO posterior (cells with a
  camera);
- `patch_gap`: the observation patches the VIO update wrote into the
  visual map (the `patch_sample` kernel's values) against the reference's
  samples of the frame at the point's projection from the reference's
  posterior: the 90th percentile over the written slots of the largest
  texel difference (intensity units).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from livobench.reference import lio as rlio
from livobench.reference import records, vio as rvio
from livobench.reference.arith import Arith
from livobench.reference.camera import Pinhole

LIO_NUMBERS = ("lio_pos_gap_m", "lio_rot_gap_rad", "map_gap_m")
VIO_NUMBERS = ("vio_pos_gap_m", "vio_rot_gap_rad", "patch_gap")

# The program's state as it is kept: a NavState (rot, pos, vel, bg, ba,
# grav, cov); the voxel arena (meta rows [kx, ky, kz, stamp, n, s1x, s1y,
# s1z] per slot, an empty slot's kx = ARENA_EMPTY; counts; slab (slots, 3
# cap); slab_stamps, the insert epoch of each point; surf_s2; epoch); the
# visual map (pos, score, active, cursor, obs_patch, obs_px, obs_rcw,
# obs_pcw, obs_valid, obs_cursor).
ARENA_EMPTY = float(1 << 26)
VMAP_FIELDS = ("pos", "score", "active", "cursor", "obs_patch", "obs_px", "obs_rcw", "obs_pcw",
               "obs_valid", "obs_cursor")


def clone(tup):
    """A copy in host memory of a tuple of tensors, so that the kept
    states do not count in the card's memory peak."""
    return tuple(x.detach().to("cpu", copy=True) for x in tup)


@dataclass
class Kept:
    """The program's states around one checked cycle. `group` is the
    ordinal, from the first record on, of the LIO group; the VIO group,
    when there is one, is the next."""

    group: int
    pre_state: tuple = None
    pre_map: tuple = None
    pre_vmap: tuple = None
    lio_state: tuple = None
    lio_map: tuple = None
    vio_state: tuple = None
    vio_vmap: tuple = None
    lio_trips: tuple = None  # (ESKF trips, points in the last trip's residuals), as the program reports them


@dataclass
class Keeper:
    """Keeps the program's states: the start (its first LIO and VIO
    updates) and the window's checked cycles, chosen as the first LIO
    update at or after each of `at_s` seconds into the window."""

    at_s: List[float]
    camera: bool
    start: Optional[Kept] = None
    cycles: List[Kept] = field(default_factory=list)
    open: Optional[Kept] = None  # a LIO update kept before, not yet after
    _want_vio: Optional[Kept] = None

    def due(self, window_t: float) -> bool:
        return len(self.cycles) < len(self.at_s) and window_t >= self.at_s[len(self.cycles)]

    def before_lio(self, pipe, group: int):
        """Keep the state before the window's LIO update of `group`."""
        k = Kept(group=group, pre_state=clone(pipe.state), pre_map=clone(pipe.map))
        if self.camera:
            k.pre_vmap = clone(pipe.visual_map)
        self.open = k
        self.cycles.append(k)

    def first_lio(self, pipe, group: int, info):
        """Keep the state after the program's first LIO update, `group`."""
        self.open = self.start = Kept(group=group)
        self.after_lio(pipe, info)

    def after_lio(self, pipe, info):
        """`info` is what the update returned (its LioInfo)."""
        k, self.open = self.open, None
        k.lio_state, k.lio_map = clone(pipe.state), clone(pipe.map)
        k.lio_trips = (int(info.iterations), int(info.n_effective))
        self._want_vio = k if self.camera else None

    def wants_vio(self, group: int) -> bool:
        return self._want_vio is not None and group == self._want_vio.group + 1

    def after_vio(self, pipe):
        k, self._want_vio = self._want_vio, None
        k.vio_state, k.vio_vmap = clone(pipe.state), clone(pipe.visual_map)

    def drop_vio(self):
        """The group after a kept LIO update was not an image group."""
        self._want_vio = None


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


def vmap_of(v: tuple, ar: Arith, device) -> dict:
    return {k: (x.to(device, ar.dtype) if x.is_floating_point() else x.to(device))
            for k, x in zip(VMAP_FIELDS, v)}


def written(pre: Optional[tuple], post: tuple):
    """(point, slot) indices of the observation slots the update wrote."""
    p = dict(zip(VMAP_FIELDS, post))
    if pre is None:
        mask = p["obs_valid"]
    else:
        b = dict(zip(VMAP_FIELDS, pre))
        mask = ((p["obs_valid"] != b["obs_valid"]) | (p["obs_patch"] != b["obs_patch"]).any(-1)
                | (p["obs_px"] != b["obs_px"]).any(-1))
    return torch.nonzero(mask, as_tuple=True)


def program_outputs(keeper: Keeper) -> Dict[tuple, dict]:
    """The program's answers at the checked updates, keyed as the
    reference's are."""
    out = {}

    def pose(st):
        return {"rot": st[0].double(), "pos": st[1].double()}

    def lio(k):
        return {**pose(k.lio_state), "group": k.group, "pts": arena_added(k.lio_map).double(),
                "trips": k.lio_trips}

    def vio(k, pre):
        i, j = written(pre, k.vio_vmap)
        return {**pose(k.vio_state), "group": k.group + 1,
                "patches": k.vio_vmap[VMAP_FIELDS.index("obs_patch")][i, j].double()}

    s = keeper.start
    out[("lio", "start")] = lio(s)
    if s.vio_state is not None:
        out[("vio", "start")] = vio(s, None)
    for k in keeper.cycles:
        if k.lio_state is None:
            continue
        out[("lio", k.group)] = lio(k)
        if k.vio_state is not None:
            out[("vio", k.group)] = vio(k, k.pre_vmap)
    return out


# ---------------------------------------------------------------------------
# The reference's answers.
# ---------------------------------------------------------------------------


class Rig:
    def __init__(self, p, ar: Arith, device):
        r_il = np.asarray(p.extrinsics.extrinsic_r, np.float64).reshape(3, 3)
        t_il = np.asarray(p.extrinsics.extrinsic_t, np.float64)
        self.r_il, self.t_il = ar.t(r_il, device), ar.t(t_il, device)
        self.cam = Pinhole.from_params(p.camera) if p.vio.img_enable else None
        if self.cam is not None:
            r_cl = np.asarray(p.camera.rcl, np.float64).reshape(3, 3)
            r_ci = r_cl @ r_il.T
            self.r_ci = ar.t(r_ci, device)
            self.t_ci = ar.t(np.asarray(p.camera.pcl, np.float64) - r_ci @ t_il, device)


def reference_outputs(p, pool, keeper: Keeper, device, ar: Arith = None) -> Dict[tuple, dict]:
    """The reference's answers at the updates the keeper holds: the start
    replayed from scratch, the window's from the program's kept states."""
    ar = ar or Arith()
    dev = torch.device(device)
    rig = Rig(p, ar, dev)
    lp, mp, vp = p.lio, p.map, p.vio
    init = records.StaticInit(p.imu.init_count, p.imu.zero_velocity_thresh)
    by_group = {k.group: k for k in keeper.cycles if k.lio_state is not None}
    last = max([g + 1 for g in by_group] + [keeper.start.group + 1])
    out: Dict[tuple, dict] = {}
    state, scale, first_t = None, 1.0, None
    pmap = rlio.PointMap.empty(mp.resolution, mp.max_points_per_voxel, ar, dev)
    phase = "start"  # then "start_vio", "follow"
    clouds = {}  # LIO group -> (LiDAR-frame points, accepted), for the VIO after it

    def lio_step(prior_state, pmap_in, g):
        prior, tr = rlio.propagate(ar, prior_state, g, scale, p.imu)
        pts = rlio.undistort(ar, ar.t(g.pts, dev), ar.t(g.pt_t, dev), tr, prior, rig.r_il, rig.t_il)
        ds = rlio.downsample(pts, lp.filter_size_surf, lp.max_points)
        post, accept, nb, nv, trips = rlio.update(ar, prior, ds, pmap_in, rig.r_il, rig.t_il, p)
        p_w = rlio.world_points(ar, ds, post, rig.r_il, rig.t_il)
        add = rlio.insert_gate(p_w, nb, nv, lp.filter_size_map) & accept
        went = pmap_in.insert(p_w, add)
        return post, ds, accept, p_w[went], trips, p_w

    def vio_step(prior_state, vmap, cloud, g, kept_post, kept_pre):
        prior, _ = rlio.propagate(ar, prior_state, g, scale, p.imu)
        img = ar.t(np.asarray(g.img, np.float64), dev)
        pyr = rvio.pyramid(img, max(vp.pyr_levels, vp.stored_levels))
        sel = rvio.select(ar, prior, vmap, img, pyr, cloud, rig.cam, rig.r_ci, rig.t_ci, vp)
        post = rvio.update(ar, prior, sel, pyr, rig.cam, rig.r_ci, rig.t_ci, vp)
        i, j = written(kept_pre, kept_post)
        pos = ar.t(kept_post[0][i], dev)
        rcw, pcw = rvio.camera_pose(ar, post, rig.r_ci, rig.t_ci)
        px = rig.cam.project(ar.mm(pos, rcw.T) + pcw)
        patches = rvio.stored_patches(pyr, px, vp.stored_patch, vp.stored_levels, ar)
        return {"rot": post.rot.double(), "pos": post.pos.double(), "patches": patches.double().cpu()}

    def vio_after(k: Kept, key, vmap, pre, g):
        """The VIO update after the kept LIO update, from the program's
        posterior, on the reference's own scan points placed by it."""
        ds, accept = clouds.pop(key)
        lio_post = rlio.state_of(k.lio_state, ar, dev)
        cloud = rlio.world_points(ar, ds, lio_post, rig.r_il, rig.t_il) if accept else ds[:0]
        return vio_step(lio_post, vmap_of(vmap, ar, dev), cloud, g, k.vio_vmap, pre)

    for gi, g in enumerate(records.groups(pool.stream(), p)):
        if gi > last:
            break
        if not init.done:
            if init.push(g):
                z = np.zeros(3)
                state = rlio.state_of((np.eye(3), z, z, init.mean_gyr, z, init.gravity, 1e-3 * np.eye(18)), ar, dev)
                scale = float(np.float32(init.acc_scale))
            continue
        if phase == "start":
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
            state, ds, accept, added, trips, cand = lio_step(state, pmap, g)
            out[("lio", "start")] = {"rot": state.rot.double(), "pos": state.pos.double(), "group": gi,
                                     "pts": added.double().cpu(), "trips": trips, "cloud": cand.double().cpu()}
            clouds["start"] = (ds, accept)
            phase = "start_vio" if rig.cam is not None and keeper.start.vio_state is not None else "follow"
            continue
        if phase == "start_vio":  # the VIO update after it, from the program's state (as below)
            phase = "follow"
            if not g.lidar_end:
                empty = tuple(torch.zeros_like(x) for x in keeper.start.vio_vmap)
                out[("vio", "start")] = {**vio_after(keeper.start, "start", empty, None, g), "group": gi}
                continue
        if g.lidar_end and gi in by_group:
            k = by_group[gi]
            pre = rlio.state_of(k.pre_state, ar, dev)
            post, ds, accept, added, trips, cand = lio_step(pre, arena_map(k.pre_map, mp.resolution, ar, dev), g)
            out[("lio", gi)] = {"rot": post.rot.double(), "pos": post.pos.double(), "group": gi,
                                "pts": added.double().cpu(), "trips": trips, "cloud": cand.double().cpu()}
            clouds[gi] = (ds, accept)
        elif not g.lidar_end and gi - 1 in clouds and by_group[gi - 1].vio_state is not None:
            k = by_group[gi - 1]
            out[("vio", gi - 1)] = {**vio_after(k, gi - 1, k.pre_vmap, k.pre_vmap, g), "group": gi}
    return out


# ---------------------------------------------------------------------------
# Gaps.
# ---------------------------------------------------------------------------


def _quantile(values: torch.Tensor, q: float) -> float:
    if values.numel() == 0:
        return 0.0
    v = torch.sort(values.flatten().double().cpu()).values
    return float(v[max(int(math.ceil(q * v.numel())) - 1, 0)])


def pose_gaps(a: dict, b: dict):
    """(|position gap| m, attitude gap rad)."""
    dp = float(torch.linalg.vector_norm(a["pos"].cpu() - b["pos"].cpu()))
    m = a["rot"].cpu().T @ b["rot"].cpu()
    w = 0.5 * torch.stack([m[2, 1] - m[1, 2], m[0, 2] - m[2, 0], m[1, 0] - m[0, 1]])
    return dp, abs(math.atan2(float(torch.linalg.vector_norm(w)), 0.5 * (float(torch.trace(m)) - 1.0)))


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
    return _quantile(_nearest(added, candidates), q)


def patch_gap(a: torch.Tensor, b: torch.Tensor, q: float = 0.9) -> float:
    """The q-th quantile over the slots of the largest texel difference."""
    if a.shape[0] == 0:
        return 0.0
    d = torch.nan_to_num((a.cpu() - b.cpu()).abs(), nan=math.inf)
    return _quantile(d.amax(-1), q)


def gaps(got: Dict[tuple, dict], want: Dict[tuple, dict], camera: bool, log=None) -> Dict[str, float]:
    """Each number compared: the largest over the checked updates of the
    gap between `got` (the program's answers, or the control's) and
    `want` (the reference's). An update one side ran and the other did
    not, or ran at another group, is infinitely far."""
    names = LIO_NUMBERS + (VIO_NUMBERS if camera else ())
    out = {n: 0.0 for n in names}
    for key in sorted(set(got) | set(want), key=str):
        kind = LIO_NUMBERS if key[0] == "lio" else VIO_NUMBERS
        a, b = got.get(key), want.get(key)
        if a is None or b is None or a["group"] != b["group"]:
            vals = (math.inf,) * 3
        elif key[0] == "lio":
            vals = (*pose_gaps(a, b), placement_gap(a["pts"], b["cloud"] if b["pts"].shape[0] else b["pts"]))
        else:
            vals = (*pose_gaps(a, b), patch_gap(a["patches"], b["patches"]))
        for n, v in zip(kind, vals):
            if n in out:
                out[n] = max(out[n], v)
        if log is not None:
            extra = ""
            if key[0] == "lio" and a is not None and b is not None:
                extra = (f"; trips and residual points {a.get('trips')} against {b.get('trips')}, "
                         f"points added {a['pts'].shape[0]} against {b['pts'].shape[0]}")
            log(f"check {key[0]} update at group {(a or b)['group']} ({key[1]}): "
                + ", ".join(f"{n} {v:.3e}" for n, v in zip(kind, vals)) + extra)
    return out


def tf32_arith() -> Arith:
    """TF32 matmuls: the control of a float32 configuration (TF32 off)."""
    return Arith(torch.float32, tf32=True)


def reference_gaps(p, pool, keeper: Keeper, device, log=None) -> Dict[str, float]:
    """The numbers compared: the program's answers against the reference's."""
    want = reference_outputs(p, pool, keeper, device)
    return gaps(program_outputs(keeper), want, bool(p.vio.img_enable), log)


def judge(gaps: Dict[str, float], limits: Dict[str, float]):
    """(correct, lines): every number that has a limit at or under it; one
    line per number compared, `name value limit`. A number without a limit
    is read and not compared (PERF.md says why for each)."""
    lines, ok = [], True
    for name, value in gaps.items():
        if name not in limits:
            continue
        lim = limits[name]
        good = value <= lim
        ok &= good
        lines.append((name, value, lim, good))
    return ok, lines
