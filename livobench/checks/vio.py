"""The VIO check: the port's photometric VIO update after each of the LIO
check's updates held to the plain reference (`livobench/reference/vio.py`,
float64). It reads the replay of the LIO updates (`check.Shared.replay`)
that the `lio` check gives.

After the program's first LIO update, and after each of the window's
checked LIO updates, the keeper holds the program's posterior of that
update, the visual map before the VIO update that comes next, and the
state and visual map after it. The reference runs its own VIO update
from the program's posterior of the LIO update, on its own scan cloud of
that update (the replay's) placed by that posterior.

Numbers, each the largest over the checked updates:

- `vio_pos_gap_m`, `vio_rot_gap_rad`: the VIO posterior's position and
  attitude against the reference's;
- `patch_gap`: the observation patches the VIO update wrote into the
  visual map (the `patch_sample` kernel's values) against the reference's
  samples of the frame at the point's projection from the reference's
  posterior: the 90th percentile over the written slots of the largest
  texel difference (intensity units);

and the same three as the median over the checked updates (`..._median`).
Both are compared: the largest sees a fault confined to one update (the
start's, on an empty visual map, or one frame's), the median a small
departure on every update. The choice of the points an update follows
(`select`: depth image, cells, view, warp level) is a cascade of discrete
gates, so the largest swings by its nature: where a point sits on a
gate's edge, one update reads some tens of times the others, and the
reference computed in float32 departs there too (PERF.md).
"""

from __future__ import annotations

import math
import statistics
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from livobench.check import clone, compare, largest, pose_gaps, quantile, sound
from livobench.reference import lio as rlio
from livobench.reference import vio as rvio
from livobench.reference.arith import Arith
from livobench.reference.camera import Pinhole

NUMBERS = ("vio_pos_gap_m", "vio_rot_gap_rad", "patch_gap",
           "vio_pos_gap_m_median", "vio_rot_gap_rad_median", "patch_gap_median")
HOLDS = ("vio",)
READS_REPLAY = True

# The visual map as the program keeps it.
VMAP_FIELDS = ("pos", "score", "active", "cursor", "obs_patch", "obs_px", "obs_rcw", "obs_pcw",
               "obs_valid", "obs_cursor")


@dataclass
class Kept:
    """Around the VIO update after one kept LIO update: the program's
    posterior of the LIO update, the visual map before the VIO update
    (None at the start: the map is empty), and the state and visual map
    after it."""

    lio_state: tuple = None
    pre_vmap: tuple = None
    vio_state: tuple = None
    vio_vmap: tuple = None


class Keeper:
    """What each kept LIO update's VIO update needs, by the LIO group."""

    def __init__(self, tree: dict):
        self.kept: Dict[int, Kept] = {}

    def first_lio(self, pipe, group: int, info):
        self.kept[group] = Kept(lio_state=clone(pipe.state))

    def before_lio(self, pipe, group: int):
        self.kept[group] = Kept(pre_vmap=clone(pipe.visual_map))

    def after_lio(self, pipe, group: int, info):
        self.kept[group].lio_state = clone(pipe.state)

    def after_vio(self, pipe, group: int):
        k = self.kept[group]
        k.vio_state, k.vio_vmap = clone(pipe.state), clone(pipe.visual_map)


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


def _checked(kept: Keeper, shared):
    """(key, group, kept) of every VIO update that ran after the program's
    first LIO update or a checked one, the key "start" or the group."""
    out = []
    for g in [shared.start] + list(shared.cycles):
        k = kept.kept.get(g)
        if k is not None and k.lio_state is not None and k.vio_state is not None:
            out.append(("start" if g == shared.start else g, g, k))
    return out


def program_outputs(kept: Keeper, shared) -> Dict[tuple, dict]:
    out = {}
    for key, g, v in _checked(kept, shared):
        i, j = written(v.pre_vmap, v.vio_vmap)
        out[("vio", key)] = {"rot": v.vio_state[0].double(), "pos": v.vio_state[1].double(), "group": g + 1,
                             "patches": v.vio_vmap[VMAP_FIELDS.index("obs_patch")][i, j].double()}
    return out


class CameraRig:
    """The camera's pose in the IMU frame (p_c = R_ci p_imu + t_ci) and its
    pinhole model."""

    def __init__(self, p, ar: Arith, device):
        r_il = np.asarray(p.extrinsics.extrinsic_r, np.float64).reshape(3, 3)
        t_il = np.asarray(p.extrinsics.extrinsic_t, np.float64)
        self.r_il, self.t_il = ar.t(r_il, device), ar.t(t_il, device)
        self.cam = Pinhole.from_params(p.camera)
        r_ci = np.asarray(p.camera.rcl, np.float64).reshape(3, 3) @ r_il.T
        self.r_ci = ar.t(r_ci, device)
        self.t_ci = ar.t(np.asarray(p.camera.pcl, np.float64) - r_ci @ t_il, device)


def reference_outputs(p, pool, kept: Keeper, shared, device, ar: Arith) -> Dict[tuple, dict]:
    """The reference's VIO update after each checked LIO update, from the
    program's posterior of it, on the reference's own scan points of it
    placed by that posterior."""
    dev = torch.device(device)
    rig = CameraRig(p, ar, dev)
    vp = p.vio
    followed = shared.replay(ar)
    out = {}
    for key, g, v in _checked(kept, shared):
        scan = followed.scans.get(g)
        if scan is None or scan.next_group is None:
            continue
        g = scan.next_group
        lio_post = rlio.state_of(v.lio_state, ar, dev)
        cloud = rlio.world_points(ar, scan.ds, lio_post, rig.r_il, rig.t_il) if scan.accept else scan.ds[:0]
        vmap = v.pre_vmap if v.pre_vmap is not None else tuple(torch.zeros_like(x) for x in v.vio_vmap)
        prior, _ = rlio.propagate(ar, lio_post, g, followed.scale, p.imu)
        img = ar.t(np.asarray(g.img, np.float64), dev)
        pyr = rvio.pyramid(img, max(vp.pyr_levels, vp.stored_levels))
        vm = {n: (x.to(dev, ar.dtype) if x.is_floating_point() else x.to(dev)) for n, x in zip(VMAP_FIELDS, vmap)}
        sel = rvio.select(ar, prior, vm, img, pyr, cloud, rig.cam, rig.r_ci, rig.t_ci, vp)
        post = rvio.update(ar, prior, sel, pyr, rig.cam, rig.r_ci, rig.t_ci, vp)
        i, j = written(v.pre_vmap, v.vio_vmap)
        pos = ar.t(v.vio_vmap[0][i], dev)
        rcw, pcw = rvio.camera_pose(ar, post, rig.r_ci, rig.t_ci)
        px = rig.cam.project(ar.mm(pos, rcw.T) + pcw)
        patches = rvio.stored_patches(pyr, px, vp.stored_patch, vp.stored_levels, ar)
        out[("vio", key)] = {"rot": post.rot.double(), "pos": post.pos.double(), "group": scan.next_index,
                             "patches": patches.double().cpu()}
    return out


def patch_gap(a: torch.Tensor, b: torch.Tensor, q: float = 0.9) -> float:
    """The q-th quantile over the slots of the largest texel difference."""
    if a.shape[0] == 0:
        return 0.0
    d = torch.nan_to_num((a.cpu() - b.cpu()).abs(), nan=math.inf)
    return quantile(d.amax(-1), q)


def gaps(rcfg, tree, pool, kept: Keeper, device, arith: Arith, log, shared) -> Dict[str, float]:
    want = reference_outputs(rcfg, pool, kept, shared, device, Arith())
    got = program_outputs(kept, shared) if sound(arith) else reference_outputs(rcfg, pool, kept, shared, device, arith)
    per_update = compare(got, want, "vio", NUMBERS[:3],
                         lambda a, b: (*pose_gaps(a, b), patch_gap(a["patches"], b["patches"])), log)
    return {**largest(per_update),
            **{f"{n}_median": statistics.median(v) if v else 0.0 for n, v in per_update.items()}}
