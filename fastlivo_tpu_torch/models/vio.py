"""VIO: direct sparse photometric iterated error-state Kalman update (port
of fastlivo_tpu/models/vio.py: select, photometric_update, maintain and
vio_update; `candidate_overlay` is not ported yet).

Every patch read goes through `ops.image.strided_patch_sample`, whose
window extraction is the CUDA kernel on the GPU (csrc/extract_windows.cu):
one launch in `select`, one per update iteration (at most 3 levels x 10)
and six in `maintain`. The per-level `lax.while_loop` becomes a Python
loop that reads its `done` flag from the device once per trip.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from fastlivo_tpu_torch.maps import visual_map as vmap_mod
from fastlivo_tpu_torch.models import ieskf
from fastlivo_tpu_torch.ops import image as img_ops
from fastlivo_tpu_torch.ops import linalg, so3
from fastlivo_tpu_torch.ops import scatter as scatter_ops
from fastlivo_tpu_torch.ops.camera import Pinhole
from fastlivo_tpu_torch.state import DIM_STATE, NavState, boxminus, boxplus

_R2D = 57.29577951308232
# Padding for window-based patch sampling (see the JAX module: windows are
# sized for stride 4 but anchored with each candidate's own stride).
_SAMPLE_PAD = 32


def _pyramid_padded(img: torch.Tensor, levels: int):
    return [img_ops.pad_image(p, _SAMPLE_PAD) for p in img_ops.build_pyramid(img, levels)]


def stored_patch_pyramid(
    img: torch.Tensor, px: torch.Tensor, vm_cfg: vmap_mod.VisualMapConfig
) -> torch.Tensor:
    """Stored observation patches: the central stored_patch^2 texels of
    each pyramid level at px. Returns (N, levels, S, S)."""
    pyr = _pyramid_padded(img, vm_cfg.levels)
    n = px.shape[0]
    ones = torch.ones(n, dtype=torch.int32, device=px.device)
    out = []
    for lvl in range(vm_cfg.levels):
        c = px / (1 << lvl)
        out.append(
            img_ops.strided_patch_sample(
                pyr[lvl], c, ones, vm_cfg.stored_patch, _SAMPLE_PAD, stride_set=(1,)
            )
        )
    return torch.stack(out, dim=1).reshape(n, vm_cfg.levels, vm_cfg.stored_patch, vm_cfg.stored_patch)


@dataclass(frozen=True)
class VioConfig:
    grid_size: int = 40
    patch_size: int = 8
    max_iterations: int = 10
    outlier_threshold: float = 300.0
    img_point_cov: float = 100.0
    depth_continuous_thresh: float = 1.5
    converge_rot_deg: float = 0.001
    converge_trans_cm: float = 0.001
    ncc_en: bool = False
    ncc_thre: float = 0.0
    levels: int = 3
    border_px: int = 40
    exposure_en: bool = True

    def grid_dims(self, cam: Pinhole) -> Tuple[int, int]:
        return (
            (cam.width + self.grid_size - 1) // self.grid_size,
            (cam.height + self.grid_size - 1) // self.grid_size,
        )


class VioInfo(NamedTuple):
    n_selected: torch.Tensor
    error_before: torch.Tensor
    error_after: torch.Tensor
    n_new_points: torch.Tensor
    n_new_obs: torch.Tensor


class Selection(NamedTuple):
    valid: torch.Tensor  # (G,)
    pt_idx: torch.Tensor  # (G,)
    pt_pos: torch.Tensor  # (G, 3)
    ref_patch: torch.Tensor  # (G, L, 64)
    search_level: torch.Tensor  # (G,) int32
    scale: torch.Tensor  # (G,)
    cell_score: torch.Tensor  # (n_cells,)


def camera_pose(state_rot, state_pos, rot_ci, t_ci):
    """World->camera from the IMU state: p_c = Rcw p_w + Pcw."""
    rcw = rot_ci @ state_rot.T
    pcw = -rcw @ state_pos + t_ci
    return rcw, pcw


def build_depth_image(cam: Pinhole, rcw, pcw, pts_world, mask) -> torch.Tensor:
    """Scatter-min depth buffer from the scan cloud (exact f32 min through
    the int32 key encoding)."""
    p_c = pts_world @ rcw.T + pcw
    z = p_c[..., 2]
    uv = cam.project(p_c)
    ok = mask & (z > 0) & cam.in_frame(uv, border=1)
    col = torch.clamp(uv[..., 0].to(torch.int32), 0, cam.width - 1)
    row = torch.clamp(uv[..., 1].to(torch.int32), 0, cam.height - 1)
    flat = torch.where(ok, row * cam.width + col, cam.width * cam.height)
    depth = scatter_ops.scatter_min_f32(
        cam.height * cam.width, flat, torch.where(ok, z, torch.inf)
    )
    depth = torch.where(torch.isfinite(depth), depth, 0.0)
    return depth.reshape(cam.height, cam.width)


def _pool2d(img: torch.Tensor, half: int, mode: str) -> torch.Tensor:
    """(2*half+1)^2 window max or min with SAME padding (exact)."""
    k = 2 * half + 1
    x = img if mode == "max" else -img
    x = F.max_pool2d(x[None, None], (1, k), stride=1, padding=(0, half))
    x = F.max_pool2d(x, (k, 1), stride=1, padding=(half, 0))[0, 0]
    return x if mode == "max" else -x


def _depth_window_gate(depth_img, uv, z, thresh: float, half: int = 4) -> torch.Tensor:
    """Visibility gate over the depth-image window around each candidate:
    at least one return there and none conflicting (|z - d| > thresh)."""
    h, w = depth_img.shape
    pos = depth_img > 0
    big = torch.finfo(depth_img.dtype).max
    dmax = _pool2d(torch.where(pos, depth_img, -big), half, "max")
    dmin = _pool2d(torch.where(pos, depth_img, big), half, "min")
    cols = torch.clamp(uv[:, 0].to(torch.int64), 0, w - 1)
    rows = torch.clamp(uv[:, 1].to(torch.int64), 0, h - 1)
    mx = dmax[rows, cols]
    mn = dmin[rows, cols]
    return (mx > 0) & (mx <= z + thresh) & (mn >= z - thresh)


def _cell_argmin(values: torch.Tensor, cells: torch.Tensor, n_cells: int):
    """Per-cell argmin (lowest index among ties). Returns (winner_idx (C,),
    has_winner (C,)); `cells` is n_cells for masked-out entries."""
    big = torch.finfo(values.dtype).max
    cmin = scatter_ops.scatter_min_f32(n_cells + 1, cells, values, fill=big)
    is_min = values <= cmin[cells.long()]
    n = values.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=values.device)
    init = torch.full((n_cells + 1,), n, dtype=torch.int32, device=values.device)
    winner = scatter_ops.reduce_drop(init, torch.where(is_min, cells, n_cells), idx, "amin")
    has = winner[:n_cells] < n
    return torch.clamp(winner[:n_cells], 0, n - 1), has


def select(
    state: NavState,
    vmap: vmap_mod.VisualMap,
    img: torch.Tensor,
    scan_world: torch.Tensor,
    scan_mask: torch.Tensor,
    cam: Pinhole,
    rot_ci: torch.Tensor,
    t_ci: torch.Tensor,
    vm_cfg: vmap_mod.VisualMapConfig,
    cfg: VioConfig,
) -> Tuple[Selection, torch.Tensor]:
    """Phase A: one candidate per grid cell. Returns (Selection, depth_img)."""
    dtype = img.dtype
    dev = img.device
    gw, gh = cfg.grid_dims(cam)
    n_cells = gw * gh
    rcw, pcw = camera_pose(state.rot, state.pos, rot_ci, t_ci)
    cam_pos = -rcw.T @ pcw

    depth_img = build_depth_image(cam, rcw, pcw, scan_world, scan_mask)

    p_c = vmap.pos @ rcw.T + pcw
    z = p_c[..., 2]
    uv = cam.project(p_c)
    in_frame = cam.in_frame(uv, border=cfg.border_px)
    cand = vmap.active & (z > 0) & in_frame
    cand = cand & _depth_window_gate(depth_img, uv, z, cfg.depth_continuous_thresh)

    cells = (uv[..., 0] / cfg.grid_size).to(torch.int32) * gh + (
        uv[..., 1] / cfg.grid_size
    ).to(torch.int32)
    cells = torch.clamp(cells, 0, n_cells - 1)
    cell_of = torch.where(cand, cells, n_cells)

    vis = vmap.active & (z > 0) & in_frame
    score_src = torch.where(vis, vmap.score, -1.0)
    cell_score = scatter_ops.reduce_drop(
        torch.zeros((n_cells + 1,), dtype=dtype, device=dev),
        torch.where(vis, cells, n_cells), score_src, "amax",
    )[:n_cells]

    dist = torch.linalg.vector_norm(vmap.pos - cam_pos, dim=-1)
    dist = torch.where(cand, dist, torch.finfo(dtype).max)
    winner, has = _cell_argmin(dist, cell_of, n_cells)

    pt_idx = winner
    pidx = pt_idx.long()
    pt_pos = vmap.pos[pidx]
    sel_uv = uv[pidx]

    obs_k, view_ok = vmap_mod.closest_view_obs(vmap, pt_idx, cam_pos)
    valid = has & view_ok

    g = pt_idx.shape[0]
    gi = torch.arange(g, device=dev)
    ref_px = vmap.obs_px[pidx, obs_k]
    ref_rcw = vmap.obs_rcw[pidx, obs_k]
    ref_pcw = vmap.obs_pcw[pidx, obs_k]
    ref_cam_pos = vmap_mod.obs_cam_pos(ref_rcw, ref_pcw)
    s_st = vm_cfg.stored_patch
    ref_patches = vmap.obs_patch[pidx, obs_k].reshape(-1, vm_cfg.levels, s_st, s_st)

    # --- affine warp A_cur_ref.
    half = cfg.patch_size // 2
    depth_ref = torch.linalg.vector_norm(ref_cam_pos - pt_pos, dim=-1)
    f_ref = cam.unproject(ref_px)
    xyz_ref = f_ref * depth_ref[:, None]
    du_px = ref_px + torch.tensor([half, 0.0], dtype=dtype, device=dev)
    dv_px = ref_px + torch.tensor([0.0, half], dtype=dtype, device=dev)
    xyz_du = cam.unproject(du_px)
    xyz_dv = cam.unproject(dv_px)
    xyz_du = xyz_du * (xyz_ref[:, 2:3] / torch.clamp(xyz_du[:, 2:3], min=1e-9))
    xyz_dv = xyz_dv * (xyz_ref[:, 2:3] / torch.clamp(xyz_dv[:, 2:3], min=1e-9))

    r_cr = rcw @ ref_rcw.transpose(-1, -2)
    t_cr = pcw[None, :] - (r_cr @ ref_pcw[:, :, None])[:, :, 0]

    def to_cur_px(xyz):
        return cam.project((r_cr @ xyz[:, :, None])[:, :, 0] + t_cr)

    px_cur = to_cur_px(xyz_ref)
    a_cur_ref = torch.stack(
        [(to_cur_px(xyz_du) - px_cur) / half, (to_cur_px(xyz_dv) - px_cur) / half], dim=-1
    )

    det = a_cur_ref[:, 0, 0] * a_cur_ref[:, 1, 1] - a_cur_ref[:, 0, 1] * a_cur_ref[:, 1, 0]
    search_level = (det > 3.0).to(torch.int32) + (det > 12.0).to(torch.int32)
    scale = torch.exp2(search_level.to(dtype))
    valid = valid & (torch.abs(det) > 1e-6)

    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-6, det, 1.0)
    a_ref_cur = (
        torch.stack(
            [
                torch.stack([a_cur_ref[:, 1, 1], -a_cur_ref[:, 0, 1]], dim=-1),
                torch.stack([-a_cur_ref[:, 1, 0], a_cur_ref[:, 0, 0]], dim=-1),
            ],
            dim=-2,
        )
        * inv_det[:, None, None]
    )

    # --- warp the stored reference patch to the current view.
    grid = img_ops.patch_grid(cfg.patch_size, dtype, dev)
    px_patch = grid[None, :, :] * scale[:, None, None]
    ref_off = px_patch @ a_ref_cur.transpose(-1, -2)  # einsum nij,nkj->nki
    center = vm_cfg.stored_patch // 2
    lvl_patches = ref_patches[gi, torch.clamp(search_level, 0, vm_cfg.levels - 1).long()]
    coords = ref_off / scale[:, None, None] + center
    warped = img_ops.sample_patch_grid(lvl_patches, coords)

    r8 = torch.arange(cfg.patch_size, device=dev) - half + center
    refs = [warped]
    for lvl in range(1, cfg.levels):
        refs.append(ref_patches[:, lvl][:, r8[:, None], r8[None, :]].reshape(g, -1))
    ref_patch = torch.stack(refs, dim=1)

    # --- photometric outlier gate at the search-level stride.
    img_pad = img_ops.pad_image(img, _SAMPLE_PAD)
    cur_patch = img_ops.strided_patch_sample(
        img_pad, sel_uv, torch.round(scale).to(torch.int32), cfg.patch_size, _SAMPLE_PAD
    )
    if cfg.exposure_en:
        wsel = valid.to(dtype)[:, None] * torch.ones_like(cur_patch)
        n_w = torch.clamp(torch.sum(wsel), min=1.0)
        mv = torch.sum(cur_patch * wsel) / n_w
        mr = torch.sum(warped * wsel) / n_w
        cov_vr = torch.sum((cur_patch - mv) * (warped - mr) * wsel) / n_w
        var_v = torch.sum((cur_patch - mv) ** 2 * wsel) / n_w
        a_exp = torch.clamp(cov_vr / torch.clamp(var_v, min=1e-6), 0.5, 2.0)
        cur_patch = a_exp * cur_patch + (mr - a_exp * mv)
    err = torch.sum((warped - cur_patch) ** 2, dim=-1)
    valid = valid & (err <= cfg.outlier_threshold * cfg.patch_size**2)
    if cfg.ncc_en:
        wm = warped - warped.mean(dim=-1, keepdim=True)
        cm = cur_patch - cur_patch.mean(dim=-1, keepdim=True)
        ncc = torch.sum(wm * cm, dim=-1) / torch.sqrt(
            torch.sum(wm * wm, -1) * torch.sum(cm * cm, -1) + 1e-10
        )
        valid = valid & (ncc >= cfg.ncc_thre)

    sel = Selection(
        valid=valid,
        pt_idx=pt_idx,
        pt_pos=pt_pos,
        ref_patch=torch.where(valid[:, None, None], ref_patch, 0.0),
        search_level=search_level,
        scale=scale,
        cell_score=cell_score,
    )
    return sel, depth_img


def photometric_update(
    state_prop: NavState,
    sel: Selection,
    img: torch.Tensor,
    cam: Pinhole,
    rot_ci: torch.Tensor,
    t_ci: torch.Tensor,
    cfg: VioConfig,
) -> Tuple[NavState, torch.Tensor, torch.Tensor]:
    """Phase B: coarse-to-fine iterated EKF with error-decrease acceptance
    and rollback. Returns (posterior, error_before, error_after)."""
    dtype = img.dtype
    dev = img.device
    p_inv = linalg.psd_inverse(state_prop.cov / cfg.img_point_cov)
    psz2 = cfg.patch_size**2
    pyr = _pyramid_padded(img, cfg.levels)
    strides_i = torch.round(sel.scale).to(torch.int32)

    def residuals_and_h(rot, pos, level):
        rcw, pcw = camera_pose(rot, pos, rot_ci, t_ci)
        p_i = (sel.pt_pos - pos) @ rot
        p_c = sel.pt_pos @ rcw.T + pcw
        z_ok = p_c[..., 2] > 1e-3
        uv = cam.project(p_c)
        in_ok = cam.in_frame(uv, border=cfg.border_px // 2)
        valid = sel.valid & z_ok & in_ok

        val, du, dv = img_ops.strided_patch_sample(
            pyr[level], uv / (1 << level), strides_i, cfg.patch_size,
            _SAMPLE_PAD, grad_units=sel.scale * (2.0**level),
        )
        ref = sel.ref_patch[:, level, :]
        if cfg.exposure_en:
            w = valid.to(dtype)[:, None] * torch.ones_like(val)
            n_w = torch.clamp(torch.sum(w), min=1.0)
            mv = torch.sum(val * w) / n_w
            mr = torch.sum(ref * w) / n_w
            cov_vr = torch.sum((val - mv) * (ref - mr) * w) / n_w
            var_v = torch.sum((val - mv) ** 2 * w) / n_w
            a_exp = torch.clamp(cov_vr / torch.clamp(var_v, min=1e-6), 0.5, 2.0)
            b_exp = mr - a_exp * mv
            val = a_exp * val + b_exp
            du = a_exp * du
            dv = a_exp * dv
        res = val - ref

        jdpi = cam.dpi(p_c)  # (N, 2, 3)
        dpc_dth = rot_ci @ so3.hat(p_i)  # (N, 3, 3)
        dpc_dp = -(rot_ci @ rot.T)
        jimg = torch.stack([du, dv], dim=-1)  # (N, 64, 2)
        juv = jimg @ jdpi  # (N, 64, 3)
        jth = juv @ dpc_dth
        jp = juv @ dpc_dp
        h = torch.cat([jth, jp], dim=-1)

        h = torch.where(valid[:, None, None], h, 0.0)
        res = torch.where(valid[:, None], res, 0.0)
        n_meas = torch.sum(valid.to(torch.int32)) * psz2
        err = torch.sum(res * res) / torch.clamp(n_meas.to(dtype), min=1.0)
        return h.reshape(-1, 6), res.reshape(-1), err

    def run_level(state_in: NavState, g_mat_in, level):
        nav = (state_in.rot, state_in.pos, state_in.vel, state_in.bg, state_in.ba, state_in.grav)
        best = nav
        g_mat = g_mat_in
        last_error = torch.tensor(torch.inf, dtype=dtype, device=dev)
        it = 0
        while True:  # the JAX while_loop: one host read of `done` per trip
            h, res, err = residuals_and_h(nav[0], nav[1], level)
            improved = err <= last_error

            hth = torch.zeros((DIM_STATE, DIM_STATE), dtype=dtype, device=dev)
            hth[0:6, 0:6] = h.T @ h
            hty = torch.zeros((DIM_STATE,), dtype=dtype, device=dev)
            hty[0:6] = -(h.T @ res)
            cur = NavState(*nav, state_prop.cov)
            vec = boxminus(state_prop, cur)
            dx, g_new = ieskf.map_step(p_inv, hth, hty, vec)
            new = boxplus(cur, dx)
            converged = (torch.linalg.vector_norm(dx[0:3]) * _R2D < cfg.converge_rot_deg) & (
                torch.linalg.vector_norm(dx[3:6]) * 100.0 < cfg.converge_trans_cm
            )

            new_nav = (new.rot, new.pos, new.vel, new.bg, new.ba, new.grav)
            nav_next = tuple(torch.where(improved, a, b) for a, b in zip(new_nav, best))
            best = tuple(torch.where(improved, a, b) for a, b in zip(nav, best))
            nav = nav_next
            g_mat = torch.where(improved, g_new, g_mat)
            last_error = torch.where(improved, err, last_error)
            it += 1
            done = (~improved) | converged | (it >= cfg.max_iterations)
            if bool(done):
                break
        return NavState(*nav, state_prop.cov), g_mat, last_error

    state = state_prop
    g_mat = torch.zeros((DIM_STATE, DIM_STATE), dtype=dtype, device=dev)
    err_first = None
    err_last = torch.tensor(0.0, dtype=dtype, device=dev)
    for level in range(cfg.levels - 1, -1, -1):
        state, g_mat, err_last = run_level(state, g_mat, level)
        if err_first is None:
            err_first = err_last

    improved = err_last <= err_first
    cov = torch.where(improved, state_prop.cov - g_mat @ state_prop.cov, state_prop.cov)
    cov = 0.5 * (cov + cov.T)
    return state._replace(cov=cov), err_first, err_last


def maintain(
    state: NavState,
    vmap: vmap_mod.VisualMap,
    sel: Selection,
    img: torch.Tensor,
    scan_world: torch.Tensor,
    scan_mask: torch.Tensor,
    cam: Pinhole,
    rot_ci: torch.Tensor,
    t_ci: torch.Tensor,
    vm_cfg: vmap_mod.VisualMapConfig,
    cfg: VioConfig,
) -> Tuple[vmap_mod.VisualMap, torch.Tensor, torch.Tensor]:
    """Phase C: new map points (best Shi-Tomasi scan point per cell) and
    observation appends at the posterior pose. Returns (vmap, n_new, n_obs)."""
    dev = img.device
    gw, gh = cfg.grid_dims(cam)
    rcw, pcw = camera_pose(state.rot, state.pos, rot_ci, t_ci)

    p_c = scan_world @ rcw.T + pcw
    z = p_c[..., 2]
    uv = cam.project(p_c)
    ok = scan_mask & (z > 0) & cam.in_frame(uv, border=cfg.border_px)
    score_map = img_ops.shi_tomasi_dense(img)
    h_img, w_img = img.shape
    ui = torch.clamp(torch.floor(uv[:, 0]).to(torch.int32), 0, w_img - 1)
    vi = torch.clamp(torch.floor(uv[:, 1]).to(torch.int32), 0, h_img - 1)
    n_pts = scan_world.shape[0]
    flat_px = torch.where(ok, vi * w_img + ui, h_img * w_img)
    pt_at_px = scatter_ops.reduce_drop(
        torch.full((h_img * w_img,), n_pts, dtype=torch.int32, device=dev),
        flat_px, torch.arange(n_pts, dtype=torch.int32, device=dev), "amin",
    )
    hit = pt_at_px < n_pts
    score_hit = torch.where(hit, score_map.reshape(-1), -1.0)
    g = cfg.grid_size
    ph, pw = gh * g - h_img, gw * g - w_img

    def blocks(a, fill):
        return F.pad(a.reshape(h_img, w_img), (0, pw, 0, ph), value=fill).reshape(gh, g, gw, g)

    sb = blocks(score_hit, -1.0)
    cell_max = torch.amax(sb, dim=(1, 3))
    at_max = sb >= cell_max[:, None, :, None]
    big_i = h_img * w_img
    pb = blocks(torch.arange(h_img * w_img, dtype=torch.int32, device=dev), h_img * w_img)
    win_px = torch.amin(torch.where(at_max, pb, big_i), dim=(1, 3))
    has2d = cell_max > 0.0
    winner2d = pt_at_px[torch.clamp(win_px, 0, h_img * w_img - 1).long()]
    winner2d = torch.clamp(winner2d, 0, n_pts - 1)
    winner = winner2d.T.reshape(-1).long()
    w_score = cell_max.T.reshape(-1)
    has = has2d.T.reshape(-1)
    new_ok = has & (w_score > sel.cell_score) & (w_score > 0.0)

    new_px = uv[winner]
    patches = stored_patch_pyramid(img, new_px, vm_cfg)
    vmap = vmap_mod.add_points(
        vmap, vm_cfg, scan_world[winner], w_score, patches, new_px, rcw, pcw, new_ok
    )

    sel_pc = sel.pt_pos @ rcw.T + pcw
    sel_uv = cam.project(sel_pc)
    obs_ok = sel.valid & (sel_pc[..., 2] > 0) & cam.in_frame(sel_uv, cfg.border_px)

    pidx = sel.pt_idx.long()
    last_k = ((vmap.obs_cursor[pidx] - 1) % vm_cfg.max_obs).long()
    last_px = vmap.obs_px[pidx, last_k]
    last_rcw = vmap.obs_rcw[pidx, last_k]
    last_pcw = vmap.obs_pcw[pidx, last_k]
    last_cam = vmap_mod.obs_cam_pos(last_rcw, last_pcw)
    cam_pos = -rcw.T @ pcw
    delta_p = torch.linalg.vector_norm(cam_pos - last_cam, dim=-1)
    px_dist = torch.linalg.vector_norm(sel_uv - last_px, dim=-1)
    add_flag = obs_ok & ((delta_p > 0.5) | (px_dist > 40.0))

    su = torch.clamp(torch.floor(sel_uv[:, 0]).to(torch.int64), 0, w_img - 1)
    sv = torch.clamp(torch.floor(sel_uv[:, 1]).to(torch.int64), 0, h_img - 1)
    sel_score = score_map[sv, su]
    sel_patches = stored_patch_pyramid(img, sel_uv, vm_cfg)

    vmap = vmap_mod.add_observations(
        vmap, vm_cfg, sel.pt_idx, sel_score, sel_patches, sel_uv, rcw, pcw, add_flag
    )
    return (
        vmap,
        torch.sum(new_ok.to(torch.int32)).to(torch.int32),
        torch.sum(add_flag.to(torch.int32)).to(torch.int32),
    )


def vio_update(
    state_prop: NavState,
    vmap: vmap_mod.VisualMap,
    img: torch.Tensor,
    scan_world: torch.Tensor,
    scan_mask: torch.Tensor,
    cam: Pinhole,
    rot_ci: torch.Tensor,
    t_ci: torch.Tensor,
    vm_cfg: vmap_mod.VisualMapConfig,
    cfg: VioConfig,
) -> Tuple[NavState, vmap_mod.VisualMap, VioInfo]:
    """Full per-frame VIO: select -> update -> maintain."""
    sel, _ = select(state_prop, vmap, img, scan_world, scan_mask, cam, rot_ci, t_ci, vm_cfg, cfg)
    posterior, err0, err1 = photometric_update(state_prop, sel, img, cam, rot_ci, t_ci, cfg)
    vmap, n_new, n_obs = maintain(
        posterior, vmap, sel, img, scan_world, scan_mask, cam, rot_ci, t_ci, vm_cfg, cfg
    )
    info = VioInfo(
        n_selected=torch.sum(sel.valid.to(torch.int32)).to(torch.int32),
        error_before=err0,
        error_after=err1,
        n_new_points=n_new,
        n_new_obs=n_obs,
    )
    return posterior, vmap, info
