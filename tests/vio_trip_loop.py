"""The photometric update's loop before its trips were factored into
`models.vio.gn_trip`, kept op for op as the tests' eager reference: each
trip dispatched from a Python loop, one flag read a trip, the same
`vio.trips` and `sync.vio_flags` counts. Imports no jax, so the tests
marked `cuda` use it too."""

from typing import List, Optional, Tuple

import torch

from fastlivo_tpu_torch.models import ieskf
from fastlivo_tpu_torch.models.vio import _R2D, _SAMPLE_PAD, Selection, VioConfig, camera_pose, pyramid_padded
from fastlivo_tpu_torch.ops import image as img_ops
from fastlivo_tpu_torch.ops import linalg, so3
from fastlivo_tpu_torch.ops.camera import Pinhole
from fastlivo_tpu_torch.state import DIM_STATE, NavState, boxminus, boxplus
from fastlivo_tpu_torch.utils import timing


def loop_photometric_update(
    state_prop: NavState,
    sel: Selection,
    img: torch.Tensor,
    cam: Pinhole,
    rot_ci: torch.Tensor,
    t_ci: torch.Tensor,
    cfg: VioConfig,
    pyr: Optional[List[torch.Tensor]] = None,
) -> Tuple[NavState, torch.Tensor, torch.Tensor]:
    """Phase B: coarse-to-fine iterated EKF with error-decrease acceptance
    and rollback. `pyr` is img's padded pyramid (built here when None).
    Returns (posterior, error_before, error_after)."""
    dtype = img.dtype
    dev = img.device
    p_inv = linalg.psd_inverse(state_prop.cov / cfg.img_point_cov)
    psz2 = cfg.patch_size**2
    if pyr is None:
        pyr = pyramid_padded(img, cfg.levels)
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
            timing.count("vio.trips")
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
            timing.sync_point("vio_flags")
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

