"""Photometric visual-inertial update, written from the mathematics.

Images: a pyramid of 2x2 means; a patch of P x P texels about a centre c
at stride s samples the level's image bilinearly at c + s (i - P/2, j -
P/2), zero outside the image, and its gradients are the central
differences at +-s over 2 s (in the level's pixels, times 2^-level for the
full frame's). A stored observation patch is the 12 x 12 patch at stride 1
of each level, about px / 2^level.

Selection (`select`): a visual map point is a candidate when it lies in
front of the camera and `border_px` inside the frame, and the depth image
of the last scan's world points (the nearest return per pixel) has a
return within 4 pixels of it and none nearer or farther than
`depth_continuous_thresh` from it. Each grid cell takes its candidate
nearest the camera, and with it the point's observation seen from the
direction closest to the current one (cosine above 0.5). The stored patch
is warped into the current view by the affine map of the two views'
pixel steps at the point's depth; the warp's determinant sets the search
level (0, 1, 2 above 3 and 12) and the stride 2^level. A choice is kept
when its warped patch and the current one, after the exposure fit of all
choices (gain in [0.5, 2] and bias, least squares), differ by at most
`outlier_threshold` per texel squared.

The update (`update`): from the coarsest level to the finest, Gauss-Newton
steps of the same MAP problem as the LIO update with the photometric
residuals (image patch, exposure-fitted, less the reference patch) and
P / img_point_cov as the prior; each level keeps a step only while the
mean squared residual does not grow, and stops when it grows (back to the
best), on convergence or after `max_iterations`. The covariance shrinks by
the last kept gain when the finest level's error is no worse than the
coarsest's.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch
import torch.nn.functional as F

from livobench.reference import arith as A
from livobench.reference.camera import Pinhole
from livobench.reference.lio import R2D, State, boxminus, boxplus


def pyramid(img: torch.Tensor, levels: int) -> List[torch.Tensor]:
    out = [img]
    for _ in range(levels - 1):
        c = out[-1]
        c = c[: c.shape[0] // 2 * 2, : c.shape[1] // 2 * 2]
        out.append(0.25 * (c[0::2, 0::2] + c[0::2, 1::2] + c[1::2, 0::2] + c[1::2, 1::2]))
    return out


def bilinear(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    h, w = img.shape
    x0, y0 = torch.floor(uv[..., 0]), torch.floor(uv[..., 1])
    fx, fy = uv[..., 0] - x0, uv[..., 1] - y0
    x0, y0 = x0.to(torch.int64), y0.to(torch.int64)

    def tap(x, y):
        ok = (x >= 0) & (x < w) & (y >= 0) & (y < h)
        return torch.where(ok, img[y.clamp(0, h - 1), x.clamp(0, w - 1)], 0.0)

    return (tap(x0, y0) * (1 - fx) * (1 - fy) + tap(x0 + 1, y0) * fx * (1 - fy)
            + tap(x0, y0 + 1) * (1 - fx) * fy + tap(x0 + 1, y0 + 1) * fx * fy)


def grid(p: int, ar: A.Arith, device) -> torch.Tensor:
    """(p*p, 2) texel offsets (u, v) from the centre, row by row."""
    r = torch.arange(p, device=device).to(ar.dtype) - p // 2
    return torch.stack([r.repeat(p), r.repeat_interleave(p)], -1)


def patch(img, c, stride, p, ar, grad_units=None):
    """Patch values (N, p*p) about centres c (N, 2) at per-point strides,
    and with `grad_units` their gradients over those units."""
    off = grid(p, ar, c.device)[None] * stride[:, None, None]
    uv = c[:, None, :] + off
    val = bilinear(img, uv)
    if grad_units is None:
        return val
    su = torch.stack([stride, torch.zeros_like(stride)], -1)[:, None, :]
    sv = torch.stack([torch.zeros_like(stride), stride], -1)[:, None, :]
    inv = (1.0 / grad_units)[:, None]
    du = 0.5 * (bilinear(img, uv + su) - bilinear(img, uv - su)) * inv
    dv = 0.5 * (bilinear(img, uv + sv) - bilinear(img, uv - sv)) * inv
    return val, du, dv


def stored_patches(pyr, px, size: int, levels: int, ar) -> torch.Tensor:
    """(N, levels * size * size) observation patches at px."""
    one = torch.ones(px.shape[0], dtype=ar.dtype, device=px.device)
    return torch.cat([patch(pyr[l], px / 2**l, one, size, ar) for l in range(levels)], -1)


def camera_pose(ar: A.Arith, s: State, r_ci, t_ci):
    """World -> camera: p_c = rcw p + pcw."""
    rcw = ar.mm(r_ci, s.rot.T)
    return rcw, t_ci - ar.mm(rcw, s.pos[:, None])[:, 0]


def exposure(val, ref, w):
    """Gain and bias fitting val to ref over the weighted texels."""
    n = torch.clamp(w.sum(), min=1.0)
    mv, mr = (val * w).sum() / n, (ref * w).sum() / n
    gain = ((val - mv) * (ref - mr) * w).sum() / n / torch.clamp(((val - mv) ** 2 * w).sum() / n, min=1e-6)
    gain = torch.clamp(gain, 0.5, 2.0)
    return gain, mr - gain * mv


class Selection(NamedTuple):
    valid: torch.Tensor  # (G,)
    pos: torch.Tensor  # (G, 3)
    ref: torch.Tensor  # (G, levels, p*p)
    stride: torch.Tensor  # (G,)


def select(ar: A.Arith, s: State, vmap: dict, img, pyr, cloud, cam: Pinhole, r_ci, t_ci, v) -> Selection:
    dev = img.device
    rcw, pcw = camera_pose(ar, s, r_ci, t_ci)
    cam_pos = -ar.mm(rcw.T, pcw[:, None])[:, 0]
    h, w = cam.height, cam.width
    # The depth image of the scan's world points.
    pc = ar.mm(cloud, rcw.T) + pcw
    uv = cam.project(pc)
    ok = (pc[:, 2] > 0) & cam.inside(uv, 1)
    flat = (uv[:, 1].to(torch.int64) * w + uv[:, 0].to(torch.int64))[ok]
    depth = torch.full((h * w,), torch.inf, dtype=ar.dtype, device=dev)
    depth = depth.scatter_reduce(0, flat, pc[ok, 2], "amin").reshape(h, w)
    has = torch.isfinite(depth)
    near = -F.max_pool2d(torch.where(has, -depth, -torch.inf)[None, None], 9, 1, 4)[0, 0]
    far = F.max_pool2d(torch.where(has, depth, -torch.inf)[None, None], 9, 1, 4)[0, 0]

    pm = ar.mm(vmap["pos"], rcw.T) + pcw
    z = pm[:, 2]
    uvm = cam.project(pm)
    seen = vmap["active"] & (z > 0) & cam.inside(uvm, v.border_px)
    ci = uvm[:, 0].clamp(0, w - 1).to(torch.int64)
    ri = uvm[:, 1].clamp(0, h - 1).to(torch.int64)
    th = v.depth_continuous_thresh
    cand = seen & torch.isfinite(far[ri, ci]) & (far[ri, ci] <= z + th) & (near[ri, ci] >= z - th)

    gw, gh = -(-w // v.grid_size), -(-h // v.grid_size)
    cell = ((uvm[:, 0] / v.grid_size).to(torch.int64) * gh + (uvm[:, 1] / v.grid_size).to(torch.int64)).clamp(0, gw * gh - 1)
    dist = torch.linalg.vector_norm(vmap["pos"] - cam_pos, dim=-1)
    n_pts = dist.shape[0]
    best = torch.full((gw * gh,), torch.inf, dtype=ar.dtype, device=dev).scatter_reduce(
        0, cell[cand], dist[cand], "amin")
    win = cand & (dist == best[cell])
    idx = torch.full((gw * gh,), n_pts, dtype=torch.int64, device=dev).scatter_reduce(
        0, cell[win], torch.arange(n_pts, device=dev)[win], "amin")
    chosen = idx < n_pts
    pi = idx.clamp(max=n_pts - 1)
    pos = vmap["pos"][pi]

    # The observation seen from nearest the current direction.
    o_rcw, o_pcw = vmap["obs_rcw"][pi], vmap["obs_pcw"][pi]
    o_cam = -(o_rcw.transpose(-1, -2) @ o_pcw[..., None])[..., 0]
    view = cam_pos - pos
    view = view / (torch.linalg.vector_norm(view, dim=-1, keepdim=True) + 1e-9)
    od = o_cam - pos[:, None, :]
    od = od / (torch.linalg.vector_norm(od, dim=-1, keepdim=True) + 1e-9)
    cos = torch.where(vmap["obs_valid"][pi], (od * view[:, None, :]).sum(-1), -2.0)
    k = torch.argmax(cos, dim=1)
    g = torch.arange(pi.shape[0], device=dev)
    valid = chosen & (cos[g, k] > 0.5)
    ref_px, rr, rp = vmap["obs_px"][pi, k], o_rcw[g, k], o_pcw[g, k]

    # The affine warp from the reference view's pixels to the current one's.
    half = v.patch_size // 2
    depth_ref = torch.linalg.vector_norm(o_cam[g, k] - pos, dim=-1)
    xyz = cam.unproject(ref_px) * depth_ref[:, None]

    def at_depth(px):
        f = cam.unproject(px)
        return f * (xyz[:, 2:3] / f[:, 2:3])

    r_cr = rcw @ rr.transpose(-1, -2)
    t_cr = pcw - (r_cr @ rp[..., None])[..., 0]

    def to_cur(x):
        return cam.project((r_cr @ x[..., None])[..., 0] + t_cr)

    c0 = to_cur(xyz)
    step_u = torch.tensor([half, 0.0], dtype=ar.dtype, device=dev)
    step_v = torch.tensor([0.0, half], dtype=ar.dtype, device=dev)
    a_cr = torch.stack([(to_cur(at_depth(ref_px + step_u)) - c0) / half,
                        (to_cur(at_depth(ref_px + step_v)) - c0) / half], -1)
    det = a_cr[:, 0, 0] * a_cr[:, 1, 1] - a_cr[:, 0, 1] * a_cr[:, 1, 0]
    level = (det > 3.0).to(torch.int64) + (det > 12.0).to(torch.int64)
    stride = (2.0 ** level).to(ar.dtype)
    valid = valid & (det.abs() > 1e-6)
    a_rc = torch.linalg.inv(torch.where(valid[:, None, None], a_cr, torch.eye(2, dtype=ar.dtype, device=dev)))

    # The stored patch of the search level, warped; the other levels as stored.
    sp, lv = v.stored_patch, v.stored_levels
    stored = vmap["obs_patch"][pi, k].reshape(-1, lv, sp, sp)
    offs = grid(v.patch_size, ar, dev)[None] * stride[:, None, None]
    coords = (offs @ a_rc.transpose(-1, -2)) / stride[:, None, None] + sp // 2
    src = stored[g, level.clamp(max=lv - 1)]
    u = coords[..., 0].clamp(0, sp - 1)
    vv = coords[..., 1].clamp(0, sp - 1)
    u0, v0 = u.floor().clamp(0, sp - 2), vv.floor().clamp(0, sp - 2)
    fu, fv = u - u0, vv - v0
    u0, v0 = u0.to(torch.int64), v0.to(torch.int64)

    def tex(du, dv):
        return src[g[:, None], v0 + dv, u0 + du]

    warped = (tex(0, 0) * (1 - fu) * (1 - fv) + tex(1, 0) * fu * (1 - fv)
              + tex(0, 1) * (1 - fu) * fv + tex(1, 1) * fu * fv)
    lo = sp // 2 - half
    refs = [warped] + [stored[:, l, lo:lo + v.patch_size, lo:lo + v.patch_size].reshape(-1, v.patch_size ** 2)
                       for l in range(1, v.pyr_levels)]
    ref = torch.stack(refs, 1)

    # The photometric gate at the search level's stride.
    cur = patch(pyr[0], uvm[pi], stride, v.patch_size, ar)
    if v.exposure_en:
        gain, bias = exposure(cur, warped, valid[:, None].to(ar.dtype).expand_as(cur))
        cur = gain * cur + bias
    valid = valid & (((warped - cur) ** 2).sum(-1) <= v.outlier_threshold * v.patch_size ** 2)
    return Selection(valid, pos, torch.where(valid[:, None, None], ref, 0.0), stride)


def update(ar: A.Arith, prior: State, sel: Selection, pyr, cam: Pinhole, r_ci, t_ci, v) -> State:
    dev = prior.pos.device
    p_inv = torch.linalg.inv(prior.cov / v.img_point_cov)
    npx = v.patch_size ** 2

    def residuals(s: State, level: int):
        rcw, pcw = camera_pose(ar, s, r_ci, t_ci)
        p_i = ar.mm(sel.pos - s.pos, s.rot)
        pc = ar.mm(sel.pos, rcw.T) + pcw
        uv = cam.project(pc)
        ok = sel.valid & (pc[:, 2] > 1e-3) & cam.inside(uv, v.border_px // 2)
        val, du, dv = patch(pyr[level], uv / 2**level, sel.stride, v.patch_size, ar,
                            grad_units=sel.stride * 2.0**level)
        ref = sel.ref[:, level]
        if v.exposure_en:
            ga, gb = exposure(val, ref, ok[:, None].to(ar.dtype).expand_as(val))
            val, du, dv = ga * val + gb, ga * du, ga * dv
        res = torch.where(ok[:, None], val - ref, 0.0)
        j_uv = ar.mm(torch.stack([du, dv], -1), cam.jacobian(pc))  # (N, P*P, 3)
        j_th = ar.mm(j_uv, ar.mm(r_ci, A.hat(p_i)))
        j_p = ar.mm(j_uv, -ar.mm(r_ci, s.rot.T).expand(pc.shape[0], 3, 3))
        hm = torch.where(ok[:, None, None], torch.cat([j_th, j_p], -1), 0.0).reshape(-1, 6)
        err = (res ** 2).sum() / torch.clamp(ok.sum() * npx, min=1).to(ar.dtype)
        return hm, res.reshape(-1), err

    state, gain = prior, torch.zeros((18, 18), dtype=ar.dtype, device=dev)
    first = last = None
    for level in range(v.pyr_levels - 1, -1, -1):
        best, best_err = state, torch.tensor(torch.inf, dtype=ar.dtype, device=dev)
        for _ in range(v.max_iterations):
            hm, res, err = residuals(state, level)
            if not err <= best_err:  # worse: back to the best and stop the level
                state = best
                break
            hth = torch.zeros((18, 18), dtype=ar.dtype, device=dev)
            hth[0:6, 0:6] = ar.mm(hm.T, hm)
            hty = torch.zeros(18, dtype=ar.dtype, device=dev)
            hty[0:6] = -ar.mm(hm.T, res[:, None])[:, 0]
            s_mat = p_inv + hth
            dx = torch.linalg.solve(s_mat, ar.mm(p_inv, boxminus(prior, state)[:, None])[:, 0] + hty)
            gain = torch.linalg.solve(s_mat, hth)
            best, best_err = state, err
            state = boxplus(state, dx)
            if (torch.linalg.vector_norm(dx[0:3]) * R2D < v.converge_rot_deg
                    and torch.linalg.vector_norm(dx[3:6]) * 100.0 < v.converge_trans_cm):
                break
        first = best_err if first is None else first
        last = best_err
    cov = prior.cov - ar.mm(gain, prior.cov) if last <= first else prior.cov
    return state._replace(cov=0.5 * (cov + cov.T))
