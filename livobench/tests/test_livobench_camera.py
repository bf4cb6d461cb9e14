"""The camera room (`avia_livo.handheld_room`, float32) against the
reference on the CPU at the tests' small size (`small.py`): the program's
LIO and VIO numbers read under bounds read at this size, the TF32 control
reads over them, and the plane fit the program had before it was centred
(the normal equations of A x = -1 on the raw float32 Gram) is found out by
the LIO position, its undistortion before it paired each IMU sample with
the interval the sample starts by the LIO attitude."""

from livobench import check, control, harness
from livobench.tests import small

# CPU readings at this size, seeds 2147483659 and 11-15: the program
# lio_pos_gap_m 2.8e-7-3.2e-5, lio_rot_gap_rad 4.8e-8-8.9e-6, map_gap_m
# 3.1e-6-1.2e-4, vio_pos_gap_m <= 3.8e-7, vio_rot_gap_rad <= 1.1e-7,
# patch_gap <= 8.5e-4; the TF32 control 1.8e-3, 9.7e-4, 1.6e-2, 7.2e-5,
# 9.4e-5 and 2.3 and above; the raw-Gram fit's lio_pos_gap_m 3.1e-3-1.2e-2.
BOUNDS = {"lio_pos_gap_m": 3e-4, "lio_rot_gap_rad": 1e-4, "map_gap_m": 2e-3, "vio_pos_gap_m": 1e-5,
          "vio_rot_gap_rad": 1e-5, "patch_gap": 0.05}
SEED = 2147483659


def gram_esti_plane(neighbors, neighbor_valid, threshold=0.1):
    """The fit before centring: the adjugate of the raw Gram A^T A."""
    import torch

    from fastlivo_tpu_torch.ops import plane

    x, det = plane._solve3(neighbors.transpose(-1, -2) @ neighbors, -torch.sum(neighbors, dim=1))
    finite = torch.all(torch.isfinite(x), dim=-1)
    x = torch.where(finite[..., None], x, 0.0)
    norm = torch.linalg.vector_norm(x, dim=-1)
    normal = x / (norm[..., None] + plane._EPS)
    d = 1.0 / (norm + plane._EPS)
    resid = torch.abs((neighbors @ normal[..., None])[..., 0] + d[:, None])
    valid = (torch.all(neighbor_valid, dim=-1) & torch.all(resid <= threshold, dim=-1) & finite
             & (torch.abs(det) > 1e-12) & (norm > plane._EPS))
    return torch.where(valid[..., None], normal, 0.0), torch.where(valid, d, 0.0), valid


def test_the_float32_room_follows_the_reference_and_tf32_does_not():
    c = small.cell(small.ROOM)
    assert c.precision == "float32"
    got = control.readings(c, SEED, 8.0, "cpu", overrides=small.SMALL["avia_livo"], traffic=small.small_traffic(c))
    sound, ctrl = got["sound"], got["control"]
    assert check.judge(sound, BOUNDS)[0], sound
    failed = {n for n, _, _, good in check.judge(ctrl, BOUNDS)[1] if not good}
    assert {"lio_pos_gap_m", "map_gap_m", "patch_gap"} <= failed, ctrl
    # The cell's own limits: each VIO number compared as the largest and as the median over the updates.
    assert check.judge(sound, c.limits)[0], sound
    failed = {n for n, _, _, good in check.judge(ctrl, c.limits)[1] if not good}
    assert {"lio_pos_gap_m", "patch_gap", "patch_gap_median"} <= failed, ctrl


def test_the_raw_gram_fit_is_found_out(monkeypatch):
    from fastlivo_tpu_torch.ops import plane

    monkeypatch.setattr(plane, "esti_plane", gram_esti_plane)
    c = small.cell(small.ROOM)
    c.limits = BOUNDS
    result, lines = harness.run_cell(c, SEED, 8.0, False, "cpu", 0.0, overrides=small.SMALL["avia_livo"],
                                     traffic=small.small_traffic(c))
    failed = {n for n, _, _, good in lines if not good}
    assert not result["correct"] and "lio_pos_gap_m" in failed, lines


def previous_undistort(points, t_offs, mask, poses, state_end, rot_il, t_il, imu_mask):
    """The undistortion before the fix: slot j's rate and the acceleration
    of the interval before it, a point past the last valid sample moved on
    from a padded slot."""
    import torch

    from fastlivo_tpu_torch.ops import so3

    idx = torch.clamp(torch.searchsorted(poses.stamps, t_offs, right=True) - 1, 0, poses.stamps.shape[0] - 1)
    dt = (t_offs - poses.stamps[idx])[:, None]
    rot_i = poses.rot[idx] @ so3.exp(poses.gyr_b[idx] * dt)
    pos_i = poses.pos[idx] + poses.vel[idx] * dt + 0.5 * poses.acc_w[idx] * dt * dt
    p_w = (rot_i @ (points @ rot_il.T + t_il)[:, :, None])[:, :, 0] + pos_i
    p_end = ((p_w - state_end.pos) @ state_end.rot - t_il) @ rot_il
    return torch.where(mask[:, None], p_end, points)


def test_the_previous_undistortion_is_found_out(monkeypatch):
    from fastlivo_tpu_torch.models import imu

    monkeypatch.setattr(imu, "undistort", previous_undistort)
    c = small.cell(small.ROOM)
    c.limits = BOUNDS
    result, lines = harness.run_cell(c, SEED, 8.0, False, "cpu", 0.0, overrides=small.SMALL["avia_livo"],
                                     traffic=small.small_traffic(c))
    failed = {n for n, _, _, good in lines if not good}
    assert not result["correct"] and "lio_rot_gap_rad" in failed, lines
