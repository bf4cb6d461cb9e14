"""Port parity: linalg (Cholesky solves, closed-form eigh3), the IESKF MAP
step and IMU propagation / undistortion. The port's undistortion pairs
each IMU sample with the interval it starts and moves points past the last
valid sample with the last interval (FAST-LIO's rule), where the JAX
package pairs a sample with the interval before it and moves such points
with a padded slot; it is held to JAX's `undistort` on poses re-paired so.

Tolerances: solves of well-conditioned 18x18 systems agree to f32 rounding
of LAPACK (rtol 1e-4); the closed-form eigenpair repeats the JAX formula
(rtol 1e-4 on eigenvalues of unit-scale matrices, normals up to sign
never flip since the same row cross product wins); propagation chains 31
intervals of 3x3 products (atol 1e-5 on metres and radians, 1e-6 on the
covariance whose entries are ~1e-4); the windows the window builder fills
(128 slots, a valid prefix) chain up to 127 intervals and hold the same
tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastlivo_tpu.models import ieskf as JK
from fastlivo_tpu.models import imu as JI
from fastlivo_tpu.ops import linalg as JL
from fastlivo_tpu.ops import so3 as JSO3
from fastlivo_tpu.state import NavState as JNav
from fastlivo_tpu_torch.models import ieskf as TK
from fastlivo_tpu_torch.models import imu as TI
from fastlivo_tpu_torch.ops import linalg as TL
from fastlivo_tpu_torch.state import NavState as TNav
from fastlivo_tpu_torch.utils import timing

torch.set_num_threads(1)


def _spd(seed, n=18, scale=1.0):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, n))
    m = a @ a.T + n * np.eye(n)
    d = np.diag(np.logspace(-3, 3, n))  # wide dynamic range, as in the filter
    return (d @ m @ d * scale).astype(np.float32)


def test_psd_solve_and_inverse():
    a = _spd(0)
    b = np.random.default_rng(1).normal(size=18).astype(np.float32)
    bm = np.random.default_rng(2).normal(size=(18, 5)).astype(np.float32)
    for rhs in (b, bm):
        got = TL.psd_solve(torch.from_numpy(a), torch.from_numpy(rhs)).numpy()
        want = np.asarray(JL.psd_solve(jnp.asarray(a), jnp.asarray(rhs)))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-9)
    got = TL.psd_inverse(torch.from_numpy(a)).numpy()
    want = np.asarray(JL.psd_inverse(jnp.asarray(a)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-9)


def test_eigh3_smallest():
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(256, 20, 3)) * [1.0, 0.5, 0.01]
    r = np.asarray(JSO3.exp(jnp.asarray(rng.normal(size=(256, 3)), jnp.float32)))
    p = np.einsum("nij,nkj->nki", r, pts)
    p = p - p.mean(1, keepdims=True)
    cov = (np.einsum("nki,nkj->nij", p, p) / 20).astype(np.float32)
    lam_t, v_t = TL.eigh3_smallest(torch.from_numpy(cov))
    lam_j, v_j = JL.eigh3_smallest(jnp.asarray(cov))
    np.testing.assert_allclose(lam_t.numpy(), np.asarray(lam_j), rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), atol=1e-4)


def test_map_step_and_posterior_cov():
    p = _spd(4, scale=1e-8)
    p_inv = np.asarray(JL.psd_inverse(jnp.asarray(p)))
    rng = np.random.default_rng(5)
    h = rng.normal(size=(200, 18)).astype(np.float32)
    h[:, 6:] = 0.0
    hth = (h.T @ h * 1e3).astype(np.float32)
    hty = rng.normal(size=18).astype(np.float32)
    vec = rng.normal(size=18).astype(np.float32) * 1e-3
    dx_t, g_t = TK.map_step(*(torch.from_numpy(x) for x in (p_inv, hth, hty, vec)))
    dx_j, g_j = JK.map_step(*(jnp.asarray(x) for x in (p_inv, hth, hty, vec)))
    np.testing.assert_allclose(dx_t.numpy(), np.asarray(dx_j), rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-3, atol=1e-5)
    c_t = TK.posterior_cov(torch.from_numpy(p), g_t).numpy()
    c_j = np.asarray(JK.posterior_cov(jnp.asarray(p), g_j))
    np.testing.assert_allclose(c_t, c_j, rtol=1e-3, atol=1e-12)


def _imu_case(seed, m=32, n_valid=None):
    """A window with the last three slots masked (n_valid None), or a
    masked-prefix window as `io.sync.WindowBuilder` fills it: n_valid
    samples at 200 Hz, the tail repeating the last stamp with zero rates."""
    rng = np.random.default_rng(seed)
    if n_valid is None:
        stamps = np.linspace(0.0, 0.1, m).astype(np.float32)
        mask = np.ones(m, bool)
        mask[-3:] = False  # padded tail: zero-dt no-ops
        gyr = (rng.normal(size=(m, 3)) * 0.3).astype(np.float32)
        acc = (rng.normal(size=(m, 3)) * 0.5 + [0.0, 0.0, 9.81]).astype(np.float32)
    else:
        stamps = np.zeros(m, np.float32)
        stamps[:n_valid] = 0.0013 + 0.1 / 128 * np.arange(n_valid)
        stamps[n_valid:] = stamps[n_valid - 1]
        mask = np.arange(m) < n_valid
        gyr = np.zeros((m, 3), np.float32)
        acc = np.zeros((m, 3), np.float32)
        gyr[:n_valid] = rng.normal(size=(n_valid, 3)) * 0.3
        acc[:n_valid] = rng.normal(size=(n_valid, 3)) * 0.5 + [0.0, 0.0, 9.81]
    win = dict(stamps=stamps, gyr=gyr, acc=acc, mask=mask)
    a = rng.normal(size=(18, 18))
    st = dict(
        rot=np.asarray(JSO3.exp(jnp.asarray(rng.normal(size=3).astype(np.float32)))),
        pos=rng.normal(size=3).astype(np.float32),
        vel=rng.normal(size=3).astype(np.float32),
        bg=(rng.normal(size=3) * 0.01).astype(np.float32),
        ba=(rng.normal(size=3) * 0.01).astype(np.float32),
        grav=np.array([0.0, 0.0, -9.81], np.float32),
        cov=((a @ a.T) * 1e-5 + np.eye(18) * 1e-4).astype(np.float32),
    )
    return st, win


def _propagate_both(seed, m=32, n_valid=None):
    st, win = _imu_case(seed, m, n_valid)
    t_end, acc_scale = np.float32(0.1), np.float32(0.98)
    j_state, j_poses = jax.jit(JI.propagate)(
        JNav(**{k: jnp.asarray(v) for k, v in st.items()}),
        JI.ImuWindow(**{k: jnp.asarray(v) for k, v in win.items()}),
        jnp.asarray(t_end), jnp.asarray(acc_scale),
    )
    t_state, t_poses = TI.propagate(
        TNav(**{k: torch.from_numpy(v) for k, v in st.items()}),
        TI.ImuWindow(**{k: torch.from_numpy(v) for k, v in win.items()}),
        torch.tensor(t_end), torch.tensor(acc_scale),
    )
    return (j_state, j_poses), (t_state, t_poses)


@pytest.mark.parametrize("m,n_valid", [(32, None), (128, 1), (128, 21), (128, 128)])
def test_propagate(m, n_valid):
    (j_state, j_poses), (t_state, t_poses) = _propagate_both(6, m, n_valid)
    for name, g, w in zip(TNav._fields, t_state, j_state):
        atol = 1e-6 if name == "cov" else 1e-5
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=atol, err_msg=name)
    for name, g, w in zip(TI.ImuPoses._fields, t_poses, j_poses):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5, err_msg=name)


def _launches():
    return timing.counters().get("imu_propagate.launches", 0)


def test_propagate_on_the_cpu_is_the_plain_path():
    st, win = _imu_case(9, 128, 21)
    args = (
        TNav(**{k: torch.from_numpy(v) for k, v in st.items()}),
        TI.ImuWindow(**{k: torch.from_numpy(v) for k, v in win.items()}),
        torch.tensor(np.float32(0.1)), torch.tensor(np.float32(0.98)),
    )
    before = _launches()
    got = TI.propagate(*args)
    assert _launches() == before
    want = TI.propagate_plain(*args)
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(g, w)


def _kernel_inputs(state_dtype=torch.float64, window_dtype=torch.float64, m=128):
    st, win = _imu_case(10, m, min(21, m))
    state = TNav(**{k: torch.tensor(v, dtype=state_dtype) for k, v in st.items()})
    window = TI.ImuWindow(**{k: torch.as_tensor(v, dtype=None if k == "mask" else window_dtype)
                             for k, v in win.items()})
    return state, window, torch.tensor(0.1, dtype=window_dtype), torch.tensor(0.98, dtype=window_dtype)


@pytest.mark.parametrize("state_dtype,window_dtype,kind", [
    (torch.float32, torch.float32, 0), (torch.float64, torch.float64, 1), (torch.float64, torch.float32, 2),
])
def test_kernel_check_accepts_its_kinds(state_dtype, window_dtype, kind):
    assert TI._check(*_kernel_inputs(state_dtype, window_dtype)) == kind


BAD_INPUTS = (
    "f32 state, f64 window", "f16 window", "t_end f32", "t_end (1,)", "mask uint8", "gyr (M, 4)",
    "cov (17, 17)", "rot transposed", "one sample", "window above MAX_WINDOW", "stamps (M, 1)",
)


def _bad_inputs():
    """What the kernel's wrapper must reject, by name (CPU tensors; the
    checks are the ones the CUDA path makes before the launch)."""
    st, win, t_end, sc = _kernel_inputs()
    return {
        "f32 state, f64 window": (TNav(*(x.float() for x in st)), win, t_end, sc),
        "f16 window": (st, TI.ImuWindow(win.stamps.half(), win.gyr.half(), win.acc.half(), win.mask),
                       t_end.half(), sc.half()),
        "t_end f32": (st, win, t_end.float(), sc),
        "t_end (1,)": (st, win, t_end.reshape(1), sc),
        "mask uint8": (st, win._replace(mask=win.mask.to(torch.uint8)), t_end, sc),
        "gyr (M, 4)": (st, win._replace(gyr=torch.zeros(128, 4, dtype=torch.float64)), t_end, sc),
        "cov (17, 17)": (st._replace(cov=st.cov[:17, :17].contiguous()), win, t_end, sc),
        "rot transposed": (st._replace(rot=st.rot.T), win, t_end, sc),
        "one sample": _kernel_inputs(m=1),
        "window above MAX_WINDOW": _kernel_inputs(m=TI.MAX_WINDOW + 1),
        "stamps (M, 1)": (st, win._replace(stamps=win.stamps[:, None]), t_end, sc),
    }


@pytest.mark.parametrize("case", BAD_INPUTS)
def test_kernel_check_rejects(case):
    bad = _bad_inputs()
    assert set(bad) == set(BAD_INPUTS)
    with pytest.raises(ValueError):
        TI._check(*bad[case])


def forward_paired(poses, imu_mask):
    """JAX's poses re-paired as the port's undistortion pairs them (each
    sample with the rate and acceleration of the interval it starts, the
    last valid sample with the last interval's), the padded slots holding
    the last valid sample's stamp: JAX's `undistort` on them is the port's
    rule in the JAX package's arithmetic."""
    last = int(np.sum(imu_mask)) - 1
    slots = np.arange(np.asarray(poses.stamps).shape[0])
    held = np.minimum(slots, last)
    return poses._replace(
        stamps=jnp.asarray(poses.stamps)[held],
        acc_w=jnp.asarray(poses.acc_w)[np.minimum(slots + 1, last)],
        gyr_b=jnp.asarray(poses.gyr_b)[np.maximum(np.minimum(slots, last - 1), 0)],
    )


def _undistort_both(m, n_valid):
    """(the port's, JAX's on forward-paired poses, the points' mask, the
    points) over one window."""
    (j_state, j_poses), (t_state, t_poses) = _propagate_both(7, m, n_valid)
    imu_mask = _imu_case(7, m, n_valid)[1]["mask"]
    rng = np.random.default_rng(8)
    n = 512
    pts = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    t_offs = np.sort(rng.uniform(-0.01, 0.11, n)).astype(np.float32)  # both ends clamp
    mask = rng.uniform(size=n) > 0.1
    rot_il = np.asarray(JSO3.exp(jnp.asarray([0.01, -0.02, 0.03])))
    t_il = np.array([0.05, -0.02, 0.1], np.float32)
    want = np.asarray(jax.jit(JI.undistort)(
        jnp.asarray(pts), jnp.asarray(t_offs), jnp.asarray(mask), forward_paired(j_poses, imu_mask), j_state,
        jnp.asarray(rot_il), jnp.asarray(t_il),
    ))
    got = TI.undistort(
        torch.from_numpy(pts), torch.from_numpy(t_offs), torch.from_numpy(mask), t_poses,
        t_state, torch.from_numpy(rot_il), torch.from_numpy(t_il), torch.from_numpy(imu_mask),
    ).numpy()
    return got, want, mask, pts


def test_undistort():
    got, want, mask, pts = _undistort_both(32, None)
    # |p| up to ~17 m: 1e-5 relative is ~0.2 mm.
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-4)
    np.testing.assert_array_equal(got[~mask], pts[~mask])


def test_undistort_masked_prefix_window():
    """A 128-slot window with 21 valid samples, the tail repeating the last
    stamp, as `io.sync.WindowBuilder` fills it."""
    got, want, mask, pts = _undistort_both(128, 21)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-4)
    np.testing.assert_array_equal(got[~mask], pts[~mask])
