"""Port parity: linalg (Cholesky solves, closed-form eigh3), the IESKF MAP
step and IMU propagation / undistortion.

Tolerances: solves of well-conditioned 18x18 systems agree to f32 rounding
of LAPACK (rtol 1e-4); the closed-form eigenpair repeats the JAX formula
(rtol 1e-4 on eigenvalues of unit-scale matrices, normals up to sign
never flip since the same row cross product wins); propagation chains 31
intervals of 3x3 products (atol 1e-5 on metres and radians, 1e-6 on the
covariance whose entries are ~1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
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


def _imu_case(seed, m=32):
    rng = np.random.default_rng(seed)
    stamps = np.linspace(0.0, 0.1, m).astype(np.float32)
    mask = np.ones(m, bool)
    mask[-3:] = False  # padded tail: zero-dt no-ops
    win = dict(
        stamps=stamps,
        gyr=(rng.normal(size=(m, 3)) * 0.3).astype(np.float32),
        acc=(rng.normal(size=(m, 3)) * 0.5 + [0.0, 0.0, 9.81]).astype(np.float32),
        mask=mask,
    )
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


def _propagate_both(seed):
    st, win = _imu_case(seed)
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


def test_propagate():
    (j_state, j_poses), (t_state, t_poses) = _propagate_both(6)
    for name, g, w in zip(TNav._fields, t_state, j_state):
        atol = 1e-6 if name == "cov" else 1e-5
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=atol, err_msg=name)
    for name, g, w in zip(TI.ImuPoses._fields, t_poses, j_poses):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5, err_msg=name)


def test_undistort():
    (j_state, j_poses), (t_state, t_poses) = _propagate_both(7)
    rng = np.random.default_rng(8)
    n = 512
    pts = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    t_offs = np.sort(rng.uniform(-0.01, 0.11, n)).astype(np.float32)  # both ends clamp
    mask = rng.uniform(size=n) > 0.1
    rot_il = np.asarray(JSO3.exp(jnp.asarray([0.01, -0.02, 0.03])))
    t_il = np.array([0.05, -0.02, 0.1], np.float32)
    want = np.asarray(jax.jit(JI.undistort)(
        jnp.asarray(pts), jnp.asarray(t_offs), jnp.asarray(mask), j_poses, j_state,
        jnp.asarray(rot_il), jnp.asarray(t_il),
    ))
    got = TI.undistort(
        torch.from_numpy(pts), torch.from_numpy(t_offs), torch.from_numpy(mask), t_poses,
        t_state, torch.from_numpy(rot_il), torch.from_numpy(t_il),
    ).numpy()
    # |p| up to ~17 m: 1e-5 relative is ~0.2 mm.
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-4)
    np.testing.assert_array_equal(got[~mask], pts[~mask])
