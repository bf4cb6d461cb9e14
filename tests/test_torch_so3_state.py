"""Port parity: SO(3) maps and the filter state (boxplus / boxminus).

Same inputs (numpy, seeded) through fastlivo_tpu and fastlivo_tpu_torch.
The formulas are identical; tolerances cover f32 rounding of
transcendental functions (rtol 1e-5, atol 1e-6 on unit-scale values).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastlivo_tpu import state as JS
from fastlivo_tpu.ops import so3 as J
from fastlivo_tpu_torch import state as TS
from fastlivo_tpu_torch.ops import so3 as T

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)


def _rotvecs(seed, n=64):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(n, 3)) * rng.uniform(0, 3.0, (n, 1))
    w[:4] = [[0, 0, 0], [1e-7, 0, 0], [0, 0, np.pi - 1e-4], [0, 2.5, 0.4]]
    return w.astype(np.float32)


def _cmp(t_fn, j_fn, *args):
    got = t_fn(*[torch.tensor(np.asarray(a)) for a in args]).numpy()
    want = np.asarray(j_fn(*[jnp.asarray(a) for a in args]))
    np.testing.assert_allclose(got, want, **TOL)
    return got


def test_hat_vee_exp():
    w = _rotvecs(0)
    _cmp(T.hat, J.hat, w)
    r = _cmp(T.exp, J.exp, w)
    _cmp(T.vee, J.vee, r)


def test_log_including_near_pi():
    r = np.asarray(J.exp(jnp.asarray(_rotvecs(1))))
    _cmp(T.log, J.log, r)


def test_quaternions_and_euler():
    r = np.asarray(J.exp(jnp.asarray(_rotvecs(2))))
    q = _cmp(T.rot_to_quat, J.rot_to_quat, r)
    _cmp(T.quat_to_rot, J.quat_to_rot, q)
    _cmp(T.rot_to_euler, J.rot_to_euler, r)


def test_exp_scaled():
    w = _rotvecs(3, 8)
    dt = np.float32(0.05)
    got = T.exp_scaled(torch.from_numpy(w), dt).numpy()
    want = np.asarray(J.exp_scaled(jnp.asarray(w), dt))
    np.testing.assert_allclose(got, want, **TOL)


def _state(seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(18, 18)).astype(np.float32)
    return dict(
        rot=np.asarray(J.exp(jnp.asarray(rng.normal(size=3).astype(np.float32)))),
        pos=rng.normal(size=3).astype(np.float32),
        vel=rng.normal(size=3).astype(np.float32),
        bg=rng.normal(size=3).astype(np.float32) * 0.01,
        ba=rng.normal(size=3).astype(np.float32) * 0.01,
        grav=np.array([0.1, -0.2, -9.8], np.float32),
        cov=(a @ a.T * 1e-3).astype(np.float32),
    )


def test_boxplus_boxminus():
    sa, sb = _state(4), _state(5)
    dx = np.random.default_rng(6).normal(size=18).astype(np.float32) * 0.1
    ja, jb = JS.NavState(**sa), JS.NavState(**sb)
    ta = TS.NavState(**{k: torch.from_numpy(v) for k, v in sa.items()})
    tb = TS.NavState(**{k: torch.from_numpy(v) for k, v in sb.items()})
    for g, w in zip(TS.boxplus(ta, torch.from_numpy(dx)), JS.boxplus(ja, jnp.asarray(dx))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    np.testing.assert_allclose(
        TS.boxminus(ta, tb).numpy(), np.asarray(JS.boxminus(ja, jb)), **TOL
    )


def test_identity_state_and_device_rule():
    t = TS.NavState.identity(device="cpu")
    j = JS.NavState.identity()
    for g, w in zip(t, j):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert TS.DIM_STATE == JS.DIM_STATE and TS.GRAVITY_MS2 == JS.GRAVITY_MS2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            TS.NavState.identity()  # device=None means the GPU


def test_tf32_is_off():
    import fastlivo_tpu_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
