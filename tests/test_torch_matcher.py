"""Port parity for the visual loop gate: SuperPoint and LightGlue as torch
modules against the JAX forwards (random-init and the committed trained
weights), the learned matcher's match sets on the trained-matcher loop
pairs of tests/test_superpoint_lightglue.py, the classical matchers and
`essential_pose`.

Tolerances: score map, dense descriptors and the assignment matrix within
1e-4 (f32 convolutions and products in another summation order); integer
outputs (keypoint pixels, match sets) identical."""

import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter
from scipy.spatial.transform import Rotation

import jax
import jax.numpy as jnp
from fastlivo_tpu.backend import superpoint_lightglue as JSPL
from fastlivo_tpu.backend import visual_verify as JVV
from fastlivo_tpu.io import render as JR
from fastlivo_tpu.ops.camera import Pinhole as JPinhole
from fastlivo_tpu_torch import convert
from fastlivo_tpu_torch.backend import superpoint_lightglue as TSPL
from fastlivo_tpu_torch.backend import visual_verify as TVV
from fastlivo_tpu_torch.ops.camera import Pinhole as TPinhole

torch.set_num_threads(4)


@pytest.fixture(scope="module")
def textured_img():
    r = np.random.default_rng(7)
    img = gaussian_filter(r.uniform(0, 1, (256, 320)), 3.0)
    img += 0.5 * gaussian_filter(r.uniform(0, 1, (256, 320)), 8.0)
    img = (img - img.min()) / (img.max() - img.min())
    return img.astype(np.float32)


def _weights(kind):
    """(JAX pytrees, torch modules) for random-init or committed weights."""
    if kind == "random":
        j_sp, j_lg = JSPL.init_superpoint(0), JSPL.init_lightglue(1, n_layers=2)
        sp_np = {k: np.asarray(v) for k, v in j_sp.items()}
        lg_np = {k: np.asarray(v) for k, v in j_lg.items()}
    else:
        sp_path, lg_path = JVV.default_weights_paths()
        sp_np, lg_np = TSPL.load_npz(sp_path), TSPL.load_npz(lg_path)
        j_sp, j_lg = JSPL.load_npz(sp_path), JSPL.load_npz(lg_path)
    sp = TSPL.SuperPoint()
    sp.load_state_dict(convert.superpoint_state_from_numpy(sp_np))
    state, depth = convert.lightglue_state_from_numpy(lg_np)
    lg = TSPL.LightGlue(depth)
    lg.load_state_dict(state)
    return (j_sp, j_lg, int(np.asarray(j_lg["n_layers"]))), (sp.eval(), lg.eval())


@pytest.fixture(scope="module", params=["random", "trained"])
def weights(request):
    return _weights(request.param)


def test_superpoint_and_keypoints(weights, textured_img):
    (j_sp, _, _), (sp, _) = weights
    j_scores, j_desc = jax.jit(JSPL.superpoint_forward)(j_sp, jnp.asarray(textured_img))
    with torch.no_grad():
        t_scores, t_desc = TSPL.superpoint_forward(sp, torch.as_tensor(textured_img))
        tk, td, tv = TSPL.extract_keypoints(sp, torch.as_tensor(textured_img), 256)
    np.testing.assert_allclose(t_scores.numpy(), np.asarray(j_scores), atol=1e-4)
    np.testing.assert_allclose(t_desc.numpy(), np.asarray(j_desc), atol=1e-4)
    jk, jd, jv = JSPL.extract_keypoints(j_sp, jnp.asarray(textured_img), 256)
    assert np.asarray(jv).sum() > 32
    assert np.array_equal(tk.numpy(), np.asarray(jk))
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-4)


def test_lightglue_on_jax_keypoints(weights, textured_img):
    (j_sp, j_lg, depth), (_, lg) = weights
    img2 = np.roll(textured_img, 5, axis=1)
    k0, d0, v0 = JSPL.extract_keypoints(j_sp, jnp.asarray(textured_img), 128)
    k1, d1, v1 = JSPL.extract_keypoints(j_sp, jnp.asarray(img2), 128)
    size = jnp.asarray([320.0, 256.0])
    jp, jm0, _ = JSPL.lightglue_forward(j_lg, k0, d0, v0, k1, d1, v1, size, n_layers=depth)
    t = [torch.as_tensor(np.asarray(a)) for a in (k0, d0, v0, k1, d1, v1)]
    with torch.no_grad():
        tp, tm0, _ = TSPL.lightglue_forward(lg, *t, torch.tensor([320.0, 256.0]))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-4)
    np.testing.assert_allclose(tm0.numpy(), np.asarray(jm0), atol=1e-4)


def _render_view(rot_wc, pos):
    cam = JPinhole(width=320, height=256, fx=200.0, fy=200.0, cx=160.0, cy=128.0)
    rcw = np.asarray(rot_wc, np.float32).T
    pcw = -rcw @ np.asarray(pos, np.float32)
    f = jax.jit(JR.render_room, static_argnames="cam")(cam, jnp.asarray(rcw), jnp.asarray(pcw))
    return np.asarray(f)


@pytest.fixture(scope="module")
def loop_pairs():
    """tests/test_superpoint_lightglue.py::test_trained_matcher_verifies_loops'
    true loop pair and mismatched pair."""
    base = Rotation.from_euler("x", -90, degrees=True).as_matrix()
    img1 = _render_view(base, [0.0, 0.0, 0.0])
    img2 = _render_view(base @ Rotation.from_rotvec([0.0, 0.04, 0.06]).as_matrix(), [0.25, 0.15, 0.05])
    far = base @ Rotation.from_euler("y", 150, degrees=True).as_matrix()
    img3 = _render_view(far, [5.0, 4.0, 0.5])
    return img1, img2, img3


def test_trained_match_sets_identical(loop_pairs):
    img1, img2, img3 = loop_pairs
    jm, tm = JVV.default_matcher(), TVV.default_matcher(device="cpu")
    assert isinstance(tm, TVV.SuperPointLightGlue)
    for other, want in ((img2, True), (img3, False)):
        jok, jres = JVV.verify_loop(img1, other, jm)
        tok, tres = TVV.verify_loop(img1, other, tm)
        assert tok == jok == want
        assert tres.n_keypoints == jres.n_keypoints
        assert np.array_equal(tres.pts1, jres.pts1) and np.array_equal(tres.pts2, jres.pts2)


def test_broken_weights_raise(tmp_path):
    bad = tmp_path / "sp.npz"
    bad.write_bytes(b"not an npz")
    with pytest.raises(Exception):
        TVV.SuperPointLightGlue(weights_path=(str(bad), str(bad)), device="cpu")
    with pytest.raises(FileNotFoundError):
        TVV.SuperPointLightGlue(weights_path=None, device="cpu")


@pytest.mark.parametrize("kind", ["PatchMatcher", "OrientedPatchMatcher"])
def test_classical_matchers_identical(kind, textured_img, loop_pairs):
    from scipy.ndimage import rotate as nd_rotate

    img1 = textured_img * 255.0
    pairs = [(img1, nd_rotate(img1, 30.0, reshape=False, order=1, mode="nearest")),
             (loop_pairs[0], loop_pairs[1])]
    for a, b in pairs:
        jres = getattr(JVV, kind)().match(a, b)
        tres = getattr(TVV, kind)(device="cpu").match(a, b)
        assert tres.n_keypoints == jres.n_keypoints > 8
        assert np.array_equal(tres.pts1, jres.pts1) and np.array_equal(tres.pts2, jres.pts2)


def test_essential_pose_equal(loop_pairs):
    jres = JVV.OrientedPatchMatcher().match(loop_pairs[0], loop_pairs[1])
    tres = TVV.MatchResult(jres.pts1, jres.pts2, jres.n_keypoints)
    cam = dict(width=320, height=256, fx=200.0, fy=200.0, cx=160.0, cy=128.0)
    je = JVV.essential_pose(jres, JPinhole(**cam))
    te = TVV.essential_pose(tres, TPinhole(**cam))
    assert je is not None and te is not None
    assert np.array_equal(te[0], je[0]) and np.array_equal(te[1], je[1]) and te[2] == je[2]
