"""The loop back end's guards in the port (the counterparts of
tests/test_loop_manager.py:73, :125 and :179), each run through the JAX
package and the port on the same inputs: the same frames (rendered once,
as numpy) and the same clouds.

- the essential-matrix pose cross-check rejects a corrupted STD pose
  (fastlivo_tpu_torch/backend/loop_manager.py:158-172);
- the visual gate rejects mismatched frames and passes matching ones;
- a background detection stores the camera frame current at key-cloud
  submission, not the one current when its future completes
  (loop_manager.py:100-107).

Verdicts (loops accepted, loops rejected) must be the same in both
packages; the rejected pose check's angle agrees to 1e-3 rad.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from fastlivo_tpu.backend.loop_manager import LoopBackend as JLoop
from fastlivo_tpu.io import render
from fastlivo_tpu.ops.camera import Pinhole
from fastlivo_tpu.utils.config import FastLivoConfig
from fastlivo_tpu_torch.backend.loop_manager import LoopBackend as TLoop
from fastlivo_tpu_torch.utils.config import load_config
from tests.test_backend import make_structured_scene

torch.set_num_threads(1)

CAM = Pinhole(width=320, height=256, fx=200.0, fy=200.0, cx=160.0, cy=128.0)
BASE = Rotation.from_euler("x", -90, degrees=True).as_matrix()
_jrender = jax.jit(render.render_room, static_argnames="cam")


def img_at(pos, rot_wc=BASE):
    rcw = np.asarray(rot_wc).T
    pcw = -rcw @ np.asarray(pos)
    return np.asarray(_jrender(CAM, jnp.asarray(rcw, jnp.float32), jnp.asarray(pcw, jnp.float32)))


def both_backends(settings, background):
    """The same loop settings in both packages: (JAX backend, port backend)."""
    jcfg = FastLivoConfig()
    for k, v in settings.items():
        group, name = k.split(".")
        setattr(getattr(jcfg, group), name, v)
    return (JLoop(jcfg, background=background),
            TLoop(load_config(None, settings), background=background, device="cpu"))


GATE = {"loop.loop_en": True, "loop.sub_frame_num": 5, "loop.skip_near_num": 1, "loop.corner_thre": 6.0,
        "loop.icp_threshold": 0.3, "loop.visual_verify_en": True, "keyframe.trans_thresh_m": 0.5}


def test_pose_cross_check_rejects_corrupted_std_pose():
    settings = {
        "loop.loop_en": True, "loop.visual_verify_en": True, "camera.width": 320, "camera.height": 256,
        "camera.fx": 200.0, "camera.fy": 200.0, "camera.cx": 160.0, "camera.cy": 128.0,
        "camera.rcl": tuple(np.asarray(BASE).T.reshape(-1).tolist()), "keyframe.trans_thresh_m": 0.2,
    }
    img0, img1 = img_at([0.0, 0.0, 0.0]), img_at([0.4, 0.05, 0.0])

    def run(be, rot_std):
        # Two keyframes: the matched one at the origin, the current at 0.4 m.
        be.graph.maybe_add_keyframe(np.eye(3), np.zeros(3), 0.2, 0.2)
        be.graph.maybe_add_keyframe(np.eye(3), np.array([0.4, 0.05, 0.0]), 0.2, 0.2)
        be._std_frame_kf = [0]
        be._frame_imgs = [img0]
        be._handle_result((0, 0.8, rot_std, np.zeros(3)), 1, img1)
        return be

    for rot_std, n_loops in ((np.eye(3), 1), (Rotation.from_euler("z", 40, degrees=True).as_matrix(), 0)):
        jbe, tbe = (run(be, rot_std) for be in both_backends(settings, background=False))
        assert len(tbe.loops) == len(jbe.loops) == n_loops, (tbe.rejected_loops, jbe.rejected_loops)
        assert len(tbe.rejected_loops) == len(jbe.rejected_loops) == 1 - n_loops
        for t, j in zip(tbe.rejected_loops, jbe.rejected_loops):
            assert t[:2] == j[:2] and t[2] < 0 and abs(t[2] - j[2]) < 1e-3


@pytest.fixture(scope="module")
def gate_runs():
    """tests/test_loop_manager.py:125's sequence with a matching and an
    unrelated revisit frame, through both packages."""
    img1 = img_at([0.0, 0.0, 0.0])
    far = Rotation.from_euler("x", -90, degrees=True) * Rotation.from_euler("y", 150, degrees=True)
    second = {"ok": img_at([0.05, 0.02, 0.0]), "bad": img_at([5.0, 4.0, 0.5], far.as_matrix())}
    out = {}
    for name, img2 in second.items():
        for pkg, be in zip(("jax", "port"), both_backends(GATE, background=False)):
            rng = np.random.default_rng(3)
            place = make_structured_scene(rng, n=25000)
            for i in range(5):
                be.on_scan(np.eye(3), np.array([0.6 * i, 0, 0]), place[rng.permutation(len(place))[:12000]],
                           img=img1)
            place2 = make_structured_scene(np.random.default_rng(9), n=25000)
            for i in range(5):
                be.on_scan(np.eye(3), np.array([0.6 * i, 0.2, 0]), place2[rng.permutation(len(place2))[:12000]],
                           img=img2)
            be.finish()
            out[name, pkg] = (len(be.loops), len(be.rejected_loops))
    return out


def test_visual_gate_rejects_mismatched_images(gate_runs):
    for name in ("ok", "bad"):
        assert gate_runs[name, "port"] == gate_runs[name, "jax"], name
    assert gate_runs["ok", "port"][0] >= 1, "the visual gate blocked a genuine loop"
    loops, rejected = gate_runs["bad", "port"]
    assert loops == 0 and rejected >= 1


def test_background_image_captured_at_submission():
    """A garbage frame streamed between a key cloud's submission and its
    detection's completion must not replace the frame stored for it."""
    img_a = img_at([0.0, 0.0, 0.0])
    garbage = np.random.default_rng(3).uniform(0.0, 255.0, img_a.shape).astype(np.float32)
    img_back = img_at([0.05, 0.02, 0.0])
    verdicts = []
    for be in both_backends(GATE, background=True):
        gate = threading.Event()
        orig_detect = be._detect
        be._detect = lambda kc, orig=orig_detect: (gate.wait(30), orig(kc))[1]
        rng = np.random.default_rng(3)
        rng.uniform(0.0, 255.0, img_a.shape)  # the draw of `garbage` above
        place = make_structured_scene(rng, n=25000)
        for i in range(5):
            be.on_scan(np.eye(3), np.array([0.6 * i, 0.0, 0.0]), place[rng.permutation(len(place))[:12000]],
                       img=img_a)
        place2 = make_structured_scene(np.random.default_rng(50), n=20000, layout_seed=77)
        for i in range(5):
            be.on_scan(np.eye(3), np.array([40.0 + 0.6 * i, 10.0, 0.0]), place2 + 0.0, img=garbage)
        gate.set()
        for p in list(be._pending):
            p[0].result()
        be._poll()
        assert be._frame_imgs and np.array_equal(be._frame_imgs[0], img_a), (
            "STD frame 0 stored a poll-time image, not the submission-time one"
        )
        for i in range(5):
            be.on_scan(np.eye(3), np.array([0.6 * i, 0.2, 0.0]), place[rng.permutation(len(place))[:12000]],
                       img=img_back)
        be.finish()
        assert len(be.loops) >= 1, ("genuine loop rejected", be.rejected_loops)
        verdicts.append((len(be.loops), len(be.rejected_loops)))
    assert verdicts[0] == verdicts[1]
