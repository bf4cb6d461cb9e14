"""Port parity: the surfel LIO update (transform, surfel match, innovation,
iterated ESKF) from one shared map.

The map is bootstrapped by the JAX package and carried over with
fastlivo_tpu_torch.convert. Effective counts, validity masks and the
iteration count must match exactly; the posterior agrees to f32 rounding
of the 6x6 reductions over ~1000 points (1e-5 m, 1e-5 rad).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as scene_mod
from fastlivo_tpu.maps import voxel_map as JV
from fastlivo_tpu.models import lio as JL
from fastlivo_tpu.ops import so3 as JSO3
from fastlivo_tpu.ops import voxelize as JX
from fastlivo_tpu.state import NavState as JNav
from fastlivo_tpu_torch import convert
from fastlivo_tpu_torch.maps import voxel_map as TV
from fastlivo_tpu_torch.models import lio as TL
from fastlivo_tpu_torch.models import pipeline as TP
from fastlivo_tpu_torch.ops import voxelize as TX

torch.set_num_threads(1)

JMAP = JV.VoxelMapConfig(resolution=0.5, capacity=1 << 14, max_points=32, lookup_unique_cap=1024)
TMAP = TV.VoxelMapConfig(resolution=0.5, capacity=1 << 14, max_points=32, lookup_unique_cap=1024)
JCFG = JL.LioConfig(measurement_model="surfel")
TCFG = TL.LioConfig(measurement_model="surfel")


@pytest.fixture(scope="module")
def case():
    """A map bootstrapped from three room scans, a new scan from a pose
    7 cm / 0.02 rad off the prior, and both packages' inputs."""
    scene = scene_mod.Scene(8192, 32, seed=3)
    m = JV.make_map(JMAP)
    ins = jax.jit(JV.insert, static_argnames=("cfg",))
    down = jax.jit(JX.voxel_downsample, static_argnames=("leaf", "out_size"))
    origin = scene_mod.pose_at(scene_mod.HALF_DT)
    for _ in range(3):
        w = scene.room_points(8192)
        pts, mask = down(jnp.asarray(w, jnp.float32), jnp.ones(8192, bool), 0.15, 4096)
        m = ins(m, pts, mask, JMAP)
    truth = origin + np.array([0.05, -0.04, 0.02])
    body = scene.room_points(8192) - truth
    ds, ds_mask = TX.voxel_downsample(
        torch.tensor(body, dtype=torch.float32), torch.ones(8192, dtype=torch.bool), 0.15, 4096
    )
    state = scene.initial_state()
    state["rot"] = np.asarray(JSO3.exp(jnp.asarray([0.0, 0.0, 0.02], jnp.float32)))
    return {k: np.asarray(v) for k, v in m._asdict().items()}, state, ds.numpy(), ds_mask.numpy()


def test_transform_and_surfel_match(case):
    mapd, st, ds, mask = case
    rot, pos = st["rot"], st["pos"]
    rot_il = np.asarray(JSO3.exp(jnp.asarray([0.01, 0.0, -0.01], jnp.float32)))
    t_il = np.array([0.02, 0.0, 0.05], np.float32)
    j = JL.transform_to_world(*(jnp.asarray(a) for a in (ds, rot, pos, rot_il, t_il)))
    t = TL.transform_to_world(*(torch.tensor(a) for a in (ds, rot, pos, rot_il, t_il)))
    for g, w in zip(t, j):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-5)
    i3, z3 = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    want = jax.jit(JL.surfel_match, static_argnames=("map_cfg", "cfg", "map_axis"))(
        jnp.asarray(rot), jnp.asarray(pos), jnp.asarray(ds),
        JV.VoxelHashMap(**{k: jnp.asarray(v) for k, v in mapd.items()}),
        jnp.asarray(i3), jnp.asarray(z3), JMAP, JCFG,
    )
    got = TL.surfel_match(
        torch.tensor(rot), torch.tensor(pos), torch.tensor(ds),
        convert.voxel_map_from_numpy(mapd, "cpu"), torch.tensor(i3), torch.tensor(z3), TMAP, TCFG,
    )
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert got.valid.sum() > 500

    hj = JL._innovation_surfel(
        jnp.asarray(rot), jnp.asarray(pos), jnp.asarray(ds), jnp.asarray(mask), want,
        jnp.asarray(i3), jnp.asarray(z3), JCFG,
    )
    ht = TL._innovation_surfel(
        torch.tensor(rot), torch.tensor(pos), torch.tensor(ds), torch.tensor(mask), got,
        torch.tensor(i3), torch.tensor(z3), TCFG,
    )
    assert int(ht[2]) == int(hj[2])  # n_effective
    # 6x6 sums over ~1000 weighted rows (weights ~1e4): relative 1e-4.
    scale = np.abs(np.asarray(hj[0])).max()
    np.testing.assert_allclose(ht[0].numpy(), np.asarray(hj[0]), rtol=1e-4, atol=1e-5 * scale)
    np.testing.assert_allclose(ht[1].numpy(), np.asarray(hj[1]), rtol=1e-4, atol=1e-4 * np.abs(np.asarray(hj[1])).max())


def test_lio_update(case):
    mapd, st, ds, mask = case
    i3, z3 = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    jpost, jinfo, _ = jax.jit(JL.lio_update, static_argnames=("map_cfg", "cfg", "axis_name", "map_axis"))(
        JNav(**{k: jnp.asarray(v) for k, v in st.items()}),
        JV.VoxelHashMap(**{k: jnp.asarray(v) for k, v in mapd.items()}),
        jnp.asarray(ds), jnp.asarray(mask), jnp.asarray(i3), jnp.asarray(z3), JMAP, JCFG,
    )
    tpost, tinfo, _ = TL.lio_update(
        convert.nav_state_from_numpy(st, "cpu"), convert.voxel_map_from_numpy(mapd, "cpu"),
        torch.tensor(ds), torch.tensor(mask), torch.tensor(i3), torch.tensor(z3), TMAP, TCFG,
    )
    assert int(tinfo.iterations) == int(jinfo.iterations) >= 2
    assert bool(tinfo.converged) == bool(jinfo.converged)
    assert abs(int(tinfo.n_effective) - int(jinfo.n_effective)) <= 0.01 * int(jinfo.n_effective)
    np.testing.assert_allclose(tpost.pos.numpy(), np.asarray(jpost.pos), atol=1e-5)
    np.testing.assert_allclose(tpost.rot.numpy(), np.asarray(jpost.rot), atol=1e-5)
    np.testing.assert_allclose(tpost.cov.numpy(), np.asarray(jpost.cov), rtol=1e-3, atol=1e-9)
    # the update moves the estimate toward the true pose
    truth = st["pos"] + [0.05, -0.04, 0.02]
    assert np.linalg.norm(tpost.pos.numpy() - truth) < np.linalg.norm(st["pos"] - truth)


def test_unported_models_raise():
    # Every single-device measurement model is ported; the multi-device
    # forms of the update and the step still raise, for each model.
    for model in ("surfel", "point_to_plane", "vgicp"):
        cfg = TL.LioConfig(measurement_model=model)
        with pytest.raises(NotImplementedError, match="item 14"):
            TL.lio_update(None, None, None, None, None, None, TMAP, cfg, axis_name="x")
        with pytest.raises(NotImplementedError, match="item 14"):
            TL.lio_update(None, None, None, None, None, None, TMAP, cfg, map_axis="x")
        with pytest.raises(NotImplementedError, match="item 14"):
            TP.lio_scan_step(None, None, None, None, None, TP.StepConfig(lio_cfg=cfg), axis_name="x")
        with pytest.raises(NotImplementedError, match="item 14"):
            TP.lio_scan_step(None, None, None, None, None, TP.StepConfig(lio_cfg=cfg, map_sharded=True))
