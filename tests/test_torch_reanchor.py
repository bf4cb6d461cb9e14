"""Port parity for loop-corrected map re-anchoring on the three
tests/test_reanchor.py recipes: `vm.reanchor` on the disjoint and the
revisited-voxel segment maps (occupancy, counts, slab stamps and epoch
exact; points within 1e-5), and `LivoPipeline.reanchor_map` after the
street drive with the loop back end (it fires, the epochs stay aligned,
the arena stays populated and finite, and it equals the JAX `vm.reanchor`
of the same arena and corrections). The port skips chunks that hold no
point and counts them into the epoch; the epoch and every field still
match the JAX rebuild, which inserts every chunk."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from fastlivo_tpu.maps import voxel_map as JV
from fastlivo_tpu_torch import convert
from fastlivo_tpu_torch.maps import voxel_map as TV

torch.set_num_threads(2)


def _drifted_map(rng, cfg_kw, n, lo_a, hi_a, lo_b, hi_b):
    a = rng.uniform(lo_a, hi_a, (n, 3)).astype(np.float32)
    b_true = rng.uniform(lo_b, hi_b, (n, 3)).astype(np.float32)
    th = 0.05
    r_drift = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]], np.float32)
    t_drift = np.array([0.8, -0.4, 0.1], np.float32)
    b_drifted = b_true @ r_drift.T + t_drift
    cfg = JV.VoxelMapConfig(**cfg_kw)
    ins = jax.jit(JV.insert, static_argnames="cfg")
    m = JV.make_map(cfg)
    m = ins(m, jnp.asarray(a), jnp.ones(n, bool), cfg)
    m = ins(m, jnp.asarray(b_drifted), jnp.ones(n, bool), cfg)
    r_corr = np.stack([np.eye(3, dtype=np.float32), r_drift.T])
    t_corr = np.stack([np.zeros(3, np.float32), -r_drift.T @ t_drift])
    return m, r_corr, t_corr


@pytest.mark.parametrize(
    "cfg_kw,n,ranges,chunk",
    [
        # test_reanchor_moves_drifted_segment_home (disjoint segments)
        (dict(resolution=0.25, capacity=1 << 14, max_points=16), 2000, (-3.0, 0.5, 1.5, 6.0), 65536),
        # test_reanchor_revisited_voxel_exact (both segments in each voxel)
        (dict(resolution=0.25, capacity=1 << 16, max_points=16), 20000, (-3.0, 3.0, -3.0, 3.0), 65536),
        # the same in small chunks: the epoch advances by one per chunk
        (dict(resolution=0.25, capacity=1 << 16, max_points=16), 20000, (-3.0, 3.0, -3.0, 3.0), 4096),
    ],
)
def test_reanchor_matches_jax(rng, cfg_kw, n, ranges, chunk):
    jm, r_corr, t_corr = _drifted_map(rng, cfg_kw, n, *ranges)
    seg = np.asarray([0, 1], np.int32)
    j2 = jax.jit(JV.reanchor, static_argnames=("cfg", "chunk"))(
        jm, JV.VoxelMapConfig(**cfg_kw), jnp.asarray(seg), jnp.asarray(r_corr),
        jnp.asarray(t_corr), chunk=chunk,
    )
    tm = convert.voxel_map_from_numpy({k: np.asarray(v) for k, v in jm._asdict().items()}, "cpu")
    t2 = TV.reanchor(tm, TV.VoxelMapConfig(**cfg_kw), torch.as_tensor(seg),
                     torch.as_tensor(r_corr), torch.as_tensor(t_corr), chunk=chunk)
    cap, s = cfg_kw["capacity"], cfg_kw["max_points"]
    n_chunks = -(-(cap * s) // chunk)
    assert int(t2.epoch) == int(j2.epoch) == 2 + n_chunks
    assert np.array_equal(t2.occupied.numpy(), np.asarray(j2.occupied))
    assert np.array_equal(t2.keys.numpy(), np.asarray(j2.keys))
    assert np.array_equal(t2.counts.numpy(), np.asarray(j2.counts))
    assert np.array_equal(t2.slab_stamps.numpy(), np.asarray(j2.slab_stamps))
    assert np.array_equal(t2.stamps.numpy(), np.asarray(j2.stamps))
    np.testing.assert_allclose(t2.slab.numpy(), np.asarray(j2.slab), atol=1e-5)
    np.testing.assert_allclose(t2.surf_s2.numpy(), np.asarray(j2.surf_s2), atol=1e-4)
    assert int(TV.num_points(t2)) >= 0.98 * int(JV.num_points(jm))


def test_pipeline_reanchor_matches_jax():
    """test_reanchor.py::test_pipeline_reanchor_smoke through the port
    (street out-and-back with the loop back end, sync detection), then the
    JAX package's `vm.reanchor` on the port's own arena with the same
    epoch segments and corrections: the rebuilt arenas agree as above."""
    from fastlivo_tpu.io import synthetic as JSYN
    from fastlivo_tpu_torch.io.sync import MeasurementSynchronizer as TSync
    from fastlivo_tpu_torch.io.sync import WindowBuilder as TBuilder
    from fastlivo_tpu_torch.models.pipeline import LivoPipeline as TPipe
    from fastlivo_tpu_torch.utils.config import FastLivoConfig as TCfg

    seq = JSYN.generate_street(duration=6.0, seed=4, pts_per_scan=3000)
    cfg = TCfg()
    cfg.lio.max_points = 4096
    cfg.map.capacity = 1 << 14
    cfg.imu.imu_int_frame = 32
    cfg.loop.loop_en = True
    cfg.loop.background = False
    cfg.loop.sub_frame_num = 5
    cfg.loop.skip_near_num = 2
    cfg.loop.corner_thre = 6.0
    cfg.loop.icp_threshold = 0.2
    pipe = TPipe(cfg, device="cpu")
    pipe.initializer.done = True
    pipe.initializer.mean_acc = np.array([0.0, 0.0, 9.81])
    pipe.initializer.mean_gyr = np.zeros(3)
    sync, builder = TSync(img_enabled=False), TBuilder(8192, 32)
    imu_iter = iter(seq.imu)
    pending = next(imu_iter)
    for scan in seq.scans:
        sync.push_lidar(scan)
        while pending is not None and pending.stamp < scan.end_time + 0.05:
            sync.push_imu(pending)
            pending = next(imu_iter, None)
        while (group := sync.next_group()) is not None:
            si, t_abs = builder.build(group)
            pipe.process_scan(si._replace(acc_scale=np.float32(1.0)), t_abs)
    pipe.finish()
    assert len(pipe.loop_backend.loops) >= 1
    assert len(pipe._epoch_stamps) == int(pipe.map.epoch)

    # Capture the arena and the corrections reanchor_map applies.
    before = convert.voxel_map_to_numpy(pipe.map)
    seen = {}
    real = TV.reanchor

    def spy(m, cfg_, seg, rots, trans, chunk=65536):
        seen.update(seg=seg.numpy(), rots=rots.numpy(), trans=trans.numpy())
        return real(m, cfg_, seg, rots, trans, chunk)

    TV.reanchor = spy
    try:
        occ_before = int(TV.num_occupied(pipe.map))
        assert pipe.reanchor_map()
    finally:
        TV.reanchor = real
    assert int(pipe.map.epoch) == len(pipe._epoch_stamps)
    assert int(TV.num_occupied(pipe.map)) > 0.5 * occ_before
    assert bool(torch.all(torch.isfinite(pipe.map.points)))

    jcfg = JV.VoxelMapConfig(resolution=cfg.map.resolution, capacity=cfg.map.capacity,
                             max_points=cfg.map.max_points_per_voxel)
    j2 = jax.jit(JV.reanchor, static_argnames=("cfg", "chunk"))(
        JV.VoxelHashMap(**{k: jnp.asarray(v) for k, v in before.items()}), jcfg,
        jnp.asarray(seen["seg"]), jnp.asarray(seen["rots"]), jnp.asarray(seen["trans"]),
    )
    t2 = pipe.map
    assert int(t2.epoch) == int(j2.epoch)
    assert np.array_equal(t2.occupied.numpy(), np.asarray(j2.occupied))
    assert np.array_equal(t2.counts.numpy(), np.asarray(j2.counts))
    assert np.array_equal(t2.slab_stamps.numpy(), np.asarray(j2.slab_stamps))
    np.testing.assert_allclose(t2.slab.numpy(), np.asarray(j2.slab), atol=1e-5)
