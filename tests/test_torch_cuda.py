"""The CUDA kernels on the card (marked `cuda`; skipped without a GPU).

This file imports neither jax nor the JAX package, so it also runs on a
GPU machine without jax:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

import chip_smoke
import eskf_trip_loop
import knn_maps
from fastlivo_tpu_torch.maps import voxel_map as vm
from fastlivo_tpu_torch.models import imu
from fastlivo_tpu_torch.ops import image
from fastlivo_tpu_torch.ops import pallas_windows as pw
from fastlivo_tpu_torch.ops import patch_sample as ps
from fastlivo_tpu_torch.utils import timing


def _launches(kernel):
    """The kernel wrapper's launch counter (utils.timing)."""
    return timing.counters().get(f"{kernel}.launches", 0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("win", [13, 30, 38])
def test_kernel_matches_plain_and_counts_launches(cuda_device, win):
    rng = np.random.default_rng(win)
    img = torch.as_tensor(rng.uniform(0, 255, (576, 704)).astype(np.float32)).to(cuda_device)
    origins = rng.integers(-60, [700, 560], size=(208, 2)).astype(np.int32)
    origins[:2] = [[-60, -60], [700, 560]]  # clipped on both sides
    o = torch.as_tensor(origins).to(cuda_device)
    before = _launches("extract_windows")
    got = image.extract_windows(img, o, win, 32)
    assert _launches("extract_windows") == before + 1
    want = image.extract_windows(img.cpu(), o.cpu(), win, 32)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_kernel_rejects_noncontiguous(cuda_device):
    img = torch.zeros((64, 80), device=cuda_device)
    starts = torch.zeros((4, 2), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        pw.extract_windows(img.T, starts, 8)


def _cases(device, form, n=208):
    """The form's case on the card, and the same inputs on the CPU."""
    cam, pyr = chip_smoke.patch_sample_frame(device)
    return [
        next(c for c in chip_smoke.patch_sample_cases(levels, cam, n) if c["name"] == form)
        for levels in (pyr, [img.cpu() for img in pyr])
    ]


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["select", "update_L0", "update_L1", "update_L2", "stored"])
def test_patch_sample_matches_plain_and_counts_launches(cuda_device, form):
    # The main-path forms on a rendered frame's padded pyramid, with
    # clamped, out-of-set and non-finite centers among the candidates.
    case, cpu_case = _cases(cuda_device, form)
    before = _launches("patch_sample")
    got = _as_tuple(case["kernel"]())
    assert _launches("patch_sample") == before + 1
    want = _as_tuple(case["plain"]())
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert chip_smoke.same_bits(a, b)
    # Finite centers (rows 8 on) give the CPU plain version's bits too.
    for a, b in zip(got, _as_tuple(cpu_case["kernel"]())):
        assert torch.equal(a[8:].cpu(), b[8:])


@pytest.mark.cuda
def test_patch_sample_levels_equal_per_level_launches(cuda_device):
    case, _ = _cases(cuda_device, "stored")
    pyr, px = case["levels"], case["centers"][0]
    got = ps.patch_sample_levels(pyr, px, 12, chip_smoke.PS_PAD)
    ones = torch.ones(px.shape[0], dtype=torch.int32, device=cuda_device)
    before = _launches("patch_sample")
    for lvl, img in enumerate(pyr):
        one = ps.patch_sample(img, px / (1 << lvl), ones, 12, chip_smoke.PS_PAD, (1,))
        assert chip_smoke.same_bits(got[:, lvl].reshape(px.shape[0], -1), one), lvl
    assert _launches("patch_sample") == before + len(pyr)


class _Frame:
    width, height = 640, 512


def _edge_inputs(device, n, n_levels, grads, seed):
    """A seeded padded pyramid (704x576 halving) and n level-0 centers led
    by the hard cases of `chip_smoke.patch_sample_centers` (windows clamped
    on each side, a stride outside the set, NaN and inf centers); with
    gradients, grad_units holding 0 and NaN among positive values."""
    rng = np.random.default_rng(seed)
    pyr = [
        torch.as_tensor(rng.uniform(0, 255, (576 >> lvl, 704 >> lvl)).astype(np.float32)).to(device)
        for lvl in range(n_levels)
    ]
    c, s = chip_smoke.patch_sample_centers(rng, n, _Frame)
    gu = None
    if grads:
        g = (s * rng.uniform(0.5, 4.0, n)).astype(np.float32)
        g[2:n:7] = 0.0
        g[3:n:11] = np.nan
        gu = torch.as_tensor(g).to(device)
    return pyr, torch.as_tensor(c).to(device), torch.as_tensor(s).to(device), gu


# (N, levels, patch, gradients): N of 0 and 1; N and N * L that fill no
# block or gradient chunk evenly; N = 16,384 (the grid walks several
# passes); L = 1, 2 and 3; the largest lattices (patch 14 with gradients,
# 16 without); an odd patch (one texel per thread, scalar stores); an even
# patch that is no multiple of 4 (a thread's four texels span two rows).
EDGE_CASES = [
    (0, 1, 8, True), (0, 3, 12, False), (1, 1, 8, False), (1, 1, 8, True), (1, 3, 12, False),
    (7, 1, 8, True), (13, 2, 12, False), (209, 3, 12, False), (208, 1, 14, True),
    (208, 1, 16, False), (208, 3, 16, False), (45, 1, 5, True), (45, 2, 7, False),
    (33, 1, 6, False), (33, 3, 6, False), (33, 1, 6, True), (33, 1, 10, True),
    (16384, 1, 8, True), (16384, 1, 8, False), (16384, 3, 12, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("n,n_levels,patch,grads", EDGE_CASES)
def test_patch_sample_edges_match_plain(cuda_device, n, n_levels, patch, grads):
    pyr, c, s, gu = _edge_inputs(cuda_device, n, n_levels, grads, seed=n + 7 * patch + n_levels)
    before = _launches("patch_sample")
    if n_levels == 1:
        got = _as_tuple(ps.patch_sample(pyr[0], c, s, patch, chip_smoke.PS_PAD, grad_units=gu))
        want = _as_tuple(ps.patch_sample_plain(pyr[0], c, s, patch, chip_smoke.PS_PAD, grad_units=gu))
    else:
        got = (ps.patch_sample_levels(pyr, c, patch, chip_smoke.PS_PAD),)
        want = (ps.patch_sample_levels_plain(pyr, c, patch, chip_smoke.PS_PAD),)
    torch.cuda.synchronize()
    assert _launches("patch_sample") == before + (1 if n else 0)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.is_contiguous()
        assert chip_smoke.same_bits(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("grads", [False, True])
def test_patch_sample_replays_in_a_cuda_graph(cuda_device, grads):
    """One call captured in a CUDA graph, then replayed on new centers
    copied into the captured input: the replay equals the plain version
    of the new inputs bit for bit."""
    pyr, c, s, gu = _edge_inputs(cuda_device, 208, 1, grads, seed=3)
    _, c2, _, _ = _edge_inputs(cuda_device, 208, 1, grads, seed=4)

    def call():
        return _as_tuple(ps.patch_sample(pyr[0], c, s, 8, chip_smoke.PS_PAD, grad_units=gu))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = _launches("patch_sample")
    with timing.graph_counts() as launches, torch.cuda.graph(graph):
        out = call()
    # Recorded, not run: the launch goes to the capture's tally.
    assert _launches("patch_sample") == before and dict(launches) == {"patch_sample.launches": 1}
    c.copy_(c2)
    graph.replay()
    want = _as_tuple(ps.patch_sample_plain(pyr[0], c2, s, 8, chip_smoke.PS_PAD, grad_units=gu))
    torch.cuda.synchronize()
    for a, b in zip(out, want):
        assert chip_smoke.same_bits(a, b)


@pytest.mark.cuda
def test_patch_sample_rejects_bad_inputs(cuda_device):
    img = torch.zeros((80, 96), device=cuda_device)
    c = torch.full((4, 2), 40.0, device=cuda_device)
    s = torch.ones(4, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        ps.patch_sample(img.T, c, s, 8, 32)  # not contiguous
    with pytest.raises(ValueError):
        ps.patch_sample(img, c.cpu(), s, 8, 32)  # two devices
    with pytest.raises(ValueError):
        ps.patch_sample(img, c, s.long(), 8, 32)


@pytest.mark.cuda
def test_fit_voxel_planes_card_matches_cpu(cuda_device):
    from fastlivo_tpu_torch.backend import std_loop

    rng = np.random.default_rng(4)
    ground = np.c_[rng.uniform(-20, 20, (30000, 2)), np.zeros(30000)]
    wall = np.c_[np.full(8000, 3.3), rng.uniform(-20, 20, 8000), rng.uniform(0, 6, 8000)]
    cloud = torch.as_tensor(np.concatenate([ground, wall]).astype(np.float32))
    kw = dict(voxel_size=2.0, max_voxels=1024, min_points=10, plane_thresh=0.01)
    ones = torch.ones(len(cloud), dtype=torch.bool)
    cpu = std_loop.fit_voxel_planes(cloud, ones, **kw)
    gpu = std_loop.fit_voxel_planes(cloud.to(cuda_device), ones.to(cuda_device), **kw)
    for k in ("coords", "count", "is_plane", "valid"):
        assert torch.equal(gpu[k].cpu(), cpu[k]), k
    pl = cpu["is_plane"]
    assert int(pl.sum()) > 100
    assert torch.allclose(gpu["center"].cpu()[pl], cpu["center"][pl], atol=1e-5)
    assert torch.allclose(gpu["normal"].cpu()[pl], cpu["normal"][pl], atol=1e-4)


@pytest.mark.cuda
def test_learned_matcher_card_matches_cpu(cuda_device):
    """The committed matcher on a street frame pair: the score map and
    dense descriptors within 1e-3, the keypoints and match set equal."""
    match = chip_smoke.matcher_card_vs_cpu(cuda_device, width=320, height=256)
    assert match["score_max_abs_err"] < 1e-3 and match["desc_max_abs_err"] < 1e-3
    assert match["keypoints_equal"] and match["matches_equal"]


@pytest.mark.cuda
def test_align_trajectory_card_matches_cpu(cuda_device):
    """GNSS initialisation runs its Gauss-Newton on the pipeline's device:
    the card's yaw and lever agree with the CPU's to f32 rounding."""
    from scipy.spatial.transform import Rotation

    from fastlivo_tpu_torch.models import gnss

    rng = np.random.default_rng(4)
    n = 40
    r_we = Rotation.from_euler("z", 0.7).as_matrix()
    lever = np.array([0.2, -0.1, 0.5])
    odo_pos = np.cumsum(rng.normal(0, 0.3, (n, 3)), axis=0) * [1.0, 1.0, 0.1]
    odo_rot = np.stack([Rotation.from_euler("z", 0.05 * i).as_matrix() for i in range(n)])
    gnss_enu = (odo_pos + np.einsum("nij,j->ni", odo_rot, lever)) @ r_we + rng.normal(0, 0.02, (n, 3))
    args = (odo_pos, odo_rot, gnss_enu, np.full(3, 0.02))
    r_gpu, l_gpu = gnss.align_trajectory(*args, device=cuda_device)
    r_cpu, l_cpu = gnss.align_trajectory(*args, device="cpu")
    np.testing.assert_allclose(r_gpu, r_cpu, atol=1e-5)
    np.testing.assert_allclose(l_gpu, l_cpu, atol=1e-4)
    np.testing.assert_allclose(l_cpu, lever, atol=0.05)


@pytest.mark.cuda
def test_training_steps_card_match_cpu(cuda_device):
    """One SuperPoint step (batch 8) and one LightGlue step (3 layers,
    batch 4) on the card against the CPU port from the same init weights
    and batch, to phase 8's tolerance (`chip_smoke.card_vs_cpu_failures`):
    losses within rtol 1e-4; in float32 the gradients together within 1e-4
    relative L2; in float64 every gradient tensor within 1e-4."""
    from fastlivo_tpu_torch import convert
    from fastlivo_tpu_torch.backend import superpoint_lightglue as spl
    from fastlivo_tpu_torch.backend import train_matcher as tm

    ds, _ = tm.build_dataset(4, 0, chunk=8, device="cpu")
    lg_ds = tm.build_lg_dataset(ds, convert.superpoint_from_numpy(spl.init_superpoint(0), device="cpu"))
    cmp = chip_smoke.train_step_card_vs_cpu(cuda_device, ds, lg_ds, 8, 4)
    assert not chip_smoke.card_vs_cpu_failures(cmp), cmp


@pytest.mark.cuda
def test_graphed_training_equals_eager(cuda_device):
    """`train_matcher.fit` replays a CUDA graph after its eager warm-up: 12
    steps of each network against the same steps run eagerly, to phase 8's
    tolerance (`chip_smoke.graph_failures`)."""
    from fastlivo_tpu_torch import convert
    from fastlivo_tpu_torch.backend import superpoint_lightglue as spl
    from fastlivo_tpu_torch.backend import train_matcher as tm

    ds, n_valid = tm.build_dataset(4, 0, chunk=8, device=cuda_device)
    lg_ds = tm.build_lg_dataset(ds, convert.superpoint_from_numpy(spl.init_superpoint(0), device=cuda_device))
    cmp = chip_smoke.graphed_vs_eager(cuda_device, ds, lg_ds, int(n_valid), 8, 4)
    assert not chip_smoke.graph_failures(cmp), cmp


def _imu_tol(kind):
    """chip_smoke.IMU_RTOL for the case's state dtype: the kernel and
    propagate_plain sum each product in another order through up to 127
    chained intervals (float64 near 1e-12 of each output's largest value)."""
    return chip_smoke.IMU_RTOL[chip_smoke.IMU_DTYPES[kind][0]]


@pytest.mark.cuda
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("n_valid", chip_smoke.IMU_VALID)
@pytest.mark.parametrize("kind", sorted(chip_smoke.IMU_DTYPES))
def test_imu_propagate_matches_plain_and_counts_launches(cuda_device, kind, n_valid, bias):
    args = chip_smoke.imu_case(cuda_device, n_valid, kind, bias, seed=n_valid)
    before = _launches("imu_propagate")
    got = imu.propagate(*args)
    assert _launches("imu_propagate") == before + 1
    want = imu.propagate_plain(*args)
    torch.cuda.synchronize()
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        assert a.shape == b.shape and a.dtype == b.dtype and a.device == b.device
    errs = chip_smoke.imu_errors(got, want)
    assert max(errs.values()) <= _imu_tol(kind), errs
    # bg, ba, grav and the stamps are the inputs themselves, as in the plain version.
    assert got[0].bg is args[0].bg and got[0].grav is args[0].grav and got[1].stamps is args[1].stamps
    # Padded slots are exact copies of the last valid one; a window with no
    # interval leaves the covariance as it was, bit for bit.
    poses = got[1]
    for table in (poses.rot, poses.pos, poses.vel):
        assert torch.equal(table[n_valid:], table[n_valid - 1].expand_as(table[n_valid:]))
    if n_valid == 1:
        assert torch.equal(got[0].cov, args[0].cov)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "f64"])
def test_imu_propagate_longest_window(cuda_device, kind):
    """imu.MAX_WINDOW slots, most of them valid: the launch that needs
    more than 48 KB of shared memory (224 KB in float64)."""
    args = chip_smoke.imu_case(cuda_device, imu.MAX_WINDOW - 24, kind, m=imu.MAX_WINDOW)
    got = imu.propagate(*args)
    want = imu.propagate_plain(*args)
    torch.cuda.synchronize()
    errs = chip_smoke.imu_errors(got, want)
    assert max(errs.values()) <= _imu_tol(kind), errs


@pytest.mark.cuda
def test_imu_propagate_replays_in_a_cuda_graph(cuda_device):
    """One propagation captured in a CUDA graph, then replayed on a new
    state and window copied into the captured inputs: the replay equals
    propagate_plain of the new inputs within the kernel's tolerance."""
    args = chip_smoke.imu_case(cuda_device, 21, "f64", seed=3)
    new = chip_smoke.imu_case(cuda_device, 21, "f64", seed=4)

    def call():
        return imu.propagate(*args)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = _launches("imu_propagate")
    with timing.graph_counts() as launches, torch.cuda.graph(graph):
        out = call()
    assert _launches("imu_propagate") == before and dict(launches) == {"imu_propagate.launches": 1}
    for dst, src in zip(args[0] + args[1] + args[2:], new[0] + new[1] + new[2:]):
        dst.copy_(src)
    graph.replay()
    want = imu.propagate_plain(*new)
    torch.cuda.synchronize()
    errs = chip_smoke.imu_errors(out, want)
    assert max(errs.values()) <= _imu_tol("f64"), errs


@pytest.mark.cuda
def test_imu_propagate_rejects_bad_inputs(cuda_device):
    st, win, t_end, sc = chip_smoke.imu_case(cuda_device, 21, "f64")
    bad = [
        (st._replace(cov=st.cov.float()), win, t_end, sc),  # dtype
        (st, win._replace(stamps=win.stamps.float()), t_end, sc),  # window dtypes differ
        (st, win._replace(gyr=win.gyr[:, :2].contiguous()), t_end, sc),  # shape
        (st, win, t_end.reshape(1), sc),  # t_end not 0-d
        (st._replace(rot=st.rot.T), win, t_end, sc),  # not contiguous
        (st, win, t_end.cpu(), sc),  # two devices
    ]
    before = _launches("imu_propagate")
    for args in bad:
        with pytest.raises(ValueError):
            imu.propagate(*args)
    assert _launches("imu_propagate") == before


def _counted(fn):
    """fn()'s result and what it added to the port's counters."""
    before = timing.counters()
    out = fn()
    return out, timing.counter_delta(timing.counters(), before)


@pytest.mark.cuda
def test_photometric_update_graphs_equal_the_eager_loop(cuda_device):
    """The flagship rig's rendered 640x512 room frames (N = 208): the
    update through its level graphs equals the eager trip loop
    (tests/vio_trip_loop.py) bit for bit, posterior, covariance, both
    errors and trips, and so does `vio_update`. The first frame after the
    cache is emptied captures the three levels (each after one warm-up
    trip, one more `patch_sample` launch); two frames of other data
    replay without a capture, counting the trips, flag reads and launches
    the eager loop counts; the launches counted are the `patch_sample`
    kernel runs the device trace records."""
    import vio_trip_loop

    from fastlivo_tpu_torch.models import pipeline as pl
    from fastlivo_tpu_torch.models import vio
    from fastlivo_tpu_torch.state import NavState

    cfg = chip_smoke.flagship_config()
    run = chip_smoke.LivoRun(cfg, chip_smoke.Scene(n_raw=16384, imu_m=32, seed=0), cuda_device)
    inputs = run.make_inputs(6)
    for inp in inputs[:3]:  # the visual map's first points and observations
        run.pair(inp)
    vio._TRIP_GRAPHS.clear()
    for k, inp in enumerate(inputs[3:]):
        cloud, _ = run.lio(inp)
        state_prop, _ = pl._propagate(run.state, inp["vwin"], cfg)
        img = inp["img"]
        pyr = vio.pyramid_padded(img, max(cfg.vio_cfg.levels, cfg.vm_cfg.levels))
        sel, _ = vio.select(state_prop, run.vmap, img, cloud[0], cloud[1], cfg.cam, run.rot_ci, run.z3,
                            cfg.vm_cfg, cfg.vio_cfg, pyr)
        assert sel.pt_pos.shape[0] == 208 and int(sel.valid.sum()) >= 20
        args = (state_prop, sel, img, cfg.cam, run.rot_ci, run.z3, cfg.vio_cfg, pyr)
        (want, w0, w1), want_n = _counted(lambda: vio_trip_loop.loop_photometric_update(*args))
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            (got, g0, g1), got_n = _counted(lambda: vio.photometric_update(*args))
            torch.cuda.synchronize()
        ran = chip_smoke.kernel_runs(prof.key_averages(), chip_smoke.PS_KERNEL_RE)
        assert ran == got_n["patch_sample.launches"], (k, ran, got_n)
        for name in NavState._fields:
            assert chip_smoke.same_bits(getattr(got, name), getattr(want, name)), (k, name)
        assert chip_smoke.same_bits(g0, w0) and chip_smoke.same_bits(g1, w1), k
        trips = want_n["vio.trips"]
        assert trips == want_n["sync.vio_flags"] >= 3 and want_n["patch_sample.launches"] == trips
        captures = 3 if k == 0 else 0
        assert got_n == dict(want_n, **{
            "vio.graph_replays": trips, "patch_sample.launches": trips + captures,
        }, **({"vio.graph_captures": 3} if captures else {})), (k, got_n, want_n)

        post, run.vmap, info = vio.vio_update(state_prop, run.vmap, img, cloud[0], cloud[1], cfg.cam,
                                              run.rot_ci, run.z3, cfg.vm_cfg, cfg.vio_cfg)
        for name in NavState._fields:
            assert chip_smoke.same_bits(getattr(post, name), getattr(want, name)), (k, name)
        assert chip_smoke.same_bits(info.error_before, w0) and chip_smoke.same_bits(info.error_after, w1)
        run.state = post
    assert len(vio._TRIP_GRAPHS) == 1


CELL_RAW = 32768  # the room scans' raw points: 16,384 after the 0.15 m downsampling, the rooms' budget
STREET_RAW = 131072  # 65,536 after it: the street cell's budget (kitti_lio_hdl64)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(eskf_trip_loop.CASES))
def test_lio_update_graphs_equal_the_eager_loop(cuda_device, name):
    """Every measurement model, both dtypes, the GNSS extras and an exit
    at max_iteration, on 16,384-point scans: the update through its trip
    graph equals the eager loop (tests/eskf_trip_loop.py) on the card bit
    for bit, posterior, LioInfo and neighbor cache, in two updates of
    other data. The first update after the cache is emptied captures the
    key's one graph; every trip replays it; the trips, searches and flag
    reads are the loop's. The neighbor cache an update returns is its own
    (the next update leaves it as it was)."""
    _lio_graphs_equal_the_eager_loop(cuda_device, name, CELL_RAW)


@pytest.mark.cuda
def test_lio_update_graph_at_the_street_budget(cuda_device):
    """The street cell's update (float32 point-to-plane) on 65,536-point
    scans, four times the rooms': its own graph key, and the replays equal
    the eager loop bit for bit, as above."""
    _lio_graphs_equal_the_eager_loop(cuda_device, "point_to_plane_f32", STREET_RAW)


@pytest.mark.cuda
@pytest.mark.parametrize("capacity", [1 << 14, 16], ids=["roomy_arena", "arena_too_small"])
def test_insert_counts_match_a_recount(cuda_device, capacity):
    """A LIO step's summary carries the insert's points added, fresh and
    unclaimed voxels, equal to a recount from the arena before and after
    (tests/test_torch_street_cell.py on the card)."""
    import test_torch_street_cell

    added, fresh, unclaimed = test_torch_street_cell.check_insert_counts(cuda_device, capacity)
    assert added > 0 and fresh > 0 and (unclaimed > 0) == (capacity == 16)


def _lio_graphs_equal_the_eager_loop(cuda_device, name, n_raw):
    from fastlivo_tpu_torch.models import lio
    from fastlivo_tpu_torch.state import NavState

    dtype, fields, gnss = eskf_trip_loop.CASES[name]
    cfg = lio.LioConfig(**fields)
    _, updates = eskf_trip_loop.lio_case(cuda_device, dtype, n_raw=n_raw)
    lio._TRIP_GRAPHS.clear()
    kept = None
    for k, upd in enumerate(updates):
        args = (*upd["args"], eskf_trip_loop.MAP_CFG, cfg)
        extras = eskf_trip_loop.gnss_extras(upd["args"][0], upd["truth"]) if gnss else (None, None)
        (want, want_info, want_nbr), want_n = _counted(lambda: eskf_trip_loop.loop_lio_update(*args, *extras))
        (got, got_info, got_nbr), got_n = _counted(lambda: lio.lio_update(*args, *extras))
        torch.cuda.synchronize()
        for field in NavState._fields:
            assert chip_smoke.same_bits(getattr(got, field), getattr(want, field)), (k, field)
        for field in lio.LioInfo._fields:
            a, b = getattr(got_info, field), getattr(want_info, field)
            assert chip_smoke.same_bits(a, b) if a.is_floating_point() else torch.equal(a, b), (k, field)
        assert chip_smoke.same_bits(got_nbr[0], want_nbr[0]) and torch.equal(got_nbr[1], want_nbr[1]), k
        trips = want_n["lio.eskf.trips"]
        assert trips == want_n["sync.eskf_flags"] == int(want_info.iterations) >= 2
        assert int(want_info.n_effective) >= 200, k
        assert got_n == dict(want_n, **{"lio.eskf.graph_replays": trips},
                             **({"lio.eskf.graph_captures": 1} if k == 0 else {})), (k, got_n, want_n)
        if kept is not None:
            assert chip_smoke.same_bits(kept[0][0], kept[1][0]) and torch.equal(kept[0][1], kept[1][1]), k
        kept = got_nbr, tuple(t.clone() for t in got_nbr)
    assert len(lio._TRIP_GRAPHS) == 1


@pytest.mark.cuda
def test_lio_update_extras_are_their_own_graph(cuda_device):
    """An update with GNSS extras captures a graph of its own beside the
    one without them, and each replays its own: both equal the eager loop."""
    from fastlivo_tpu_torch.models import lio

    _, updates = eskf_trip_loop.lio_case(cuda_device, torch.float64, n_raw=CELL_RAW, offsets=eskf_trip_loop.OFFSETS[:1])
    upd = updates[0]
    args = (*upd["args"], eskf_trip_loop.MAP_CFG, lio.LioConfig())
    extras = eskf_trip_loop.gnss_extras(upd["args"][0], upd["truth"])
    lio._TRIP_GRAPHS.clear()
    for ex, captures in (((None, None), 1), (extras, 1), ((None, None), 0), (extras, 0)):
        want, _, _ = eskf_trip_loop.loop_lio_update(*args, *ex)
        (got, _, _), n = _counted(lambda: lio.lio_update(*args, *ex))
        for a, b in zip(got, want):
            assert chip_smoke.same_bits(a, b)
        assert n.get("lio.eskf.graph_captures", 0) == captures, n
        assert n["lio.eskf.graph_replays"] == n["lio.eskf.trips"] >= 2
    assert len(lio._TRIP_GRAPHS) == 2


KNN_DTYPES = {"f32": torch.float32, "f64": torch.float64}


def _bits(ts):
    return [t.view(torch.uint8) for t in ts]


def _knn_equal(got, want):
    """The kernel's (neighbors, d2, valid) equal the plain path's bit for
    bit: the zero points of entries left at inf, inf and finite-over-limit
    d2 included."""
    torch.cuda.synchronize()
    assert [t.shape for t in got] == [t.shape for t in want]
    for name, a, b in zip(("neighbors", "d2", "valid"), _bits(got), _bits(want)):
        bad = (a != b).reshape(a.shape[0], -1).any(dim=1).nonzero()[:5, 0].tolist()
        assert not bad, (name, bad)


def _knn_once(m, q, cfg, k=5, max_dist2=25.0):
    """One `knn` call on the card (asserting one launch) and the plain path."""
    before = _launches("voxel_map.knn")
    got = vm.knn(m, q, cfg, k, max_dist2)
    assert _launches("voxel_map.knn") == before + 1
    return got, vm.knn_plain(m, q, cfg, k, max_dist2)


@pytest.mark.cuda
@pytest.mark.parametrize("max_points", [8, 32])
@pytest.mark.parametrize("nearby_type", [0, 6, 18, 26])
@pytest.mark.parametrize("k,max_dist2", [(5, 25.0), (8, 0.05)])
@pytest.mark.parametrize("dtype", sorted(KNN_DTYPES))
def test_voxel_knn_matches_plain_and_counts_launches(cuda_device, dtype, k, max_dist2, nearby_type, max_points):
    """The tie map (each grid point twice, junk past every slab's count)
    with grid corners, random points, voxel boundaries, empty space and
    non-finite queries (tests/knn_maps.py)."""
    cfg = knn_maps.map_cfg(nearby_type=nearby_type, max_points=max_points)
    m = knn_maps.tie_map(cfg, KNN_DTYPES[dtype], cuda_device)
    got, want = _knn_once(m, knn_maps.queries(KNN_DTYPES[dtype], cuda_device), cfg, k, max_dist2)
    _knn_equal(got, want)
    d2 = want[1]
    assert (d2[:, 1:] == d2[:, :-1]).any() and torch.isinf(d2).any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(KNN_DTYPES))
def test_voxel_knn_at_an_inexact_resolution(cuda_device, dtype):
    """A 0.15 m voxel, whose reciprocal is inexact: the kernel's voxel of
    a query on a boundary is the plain path's (PyTorch divides a CUDA
    tensor by a scalar as a product by its reciprocal)."""
    cfg = knn_maps.map_cfg(resolution=0.15, capacity=1 << 16)
    m = knn_maps.tie_map(cfg, KNN_DTYPES[dtype], cuda_device)
    _knn_equal(*_knn_once(m, knn_maps.queries(KNN_DTYPES[dtype], cuda_device, resolution=0.15), cfg))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(KNN_DTYPES))
def test_voxel_knn_on_an_empty_map(cuda_device, dtype):
    cfg = knn_maps.map_cfg()
    m = vm.make_map(cfg, KNN_DTYPES[dtype], device=cuda_device)
    got, want = _knn_once(m, knn_maps.queries(KNN_DTYPES[dtype], cuda_device), cfg)
    _knn_equal(got, want)
    assert torch.isinf(got[1]).all() and not got[2].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(KNN_DTYPES))
def test_voxel_knn_on_a_street_sized_arena(cuda_device, dtype):
    """65,536 queries (the street cell's budget) on a 2^19-slot arena."""
    m, cfg, q = knn_maps.street(KNN_DTYPES[dtype], cuda_device)
    got, want = _knn_once(m, q, cfg)
    _knn_equal(got, want)
    assert want[2].float().mean() > 0.9


@pytest.mark.cuda
def test_voxel_knn_of_no_queries_launches_nothing(cuda_device):
    cfg = knn_maps.map_cfg()
    m = vm.make_map(cfg, torch.float32, device=cuda_device)
    before = _launches("voxel_map.knn")
    pts, d2, valid = vm.knn(m, torch.zeros((0, 3), device=cuda_device), cfg, k=8)
    assert _launches("voxel_map.knn") == before
    assert pts.shape == (0, 8, 3) and d2.shape == (0, 8) and valid.shape == (0, 8)


@pytest.mark.cuda
def test_voxel_knn_rejects_bad_inputs(cuda_device):
    cfg = knn_maps.map_cfg()
    m = vm.make_map(cfg, torch.float32, device=cuda_device)
    q = torch.zeros((64, 3), device=cuda_device)
    before = _launches("voxel_map.knn")
    bad = [
        (m, torch.zeros((3, 64), device=cuda_device).T, 5),  # not contiguous
        (m._replace(slab=m.slab.cpu()), q, 5),  # mixed devices
        (m._replace(meta=m.meta.double()), q, 5),  # mixed dtypes
        (m, q.half(), 5),
        (m, q, 17),  # k above 16
        (m, q, 0),
    ]
    for mm, qq, k in bad:
        with pytest.raises(ValueError):
            vm.knn(mm, qq, cfg, k=k)
    assert _launches("voxel_map.knn") == before


@pytest.mark.cuda
def test_voxel_knn_device_time_is_read_under_its_range(cuda_device):
    """The benchmark's `knn_device_ms_per_scan` (livobench/profiling.py)
    reads the device time of the kernels launched inside the
    `voxel_map.knn` profiler range: the ctypes launch is one of them."""
    from livobench import profiling

    m, cfg, q = knn_maps.street(torch.float32, cuda_device, n_queries=16384)
    vm.knn(m, q, cfg)
    prof = profiling.Profile(cuda=True, host=True)
    prof.start()
    for _ in range(3):
        # Another op first, as in a scan cycle: the profiler records the
        # first kernel of a profiling run irregularly (dropped, or its range's
        # device-side copy counted into it).
        q.add(0.0)
        vm.knn(m, q, cfg)
    rec = prof.stop(scans=3, frames=0)
    kernel_s = sum(s for name, s in rec["device_ops"] if "knn_kernel" in name)
    assert kernel_s > 0.0, rec
    assert abs(rec["knn_device_s"] - kernel_s) <= 1e-3 * kernel_s, rec


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["point_to_plane_f32", "point_to_plane_f64", "vgicp_neighborhood"])
def test_lio_update_with_the_kernel_equals_the_plain_knn(cuda_device, monkeypatch, name):
    """`lio_update` on 16,384-point scans returns the same posterior,
    LioInfo and neighbor cache with `knn_plain` swapped in; each search
    (and the VGICP source covariances' scratch search, k = 8) is one
    launch."""
    from fastlivo_tpu_torch.models import lio
    from fastlivo_tpu_torch.state import NavState

    dtype, fields, _ = eskf_trip_loop.CASES[name]
    cfg = lio.LioConfig(**fields)
    _, updates = eskf_trip_loop.lio_case(cuda_device, dtype, n_raw=CELL_RAW)
    for upd in updates:
        args = (*upd["args"], eskf_trip_loop.MAP_CFG, cfg)
        (got, got_info, got_nbr), n = _counted(lambda: lio.lio_update(*args))
        got_nbr = tuple(t.clone() for t in got_nbr)
        with monkeypatch.context() as mp:
            mp.setattr(vm, "knn", vm.knn_plain)
            (want, want_info, want_nbr), n_plain = _counted(lambda: lio.lio_update(*args))
        torch.cuda.synchronize()
        for field in NavState._fields:
            assert chip_smoke.same_bits(getattr(got, field), getattr(want, field)), field
        for field in lio.LioInfo._fields:
            a, b = getattr(got_info, field), getattr(want_info, field)
            assert chip_smoke.same_bits(a, b) if a.is_floating_point() else torch.equal(a, b), field
        assert chip_smoke.same_bits(got_nbr[0], want_nbr[0]) and torch.equal(got_nbr[1], want_nbr[1])
        scratch = 1 if cfg.vgicp_source_mode == "neighborhood" and cfg.measurement_model == "vgicp" else 0
        assert n["voxel_map.knn.launches"] == n["lio.eskf.searches"] + scratch >= 2
        assert "voxel_map.knn.launches" not in n_plain and n_plain["lio.eskf.searches"] == n["lio.eskf.searches"]
