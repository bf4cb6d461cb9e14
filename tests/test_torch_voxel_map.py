"""Port parity: the voxel-hash map (hashes, probes, dedup, insert, insert
gate, surfel lookup), voxel downsampling and the f32 min-scatter.

Both packages start from the same mid-run map (built by the JAX package,
carried over with fastlivo_tpu_torch.convert). Integer and boolean outputs
— hashes, found/cand slots, unique tables, ranks, counts, stamps, gates —
must match exactly. Float moments are segment sums in the same sorted
order; they are held to rtol 1e-5 (f32 rounding of the decay products).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastlivo_tpu.maps import voxel_map as JV
from fastlivo_tpu.ops import scatter as JS
from fastlivo_tpu.ops import voxelize as JX
from fastlivo_tpu_torch import convert
from fastlivo_tpu_torch.maps import voxel_map as TV
from fastlivo_tpu_torch.ops import scatter as TS
from fastlivo_tpu_torch.ops import voxelize as TX

torch.set_num_threads(1)

# Small arena and slabs: the scans below need several claim rounds and
# overflow the 8-point slabs.
JCFG = JV.VoxelMapConfig(resolution=0.5, capacity=1 << 11, max_points=8, lookup_unique_cap=512)
TCFG = TV.VoxelMapConfig(resolution=0.5, capacity=1 << 11, max_points=8, lookup_unique_cap=512)


def _scan(seed, n=2048, shift=(0.0, 0.0, 0.0)):
    """Points on three planes of a box corner plus noise; some masked."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(-3, 3, (n, 2))
    face = rng.integers(0, 3, n)
    p = np.zeros((n, 3))
    p[face == 0] = np.c_[u[face == 0], np.full((face == 0).sum(), -1.5)]
    p[face == 1] = np.c_[np.full((face == 1).sum(), 2.6), u[face == 1]]
    p[face == 2] = np.c_[u[face == 2, 0], np.full((face == 2).sum(), -2.7), u[face == 2, 1]]
    p += rng.normal(scale=0.01, size=p.shape) + shift
    mask = rng.uniform(size=n) > 0.05
    return p.astype(np.float32), mask


@pytest.fixture(scope="module")
def mid_map():
    """A JAX map after three inserts, as numpy fields."""
    m = JV.make_map(JCFG)
    for k in range(3):
        p, msk = _scan(k, shift=(0.1 * k, 0.0, 0.0))
        m = _insert(m, jnp.asarray(p), jnp.asarray(msk), JCFG)
    return {k: np.asarray(v) for k, v in m._asdict().items()}


_unique = jax.jit(JV.unique_voxels, static_argnames=("cap",))
_gate = jax.jit(JV.slab_insert_gate, static_argnames=("cfg", "filter_size_map"))
_insert = jax.jit(JV.insert, static_argnames=("cfg",))
_lookup = jax.jit(JV.surfel_lookup, static_argnames=("cfg",))
_candidate = jax.jit(JV.surfel_candidate, static_argnames=("cfg",))
_probe = jax.jit(JV.probe_rows, static_argnames=("cfg",))
_downsample = jax.jit(JX.voxel_downsample, static_argnames=("leaf", "out_size"))


def _tmap(d):
    return convert.voxel_map_from_numpy(d, "cpu")


def _jmap(d):
    return JV.VoxelHashMap(**{k: jnp.asarray(v) for k, v in d.items()})


def test_hashes_wrap_like_int32():
    rng = np.random.default_rng(0)
    big = (1 << 21) - 3
    vox = np.concatenate(
        [
            rng.integers(-big, big, (4096, 3)),
            np.array([[big, big, big], [-big, -big, -big], [big, -big, 7], [0, 0, 0]]),
        ]
    ).astype(np.int32)
    for nb in (1 << 8, 1 << 15):
        np.testing.assert_array_equal(
            TV._hash(torch.tensor(vox), nb).numpy(), np.asarray(JV._hash(jnp.asarray(vox), nb))
        )
        np.testing.assert_array_equal(
            TV._hash2(torch.tensor(vox), nb).numpy(), np.asarray(JV._hash2(jnp.asarray(vox), nb))
        )
    assert TV._hash(torch.tensor(vox), 256).dtype == torch.int32


def test_make_map_and_convert_roundtrip(mid_map):
    t = TV.make_map(TCFG, device="cpu")
    j = JV.make_map(JCFG)
    for name in TV.VoxelHashMap._fields:
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)))
    back = convert.voxel_map_to_numpy(_tmap(mid_map))
    for name, v in mid_map.items():
        assert back[name].dtype == v.dtype and back[name].shape == v.shape
        np.testing.assert_array_equal(back[name], v)


def test_probe_rows(mid_map):
    p, _ = _scan(10, n=1024)
    vox = np.asarray(JV.voxel_coord(jnp.asarray(p), 0.5))
    want = _probe(_jmap(mid_map), jnp.asarray(vox), JCFG)
    got = TV.probe_rows(_tmap(mid_map), torch.tensor(vox), TCFG)
    for name in ("found", "cand", "n", "s1", "stamp"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), name)


@pytest.mark.parametrize("cap", [64, 4096])
def test_unique_voxels_and_ranks(cap):
    p, mask = _scan(11, n=2048)
    vox = np.asarray(JV.voxel_coord(jnp.asarray(p), 0.5))
    want = _unique(jnp.asarray(vox), jnp.asarray(mask), cap)
    got = TV.unique_voxels(torch.tensor(vox), torch.from_numpy(mask), cap)
    for name in ("uvox", "uvalid", "inv", "order", "seg"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), name)
    ok = np.random.default_rng(12).uniform(size=2048) > 0.3
    np.testing.assert_array_equal(
        TV._dedup_ranks(got, torch.from_numpy(ok)).numpy(),
        np.asarray(JV._dedup_ranks(want, jnp.asarray(ok))),
    )


def _cmp_maps(got, want):
    exact = ("counts", "slab", "slab_stamps", "epoch")
    for name in exact:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), name)
    gm = got.meta.numpy().reshape(-1, 8)
    wm = np.asarray(want.meta).reshape(-1, 8)
    np.testing.assert_array_equal(gm[:, :4], wm[:, :4])  # keys + LRU stamps
    np.testing.assert_allclose(gm[:, 4:], wm[:, 4:], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.surf_s2.numpy(), np.asarray(want.surf_s2), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fresh", [True, False])
def test_insert(mid_map, fresh):
    base = {k: np.asarray(v) for k, v in JV.make_map(JCFG)._asdict().items()} if fresh else mid_map
    p, mask = _scan(13, shift=(0.3, -0.2, 0.05))
    want = _insert(_jmap(base), jnp.asarray(p), jnp.asarray(mask), JCFG)
    got = TV.insert(_tmap(base), torch.from_numpy(p), torch.from_numpy(mask), TCFG)
    _cmp_maps(got, want)
    assert int(TV.num_occupied(got)) == int(JV.num_occupied(want))
    assert int(TV.num_points(got)) == int(JV.num_points(want))


def test_slab_insert_gate_with_shared_dedup(mid_map):
    p, mask = _scan(14, shift=(0.05, 0.0, 0.0))
    vox = JV.voxel_coord(jnp.asarray(p), 0.5)
    jd = _unique(vox, jnp.asarray(mask), 512)
    td = TV.unique_voxels(torch.from_numpy(np.asarray(vox)), torch.from_numpy(mask), 512)
    want = _gate(_jmap(mid_map), jnp.asarray(p), jnp.asarray(mask), JCFG, 0.3, dedup=jd)
    got = TV.slab_insert_gate(_tmap(mid_map), torch.from_numpy(p), torch.from_numpy(mask), TCFG, 0.3, dedup=td)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the gated insert with the shared dedup, as lio_scan_step runs it
    want_m = _insert(_jmap(mid_map), jnp.asarray(p), want, JCFG, dedup=jd)
    got_m = TV.insert(_tmap(mid_map), torch.from_numpy(p), got, TCFG, dedup=td)
    _cmp_maps(got_m, want_m)


@pytest.mark.parametrize("cap", [0, 512])
def test_surfel_lookup(mid_map, cap):
    # Normals from the closed-form eigh3 of moment covariances: atol 1e-4
    # on unit vectors, 1e-4 m on plane offsets; validity is exact.
    jcfg = JV.VoxelMapConfig(resolution=0.5, capacity=1 << 11, max_points=8, lookup_unique_cap=cap)
    tcfg = TV.VoxelMapConfig(resolution=0.5, capacity=1 << 11, max_points=8, lookup_unique_cap=cap)
    p, _ = _scan(15, n=1024)
    want = _lookup(_jmap(mid_map), jnp.asarray(p), jcfg)
    got = TV.surfel_lookup(_tmap(mid_map), torch.from_numpy(p), tcfg)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert got.valid.sum() > 100
    # A voxel whose two smallest moment eigenvalues nearly coincide has an
    # ill-conditioned smallest eigenvector: there a few normals differ by
    # up to 1e-2 (XLA fuses the closed form with other roundings).
    dn = np.abs(got.normal.numpy() - np.asarray(want.normal)).max(axis=1)
    assert np.mean(dn <= 1e-4) >= 0.98 and dn.max() <= 1e-2
    dd = np.abs(got.d.numpy() - np.asarray(want.d))
    assert np.mean(dd <= 1e-4) >= 0.98 and dd.max() <= 3e-2
    np.testing.assert_allclose(got.n_pts.numpy(), np.asarray(want.n_pts), rtol=1e-5)
    wme = np.asarray(want.min_eig)
    np.testing.assert_array_equal(np.isfinite(got.min_eig.numpy()), np.isfinite(wme))
    fin = np.isfinite(wme)
    np.testing.assert_allclose(got.min_eig.numpy()[fin], wme[fin], rtol=1e-3, atol=1e-6)
    d2_t, slot_t, has_t = TV.surfel_candidate(_tmap(mid_map), torch.from_numpy(p), tcfg)
    d2_j, slot_j, has_j = _candidate(_jmap(mid_map), jnp.asarray(p), jcfg)
    np.testing.assert_array_equal(slot_t.numpy(), np.asarray(slot_j))
    np.testing.assert_array_equal(has_t.numpy(), np.asarray(has_j))


def test_voxel_downsample():
    # Sorted-segment centroid sums in the same order as JAX's scatter-add:
    # masks exact, centroids to f32 rounding (atol 1e-5 m).
    p, mask = _scan(16, n=4096)
    for out_size in (256, 4096):
        want_p, want_m = _downsample(jnp.asarray(p), jnp.asarray(mask), 0.15, out_size)
        got_p, got_m = TX.voxel_downsample(torch.from_numpy(p), torch.from_numpy(mask), 0.15, out_size)
        np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
        np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=0, atol=1e-5)


def test_f32_keys_and_scatter_min():
    rng = np.random.default_rng(17)
    # Normal floats here; subnormals have their own test below.
    x = np.concatenate([rng.normal(size=500) * 1e3, [0.0, -0.0, np.inf, -np.inf, 1e-30]]).astype(np.float32)
    k_t = TS.f32_sort_key(torch.from_numpy(x))
    np.testing.assert_array_equal(k_t.numpy(), np.asarray(JS.f32_sort_key(jnp.asarray(x))))
    np.testing.assert_array_equal(TS.f32_from_key(k_t).numpy(), x + np.float32(0.0))
    idx = rng.integers(-3, 40, x.shape[0]).astype(np.int32)  # out-of-range drops
    vals = x.copy()
    vals[::7] = np.nan
    got = TS.scatter_min_f32(37, torch.from_numpy(idx), torch.from_numpy(vals)).numpy()
    want = np.asarray(JS.scatter_min_f32(37, jnp.asarray(idx), jnp.asarray(vals)))
    np.testing.assert_array_equal(got, want)


def test_f32_keys_flush_subnormals():
    """XLA:CPU flushes f32 subnormals to zero before the bit encoding; the
    port does the same, so every subnormal (either sign, down to the
    smallest) shares zero's key and the keys equal the JAX package's
    exactly. The smallest normals keep their own keys."""
    rng = np.random.default_rng(18)
    tiny = np.finfo(np.float32).tiny
    sub = np.concatenate([
        rng.uniform(-1.0, 1.0, 200) * tiny,
        [1e-45, -1e-45, np.nextafter(tiny, 0), -np.nextafter(tiny, 0), 1e-40, -1e-40],
    ]).astype(np.float32)
    assert np.all(np.abs(sub) < tiny) and np.count_nonzero(sub) == len(sub)
    x = np.concatenate([sub, [tiny, -tiny, 0.0, -0.0, 1.0, -1.0]]).astype(np.float32)
    k_t = TS.f32_sort_key(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(k_t, np.asarray(JS.f32_sort_key(jnp.asarray(x))))
    assert np.all(k_t[: len(sub)] == 0) and np.all(k_t[len(sub) : len(sub) + 2] != 0)
    np.testing.assert_array_equal(TS.f32_from_key(torch.from_numpy(k_t)).numpy()[: len(sub)], 0.0)
    # A subnormal never beats zero in the min-scatter, as in JAX.
    vals = np.array([1e-40, 0.0, -1e-40, 2.0], np.float32)
    idx = np.array([0, 0, 1, 1], np.int32)
    got = TS.scatter_min_f32(2, torch.from_numpy(idx), torch.from_numpy(vals)).numpy()
    np.testing.assert_array_equal(got, np.asarray(JS.scatter_min_f32(2, jnp.asarray(idx), jnp.asarray(vals))))


def test_segment_sum_sorted_drops_tail():
    seg = torch.tensor([0, 0, 2, 2, 2, 3, 5, 5], dtype=torch.int32)
    data = torch.arange(8, dtype=torch.float32)
    np.testing.assert_array_equal(
        TS.segment_sum_sorted(data, seg, 4).numpy(), [1.0, 0.0, 9.0, 5.0]
    )
    np.testing.assert_array_equal(
        TS.segment_sum_sorted(seg, seg, 3).numpy(), [0, 0, 6]
    )
