"""Degenerate inputs through the port's estimation core, held against the
JAX package on the same inputs (the port's counterparts of
tests/test_robustness.py): a fully masked scan, NaN in the masked padding,
an update against an empty map, repeated inserts.

Each case runs the same numpy inputs through both packages and holds the
port to the JAX test's own gates (finite, the prior kept, bounded slabs).
Arenas must match exactly (counts, slab rows, keys). Where an update has
nothing to fit (masked or empty), the posteriors agree to 1e-6 m. With
padding, the update is held to its own unpadded run in each package, to
1e-6 m and its covariance to 1% of the largest entry (the padded rows add
exact zeros, but the 6x6 products block their sums differently at another
row count): the two packages' point-to-plane posteriors are not compared on
this room, whose fits (five neighbours inside one 0.5 m voxel 5 m out) are
ill-conditioned enough that the port and XLA differ by ~1 cm and ~10% of
n_effective on one update (ROADMAP.md section 3;
tests/test_torch_lio_p2pl.py holds them on a well-conditioned scene).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastlivo_tpu.maps import voxel_map as JV
from fastlivo_tpu.models import lio as JL
from fastlivo_tpu.state import NavState as JNav
from fastlivo_tpu_torch import convert
from fastlivo_tpu_torch.maps import voxel_map as TV
from fastlivo_tpu_torch.models import lio as TL

torch.set_num_threads(1)

MAP = dict(resolution=0.5, capacity=1 << 14, max_points=16, nearby_type=6)
JMAP, TMAP = JV.VoxelMapConfig(**MAP), TV.VoxelMapConfig(**MAP)
JLIO, TLIO = JL.LioConfig(max_iteration=4), TL.LioConfig(max_iteration=4)

_jinsert = jax.jit(JV.insert, static_argnames="cfg")
_jupdate = jax.jit(JL.lio_update, static_argnames=("map_cfg", "cfg"))


def _room(rng, n=3000):
    """tests/test_robustness.py:30."""
    pts = []
    per = n // 5
    u = rng.uniform(-5, 5, size=(per, 2))
    pts.append(np.stack([u[:, 0], u[:, 1], np.full(per, -1.3)], axis=1))
    for axis, val in ((0, -5), (0, 5), (1, -5), (1, 5)):
        u = rng.uniform(-5, 5, size=(per, 2))
        w = np.zeros((per, 3))
        w[:, axis] = val
        w[:, (axis + 1) % 2] = u[:, 0]
        w[:, 2] = u[:, 1] + 5
        pts.append(w)
    return np.concatenate(pts).astype(np.float32)


def _prior(pos):
    st = JNav.identity()._replace(pos=jnp.asarray(pos, jnp.float32))
    return {k: np.asarray(v) for k, v in st._asdict().items()}


def _both_maps(pts_list, masks):
    """The same inserts into both packages' arenas: (JAX map, port map)."""
    jm, tm = JV.make_map(JMAP), TV.make_map(TMAP, device="cpu")
    for p, k in zip(pts_list, masks):
        jm = _jinsert(jm, jnp.asarray(p), jnp.asarray(k), JMAP)
        tm = TV.insert(tm, torch.as_tensor(p), torch.as_tensor(k), TMAP)
    return jm, tm


def _both_updates(jm, tm, prior, pts, mask):
    jpost, jinfo, _ = _jupdate(JNav(**{k: jnp.asarray(v) for k, v in prior.items()}), jm,
                               jnp.asarray(pts), jnp.asarray(mask), jnp.eye(3), jnp.zeros(3), JMAP, JLIO)
    tpost, tinfo, _ = TL.lio_update(convert.nav_state_from_numpy(prior, "cpu"), tm, torch.as_tensor(pts),
                                    torch.as_tensor(mask), torch.eye(3), torch.zeros(3), TMAP, TLIO)
    return (jpost, jinfo), (tpost, tinfo)


def _finite_state(st):
    for leaf in st:
        assert torch.isfinite(leaf).all(), "non-finite state leaf"


def _same_arena(tm, jm):
    np.testing.assert_array_equal(tm.counts.numpy(), np.asarray(jm.counts))
    np.testing.assert_array_equal(tm.slab.numpy(), np.asarray(jm.slab))
    np.testing.assert_array_equal(tm.keys.numpy(), np.asarray(jm.keys))


def test_fully_masked_scan_is_noop(rng):
    world = _room(rng)
    jm, tm = _both_maps([world], [np.ones(len(world), bool)])
    _same_arena(tm, jm)
    prior = _prior([0.1, 0.2, 1.0])
    scan = rng.uniform(-4, 4, (512, 3)).astype(np.float32)
    (jpost, jinfo), (tpost, tinfo) = _both_updates(jm, tm, prior, scan, np.zeros(512, bool))
    assert int(tinfo.n_effective) == int(jinfo.n_effective) == 0
    _finite_state(tpost)
    np.testing.assert_allclose(tpost.pos.numpy(), prior["pos"], atol=1e-5)
    np.testing.assert_allclose(tpost.rot.numpy(), prior["rot"], atol=1e-5)
    np.testing.assert_allclose(tpost.pos.numpy(), np.asarray(jpost.pos), atol=1e-6)


def test_nan_in_masked_padding_does_not_poison(rng):
    """NaN in the padding lanes: masked out before any accumulation in the
    update and in the insert (0 * NaN would poison the sums)."""
    world = _room(rng)
    jm, tm = _both_maps([world], [np.ones(len(world), bool)])
    scan_world = _room(np.random.default_rng(5), n=1024)
    pos_t = np.array([0.2, -0.1, 1.1], np.float32)
    body = scan_world - pos_t
    n = len(body)
    pts = np.concatenate([body, np.full((256, 3), np.nan, np.float32)])
    mask = np.r_[np.ones(n, bool), np.zeros(256, bool)]
    prior = _prior(pos_t + 0.03)
    (jpost, jinfo), (tpost, tinfo) = _both_updates(jm, tm, prior, pts, mask)
    (jref, jref_info), (tref, tref_info) = _both_updates(jm, tm, prior, body, np.ones(n, bool))
    for post, info, ref, ref_info in ((tpost, tinfo, tref, tref_info), (jpost, jinfo, jref, jref_info)):
        assert int(info.n_effective) == int(ref_info.n_effective) > 300
        np.testing.assert_allclose(np.asarray(post.pos), np.asarray(ref.pos), atol=1e-6)
        ref_cov = np.asarray(ref.cov)
        np.testing.assert_allclose(np.asarray(post.cov), ref_cov, atol=1e-2 * np.abs(ref_cov).max())
        assert np.linalg.norm(np.asarray(post.pos) - pos_t) < 0.05
    _finite_state(tpost)

    jm2 = _jinsert(jm, jnp.asarray(pts), jnp.asarray(mask), JMAP)
    tm2 = TV.insert(tm, torch.as_tensor(pts), torch.as_tensor(mask), TMAP)
    ok = (torch.arange(TMAP.max_points)[None, :] < tm2.counts[:, None]) & tm2.occupied[:, None]
    assert torch.isfinite(tm2.points[ok]).all(), "NaN leaked into the arena"
    assert torch.isfinite(tm2.surf_s1).all() and torch.isfinite(tm2.surf_s2).all(), "NaN in the moments"
    _same_arena(tm2, jm2)


def test_update_against_empty_map_keeps_prior(rng):
    jm, tm = JV.make_map(JMAP), TV.make_map(TMAP, device="cpu")
    prior = _prior([0.0, 0.0, 1.0])
    scan = rng.uniform(-4, 4, (512, 3)).astype(np.float32)
    (jpost, jinfo), (tpost, tinfo) = _both_updates(jm, tm, prior, scan, np.ones(512, bool))
    assert int(tinfo.n_effective) == int(jinfo.n_effective) == 0
    _finite_state(tpost)
    np.testing.assert_allclose(tpost.pos.numpy(), prior["pos"], atol=1e-5)
    np.testing.assert_allclose(tpost.pos.numpy(), np.asarray(jpost.pos), atol=1e-6)


@pytest.mark.parametrize("repeats", [6])
def test_repeated_insert_bounded(rng, repeats):
    """Re-inserting one scan keeps every slab within max_points, the counts
    sane and the stored points finite; the arenas equal JAX's."""
    pts = _room(rng, n=2000)
    jm, tm = _both_maps([pts] * repeats, [np.ones(2000, bool)] * repeats)
    counts = tm.counts.numpy()
    assert (counts <= TMAP.max_points).all() and (counts >= 0).all()
    assert counts.max() == TMAP.max_points  # the cap was reached, not just approached
    ok = (torch.arange(TMAP.max_points)[None, :] < tm.counts[:, None]) & tm.occupied[:, None]
    assert torch.isfinite(tm.points[ok]).all()
    _same_arena(tm, jm)
