"""Port parity of the multi-device step: the sharded arena ops, the axis
branches of the LIO step, and the 2-D mesh, on gloo CPU ranks against the
JAX package's `shard_map` over `parallel.make_mesh(W)` at the same W.

Two worlds run here, one per module fixture (W = 4 and W = 2); each runs
all of its cases in one spawn while the parent computes the JAX side.
Integer outputs (owners, occupied keys per shard, counts, slab rows,
validity) must match exactly. Float tolerances, with their reasons:
- surfel moments in the meta rows: rtol 1e-5, the f32 rounding of the
  decay products (as tests/test_torch_voxel_map.py);
- lookup distances 1e-6; normals 1e-5, except in the few voxels whose two
  smallest moment eigenvalues nearly coincide, where the closed-form
  eigenvector differs up to 1e-2 between XLA's fused arithmetic and torch's
  (ROADMAP.md section 3: 1e-2 on under 2% of rows);
- step poses: the JAX package's own sharded-vs-single bounds
  (tests/test_sharded.py:235 and :285, 2.5e-3 and 1e-3 m).

The step is held against JAX with the surfel model (_agreement_case's
surfel inputs, tests/test_sharded.py:271): with point-to-plane the port and
XLA already differ on one device (about 7% of n_effective here, the
ill-conditioned plane fits of ROADMAP.md section 3), so the point-to-plane
sharded step is held against the port's own single-device step instead,
with the JAX package's sharded-vs-single bounds.

The room scans of tests/test_sharded.py are shifted by ROOM_SHIFT: there
the walls at +-6 m lie exactly on 0.12 m downsampling-voxel boundaries,
and jitted XLA divides by the static leaf as a multiply by its reciprocal,
which floors such points into the neighbouring voxel (eager XLA and the
port divide; ROADMAP.md section 3).
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_ranks
from fastlivo_tpu import parallel as jpar
from fastlivo_tpu.maps import voxel_map as JV
from fastlivo_tpu.models import lio as JL
from fastlivo_tpu.models import pipeline as JP
from fastlivo_tpu.models.imu import ImuWindow as JImu
from fastlivo_tpu.state import NavState as JNav
from fastlivo_tpu_torch import convert
from fastlivo_tpu_torch.maps import voxel_map as TV
from fastlivo_tpu_torch.models import lio as TL
from fastlivo_tpu_torch.models import pipeline as TP

torch.set_num_threads(1)

W4 = 4
W2 = 2


# ---------------------------------------------------------------------------
# Inputs (numpy, the same for both packages)
# ---------------------------------------------------------------------------


ROOM_SHIFT = np.array([0.013, 0.021, 0.0])


def room_scan(rng, n, extent=12.0, pose=(0.0, 0.0, 0.0)):
    """Points on 5 faces of a box (tests/test_sharded.py:102), shifted by
    ROOM_SHIFT."""
    per = n // 5
    pts = []
    h = extent / 2
    for face in range(5):
        u = rng.uniform(-h, h, size=(per, 2))
        if face == 0:
            p = np.stack([u[:, 0], u[:, 1], np.full(per, -1.5)], 1)
        else:
            axis, val = [(0, -h), (0, h), (1, -h), (1, h)][face - 1]
            p = np.zeros((per, 3))
            p[:, axis] = val
            p[:, 1 - axis] = u[:, 0]
            p[:, 2] = u[:, 1] + 2
        pts.append(p)
    w = np.concatenate(pts)
    pad = n - len(w)
    if pad:
        w = np.concatenate([w, w[:pad]])
    return (w - np.asarray(pose) + ROOM_SHIFT).astype(np.float32)


def scan_dict(pts, rng):
    n = len(pts)
    return dict(
        pts=pts,
        t_offs=np.sort(rng.uniform(0, 0.1, n)).astype(np.float32),
        mask=np.ones(n, bool),
        imu=dict(
            stamps=np.linspace(0, 0.1, 8).astype(np.float32),
            gyr=np.tile([0.0, 0.0, 0.1], (8, 1)).astype(np.float32),
            acc=np.tile([0.05, 0.0, 9.81], (8, 1)).astype(np.float32),
            mask=np.ones(8, bool),
        ),
        t_end=np.float32(0.1),
        acc_scale=np.float32(1.0),
    )


def jscan(d):
    return JP.ScanInput(
        pts=jnp.asarray(d["pts"]), t_offs=jnp.asarray(d["t_offs"]), mask=jnp.asarray(d["mask"]),
        imu=JImu(**{k: jnp.asarray(v) for k, v in d["imu"].items()}),
        t_end=jnp.asarray(d["t_end"]), acc_scale=jnp.asarray(d["acc_scale"]),
    )


def state0():
    st = JNav.identity()._replace(cov=jnp.eye(18) * 1e-4)
    return {k: np.asarray(v) for k, v in st._asdict().items()}


def step_cfgs(map_kw, lio_kw=None, **kw):
    """The same StepConfig in both packages."""
    lio_kw = lio_kw or {}
    j = JP.StepConfig(map_cfg=JV.VoxelMapConfig(**map_kw), lio_cfg=JL.LioConfig(**lio_kw), **kw)
    t = TP.StepConfig(map_cfg=TV.VoxelMapConfig(**map_kw), lio_cfg=TL.LioConfig(**lio_kw), **kw)
    return j, t


def np_tree(t):
    return {k: np.asarray(v) for k, v in t._asdict().items()}


def map_specs(m, ax="points"):
    return jax.tree.map(lambda x: P() if x.ndim == 0 else P(ax), m)


def shard_rows(d, n_shards, i):
    return convert.split_sharded_map(d, n_shards)[i]


def key_set(keys, occ):
    return set(map(tuple, np.asarray(keys)[np.asarray(occ)].tolist()))


I3 = jnp.eye(3, dtype=jnp.float32)
Z3 = jnp.zeros(3, jnp.float32)

# tests/test_sharded.py:369 (memory partition): the bootstrap case.
PART_MAP = dict(resolution=0.25, capacity=1 << 10, max_points=8)
PART_KW = dict(ds_capacity=2048, imu_window=8, ds_leaf=0.12)
# tests/test_sharded.py:143 (_agreement_case), at W = 4: point-to-plane,
# and the surfel case of :271 (0.5 m voxels, an 8 m room).
AGREE_MAP = dict(resolution=0.25, capacity=1 << 12, max_points=16, nearby_type=18)
SURF_MAP = dict(AGREE_MAP, resolution=0.5)
AGREE_KW = dict(ds_capacity=4096, imu_window=8, ds_leaf=0.12)
SURF_LIO = dict(measurement_model="surfel")
# tests/test_pipeline_sharded.py:118 (reanchor ownership).
RE_MAP = dict(resolution=0.4, capacity=1 << 10, max_points=8, probe_depth=8)


def jax_sharded_run(cfg, scans, st, mesh):
    m = jpar.make_sharded_map(cfg.map_cfg, mesh) if cfg.map_sharded else JV.make_map(cfg.map_cfg)
    m = jpar.make_sharded_bootstrap(mesh, cfg)(m, jpar.shard_scan(jscan(scans[0]), mesh),
                                               JNav(**st), I3, Z3)
    boot = np_tree(m)
    step = jpar.make_sharded_lio_step(mesh, cfg)
    s, steps = JNav(**st), []
    for sc in scans[1:]:
        s, m, info, (wc, wm), summary = step(s, m, jpar.shard_scan(jscan(sc), mesh), I3, Z3)
        steps.append(dict(summary=np.asarray(summary), n_eff=int(info.n_effective),
                          cloud=np.asarray(wc), mask=np.asarray(wm)))
    return dict(boot=boot, map=np_tree(m), state=np_tree(s), steps=steps)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """The W = 4 world: the bootstrap partition, the step in both modes over
    3 scans, the sharded reanchor and the 2 x 2 mesh; then the JAX side."""
    rng = np.random.default_rng(0)
    part_scan = scan_dict(room_scan(rng, 4096), rng)
    rng = np.random.default_rng(42)
    agree_scans = [scan_dict(room_scan(rng, 8192, pose=(0.05 * k, 0.02 * k, 0.0)), rng) for k in range(4)]
    rng = np.random.default_rng(42)
    surf_scans = [scan_dict(room_scan(rng, 8192, extent=8.0, pose=(0.05 * k, 0.02 * k, 0.0)), rng)
                  for k in range(4)]
    st = state0()
    jpart, tpart = step_cfgs(PART_MAP, map_sharded=True, **PART_KW)
    jsh, tsh = step_cfgs(SURF_MAP, SURF_LIO, map_sharded=True, **AGREE_KW)
    jpts, tpts = step_cfgs(dict(SURF_MAP, capacity=SURF_MAP["capacity"] * W4), SURF_LIO, **AGREE_KW)
    _, tp2pl = step_cfgs(AGREE_MAP, map_sharded=True, **AGREE_KW)
    _, tp2pl_1 = step_cfgs(dict(AGREE_MAP, capacity=AGREE_MAP["capacity"] * W4), **AGREE_KW)

    # Reanchor: one point per voxel, then a correction that moves most
    # voxels to another owner.
    rng = np.random.default_rng(42)
    pts = rng.uniform(-6, 6, (512, 3)).astype(np.float32)
    vox = np.unique(np.floor(pts / RE_MAP["resolution"]).astype(np.int32), axis=0)
    re_pts = np.pad(((vox + 0.5) * RE_MAP["resolution"]).astype(np.float32), ((0, 512 - len(vox)), (0, 0)))
    re_mask = np.arange(512) < len(vox)
    th = 0.05
    rot = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]], np.float32)
    trans = np.array([10.3, -7.7, 3.9], np.float32)
    _, tre = step_cfgs(RE_MAP, map_sharded=True, ds_capacity=512, imu_window=8)

    mesh2d_scans = surf_scans[:3]
    world = torch_ranks.World(W4, tmp_path_factory.mktemp("world4"), [
        ("bootstrap_shards", dict(scan=part_scan, state=st, cfg=tpart)),
        ("step_run", dict(scans=surf_scans, state=st, cfg=tsh)),
        ("step_run", dict(scans=surf_scans, state=st, cfg=tpts)),
        ("step_run", dict(scans=agree_scans, state=st, cfg=tp2pl)),
        ("reanchor_run", dict(pts=re_pts, mask=re_mask, map_cfg=tre.map_cfg, step_cfg=tre,
                              rot=rot, trans=trans, chunk=2048)),
        ("step_run", dict(scans=mesh2d_scans, state=st, cfg=tsh, n_hosts=2)),
    ])
    # The JAX side while the ranks run.
    mesh = jpar.make_mesh(W4)
    m = jpar.make_sharded_bootstrap(mesh, jpart)(
        jpar.make_sharded_map(jpart.map_cfg, mesh), jpar.shard_scan(jscan(part_scan), mesh),
        JNav(**st), I3, Z3,
    )
    jax_part = np_tree(m)
    jax_sh = jax_sharded_run(jsh, surf_scans, st, mesh)
    jax_pts = jax_sharded_run(jpts, surf_scans, st, mesh)
    # Point-to-plane against the port's own single-device step; the 2 x 2
    # mesh on an arena of its global capacity (two map shards).
    single = single_device_run(tp2pl_1, agree_scans, st)
    _, t2d = step_cfgs(dict(SURF_MAP, capacity=SURF_MAP["capacity"] * 2), SURF_LIO, **AGREE_KW)
    single2d = single_device_run(t2d, mesh2d_scans, st)
    ranks = world.results()
    part, sh, pts_, p2pl, re, mesh2d = (list(r) for r in zip(*ranks))
    return dict(part=part, sh=sh, pts=pts_, p2pl=p2pl, re=re, mesh2d=mesh2d, single=single,
                single2d=single2d, jax_part=jax_part, jax_sh=jax_sh, jax_pts=jax_pts,
                re_in=dict(pts=re_pts, mask=re_mask, vox=vox, rot=rot, trans=trans))


def single_device_run(cfg, scans, st):
    from fastlivo_tpu_torch.models.imu import ImuWindow
    from fastlivo_tpu_torch.models.pipeline import ScanInput

    def scan(d):
        t = torch.as_tensor
        return ScanInput(pts=t(d["pts"]), t_offs=t(d["t_offs"]), mask=t(d["mask"]),
                         imu=ImuWindow(**{k: t(v) for k, v in d["imu"].items()}),
                         t_end=t(d["t_end"]), acc_scale=t(d["acc_scale"]))

    i3, z3 = torch.eye(3), torch.zeros(3)
    s = convert.nav_state_from_numpy(st, "cpu")
    m = TP.bootstrap_map(TV.make_map(cfg.map_cfg, device="cpu"), scan(scans[0]), s, i3, z3, cfg)
    n_eff = []
    for sc in scans[1:]:
        s, m, info, _, _ = TP.lio_scan_step(s, m, scan(sc), i3, z3, cfg)
        n_eff.append(int(info.n_effective))
    return dict(n_eff=n_eff, pos=s.pos.numpy(), rot=s.rot.numpy(), points=int(m.counts.sum()),
                keys=key_set(m.keys.numpy(), m.occupied.numpy()))


# tests/test_torch_lio.py's room, a map of four scans, the queries one more.
LOOK_MAP = dict(resolution=0.5, capacity=1 << 13, max_points=32, lookup_unique_cap=1024)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """The W = 2 world: the merged surfel lookup and kNN over a two-shard
    arena, and a sharded insert with NaN in its masked padding."""
    import chip_smoke as scene_mod

    scene = scene_mod.Scene(8192, 8, seed=3)
    map_pts = np.concatenate([scene.room_points(8192) for _ in range(4)]).astype(np.float32)
    map_mask = np.ones(len(map_pts), bool)
    map_mask[::17] = False
    queries = (scene.room_points(4096) + np.random.default_rng(4).normal(0, 0.02, (4096, 3))).astype(np.float32)
    nan_pts = np.concatenate([scene.room_points(1024).astype(np.float32), np.full((256, 3), np.nan, np.float32)])
    nan_mask = np.r_[np.ones(1024, bool), np.zeros(256, bool)]
    tcfg, jcfg = TV.VoxelMapConfig(**LOOK_MAP), JV.VoxelMapConfig(**LOOK_MAP)
    look = dict(k=5, max_dist2=25.0, min_points=6.0, planarity_max=0.01)
    world = torch_ranks.World(W2, tmp_path_factory.mktemp("world2"), [
        ("insert_and_lookup", dict(map_pts=map_pts, map_mask=map_mask, queries=queries, map_cfg=tcfg, **look)),
        ("nan_padding_insert", dict(map_pts=map_pts, map_mask=map_mask, pts=nan_pts, mask=nan_mask,
                                    map_cfg=tcfg)),
        ("global_mesh_slice", dict(scan=scan_dict(nan_pts[:1024], np.random.default_rng(5)))),
    ])
    mesh = jpar.make_mesh(W2)
    m0 = jpar.make_sharded_map(jcfg, mesh)
    specs = map_specs(m0)
    ins = jax.jit(jax.shard_map(lambda m, p, k: JV.sharded_insert(m, p, k, jcfg, "points"), mesh=mesh,
                                in_specs=(specs, P(), P()), out_specs=specs, check_vma=False))
    lookup = jax.jit(jax.shard_map(
        lambda m, q: (
            JV.sharded_surfel_lookup(m, q, jcfg, "points", look["min_points"], look["planarity_max"]),
            JV.sharded_knn(m, q, jcfg, "points", k=look["k"], max_dist2=look["max_dist2"]),
        ),
        mesh=mesh, in_specs=(specs, P()), out_specs=P(), check_vma=False,
    ))
    m = ins(m0, jnp.asarray(map_pts), jnp.asarray(map_mask))
    surf, (nbr, d2, valid) = lookup(m, jnp.asarray(queries))
    m_nan = ins(m, jnp.asarray(nan_pts), jnp.asarray(nan_mask))
    ranks = world.results()
    look_r, nan_r, gmesh = (list(r) for r in zip(*ranks))
    return dict(look=look_r, nan=nan_r, gmesh=gmesh, jax_map=np_tree(m), jax_surf=np_tree(surf),
                jax_nbr=np.asarray(nbr), jax_d2=np.asarray(d2), jax_valid=np.asarray(valid),
                jax_nan=np_tree(m_nan), queries=queries)


# ---------------------------------------------------------------------------
# Ownership hash (no ranks needed)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 8])
def test_owner_of_matches_jax(n_shards):
    """Random int32 voxels, negative and product-wrapping coordinates
    included: the same owners as the JAX package, exactly."""
    rng = np.random.default_rng(n_shards)
    vox = np.concatenate([
        rng.integers(-(1 << 22), 1 << 22, (4000, 3)),
        rng.integers(-50, 50, (1000, 3)),
        rng.integers(np.iinfo(np.int32).min, np.iinfo(np.int32).max, (1000, 3), dtype=np.int64),
    ]).astype(np.int32)
    want = np.asarray(JV.owner_of(jnp.asarray(vox), n_shards))
    got = TV.owner_of(torch.as_tensor(vox), n_shards).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() < n_shards


def test_split_and_join_sharded_map_round_trip(world4):
    glob = world4["jax_part"]
    shards = convert.split_sharded_map(glob, W4)
    assert [s["counts"].shape[0] for s in shards] == [PART_MAP["capacity"]] * W4
    back = convert.join_sharded_maps(shards)
    for k in glob:
        np.testing.assert_array_equal(back[k], glob[k])


# ---------------------------------------------------------------------------
# W = 4: insert partition, the step in both modes, reanchor, the 2-D mesh
# ---------------------------------------------------------------------------


def test_sharded_insert_matches_jax_shards(world4):
    """Bootstrap of the memory-partition room scan (tests/test_sharded.py:369):
    each rank's arena is the JAX shard's rows (keys, occupancy, counts, slab
    points and stamps exactly; moments to rtol 1e-5)."""
    for r, got in enumerate(world4["part"]):
        want = shard_rows(world4["jax_part"], W4, r)
        for k in ("counts", "slab", "slab_stamps", "epoch"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"rank {r} {k}")
        gm, wm = got["meta"].reshape(-1, 8), want["meta"].reshape(-1, 8)
        np.testing.assert_array_equal(gm[:, :4], wm[:, :4], err_msg=f"rank {r} keys/stamps")
        np.testing.assert_allclose(gm[:, 4:], wm[:, 4:], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["surf_s2"], want["surf_s2"], rtol=1e-5, atol=1e-6)


def test_sharded_map_memory_is_partitioned(world4):
    """Every occupied voxel lives on the rank that owns it, and the load
    is balanced (tests/test_sharded.py:369)."""
    per = []
    for r, got in enumerate(world4["part"]):
        m = convert.voxel_map_from_numpy(got, "cpu")
        keys = m.keys[m.occupied]
        assert (TV.owner_of(keys, W4) == r).all()
        per.append(int(m.occupied.sum()))
    assert sum(per) > 1000
    assert min(per) > 0.5 * np.mean(per)


@pytest.mark.parametrize("mode", ["sh", "pts"])
def test_sharded_step_matches_jax(world4, mode):
    """Three scans through the sharded surfel step (tests/test_sharded.py:271
    inputs at W = 4), map-sharded ("sh") and points-sharded ("pts"), against
    JAX at the same W: bootstrap key sets per shard exactly equal,
    n_effective within 1%, poses within 1e-3 m / 1e-3 rad (the JAX surfel
    sharded-vs-single bound, tests/test_sharded.py:285), every rank holding
    the same state."""
    ranks, ref = world4[mode], world4[f"jax_{mode}"]
    n_sh = W4 if mode == "sh" else 1
    for r, got in enumerate(ranks):
        want = shard_rows(ref["boot"], n_sh, r if n_sh > 1 else 0)
        gm, wm = got["boot"]["meta"].reshape(-1, 8), want["meta"].reshape(-1, 8)
        assert key_set(gm[:, :3], gm[:, 0] != 1 << 26) == key_set(wm[:, :3], wm[:, 0] != 1 << 26)
        np.testing.assert_array_equal(got["boot"]["counts"], want["counts"])
    for k, want in enumerate(ref["steps"]):
        a = want["n_eff"]
        assert a > 1000
        for got in ranks:
            b = got["steps"][k]["n_eff"]
            assert abs(a - b) <= max(2, a // 100), (k, a, b)
            np.testing.assert_allclose(got["steps"][k]["summary"][0:3], want["summary"][0:3], atol=1e-3)
            np.testing.assert_allclose(got["steps"][k]["summary"][3:7], want["summary"][3:7], atol=1e-3)
    for got in ranks[1:]:
        for key in ("pos", "rot", "cov"):
            np.testing.assert_array_equal(got["state"][key], ranks[0]["state"][key])
    np.testing.assert_allclose(ranks[0]["state"]["rot"], ref["state"]["rot"], atol=1e-3)
    # The world cloud: whole on every rank (map-sharded), or each rank's
    # slice of the downsampled scan, in rank order (points-sharded).
    cloud = [g["steps"][-1]["cloud"] for g in ranks]
    if mode == "sh":
        assert all(c.shape == (AGREE_KW["ds_capacity"], 3) for c in cloud)
    else:
        assert np.concatenate(cloud).shape == ref["steps"][-1]["cloud"].shape


def test_point_to_plane_sharded_step_matches_single_device(world4):
    """The map-sharded point-to-plane step (the merged kNN) against the
    port's single-device step on a W-times arena, with the JAX package's
    bounds (tests/test_sharded.py:206): n_effective within 1% per scan,
    at least 90% of the stored voxels shared, poses within 2.5e-3."""
    single = world4["single"]
    for got in world4["p2pl"]:
        for a, step in zip(single["n_eff"], got["steps"]):
            assert a > 1000 and abs(a - step["n_eff"]) <= max(2, a // 100), (a, step["n_eff"])
        np.testing.assert_allclose(got["state"]["pos"], single["pos"], atol=2.5e-3)
        np.testing.assert_allclose(got["state"]["rot"], single["rot"], atol=2.5e-3)
    keys = set().union(*(key_set(g["map"]["meta"].reshape(-1, 8)[:, :3],
                                 g["map"]["meta"].reshape(-1, 8)[:, 0] != 1 << 26) for g in world4["p2pl"]))
    k1 = single["keys"]
    assert len(k1 & keys) >= 0.90 * len(k1 | keys)


def test_collectives_per_step(world4):
    """What each mode sends per step: points mode sums the innovation every
    iteration; map-sharded merges each lookup and sends no innovation."""
    sh, pts = world4["sh"][0]["collectives"], world4["pts"][0]["collectives"]
    p2pl = world4["p2pl"][0]["collectives"]
    assert sh["pmin"] == sh["psum"] > 0  # surfel: 2 MIN + 2 SUM per lookup
    assert p2pl.get("pmin", 0) == p2pl.get("psum", 0) == 0 and p2pl["all_gather"] > 0  # kNN: gathers
    assert pts["psum"] >= 4 * 3 and pts.get("pmin", 0) == 0
    counts = [g["collectives"] for g in world4["pts"]]
    assert all(c == counts[0] for c in counts)  # every rank ran the same trips


def test_sharded_reanchor_no_ownership_drops(world4):
    """A correction moving most voxels to another owner drops no point: the
    stored multiset is the corrected points, and every occupied key sits on
    its owner (tests/test_pipeline_sharded.py:118)."""
    inp = world4["re_in"]
    vox, rot, trans = inp["vox"], inp["rot"], inp["trans"]
    res = inp["pts"][inp["mask"]]
    new_vox = np.floor((res @ rot.T + trans) / RE_MAP["resolution"]).astype(np.int32)
    moved = TV.owner_of(torch.as_tensor(vox), W4) != TV.owner_of(torch.as_tensor(new_vox), W4)
    assert int(moved.sum()) > len(vox) // 4
    before = sum(int(r["before"]["counts"].sum()) for r in world4["re"])
    assert before == len(vox)
    stored = []
    for r, got in enumerate(world4["re"]):
        m = convert.voxel_map_from_numpy(got["after"], "cpu")
        assert (TV.owner_of(m.keys[m.occupied], W4) == r).all()
        ok = (torch.arange(RE_MAP["max_points"])[None, :] < m.counts[:, None]) & m.occupied[:, None]
        stored.append(m.points[ok].numpy())
        assert int(got["after"]["epoch"]) == int(world4["re"][0]["after"]["epoch"])
    stored = np.concatenate(stored)
    assert len(stored) == before  # zero ownership drops
    want = res @ rot.T + trans
    np.testing.assert_allclose(stored[np.lexsort(stored.T)], want[np.lexsort(want.T)], atol=1e-5)


def test_2d_mesh_matches_single_device(world4):
    """2 x 2 (hosts x points) mesh: the arena over "points", the queries and
    the innovation sum over "hosts"; the surfel step against the port's own
    single-device run with the bounds of tests/test_sharded.py:474-489.
    (Surfel: on this room the port's point-to-plane fits are ill-conditioned
    enough that a query split alone moves n_effective by up to 8% at the
    second scan, as it moves JAX's by 1.1%; the query split itself is exact
    to 1e-7 m on the well-conditioned floor-and-wall scene.)"""
    single = world4["single2d"]
    ranks = world4["mesh2d"]
    n1 = single["n_eff"][-1]
    assert n1 > 1000
    for got in ranks:
        n2 = got["steps"][-1]["n_eff"]
        assert abs(n1 - n2) <= max(5, n1 * 4 // 100)
        np.testing.assert_allclose(got["state"]["pos"], single["pos"], atol=4e-3)
        assert got["steps"][-1]["cloud"].shape == (AGREE_KW["ds_capacity"], 3)
    # The map shards over the inner axis: the two host rows hold replicas.
    p_host0 = sum(int(ranks[r]["map"]["counts"].sum()) for r in (0, 1))
    p_host1 = sum(int(ranks[r]["map"]["counts"].sum()) for r in (2, 3))
    assert p_host0 == p_host1
    assert abs(p_host0 - single["points"]) <= max(4, single["points"] // 100)


# ---------------------------------------------------------------------------
# W = 2: merged lookups, NaN padding
# ---------------------------------------------------------------------------


def test_sharded_lookups_match_jax(world2):
    """The merged surfel lookup and kNN over two shards: validity and
    neighbour validity exactly equal, the same neighbours in the same
    `top_k` order, distances within 1e-6, normals within the ill-conditioned
    bound; both ranks hold the same (replicated) result."""
    r0, r1 = world2["look"]
    for k in ("surf", "nbr", "d2", "valid"):
        a, b = r0[k], r1[k]
        for x, y in (zip(a.values(), b.values()) if isinstance(a, dict) else [(a, b)]):
            np.testing.assert_array_equal(x, y)
    for r, got in enumerate(world2["look"]):
        want = shard_rows(world2["jax_map"], W2, r)
        np.testing.assert_array_equal(got["map"]["counts"], want["counts"])
        np.testing.assert_array_equal(got["map"]["slab"], want["slab"])
    surf, ref = r0["surf"], world2["jax_surf"]
    np.testing.assert_array_equal(surf["valid"], ref["valid"])
    assert surf["valid"].sum() > 1000
    np.testing.assert_allclose(surf["n_pts"], ref["n_pts"], rtol=1e-6)
    err = np.abs(surf["normal"] - ref["normal"]).max(axis=1)
    assert err.max() < 1e-2 and (err > 1e-5).mean() < 0.02, (err.max(), (err > 1e-5).mean())
    np.testing.assert_array_equal(r0["valid"], world2["jax_valid"])
    assert r0["valid"].sum() > 1000
    np.testing.assert_allclose(r0["d2"], world2["jax_d2"], atol=1e-6)
    np.testing.assert_array_equal(r0["nbr"], world2["jax_nbr"])


def test_global_mesh_and_host_local_slice(world2):
    """`make_global_mesh` spans the world in rank order, and
    `host_local_slice` is this rank's contiguous share of a point axis: the
    same rows `shard_scan` gives it over that mesh (1024 points, 512 each)."""
    for r, got in enumerate(world2["gmesh"]):
        assert (got["index"], got["size"]) == (r, W2)
        assert (got["start"], got["stop"]) == (r * 512, (r + 1) * 512)
        assert got["same"]


def test_sharded_insert_with_nan_padding(world2):
    """NaN in the masked padding of a sharded insert: every shard stays
    finite (slab points, moments) and equal to the JAX shard."""
    for r, got in enumerate(world2["nan"]):
        m = convert.voxel_map_from_numpy(got, "cpu")
        ok = (torch.arange(m.points.shape[1])[None, :] < m.counts[:, None]) & m.occupied[:, None]
        assert torch.isfinite(m.points[ok]).all()
        assert torch.isfinite(m.surf_s1).all() and torch.isfinite(m.surf_s2).all()
        want = shard_rows(world2["jax_nan"], W2, r)
        np.testing.assert_array_equal(got["counts"], want["counts"])
        np.testing.assert_array_equal(got["slab"], want["slab"])
