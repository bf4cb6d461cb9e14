"""Port parity for the matcher-training path: `init_superpoint` /
`init_lightglue`, the inverse converters and the f16 npz format, the
batched forwards, the clip + Adam + cosine chain (`backend/optim.py`), and
`backend/train_matcher.py` against `examples/train_matcher.py` (imported
from its path, not edited) and the JAX package.

Tolerances:
- init weights, converter round trips: bit for bit;
- the JAX forwards on a port-written f16 npz against the port's forwards on
  the same f16-rounded weights: 1e-4 (f32 convolutions and products in
  another summation order);
- batched against per-image / per-pair calls: B = 1 exact; SuperPoint
  logits within 1e-6 of their largest magnitude (oneDNN sums a batch in
  another order), descriptors and LightGlue outputs within 1e-6;
- the optimizer chain against optax over 5 steps: 1e-7;
- `build_dataset(2, 0, chunk=4)`: images within 1e-3 on all but 1e-4 of the
  pixels and within 0.05 on all (the render tolerance of
  tests/test_torch_image.py: sin/cos of f32 arguments up to ~1e2 differ by
  an ulp between XLA and torch; 13 of 327,680 pixels of seed 0 differ by
  1e-3 to 1.5e-3), detector labels and
  correspondence targets equal on at least 99% of cells (Shi-Tomasi box
  sums and the 3x3 reprojections round in another order), `n_valid` and the
  compaction order equal;
- two training steps of each network replaying JAX's `jax.random` draws:
  losses within rtol 1e-4; weights within 1e-5, except at most 1e-3 of the
  elements, each within 2 lr (Adam's first steps move every weight by about
  lr sign(g), so where |g| is near eps a rounding of g moves the weight by
  up to 2 lr).
"""

import importlib.util
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

import jax
import jax.numpy as jnp
import optax
from fastlivo_tpu.backend import superpoint_lightglue as JSPL
from fastlivo_tpu_torch import convert
from fastlivo_tpu_torch.backend import optim
from fastlivo_tpu_torch.backend import superpoint_lightglue as TSPL
from fastlivo_tpu_torch.backend import train_matcher as TTM

REPO = pathlib.Path(__file__).resolve().parent.parent
torch.set_num_threads(4)


def _example():
    spec = importlib.util.spec_from_file_location("jax_train_matcher", REPO / "examples" / "train_matcher.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JTM = _example()


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _smooth_images(rng, n, h, w):
    img = np.stack([gaussian_filter(rng.uniform(0, 1, (h, w)), 2.0) for _ in range(n)])
    img = (img - img.min()) / (img.max() - img.min())
    return img.astype(np.float32)


@pytest.mark.parametrize("net", ["superpoint", "lightglue"])
def test_init_bit_for_bit(net):
    if net == "superpoint":
        j, t = _np(JSPL.init_superpoint(3)), TSPL.init_superpoint(3)
    else:
        j, t = _np(JSPL.init_lightglue(5, n_layers=2)), TSPL.init_lightglue(5, n_layers=2)
    assert list(j) == list(t)
    for k in j:
        assert j[k].dtype == t[k].dtype and j[k].shape == t[k].shape, k
        assert np.array_equal(j[k], t[k]), k


def test_converters_round_trip_both_ways():
    """numpy -> module -> numpy and module -> numpy -> module, bit for bit,
    with the names that '_' -> '.' would get wrong (final_proj_w, kenc_w,
    matchability_b, l0_self_mlp0_w) and `n_layers` as the JAX int32."""
    sp_np, lg_np = TSPL.init_superpoint(1), TSPL.init_lightglue(2, n_layers=2)
    for to_mod, to_np, d in ((convert.superpoint_from_numpy, convert.superpoint_state_to_numpy, sp_np),
                             (convert.lightglue_from_numpy, convert.lightglue_state_to_numpy, lg_np)):
        mod = to_mod(d, device="cpu")
        back = to_np(mod)
        assert list(back) == list(d)
        for k in d:
            assert back[k].dtype == d[k].dtype and np.array_equal(back[k], d[k]), k
        again = to_mod(back, device="cpu")
        for (ka, a), (kb, b) in zip(mod.state_dict().items(), again.state_dict().items()):
            assert ka == kb and torch.equal(a, b)
    assert {"final_proj.w", "kenc.w", "matchability.b", "l0.self.mlp0.w", "l1.cross.o.b"} <= set(
        convert.lightglue_state_to_numpy(convert.lightglue_from_numpy(lg_np, device="cpu")))
    assert int(back["n_layers"]) == 2 and back["n_layers"].shape == ()


def test_f16_npz_loads_in_the_jax_package(tmp_path):
    """A port-written f16 pair loads through the JAX `load_npz`, the JAX
    matcher reads its depth, and the JAX forwards on it equal the port's
    on the same f16-rounded weights."""
    sp = convert.superpoint_from_numpy(TSPL.init_superpoint(4), device="cpu")
    lg = convert.lightglue_from_numpy(TSPL.init_lightglue(6, n_layers=2), device="cpu")
    sp_path, lg_path = tmp_path / "superpoint_synth.npz", tmp_path / "lightglue_synth.npz"
    TTM.save_f16(str(sp_path), convert.superpoint_state_to_numpy(sp))
    TTM.save_f16(str(lg_path), convert.lightglue_state_to_numpy(lg))
    j_sp, j_lg = JSPL.load_npz(str(sp_path)), JSPL.load_npz(str(lg_path))
    assert JSPL.SuperPointLightGlueMatcher(j_sp, j_lg).n_layers == 2
    raw = np.load(lg_path)
    assert raw["n_layers"].dtype == np.int32 and raw["kenc.w"].dtype == np.float16
    t_sp = convert.superpoint_from_numpy(TSPL.load_npz(str(sp_path)), device="cpu")
    t_lg = convert.lightglue_from_numpy(TSPL.load_npz(str(lg_path)), device="cpu")
    img = _smooth_images(np.random.default_rng(0), 1, 128, 160)[0]
    js, jd = jax.jit(JSPL.superpoint_forward)(j_sp, jnp.asarray(img))
    k0, d0, v0 = JSPL.extract_keypoints(j_sp, jnp.asarray(img), 64)
    k1, d1, v1 = JSPL.extract_keypoints(j_sp, jnp.asarray(np.roll(img, 3, axis=1)), 64)
    jp, jm0, jm1 = JSPL.lightglue_forward(j_lg, k0, d0, v0, k1, d1, v1, jnp.asarray([160.0, 128.0]), n_layers=2)
    with torch.no_grad():
        ts, td = TSPL.superpoint_forward(t_sp, torch.as_tensor(img))
        args = [torch.as_tensor(np.asarray(a)) for a in (k0, d0, v0, k1, d1, v1)]
        tp, tm0, tm1 = TSPL.lightglue_forward(t_lg, *args, torch.tensor([160.0, 128.0]))
    for a, b in ((ts, js), (td, jd), (tp, jp), (tm0, jm0), (tm1, jm1)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)


def test_batched_forwards_equal_unbatched():
    rng = np.random.default_rng(1)
    sp = convert.superpoint_from_numpy(TSPL.init_superpoint(0), device="cpu")
    lg = convert.lightglue_from_numpy(TSPL.init_lightglue(1, n_layers=2), device="cpu")
    imgs = torch.as_tensor(_smooth_images(rng, 3, 64, 80))
    n = 24
    kp = [torch.as_tensor(rng.uniform(0, 80, (3, n, 2)).astype(np.float32)) for _ in range(2)]
    desc = [torch.nn.functional.normalize(torch.as_tensor(rng.normal(size=(3, n, 256)).astype(np.float32)), dim=-1)
            for _ in range(2)]
    valid = [torch.as_tensor(rng.uniform(size=(3, n)) > 0.3) for _ in range(2)]
    valid[1][2] = False  # a pair with no valid keypoint in image 1
    size = torch.tensor([80.0, 64.0])
    with torch.no_grad():
        bl, bd = TSPL.superpoint_logits(sp, imgs)
        one = TSPL.superpoint_logits(sp, imgs[:1])
        bp = TSPL.lightglue_forward(lg, kp[0], desc[0], valid[0], kp[1], desc[1], valid[1], size)
        for i in range(3):
            ul, ud = TSPL.superpoint_logits(sp, imgs[i])
            assert (bl[i] - ul).abs().max() <= 1e-6 * ul.abs().max()
            assert (bd[i] - ud).abs().max() <= 1e-6
            if i == 0:
                assert torch.equal(one[0][0], ul) and torch.equal(one[1][0], ud)
            up = TSPL.lightglue_forward(lg, kp[0][i], desc[0][i], valid[0][i], kp[1][i], desc[1][i],
                                        valid[1][i], size)
            for a, b in zip(bp, up):
                assert (a[i] - b).abs().max() <= 1e-6
    assert bl.shape == (3, 8, 10, 65) and bd.shape == (3, 8, 10, 256) and bp[0].shape == (3, n, n)


def test_optimizer_chain_equals_optax():
    """Five steps of optax.chain(clip_by_global_norm(1), adam(cosine)),
    the clip triggered on the even steps and not on the odd ones."""
    rng = np.random.default_rng(0)
    shapes = [(5, 3), (7,), (2, 2, 4)]
    w = [rng.normal(size=s).astype(np.float32) for s in shapes]
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(optax.cosine_decay_schedule(3e-3, 5)))
    jw = {str(i): jnp.asarray(a) for i, a in enumerate(w)}
    state = opt.init(jw)
    tw = [torch.tensor(a) for a in w]
    topt = optim.ClipAdamCosine(tw, 3e-3, 5)
    for k in range(5):
        g = [rng.normal(size=s).astype(np.float32) * (3.0 if k % 2 == 0 else 0.05) for s in shapes]
        norm = np.sqrt(sum(float(np.sum(a.astype(np.float64) ** 2)) for a in g))
        assert (norm >= 1.0) == (k % 2 == 0)
        upd, state = opt.update({str(i): jnp.asarray(a) for i, a in enumerate(g)}, state)
        jw = optax.apply_updates(jw, upd)
        topt.step([torch.tensor(a) for a in g])
        for i in range(len(shapes)):
            np.testing.assert_allclose(tw[i].numpy(), np.asarray(jw[str(i)]), rtol=0, atol=1e-7)
    assert int(topt.count) == 5
    assert optim.cosine_decay(3e-3, 5, 0) == pytest.approx(3e-3, rel=1e-7)


@pytest.mark.parametrize("min_overlap", [0.35, 0.6])
def test_build_dataset_matches_jax(min_overlap):
    """The default gate keeps all four pairs of seed 0; at 0.6 the second
    is dropped, so the stable compaction moves it last."""
    jds, jnv = JTM.build_dataset(2, 0, min_overlap=min_overlap, chunk=4)
    tds, tnv = TTM.build_dataset(2, 0, min_overlap=min_overlap, chunk=4, device="cpu")
    jds = _np(jds)
    assert int(tnv) == int(np.asarray(jnv)) == (4 if min_overlap < 0.5 else 3)
    ok = tds["ok"].numpy()
    assert np.array_equal(np.argsort(~ok, kind="stable"), [0, 1, 2, 3] if ok.all() else [0, 2, 3, 1])
    for k in ("img0", "img1"):
        err = np.abs(tds[k].numpy() - jds[k])
        assert err.max() <= 0.05 and np.mean(err > 1e-3) <= 1e-4, (k, float(err.max()), np.mean(err > 1e-3))
    for k in ("det0", "det1", "corr01", "corr10"):
        assert tds[k].dtype == torch.int32
        share = np.mean(tds[k].numpy() == jds[k])
        assert share >= 0.99, (k, share)
    good = (jds["corr01"] >= 0) & (tds["corr01"].numpy() >= 0)
    np.testing.assert_allclose(tds["uv1_of0"].numpy()[good], jds["uv1_of0"][good], atol=1e-3)


def _weights_close(t_np, j_np, lr):
    """Weights within 1e-5, but for at most 1e-3 of the elements, each
    within 2 lr; returns the share of such elements."""
    n_all = n_off = 0
    for k, jv in j_np.items():
        if k == "n_layers":
            continue
        diff = np.abs(t_np[k] - jv)
        off = diff > 1e-5
        assert np.all(diff[off] <= 2 * lr * (1 + 1e-3)), (k, float(diff.max()))
        n_all += diff.size
        n_off += int(off.sum())
    assert n_off <= 1e-3 * n_all, (n_off, n_all)
    return n_off / n_all


def test_train_superpoint_replays_jax(monkeypatch):
    """Two steps at batch 1 on 64x80 images (G = 80 cells), the JAX batch
    indices and augmentation draws replayed through the port's sampler."""
    h, w, m, seed, steps, batch = 64, 80, 3, 0, 2, 1
    g_cells = (h // 8) * (w // 8)
    monkeypatch.setattr(JTM, "G", g_cells)
    rng = np.random.default_rng(7)
    ds = {
        "img0": _smooth_images(rng, m, h, w) * 255.0, "img1": _smooth_images(rng, m, h, w) * 255.0,
        "det0": rng.integers(0, 65, (m, g_cells)).astype(np.int32),
        "det1": rng.integers(0, 65, (m, g_cells)).astype(np.int32),
        "corr01": rng.integers(-1, g_cells, (m, g_cells)).astype(np.int32),
        "corr10": rng.integers(-1, g_cells, (m, g_cells)).astype(np.int32),
    }
    j_w, j_losses = JTM.train_superpoint({k: jnp.asarray(v) for k, v in ds.items()}, jnp.asarray(m), steps,
                                         batch, seed)
    # The JAX script's draws (train_matcher.py train_chunk / augment_j).
    draws, key = [], jax.random.PRNGKey(seed + 1)
    for _ in range(steps):
        key, ki, k0, k1 = jax.random.split(key, 4)
        idx = jax.random.randint(ki, (batch,), 0, m)
        augs = []
        for kk in (k0, k1):
            kg, ko, kgam = jax.random.split(kk, 3)
            augs.append(tuple(
                torch.as_tensor(np.asarray(jax.random.uniform(k_, (batch, 1, 1), minval=lo, maxval=hi)))
                for k_, (lo, hi) in zip((kg, ko, kgam), TTM.AUG_RANGES)))
        draws.append(dict(idx=torch.as_tensor(np.asarray(idx)).long(), aug0=torch.stack(augs[0]),
                          aug1=torch.stack(augs[1])))
    sp, t_losses = TTM.train_superpoint({k: torch.as_tensor(v) for k, v in ds.items()}, m, steps, batch, seed,
                                        sampler=lambda i: draws[i])
    np.testing.assert_allclose(t_losses.numpy(), np.asarray(j_losses), rtol=1e-4)
    _weights_close(convert.superpoint_state_to_numpy(sp), _np(j_w), 3e-4)


def _lg_dataset(rng, m, n):
    d = lambda: rng.normal(size=(m, n, 256)).astype(np.float32)
    norm = lambda a: a / np.linalg.norm(a, axis=-1, keepdims=True)
    gt = rng.integers(0, n, (m, n)).astype(np.int32)
    gt[rng.uniform(size=(m, n)) < 0.4] = -1
    return {
        "k0": rng.uniform([0, 0], [320, 256], (m, n, 2)).astype(np.float32), "d0": norm(d()),
        "v0": rng.uniform(size=(m, n)) > 0.15,
        "k1": rng.uniform([0, 0], [320, 256], (m, n, 2)).astype(np.float32), "d1": norm(d()),
        "v1": rng.uniform(size=(m, n)) > 0.15, "gt": gt,
    }


def test_train_lightglue_replays_jax():
    """Two steps at batch 2 with 1 layer and 32 keypoints on a seeded
    synthetic LightGlue dataset, the JAX batch indices replayed."""
    m, n, seed, steps, batch = 5, 32, 0, 2, 2
    lg_ds = _lg_dataset(np.random.default_rng(3), m, n)
    j_w, j_losses = JTM.train_lightglue({k: jnp.asarray(v) for k, v in lg_ds.items()}, jnp.asarray(m), steps,
                                        batch, seed, n_layers=1)
    draws, key = [], jax.random.PRNGKey(seed + 2)
    for _ in range(steps):
        key, ki = jax.random.split(key)
        draws.append(dict(idx=torch.as_tensor(np.asarray(jax.random.randint(ki, (batch,), 0, m))).long()))
    lg, t_losses = TTM.train_lightglue({k: torch.as_tensor(v) for k, v in lg_ds.items()}, m, steps, batch, seed,
                                       n_layers=1, sampler=lambda i: draws[i])
    np.testing.assert_allclose(t_losses.numpy(), np.asarray(j_losses), rtol=1e-4)
    t_np = convert.lightglue_state_to_numpy(lg)
    assert int(t_np["n_layers"]) == int(np.asarray(j_w["n_layers"])) == 1
    _weights_close(t_np, _np(j_w), 4e-4)


def test_cli_tiny_cpu_run_writes_jax_format(tmp_path, monkeypatch):
    """`python -m fastlivo_tpu_torch.backend.train_matcher --device cpu` at a
    tiny recipe writes both npz files in the committed artifacts' format.
    The run is `main` in this process, its dataset rounded up to 4 rendered
    pairs instead of the flags' 32 (`chunk`); a subprocess checks the
    module's command line."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-m", "fastlivo_tpu_torch.backend.train_matcher", "--help"],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "--device {cuda,cpu}" in res.stdout, res.stderr[-2000:]
    build = TTM.build_dataset
    monkeypatch.setattr(TTM, "build_dataset", lambda *a, **kw: build(*a, **{**kw, "chunk": 4}))
    out = tmp_path / "w"
    summary = TTM.main(["--device", "cpu", "--pairs", "2", "--steps-sp", "2", "--steps-lg", "2", "--batch", "2",
                        "--lg-layers", "1", "--out", str(out)])
    assert len(summary["eval"]) == 6 and np.all(np.isfinite(summary["sp_losses"]))
    committed = REPO / "fastlivo_tpu" / "weights"
    for name, depth in (("superpoint_synth.npz", None), ("lightglue_synth.npz", 1)):
        got, ref = np.load(out / name), np.load(committed / name)
        ref_keys = set(ref.files) if depth is None else {
            k for k in ref.files if not k.startswith("l") or k.split(".")[0] == "l0"}
        assert set(got.files) == ref_keys, name
        for k in got.files:
            assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        assert np.all(np.isfinite(np.concatenate([got[k].ravel() for k in got.files if k != "n_layers"])))
    j_lg = JSPL.load_npz(str(out / "lightglue_synth.npz"))
    assert JSPL.SuperPointLightGlueMatcher(JSPL.load_npz(str(out / "superpoint_synth.npz")), j_lg).n_layers == 1
