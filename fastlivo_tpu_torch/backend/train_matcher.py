"""Train the learned loop gate's SuperPoint + LightGlue weights on synthetic
renders (port of examples/train_matcher.py, function for function).

The recipe is the JAX script's. Pairs of views of the textured room
(`io/render`) are rendered with the exact geometry, whose dense
correspondences supervise both networks (the room is convex and seen from
inside: no occlusion).

- SuperPoint (full architecture): a 65-way detector cross-entropy against
  Shi-Tomasi labels of the clean render, plus a symmetric InfoNCE over the
  1/8-resolution descriptor grids of a pair (positives from the geometric
  correspondence), under per-image gain / offset / gamma augmentation.
- LightGlue (`--lg-layers`, default 3): keypoints and descriptors from the
  frozen SuperPoint; the NLL of the dual-softmax assignment at the
  ground-truth pairs (reprojection within 3 px) plus 0.5 x matchability BCE.

Both train with optax's `clip_by_global_norm(1.0)` + Adam + cosine decay
chain (`backend/optim.py`). The dataset stays on the device; the losses
are kept there and read once, after training (no host read inside the step
loops; `n_valid` is read once before them). The weights are written as f16
npz files in the JAX package's format (`convert.*_state_to_numpy`), which
`visual_verify.SuperPointLightGlue` and the JAX package's `load_npz` read.

    python -m fastlivo_tpu_torch.backend.train_matcher --out DIR      # on the GPU
    python -m fastlivo_tpu_torch.backend.train_matcher --device cpu \\
        --pairs 2 --steps-sp 2 --steps-lg 2 --batch 2 --out DIR      # a tiny CPU run
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from fastlivo_tpu_torch import convert
from fastlivo_tpu_torch import device as _device
from fastlivo_tpu_torch.backend import superpoint_lightglue as spl
from fastlivo_tpu_torch.backend.optim import ClipAdamCosine
from fastlivo_tpu_torch.io import render
from fastlivo_tpu_torch.ops import image as img_ops
from fastlivo_tpu_torch.ops.camera import Pinhole

CAM_W, CAM_H = 320, 256
HC, WC = CAM_H // 8, CAM_W // 8
G = HC * WC  # descriptor-grid cells per image
ST_THRESH = 25.0  # Shi-Tomasi score of a labelled detector cell
TAU = 0.1  # InfoNCE temperature
# Brightness augmentation ranges: gain, offset, gamma.
AUG_RANGES = ((0.6, 1.5), (-0.12, 0.12), (0.7, 1.4))
SP_LR, LG_LR = 3e-4, 4e-4  # peak learning rates of the cosine schedules
CHUNK_STEPS = 100  # the JAX script's optimizer steps per dispatch
MAX_KP, GT_PX = 256, 3.0  # LightGlue keypoints per image; GT reprojection radius
EVAL_PAIRS = 6
GRAPH_WARMUP = 3  # eager steps on the card before the step is captured as a CUDA graph


def make_cam() -> Pinhole:
    return Pinhole(width=CAM_W, height=CAM_H, fx=200.0, fy=200.0, cx=160.0, cy=128.0)


def pose_matrices(o, yaw, pitch, roll):
    """World->camera (rcw, pcw) for a camera at `o` looking along
    (yaw, pitch) with in-plane roll."""
    d = np.array([np.cos(pitch) * np.cos(yaw), np.cos(pitch) * np.sin(yaw), np.sin(pitch)])
    up0 = np.array([0.0, 0.0, 1.0])
    right = np.cross(d, up0)
    right = right / (np.linalg.norm(right) + 1e-9)
    down = np.cross(d, right)  # image +y
    c, s = np.cos(roll), np.sin(roll)
    x_cam = c * right + s * down
    y_cam = -s * right + c * down
    r_wc = np.stack([x_cam, y_cam, d], axis=1)  # columns = camera axes
    rcw = r_wc.T.astype(np.float32)
    pcw = (-rcw @ o).astype(np.float32)
    return rcw, pcw


def sample_pose(rng):
    o = np.array([rng.uniform(-4, 4), rng.uniform(-4, 4), rng.uniform(0.5, 4.0)])
    return o, rng.uniform(0, 2 * np.pi), rng.uniform(-0.45, 0.25), rng.uniform(-0.9, 0.9)


def perturb_pose(rng, o, yaw, pitch, roll):
    o1 = o + rng.uniform(-1.2, 1.2, 3)
    o1[2] = np.clip(o1[2], 0.5, 4.0)
    return (
        o1,
        yaw + rng.normal(0, 0.22),
        np.clip(pitch + rng.normal(0, 0.12), -0.5, 0.3),
        roll + rng.uniform(-0.7, 0.7),
    )


def det_labels(img: torch.Tensor) -> torch.Tensor:
    """Per-8x8-cell Shi-Tomasi argmax position (0..63, the first maximum)
    or the dustbin 64: (G,) int32."""
    st = img_ops.shi_tomasi_dense(img)
    st = st.reshape(HC, 8, WC, 8).permute(0, 2, 1, 3).reshape(HC, WC, 64)
    lab = torch.where(st.amax(dim=-1) > ST_THRESH, st.argmax(dim=-1), 64)
    return lab.reshape(-1).to(torch.int32)


def cell_centers(device):
    """(x, y) pixel columns of the descriptor grid's cell centers, (G,) each."""
    cy, cx = np.meshgrid(np.arange(HC) * 8 + 4, np.arange(WC) * 8 + 4, indexing="ij")
    return (torch.as_tensor(cx.reshape(-1), device=device), torch.as_tensor(cy.reshape(-1), device=device))


def corr_targets(hits, valid, rcw_o, pcw_o, centers):
    """For each cell center of this image: the target cell in the other
    image (or -1), the exact reprojected uv, and the correspondence flag."""
    cen_x, cen_y = centers
    hp = hits[cen_y, cen_x]  # (G, 3) world
    ok = valid[cen_y, cen_x]
    p_c = hp @ rcw_o.T + pcw_o
    z_ok = p_c[:, 2] > 0.05
    z = torch.clamp(p_c[:, 2], min=1e-6)
    uv = torch.stack([200.0 * p_c[:, 0] / z + 160.0, 200.0 * p_c[:, 1] / z + 128.0], dim=-1)
    inside = (uv[:, 0] >= 4) & (uv[:, 0] < CAM_W - 4) & (uv[:, 1] >= 4) & (uv[:, 1] < CAM_H - 4)
    # Floor division of floats, as `//` in the JAX script (exact by 8).
    cell = (
        torch.clamp(torch.floor(uv[:, 1] / 8), 0, HC - 1) * WC + torch.clamp(torch.floor(uv[:, 0] / 8), 0, WC - 1)
    ).to(torch.int32)
    good = ok & z_ok & inside
    return torch.where(good, cell, -1).to(torch.int32), uv.to(torch.float32), good


def one_pair(cam, r0, p0, r1, p1, min_overlap, centers):
    """One rendered pair and its supervision: (img0, img1, det0, det1,
    corr01, corr10, uv1_of0, overlap-gate flag)."""
    i0, h0, v0 = render.render_room_hits(cam, r0, p0)
    i1, h1, v1 = render.render_room_hits(cam, r1, p1)
    c01, uv1, m01 = corr_targets(h0, v0, r1, p1, centers)
    c10, _, m10 = corr_targets(h1, v1, r0, p0, centers)
    ok = (m01.to(torch.float32).mean() >= min_overlap) & (m10.to(torch.float32).mean() >= min_overlap)
    return i0, i1, det_labels(i0), det_labels(i1), c01, c10, uv1, ok


def build_dataset(n_pairs, seed, min_overlap=0.35, chunk=32, device=None):
    """Render pairs and their supervision on the device and keep them there.

    Returns (ds, n_valid), ds a dict of device tensors:
      img0/img1 (M, H, W) clean renders in [0, 255]
      det0/det1 (M, G) int32 detector cell labels (0..63 position, 64 none)
      corr01/corr10 (M, G) int32 target cell in the other image (-1 invalid)
      uv1_of0 (M, G, 2) f32 exact reprojection of cell centers (for LG GT)
      ok (M,) bool the overlap gate of each pair in render order
    with the first n_valid rows overlap-valid (a stable compaction), M =
    2 * n_pairs rounded up to `chunk` (the JAX script's oversampling)."""
    dev = _device.resolve(device)
    cam = make_cam()
    rng = np.random.default_rng(seed)
    m = 2 * n_pairs
    m = ((m + chunk - 1) // chunk) * chunk
    poses = []
    for _ in range(m):
        p0 = sample_pose(rng)
        p1 = perturb_pose(rng, *p0)
        poses.append(pose_matrices(*p0) + pose_matrices(*p1))
    rcw0, pcw0, rcw1, pcw1 = (torch.as_tensor(np.stack([p[i] for p in poses])).to(dev) for i in range(4))
    centers = cell_centers(dev)
    rows = [one_pair(cam, rcw0[i], pcw0[i], rcw1[i], pcw1[i], min_overlap, centers) for i in range(m)]
    img0, img1, det0, det1, c01, c10, uv1, ok = (torch.stack(col) for col in zip(*rows))
    # Valid pairs first (stable argsort of the fail flag); training draws
    # indices < n_valid.
    order = torch.argsort((~ok).to(torch.int32), stable=True)
    ds = {
        "img0": img0[order], "img1": img1[order],
        "det0": det0[order], "det1": det1[order],
        "corr01": c01[order], "corr10": c10[order],
        "uv1_of0": uv1[order], "ok": ok,
    }
    return ds, ok.to(torch.int32).sum()


def n_train_steps(steps: int) -> int:
    """The JAX script's step count: whole dispatches of CHUNK_STEPS
    (`steps` below one dispatch runs as one shorter dispatch)."""
    chunk_steps = min(CHUNK_STEPS, max(steps, 1))
    return chunk_steps * max(steps // chunk_steps, 1)


def augment(imgs, aug):
    """Brightness augmentation of [0, 255] renders -> [0, 1]; `aug` stacks
    (gain, offset, gamma), each (batch, 1, 1)."""
    gain, offset, gamma = aug
    x = torch.clamp(imgs / 255.0, 0.0, 1.0) ** gamma
    return torch.clamp(gain * x + offset, 0.0, 1.0)


def superpoint_sampler(n_valid: int, batch: int, seed: int, device) -> Callable[[int], Dict]:
    """Default SuperPoint batch draws from a seeded generator on the device:
    `batch` indices below n_valid, and for each side of the pair (gain,
    offset, gamma) stacked as (3, batch, 1, 1)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def uniform(lo, hi):
        return torch.rand((batch, 1, 1), generator=gen, device=device) * (hi - lo) + lo

    def draw(step):
        idx = torch.randint(0, max(n_valid, 1), (batch,), generator=gen, device=device)
        aug0 = torch.stack([uniform(lo, hi) for lo, hi in AUG_RANGES])
        aug1 = torch.stack([uniform(lo, hi) for lo, hi in AUG_RANGES])
        return dict(idx=idx, aug0=aug0, aug1=aug1)

    return draw


def superpoint_loss(sp, img0, img1, det0, det1, c01, c10):
    """Detector cross-entropy of both images plus the symmetric InfoNCE of
    the pair's descriptor grids; one SuperPoint pass over both sides."""
    b = img0.shape[0]
    logits, d = spl.superpoint_logits(sp, torch.cat([img0, img1]))
    logits = logits.reshape(2, b, -1, 65)  # (side, batch, cell, 65)
    d = d.reshape(2, b, -1, spl.DESC_DIM)

    def det_ce(lg, lab):
        lp = torch.log_softmax(lg, dim=-1)
        return -torch.gather(lp, -1, lab.long()[..., None]).mean()

    def nce(da, db, tgt):
        sim = torch.einsum("bgc,bhc->bgh", da, db) / TAU
        lp = torch.log_softmax(sim, dim=-1)
        ok = tgt >= 0
        pick = torch.gather(lp, -1, torch.clamp(tgt, min=0).long()[..., None])[..., 0]
        return -torch.where(ok, pick, 0.0).sum() / torch.clamp(ok.sum(), min=1)

    l_det = det_ce(logits[0], det0) + det_ce(logits[1], det1)
    l_desc = nce(d[0], d[1], c01) + nce(d[1], d[0], c10)
    return l_det + l_desc


def train_superpoint(ds, n_valid, steps, batch, seed, sampler: Optional[Callable[[int], Dict]] = None):
    """Train SuperPoint from `init_superpoint(seed)` on the device of `ds`.
    `sampler(step)` gives each step's batch (`superpoint_sampler` unless
    injected). Returns (module, losses (steps,) on the device)."""
    dev = ds["img0"].device
    sp = convert.superpoint_from_numpy(spl.init_superpoint(seed), device=dev)
    if sampler is None:
        sampler = superpoint_sampler(int(n_valid), batch, seed + 1, dev)

    def loss_of(b):
        idx = b["idx"]
        return superpoint_loss(
            sp, augment(ds["img0"][idx], b["aug0"]), augment(ds["img1"][idx], b["aug1"]),
            ds["det0"][idx], ds["det1"][idx], ds["corr01"][idx], ds["corr10"][idx],
        )

    return sp, fit(list(sp.parameters()), SP_LR, steps, sampler, loss_of)


def fit(params, lr, steps, draw, loss_of):
    """The optimizer loop of both trainers: each step draws its inputs (a
    dict of tensors), evaluates `loss_of(inputs)` and takes one
    `ClipAdamCosine` step. Returns the losses (steps,) on the device.

    On a CUDA device the loop is host-bound (a LightGlue step is ~1,000
    small kernels), so after GRAPH_WARMUP eager steps (on a side stream, as
    capture requires) one step is captured as a CUDA graph, and each later
    step copies its draws into the graph's input buffers and replays it:
    the same kernels on the same buffers, one launch from the host."""
    opt = ClipAdamCosine(params, lr, steps)
    n = n_train_steps(steps)

    def step(b):
        loss = loss_of(b)
        opt.step(torch.autograd.grad(loss, params))
        return loss.detach()

    if params[0].device.type != "cuda" or n <= GRAPH_WARMUP:
        return torch.stack([step(draw(i)) for i in range(n)])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        losses = [step(draw(i)) for i in range(GRAPH_WARMUP)]
    torch.cuda.current_stream().wait_stream(side)
    static = {k: v.clone() for k, v in draw(GRAPH_WARMUP).items()}
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static_loss = step(static)
    for i in range(GRAPH_WARMUP, n):
        if i > GRAPH_WARMUP:
            for k, v in draw(i).items():
                static[k].copy_(v)
        graph.replay()
        losses.append(static_loss.clone())
    return torch.stack(losses)


def gt_assignment(k0, k1, v0, v1, uv1_flat):
    """Ground-truth partner in image 1 of each keypoint of image 0 (or -1):
    the keypoint nearest its bilinear reprojection, within GT_PX."""
    uv1 = uv1_flat.reshape(HC, WC, 2)
    gx = torch.clamp(k0[:, 0] / 8.0 - 0.5, 0, WC - 1.001)
    gy = torch.clamp(k0[:, 1] / 8.0 - 0.5, 0, HC - 1.001)
    x0 = gx.to(torch.int32)
    y0 = gy.to(torch.int32)
    fx, fy = (gx - x0)[:, None], (gy - y0)[:, None]
    x0, y0 = x0.long(), y0.long()
    x1 = torch.clamp(x0 + 1, max=WC - 1)
    y1 = torch.clamp(y0 + 1, max=HC - 1)
    proj = (
        uv1[y0, x0] * (1 - fx) * (1 - fy)
        + uv1[y0, x1] * fx * (1 - fy)
        + uv1[y1, x0] * (1 - fx) * fy
        + uv1[y1, x1] * fx * fy
    )
    d2 = torch.sum((proj[:, None, :] - k1[None, :, :]) ** 2, dim=-1)
    j = torch.argmin(d2, dim=1)
    ok = (
        (torch.gather(d2, 1, j[:, None])[:, 0] < GT_PX**2)
        & v0 & v1[j]
        & (proj[:, 0] > 0) & (proj[:, 0] < CAM_W)
        & (proj[:, 1] > 0) & (proj[:, 1] < CAM_H)
    )
    return torch.where(ok, j, -1).to(torch.int32)


@torch.no_grad()
def build_lg_dataset(ds, sp):
    """Frozen-SuperPoint keypoints and descriptors and the GT assignment of
    every pair, on the device: dict of (M, K, ...) tensors k0, d0, v0, k1,
    d1, v1, gt."""
    cols = []
    for i in range(ds["img0"].shape[0]):
        i0 = torch.clamp(ds["img0"][i] / 255.0, 0.0, 1.0)
        i1 = torch.clamp(ds["img1"][i] / 255.0, 0.0, 1.0)
        k0, d0, v0 = spl.extract_keypoints(sp, i0, MAX_KP)
        k1, d1, v1 = spl.extract_keypoints(sp, i1, MAX_KP)
        cols.append((k0, d0, v0, k1, d1, v1, gt_assignment(k0, k1, v0, v1, ds["uv1_of0"][i])))
    return dict(zip(("k0", "d0", "v0", "k1", "d1", "v1", "gt"), (torch.stack(c) for c in zip(*cols))))


def lightglue_sampler(n_valid: int, batch: int, seed: int, device) -> Callable[[int], Dict]:
    """Default LightGlue batch draws: `batch` indices below n_valid."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def draw(step):
        return dict(idx=torch.randint(0, max(n_valid, 1), (batch,), generator=gen, device=device))

    return draw


def lightglue_loss(lg, b, size_wh):
    """Mean over the batch's pairs of the assignment NLL at the GT pairs
    plus 0.5 x the matchability BCE of both images."""
    p, m0, m1 = spl.lightglue_forward(lg, b["k0"], b["d0"], b["v0"], b["k1"], b["d1"], b["v1"], size_wh)
    gt = b["gt"].long()
    matched = gt >= 0
    g0 = torch.clamp(gt, min=0)
    pick = torch.gather(p, -1, g0[..., None])[..., 0]
    nll = -torch.where(matched, torch.log(pick + 1e-9), 0.0).sum(-1) / torch.clamp(matched.sum(-1), min=1)
    # matched0: has a GT partner; matched1: is some keypoint's GT partner.
    t0 = matched.to(torch.float32)
    is_tgt = torch.zeros(m1.shape, dtype=torch.float32, device=m1.device).scatter_reduce(
        -1, g0, t0, "amax", include_self=True)

    def bce(m, t, v):
        ll = t * torch.log(m + 1e-9) + (1 - t) * torch.log(1 - m + 1e-9)
        return -torch.where(v, ll, 0.0).sum(-1) / torch.clamp(v.sum(-1), min=1)

    return torch.mean(nll + 0.5 * (bce(m0, t0, b["v0"]) + bce(m1, is_tgt, b["v1"])))


def train_lightglue(lg_ds, n_valid, steps, batch, seed, n_layers=3,
                    sampler: Optional[Callable[[int], Dict]] = None):
    """Train LightGlue from `init_lightglue(seed, n_layers)` on the device
    of `lg_ds`; `sampler` as in `train_superpoint`. Returns (module, losses
    (steps,) on the device)."""
    dev = lg_ds["k0"].device
    lg = convert.lightglue_from_numpy(spl.init_lightglue(seed, n_layers=n_layers), device=dev)
    size_wh = torch.tensor([CAM_W, CAM_H], dtype=torch.float32, device=dev)
    if sampler is None:
        sampler = lightglue_sampler(int(n_valid), batch, seed + 2, dev)

    def loss_of(b):
        return lightglue_loss(lg, {k: v[b["idx"]] for k, v in lg_ds.items()}, size_wh)

    return lg, fit(list(lg.parameters()), LG_LR, steps, sampler, loss_of)


def adversarial_pair(seed=123, device=None):
    """A held-out wide-baseline pair: large in-plane roll + translation +
    strong brightness curve (the regime where patch correlation dies),
    rendered on `device`; NumPy (H, W) images."""
    dev = _device.resolve(device)
    cam = make_cam()
    rng = np.random.default_rng(seed)
    o0 = np.array([0.5, -0.8, 2.0]) + rng.uniform(-1.0, 1.0, 3)
    o0[2] = np.clip(o0[2], 0.8, 3.5)
    yaw0 = rng.uniform(0, 2 * np.pi)
    p0 = (o0, yaw0, rng.uniform(-0.2, 0.0), rng.uniform(-0.3, 0.3))
    p1 = (o0 + np.array([0.9, 0.5, -0.4]) * rng.uniform(0.6, 1.2), yaw0 + 0.18, p0[2] + 0.05, p0[3] + 0.9)
    i0, i1 = (render.render_room(cam, *(torch.as_tensor(a).to(dev) for a in pose_matrices(*p))).cpu().numpy()
              for p in (p0, p1))
    # brightness curve on the second frame
    i1 = 255.0 * np.clip(i1 / 255.0, 0, 1) ** 1.6 * 0.8 + 20.0
    return i0, i1


def evaluate(sp, lg):
    """Learned vs classical match ratio on adversarial held-out pairs, on
    the modules' device: rows (learned ratio, matches, classical ratio,
    matches)."""
    from fastlivo_tpu_torch.backend.visual_verify import OrientedPatchMatcher

    dev = next(sp.parameters()).device
    learned = spl.SuperPointLightGlueMatcher(sp.eval(), lg.eval(), max_keypoints=MAX_KP)
    classical = OrientedPatchMatcher(device=dev)
    rows = []
    for k in range(EVAL_PAIRS):
        i0, i1 = adversarial_pair(seed=1000 + k, device=dev)
        rl = learned.match(i0, i1)
        rc = classical.match(i0, i1)
        rows.append((rl.match_ratio, len(rl.pts1), rc.match_ratio, len(rc.pts1)))
        print(f"[eval {k}] learned ratio={rl.match_ratio:.3f} ({len(rl.pts1)} matches)  "
              f"classical ratio={rc.match_ratio:.3f} ({len(rc.pts1)})", flush=True)
    return rows


def save_f16(path, w):
    """Write a weight dict as an npz: floats as f16, the rest as they are."""
    out = {}
    for k, v in w.items():
        a = np.asarray(v)
        out[k] = a.astype(np.float16) if np.issubdtype(a.dtype, np.floating) else a
    np.savez_compressed(path, **out)
    print(f"wrote {path} ({os.path.getsize(path) / 1e6:.1f} MB)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--pairs", type=int, default=384)
    ap.add_argument("--steps-sp", type=int, default=3000)
    ap.add_argument("--steps-lg", type=int, default=2500)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lg-layers", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="where to train (default: the GPU; raises without one)")
    ap.add_argument("--no-save", action="store_true")
    ap.add_argument("--out", default="matcher_weights",
                    help="directory for superpoint_synth.npz and lightglue_synth.npz")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)

    t0 = time.time()
    print(f"rendering {args.pairs} training pairs on {dev} ...", flush=True)
    ds, n_valid = build_dataset(args.pairs, args.seed, device=dev)
    print(f"rendered in {time.time() - t0:.0f}s; training SuperPoint ...", flush=True)
    sp, sp_losses = train_superpoint(ds, n_valid, args.steps_sp, args.batch, args.seed)
    print("building LightGlue dataset ...", flush=True)
    lg_ds = build_lg_dataset(ds, sp)
    lg, lg_losses = train_lightglue(lg_ds, n_valid, args.steps_lg, max(args.batch // 2, 1), args.seed,
                                    n_layers=args.lg_layers)
    # The first host reads of the run.
    sp_l, lg_l = sp_losses.cpu().numpy(), lg_losses.cpu().numpy()
    print(f"training done in {time.time() - t0:.0f}s", flush=True)
    dust = float((ds["det0"] == 64).float().mean())
    gtfrac = float((lg_ds["gt"] >= 0).float().mean())
    print(
        f"n_valid={int(n_valid)}/{ds['img0'].shape[0]} dustbin={dust:.2f} gt_frac={gtfrac:.2f}\n"
        f"sp loss {sp_l[:5].mean():.4f} -> {sp_l[-50:].mean():.4f}  "
        f"lg loss {lg_l[:5].mean():.4f} -> {lg_l[-50:].mean():.4f}",
        flush=True,
    )
    rows = evaluate(sp, lg)
    if not args.no_save:
        os.makedirs(args.out, exist_ok=True)
        save_f16(os.path.join(args.out, "superpoint_synth.npz"), convert.superpoint_state_to_numpy(sp))
        save_f16(os.path.join(args.out, "lightglue_synth.npz"), convert.lightglue_state_to_numpy(lg))
    print(f"done in {time.time() - t0:.0f}s")
    return dict(n_valid=int(n_valid), sp_losses=sp_l, lg_losses=lg_l, eval=rows)


if __name__ == "__main__":
    main()
