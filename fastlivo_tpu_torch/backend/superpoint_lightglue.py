"""SuperPoint + LightGlue as PyTorch modules (port of
fastlivo_tpu/backend/superpoint_lightglue.py).

The same architectures over the same weights: the SuperPoint VGG encoder
with its detector and descriptor heads, and the LightGlue rotary
self/cross attention stack with the matchability and dual-softmax head.
Convolutions are `F.conv2d` in NCHW ('SAME' is padding 1 for the 3x3
convolutions, 0 for the 1x1 ones); products are `torch.matmul` with the
JAX package's (in, out) weight layout. Weights come from the JAX npz
artifacts (or the JAX package's `init_superpoint`/`init_lightglue` output
as NumPy) through `convert.superpoint_state_from_numpy` /
`convert.lightglue_state_from_numpy`.

Parameter names are the npz keys with '.' replaced by '_' (`conv1a_w`,
`l0_self_q_w`, ...); SuperPoint convolution weights are OIHW.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

DESC_DIM = 256
N_HEADS = 4
N_LAYERS = 9

_CONVS = [
    # name, cin, cout, ksize
    ("conv1a", 1, 64, 3), ("conv1b", 64, 64, 3),
    ("conv2a", 64, 64, 3), ("conv2b", 64, 64, 3),
    ("conv3a", 64, 128, 3), ("conv3b", 128, 128, 3),
    ("conv4a", 128, 128, 3), ("conv4b", 128, 128, 3),
    ("convPa", 128, 256, 3), ("convPb", 256, 65, 1),
    ("convDa", 128, 256, 3), ("convDb", 256, DESC_DIM, 1),
]


class SuperPoint(nn.Module):
    """The SuperPoint encoder and heads; weights are buffers (inference)."""

    def __init__(self):
        super().__init__()
        self.ksize = {}
        for name, cin, cout, k in _CONVS:
            self.register_buffer(f"{name}_w", torch.zeros((cout, cin, k, k)))
            self.register_buffer(f"{name}_b", torch.zeros((cout,)))
            self.ksize[name] = k

    def conv(self, name: str, x: torch.Tensor, relu: bool = True) -> torch.Tensor:
        k = self.ksize[name]
        y = F.conv2d(x, getattr(self, f"{name}_w"), getattr(self, f"{name}_b"), padding=k // 2)
        return F.relu(y) if relu else y

    def forward(self, img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return superpoint_logits(self, img)


def superpoint_logits(sp: SuperPoint, img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """img (H, W) in [0, 1] -> (detector logits (H/8, W/8, 65), dense
    descriptors (H/8, W/8, 256) L2-normalized), channels last as in JAX."""
    c = sp.conv
    x = img[None, None]
    x = c("conv1b", c("conv1a", x))
    x = F.max_pool2d(x, 2, 2)
    x = c("conv2b", c("conv2a", x))
    x = F.max_pool2d(x, 2, 2)
    x = c("conv3b", c("conv3a", x))
    x = F.max_pool2d(x, 2, 2)
    x = c("conv4b", c("conv4a", x))
    logits = c("convPb", c("convPa", x), relu=False)[0].permute(1, 2, 0)
    d = c("convDb", c("convDa", x), relu=False)[0].permute(1, 2, 0)
    d = d * torch.rsqrt(torch.sum(d * d, dim=-1, keepdim=True) + 1e-12)
    return logits, d


def superpoint_forward(sp: SuperPoint, img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """img (H, W) in [0, 1] -> (score map (H, W), dense descriptors
    (H/8, W/8, 256)). H and W must be multiples of 8."""
    logits, d = superpoint_logits(sp, img)
    p = torch.softmax(logits, dim=-1)[..., :64]
    hc, wc = p.shape[0], p.shape[1]
    # Depth-to-space: channel row*8 + col of cell (i, j) is pixel
    # (8i + row, 8j + col).
    scores = p.reshape(hc, wc, 8, 8).permute(0, 2, 1, 3).reshape(hc * 8, wc * 8)
    return scores, d


def _simple_nms(scores: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """Keep local maxima within a (2r+1)^2 window (padded with -inf)."""
    m = F.max_pool2d(scores[None, None], 2 * radius + 1, stride=1, padding=radius)[0, 0]
    return torch.where(scores == m, scores, 0.0)


def extract_keypoints(
    sp: SuperPoint,
    img: torch.Tensor,
    max_keypoints: int = 512,
    score_thresh: float = 0.0005,
    border: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """SuperPoint keypoints: (kpts (K,2) xy, desc (K,256), valid (K,))."""
    h, w = img.shape
    scores, dense_desc = superpoint_forward(sp, img)
    scores = _simple_nms(scores)
    mask = torch.zeros_like(scores)
    mask[border:-border, border:-border] = 1.0
    scores = scores * mask

    # `lax.top_k` order: descending, ties lower index first (a stable sort).
    flat = scores.reshape(-1)
    top, idx = torch.sort(flat, descending=True, stable=True)
    top, idx = top[:max_keypoints], idx[:max_keypoints]
    ys = torch.div(idx, w, rounding_mode="floor").to(torch.float32)
    xs = (idx % w).to(torch.float32)
    kpts = torch.stack([xs, ys], dim=-1)
    valid = top > score_thresh

    # Bilinear-sample dense descriptors at keypoint/8 coords.
    gx = xs / 8.0 - 0.5
    gy = ys / 8.0 - 0.5
    x0 = torch.clamp(torch.floor(gx).to(torch.int32), 0, dense_desc.shape[1] - 2).long()
    y0 = torch.clamp(torch.floor(gy).to(torch.int32), 0, dense_desc.shape[0] - 2).long()
    fx = torch.clamp(gx - x0, 0.0, 1.0)[:, None]
    fy = torch.clamp(gy - y0, 0.0, 1.0)[:, None]
    d00 = dense_desc[y0, x0]
    d01 = dense_desc[y0, x0 + 1]
    d10 = dense_desc[y0 + 1, x0]
    d11 = dense_desc[y0 + 1, x0 + 1]
    desc = d00 * (1 - fx) * (1 - fy) + d01 * fx * (1 - fy) + d10 * (1 - fx) * fy + d11 * fx * fy
    desc = desc * torch.rsqrt(torch.sum(desc * desc, dim=-1, keepdim=True) + 1e-12)
    return kpts, desc, valid


# --------------------------------------------------------------------------
# LightGlue
# --------------------------------------------------------------------------


class LightGlue(nn.Module):
    """The LightGlue stack; weights are buffers in the (in, out) layout."""

    def __init__(self, n_layers: int = N_LAYERS, dim: int = DESC_DIM):
        super().__init__()
        self.n_layers = n_layers
        head_dim = dim // N_HEADS
        self.register_buffer("kenc_w", torch.zeros((2, head_dim // 2)))
        for i in range(n_layers):
            for kind in ("self", "cross"):
                p = f"l{i}_{kind}"
                for nm in ("q", "k", "v", "o"):
                    self.register_buffer(f"{p}_{nm}_w", torch.zeros((dim, dim)))
                    self.register_buffer(f"{p}_{nm}_b", torch.zeros((dim,)))
                self.register_buffer(f"{p}_mlp0_w", torch.zeros((2 * dim, 2 * dim)))
                self.register_buffer(f"{p}_mlp0_b", torch.zeros((2 * dim,)))
                self.register_buffer(f"{p}_mlp1_w", torch.zeros((2 * dim, dim)))
                self.register_buffer(f"{p}_mlp1_b", torch.zeros((dim,)))
        self.register_buffer("matchability_w", torch.zeros((dim, 1)))
        self.register_buffer("matchability_b", torch.zeros((1,)))
        self.register_buffer("final_proj_w", torch.zeros((dim, dim)))
        self.register_buffer("final_proj_b", torch.zeros((dim,)))

    def block(self, prefix: str) -> Dict[str, torch.Tensor]:
        n = len(prefix) + 1
        return {k[n:]: v for k, v in self.named_buffers() if k.startswith(prefix + "_")}

    def forward(self, kpts0, desc0, valid0, kpts1, desc1, valid1, size_wh):
        return lightglue_forward(self, kpts0, desc0, valid0, kpts1, desc1, valid1, size_wh)


def _rotary(kpts: torch.Tensor, wenc: torch.Tensor, size_wh: torch.Tensor) -> torch.Tensor:
    """Rotary frequencies from normalized keypoint coords: (N, hd/2)."""
    p = (kpts - size_wh / 2.0) / size_wh.max()
    return p @ wenc


def _apply_rot(x: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """x (N, H, hd) rotated on its interleaved pairs by theta (N, hd/2)."""
    c, s = torch.cos(theta), torch.sin(theta)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    y1 = x1 * c[:, None, :] - x2 * s[:, None, :]
    y2 = x1 * s[:, None, :] + x2 * c[:, None, :]
    return torch.stack([y1, y2], dim=-1).reshape(x.shape)


def _attention(wp, x_q, x_kv, mask_q, mask_kv, theta_q=None, theta_kv=None):
    """Multi-head attention block with LightGlue's message-MLP update."""
    n, d = x_q.shape
    hd = d // N_HEADS

    def split(t):
        return t.reshape(-1, N_HEADS, hd)

    q = split(x_q @ wp["q_w"] + wp["q_b"])
    k = split(x_kv @ wp["k_w"] + wp["k_b"])
    v = split(x_kv @ wp["v_w"] + wp["v_b"])
    if theta_q is not None:
        q = _apply_rot(q, theta_q)
        k = _apply_rot(k, theta_kv)
    att = torch.einsum("nhd,mhd->hnm", q, k) / math.sqrt(hd)
    att = torch.where(mask_kv[None, None, :], att, -1e9)
    att = torch.softmax(att, dim=-1)
    msg = torch.einsum("hnm,mhd->nhd", att, v).reshape(n, d)
    msg = msg @ wp["o_w"] + wp["o_b"]
    y = torch.cat([x_q, msg], dim=-1)
    y = F.gelu(y @ wp["mlp0_w"] + wp["mlp0_b"], approximate="tanh")
    y = y @ wp["mlp1_w"] + wp["mlp1_b"]
    return torch.where(mask_q[:, None], x_q + y, x_q)


def lightglue_forward(lg: LightGlue, kpts0, desc0, valid0, kpts1, desc1, valid1, size_wh):
    """Returns the (N0, N1) soft assignment P and the matchabilities."""
    size_wh = torch.as_tensor(size_wh, dtype=torch.float32, device=desc0.device)
    th0 = _rotary(kpts0, lg.kenc_w, size_wh)
    th1 = _rotary(kpts1, lg.kenc_w, size_wh)
    x0, x1 = desc0, desc1
    for i in range(lg.n_layers):
        ws = lg.block(f"l{i}_self")
        x0 = _attention(ws, x0, x0, valid0, valid0, th0, th0)
        x1 = _attention(ws, x1, x1, valid1, valid1, th1, th1)
        wc = lg.block(f"l{i}_cross")
        x0n = _attention(wc, x0, x1, valid0, valid1)
        x1n = _attention(wc, x1, x0, valid1, valid0)
        x0, x1 = x0n, x1n

    m0 = torch.sigmoid((x0 @ lg.matchability_w + lg.matchability_b)[:, 0])
    m1 = torch.sigmoid((x1 @ lg.matchability_w + lg.matchability_b)[:, 0])
    p0 = x0 @ lg.final_proj_w + lg.final_proj_b
    p1 = x1 @ lg.final_proj_w + lg.final_proj_b
    sim = (p0 @ p1.T) / math.sqrt(p0.shape[-1])
    sim = torch.where(valid0[:, None] & valid1[None, :], sim, -1e9)
    # Dual-softmax assignment weighted by matchability (LightGlue eq. 8).
    p = torch.softmax(sim, dim=1) * torch.softmax(sim, dim=0) * (m0[:, None] * m1[None, :])
    return p, m0, m1


def load_npz(path: str) -> Dict[str, np.ndarray]:
    """An npz weight artifact as NumPy arrays (f16 kept; the converters
    promote floats to f32)."""
    data = np.load(path)
    return {k: data[k] for k in data.files}


class SuperPointLightGlueMatcher:
    """End-to-end learned matcher on one device. `sp` / `lg` are loaded
    modules; `match()` returns visual_verify.MatchResult.

    One match: two SuperPoint passes, one LightGlue pass, then one host
    read of the keypoints, validity flags and the assignment matrix (and
    one host read of the image maximum for the [0, 255] check)."""

    def __init__(self, sp: SuperPoint, lg: LightGlue, max_keypoints: int = 512,
                 match_thresh: float = 0.1):
        self.sp = sp
        self.lg = lg
        self.max_keypoints = max_keypoints
        self.match_thresh = match_thresh
        self.device = sp.conv1a_w.device

    @property
    def n_layers(self) -> int:
        return self.lg.n_layers

    def prepare(self, img1: np.ndarray, img2: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        """Both frames cropped to multiples of 8, on the device, in [0, 1]."""
        h = (img1.shape[0] // 8) * 8
        w = (img1.shape[1] // 8) * 8
        a = torch.as_tensor(np.asarray(img1[:h, :w], np.float32), device=self.device)
        b = torch.as_tensor(np.asarray(img2[:h, :w], np.float32), device=self.device)
        if float(a.max()) > 1.5:  # accept [0,255] inputs
            a, b = a / 255.0, b / 255.0
        return a, b

    @torch.no_grad()
    def forward(self, a: torch.Tensor, b: torch.Tensor):
        """Device part of a match: (k0, v0, k1, v1, P)."""
        k0, d0, v0 = extract_keypoints(self.sp, a, self.max_keypoints)
        k1, d1, v1 = extract_keypoints(self.sp, b, self.max_keypoints)
        size_wh = torch.tensor([a.shape[1], a.shape[0]], dtype=torch.float32, device=a.device)
        p, _, _ = lightglue_forward(self.lg, k0, d0, v0, k1, d1, v1, size_wh)
        return k0, v0, k1, v1, p

    def select(self, k0, v0, k1, v1, p):
        """Host part of a match: mutual best with a score threshold."""
        from fastlivo_tpu_torch.backend.visual_verify import MatchResult

        p = p.cpu().numpy()
        k0, k1 = k0.cpu().numpy(), k1.cpu().numpy()
        v0, v1 = v0.cpu().numpy(), v1.cpu().numpy()
        best1 = p.argmax(axis=1)
        best0 = p.argmax(axis=0)
        idx0 = np.arange(len(k0))
        mutual = best0[best1] == idx0
        score = p[idx0, best1]
        keep = mutual & (score > self.match_thresh) & v0 & v1[best1]
        return MatchResult(k0[keep], k1[best1[keep]], int(v0.sum()))

    def match(self, img1: np.ndarray, img2: np.ndarray):
        return self.select(*self.forward(*self.prepare(img1, img2)))
