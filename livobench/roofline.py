"""The card's published peaks and the least work of the port's hand kernel,
kept with the benchmark for a roofline metric (none reads them yet).

Peaks: NVIDIA's H100 SXM data sheet, dense rates without sparsity, at the
full 700 W power limit.

`patch_sample_bound_bytes` is the least memory traffic of one
`patch_sample` call (`fastlivo_tpu_torch/csrc/patch_sample.cu`): every
image pixel some tap touches read once, the candidates' inputs read once,
every output written once. A copy of the arithmetic `chip_smoke.py`'s
phase 1 uses; a call's roofline share is bound_bytes / HBM_BYTES_PER_S
over its measured device time.
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12  # outside the tensor cores
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
PAD = 32  # the VIO path's pyramid padding (models/vio.py _SAMPLE_PAD)


def lattice_points(img, centers, strides, patch, stride_set, grads, pad=PAD):
    """Padded-pixel (x, y) of the top-left tap of every lattice point, each
    (N, n_lat, n_lat) int, and the shared fraction (N, 2), from the same
    clipped window origins as the sampler."""
    hp, wp = img.shape
    g = 1 if grads else 0
    n_lat = patch + 2 * g
    win = (n_lat - 1) * max(stride_set) + 2
    i0 = torch.floor(centers)
    frac = centers - i0
    i0 = i0.to(torch.int32)
    if strides is None:
        strides = torch.full_like(i0[:, 0], stride_set[0])
    org = i0 - strides[:, None] * (patch // 2 + g)
    ou = torch.clamp(org[:, 0] + pad, 0, wp - win)
    ov = torch.clamp(org[:, 1] + pad, 0, hp - win)
    s_eff = torch.full_like(strides, stride_set[0])
    for s in stride_set[1:]:
        s_eff = torch.where(strides == s, s, s_eff)
    r = torch.arange(n_lat, device=img.device, dtype=torch.int32)
    x = ou[:, None, None] + s_eff[:, None, None] * r[None, None, :]
    y = ov[:, None, None] + s_eff[:, None, None] * r[None, :, None]
    return x.expand(-1, n_lat, -1).long(), y.expand(-1, -1, n_lat).long(), frac


def patch_sample_bound_bytes(case) -> int:
    """Least bytes of one call. `case` holds the call's `levels` (padded
    images), `centers` (per level), `strides` (or None), `patch`,
    `stride_set` and `grads`."""
    touched = 0
    for img, c in zip(case["levels"], case["centers"]):
        x, y, _ = lattice_points(img, c, case["strides"], case["patch"], case["stride_set"], case["grads"])
        mask = torch.zeros(img.shape, dtype=torch.bool, device=img.device)
        for dy in (0, 1):
            for dx in (0, 1):
                mask[y + dy, x + dx] = True
        touched += int(mask.sum())
    n = case["centers"][0].shape[0]
    inputs = n * (8 + (4 if case["strides"] is not None else 0) + (4 if case["grads"] else 0))
    outputs = n * len(case["levels"]) * case["patch"] ** 2 * 4 * (3 if case["grads"] else 1)
    return touched * 4 + inputs + outputs
