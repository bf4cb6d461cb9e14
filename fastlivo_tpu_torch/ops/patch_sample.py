"""Fused patch sampling on a stride lattice: the CUDA kernel and its plain
PyTorch version.

`patch_sample` computes the JAX package's `strided_patch_sample`
(fastlivo_tpu/ops/image.py:167-262): window extraction (the Pallas TPU
kernel `extract_windows_tpu`, fastlivo_tpu/ops/pallas_windows.py:66), the
bilinear lattice of each candidate's stride and the central-difference
gradients, in one launch. `patch_sample_levels` samples every level of a
padded pyramid at one set of level-0 pixels in one launch (the stored
observation patches of models/vio.py). The kernel source is
`fastlivo_tpu_torch/csrc/patch_sample.cu` (see the note there for its
design and bound).

The wrappers launch the kernel for CUDA tensors and use the plain version
for CPU tensors only; there is no fallback between the two. The plain
version is pure torch on any device (its window gather is
`pallas_windows.extract_windows_plain`), so on the card it is the kernel's
bitwise reference.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from fastlivo_tpu_torch.ops import cuda_build
from fastlivo_tpu_torch.ops.pallas_windows import extract_windows_plain

# Kernel launches since the last reset (the wrapper adds one per launch).
LAUNCHES = {"patch_sample": 0}

MAX_LEVELS = 3
MAX_STRIDES = 3
MAX_LATTICE = 16  # lattice points per axis (patch_size + 2 with gradients)

_FN = None


def _kernel_fn():
    global _FN
    if _FN is None:
        fn = cuda_build.load("patch_sample").patch_sample
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # imgs, hps, wps, L
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # centers, strides, grad_units
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # n, patch, pad
            ctypes.c_void_p, ctypes.c_int,  # stride_set, n_strides
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # val, du, dv, stream
        ]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def window_size(patch_size: int, stride_set: Sequence[int], grads: bool) -> int:
    """Side of the window each candidate's lattice is read from."""
    n_lat = patch_size + (2 if grads else 0)
    return (n_lat - 1) * max(stride_set) + 2


def _check(levels, centers, strides, patch_size, stride_set, grad_units) -> None:
    dev = centers.device
    if centers.dim() != 2 or centers.shape[1] != 2 or centers.dtype != torch.float32:
        raise ValueError(f"centers must be (N, 2) float32, got {tuple(centers.shape)} {centers.dtype}")
    n = centers.shape[0]
    named = [("centers", centers)]
    if strides is not None:
        if strides.shape != (n,) or strides.dtype != torch.int32:
            raise ValueError(f"strides must be (N,) int32, got {tuple(strides.shape)} {strides.dtype}")
        named.append(("strides", strides))
    if grad_units is not None:
        if grad_units.shape != (n,) or grad_units.dtype != torch.float32:
            raise ValueError(
                f"grad_units must be (N,) float32, got {tuple(grad_units.shape)} {grad_units.dtype}"
            )
        named.append(("grad_units", grad_units))
    if not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f"1 to {MAX_LEVELS} levels, got {len(levels)}")
    if not (1 <= len(stride_set) <= MAX_STRIDES and all(s >= 1 for s in stride_set)):
        raise ValueError(f"stride_set must hold 1 to {MAX_STRIDES} positive ints, got {stride_set}")
    if not 1 <= patch_size + (2 if grad_units is not None else 0) <= MAX_LATTICE:
        raise ValueError(f"patch_size {patch_size} too large for the kernel's lattice")
    win = window_size(patch_size, stride_set, grad_units is not None)
    for lvl, img in enumerate(levels):
        if img.dim() != 2 or img.dtype != torch.float32:
            raise ValueError(f"level {lvl} must be 2-D float32, got {tuple(img.shape)} {img.dtype}")
        if win > min(img.shape):
            raise ValueError(f"window {win} does not fit level {lvl} ({tuple(img.shape)})")
        named.append((f"level {lvl}", img))
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, centers on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def patch_sample_plain(
    img_pad: torch.Tensor,
    centers: torch.Tensor,
    strides: torch.Tensor,
    patch_size: int,
    pad: int,
    stride_set: Tuple[int, ...] = (1, 2, 4),
    grad_units: Optional[torch.Tensor] = None,
):
    """The JAX arithmetic op by op: clipped window per candidate, each
    static stride's bilinear lattice, a `where` per stride, then the
    central differences. Returns val or (val, du, dv), each (N, P^2)."""
    dtype = img_pad.dtype
    half = patch_size // 2
    g = 0 if grad_units is None else 1
    n_lat = patch_size + 2 * g
    win = window_size(patch_size, stride_set, grad_units is not None)

    i0 = torch.floor(centers)
    frac = (centers - i0).to(dtype)
    i0 = i0.to(torch.int32)
    origins = i0 - strides[:, None] * (half + g)
    hp, wp = img_pad.shape
    ou = torch.clamp(origins[:, 0] + pad, 0, wp - win)
    ov = torch.clamp(origins[:, 1] + pad, 0, hp - win)
    windows = extract_windows_plain(img_pad, torch.stack([ou, ov], dim=-1).to(torch.int32), win)

    fu = frac[:, 0][:, None, None]
    fv = frac[:, 1][:, None, None]

    def lattice(s: int) -> torch.Tensor:
        span = (n_lat - 1) * s + 1

        def corner(dv, du):
            return windows[:, dv : dv + span : s, du : du + span : s]

        return (
            corner(0, 0) * (1 - fu) * (1 - fv)
            + corner(0, 1) * fu * (1 - fv)
            + corner(1, 0) * (1 - fu) * fv
            + corner(1, 1) * fu * fv
        )

    lat = lattice(stride_set[0])
    for s in stride_set[1:]:
        lat = torch.where((strides == s)[:, None, None], lattice(s), lat)

    n = centers.shape[0]
    val = lat[:, g : g + patch_size, g : g + patch_size].reshape(n, -1)
    if grad_units is None:
        return val
    inv = (1.0 / torch.clamp(grad_units, min=1e-9)).to(dtype)[:, None]
    du = 0.5 * (
        lat[:, g : g + patch_size, 2 : 2 + patch_size]
        - lat[:, g : g + patch_size, 0:patch_size]
    ).reshape(n, -1) * inv
    dv = 0.5 * (
        lat[:, 2 : 2 + patch_size, g : g + patch_size]
        - lat[:, 0:patch_size, g : g + patch_size]
    ).reshape(n, -1) * inv
    return val, du, dv


def patch_sample_levels_plain(
    pyr: Sequence[torch.Tensor], px: torch.Tensor, patch_size: int, pad: int
) -> torch.Tensor:
    """The per-level loop: level l sampled at px / 2^l with stride 1.
    Returns (N, L, S, S)."""
    n = px.shape[0]
    ones = torch.ones(n, dtype=torch.int32, device=px.device)
    out = [
        patch_sample_plain(img, px / (1 << lvl), ones, patch_size, pad, stride_set=(1,))
        for lvl, img in enumerate(pyr)
    ]
    return torch.stack(out, dim=1).reshape(n, len(pyr), patch_size, patch_size)


def _launch(levels, centers, strides, patch_size, pad, stride_set, grad_units):
    """Launch the kernel on the current stream over every level at once,
    on CUDA inputs that `_check` passed (level l samples centers / 2^l;
    `strides=None` means stride_set[0] for every candidate). Returns val
    or (val, du, dv), each (N, L * P^2): level l's texels at columns
    [l * P^2, (l + 1) * P^2)."""
    n = centers.shape[0]
    n_lv = len(levels)
    val = torch.empty((n, n_lv * patch_size * patch_size), dtype=torch.float32, device=centers.device)
    grads = grad_units is not None
    du = torch.empty_like(val) if grads else None
    dv = torch.empty_like(val) if grads else None
    out = (val, du, dv) if grads else val
    if n == 0:
        return out
    imgs = (ctypes.c_uint64 * n_lv)(*[img.data_ptr() for img in levels])
    hps = (ctypes.c_int * n_lv)(*[img.shape[0] for img in levels])
    wps = (ctypes.c_int * n_lv)(*[img.shape[1] for img in levels])
    sset = (ctypes.c_int * len(stride_set))(*stride_set)
    # The launch goes to the calling thread's current CUDA device; a tensor
    # on another device makes the launch fail, and the error raises below.
    stream = torch.cuda.current_stream(centers.device).cuda_stream
    err = _kernel_fn()(
        imgs, hps, wps, n_lv,
        centers.data_ptr(), None if strides is None else strides.data_ptr(),
        grad_units.data_ptr() if grads else None,
        n, patch_size, pad, sset, len(stride_set),
        val.data_ptr(), du.data_ptr() if grads else None, dv.data_ptr() if grads else None,
        stream,
    )
    if err != 0:
        raise RuntimeError(f"patch_sample kernel launch failed: cudaError {err}")
    LAUNCHES["patch_sample"] += 1
    return out


def patch_sample(
    img_pad: torch.Tensor,
    centers: torch.Tensor,
    strides: torch.Tensor,
    patch_size: int,
    pad: int,
    stride_set: Tuple[int, ...] = (1, 2, 4),
    grad_units: Optional[torch.Tensor] = None,
):
    """`strided_patch_sample` on one padded image: the kernel for CUDA
    tensors, the plain version for CPU tensors. Returns val or
    (val, du, dv), each (N, P^2)."""
    _check([img_pad], centers, strides, patch_size, stride_set, grad_units)
    if centers.device.type == "cuda":
        return _launch([img_pad], centers, strides, patch_size, pad, stride_set, grad_units)
    if centers.device.type == "cpu":
        return patch_sample_plain(img_pad, centers, strides, patch_size, pad, stride_set, grad_units)
    raise ValueError(f"patch_sample: unsupported device {centers.device}")


def patch_sample_levels(
    pyr: Sequence[torch.Tensor], px: torch.Tensor, patch_size: int, pad: int
) -> torch.Tensor:
    """Stride-1 patches of every padded pyramid level at level-0 pixels px
    (level l at px / 2^l), in one launch for CUDA tensors; the plain
    per-level loop for CPU tensors. Returns (N, L, S, S)."""
    _check(pyr, px, None, patch_size, (1,), None)
    if px.device.type == "cuda":
        val = _launch(pyr, px, None, patch_size, pad, (1,), None)
        return val.view(px.shape[0], len(pyr), patch_size, patch_size)
    if px.device.type == "cpu":
        return patch_sample_levels_plain(pyr, px, patch_size, pad)
    raise ValueError(f"patch_sample_levels: unsupported device {px.device}")
