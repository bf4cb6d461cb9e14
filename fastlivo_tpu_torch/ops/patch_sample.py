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
from fastlivo_tpu_torch.utils import timing


MAX_LEVELS = 3
MAX_STRIDES = 3
MAX_LATTICE = 16  # lattice points per axis (patch_size + 2 with gradients)

_FN = None


def bind(lib: ctypes.CDLL):
    """`lib.patch_sample` with its argument types set (see the C entry
    point in csrc/patch_sample.cu)."""
    fn = lib.patch_sample
    fn.argtypes = (
        [ctypes.c_void_p] * 7  # params, img0, img1, img2, centers, strides, grad_units
        + [ctypes.c_int]  # n
        + [ctypes.c_void_p] * 2  # out, stream
    )
    fn.restype = ctypes.c_int
    return fn


def _kernel_fn():
    global _FN
    if _FN is None:
        _FN = bind(cuda_build.load("patch_sample"))
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
    val = lat[:, g : g + patch_size, g : g + patch_size].reshape(n, patch_size * patch_size)
    if grad_units is None:
        return val
    inv = (1.0 / torch.clamp(grad_units, min=1e-9)).to(dtype)[:, None]
    du = 0.5 * (
        lat[:, g : g + patch_size, 2 : 2 + patch_size]
        - lat[:, g : g + patch_size, 0:patch_size]
    ).reshape(n, patch_size * patch_size) * inv
    dv = 0.5 * (
        lat[:, 2 : 2 + patch_size, g : g + patch_size]
        - lat[:, 0:patch_size, g : g + patch_size]
    ).reshape(n, patch_size * patch_size) * inv
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


# (patch, stride_set, grads, pad, level shapes...) -> the kernel's int
# parameters as one ctypes array, or False where `_check` rejects them.
_STATIC = {}
_STATIC_MAX = 256
_F32 = torch.float32
_I32 = torch.int32


def _static_args(patch_size, stride_set, grads, pad, *shapes):
    """The C entry point's `params` (hp0, wp0, hp1, wp1, hp2, wp2, n_levels,
    patch, pad, s0, s1, s2, n_strides) when `_check` accepts these
    non-tensor arguments and level shapes, else False."""
    n_lv = len(shapes)
    if not (
        1 <= n_lv <= MAX_LEVELS
        and 1 <= len(stride_set) <= MAX_STRIDES
        and all(s >= 1 for s in stride_set)
        and 1 <= patch_size + (2 if grads else 0) <= MAX_LATTICE
    ):
        return False
    win = window_size(patch_size, stride_set, grads)
    if not all(len(sh) == 2 and win <= min(sh) for sh in shapes):
        return False
    dims = [d for sh in shapes for d in sh] + [0] * (2 * (MAX_LEVELS - n_lv))
    sset = list(stride_set) + [0] * (MAX_STRIDES - len(stride_set))
    return (ctypes.c_int * 13)(*dims, n_lv, patch_size, pad, *sset, len(stride_set))


def _tensors_ok(levels, centers, strides, grad_units) -> bool:
    """`_check`'s per-tensor conditions but the level sizes (dtype, shape,
    one device, contiguous) for CUDA centers, as plain int and identity
    tests."""
    dev = centers.get_device()
    shape = centers.shape
    if not (len(shape) == 2 and shape[1] == 2 and centers.dtype is _F32 and centers.is_contiguous()):
        return False
    n = shape[:1]
    for t, dtype in ((strides, _I32), (grad_units, _F32)):
        if t is not None and not (
            t.shape == n and t.dtype is dtype and t.get_device() == dev and t.is_contiguous()
        ):
            return False
    for img in levels:
        if not (img.dtype is _F32 and img.get_device() == dev and img.is_contiguous()):
            return False
    return True


def _validate(levels, centers, strides, patch_size, stride_set, grad_units, pad):
    """What `_check` checks, for CUDA centers, at the least host cost: the
    non-tensor arguments and the level shapes once per distinct set
    (cached with the kernel's `params`), the tensors on every call.
    Returns `params`; a rejected call raises `_check`'s ValueError."""
    key = (
        patch_size, stride_set if type(stride_set) is tuple else tuple(stride_set),
        grad_units is not None, pad, *[img.shape for img in levels],
    )
    params = _STATIC.get(key)
    if params is None:
        if len(_STATIC) >= _STATIC_MAX:
            _STATIC.clear()
        params = _STATIC[key] = _static_args(*key)
    if params and _tensors_ok(levels, centers, strides, grad_units):
        return params
    _check(levels, centers, strides, patch_size, stride_set, grad_units)
    raise ValueError("patch_sample: the kernel does not take these inputs")  # _check raised first


def _outputs(centers, n, n_levels, patch_size, grads):
    """One output buffer, (N, L * P^2) for values or (3, N, L * P^2) for
    val, du, dv, and what the call returns (the buffer, or its three
    contiguous views)."""
    # new_empty: the centers' dtype (float32, checked) and device, and the
    # cheapest allocation call on the host.
    cols = n_levels * patch_size * patch_size
    if grads:
        out = centers.new_empty((3, n, cols))
        return out, out.unbind(0)
    out = centers.new_empty((n, cols))
    return out, out


def _arguments(levels, centers, strides, grad_units, n, params, out):
    """The C entry point's arguments but the stream, as Python ints (None
    for a null pointer)."""
    n_lv = len(levels)
    return (
        params, levels[0].data_ptr(),
        levels[1].data_ptr() if n_lv > 1 else None, levels[2].data_ptr() if n_lv > 2 else None,
        centers.data_ptr(), None if strides is None else strides.data_ptr(),
        None if grad_units is None else grad_units.data_ptr(), n, out.data_ptr(),
    )


def _stream(centers):
    """PyTorch's current stream on the centers' device as a raw handle: the
    int `torch.cuda.current_stream(dev).cuda_stream` gives, without
    building a Stream object. The launch joins the caller's stream, so it
    is captured with the caller's CUDA graph."""
    return torch._C._cuda_getCurrentRawStream(centers.get_device())


def _launch(levels, centers, strides, patch_size, pad, stride_set, grad_units):
    """Launch the kernel on the current stream over every level at once,
    for CUDA centers (level l samples centers / 2^l; `strides=None` means
    stride_set[0] for every candidate). Returns val or (val, du, dv), each
    (N, L * P^2): level l's texels at columns [l * P^2, (l + 1) * P^2)."""
    params = _validate(levels, centers, strides, patch_size, stride_set, grad_units, pad)
    n = centers.shape[0]
    out, res = _outputs(centers, n, len(levels), patch_size, grad_units is not None)
    if n == 0:
        return res
    args = _arguments(levels, centers, strides, grad_units, n, params, out)
    # The launch goes to the calling thread's current CUDA device; a tensor
    # on another device makes the launch fail, and the error raises below.
    err = _kernel_fn()(*args, _stream(centers))
    if err != 0:
        raise RuntimeError(f"patch_sample kernel launch failed: cudaError {err}")
    timing.count_launch("patch_sample.launches")
    return res


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
    if centers.is_cuda:
        return _launch((img_pad,), centers, strides, patch_size, pad, stride_set, grad_units)
    _check([img_pad], centers, strides, patch_size, stride_set, grad_units)
    if centers.device.type == "cpu":
        return patch_sample_plain(img_pad, centers, strides, patch_size, pad, stride_set, grad_units)
    raise ValueError(f"patch_sample: unsupported device {centers.device}")


def patch_sample_levels(
    pyr: Sequence[torch.Tensor], px: torch.Tensor, patch_size: int, pad: int
) -> torch.Tensor:
    """Stride-1 patches of every padded pyramid level at level-0 pixels px
    (level l at px / 2^l), in one launch for CUDA tensors; the plain
    per-level loop for CPU tensors. Returns (N, L, S, S)."""
    if px.is_cuda:
        val = _launch(pyr, px, None, patch_size, pad, (1,), None)
        return val.view(px.shape[0], len(pyr), patch_size, patch_size)
    _check(pyr, px, None, patch_size, (1,), None)
    if px.device.type == "cpu":
        return patch_sample_levels_plain(pyr, px, patch_size, pad)
    raise ValueError(f"patch_sample_levels: unsupported device {px.device}")
