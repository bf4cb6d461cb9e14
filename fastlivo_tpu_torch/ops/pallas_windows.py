"""Batched extraction of per-candidate image windows: the CUDA kernel and
its plain PyTorch version.

Counterpart of fastlivo_tpu/ops/pallas_windows.py, whose Pallas TPU kernel
`extract_windows_tpu` this replaces. The kernel source is
`fastlivo_tpu_torch/csrc/extract_windows.cu` (one thread block per window,
coalesced row reads; see the note there for its bound). The wrapper
launches it for CUDA tensors and uses the plain version for CPU tensors
only; there is no fallback between the two.
"""

from __future__ import annotations

import ctypes

import torch

from fastlivo_tpu_torch.ops import cuda_build

# Kernel launches since the last reset (the wrapper adds one per launch).
LAUNCHES = {"extract_windows": 0}

_FN = None


def _kernel_fn():
    global _FN
    if _FN is None:
        fn = cuda_build.load("extract_windows").extract_windows
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # img, hp, wp
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # starts, n, win
            ctypes.c_void_p, ctypes.c_void_p,  # out, stream
        ]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _check(img_pad: torch.Tensor, starts: torch.Tensor, win: int) -> None:
    if img_pad.dim() != 2 or img_pad.dtype != torch.float32:
        raise ValueError(f"img_pad must be 2-D float32, got {tuple(img_pad.shape)} {img_pad.dtype}")
    if starts.dim() != 2 or starts.shape[1] != 2 or starts.dtype != torch.int32:
        raise ValueError(f"starts must be (N, 2) int32, got {tuple(starts.shape)} {starts.dtype}")
    if starts.device != img_pad.device:
        raise ValueError("img_pad and starts must be on one device")
    hp, wp = img_pad.shape
    if not 0 < win <= min(hp, wp):
        raise ValueError(f"win={win} does not fit a {hp}x{wp} image")


def extract_windows_plain(
    img_pad: torch.Tensor, starts: torch.Tensor, win: int
) -> torch.Tensor:
    """Index-grid gather: out[i] = img_pad[ov_i:ov_i+win, ou_i:ou_i+win]
    for starts (N, 2) = (ou, ov) already clipped to [0, dim - win]."""
    _check(img_pad, starts, win)
    r = torch.arange(win, device=img_pad.device)
    ou = starts[:, 0].long()
    ov = starts[:, 1].long()
    return img_pad[ov[:, None, None] + r[:, None], ou[:, None, None] + r]


def extract_windows_cuda(
    img_pad: torch.Tensor, starts: torch.Tensor, win: int
) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream. Returns (N, win, win)."""
    _check(img_pad, starts, win)
    if img_pad.device.type != "cuda":
        raise ValueError("extract_windows_cuda needs CUDA tensors")
    if not (img_pad.is_contiguous() and starts.is_contiguous()):
        raise ValueError("extract_windows_cuda needs contiguous tensors")
    n = starts.shape[0]
    hp, wp = img_pad.shape
    out = torch.empty((n, win, win), dtype=img_pad.dtype, device=img_pad.device)
    if n == 0:
        return out
    # The launch goes to the calling thread's current CUDA device; a tensor
    # on another device makes the launch fail, and the error raises below.
    stream = torch.cuda.current_stream(img_pad.device).cuda_stream
    err = _kernel_fn()(
        img_pad.data_ptr(), hp, wp, starts.data_ptr(), n, win, out.data_ptr(), stream
    )
    if err != 0:
        raise RuntimeError(f"extract_windows kernel launch failed: cudaError {err}")
    LAUNCHES["extract_windows"] += 1
    return out


def extract_windows(img_pad: torch.Tensor, starts: torch.Tensor, win: int) -> torch.Tensor:
    """Dispatch on the device of the inputs: the kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if img_pad.device.type == "cuda":
        return extract_windows_cuda(img_pad, starts, win)
    if img_pad.device.type == "cpu":
        return extract_windows_plain(img_pad, starts, win)
    raise ValueError(f"extract_windows: unsupported device {img_pad.device}")
