"""Scatters with the JAX package's semantics (port of
fastlivo_tpu/ops/scatter.py plus the scatter helpers the maps share).

- `f32_sort_key` / `f32_from_key` / `scatter_min_f32`: the monotonic
  f32 -> int32 encoding and the exact f32 min-scatter built on it.
- `set_drop` / `reduce_drop`: JAX's `.at[idx].set/min/max(..., mode="drop")`
  (negative indices count from the end, as in JAX). Torch raises on
  out-of-range indices (or writes out of bounds on CUDA), so the target is
  extended by one trash row, every out-of-range index is sent there, and
  the row is cut off again.
- `segment_sum_sorted`: `jax.ops.segment_sum` for segment ids that are
  already sorted. It reduces each segment sequentially in order
  (`torch.segment_reduce`), so the result is the same on every run —
  unlike `index_add_` with CUDA atomics, whose order changes run to run.
"""

from __future__ import annotations

import math

import torch

_FLIP = 0x7FFFFFFF


def f32_sort_key(x: torch.Tensor) -> torch.Tensor:
    """Monotonic f32 -> int32: a < b <=> key(a) < key(b). +0.0 and -0.0
    share a key. NaN keys are meaningless: replace NaNs first."""
    x = x + 0.0  # canonicalize -0.0 -> +0.0
    b = x.contiguous().view(torch.int32)
    flip = torch.where(x >= 0, 0, _FLIP).to(torch.int32)
    return torch.bitwise_xor(b, flip)


def f32_from_key(k: torch.Tensor) -> torch.Tensor:
    """Inverse of f32_sort_key."""
    flip = torch.where(k >= 0, 0, _FLIP).to(torch.int32)
    return torch.bitwise_xor(k, flip).contiguous().view(torch.float32)


def _extended(target: torch.Tensor, fill=0) -> torch.Tensor:
    pad = torch.full((1,) + tuple(target.shape[1:]), fill, dtype=target.dtype, device=target.device)
    return torch.cat([target, pad])


def _drop_index(idx: torch.Tensor, size: int) -> torch.Tensor:
    """JAX index semantics: negative indices count from the end; what is
    still out of [0, size) goes to the trash row `size`."""
    idx = idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + size, idx)
    return torch.where((idx >= 0) & (idx < size), idx, size)


def set_drop(target: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """target.at[idx].set(vals, mode="drop") along dim 0 (functional).
    Duplicate in-range indices must carry equal values (any may win)."""
    n = target.shape[0]
    ext = _extended(target)
    ext[_drop_index(idx, n)] = torch.as_tensor(vals, dtype=target.dtype, device=target.device)
    return ext[:n]


def set2_drop(target: torch.Tensor, i: torch.Tensor, j: torch.Tensor, vals) -> torch.Tensor:
    """target.at[i, j].set(vals, mode="drop") for a 2-index scatter where
    only `i` can be out of range (dropped rows)."""
    n = target.shape[0]
    ext = _extended(target)
    ii = _drop_index(i, n)
    jj = torch.where(ii < n, j.to(torch.int64), 0)
    ext[ii, jj] = torch.as_tensor(vals, dtype=target.dtype, device=target.device)
    return ext[:n]


def reduce_drop(target: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor, reduce: str) -> torch.Tensor:
    """target.at[idx].min/max(vals, mode="drop") for 1-D targets
    (reduce in {"amin", "amax"}); exact and order-independent."""
    n = target.shape[0]
    ext = _extended(target)
    return ext.scatter_reduce(0, _drop_index(idx, n), vals, reduce, include_self=True)[:n]


def scatter_min_f32(size: int, idx: torch.Tensor, vals: torch.Tensor, fill=math.inf) -> torch.Tensor:
    """out[j] = min over {vals[i] : idx[i] == j}, `fill` where empty;
    out-of-range idx dropped; NaN vals never win."""
    fill_t = torch.tensor(fill, dtype=torch.float32, device=vals.device)
    vals = torch.where(torch.isnan(vals), fill_t, vals)
    init = f32_sort_key(fill_t).expand(size).clone()
    keys = reduce_drop(init, idx, f32_sort_key(vals), "amin")
    return f32_from_key(keys)


def segment_offsets(seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Start offsets of segments 0..num_segments (the last one is where the
    dropped tail begins) for nondecreasing segment ids."""
    b = torch.arange(num_segments + 1, dtype=seg.dtype, device=seg.device)
    return torch.searchsorted(seg, b)


def segment_sum_sorted(data: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """jax.ops.segment_sum(data, seg, num_segments) for NONDECREASING seg.

    Ids >= num_segments (which, sorted, sit at the end) are dropped. Float
    data reduces sequentially within each segment; integer data is summed
    exactly through an int64 cumulative sum.
    """
    n = seg.shape[0]
    seg = torch.clamp(seg, max=num_segments)
    starts = segment_offsets(seg, num_segments)
    if not data.is_floating_point():
        cs = torch.cumsum(data.to(torch.int64), dim=0)
        cs = torch.cat([torch.zeros((1,) + tuple(cs.shape[1:]), dtype=cs.dtype, device=cs.device), cs])
        return (cs[starts[1:]] - cs[starts[:-1]]).to(data.dtype)
    ends = torch.cat([starts[1:], torch.full((1,), n, dtype=starts.dtype, device=starts.device)])
    lengths = ends - starts  # the final entry holds the dropped tail
    out = torch.segment_reduce(data, "sum", lengths=lengths, axis=0, unsafe=True)
    return out[:num_segments]
