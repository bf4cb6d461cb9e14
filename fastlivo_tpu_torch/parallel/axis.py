"""A mesh axis as a torch.distributed process group, and its collectives.

The JAX package runs one controller over a device mesh, and its
multi-device code names mesh axes (`axis_name`) inside `shard_map`: psum,
pmin, tiled all_gather, axis_index and axis_size. The port runs one process
per rank; an `Axis` holds the process group of one mesh axis (or of several
joined, outer first, as JAX's tuple of axis names), this rank's index on it
and its size, and gives the same five operations:

    jax.lax.psum                -> Axis.psum     (all_reduce SUM)
    jax.lax.pmin                -> Axis.pmin     (all_reduce MIN)
    all_gather(tiled=True)      -> Axis.all_gather (rank order, along dim 0)
    axis_index / axis_size      -> Axis.index / Axis.size

plus `Axis.broadcast` (rank 0's value everywhere), which a single
controller never needs: it replicates a host-side decision that the ranks
could otherwise reach differently (the loop back end's corrections).
Nothing else in the port calls torch.distributed collectives.

Rules the callers keep: every value the host reads to steer control flow
(the LIO loop's flags, the health gate, the re-anchoring go/no-go) is
derived from replicated values after a collective, never from shard-local
or thread-timed ones, or the ranks would take different branches and the
next collective would hang. Integer reductions
are exact; float sums reduce in the backend's order (fixed for a fixed
world size), not in XLA's.

Both backends take the tensors where they lie: NCCL reduces on the card;
gloo reduces CPU tensors, and it takes CUDA tensors too (all_reduce SUM
and MIN, all_gather_into_tensor, int32 and uint8 included: checked on the
H100 machine with torch 2.11), copying them through the host itself. So
the CPU tests run the same code as two gloo ranks sharing one GPU.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional, Sequence

import torch
import torch.distributed as dist

# Dtypes that cross a collective as another dtype: gloo and NCCL reduce no
# bool, so masks travel as uint8.
_WIRE = {torch.bool: torch.uint8}


class Axis:
    """One mesh axis: a process group, this rank's index on it and its size.

    `group` None is the default (world) group. `parts` is set on a joined
    axis (`Axis.joined`): the component axes, outer first, whose product
    this axis spans in row-major rank order — the port's form of a JAX
    tuple of axis names. `counts` tallies the collectives this axis ran, by
    operation (a plain Counter the caller may reset)."""

    def __init__(self, group=None, name: str = "points", parts: Sequence["Axis"] = ()):
        if not dist.is_initialized():
            raise ValueError("an Axis needs an initialised torch.distributed process group")
        self.group = group
        self.name = name
        self.parts = tuple(parts)
        self.index = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.counts: Counter = Counter()

    @classmethod
    def joined(cls, outer: "Axis", inner: "Axis") -> "Axis":
        """The product of two axes (JAX's `(outer, inner)` axis tuple) over
        the whole world, ranks row-major (outer-major)."""
        ax = cls(None, f"{outer.name}+{inner.name}", parts=(outer, inner))
        if ax.size != outer.size * inner.size or ax.index != outer.index * inner.size + inner.index:
            raise ValueError(
                f"joined axis {ax.name}: rank {ax.index} of {ax.size} is not row-major over "
                f"{outer.name} ({outer.index} of {outer.size}) x {inner.name} ({inner.index} of {inner.size})"
            )
        return ax

    # -- collectives ------------------------------------------------------

    @staticmethod
    def _to_wire(x: torch.Tensor) -> torch.Tensor:
        x = x.detach()
        if x.dtype in _WIRE:
            x = x.to(_WIRE[x.dtype])
        return x.contiguous()

    def _reduce(self, x: torch.Tensor, op, name: str) -> torch.Tensor:
        buf = self._to_wire(x).clone()  # all_reduce works in place
        dist.all_reduce(buf.reshape(-1), op=op, group=self.group)
        self.counts[name] += 1
        return buf.to(x.dtype)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the axis (jax.lax.psum); the result is replicated."""
        return self._reduce(x, dist.ReduceOp.SUM, "psum")

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        """Minimum over the axis (jax.lax.pmin); the result is replicated."""
        return self._reduce(x, dist.ReduceOp.MIN, "pmin")

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's x concatenated along dim 0 in rank order
        (jax.lax.all_gather(..., tiled=True))."""
        src = self._to_wire(x)
        out = torch.empty((self.size * src.shape[0],) + tuple(src.shape[1:]), dtype=src.dtype,
                          device=src.device)
        # One call on every torch the port runs on: torch 2.11 has no
        # all_gather_single, newer ones keep this name as its alias.
        dist.all_gather_into_tensor(out, src, group=self.group)
        self.counts["all_gather"] += 1
        return out.to(x.dtype)

    def broadcast(self, x: torch.Tensor) -> torch.Tensor:
        """The axis's rank 0's x on every rank (x must have the same shape
        and dtype everywhere): how a decision made on the host of one rank
        becomes replicated."""
        buf = self._to_wire(x).clone()  # broadcast works in place
        src = 0 if self.group is None else dist.get_global_rank(self.group, 0)
        dist.broadcast(buf, src=src, group=self.group)
        self.counts["broadcast"] += 1
        return buf.to(x.dtype)

    def all_gather_ragged(self, x: torch.Tensor) -> torch.Tensor:
        """Like `all_gather`, for rows counts that differ between ranks
        (one host read of the counts; off the scan path)."""
        n = torch.tensor([x.shape[0]], dtype=torch.int64, device=x.device)
        sizes = self.all_gather(n).tolist()
        width = max(sizes)
        pad = torch.zeros((width - x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        rows = self.all_gather(torch.cat([x, pad]))
        return torch.cat([rows[i * width: i * width + s] for i, s in enumerate(sizes)])

    def barrier(self):
        dist.barrier(group=self.group)


def map_axis_of(axis: Optional[Axis]) -> Optional[Axis]:
    """The axis a sharded arena partitions over: the last (innermost)."""
    if axis is None:
        return None
    return axis.parts[-1] if axis.parts else axis
