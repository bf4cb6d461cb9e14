"""Fixed-shape loop trips replayed as captured CUDA graphs: the static
buffers' helpers and the capture that the photometric update
(`models.vio`) and the LIO update (`models.lio`) share.

A trip is a function of a carry (what one trip hands the next) and of
inputs that stay fixed over an update; it returns the next carry and
device outputs, and reads nothing back to the host. Its graph reads and
writes one set of static buffers shaped like those tensors: the caller
copies an update's inputs in, and each replay ends by copying the trip's
carry over the one it read, so replays chain.
"""

from __future__ import annotations

from typing import List

import torch

from fastlivo_tpu_torch.utils import timing


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of nested tuples, lists and NamedTuples, in order (None
    skipped)."""
    out = []
    for x in tree:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif x is not None:
            out.extend(leaves(x))
    return out


def empty_like(tree):
    """Uninitialized tensors shaped as the tensors of nested tuples and
    NamedTuples (None kept)."""
    items = [
        torch.empty_like(x) if isinstance(x, torch.Tensor) else None if x is None else empty_like(x)
        for x in tree
    ]
    return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)


def copy_into(dst, src):
    """Copy the tensors of `src` over those of the same-shaped `dst`."""
    for d, s in zip(leaves(dst), leaves(src)):
        d.copy_(s)


def capture(trip, carry, side: torch.cuda.Stream):
    """Capture `trip()` -> (next carry, outputs), followed by the copy of
    its carry over `carry` (the static buffers it reads), into one CUDA
    graph on the side stream `side`, after one warm-up trip there (run, and
    its result dropped: the buffers are unchanged). A host synchronization
    in the trip fails the capture. Returns (graph, outputs, launches):
    `outputs` are the tensors each replay writes, `launches` the kernel
    launches recorded into the graph (`timing.graph_counts`), which the
    owner counts at each replay. Warm-ups and captures of one owner share
    `side`: cuBLAS keeps a workspace for each stream it meets."""
    main = torch.cuda.current_stream(side.device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        trip()
    main.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    # thread_local: another thread's CUDA calls (the loop back end's) do
    # not break this capture.
    with timing.graph_counts() as launches, torch.cuda.graph(
        graph, stream=side, capture_error_mode="thread_local"
    ):
        nxt, outputs = trip()
        copy_into(carry, nxt)
    return graph, outputs, dict(launches)
