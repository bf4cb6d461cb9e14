"""Kernels that f32_sort_key's subnormal flush adds to a flagship LIVO pair
of the PyTorch port, against the earlier `x + 0.0` canonicalisation.

    python3 examples/torch_sort_key_kernels.py   # from the repo root, on a CUDA machine

Prints the card's name and power limit, then one JSON line: the CUDA
kernels of one f32_sort_key call in each form (torch.profiler), and for
six flagship pairs after three warm-up pairs (chip_smoke.py phase 2's
sizes; two with the flush, two with the old form, two with the flush) the
kernels per pair and the f32_sort_key calls per pair.
"""

import json
import os
import sys

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
from fastlivo_tpu_torch.ops import cuda_build, scatter  # noqa: E402

_FLIP = 0x7FFFFFFF


def sort_key_plus_zero(x):
    """f32_sort_key before the flush: -0.0 -> +0.0 only."""
    x = x + 0.0
    b = x.contiguous().view(torch.int32)
    flip = torch.where(x >= 0, 0, _FLIP).to(torch.int32)
    return torch.bitwise_xor(b, flip)


def n_kernels(fn):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)


def main():
    print(cs.gpu_identity(), flush=True)
    cuda_build.build_all()
    dev = torch.device("cuda")
    flush = scatter.f32_sort_key
    forms = {"flush": flush, "plus_zero": sort_key_plus_zero}
    x = torch.randn(640 * 512, device=dev)
    out = dict(kernels_per_call={name: n_kernels(lambda f=f: f(x)) for name, f in forms.items()}, pairs=[])

    run = cs.LivoRun(cs.flagship_config(), cs.Scene(n_raw=81920, imu_m=32, seed=0), dev)
    inputs = run.make_inputs(9)
    cs.finish([run.pair(inp) for inp in inputs[:3]])
    calls = []
    try:
        for i, name in enumerate(("flush", "plus_zero", "flush")):
            def counted(v, f=forms[name]):
                calls.append(1)
                return f(v)

            scatter.f32_sort_key = counted
            for inp in inputs[3 + 2 * i: 5 + 2 * i]:
                n0 = len(calls)
                k = n_kernels(lambda: cs.finish([run.pair(inp)]))
                out["pairs"].append(dict(key=name, k=inp["k"], kernels=k, f32_sort_key_calls=len(calls) - n0))
    finally:
        scatter.f32_sort_key = flush
    print(json.dumps(out))


if __name__ == "__main__":
    main()
