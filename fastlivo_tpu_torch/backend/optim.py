"""The matcher trainer's optimizer: optax's
`chain(clip_by_global_norm(1.0), adam(cosine_decay_schedule(lr, steps)))`
as plain tensor code (`examples/train_matcher.py` trains with that chain).

`torch.optim` is not used: its clipping (`clip_grad_norm_` scales by
`max / (norm + 1e-6)`) and its schedulers' step timing differ from optax's.
Each `step` does, in optax's order and formulas:

1. clip: the gradients are left as they are while their global norm is
   below 1, else divided by the norm;
2. Adam moments `mu = (1 - b1) g + b1 mu`, `nu = (1 - b2) g^2 + b2 nu`,
   bias-corrected by the incremented count, `mu_hat / (sqrt(nu_hat) + eps)`
   (`eps_root` 0);
3. the cosine schedule at the count before the increment, so the first
   update uses the full `lr`; `p += -lr_t * update`.

No step reads the host: the clip decision is made on the device, and the
schedule and the bias corrections are computed once, in float32 as XLA
computes them, into a table the device reads at its step count.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch


MAX_NORM = 1.0  # clip_by_global_norm
B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults (eps_root 0)


def cosine_decay(lr: float, decay_steps: int, count: int) -> float:
    """optax.cosine_decay_schedule(lr, decay_steps) (alpha 0) at `count`, in
    float32 arithmetic."""
    if decay_steps <= 0:
        raise ValueError(f"decay_steps must be positive, got {decay_steps}")
    f = np.float32
    c = f(min(count, decay_steps))
    return float(f(lr) * (f(0.5) * (f(1) + np.cos(f(math.pi) * c / f(decay_steps), dtype=np.float32))))


def _bias_correction(decay: float, count: int) -> float:
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


class ClipAdamCosine:
    """optax's clip + Adam + cosine chain over a list of parameters, which
    `step` updates in place from their gradients.

    The step count is a device tensor and each step's scalars (-lr_t and
    both bias corrections, float32 as XLA computes them) are a table on the
    device read at that count, so a step reads nothing from the host and
    can be captured in a CUDA graph. The table covers `steps` updates."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float, steps: int):
        self.params: List[torch.Tensor] = list(params)
        dev = self.params[0].device
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        table = [(-cosine_decay(lr, steps, c), _bias_correction(B1, c + 1), _bias_correction(B2, c + 1))
                 for c in range(steps)]
        self.schedule = torch.tensor(table, dtype=torch.float32, device=dev).reshape(-1, 3)
        self.count = torch.zeros((1,), dtype=torch.int64, device=dev)

    def clip(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """optax.clip_by_global_norm(MAX_NORM): `g` while the global norm is
        below MAX_NORM, else `(g / norm) * MAX_NORM`. Both branches are one
        division and one product, by 1 where the bound holds (exact), so
        no host read decides between them."""
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(grads))))
        keep = norm < MAX_NORM
        denom = torch.where(keep, 1.0, norm)
        scale = torch.where(keep, 1.0, torch.full_like(norm, MAX_NORM))
        return list(torch._foreach_mul(torch._foreach_div(list(grads), denom), scale))

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        g = self.clip(grads)
        torch._foreach_mul_(self.mu, B1)
        torch._foreach_add_(self.mu, torch._foreach_mul(g, 1.0 - B1))
        torch._foreach_mul_(self.nu, B2)
        torch._foreach_add_(self.nu, torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - B2))
        neg_lr, bc1, bc2 = torch.index_select(self.schedule, 0, self.count)[0]
        self.count += 1
        mu_hat = torch._foreach_div(self.mu, bc1)
        nu_hat = torch._foreach_div(self.nu, bc2)
        denom = torch._foreach_add(torch._foreach_sqrt(nu_hat), EPS)
        upd = torch._foreach_div(mu_hat, denom)
        torch._foreach_add_(self.params, torch._foreach_mul(upd, neg_lr))
