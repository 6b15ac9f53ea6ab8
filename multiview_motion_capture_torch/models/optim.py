"""optax's AdamW and warmup-cosine schedule, in PyTorch.

The JAX package trains with `optax.adamw(lr)` / `optax.adamw(lr,
weight_decay=)` and, in `scripts/train_posenet.py`, with
`optax.warmup_cosine_decay_schedule`.  optax's defaults differ from
torch's: b1 0.9, b2 0.999, eps 1e-8 as torch's, but weight decay 1e-4 on
every leaf (torch's AdamW default is 1e-2), so `adamw` states each value.
The update is the same arithmetic: p - lr (m_hat / (sqrt(v_hat) + eps) +
wd p), both moments bias-corrected.

optax evaluates a schedule at the update count BEFORE each update: the
first update runs at schedule(0) (lr 0 for a warmup from 0).  `AdamW`
does the same when given a schedule for `lr`.
"""
from __future__ import annotations

import math
from typing import Callable, Union

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8
WEIGHT_DECAY = 1e-4   # optax.adamw's default

Schedule = Callable[[int], float]


class AdamW(torch.optim.AdamW):
    """`torch.optim.AdamW` with optax.adamw's hyper-parameters.  `lr` is a
    number or a schedule of the update count, evaluated before each update
    as optax does (`count` updates have been applied so far)."""

    def __init__(self, params, lr: Union[float, Schedule],
                 weight_decay: float = WEIGHT_DECAY):
        self.schedule = lr if callable(lr) else None
        self.count = 0
        super().__init__(params, lr=self.schedule(0) if self.schedule else lr,
                         betas=(B1, B2), eps=EPS, weight_decay=weight_decay)

    def step(self, closure=None):
        if self.schedule is not None:
            for group in self.param_groups:
                group["lr"] = self.schedule(self.count)
        out = super().step(closure)
        self.count += 1
        return out


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0) -> Schedule:
    """optax.warmup_cosine_decay_schedule (exponent 1): linear from
    `init_value` to `peak_value` over `warmup_steps`, then a cosine from
    `peak_value` to `end_value` over the remaining `decay_steps -
    warmup_steps`, constant after."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine_steps = decay_steps - warmup_steps
    if cosine_steps <= 0:
        raise ValueError(f"decay_steps ({decay_steps}) must exceed warmup_steps "
                         f"({warmup_steps})")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - max(count, 0) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        t = min(count - warmup_steps, cosine_steps)
        return peak_value * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / cosine_steps))
                             + alpha)

    return schedule
