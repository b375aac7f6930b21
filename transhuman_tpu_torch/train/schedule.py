"""Learning rate: linear warmup into cosine annealing, stepped per epoch
(counterpart of transhuman_tpu/train/schedule.py)."""

from __future__ import annotations

import math


def warmup_cosine_epoch_schedule(base_lr: float = 7e-4, end_lr: float = 1e-6,
                                 warmup_epochs: int = 300,
                                 decay_epochs: int = 3000,
                                 iters_per_epoch: int = 500):
    """lr(step): epoch = step // iters_per_epoch; linear (epoch + 1) /
    warmup_epochs of base_lr during the warmup, then cosine from base_lr to
    end_lr over the remaining decay_epochs - warmup_epochs."""
    t_max = max(decay_epochs - warmup_epochs, 1)

    def schedule(step: int) -> float:
        epoch = int(step) // iters_per_epoch
        if epoch < warmup_epochs:
            return base_lr * min((epoch + 1) / max(warmup_epochs, 1), 1.0)
        t = min(max(epoch - warmup_epochs, 0), t_max)
        return end_lr + 0.5 * (base_lr - end_lr) * (
            1 + math.cos(math.pi * t / t_max))

    return schedule
