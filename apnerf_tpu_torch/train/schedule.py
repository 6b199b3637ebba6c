"""Learning-rate schedules.

Port of ``apnerf_tpu/train/schedule.py::cyclic_lr`` (``:16-30``):
``torch.optim.lr_scheduler.CyclicLR(mode="exp_range")``'s triangular
waveform, whose peak decays by ``gamma`` per cycle. The schedule takes
the optimizer's own update count as a tensor and returns a 0-dim f32
tensor on the count's device, so the train step reads it without a host
sync. ``multistep_lr`` waits for the final refit of the mapper loop.
"""

from __future__ import annotations

import torch


def cyclic_lr(base_lr: float, max_lr: float, step_size_up: int, gamma: float = 1.0):
    def schedule(count) -> torch.Tensor:
        count = torch.as_tensor(count, dtype=torch.float32)
        cycle = torch.floor(1.0 + count / (2.0 * step_size_up))
        x = torch.abs(count / step_size_up - 2.0 * cycle + 1.0)
        amp = (max_lr - base_lr) * torch.pow(torch.as_tensor(gamma, dtype=torch.float32,
                                                             device=count.device), cycle - 1.0)
        return base_lr + amp * torch.clamp(1.0 - x, min=0.0)

    return schedule
