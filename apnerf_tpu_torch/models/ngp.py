"""Density activation shared by the fields.

Port of ``apnerf_tpu/models/ngp.py::trunc_exp``, forward only: the
slice never differentiates it. (The JAX version clamps the exponent of
its gradient at 15; the training port adds that backward.)
"""

from __future__ import annotations

import torch


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(x)
