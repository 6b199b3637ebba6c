"""Predictive-information scoring of candidate trajectories.

Port of ``apnerf_tpu/active/uncertainty.py``. Over stacked [E, V, P, ...]
ensemble renders:

  * RGB / depth: Gaussian predictive information, H(mixture variance)
    minus the mean member H(member variance), H = log(2πe σ² + 1e-4)/2;
  * semantics: entropy of the mean softmax minus the mean member entropy;
  * occupancy: Bernoulli entropy of the accumulated opacity.

PI = I_rgb + I_dep + 3·I_sem + 2·I_occ.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class PredictiveInformation(NamedTuple):
    rgb: torch.Tensor
    depth: torch.Tensor
    sem: torch.Tensor  # already x3 weighted
    occ: torch.Tensor  # already x2 weighted

    @property
    def total(self) -> torch.Tensor:
        return self.rgb + self.depth + self.sem + self.occ


_TWO_PI_E = 2 * np.pi * np.e


def _gaussian_pi(member_var: torch.Tensor) -> torch.Tensor:
    """member_var: [E, ...] per-member predictive variance."""
    n = member_var.shape[0]
    mean_cond_H = (torch.log(_TWO_PI_E * member_var + 1e-4) / 2).mean(dim=0)
    mix_var = member_var.sum(dim=0) / n
    H = torch.log(_TWO_PI_E * mix_var + 1e-4) / 2
    return (H - mean_cond_H).mean()


def _categorical_pi(logits: torch.Tensor) -> torch.Tensor:
    """logits: [E, ..., C] per-member semantic logits."""
    p = torch.softmax(logits, dim=-1)
    mean_cond_H = (-((p + 1e-4) * torch.log(p + 1e-4)).sum(dim=-1)).mean(dim=0)
    p_mix = p.mean(dim=0)
    H = -((p_mix + 1e-4) * torch.log(p_mix + 1e-4)).sum(dim=-1)
    return (H - mean_cond_H).mean()


def _bernoulli_pi(acc: torch.Tensor) -> torch.Tensor:
    """acc: [E, ...] accumulated opacities."""

    def H(p):
        return -(p + 1e-4) * torch.log(p + 1e-4) - (1 - p + 1e-4) * torch.log(1 - p + 1e-4)

    return (H(acc.mean(dim=0)) - H(acc).mean(dim=0)).mean()


def predictive_information(
    rgb_var: torch.Tensor,  # [E, V, P, 3]
    depth_var: torch.Tensor,  # [E, V, P]
    sem_logits: torch.Tensor,  # [E, V, P, C]
    acc: torch.Tensor,  # [E, V, P]
) -> PredictiveInformation:
    return PredictiveInformation(
        rgb=_gaussian_pi(rgb_var),
        depth=_gaussian_pi(depth_var),
        sem=_categorical_pi(sem_logits) * 3.0,
        occ=_bernoulli_pi(acc) * 2.0,
    )
