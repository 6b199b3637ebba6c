"""ReLU MLPs with the JAX package's parameter layout and bf16 contract.

Port of ``apnerf_tpu/models/nn.py``. An :class:`MLP` holds ``w{i}``
[in, out] and ``b{i}`` [out] exactly as ``init_mlp`` names its pytree
leaves, so weights carry across as an identity map. ``apply_mlp`` keeps
the mixed-precision contract of ``nn.py:43-78``: with a compute dtype,
inputs and hidden outputs are rounded to it (the bias is added in that
dtype, after rounding), and only the last layer emits float32.

The slice is forward-only, so parameters are created without gradients.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn


class MLP(nn.Module):
    def __init__(self, layers: Sequence[Tuple[torch.Tensor, torch.Tensor]]):
        super().__init__()
        self.n_layers = len(layers)
        for i, (w, b) in enumerate(layers):
            self.register_parameter(f"w{i}", nn.Parameter(w, requires_grad=False))
            self.register_parameter(f"b{i}", nn.Parameter(b, requires_grad=False))

    @classmethod
    def from_tree(cls, tree: dict, device=None) -> "MLP":
        """From a JAX ``init_mlp`` dict of arrays (numpy or tensors)."""
        n = len(tree) // 2
        as_t = lambda a: torch.as_tensor(np.array(a, np.float32), device=device)
        return cls([(as_t(tree[f"w{i}"]), as_t(tree[f"b{i}"])) for i in range(n)])

    def layers(self) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        return [
            (getattr(self, f"w{i}"), getattr(self, f"b{i}"))
            for i in range(self.n_layers)
        ]


def init_mlp(
    sizes: Sequence[int],
    generator: torch.Generator,
    device=None,
) -> MLP:
    """He-uniform weights and zero biases (``nn.py:26-40``)."""
    layers = []
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        bound = float(np.sqrt(6.0 / fan_in))
        w = torch.rand(
            (fan_in, fan_out), generator=generator, device=generator.device
        ).to(device)
        layers.append(
            (w * (2 * bound) - bound, torch.zeros(fan_out, device=device))
        )
    return MLP(layers)


def apply_mlp(
    params: MLP, x: torch.Tensor, compute_dtype: Optional[torch.dtype] = None
) -> torch.Tensor:
    """ReLU hidden layers and a linear output (``nn.py:43-78``)."""
    layers = params.layers()
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    for i, (w, b) in enumerate(layers):
        last = i == len(layers) - 1
        if compute_dtype is None:
            x = x @ w + b
        elif last:
            # bf16 operands, f32 accumulation and output
            x = x.float() @ w.to(compute_dtype).float() + b
        else:
            x = x @ w.to(compute_dtype) + b.to(compute_dtype)
        if not last:
            x = torch.relu(x)
    return x
