"""Carry weights from the JAX package into the port, with numpy only.

Parameters keep the JAX layout, so the map is an identity on arrays:
``W`` [3, M], ``phase`` [M] and MLP leaves ``w{i}`` [in, out] / ``b{i}``
[out]. A checkpoint trained by the JAX package can be rendered, or
trained further, on the GPU without JAX installed: the members'
parameters are trainable. Carrying the optimizer state across and
writing ``model_{i}.npz`` from the port come with the mapper loop.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np
import torch

from .train.flagship import FlagshipMember


def _member_tree(tree: dict, i: int) -> dict:
    return {
        k: _member_tree(v, i) if isinstance(v, dict) else np.asarray(v)[i]
        for k, v in tree.items()
    }


def params_from_jax(tree: dict, device=None) -> List[FlagshipMember]:
    """JAX ensemble params ``{"main": {...}, "prop": {...}}`` as nested
    dicts of numpy arrays with a leading E axis → E port members, with
    trainable parameters."""
    E = np.asarray(tree["main"]["W"]).shape[0]
    return [FlagshipMember.from_tree(_member_tree(tree, i), device) for i in range(E)]


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def load_member_npz(path, device=None) -> Tuple[FlagshipMember, torch.Tensor, torch.Tensor]:
    """One ``model_{i}.npz`` written by ``ActiveNeRFMapper.save_checkpoints``
    (keys ``main/W``, ``main/mlp_base/w0``, …, ``occ_grid``, ``occs``) →
    (member, occs [n] f32, binaries [Gx, Gy, Gz] bool). Optimizer leaves
    and the step are ignored: they belong to training."""
    with np.load(os.fspath(path)) as data:
        flat = {k: data[k] for k in data.files if k.startswith(("main/", "prop/"))}
        occs = torch.as_tensor(data["occs"].astype(np.float32), device=device)
        binaries = torch.as_tensor(data["occ_grid"].astype(bool), device=device)
    return FlagshipMember.from_tree(_unflatten(flat), device), occs, binaries
