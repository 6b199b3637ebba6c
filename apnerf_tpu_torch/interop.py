"""Carry weights and checkpoints between the JAX package and the port,
with numpy only.

Parameters keep the JAX layout, so the map is an identity on arrays:
``W`` [3, M], ``phase`` [M], the hash ``table`` [L, T, F] and MLP leaves
``w{i}`` [in, out] / ``b{i}`` [out]. Both fields carry across: a
flagship member (``{"main": ..., "prop": ...}``) and an NGP member (the
``init_ngp`` tree: ``table``, ``mlp_base``, ``mlp_head``, ``mlp_sem``),
told apart by the tree's keys. So do the example trainers' fields
(``vanilla_nerf_from_tree``, ``tnerf_from_tree``, ``ndr_tnerf_from_tree``,
``ngp_density_from_tree``, from the trees of ``init_vanilla_nerf``,
``init_tnerf``, ``init_ndr_tnerf`` and ``init_ngp_density``). A
``model_{i}.npz`` has the JAX mapper's keys
(``apnerf_tpu/active/mapper.py:1219-1317``): ``occ_grid``, ``occs``,
``step``, the parameters flattened as ``main/mlp_base/w0`` or ``table``,
``mlp_base/w0``…, and the
optimizer state as ``__opt__{j}``, the leaves of optax's Adam state in
its own order: the update count, every first moment, every second
moment (each set in the sorted-key order of the parameter tree), and the
schedule's count. Either package resumes the other's checkpoint, Adam
moments and count included.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from .models.mlp import NDRTNeRF, TNeRF, VanillaNeRF
from .models.ngp import NGPDensityField, NGPField
from .train.flagship import FlagshipMember
from .train.step import AdamState

Member = Union[FlagshipMember, NGPField]
_NOT_PARAMS = ("occ_grid", "occs", "step")


def member_from_tree(tree: dict, device=None) -> Member:
    """One member's JAX params tree → an NGP field (a tree with a hash
    ``table``) or a flagship member."""
    if "table" in tree:
        return NGPField.from_tree(tree, device)
    return FlagshipMember.from_tree(tree, device)


def vanilla_nerf_from_tree(tree: dict, device=None) -> VanillaNeRF:
    """A JAX ``init_vanilla_nerf`` tree → the port's vanilla NeRF."""
    return VanillaNeRF.from_tree(tree, device)


def tnerf_from_tree(tree: dict, device=None) -> TNeRF:
    """A JAX ``init_tnerf`` tree (``warp``, ``base``) → the port's T-NeRF."""
    return TNeRF.from_tree(tree, device)


def ndr_tnerf_from_tree(tree: dict, device=None) -> NDRTNeRF:
    """A JAX ``init_ndr_tnerf`` tree (``blocks``, ``base``) → the port's
    NDR-TNeRF."""
    return NDRTNeRF.from_tree(tree, device)


def ngp_density_from_tree(tree: dict, device=None) -> NGPDensityField:
    """A JAX ``init_ngp_density`` tree (``table``, ``mlp_base``) → the
    port's proposal field."""
    return NGPDensityField.from_tree(tree, device)


def _member_tree(tree: dict, i: int) -> dict:
    return {
        k: _member_tree(v, i) if isinstance(v, dict) else np.asarray(v)[i]
        for k, v in tree.items()
    }


def params_from_jax(tree: dict, device=None) -> List[Member]:
    """JAX ensemble params (``{"main": {...}, "prop": {...}}`` or the ngp
    tree) as nested dicts of numpy arrays with a leading E axis → E port
    members, with trainable parameters."""
    E = np.asarray(tree["table"] if "table" in tree else tree["main"]["W"]).shape[0]
    return [member_from_tree(_member_tree(tree, i), device) for i in range(E)]


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def load_member_npz(path, device=None) -> Tuple[Member, torch.Tensor, torch.Tensor]:
    """One ``model_{i}.npz`` written by ``ActiveNeRFMapper.save_checkpoints``
    of either package (keys ``main/W``, ``main/mlp_base/w0``, … or
    ``table``, ``mlp_base/w0``, …, and ``occ_grid``, ``occs``) → (member,
    occs [n] f32, binaries [Gx, Gy, Gz] bool); ``load_member_opt`` reads
    the optimizer leaves and the step."""
    with np.load(os.fspath(path)) as data:
        flat = {k: data[k] for k in data.files
                if k not in _NOT_PARAMS and not k.startswith("__opt__")}
        occs = torch.as_tensor(data["occs"].astype(np.float32), device=device)
        binaries = torch.as_tensor(data["occ_grid"].astype(bool), device=device)
    return member_from_tree(_unflatten(flat), device), occs, binaries


def _optax_order(member: Member) -> List[int]:
    """Positions in ``member.parameters()`` of the leaves in optax's
    order: a JAX dict flattens by sorted keys at every level."""
    names = [name.split(".") for name, _ in member.named_parameters()]
    return sorted(range(len(names)), key=lambda i: names[i])


def opt_leaves(member: Member, opt: AdamState) -> List[np.ndarray]:
    """A member's Adam state → the leaves of ``optax.adam``'s state for
    that member, in ``jax.tree_util.tree_leaves`` order."""
    sizes = [p.numel() for p in member.parameters()]
    shapes = [tuple(p.shape) for p in member.parameters()]
    order = _optax_order(member)
    count = opt.count.cpu().numpy().astype(np.int32)
    out = [count]
    for flat in (opt.mu, opt.nu):
        parts = [t.cpu().numpy() for t in flat.split(sizes)]
        out += [parts[i].reshape(shapes[i]) for i in order]
    return out + [count.copy()]


def adam_from_opt_leaves(member: Member, leaves, device=None) -> AdamState:
    """The inverse of ``opt_leaves``: optax's leaves for one member → the
    port's flat Adam state on ``device``."""
    order = _optax_order(member)
    n = len(order)
    if len(leaves) != 2 * n + 2:
        raise ValueError(
            f"expected {2 * n + 2} optimizer leaves (count, {n} first and {n} second "
            f"moments, count), got {len(leaves)}"
        )
    flats = []
    for block in (leaves[1: 1 + n], leaves[1 + n: 1 + 2 * n]):
        by_pos = [None] * n
        for leaf, i in zip(block, order):
            by_pos[i] = np.asarray(leaf, np.float32).reshape(-1)
        flats.append(torch.as_tensor(np.concatenate(by_pos), device=device))
    count = torch.as_tensor(np.asarray(leaves[0]).astype(np.int32), device=device).reshape(())
    return AdamState(flats[0], flats[1], count)


def save_member_npz(path, member: Member, occs, binaries, opt: AdamState,
                    step: int) -> None:
    """Write one ``model_{i}.npz`` with the JAX mapper's keys."""
    flat = {
        name.replace(".", "/"): p.detach().cpu().numpy()
        for name, p in member.named_parameters()
    }
    for j, leaf in enumerate(opt_leaves(member, opt)):
        flat[f"__opt__{j}"] = leaf
    np.savez(
        os.fspath(path), occ_grid=binaries.cpu().numpy(), occs=occs.cpu().numpy(),
        step=int(step), **flat,
    )


def load_member_opt(path, member: Member, device=None) -> Tuple[Optional[AdamState], int]:
    """The optimizer state and the step of one ``model_{i}.npz`` →
    (Adam state, or None when the file holds none; step)."""
    with np.load(os.fspath(path)) as data:
        step = int(data["step"])
        if "__opt__0" not in data.files:
            return None, step
        n = sum(1 for k in data.files if k.startswith("__opt__"))
        leaves = [data[f"__opt__{j}"] for j in range(n)]
    return adam_from_opt_leaves(member, leaves, device), step
