"""Seeded weights of the benchmark's fields, made on the device.

Both the program and the plain reference get these same tensors: the
program's parameters are overwritten with them by name, and the
reference reads them as they are. The layout (names, shapes) is the
published one of each field; the values follow each paper's
initialisation: Instant-NGP's table U(-1e-4, 1e-4), He-uniform weights
and zero biases, a random Fourier feature's isotropic directions on a
geometric ladder of band frequencies and uniform phases. Each member is
two calls on the card's generator: one uniform draw for every leaf and
one normal draw for the frequencies' directions.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch


def _mlp(prefix: str, sizes) -> List[Tuple[str, tuple, str]]:
    out = []
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        out += [(f"{prefix}.w{i}", (a, b), f"he:{a}"), (f"{prefix}.b{i}", (b,), "zero")]
    return out


def layout(cfg: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, rule) of one member's leaves, in the order drawn."""
    G, C = cfg["geo_feat_dim"], cfg["num_semantic_classes"]
    if cfg["field_type"] == "ngp":
        L, T, F = cfg["n_levels"], 1 << cfg["log2_hashmap_size"], cfg["n_features"]
        H = cfg["main_neurons"]
        return ([("table", (L, T, F), "table")]
                + _mlp("mlp_base", [L * F] + [H] * cfg["main_layer"] + [1 + G])
                + _mlp("mlp_head", [16 + G, H // 2, H // 2, 3])
                + _mlp("mlp_sem", [G, H // 2, H // 2, C]))
    M = cfg["n_levels"] * cfg["spectral_freqs_per_level"]
    H = cfg["spectral_neurons"]
    Mp = cfg["prop_levels"] * cfg["prop_freqs_per_level"]
    return ([("main.W", (3, M), "freq:main"), ("main.phase", (M,), "phase")]
            + _mlp("main.mlp_base", [2 * M] + [H] * cfg["spectral_layers"] + [1 + G])
            + _mlp("main.mlp_head", [16 + G, H // 4, H // 4, 3])
            + _mlp("main.mlp_sem", [G, H // 4, H // 4, C])
            + [("prop.W", (3, Mp), "freq:prop"), ("prop.phase", (Mp,), "phase")]
            + _mlp("prop.mlp_base", [2 * Mp] + [cfg["prop_neurons"]] * cfg["prop_layers"] + [1]))


def _frequencies(cfg: dict, which: str, normal: torch.Tensor) -> torch.Tensor:
    if which == "main":
        levels, per, lo, hi = (cfg["n_levels"], cfg["spectral_freqs_per_level"],
                               float(cfg["base_resolution"]), float(cfg["max_resolution"]))
    else:
        levels, per, lo, hi = (cfg["prop_levels"], cfg["prop_freqs_per_level"],
                               cfg["prop_base_freq"], float(min(cfg["max_resolution"], 256)))
    scales = torch.as_tensor(np.exp(np.linspace(np.log(lo), np.log(hi), levels)),
                             dtype=torch.float32, device=normal.device)
    dirs = normal.reshape(levels, per, 3)
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    return (dirs * scales[:, None, None]).reshape(levels * per, 3).T.contiguous()


def make_member(cfg: dict, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """One member's leaves from ``generator`` (on the device the leaves live on)."""
    spec = layout(cfg)
    dev = generator.device
    sizes = [int(np.prod(s)) for _, s, _ in spec]
    uni = torch.rand((sum(sizes),), generator=generator, device=dev)
    n_dirs = sum(s[1] * 3 for _, s, r in spec if r.startswith("freq"))
    normal = torch.randn((max(n_dirs, 1),), generator=generator, device=dev)
    out, at, dat = {}, 0, 0
    for (name, shape, rule), n in zip(spec, sizes):
        u = uni[at:at + n].reshape(shape)
        at += n
        if rule == "table":
            out[name] = u * 2e-4 - 1e-4
        elif rule.startswith("he:"):
            bound = float(np.sqrt(6.0 / int(rule[3:])))
            out[name] = u * (2 * bound) - bound
        elif rule == "zero":
            out[name] = torch.zeros(shape, device=dev)
        elif rule == "phase":
            out[name] = u * (2 * np.pi)
        else:
            k = shape[1] * 3
            out[name] = _frequencies(cfg, rule[5:], normal[dat:dat + k])
            dat += k
    return out


def make_ensemble(cfg: dict, seed: int, device) -> List[Dict[str, torch.Tensor]]:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return [make_member(cfg, g) for _ in range(cfg["n_ensembles"])]


@torch.no_grad()
def load_into(member: torch.nn.Module, leaves: Dict[str, torch.Tensor]) -> None:
    """Overwrite a program member's parameters with ``leaves``, by name; a
    name or shape that does not match raises."""
    params = dict(member.named_parameters())
    if set(params) != set(leaves):
        raise ValueError(f"the member's leaves {sorted(params)} are not the benchmark's "
                         f"{sorted(leaves)}")
    for name, p in params.items():
        if tuple(p.shape) != tuple(leaves[name].shape):
            raise ValueError(f"{name}: the member's shape {tuple(p.shape)} is not the "
                             f"benchmark's {tuple(leaves[name].shape)}")
        p.copy_(leaves[name])
