"""Operations, bytes and peaks: the yardstick of the per-layer metrics.

The bound of a piece of work is the least time one NVIDIA H100 could
take for it: the larger of its operations over the peak rate of its
precision and its bytes (each input read once, each output written once)
over the memory's rate. Work is counted from the shapes the inputs need,
whatever evaluates it: on the occupancy path the samples the march keeps,
on the proposal path every sample.
"""

from __future__ import annotations

from typing import Tuple

# NVIDIA H100 SXM data sheet: dense rates at 700 W
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def bound(flops: float, n_bytes: float, peak_flops: float = PEAK_BF16_FLOPS) -> Tuple[float, str]:
    """→ (ms, "operations" or "bytes", whichever bounds it)."""
    t_ops, t_bytes = flops / peak_flops, n_bytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def mlp_macs(sizes) -> int:
    return sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))


def field_macs(M: int, H: int, n_hidden: int, G: int, hh: int, C: int) -> int:
    """Multiply-adds of one spectral field row: the encoding's K = 3
    product, the trunk, the rgb head on SH(16) ++ G and the semantic head."""
    trunk = 2 * M * H + (n_hidden - 1) * H * H + H * (1 + G)
    heads = (16 + G) * hh + hh * hh + hh * 3 + G * hh + hh * hh + hh * C
    return 3 * M + trunk + heads


def spectral_macs(cfg: dict) -> int:
    M, H = cfg["n_levels"] * cfg["spectral_freqs_per_level"], cfg["spectral_neurons"]
    return field_macs(M, H, cfg["spectral_layers"], cfg["geo_feat_dim"], H // 4,
                      cfg["num_semantic_classes"])


def prop_macs(cfg: dict) -> int:
    Mp = cfg["prop_levels"] * cfg["prop_freqs_per_level"]
    return 3 * Mp + mlp_macs([2 * Mp] + [cfg["prop_neurons"]] * cfg["prop_layers"] + [1])


def spectral_weight_bytes(cfg: dict) -> int:
    """float32 bytes of the main field's leaves."""
    M, H = cfg["n_levels"] * cfg["spectral_freqs_per_level"], cfg["spectral_neurons"]
    G, C, hh = cfg["geo_feat_dim"], cfg["num_semantic_classes"], H // 4

    def mlp_params(sizes):
        return sum(a * b + b for a, b in zip(sizes[:-1], sizes[1:]))

    n = 4 * M + mlp_params([2 * M] + [H] * cfg["spectral_layers"] + [1 + G])
    n += mlp_params([16 + G, hh, hh, 3]) + mlp_params([G, hh, hh, C])
    return 4 * n


def field_heads_fwd_bound(cfg: dict, R: int, S: int) -> Tuple[float, str]:
    """The packed field forward (K4) at R rays of S samples: 2 operations a
    multiply-add in bf16; u read and the packed row written a sample, the
    SH read a ray, the weights read."""
    C = cfg["num_semantic_classes"]
    return bound(2 * spectral_macs(cfg) * R * S,
                 R * S * (12 + 4 * (4 + C)) + R * 64 + spectral_weight_bytes(cfg))


def hash_table_bwd_bound(cfg: dict, n_samples: int) -> Tuple[float, str]:
    """The hash table's backward at the encoding's boundary for n samples:
    L x 8 terms a sample of F features, 2 float32 operations a term and
    feature; each term's index and weight read, the cotangent [L N, F]
    read, the table's gradient [L T, F] written."""
    L, F, T = cfg["n_levels"], cfg["n_features"], 1 << cfg["log2_hashmap_size"]
    terms = L * 8 * n_samples
    return bound(2 * terms * F, terms * 8 + L * n_samples * F * 4 + L * T * F * 4, PEAK_F32_FLOPS)


def ngp_mlp_macs(cfg: dict) -> int:
    """Multiply-adds of the NGP field's three MLPs on one sample."""
    H, G, C = cfg["main_neurons"], cfg["geo_feat_dim"], cfg["num_semantic_classes"]
    L, F = cfg["n_levels"], cfg["n_features"]
    return (mlp_macs([L * F] + [H] * cfg["main_layer"] + [1 + G])
            + mlp_macs([16 + G, H // 2, H // 2, 3]) + mlp_macs([G, H // 2, H // 2, C]))


def ngp_train_flops(cfg: dict, kept_samples: float) -> float:
    """Matrix-product operations of the train step's forward and backward
    (2 + 4 a multiply-add) on the samples the march kept."""
    return 6.0 * ngp_mlp_macs(cfg) * kept_samples


def plan_flops(cfg: dict, n_candidates: int, n_views: int, n_rays: int) -> float:
    """Forward operations of the candidate render: every member, view and
    ray, the main field at every sample, the proposal field at every
    proposal sample."""
    per_ray = (spectral_macs(cfg) * cfg["max_samples_unc"]
               + prop_macs(cfg) * cfg["num_prop_samples"])
    return 2.0 * per_ray * n_rays * n_views * cfg["n_ensembles"] * n_candidates
