"""The plain references against the port's plain versions, on the CPU at
tiny shapes: the hash encoding, the march, the spectral field, the
proposal render with its variances and the predictive information."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from apbench.reference import ngp_train, spectral_plan
from apbench.weights import load_into, make_member

SMALL_NGP = {"n_levels": 4, "n_features": 4, "log2_hashmap_size": 10, "base_resolution": 4,
             "max_resolution": 64}


def test_apbench_hash_encode_and_its_table_gradient_match_the_port():
    from apnerf_tpu_torch.ops import hashgrid

    g = torch.Generator().manual_seed(3)
    cfg = hashgrid.HashGridConfig(4, 4, 10, 4, 64)
    table = torch.rand((4, 1024, 4), generator=g) - 0.5
    x = torch.rand((300, 3), generator=g) * 1.2 - 0.1  # some outside the unit cube
    cot = torch.randn((300, 16), generator=g)
    t1 = table.clone().requires_grad_(True)
    t2 = table.clone().requires_grad_(True)
    a = hashgrid.hash_encode(t1, x, cfg)
    b = ngp_train.hash_encode(t2, x, SMALL_NGP)
    assert torch.equal(a, b)
    (a * cot).sum().backward()
    (b * cot).sum().backward()
    torch.testing.assert_close(t1.grad, t2.grad, rtol=1e-5, atol=1e-6)


def test_apbench_march_and_lattice_match_the_port():
    from apnerf_tpu_torch.ops import grid_march

    g = torch.Generator().manual_seed(4)
    cfg = {"n_candidates": 700, "near_plane": 0.1, "render_step_size": 1e-2, "cone_angle": 0.004}
    ours = ngp_train.lattice(cfg)
    np.testing.assert_array_equal(ours, grid_march.candidate_lattice(700, 0.1, 1e-2, 0.004))
    edges = torch.as_tensor(ours)
    aabb = torch.tensor([-2.0, 0.0, -2.0, 0.0, 1.0, 0.0])
    bins = torch.rand((10, 5, 10), generator=g) > 0.4
    o = torch.tensor([-1.0, 0.5, -1.0]) + 0.3 * torch.randn((64, 3), generator=g)
    d = torch.nn.functional.normalize(torch.randn((64, 3), generator=g), dim=-1)
    a = grid_march.march_rays(o, d, bins, aabb, edges, 48)
    b = ngp_train.march(o, d, bins, aabb, edges, 48)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _flagship_cfg():
    return {"field_type": "spectral", "geo_feat_dim": 15, "num_semantic_classes": 7,
            "n_levels": 4, "spectral_freqs_per_level": 4, "spectral_neurons": 32,
            "spectral_layers": 3, "base_resolution": 16, "max_resolution": 4096,
            "prop_levels": 8, "prop_freqs_per_level": 4, "prop_base_freq": 4.0,
            "prop_neurons": 16, "prop_layers": 2, "aabb": [0.0, 0.0, 0.0, 4.0, 4.0, 4.0],
            "near_plane": 0.1, "far_plane": 1e10, "num_prop_samples": 12,
            "max_samples_unc": 24, "n_ensembles": 2, "compute_dtype": "float32"}


def _port_members(cfg, leaves_list):
    """Port fields in float32 compute holding the benchmark's leaves, whose
    frequencies are bfloat16 values (so the reference's rounding is exact)."""
    from apnerf_tpu_torch.models import spectral
    from apnerf_tpu_torch.train.flagship import FlagshipMember

    aabb = tuple(cfg["aabb"])
    s_cfg = spectral.SpectralConfig(aabb=aabb, neurons=cfg["spectral_neurons"], layers=3,
                                    n_levels=cfg["n_levels"], freqs_per_level=4,
                                    num_semantic_classes=cfg["num_semantic_classes"],
                                    compute_dtype="float32")
    p_cfg = spectral.SpectralDensityConfig(aabb=aabb, neurons=cfg["prop_neurons"],
                                           compute_dtype="float32")
    g = torch.Generator().manual_seed(0)
    members = []
    for leaves in leaves_list:
        for k in ("main.W", "prop.W"):
            leaves[k] = leaves[k].to(torch.bfloat16).float()
        m = FlagshipMember(spectral.init_spectral(s_cfg, g),
                           spectral.init_spectral_density(p_cfg, g))
        load_into(m, leaves)
        members.append(m)
    return members, s_cfg, p_cfg


def test_apbench_spectral_render_and_scores_match_the_port_in_float32():
    from apnerf_tpu_torch.active.uncertainty import predictive_information
    from apnerf_tpu_torch.models import spectral
    from apnerf_tpu_torch.render.prop_renderer import render_rays_prop

    cfg = _flagship_cfg()
    g = torch.Generator().manual_seed(5)
    leaves = [make_member(cfg, g) for _ in range(2)]
    members, s_cfg, p_cfg = _port_members(cfg, leaves)
    aabb = torch.tensor(cfg["aabb"])
    # positions on a 1/64 lattice: bfloat16 values in the unit cube, so the
    # encoding's rounding changes nothing and both sides see the same input
    x = torch.randint(1, 255, (500, 3), generator=g).float() / 64.0
    dirs = torch.nn.functional.normalize(torch.randn((500, 3), generator=g), dim=-1)
    ours = spectral_plan.main_field(leaves[0], x, dirs, aabb, "f32", torch.bfloat16)
    port = spectral.forward(members[0].main, s_cfg, x, dirs)
    for a, b in zip(ours, port):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)

    o = torch.tensor([2.0, 2.0, 2.0]) + 0.5 * torch.randn((40, 3), generator=g)
    d = torch.nn.functional.normalize(torch.randn((40, 3), generator=g), dim=-1)
    ref_views, port_views = [], []
    for m, lv in zip(members, leaves):
        ref_views.append(spectral_plan.render_view(lv, o, d, cfg, aabb, "f32"))
        port_views.append(render_rays_prop(
            lambda p, dd, m=m: spectral.forward(m.main, s_cfg, p, dd),
            lambda p, m=m: spectral.query_density_field(m.prop, p_cfg, p), o, d, aabb,
            num_samples=cfg["max_samples_unc"], num_prop_samples=cfg["num_prop_samples"],
            near_plane=cfg["near_plane"], render_bkgd=torch.zeros(3), stratified=False,
            with_variance=True))
    for k in ("rgb", "opacity", "depth", "sem", "rgb_var", "depth_var"):
        torch.testing.assert_close(ref_views[0][k], port_views[0][k], rtol=2e-4, atol=2e-5)
    ours = spectral_plan.predictive_information(
        {k: torch.stack([r[k] for r in ref_views])[:, None] for k in spectral_plan.RENDERED})
    st = {k: torch.stack([p[k] for p in port_views])[:, None] for k in port_views[0]}
    port = predictive_information(st["rgb_var"], st["depth_var"][..., 0], st["sem"],
                                  st["opacity"][..., 0])
    np.testing.assert_allclose(ours, [float(t) for t in port], rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("precision", ["tf32", "fp8"])
def test_apbench_lower_precisions_round_the_operands(precision):
    from apbench.reference.common import _operand

    x = torch.tensor([1.0, 1.0 + 2.0**-12, 1.0 + 3 * 2.0**-11, 0.3])
    y = _operand(x, precision)
    assert y[0] == 1.0 and y[1] == 1.0
    assert y[2] != x[2] and (y - x).abs().max() > 0
    if precision == "tf32":
        assert y[2] == 1.0 + 2.0**-9  # a tie rounds to the even neighbour
