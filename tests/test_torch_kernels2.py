"""The plain versions of the render kernels against the JAX package's
Pallas kernels, and the renderer's packed branches, on the CPU.

``fused_field_heads_plain`` and ``fused_field_volrend_plain`` (what the
port's wrappers run for CPU tensors, and what ``chip_smoke.py`` holds the
CUDA kernels to on the card) are held to ``fused_field_heads`` and
``fused_field_volrend`` of the JAX package run in interpret mode, as
``tests/test_pallas_fused_field.py`` and ``tests/test_pallas_fused_volrend.py``
run them: same numpy inputs from a seed, the JAX initialiser's weights with
seeded noise on the biases, 2- and 3-hidden-layer trunks, shapes the TPU
layout plan admits, some rays missing the box.

Tolerances. The two sides differ by the bias convention (the Pallas
kernels add biases in f32 before rounding to bf16, the plain chain in
bf16 after) and by bf16 rounding flips, so every output is compared on
its tensor's scale (max-abs error / max-abs of the reference), as the JAX
package's own kernel tests do: rgb, logits and per-ray sums 2e-2, sigma
2e-2 of scale, weights 2e-2 absolute. Rays that miss the box are exactly
zero on both sides. The renderer's branches against each other: 2e-2
(the JAX tests' limit); a float32 field 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apnerf_tpu.models import spectral as j_sp
from apnerf_tpu.render import prop_renderer as j_pr
from apnerf_tpu_torch.models import spectral as t_sp
from apnerf_tpu_torch.ops.cuda.fused_field_heads import (
    fused_field_heads,
    fused_field_heads_plain,
)
from apnerf_tpu_torch.ops.cuda.fused_field_volrend import (
    fused_field_volrend,
    fused_field_volrend_plain,
)
from apnerf_tpu_torch.render import prop_renderer as t_pr

AABB = (-1.0, -1.0, -1.0, 1.0, 1.0, 1.0)
C = 5


def T(a):
    return torch.as_tensor(np.array(a))


def on_scale(port, ref, rel):
    port = port.detach().float().numpy() if torch.is_tensor(port) else np.asarray(port)
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    err = np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-6)
    assert err <= rel, (err, rel)


def cfgs(layers=3, dtype="bfloat16"):
    kw = dict(aabb=AABB, n_levels=4, freqs_per_level=2, base_freq=4.0, max_freq=32.0,
              neurons=32, layers=layers, geo_feat_dim=7, num_semantic_classes=C,
              compute_dtype=dtype)
    return j_sp.SpectralConfig(**kw), t_sp.SpectralConfig(**kw)


def fields(cfg_j, seed=0):
    """The JAX initialiser's main field with noisy biases → (JAX params,
    the port's module holding the same arrays)."""
    params = jax.tree.map(np.asarray, j_sp.init_spectral(jax.random.PRNGKey(seed), cfg_j))
    rng = np.random.default_rng(seed)
    for mlp in ("mlp_base", "mlp_head", "mlp_sem"):
        for k in params[mlp]:
            if k.startswith("b"):
                params[mlp][k] = rng.normal(0, 0.1, params[mlp][k].shape).astype(np.float32)
    return jax.tree.map(jnp.asarray, params), t_sp.SpectralField.from_tree(params)


def inputs(R, S, seed=1):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1.3, 1.3, (R, S, 3)).astype(np.float32)  # straddles the box
    dirs = rng.normal(size=(R, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    edges = np.sort(rng.uniform(0.1, 3.0, (R, S + 1)).astype(np.float32), axis=-1)
    miss = (np.arange(R) % 17) == 0
    return pos, dirs, edges[:, :-1].copy(), edges[:, 1:].copy(), miss


@pytest.mark.parametrize("layers", [2, 3])
def test_field_heads_plain_matches_pallas(layers):
    cfg_j, cfg_t = cfgs(layers)
    pj, pt = fields(cfg_j)
    R, S = 32, 8
    pos, dirs, _, _, _ = inputs(R, S)
    y_j = np.asarray(j_sp.forward_packed(pj, cfg_j, jnp.asarray(pos), jnp.asarray(dirs)))
    assert y_j.shape == (4 + C, R, S)
    with torch.no_grad():
        y_t = t_sp.forward_packed(pt, cfg_t, T(pos), T(dirs))
        u, sh = t_sp._packed_inputs(cfg_t, T(pos), T(dirs))
        direct = fused_field_heads_plain(list(pt.parameters()), u, sh, S)
    assert y_t.shape == (R, S, 4 + C)
    # the wrapper takes the plain version for CPU tensors, and counts nothing
    assert torch.equal(y_t.reshape(-1, 4 + C), direct) and fused_field_heads.launches == 0
    y_j = np.moveaxis(y_j, 0, -1)  # the TPU layout is channel-major
    on_scale(y_t[..., 0:3], y_j[..., 0:3], 2e-2)  # rgb
    on_scale(y_t[..., 3], y_j[..., 3], 2e-2)  # sigma
    on_scale(y_t[..., 4:], y_j[..., 4:], 2e-2)  # logits
    outside = (np.abs(pos) >= 1.0).any(-1)
    assert outside.any() and (y_t[..., 3].numpy()[outside] == 0).all()


@pytest.mark.parametrize("layers", [2, 3])
def test_field_volrend_plain_matches_pallas(layers):
    cfg_j, cfg_t = cfgs(layers)
    pj, pt = fields(cfg_j)
    R, S = 128, 8  # whole 128-ray blocks, as the TPU layout plan asks
    pos, dirs, t0, t1, miss = inputs(R, S)
    acc_j, w_j = j_sp.forward_packed_volrend(
        pj, cfg_j, *(jnp.asarray(a) for a in (pos, dirs, t0, t1, miss)))
    with torch.no_grad():
        acc_t, w_t = t_sp.forward_packed_volrend(pt, cfg_t, *(T(a) for a in (pos, dirs, t0, t1, miss)))
    assert acc_t.shape == (R, 5 + C) and w_t.shape == (R, S)
    assert fused_field_volrend.launches == 0
    acc_j = np.asarray(acc_j).T  # the TPU layout is [5 + C, R]
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=0, atol=2e-2)
    for cols in (slice(0, 3), slice(3, 4), slice(4, 5), slice(5, 5 + C)):
        on_scale(acc_t[:, cols], acc_j[:, cols], 2e-2)
    assert miss.any()
    assert (w_t.numpy()[miss] == 0).all() and (acc_t.numpy()[miss] == 0).all()
    assert (np.asarray(w_j)[miss] == 0).all()


def test_field_volrend_plain_any_shape_and_float32():
    """Neither R nor S is bound to the TPU's plan, and in float32 the plain
    version is the unfused oracle's math to rounding: spectral.forward,
    the weights and the accumulation einsums."""
    _, cfg_t = cfgs(3, "float32")
    _, pt = fields(cfgs(3)[0])
    R, S = 37, 11
    pos, dirs, t0, t1, miss = (T(a) for a in inputs(R, S))
    with torch.no_grad():
        acc, w = t_sp.forward_packed_volrend(pt, cfg_t, pos, dirs, t0, t1, miss)
        rgb, sigma, sem = t_sp.forward(pt, cfg_t, pos, dirs[:, None, :].expand(pos.shape))
        from apnerf_tpu_torch.ops import volrend

        w_ref, _, _ = volrend.render_weight_from_density(t0, t1, sigma[..., 0] * ~miss[:, None])
        ref = torch.cat([
            torch.einsum("rs,rsc->rc", w_ref, rgb), w_ref.sum(-1, keepdim=True),
            (w_ref * 0.5 * (t0 + t1)).sum(-1, keepdim=True),
            torch.einsum("rs,rsc->rc", w_ref, sem)], dim=-1)
    np.testing.assert_allclose(w.numpy(), w_ref.numpy(), rtol=1e-5, atol=1e-6)
    on_scale(acc, ref.numpy(), 1e-4)
    with torch.no_grad():
        u, sh = t_sp._packed_inputs(cfg_t, pos, dirs)
        direct = fused_field_volrend_plain(
            list(pt.parameters()), u, sh, ((t1 - t0) * ~miss[:, None]).reshape(-1),
            (0.5 * (t0 + t1)).reshape(-1), S, torch.float32)
    assert torch.equal(direct[0], acc)


def _render_setup(dtype):
    cfg_j, cfg_t = cfgs(3, dtype)
    pj, pt = fields(cfg_j)
    p_kw = dict(aabb=AABB, neurons=16, layers=2, n_levels=2, freqs_per_level=2,
                base_freq=2.0, max_freq=8.0, compute_dtype=dtype)
    pc_j, pc_t = j_sp.SpectralDensityConfig(**p_kw), t_sp.SpectralDensityConfig(**p_kw)
    pp_j = jax.tree.map(np.asarray, j_sp.init_spectral_density(jax.random.PRNGKey(3), pc_j))
    pp_t = t_sp.SpectralDensityField.from_tree(pp_j)
    rng = np.random.default_rng(11)
    R = 128
    rays_o = rng.uniform(-2.0, 2.0, (R, 3)).astype(np.float32)
    rays_d = rng.normal(size=(R, 3)).astype(np.float32)
    rays_d /= np.linalg.norm(rays_d, axis=-1, keepdims=True)
    return cfg_j, cfg_t, pj, pt, pc_j, pc_t, jax.tree.map(jnp.asarray, pp_j), pp_t, rays_o, rays_d


@pytest.mark.parametrize("with_variance", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_renderer_packed_branches(dtype, with_variance):
    """``render_rays_prop``'s packed branch (with and without variance)
    and its fused field-and-render branch (without) against its plain
    branch and against the JAX renderer's plain branch."""
    cfg_j, cfg_t, pj, pt, pc_j, pc_t, pp_j, pp_t, rays_o, rays_d = _render_setup(dtype)
    S, bk = 8, np.array([0.2, 0.3, 0.4], np.float32)
    out_j, _ = j_pr.render_rays_prop(
        lambda p, d: j_sp.forward(pj, cfg_j, p, d),
        lambda p: j_sp.query_density_field(pp_j, pc_j, p),
        jnp.asarray(rays_o), jnp.asarray(rays_d), jnp.asarray(AABB, jnp.float32),
        jax.random.PRNGKey(0), num_samples=S, num_prop_samples=8, near_plane=0.1,
        render_bkgd=jnp.asarray(bk), stratified=False, with_variance=with_variance,
    )

    def render(**branch):
        with torch.no_grad():
            return t_pr.render_rays_prop(
                lambda p, d: t_sp.forward(pt, cfg_t, p, d),
                lambda p: t_sp.query_density_field(pp_t, pc_t, p),
                T(rays_o), T(rays_d), T(np.array(AABB, np.float32)), num_samples=S,
                num_prop_samples=8, near_plane=0.1, render_bkgd=T(bk), stratified=False,
                with_variance=with_variance, **branch,
            )

    plain = render()
    branches = {"packed": render(
        field_packed_fn=lambda p, rd: t_sp.forward_packed(pt, cfg_t, p, rd))}
    # with variance the fused branch is not taken: the packed one is, as in the JAX renderer
    branches["fused"] = render(
        field_packed_fn=lambda p, rd: t_sp.forward_packed(pt, cfg_t, p, rd),
        field_packed_vr_fn=lambda p, rd, t0, t1, m: t_sp.forward_packed_volrend(
            pt, cfg_t, p, rd, t0, t1, m),
    )
    rel = 1e-4 if dtype == "float32" else 2e-2
    keys = {"rgb", "opacity", "depth", "sem", "n_samples"}
    if with_variance:
        keys |= {"rgb_var", "depth_var"}
    assert set(plain) == keys == set(out_j)
    for name, out in branches.items():
        assert set(out) == keys, name
        for k in keys - {"n_samples"}:
            on_scale(out[k], plain[k].numpy(), rel)
            on_scale(out[k], np.asarray(out_j[k]), rel)
        assert int(out["n_samples"]) == int(plain["n_samples"]) == int(out_j["n_samples"])
    if with_variance:
        for k in keys - {"n_samples"}:
            assert torch.equal(branches["fused"][k], branches["packed"][k])


def test_packed_kernels_refuse_what_they_do_not_take():
    """The CPU branch is taken for CPU tensors only (on the card the same
    calls go through the kernels' own backwards). Here: shapes are checked
    by the plain math, autograd goes through the plain versions, and the
    counters stay at zero."""
    _, cfg_t = cfgs(3)
    _, pt = fields(cfgs(3)[0])
    pos, dirs, t0, t1, miss = (T(a) for a in inputs(4, 8))
    y = t_sp.forward_packed(pt, cfg_t, pos, dirs)  # grad enabled: plain autograd works
    assert y.requires_grad
    acc, w = t_sp.forward_packed_volrend(pt, cfg_t, pos, dirs, t0, t1, miss)
    assert acc.requires_grad and w.shape == (4, 8)
    assert fused_field_heads.launches == 0 and fused_field_volrend.launches == 0
    with pytest.raises(ValueError, match="unsupported device"):
        fused_field_heads(list(pt.parameters()), torch.empty((8, 3), device="meta"),
                          torch.empty((1, 16), device="meta"), 8)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_field_volrend(list(pt.parameters()), torch.empty((8, 3), device="meta"),
                            torch.empty((1, 16), device="meta"),
                            torch.empty(8, device="meta"), torch.empty(8, device="meta"), 8)
