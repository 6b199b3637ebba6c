"""Fields at the tile's other widths, and the route each field takes.

The plain versions of the main field's kernels (what the port's wrappers
run for CPU tensors, and what ``chip_smoke.py`` holds each CUDA instance
to on the card) against the JAX package at two of the tile's instances
other than the shipping one, (M, H) = (32, 64) and (64, 128), heads H / 4
wide: the packed field (K4), the fused field and render (K5) and the train
step's loss and gradients (K6). The JAX side runs its plain reference, the
unfused XLA chain its own kernel tests hold the Pallas kernels to
(``spectral.forward`` with ``fused="off"``). Same numpy inputs from a
seed, the JAX initialiser's weights with seeded noise on the biases, some
rays missing the box. Tolerances, as ``tests/test_torch_kernels2.py`` and
``test_torch_train.py`` state them: forwards 2e-2 of each tensor's scale
(the bias convention and bf16 rounding flips), weights 2e-2 absolute, loss
terms 1e-2 relative, gradients 5e-2 of each leaf's scale.

Then the route table: for bf16 and f32 compute, 0 and 29 classes and
viewdirs on and off, the member core's default route and the trunk's
kernel route are the branches the JAX package's gates pick on its chip.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from apnerf_tpu.models import spectral as j_sp
from apnerf_tpu.ops import volrend as j_vr
from apnerf_tpu_torch.models import spectral as t_sp
from apnerf_tpu_torch.ops.cuda import field_images as fi
from apnerf_tpu_torch.ops.cuda import fused_field_heads as t_ffh
from apnerf_tpu_torch.ops.cuda import fused_field_volrend as t_fvr
from apnerf_tpu_torch.train import flagship as t_fl

AABB = (-1.0, -1.0, -1.0, 1.0, 1.0, 1.0)
C = 5
R, S = 64, 8
WIDTHS = [(32, 64), (64, 128)]
LOSS_W = (10.0, 1.0 / 5.0, 1.0 / 2.0)


def T(a):
    return torch.as_tensor(np.array(a))


def on_scale(port, ref, rel, name=""):
    port = port.detach().float().numpy() if torch.is_tensor(port) else np.asarray(port)
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (name, port.shape, ref.shape)
    err = np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-6)
    assert err <= rel, (name, err, rel)


def _setup(M, H, seed=0):
    """The JAX configuration and initialiser at (M, H), noisy biases, and
    seeded render inputs → (JAX config, port config, params, port field,
    inputs)."""
    kw = dict(aabb=AABB, n_levels=M // 8, freqs_per_level=8, base_freq=4.0, max_freq=32.0,
              neurons=H, layers=3, geo_feat_dim=7, num_semantic_classes=C)
    cfg_j, cfg_t = j_sp.SpectralConfig(**kw, fused="off"), t_sp.SpectralConfig(**kw)
    params = jax.tree.map(np.asarray, j_sp.init_spectral(jax.random.PRNGKey(seed), cfg_j))
    rng = np.random.default_rng(seed)
    for mlp in ("mlp_base", "mlp_head", "mlp_sem"):
        for k in params[mlp]:
            if k.startswith("b"):
                params[mlp][k] = rng.normal(0, 0.1, params[mlp][k].shape).astype(np.float32)
    field = t_sp.SpectralField.from_tree(params)
    # the instance the kernels would run for this field
    assert fi.check_widths("t", [tuple(p.shape) for p in field.parameters()])[:2] == (M, H)
    pos = rng.uniform(-1.3, 1.3, (R, S, 3)).astype(np.float32)  # straddles the box
    dirs = rng.normal(size=(R, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    edges = np.sort(rng.uniform(0.1, 3.0, (R, S + 1)).astype(np.float32), axis=-1)
    miss = (np.arange(R) % 17) == 0
    pix = rng.uniform(size=(R, 3)).astype(np.float32)
    dgt = rng.uniform(0.0, 4.0, R).astype(np.float32)
    lab = rng.integers(0, C, R).astype(np.int32)
    bkgd = np.array([0.2, 0.3, 0.4], np.float32)
    inputs = (pos, dirs, edges[:, :-1].copy(), edges[:, 1:].copy(), miss, pix, dgt, lab, bkgd)
    return cfg_j, cfg_t, jax.tree.map(jnp.asarray, params), field, inputs


def _oracle(params, cfg, pos, rays_d, t0, t1, miss):
    """The JAX package's unfused chain → (packed [R, S, 4 + C], per-ray sums
    [R, 5 + C], weights [R, S]), the port's layouts."""
    dirs = jnp.broadcast_to(rays_d[:, None, :], pos.shape)
    rgb, density, sem = j_sp.forward(params, cfg, pos, dirs)
    w, _, _ = j_vr.render_weight_from_density(t0, t1, density[..., 0] * (~miss[:, None]))
    acc = jnp.concatenate([
        jnp.einsum("rs,rsc->rc", w, rgb), jnp.sum(w, axis=-1, keepdims=True),
        jnp.sum(w * 0.5 * (t0 + t1), axis=-1, keepdims=True), jnp.einsum("rs,rsc->rc", w, sem),
    ], axis=-1)
    return jnp.concatenate([rgb, density, sem], axis=-1), acc, w


@pytest.mark.parametrize("M,H", WIDTHS)
def test_packed_field_and_render_plain_match_jax(M, H):
    """K4's and K5's plain versions at (M, H) against the JAX chain."""
    cfg_j, cfg_t, pj, field, (pos, dirs, t0, t1, miss, *_) = _setup(M, H)
    y_j, acc_j, w_j = (np.asarray(a) for a in _oracle(
        pj, cfg_j, *(jnp.asarray(a) for a in (pos, dirs, t0, t1, miss))))
    with torch.no_grad():
        y_t = t_sp.forward_packed(field, cfg_t, T(pos), T(dirs))
        acc_t, w_t = t_sp.forward_packed_volrend(
            field, cfg_t, *(T(a) for a in (pos, dirs, t0, t1, miss)))
    assert t_ffh.fused_field_heads.launches == 0 and t_fvr.fused_field_volrend.launches == 0
    for cols in (slice(0, 3), slice(3, 4), slice(4, 4 + C)):  # rgb, sigma, logits
        on_scale(y_t[..., cols], y_j[..., cols], 2e-2)
    for cols in (slice(0, 3), slice(3, 4), slice(4, 5), slice(5, 5 + C)):
        on_scale(acc_t[:, cols], acc_j[:, cols], 2e-2)
    np.testing.assert_allclose(w_t.numpy(), w_j, rtol=0, atol=2e-2)
    assert (w_t.numpy()[miss] == 0).all() and (acc_t.numpy()[miss] == 0).all()


def _oracle_loss(params, cfg, pos, rays_d, t0, t1, miss, pix, dgt, lab, bkgd):
    """``train/flagship.py`` loss_fn over the unfused XLA chain."""
    _, acc, w = _oracle(params, cfg, pos, rays_d, t0, t1, miss)
    op = acc[:, 3:4]
    depth = acc[:, 4] / jnp.clip(op[:, 0], min=jnp.finfo(jnp.float32).eps)
    l_rgb = jnp.mean(optax.huber_loss(acc[:, :3] + bkgd * (1.0 - op), pix))
    l_dep = jnp.mean(optax.huber_loss(depth, dgt))
    l_sem = jnp.mean(optax.softmax_cross_entropy_with_integer_labels(acc[:, 5:], lab))
    return LOSS_W[0] * l_rgb + LOSS_W[1] * l_dep + LOSS_W[2] * l_sem, (l_rgb, l_dep, l_sem, w)


@pytest.mark.parametrize("M,H", WIDTHS)
def test_train_step_plain_matches_jax(M, H):
    """K6's plain version at (M, H) (the train step's loss terms, weights
    and every gradient) against JAX's autodiff of the same loss."""
    cfg_j, cfg_t, pj, field, inputs = _setup(M, H, seed=1)
    lossrows, w, grads = t_sp.forward_packed_lossgrad(field, cfg_t, *map(T, inputs))
    assert t_fvr.fused_field_volrend_lossgrad.launches == 0
    (_, (l_rgb, l_dep, l_sem, w_ref)), g_ref = jax.value_and_grad(
        lambda p: _oracle_loss(p, cfg_j, *map(jnp.asarray, inputs)), has_aux=True)(pj)
    terms = [lossrows[0].sum() / (3 * R), lossrows[1].sum() / R, lossrows[2].sum() / R]
    for a, b in zip(terms, (l_rgb, l_dep, l_sem)):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-2)
    on_scale(w, w_ref, 2e-2)
    for mlp in ("mlp_base", "mlp_head", "mlp_sem"):
        for k, v in g_ref[mlp].items():
            on_scale(grads[mlp][k], v, 5e-2, f"{mlp}.{k}")
    on_scale(grads["W"], g_ref["W"], 5e-2, "W")
    on_scale(grads["phase"], g_ref["phase"], 5e-2, "phase")


ROUTE_CASES = list(itertools.product(("bfloat16", "float32"), (0, 29), (True, False)))


@pytest.mark.parametrize("dtype,classes,viewdirs", ROUTE_CASES)
def test_default_route_is_the_branch_jax_picks(dtype, classes, viewdirs, monkeypatch):
    """The member core's default route and the trunk's kernel route, from
    the configuration alone, against the branch the JAX member core takes
    on its chip (``fused="on"``, the TPU backend's default; a row count its
    tiling admits): the combined kernel, a packed render branch, the field
    kernel with the heads outside, or the XLA chain. The port's renderers
    take the packed kernels exactly where the route is ``lossgrad``."""
    for var in ("APNERF_FUSED_FIELD", "APNERF_FUSED_HEADS", "APNERF_FUSED_VR",
                "APNERF_FUSED_LOSSGRAD"):
        monkeypatch.delenv(var, raising=False)
    kw = dict(aabb=AABB, n_levels=4, freqs_per_level=8, neurons=64, layers=3, geo_feat_dim=7,
              num_semantic_classes=classes, use_viewdirs=viewdirs, compute_dtype=dtype)
    cfg_j, cfg_t = j_sp.SpectralConfig(**kw, fused="on"), t_sp.SpectralConfig(**kw)
    params = j_sp.init_spectral(jax.random.PRNGKey(0), cfg_j)
    rays, samples = 256, 64
    if j_sp.use_packed_lossgrad(cfg_j, params, rays, samples):
        jax_branch = "lossgrad"
    elif j_sp.use_packed_volrend(cfg_j, params, rays, samples):
        jax_branch = "volrend"
    elif j_sp.use_packed_field(cfg_j, params, rays * samples):
        jax_branch = "packed"
    elif j_sp._use_fused_field(cfg_j, params["mlp_base"]):
        jax_branch = "field"
    else:
        jax_branch = "plain"
    want = {"bfloat16": "lossgrad" if classes and viewdirs else "field"}.get(dtype, "plain")
    assert jax_branch == want
    assert t_fl.default_route(cfg_t) == jax_branch
    field = t_sp.init_spectral(cfg_t, torch.Generator().manual_seed(0))
    off_cpu = torch.empty((4, 3), device="meta")
    assert t_sp._kernel_route("t", cfg_t, field.mlp_base, off_cpu, named=False) == (
        j_sp._use_fused_field(cfg_j, params["mlp_base"]))
    if dtype == "float32":
        # the default route runs the plain chain off the CPU too; a named one raises
        assert t_sp.query_density(field.to("meta"), cfg_t, off_cpu).shape == (4, 1)
        with pytest.raises(ValueError, match="bfloat16 field"):
            t_sp.query_density(field, cfg_t, off_cpu, trunk="field")


@pytest.mark.parametrize("layers", [1, 3])
def test_plain_route_only_where_it_is_the_default(layers):
    """The member core takes the named route ``plain`` only for a field the
    field kernels decline (here another depth); for one they take it raises
    rather than running the plain chain on the card."""
    from apnerf_tpu_torch.config import PipelineConfig

    cfg = PipelineConfig(spectral_layers=layers)
    route = t_fl.default_route(t_fl.make_spectral_config(cfg))
    assert route == ("plain" if layers == 1 else "lossgrad")
    if route == "plain":
        assert callable(t_fl.make_flagship_member_core(cfg, "plain"))
    else:
        with pytest.raises(ValueError, match="'plain'"):
            t_fl.make_flagship_member_core(cfg, "plain")
