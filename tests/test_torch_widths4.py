"""The main field on the tile's last tier, and the trunk kernels at H = 1024.

The field tile's kernels take the whole field at four tiers of its trunk
output (1 + geo padded to 16, 32, 48, 64) and its semantic output (classes
padded to 64, 128, 256, 1024); on the last, the heads' input [SH 16 | geo |
0] spans two tile images. Their plain versions (what the port's wrappers
run for CPU tensors, and what ``chip_smoke.py`` phase 27 holds the last
tier's CUDA instances to on the card) are held here to the JAX package's
Pallas kernels in interpret mode, as ``tests/test_pallas_fused_field.py``
runs them, at (H, geo, classes) = (16, 63, 1000) and (64, 48, 257): the
packed field (``forward_packed``, K4), the fused field and render
(``forward_packed_volrend``, K5) and the train step's loss rows, weights and
every gradient (``forward_packed_lossgrad``, K6). Same numpy inputs from one
seed, the JAX initialiser's weights (with seeded noise on the biases for
the forwards; with the initial zero biases for the train step, as the JAX
kernel test holds it), some rays missing the box.

Tolerances, as ``tests/test_torch_widths3.py`` states them: the two sides
differ by the bias convention (the Pallas kernels add biases in f32 before
rounding to bf16, the plain chain in bf16 after) and by bf16 rounding
flips, so every output is compared on its tensor's scale (max-abs error /
max-abs of the reference): rgb, sigma, logits and per-ray sums 2e-2,
weights 2e-2 absolute, loss terms 3e-2 relative with 3e-3 absolute,
gradients 5e-2 of each leaf's scale.

Then the plain versions of K1 (``fused_spectral_field``) and K3
(``fused_mlp_apply``) against the Pallas kernels in interpret mode at a
1024-wide trunk (mip-NeRF 360's NeRF MLP width), 192 rows, at the JAX
kernel tests' bf16 limit (2e-2 of the output's scale). The tile's CUDA
instances stop at H = 512 (``field_images.check_trunk`` refuses H = 1024 on
the card, ROADMAP Queue 3 F3); these are the plain versions such an
instance would be held to.

Last, one flagship member step at (16, 63, 1000) against JAX's member core
(loss and aux rtol 1e-2; the updated parameters 5e-2 of each tensor's
scale plus 3 learning rates, as ``tests/test_torch_train.py`` holds them).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apnerf_tpu.config import PipelineConfig
from apnerf_tpu.data import dataset as j_ds
from apnerf_tpu.models import nn as j_nn
from apnerf_tpu.models import spectral as j_sp
from apnerf_tpu.ops import occupancy as j_occ
from apnerf_tpu.ops.pallas import fused_mlp as j_fm
from apnerf_tpu.train import flagship as j_fl
from apnerf_tpu_torch.data import dataset as t_ds
from apnerf_tpu_torch.models import spectral as t_sp
from apnerf_tpu_torch.models.nn import MLP
from apnerf_tpu_torch.ops.cuda import field_images as fi
from apnerf_tpu_torch.ops.cuda import fused_field_heads as t_ffh
from apnerf_tpu_torch.ops.cuda import fused_field_volrend as t_fvr
from apnerf_tpu_torch.ops.cuda import fused_mlp as t_fm
from apnerf_tpu_torch.train import flagship as t_fl

AABB = (-1.0, -1.0, -1.0, 1.0, 1.0, 1.0)
LOSS_W = (10.0, 1.0 / 5.0, 1.0 / 2.0)
# (H, geo, classes), both on the last tier (T_out, C_pad) = (64, 1024)
WIDEST = [(16, 63, 1000), (64, 48, 257)]


def T(a):
    return torch.as_tensor(np.array(a))


def on_scale(port, ref, rel, name=""):
    port = port.detach().float().numpy() if torch.is_tensor(port) else np.asarray(port)
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (name, port.shape, ref.shape)
    err = np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-6)
    assert err <= rel, (name, err, rel)


def _setup(H, G, C, noisy_biases=True, seed=0):
    """Both packages' configurations, the JAX initialiser's field (seeded
    noise on the biases where asked) as JAX arrays and as the port's module."""
    kw = dict(aabb=AABB, n_levels=4, freqs_per_level=2, base_freq=4.0, max_freq=32.0,
              neurons=H, layers=3, geo_feat_dim=G, num_semantic_classes=C,
              compute_dtype="bfloat16")
    cfg_j, cfg_t = j_sp.SpectralConfig(**kw), t_sp.SpectralConfig(**kw)
    params = jax.tree.map(np.asarray, j_sp.init_spectral(jax.random.PRNGKey(seed), cfg_j))
    rng = np.random.default_rng(seed)
    if noisy_biases:
        for mlp in ("mlp_base", "mlp_head", "mlp_sem"):
            for k in params[mlp]:
                if k.startswith("b"):
                    params[mlp][k] = rng.normal(0, 0.1, params[mlp][k].shape).astype(np.float32)
    field = t_sp.SpectralField.from_tree(params)
    shapes = [tuple(p.shape) for p in field.parameters()]
    # a field the kernels take, on the last tier, the heads' input over two images
    assert fi.check_widths("t", shapes) == (8, H, 3, G, C)
    assert fi.tier(G, C) == (64, 1024) and fi.xs_imgs(64) == 2
    return cfg_j, cfg_t, jax.tree.map(jnp.asarray, params), field


def _inputs(R, S, C, seed=1):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1.3, 1.3, (R, S, 3)).astype(np.float32)  # straddles the box
    dirs = rng.normal(size=(R, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    edges = np.sort(rng.uniform(0.1, 3.0, (R, S + 1)).astype(np.float32), axis=-1)
    miss = (np.arange(R) % 17) == 0
    pix = rng.uniform(size=(R, 3)).astype(np.float32)
    dgt = rng.uniform(0.0, 4.0, R).astype(np.float32)  # huber's linear branch too
    lab = rng.integers(0, C, R).astype(np.int32)
    bkgd = np.array([0.2, 0.3, 0.4], np.float32)
    return pos, dirs, edges[:, :-1].copy(), edges[:, 1:].copy(), miss, pix, dgt, lab, bkgd


@pytest.mark.parametrize("H,G,C", WIDEST)
def test_packed_field_plain_matches_pallas_interpret(H, G, C):
    """K4's plain version against ``forward_packed`` (the Pallas kernel in
    interpret mode): rgb, sigma and every logit."""
    cfg_j, cfg_t, pj, field = _setup(H, G, C)
    R, S = 32, 8
    pos, dirs = _inputs(R, S, C)[:2]
    y_j = np.moveaxis(np.asarray(j_sp.forward_packed(pj, cfg_j, jnp.asarray(pos),
                                                     jnp.asarray(dirs))), 0, -1)
    t_ffh.fused_field_heads.launches = 0
    with torch.no_grad():
        y_t = t_sp.forward_packed(field, cfg_t, T(pos), T(dirs))
    assert y_t.shape == (R, S, 4 + C) and t_ffh.fused_field_heads.launches == 0
    for name, cols in (("rgb", slice(0, 3)), ("sigma", slice(3, 4)), ("logits", slice(4, None))):
        on_scale(y_t[..., cols], y_j[..., cols], 2e-2, name)
    outside = (np.abs(pos) >= 1.0).any(-1)
    assert outside.any() and (y_t[..., 3].numpy()[outside] == 0).all()


@pytest.mark.parametrize("H,G,C", WIDEST)
def test_field_volrend_plain_matches_pallas_interpret(H, G, C):
    """K5's plain version against ``forward_packed_volrend`` (the Pallas
    kernel in interpret mode): weights and every per-ray sum."""
    cfg_j, cfg_t, pj, field = _setup(H, G, C)
    R, S = 128, 8  # whole 128-ray blocks, as the TPU layout plan asks
    pos, dirs, t0, t1, miss = _inputs(R, S, C)[:5]
    acc_j, w_j = j_sp.forward_packed_volrend(
        pj, cfg_j, *(jnp.asarray(a) for a in (pos, dirs, t0, t1, miss)))
    t_fvr.fused_field_volrend.launches = 0
    with torch.no_grad():
        acc_t, w_t = t_sp.forward_packed_volrend(field, cfg_t,
                                                 *(T(a) for a in (pos, dirs, t0, t1, miss)))
    assert acc_t.shape == (R, 5 + C) and w_t.shape == (R, S)
    assert t_fvr.fused_field_volrend.launches == 0
    acc_j = np.asarray(acc_j).T  # the TPU layout is [5 + C, R]
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=0, atol=2e-2)
    for name, cols in (("rgb", slice(0, 3)), ("opacity", slice(3, 4)), ("depth", slice(4, 5)),
                       ("semantics", slice(5, None))):
        on_scale(acc_t[:, cols], acc_j[:, cols], 2e-2, name)
    assert miss.any() and (w_t.numpy()[miss] == 0).all() and (acc_t.numpy()[miss] == 0).all()


def _flat_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_tree(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("H,G,C", WIDEST)
def test_train_step_plain_matches_pallas_interpret(H, G, C):
    """K6's plain version against ``forward_packed_lossgrad`` (the Pallas
    kernel in interpret mode): the weights, the three loss terms and every
    gradient, from the initial zero biases."""
    cfg_j, cfg_t, pj, field = _setup(H, G, C, noisy_biases=False)
    R, S = 128, 8
    inputs = _inputs(R, S, C)
    t_fvr.fused_field_volrend_lossgrad.launches = 0
    lossrows, w, grads = t_sp.forward_packed_lossgrad(field, cfg_t, *map(T, inputs))
    assert t_fvr.fused_field_volrend_lossgrad.launches == 0  # the plain version
    assert lossrows.shape == (3, R) and w.shape == (R, S)
    lr_j, w_j, g_j = j_sp.forward_packed_lossgrad(pj, cfg_j, *map(jnp.asarray, inputs),
                                                  loss_weights=LOSS_W)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), rtol=2e-2, atol=2e-2)
    for i, norm in enumerate((3 * R, R, R)):
        np.testing.assert_allclose(float(lossrows[i].sum()) / norm, float(np.sum(lr_j[i])) / norm,
                                   rtol=3e-2, atol=3e-3)
    ref = _flat_tree(jax.tree.map(np.asarray, g_j))
    got = _flat_tree(grads)
    assert set(got) == set(ref)
    for k in ref:
        on_scale(got[k], ref[k], 5e-2, k)


def _jax_mlp(widths, seed):
    """The JAX initialiser's MLP with seeded noise on the biases, as numpy."""
    params = jax.tree.map(np.asarray, j_nn.init_mlp(jax.random.PRNGKey(seed), widths))
    rng = np.random.default_rng(seed)
    for k in params:
        if k.startswith("b"):
            params[k] = (rng.standard_normal(params[k].shape) * 0.1).astype(np.float32)
    return params


@pytest.mark.parametrize("layers", [2, 3])
def test_trunk_1024_field_kernel_plain_matches_pallas_interpret(layers):
    """K1 with a 1024-wide trunk on 64 frequencies and a 64-wide output (the
    last tier's trunk output): the port's plain version against
    ``fused_spectral_field`` in interpret mode, 192 rows."""
    rng = np.random.default_rng(layers)
    params = _jax_mlp([128] + [1024] * layers + [64], layers)
    W = (rng.standard_normal((3, 64)) * 4).astype(np.float32)
    phase = rng.uniform(size=(64,)).astype(np.float32)
    u = rng.uniform(size=(192, 3)).astype(np.float32)
    ref = j_fm.fused_spectral_field(jnp.asarray(W), jnp.asarray(phase),
                                    jax.tree.map(jnp.asarray, params), jnp.asarray(u))
    t_fm.fused_spectral_field.launches = 0
    with torch.no_grad():
        got = t_fm.fused_spectral_field(torch.from_numpy(W), torch.from_numpy(phase),
                                        MLP.from_tree(params), torch.from_numpy(u))
    assert t_fm.fused_spectral_field.launches == 0 and got.shape == (192, 64)
    on_scale(got, ref, 2e-2)


@pytest.mark.parametrize("x_dtype", ["bfloat16", "float32"])
def test_trunk_1024_mlp_kernel_plain_matches_pallas_interpret(x_dtype):
    """K3 with a 1024-wide trunk, a 256-wide input and a 17-wide output:
    the port's plain version against ``fused_mlp_apply`` in interpret mode,
    192 rows, x in bf16 and in f32."""
    params = _jax_mlp([256, 1024, 1024, 17], 4)
    x = np.random.default_rng(5).standard_normal((192, 256)).astype(np.float32)
    jd, td = (jnp.bfloat16, torch.bfloat16) if x_dtype == "bfloat16" else (jnp.float32,
                                                                           torch.float32)
    ref = j_fm.fused_mlp_apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x, jd))
    t_fm.fused_mlp_apply.launches = 0
    with torch.no_grad():
        got = t_fm.fused_mlp_apply(MLP.from_tree(params), torch.from_numpy(x).to(td))
    assert t_fm.fused_mlp_apply.launches == 0 and got.shape == (192, 17)
    on_scale(got, ref, 2e-2)


def _train_cfg():
    """The flagship's member step at a tiny size with a 16-wide trunk, 63
    geometry features and 1000 classes."""
    return PipelineConfig(
        aabb=AABB, img_w=32, img_h=24, num_rays=64, max_samples_train=8, num_prop_samples=8,
        num_semantic_classes=1000, n_ensembles=1, max_images=4, n_levels=4,
        spectral_freqs_per_level=2, base_resolution=4, max_resolution=32, spectral_neurons=16,
        spectral_layers=3, geo_feat_dim=63, prop_neurons=16,
    )


def _jax_state(cfg, member):
    """The port member's parameters as a one-member JAX ensemble state with
    a fresh optimizer state and grid."""
    tree = {}
    for name, v in member.state_dict().items():
        *path, leaf = name.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(v.numpy())
    opt = j_fl.make_optimizer(cfg, j_fl.default_spectral_schedule(cfg))
    grid = j_occ.init_occ_grid(cfg.aabb, cfg.main_grid_resolution)
    return tree, opt.init(tree), grid


def test_widest_member_step_matches_jax(monkeypatch):
    """One flagship member step at (16, 63, 1000): the port's default route
    (``lossgrad``, the train-step kernel's plain version on the CPU)
    against JAX's member core (its autodiff branch), the same member,
    batch and stratified draw: loss and aux, and every updated parameter."""
    monkeypatch.setenv("APNERF_FUSED_LOSSGRAD", "0")  # JAX: the autodiff branch
    cfg = _train_cfg()
    state = t_fl.init_flagship_ensemble(cfg, torch.Generator().manual_seed(0))
    assert t_fl.default_route(t_fl.make_spectral_config(cfg)) == "lossgrad"
    member = copy.deepcopy(state.members[0])
    assert fi.tier(63, 1000) == (64, 1024)
    params, opt_state, grid = _jax_state(cfg, member)
    rng = np.random.default_rng(5)
    o = rng.uniform(-2, 2, (64, 3)).astype(np.float32)
    vd = rng.normal(size=(64, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    arrays = (o, vd, rng.uniform(size=(64, 3)).astype(np.float32),
              rng.uniform(0.1, 3.0, 64).astype(np.float32),
              rng.integers(0, 1000, 64).astype(np.int32), np.ones(3, np.float32))
    k_occ = jax.random.PRNGKey(6)
    out_j = jax.jit(j_fl.make_flagship_member_core(cfg))(
        params, opt_state, grid, j_ds.RayBatch(*map(jnp.asarray, arrays)), k_occ,
        jnp.asarray(0), jnp.asarray(1e-3))
    _, k_samp = jax.random.split(k_occ)
    noise = T(jax.random.uniform(jax.random.split(k_samp)[1], (64, 9)))
    t_fvr.fused_field_volrend_lossgrad.launches = 0
    out_t = t_fl.make_flagship_member_core(cfg)(
        member, state.opt[0], t_ds.RayBatch(*map(T, arrays)), 0, noise=noise)
    assert t_fvr.fused_field_volrend_lossgrad.launches == 0
    for a, b in zip(out_t[1:6], out_j[3:8]):
        np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                                   rtol=1e-2)
    assert not bool(out_t.skipped) and not bool(out_j[8]) and int(out_t.opt.count) == 1
    lr = float(t_fl.default_spectral_schedule(cfg)(1))
    ref = _flat_tree(jax.tree.map(np.asarray, out_j[0]))
    for name, p in member.named_parameters():
        err = np.abs(p.detach().numpy() - ref[name]).max()
        assert err <= 5e-2 * max(np.abs(ref[name]).max(), 1e-6) + 3.0 * lr, (name, err)
