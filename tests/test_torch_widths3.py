"""The main field past 64 semantic classes and past 15 geometry features.

The field tile's kernels take the whole field at three tiers of its trunk
output (1 + geo padded to 16, 32, 48) and its semantic output (classes
padded to 64, 128, 256). Their plain versions (what the port's wrappers
run for CPU tensors, and what ``chip_smoke.py`` holds every tier's CUDA
instances to on the card) are held here to the JAX package's Pallas
kernels in interpret mode, as ``tests/test_pallas_fused_field.py`` runs
them, at (H, geo, classes) = (32, 31, 101), (64, 47, 150) and (16, 15,
256): the packed field (``forward_packed``, K4), the fused field and render
(``forward_packed_volrend``, K5) and the train step's loss rows, weights and
every gradient (``forward_packed_lossgrad``, K6). Same numpy inputs from one
seed, the JAX initialiser's weights (with seeded noise on the biases for
the forwards; with the initial zero biases for the train step, as the JAX
kernel test holds it), some rays missing the box.

Tolerances, as ``tests/test_torch_kernels2.py`` and ``test_torch_train.py``
state them: the two sides differ by the bias convention (the Pallas kernels
add biases in f32 before rounding to bf16, the plain chain in bf16 after)
and by bf16 rounding flips, so every output is compared on its tensor's
scale (max-abs error / max-abs of the reference): rgb, sigma, logits and
per-ray sums 2e-2, weights 2e-2 absolute, loss terms 3e-2 relative with
3e-3 absolute, gradients 5e-2 of each leaf's scale.

Then a member with 101 classes and 31 geometry features carried from the
JAX package into the port and back through the checkpoint format, bit for
bit, and one flagship member step at (32, 31, 101) against JAX's member
core (loss and aux rtol 1e-2; the updated parameters 5e-2 of each tensor's
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
from apnerf_tpu.models import spectral as j_sp
from apnerf_tpu.ops import occupancy as j_occ
from apnerf_tpu.train import flagship as j_fl
from apnerf_tpu_torch import interop
from apnerf_tpu_torch.data import dataset as t_ds
from apnerf_tpu_torch.models import spectral as t_sp
from apnerf_tpu_torch.ops.cuda import field_images as fi
from apnerf_tpu_torch.ops.cuda import fused_field_heads as t_ffh
from apnerf_tpu_torch.ops.cuda import fused_field_volrend as t_fvr
from apnerf_tpu_torch.train import flagship as t_fl
from apnerf_tpu_torch.train.step import AdamState

AABB = (-1.0, -1.0, -1.0, 1.0, 1.0, 1.0)
LOSS_W = (10.0, 1.0 / 5.0, 1.0 / 2.0)
# (H, geo, classes): each on a tier past the first, (T_out, C_pad)
WIDE = [(32, 31, 101), (64, 47, 150), (16, 15, 256)]
TIERS = {(32, 31, 101): (32, 128), (64, 47, 150): (48, 256), (16, 15, 256): (48, 256)}


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
    # a field the kernels take, on the tier past the first that its widths ask
    assert fi.check_widths("t", shapes) == (8, H, 3, G, C)
    assert fi.tier(G, C) == TIERS[H, G, C]
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


@pytest.mark.parametrize("H,G,C", WIDE)
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


@pytest.mark.parametrize("H,G,C", WIDE)
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


@pytest.mark.parametrize("H,G,C", WIDE)
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


def _train_cfg():
    """The flagship's member step at a tiny size with a 32-wide trunk, 31
    geometry features and 101 classes."""
    return PipelineConfig(
        aabb=AABB, img_w=32, img_h=24, num_rays=64, max_samples_train=8, num_prop_samples=8,
        num_semantic_classes=101, n_ensembles=1, max_images=4, n_levels=4,
        spectral_freqs_per_level=2, base_resolution=4, max_resolution=32, spectral_neurons=32,
        spectral_layers=3, geo_feat_dim=31, prop_neurons=16,
    )


def test_wide_member_round_trips_through_the_checkpoint(tmp_path):
    """A JAX ensemble's member with 101 classes and 31 geometry features
    (``init_flagship_ensemble`` at ``_train_cfg``) into the port
    (``params_from_jax``), out through ``save_member_npz`` with the JAX
    mapper's keys and back through ``load_member_npz``: every array the
    same bits as JAX's."""
    cfg = _train_cfg()
    tree = jax.tree.map(np.asarray, j_fl.init_flagship_ensemble(jax.random.PRNGKey(3),
                                                                cfg).params)
    (member,) = interop.params_from_jax(tree)
    assert member.main.mlp_base.layers()[-1][0].shape == (32, 32)
    assert member.main.mlp_sem.layers()[-1][0].shape == (8, 101)
    shapes = [tuple(p.shape) for p in member.main.parameters()]
    assert fi.check_widths("t", shapes)[3:] == (31, 101) and fi.tier(31, 101) == (32, 128)
    n = sum(p.numel() for p in member.parameters())
    zeros = torch.zeros(n)
    opt = AdamState(zeros, zeros.clone(), torch.tensor(0, dtype=torch.int32))
    occs, binaries = torch.zeros(8), torch.zeros((2, 2, 2), dtype=torch.bool)
    path = tmp_path / "model_0.npz"
    interop.save_member_npz(path, member, occs, binaries, opt, 7)
    flat = _flat_tree(jax.tree.map(lambda a: np.asarray(a)[0], tree))
    with np.load(path) as data:
        for key, ref in flat.items():
            got = data[key.replace(".", "/")]
            assert got.dtype == ref.dtype and np.array_equal(got, ref), key
    back, _, _ = interop.load_member_npz(path)
    for (name, a), (_, b) in zip(member.named_parameters(), back.named_parameters()):
        assert torch.equal(a, b), name


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


def test_wide_member_step_matches_jax(monkeypatch):
    """One flagship member step at (32, 31, 101): the port's default route
    (``lossgrad``, the train-step kernel's plain version on the CPU)
    against JAX's member core (its autodiff branch), the same member,
    batch and stratified draw: loss and aux, and every updated parameter."""
    monkeypatch.setenv("APNERF_FUSED_LOSSGRAD", "0")  # JAX: the autodiff branch
    cfg = _train_cfg()
    state = t_fl.init_flagship_ensemble(cfg, torch.Generator().manual_seed(0))
    assert t_fl.default_route(t_fl.make_spectral_config(cfg)) == "lossgrad"
    member = copy.deepcopy(state.members[0])
    params, opt_state, grid = _jax_state(cfg, member)
    rng = np.random.default_rng(5)
    o = rng.uniform(-2, 2, (64, 3)).astype(np.float32)
    vd = rng.normal(size=(64, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    arrays = (o, vd, rng.uniform(size=(64, 3)).astype(np.float32),
              rng.uniform(0.1, 3.0, 64).astype(np.float32),
              rng.integers(0, 101, 64).astype(np.int32), np.ones(3, np.float32))
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
