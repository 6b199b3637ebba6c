"""Parity of the port's train step (``apnerf_tpu_torch/train``, ``data``,
``sim``, the train-step kernel's and the weights kernel's backward plain
versions) with the JAX package's, on the CPU at tiny sizes.

Inputs come from a seeded numpy generator; random draws are made with
``jax.random`` as the JAX functions make them and handed to the port.
Tolerances, each with its reason:
  * elementwise float32 math and schedules: rtol 1e-6;
  * scans and reductions in float32 (weights backward, Adam moments):
    rtol 1e-5 / atol 1e-6, summation orders differ;
  * the train-step kernel's plain version in float32 against JAX's
    autodiff oracle: loss terms rtol 1e-5, weights rtol 1e-4 / atol 1e-5
    (density is an exp of a 4-layer matmul chain), gradient leaves 1e-4 of
    the leaf's max-abs (the same algorithm, matmul orders differ;
    gradients sum 1024 rows);
  * the same in bf16: 2e-2 of scale for the weights, 5e-2 for gradient
    leaves (the JAX test's), 1e-2 for the loss terms (one-ulp bf16 flips
    of high-frequency features);
  * against the Pallas kernel in interpret mode: the JAX test's own
    tolerances (``tests/test_pallas_fused_lossgrad.py:105-126``);
  * a member step and a phase: loss and aux rtol 1e-5 (float32) / 1e-2
    (bf16); updated parameters 2e-3 of each tensor's max-abs plus 1e-2
    learning rates per step in float32, and in bf16 5e-2 of it (the JAX
    test's tolerance for updated parameters) plus 3 learning rates per
    step. An early Adam step moves an element by about one learning rate
    whatever its gradient's size: a later step divides by the root of the
    second moment, which amplifies rounding of a near-zero gradient in
    float32, and a bf16 flip of such a gradient's sign moves the element
    by two; the zero-initialized biases have no larger scale to hide it.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from apnerf_tpu.config import PipelineConfig
from apnerf_tpu.data import dataset as j_ds
from apnerf_tpu.models import ngp as j_ngp
from apnerf_tpu.models import spectral as j_sp
from apnerf_tpu.ops import occupancy as j_occ
from apnerf_tpu.ops import volrend as j_vr
from apnerf_tpu.ops.pallas import fused_render_weights as j_fused_render_weights
from apnerf_tpu.sim import fake as j_fake
from apnerf_tpu.train import flagship as j_fl
from apnerf_tpu.train import phase as j_phase
from apnerf_tpu.train import schedule as j_sched
from apnerf_tpu.train import step as j_step
from apnerf_tpu_torch.data import dataset as t_ds
from apnerf_tpu_torch.models import ngp as t_ngp
from apnerf_tpu_torch.models import spectral as t_sp
from apnerf_tpu_torch.ops.cuda import fused_field_volrend as t_fvr
from apnerf_tpu_torch.ops.cuda.volrend_cuda import fused_render_weights
from apnerf_tpu_torch.sim import fake as t_fake
from apnerf_tpu_torch.train import flagship as t_fl
from apnerf_tpu_torch.train import phase as t_phase
from apnerf_tpu_torch.train import schedule as t_sched
from apnerf_tpu_torch.train.step import Adam, make_optimizer

LOSS_W = (10.0, 1.0 / 5.0, 1.0 / 2.0)


def T(a):
    return torch.as_tensor(np.array(a))


def close(port, ref, **tol):
    np.testing.assert_allclose(
        np.asarray(port.detach() if torch.is_tensor(port) else port), np.asarray(ref), **tol
    )


def on_scale(port, ref, rel, name=""):
    port = port.detach().float().numpy() if torch.is_tensor(port) else np.asarray(port)
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (name, port.shape, ref.shape)
    err = np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-6)
    assert err <= rel, (name, err, rel)


def flat_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_tree(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


# -- trunc_exp, the weights kernel's backward ------------------------------------


def test_trunc_exp_gradient_is_clamped():
    x = np.array([-3.0, 0.0, 5.0, 14.9, 15.0, 15.5, 20.0, 30.0], np.float32)
    g = np.random.default_rng(0).normal(size=x.shape).astype(np.float32)
    xt = T(x).requires_grad_(True)
    y = t_ngp.trunc_exp(xt)
    (gt,) = torch.autograd.grad(y, xt, T(g))
    yj, vjp = jax.vjp(j_ngp.trunc_exp, jnp.asarray(x))
    close(y, yj, rtol=1e-6)
    close(gt, vjp(jnp.asarray(g))[0], rtol=1e-6)
    # above 15 the gradient is exp(15), not exp(x)
    close(gt[-3:] / T(g[-3:]), np.full(3, np.exp(np.float32(15.0))), rtol=1e-6)


def _intervals(rng, R=24, S=64, zero_tail=7):
    edges = np.sort(rng.uniform(0.1, 5.0, (R, S + 1)).astype(np.float32), axis=-1)
    sig = rng.uniform(0, 20, (R, S)).astype(np.float32)
    sig[:, -zero_tail:] = 0.0
    return edges[:, :-1].copy(), edges[:, 1:].copy(), sig


def test_weights_backward_plain_matches_jax():
    """Autograd through the weights kernel's plain version (a CPU tensor)
    against ``jax.vjp`` through the Pallas kernel in interpret mode and
    through ``volrend.render_weight_from_density``."""
    rng = np.random.default_rng(1)
    t0, t1, sig = _intervals(rng)
    g = rng.normal(size=sig.shape).astype(np.float32)
    leaves = [T(a).requires_grad_(True) for a in (t0, t1, sig)]
    fused_render_weights.launches = 0
    w = fused_render_weights(*leaves)
    got = torch.autograd.grad(w, leaves, T(g))
    assert fused_render_weights.launches == 0  # CPU: the plain version
    for fn in (
        j_fused_render_weights,
        lambda a, b, s: j_vr.render_weight_from_density(a, b, s)[0],
    ):
        _, vjp = jax.vjp(fn, t0, t1, sig)
        for a, b in zip(got, vjp(jnp.asarray(g))):
            close(a, b, rtol=1e-5, atol=1e-5)


# -- the train-step kernel's plain version -----------------------------------------

R, S = 128, 8


def _lossgrad_cfg(layers, dtype):
    return j_sp.SpectralConfig(
        aabb=(-1, -1, -1, 1, 1, 1), n_levels=4, freqs_per_level=2, base_freq=4.0,
        max_freq=32.0, neurons=32, layers=layers, geo_feat_dim=7,
        num_semantic_classes=5, compute_dtype=dtype, fused="off",
    )


def _lossgrad_setup(layers, dtype, seed=0, noisy_biases=True):
    """A JAX-initialized field and numpy inputs, as
    ``tests/test_pallas_fused_lossgrad.py`` builds them; with seeded noise
    on the biases unless ``noisy_biases`` is False."""
    cfg = _lossgrad_cfg(layers, dtype)
    params = j_sp.init_spectral(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: np.asarray(a) + (
            rng.normal(0, 0.1, np.shape(a)).astype(np.float32)
            if noisy_biases and p[-1].key.startswith("b") else 0.0
        ),
        params,
    )
    pos = rng.uniform(-1.3, 1.3, (R, S, 3)).astype(np.float32)
    dirs = rng.normal(size=(R, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    edges = np.sort(rng.uniform(0.1, 3.0, (R, S + 1)).astype(np.float32), axis=-1)
    t0, t1 = edges[:, :-1].copy(), edges[:, 1:].copy()
    miss = (np.arange(R) % 17) == 0
    pix = rng.uniform(size=(R, 3)).astype(np.float32)
    dgt = rng.uniform(0.0, 4.0, R).astype(np.float32)  # huber's linear branch too
    lab = rng.integers(0, cfg.num_semantic_classes, R).astype(np.int32)
    bkgd = np.array([0.2, 0.3, 0.4], np.float32)
    return cfg, params, (pos, dirs, t0, t1, miss, pix, dgt, lab, bkgd)


def _oracle_loss(params, cfg, pos, rays_d, t0, t1, miss, pix, dgt, lab, bkgd):
    """``train/flagship.py`` loss_fn over the unfused XLA chain."""
    dirs = jnp.broadcast_to(rays_d[:, None, :], pos.shape)
    rgb, density, sem = j_sp.forward(params, cfg, pos, dirs)
    sigmas = density[..., 0] * (~miss[:, None])
    w, _, _ = j_vr.render_weight_from_density(t0, t1, sigmas)
    t_mid = 0.5 * (t0 + t1)
    rgb_acc = jnp.einsum("rs,rsc->rc", w, rgb)
    op = jnp.sum(w, axis=-1, keepdims=True)
    depth = jnp.einsum("rs,rs->r", w, t_mid)[:, None] / jnp.clip(
        op, min=jnp.finfo(jnp.float32).eps
    )
    sem_acc = jnp.einsum("rs,rsc->rc", w, sem)
    rgb_full = rgb_acc + bkgd * (1.0 - op)
    l_rgb = jnp.mean(optax.huber_loss(rgb_full, pix))
    l_dep = jnp.mean(optax.huber_loss(depth[:, 0], dgt))
    l_sem = jnp.mean(optax.softmax_cross_entropy_with_integer_labels(sem_acc, lab))
    loss = LOSS_W[0] * l_rgb + LOSS_W[1] * l_dep + LOSS_W[2] * l_sem
    return loss, (l_rgb, l_dep, l_sem, w)


def _port_lossgrad(cfg, params, inputs):
    field = t_sp.SpectralField.from_tree(params)
    t_cfg = t_sp.SpectralConfig(**{
        f: getattr(cfg, f) for f in t_sp.SpectralConfig._fields
    })
    t_fvr.fused_field_volrend_lossgrad.launches = 0
    out = t_sp.forward_packed_lossgrad(field, t_cfg, *map(T, inputs))
    assert t_fvr.fused_field_volrend_lossgrad.launches == 0  # CPU: the plain version
    return out


@pytest.mark.parametrize("layers,dtype", [
    (2, "float32"), (3, "float32"), (2, "bfloat16"), (3, "bfloat16"),
])
def test_lossgrad_plain_matches_jax_autodiff(layers, dtype):
    cfg, params, inputs = _lossgrad_setup(layers, dtype)
    lossrows, w, grads = _port_lossgrad(cfg, params, inputs)
    assert lossrows.shape == (3, R) and w.shape == (R, S)
    (_, (l_rgb, l_dep, l_sem, w_ref)), g_ref = jax.jit(jax.value_and_grad(
        lambda p: _oracle_loss(p, cfg, *inputs), has_aux=True
    ))(jax.tree.map(jnp.asarray, params))
    f32 = dtype == "float32"
    terms = [lossrows[0].sum() / (3 * R), lossrows[1].sum() / R, lossrows[2].sum() / R]
    for a, b in zip(terms, (l_rgb, l_dep, l_sem)):
        close(a, b, rtol=1e-5 if f32 else 1e-2)
    if f32:
        close(w, w_ref, rtol=1e-4, atol=1e-5)
    else:
        on_scale(w, w_ref, 2e-2)
    ref = flat_tree(jax.tree.map(np.asarray, g_ref))
    got = flat_tree(grads)
    assert set(got) == set(ref)
    for k in ref:
        on_scale(got[k], ref[k], 1e-4 if f32 else 5e-2, k)


def test_lossgrad_plain_matches_pallas_interpret():
    """The plain version against ``spectral.forward_packed_lossgrad`` with
    the Pallas kernel in interpret mode, at the JAX test's tolerances and,
    as there, with the initial zero biases (the two add hidden biases on
    either side of the bf16 rounding)."""
    cfg, params, inputs = _lossgrad_setup(3, "bfloat16", noisy_biases=False)
    lossrows, w, grads = _port_lossgrad(cfg, params, inputs)
    lr_j, w_j, g_j = j_sp.forward_packed_lossgrad(
        jax.tree.map(jnp.asarray, params), cfg, *inputs, loss_weights=LOSS_W
    )
    close(w, w_j, rtol=2e-2, atol=2e-2)
    for i, norm in enumerate((3 * R, R, R)):
        close(lossrows[i].sum() / norm, np.sum(lr_j[i]) / norm, rtol=3e-2, atol=3e-3)
    ref = flat_tree(jax.tree.map(np.asarray, g_j))
    got = flat_tree(grads)
    for k in ref:
        on_scale(got[k], ref[k], 5e-2, k)


def test_lossgrad_wrapper_rejects_unsupported_device():
    cfg, params, inputs = _lossgrad_setup(2, "bfloat16")
    field = t_sp.SpectralField.from_tree(params)
    meta = [T(a).to("meta") for a in inputs]
    with pytest.raises(ValueError):
        t_fvr.fused_field_volrend_lossgrad(list(field.parameters()), *meta[:8], S)


# -- schedule and optimizer ------------------------------------------------------------


@pytest.mark.parametrize("gamma", [1.0, 0.5])
def test_cyclic_lr(gamma):
    counts = np.arange(0, 61)  # 0-3 cycles of step_size_up 10
    ref = j_sched.cyclic_lr(6e-4, 6e-3, 10, gamma=gamma)(counts)
    got = t_sched.cyclic_lr(6e-4, 6e-3, 10, gamma=gamma)(T(counts))
    close(got, ref, rtol=1e-6)


def _adam_setup():
    rng = np.random.default_rng(3)
    params = {"a": rng.normal(size=(4, 5)).astype(np.float32),
              "b": rng.normal(size=(7,)).astype(np.float32)}
    grads = [
        {k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
        for _ in range(3)
    ]
    return params, grads


def test_adam_matches_optax():
    params, grads = _adam_setup()
    j_opt = optax.adam(j_sched.cyclic_lr(6e-4, 6e-3, 2), eps=1e-15)
    pj, sj = params, j_opt.init(params)
    opt = Adam(t_sched.cyclic_lr(6e-4, 6e-3, 2), eps=1e-15)
    pt = [T(params["a"]), T(params["b"])]
    st = opt.init(pt)
    for g in grads:
        upd, sj = j_opt.update(g, sj, pj)
        pj = optax.apply_updates(pj, upd)
        st, bad = opt.step(pt, [T(g["a"]), T(g["b"])], st)
        assert not bool(bad)
        for a, k in zip(pt, ("a", "b")):
            close(a, pj[k], rtol=1e-6, atol=1e-7)
    adam_state = sj[0]
    close(st.mu, np.concatenate([np.ravel(adam_state.mu[k]) for k in ("a", "b")]), rtol=1e-5,
          atol=1e-6)
    close(st.nu, np.concatenate([np.ravel(adam_state.nu[k]) for k in ("a", "b")]), rtol=1e-5,
          atol=1e-6)
    assert int(st.count) == int(adam_state.count) == 3


def test_adam_nan_gradient_leaves_everything_untouched():
    params, grads = _adam_setup()
    opt = Adam(t_sched.cyclic_lr(6e-4, 6e-3, 2), eps=1e-15)
    pt = [T(params["a"]), T(params["b"])]
    st, _ = opt.step(pt, [T(grads[0]["a"]), T(grads[0]["b"])], opt.init(pt))
    before = [p.clone() for p in pt]
    bad_g = T(grads[1]["b"])
    bad_g[3] = float("nan")
    st2, bad = opt.step(pt, [T(grads[1]["a"]), bad_g], st)
    assert bool(bad)
    for a, b in zip(pt, before):
        assert torch.equal(a, b)
    assert torch.equal(st2.mu, st.mu) and torch.equal(st2.nu, st.nu)
    assert int(st2.count) == int(st.count) == 1


def test_make_optimizer_refuses_weight_decay():
    """Until the mapper loop was ported, both weight-decay options raised;
    now they build (``tests/test_torch_ports.py`` holds them to optax):
    ``weight_decay`` decays every parameter, ``spectral_spectrum_wd`` the
    main field's spectrum only, and neither is on by default."""
    assert make_optimizer(PipelineConfig()).weight_decay == 0.0
    every = make_optimizer(PipelineConfig(weight_decay=1e-4))
    assert every.weight_decay == 1e-4 and every.decay_mask is None
    spectrum = make_optimizer(PipelineConfig(spectral_spectrum_wd=1e-4))
    assert spectrum.weight_decay == 1e-4
    assert spectrum.decay_mask("main.W", None) and spectrum.decay_mask("main.phase", None)
    assert not spectrum.decay_mask("prop.W", None)
    assert not spectrum.decay_mask("main.mlp_base.w0", None)


# -- data: fetch, pools, FakeSim -----------------------------------------------------------


def _scan(rng, n=4, h=24, w=32):
    images = rng.integers(0, 256, (n, h, w, 3)).astype(np.uint8)
    depths = rng.uniform(0.1, 5.0, (n, h, w)).astype(np.float32)
    sems = rng.integers(0, 5, (n, h, w)).astype(np.int32)
    mats = []
    for _ in range(n):
        q = rng.normal(size=4)
        mats.append(t_fake.pose_matrix_from_quat(rng.uniform(-0.5, 0.5, 3), q / np.linalg.norm(q)))
    return images, depths, sems, np.stack(mats).astype(np.float32)


def _fetch_draws(key, num_rays, h, w):
    k_x, k_y, k_bkgd = jax.random.split(key, 3)
    return {
        "x": T(jax.random.randint(k_x, (num_rays,), 0, w)),
        "y": T(jax.random.randint(k_y, (num_rays,), 0, h)),
        "bkgd": T(jax.random.uniform(k_bkgd, (3,))),
    }


def test_fetch_rays_matches_jax():
    rng = np.random.default_rng(4)
    images, depths, sems, mats = _scan(rng)
    K = t_ds.make_intrinsics(32, 24, np.pi / 2)
    key = jax.random.PRNGKey(8)
    bj = j_ds.fetch_rays(images, depths, sems, mats, K, jnp.asarray(2), key, 50)
    bt = t_ds.fetch_rays(
        T(images), T(depths), T(sems), T(mats), T(K), torch.tensor(2), 50,
        draws=_fetch_draws(key, 50, 24, 32),
    )
    for a, b in zip(bt, bj):
        close(a, b, rtol=1e-6, atol=1e-6)
    assert bt.sem.dtype == torch.int32


@pytest.mark.parametrize("recent_bias", [False, True])
def test_sample_pool_index_matches_jax(recent_bias):
    pools = np.array([[0, 1, 2, 3, 4, 5, 0, 0], [1, 1, 3, 5, 5, 0, 0, 0]], np.int32)
    counts = np.array([6, 5], np.int32)
    for seed in range(6):
        keys = jax.random.split(jax.random.PRNGKey(seed), 2)
        ref = [
            int(j_phase._sample_pool_index(
                jnp.asarray(pools[m]), jnp.asarray(counts[m]), keys[m],
                jnp.asarray(recent_bias), jnp.asarray(6), 2,
            ))
            for m in range(2)
        ]
        coin, pick = zip(*[
            [float(jax.random.uniform(k)) for k in jax.random.split(keys[m])] for m in range(2)
        ])
        got = t_phase._sample_pool_index(
            T(pools), T(counts), recent_bias, 6, 2, T(np.float32(coin)), T(np.float32(pick))
        )
        assert got.tolist() == ref


def test_fakesim_matches_jax_pixel_for_pixel():
    poses = [
        np.array([-4.0, 1.5, -4.0, 0.0, 0.0, 0.0, 1.0]),
        np.array([-2.0, 1.0, -5.0, 0.0, np.sin(0.6), 0.0, np.cos(0.6)]),
        np.array([-6.5, 2.5, -1.5, 0.1, np.sin(2.0), 0.05, np.cos(2.0)]),
    ]
    kw = dict(aabb=(-8.0, 0.0, -8.0, 0.0, 3.0, 0.0), img_w=48, img_h=40)
    for a, b in zip(t_fake.FakeSim(**kw).sample_images_from_poses(poses),
                    j_fake.FakeSim(**kw).sample_images_from_poses(poses)):
        np.testing.assert_array_equal(a, b)


# -- the member step and the phase ------------------------------------------------------------


def _train_cfg(n_ensembles):
    return PipelineConfig(
        aabb=(-1.0, -1.0, -1.0, 1.0, 1.0, 1.0), img_w=32, img_h=24, num_rays=64,
        max_samples_train=8, num_prop_samples=8, num_semantic_classes=5,
        n_ensembles=n_ensembles, max_images=4, n_levels=4, spectral_freqs_per_level=2,
        base_resolution=4, max_resolution=32, spectral_neurons=32, spectral_layers=3,
        geo_feat_dim=7, prop_neurons=16,
    )


@pytest.fixture
def field_dtype(request, monkeypatch):
    """Both packages' field configs in the requested compute dtype (the
    float32 field is a config option the pipeline config does not expose)."""
    dtype = request.param
    monkeypatch.setenv("APNERF_FUSED_LOSSGRAD", "0")  # JAX: the autodiff branch
    for mod in (j_fl, t_fl):
        for fn in ("make_spectral_config", "make_prop_config"):
            orig = getattr(mod, fn)
            monkeypatch.setattr(
                mod, fn, lambda c, orig=orig: orig(c)._replace(compute_dtype=dtype)
            )
    return dtype


def _noise(k_occ, R_, S_):
    """The stratified draw of the member core's proposal sampling."""
    _, k_samp = jax.random.split(k_occ)
    return T(jax.random.uniform(jax.random.split(k_samp)[1], (R_, S_ + 1)))


def _compare_params(port_members, jax_params, dtype, cfg, n_steps):
    rel = 2e-3 if dtype == "float32" else 5e-2
    lr = float(t_fl.default_spectral_schedule(cfg)(n_steps))
    atol = (1e-2 if dtype == "float32" else 3.0) * n_steps * lr
    for i, m in enumerate(port_members):
        ref = jax.tree.map(lambda a: np.asarray(a)[i], jax_params)
        flat = {
            ".".join(k.key for k in path): v
            for path, v in jax.tree_util.tree_flatten_with_path(ref)[0]
        }
        for name, p in m.named_parameters():
            ref_p = np.asarray(flat[name], np.float32)
            err = np.abs(p.detach().numpy() - ref_p).max()
            assert err <= rel * max(np.abs(ref_p).max(), 1e-6) + atol, (name, err)


def _jax_state(cfg, members):
    """The port members' parameters as a stacked JAX ensemble state with
    fresh optimizer states and grids (``init_flagship_ensemble``'s layout;
    building it from the port skips JAX's op-by-op init)."""
    trees = []
    for m in members:
        tree = {}
        for name, v in m.state_dict().items():
            *path, leaf = name.split(".")
            node = tree
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = jnp.asarray(v.numpy())
        trees.append(tree)
    opt = j_fl.make_optimizer(cfg, j_fl.default_spectral_schedule(cfg))
    stack = lambda ts: jax.tree.map(lambda *xs: jnp.stack(xs), *ts)
    grid = j_occ.init_occ_grid(cfg.aabb, cfg.main_grid_resolution)
    return j_step.EnsembleState(
        params=stack(trees), opt_state=stack([opt.init(t) for t in trees]),
        occ=stack([grid] * len(members)), step=jnp.asarray(0),
    )


@pytest.mark.parametrize("field_dtype", ["float32", "bfloat16"], indirect=True)
def test_member_step_matches_jax(field_dtype, monkeypatch):
    # the call site hands the weights kernel what its wrapper takes on the
    # card: three contiguous float32 [R, S] tensors
    seen = []
    real = t_fl.fused_render_weights
    monkeypatch.setattr(t_fl, "fused_render_weights", lambda *a: seen.append(a) or real(*a))
    cfg = _train_cfg(1)
    state_t = t_fl.init_flagship_ensemble(cfg, torch.Generator().manual_seed(0))
    state = _jax_state(cfg, state_t.members)
    first = lambda tree: jax.tree.map(lambda x: x[0], tree)
    rng = np.random.default_rng(5)
    o = rng.uniform(-2, 2, (64, 3)).astype(np.float32)
    vd = rng.normal(size=(64, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    arrays = (o, vd, rng.uniform(size=(64, 3)).astype(np.float32),
              rng.uniform(0.1, 3.0, 64).astype(np.float32),
              rng.integers(0, 5, 64).astype(np.int32), np.ones(3, np.float32))
    k_occ = jax.random.PRNGKey(6)
    out_j = jax.jit(j_fl.make_flagship_member_core(cfg))(
        first(state.params), first(state.opt_state), first(state.occ),
        j_ds.RayBatch(*map(jnp.asarray, arrays)), k_occ, jnp.asarray(0), jnp.asarray(1e-3),
    )
    # the combined-kernel branch (the path) and the autograd branch (its
    # plain reference), each from the same initial member
    members = [state_t.members[0], copy.deepcopy(state_t.members[0])]
    rtol = 1e-5 if field_dtype == "float32" else 1e-2
    for member, route in zip(members, ("lossgrad", "field")):
        out_t = t_fl.make_flagship_member_core(cfg, route=route)(
            member, state_t.opt[0], t_ds.RayBatch(*map(T, arrays)), 0,
            noise=_noise(k_occ, 64, 8),
        )
        for a, b in zip(out_t[1:6], out_j[3:8]):
            close(a, b, rtol=rtol)
        assert not bool(out_t.skipped) and not bool(out_j[8])
        assert int(out_t.opt.count) == 1
        _compare_params([member], jax.tree.map(lambda a: a[None], out_j[0]), field_dtype,
                        cfg, 1)
    # the proposal loss's weights (the combined-kernel route's own call site)
    assert seen and all(x.dtype == torch.float32 and x.is_contiguous() and x.shape == a[2].shape
                        and x.dim() == 2 for a in seen for x in a)


@pytest.mark.parametrize("field_dtype", ["float32", "bfloat16"], indirect=True)
def test_two_step_phase_matches_jax(field_dtype):
    cfg = _train_cfg(2)
    E, n_rays, S_ = cfg.n_ensembles, cfg.num_rays, cfg.max_samples_train
    rng = np.random.default_rng(7)
    images, depths, sems, mats = _scan(rng, h=cfg.img_h, w=cfg.img_w)
    ds_j = j_ds.RayDataset(True, num_rays=n_rays, num_models=E, width=cfg.img_w,
                           height=cfg.img_h, max_images=cfg.max_images)
    ds_t = t_ds.RayDataset(True, num_rays=n_rays, num_models=E, width=cfg.img_w,
                           height=cfg.img_h, max_images=cfg.max_images, device="cpu")
    for ds in (ds_j, ds_t):
        ds.update_data(images, depths, sems, mats)
    pools_j, counts_j = j_phase.pools_from_dataset(ds_j)
    pools_t, counts_t = t_phase.pools_from_dataset(ds_t)
    np.testing.assert_array_equal(pools_t.numpy(), np.asarray(pools_j))
    state_t = t_fl.init_flagship_ensemble(cfg, torch.Generator().manual_seed(1))
    state_j = _jax_state(cfg, state_t.members)
    keys = jax.random.split(jax.random.PRNGKey(2), 2)
    state_j, losses_j = j_fl.make_flagship_train_phase(cfg)(
        state_j, ds_j.images, ds_j.depths, ds_j.semantics, ds_j.camtoworlds, ds_j.K,
        pools_j, counts_j, jnp.asarray(ds_j.size), keys, jnp.asarray(1e-3), jnp.asarray(False),
    )
    draws = []
    for key in keys:
        k_pick, k_fetch, k_occ = jax.random.split(key, 3)
        coin, pick = zip(*[
            [float(jax.random.uniform(k)) for k in jax.random.split(pk)]
            for pk in jax.random.split(k_pick, E)
        ])
        fetch = [_fetch_draws(k, n_rays, cfg.img_h, cfg.img_w) for k in jax.random.split(k_fetch, E)]
        draws.append({
            "coin": T(np.float32(coin)), "pick": T(np.float32(pick)),
            **{k: torch.stack([f[k] for f in fetch]) for k in ("x", "y", "bkgd")},
            "noise": torch.stack([_noise(k, n_rays, S_) for k in jax.random.split(k_occ, E)]),
        })
    state_t, losses_t = t_fl.make_flagship_train_phase(cfg)(
        state_t, ds_t.images, ds_t.depths, ds_t.semantics, ds_t.camtoworlds, ds_t.K,
        pools_t, counts_t, ds_t.size, 2, False, draws=draws,
    )
    assert state_t.step == 2 and losses_t.shape == (2, E)
    close(losses_t, losses_j, rtol=1e-5 if field_dtype == "float32" else 1e-2)
    assert [int(o.count) for o in state_t.opt] == [2, 2]
    _compare_params(state_t.members, state_j.params, field_dtype, cfg, 2)


def test_port_members_are_trainable():
    cfg = _train_cfg(1)
    state = t_fl.init_flagship_ensemble(cfg, torch.Generator().manual_seed(0))
    params = list(state.members[0].parameters())
    assert params and all(p.requires_grad for p in params)
    assert state.opt[0].mu.numel() == sum(p.numel() for p in params)
