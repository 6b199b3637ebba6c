"""Parity of the port's fields, field kernel, renderer and occupancy
update with the JAX package's, on the CPU at narrow widths.

Weights are made by the JAX package's own init (plus seeded numpy noise
on the biases, so the two bias conventions differ: f32 before rounding
in the kernels, bf16 after rounding in the plain chain) and
carried across with ``interop.params_from_jax``. Tolerances:
  * float32 fields (``compute_dtype="float32"``, a supported JAX config):
    1e-4 of the tensor's max-abs: the same algorithm, with matmul
    summation orders that differ;
  * bf16 fields: 2e-2 of the tensor's max-abs, as
    ``tests/test_pallas_fused_mlp.py`` compares bf16 paths: a one-ulp
    difference in u can flip the rounding of a high-frequency feature;
  * renders and PI: float32 1e-4 relative; bf16 3e-2 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apnerf_tpu.config import PipelineConfig
from apnerf_tpu.models import spectral as j_sp
from apnerf_tpu.ops.pallas.fused_mlp import fused_spectral_field as j_fused_spectral_field
from apnerf_tpu.ops import occupancy as j_occ
from apnerf_tpu.render import prop_renderer as j_pr
from apnerf_tpu.train.step import EnsembleState
from apnerf_tpu.train import flagship as j_fl
from apnerf_tpu_torch.interop import params_from_jax
from apnerf_tpu_torch.models import spectral as t_sp
from apnerf_tpu_torch.models.nn import MLP
from apnerf_tpu_torch.ops.cuda.fused_mlp import (
    fused_spectral_field,
    fused_spectral_field_plain,
)
from apnerf_tpu_torch.render import prop_renderer as t_pr
from apnerf_tpu_torch.train import flagship as t_fl

AABB = (-4.0, 0.0, -4.0, 0.0, 3.0, 0.0)
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def T(a):
    return torch.as_tensor(np.array(a))


def on_scale(port, ref, rel):
    port = port.detach().float().numpy() if torch.is_tensor(port) else np.asarray(port)
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    scale = max(np.abs(ref).max(), 1e-6)
    err = np.abs(port - ref).max() / scale
    assert err <= rel, (err, rel)


def small_cfg(**kw):
    base = dict(
        aabb=AABB, spectral_neurons=32, spectral_layers=3, spectral_freqs_per_level=2,
        n_levels=4, base_resolution=4, max_resolution=32, geo_feat_dim=7,
        num_semantic_classes=6, prop_neurons=16, n_ensembles=2,
        render_step_size=0.05, main_grid_size=0.5, occ_warmup_steps=8,
    )
    base.update(kw)
    return PipelineConfig(**base)


def jax_ensemble(cfg, seed=0):
    """JAX-initialized ensemble params as numpy, with noisy biases."""
    members = []
    for k in jax.random.split(jax.random.PRNGKey(seed), cfg.n_ensembles):
        k1, k2 = jax.random.split(k)
        members.append({
            "main": j_sp.init_spectral(k1, j_fl.make_spectral_config(cfg)),
            "prop": j_sp.init_spectral_density(k2, j_fl.make_prop_config(cfg)),
        })
    params = jax.tree.map(lambda *xs: np.stack(xs), *members)
    rng = np.random.default_rng(seed)

    def noisy(path, a):
        a = np.array(a)
        if path[-1].key.startswith("b"):
            a = a + rng.normal(0, 0.1, a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(noisy, params)


def configs(cfg, dtype):
    js = j_fl.make_spectral_config(cfg)._replace(compute_dtype=dtype, fused="off")
    jp = j_fl.make_prop_config(cfg)._replace(compute_dtype=dtype, fused="off")
    ts = t_fl.make_spectral_config(cfg)._replace(compute_dtype=dtype)
    tp = t_fl.make_prop_config(cfg)._replace(compute_dtype=dtype)
    return js, jp, ts, tp


def member0(tree):
    return jax.tree.map(lambda a: a[0], tree)


def positions(rng, n):
    lo, hi = np.array(AABB[:3]), np.array(AABB[3:])
    # a margin outside the box exercises the selector
    return rng.uniform(lo - 0.3, hi + 0.3, (n, 3)).astype(np.float32)


def test_configs_match_jax():
    cfg = PipelineConfig()
    js, jp = j_fl.make_spectral_config(cfg), j_fl.make_prop_config(cfg)
    ts, tp = t_fl.make_spectral_config(cfg), t_fl.make_prop_config(cfg)
    for t_cfg, j_cfg in ((ts, js), (tp, jp)):
        for f in t_cfg._fields:
            assert getattr(t_cfg, f) == getattr(j_cfg, f), f
        assert t_cfg.n_freqs == j_cfg.n_freqs and t_cfg.enc_dim == j_cfg.enc_dim


def test_init_matches_jax_layout():
    cfg = small_cfg()
    members, occ = t_fl.init_flagship_params(cfg, torch.Generator().manual_seed(0))
    ref = member0(jax_ensemble(cfg))
    flat_ref = {
        "/".join(k.key for k in path): np.shape(v)
        for path, v in jax.tree_util.tree_flatten_with_path(ref)[0]
    }
    flat_t = {k.replace(".", "/"): tuple(v.shape) for k, v in members[0].state_dict().items()}
    assert flat_t == flat_ref
    assert len(members) == 2 and len(occ) == 2
    assert tuple(occ[0].binaries.shape) == cfg.main_grid_resolution
    # band frequencies follow the geometric ladder
    norms = members[0].main.W.norm(dim=0).reshape(4, 2)
    np.testing.assert_allclose(norms[:, 0].detach().numpy(), [4.0, 8.0, 16.0, 32.0], rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_main_field(dtype):
    cfg = small_cfg()
    tree = jax_ensemble(cfg)
    js, _, ts, _ = configs(cfg, dtype)
    pj, pt = member0(tree)["main"], params_from_jax(tree)[0].main
    rng = np.random.default_rng(1)
    x = positions(rng, 300).reshape(20, 15, 3)
    d = rng.normal(size=(20, 15, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    dj, fj = j_sp.query_density(pj, js, x, return_feat=True)
    dt, ft = t_sp.query_density(pt, ts, T(x), return_feat=True)
    on_scale(dt, dj, TOL[dtype])
    on_scale(ft, fj, TOL[dtype])
    assert (dt.detach().numpy()[..., 0] == 0).any()  # outside the box
    out_j = j_sp.forward(pj, js, x, d)
    out_t = t_sp.forward(pt, ts, T(x), T(d))
    for a, b in zip(out_t, out_j):
        on_scale(a, b, TOL[dtype])
    on_scale(t_sp.query_rgb(pt, ts, T(d), ft), j_sp.query_rgb(pj, js, d, fj), TOL[dtype])
    on_scale(t_sp.query_semantic(pt, ts, ft), j_sp.query_semantic(pj, js, fj), TOL[dtype])
    u = rng.uniform(size=(64, 3)).astype(np.float32)
    on_scale(t_sp.spectral_encode(pt, ts, T(u)), j_sp.spectral_encode(pj, js, u), TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_proposal_field(dtype):
    cfg = small_cfg()
    tree = jax_ensemble(cfg)
    _, jp, _, tp = configs(cfg, dtype)
    x = positions(np.random.default_rng(2), 256).reshape(16, 16, 3)
    on_scale(
        t_sp.query_density_field(params_from_jax(tree)[1].prop, tp, T(x)),
        j_sp.query_density_field(jax.tree.map(lambda a: a[1], tree)["prop"], jp, x),
        TOL[dtype],
    )


@pytest.mark.parametrize("layers", [2, 3])
def test_field_kernel_plain_matches_pallas_interpret(layers):
    """The CUDA field kernel's plain version against
    ``fused_spectral_field`` in interpret mode, as
    ``tests/test_pallas_fused_mlp.py`` runs it (N=256, bf16 scale 2e-2).
    The plain version adds hidden biases in bf16 after rounding, the
    Pallas kernel in f32 before: the noisy biases exercise both."""
    cfg = small_cfg(spectral_layers=layers)
    pj = member0(jax_ensemble(cfg))["main"]
    pt = params_from_jax(jax_ensemble(cfg))[0].main
    u = np.random.default_rng(3).uniform(size=(256, 3)).astype(np.float32)
    ref = j_fused_spectral_field(pj["W"], pj["phase"], pj["mlp_base"], u)
    fused_spectral_field.launches = 0
    got = fused_spectral_field(pt.W, pt.phase, pt.mlp_base, T(u))
    assert fused_spectral_field.launches == 0  # CPU: plain version
    np.testing.assert_array_equal(
        got.detach().numpy(),
        fused_spectral_field_plain(pt.W, pt.phase, pt.mlp_base, T(u)).detach().numpy(),
    )
    on_scale(got, ref, TOL["bfloat16"])


def test_field_wrapper_rejects_unsupported_device():
    mlp = MLP([(torch.zeros(16, 16, device="meta"), torch.zeros(16, device="meta"))] * 3)
    W = torch.zeros(3, 8, device="meta")
    with pytest.raises(ValueError):
        fused_spectral_field(W, torch.zeros(8, device="meta"), mlp, torch.zeros(4, 3, device="meta"))


@pytest.mark.parametrize(
    "dtype,stratified", [("float32", False), ("float32", True), ("bfloat16", False)]
)
def test_render_rays_prop_with_variance(dtype, stratified, monkeypatch):
    # the call site hands the weights kernel what its wrapper takes on the
    # card: three contiguous float32 [R, S] tensors
    seen = []
    real = t_pr.fused_render_weights
    monkeypatch.setattr(t_pr, "fused_render_weights", lambda *a: seen.append(a) or real(*a))
    cfg = small_cfg()
    tree = jax_ensemble(cfg)
    js, jp, ts, tp = configs(cfg, dtype)
    mj, mt = member0(tree), params_from_jax(tree)[0]
    rng = np.random.default_rng(4)
    R, S, Sp = 24, 32, 16
    o = rng.uniform([-3, 1, -3], [-1, 2, -1], (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o[0] = [10.0, 10.0, 10.0]  # a ray that misses the box
    aabb = np.asarray(AABB, np.float32)
    bk = np.array([0.1, 0.2, 0.3], np.float32)
    key = jax.random.PRNGKey(7)
    oj, _ = j_pr.render_rays_prop(
        lambda p, dd: j_sp.forward(mj["main"], js, p, dd),
        lambda p: j_sp.query_density_field(mj["prop"], jp, p),
        o, d, aabb, key, num_samples=S, num_prop_samples=Sp, near_plane=0.1,
        render_bkgd=bk, stratified=stratified, with_variance=True,
    )
    noise = np.asarray(jax.random.uniform(jax.random.split(key)[1], (R, S + 1)))
    ot = t_pr.render_rays_prop(
        lambda p, dd: t_sp.forward(mt.main, ts, p, dd),
        lambda p: t_sp.query_density_field(mt.prop, tp, p),
        T(o), T(d), T(aabb), num_samples=S, num_prop_samples=Sp, near_plane=0.1,
        render_bkgd=T(bk), stratified=stratified, with_variance=True,
        noises=[T(noise)],
    )
    assert set(ot) == set(oj)
    assert int(ot["n_samples"]) == int(oj["n_samples"]) == (R - 1) * S
    assert seen and all(x.dtype == torch.float32 and x.is_contiguous() and x.shape == a[2].shape
                        and x.dim() == 2 for a in seen for x in a)
    rel = 1e-4 if dtype == "float32" else 3e-2
    for k in ("rgb", "opacity", "depth", "sem", "rgb_var", "depth_var"):
        on_scale(ot[k], oj[k], rel)
    np.testing.assert_allclose(ot["rgb"][0].detach().numpy(), bk, rtol=1e-6)  # miss → background


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flagship_occ_update_warmup(dtype, monkeypatch):
    """The warm-up occupancy update (every cell, one jitter point each)
    with JAX's jitter injected into the port."""
    # the float32 field is a SpectralConfig option the pipeline config
    # does not expose: patch both packages' config functions alike
    for mod in (j_fl, t_fl):
        orig = mod.make_spectral_config
        monkeypatch.setattr(
            mod, "make_spectral_config",
            lambda c, orig=orig: orig(c)._replace(compute_dtype=dtype),
        )
    cfg = small_cfg()
    tree = jax_ensemble(cfg)
    grid = j_occ.init_occ_grid(cfg.aabb, cfg.main_grid_resolution)
    state = EnsembleState(
        params=jax.tree.map(jnp.asarray, tree), opt_state=None,
        occ=jax.tree.map(lambda a: jnp.stack([a] * cfg.n_ensembles), grid),
        step=jnp.asarray(0),
    )
    key = jax.random.PRNGKey(11)
    occ_j = j_fl.make_flagship_occ_update(dataclasses.replace(cfg, fused_field="off"))(
        state, key, 1e-2
    ).occ
    n = int(np.prod(cfg.main_grid_resolution))
    draws = [
        {"jitter": T(jax.random.uniform(jax.random.split(k, 3)[0], (n, 3)))}
        for k in jax.random.split(key, cfg.n_ensembles)
    ]
    _, occ0 = t_fl.init_flagship_params(cfg, torch.Generator().manual_seed(0))
    occ_t = t_fl.make_flagship_occ_update(cfg)(params_from_jax(tree), occ0, 0, 1e-2, draws=draws)
    for i in range(cfg.n_ensembles):
        on_scale(occ_t[i].occs, occ_j.occs[i], TOL[dtype])
        agree = (occ_t[i].binaries.numpy() == np.asarray(occ_j.binaries[i])).mean()
        assert agree >= (1.0 if dtype == "float32" else 0.99), agree
