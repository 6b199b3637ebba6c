"""Parity of the port's example-trainer slice with the JAX package's, on the
CPU at tiny sizes: the scene contraction, the 'lindisp' proposal warp and
sampling, the alpha side of volume rendering and ``prefix_trans``, the
sinusoidal encoding, the vanilla, T-NeRF and NDR-TNeRF fields, the NGP
proposal field, unbounded NGP and spectral fields, one step of each of the
four trainers, five steps of the NGP + occupancy trainer with a render, and
T-NeRF's relu density dying (or not) in 16 steps where JAX's does.

Inputs come from a seeded numpy generator, weights from the JAX
initialisers carried across by ``interop.py``, and every random draw
(the occupancy update's, the stratified proposal jitter, T-NeRF's cell
timestamps) from ``jax.random``, handed to the port. Tolerances, each
with its reason:
  * elementwise float32 maps (the contraction, the warps, the encoding,
    the alpha-side scans): rtol 1e-5 / atol 1e-6 (the same operations,
    exp/sin and cumulative products in another order);
  * the fields and their gradients: 1e-4 of each tensor's scale
    (float32 matmul chains summed in another order), the MLP fields'
    gradients 1e-3 (``MLP_GRAD_TOL``: derivatives of sines of x·2^9);
  * one trainer step: the loss rtol 1e-4; the gradient, read from Adam's
    first moment, 1e-3 of each tensor's max-abs (5e-2 for T-NeRF,
    ``MLP_STEP_GRAD_TOL``: about twice what JAX reads against itself);
    the update of each
    parameter as ``test_torch_ngp.py`` holds it (Adam's first step moves
    an element by ±lr wherever its gradient is clearly non-zero, so the
    update is compared where JAX's moment exceeds twice the gradient's
    tolerance of its tensor's max-abs, is exactly 0 where JAX's gradient
    is, and at most lr
    elsewhere); the occupancy grid's EMA rtol 1e-5 (1e-3 for the MLP
    fields, ``MLP_OCC_RTOL``) and its binaries exactly;
  * five steps: the loss sequence rtol 1e-3 and the render rtol 1e-3 /
    atol 1e-4 (updates of ±lr on a few elements whose tiny gradients
    change sign between the two sums move later steps slightly).
Fresh NGP fields start every cell at nearly one density (tables U(±1e-4)),
so the occupancy threshold would split cells on rounding alone; the NGP
trainers' tests redraw the tables N(0, 1) first, as ``test_torch_ngp.py``
does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apnerf_tpu.models import mlp as j_mlp
from apnerf_tpu.models import ngp as j_ngp
from apnerf_tpu.models import propnet as j_prop
from apnerf_tpu.models import spectral as j_sp
from apnerf_tpu.ops import contraction as j_con
from apnerf_tpu.ops import volrend as j_vr
from apnerf_tpu.train import examples as j_ex
from apnerf_tpu_torch import interop
from apnerf_tpu_torch.models import mlp as t_mlp
from apnerf_tpu_torch.models import ngp as t_ngp
from apnerf_tpu_torch.models import propnet as t_prop
from apnerf_tpu_torch.models import spectral as t_sp
from apnerf_tpu_torch.ops import contraction as t_con
from apnerf_tpu_torch.ops import volrend as t_vr
from apnerf_tpu_torch.train import examples as t_ex
from apnerf_tpu_torch.train import flagship as t_flag
from apnerf_tpu_torch.train_ngp_occ import sample_batch

AABB = (-1.0, -1.0, -1.0, 1.0, 1.0, 1.0)
TINY_NGP = dict(neurons=32, layers=1, n_levels=4, n_features=2, log2_hashmap_size=10,
                base_resolution=4, max_resolution=16, geo_feat_dim=7)
TINY_PROP = dict(n_levels=2, log2_hashmap_size=8, max_resolution=16)
TINY_VANILLA = dict(net_depth=6, net_width=32, skip_layer=4, net_width_condition=16)
EW = dict(rtol=1e-5, atol=1e-6)
FIELD_TOL = 1e-4
# the MLP fields' occupancy EMA: their position encoding takes sines of
# x·2^9, where float32 spaces arguments ~6e-5 apart and XLA's and
# PyTorch's sin round such arguments differently
MLP_OCC_RTOL = 1e-3
# gradients through that encoding: its derivatives scale by up to 2^9, so a
# parameter's gradient sums terms ~10^3 with cancellation; T-NeRF's warp
# gradient reads 1.4e-4 of its scale against JAX on fixed points, and in a
# trainer step JAX's jitted step and the same step run op by op differ by
# 2.6e-2 of scale in the warp's first moment (1.9e-2 in its first layer)
MLP_GRAD_TOL = 1e-3
MLP_STEP_GRAD_TOL = 5e-2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """PyTorch on one CPU thread, restored after: the suite runs several
    test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(a):
    return torch.as_tensor(np.array(a))


def close(port, ref, **tol):
    port = port.detach().numpy() if torch.is_tensor(port) else np.asarray(port)
    np.testing.assert_allclose(port, np.asarray(ref), **(tol or EW))


def same(port, ref):
    port = port.detach().numpy() if torch.is_tensor(port) else np.asarray(port)
    np.testing.assert_array_equal(port, np.asarray(ref))


def on_scale(port, ref, rel, name=""):
    port = port.detach().numpy() if torch.is_tensor(port) else np.asarray(port)
    ref = np.asarray(ref, np.float32).reshape(port.shape)
    err = np.abs(port - ref).max()
    assert err <= rel * max(np.abs(ref).max(), 1e-12), (name, err, np.abs(ref).max())


def np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def by_name(tree):
    return {".".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _rays(rng, R, lo=-0.3, hi=0.3):
    o = rng.uniform(lo, hi, (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


# -- contraction, warps, volume rendering, encoding ------------------------------------------


def test_contract_to_unisphere():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(400, 3)).astype(np.float32) * 3.0
    x[:3] = [[0.0, 0.0, 0.0], [0.5, 0.5, 0.5], [1e3, -1e3, 5.0]]  # centre, inside, far away
    aabb = np.array([-1.0, -0.5, -2.0, 1.0, 1.5, 2.0], np.float32)
    got = t_con.contract_to_unisphere(T(x), T(aabb))
    close(got, j_con.contract_to_unisphere(jnp.asarray(x), jnp.asarray(aabb)))
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0


@pytest.mark.parametrize("per_ray", [False, True])
def test_transform_stot_lindisp(per_ray):
    """The 'lindisp' warp over four orders of magnitude, scalar or per-ray
    bounds."""
    rng = np.random.default_rng(1)
    s = np.sort(rng.uniform(size=(6, 11)).astype(np.float32), axis=-1)
    s[:, 0], s[:, -1] = 0.0, 1.0
    lo = rng.uniform(0.1, 0.3, 6).astype(np.float32)
    hi = np.full(6, 1e3, np.float32)
    if not per_ray:
        lo, hi = np.float32(0.2), np.float32(1e3)
    got = t_prop.transform_stot(T(s), T(lo), T(hi), "lindisp")
    close(got, j_prop.transform_stot("lindisp", s, lo, hi))
    close(got[:, 0], np.broadcast_to(lo, (6,)))
    close(got[:, -1], np.broadcast_to(hi, (6,)), rtol=1e-5)
    with pytest.raises(ValueError, match="warp"):
        t_prop.transform_stot(T(s), T(lo), T(hi), "log")


@pytest.mark.parametrize("stratified", [False, True])
def test_propnet_sampling_lindisp(stratified):
    rng = np.random.default_rng(2)
    R = 16
    o, d = _rays(rng, R)

    def sig(t0, t1, lib):
        tm = 0.5 * (t0 + t1)
        return 5.0 * lib.exp(-((lib.log(tm) - 1.0) ** 2))

    key = jax.random.PRNGKey(7)
    t0j, t1j, lvj = j_prop.propnet_sampling(
        key, [lambda a, b: sig(a, b, jnp)], [32], 24, o, d, 0.2, 1e3,
        sampling_type="lindisp", stratified=stratified)
    noise = np.asarray(jax.random.uniform(jax.random.split(key)[1], (R, 25)))
    t0t, t1t, lvt = t_prop.propnet_sampling(
        [lambda a, b: sig(a, b, torch)], [32], 24, T(o), T(d), 0.2, 1e3, stratified=stratified,
        noises=[T(noise)], sampling_type="lindisp")
    close(t0t, t0j, rtol=1e-5)
    close(t1t, t1j, rtol=1e-5)
    for (ej, wj), (et, wt) in zip(lvj, lvt):
        close(et, ej, rtol=1e-5)
        close(wt, wj)
    edges = lvt[0][0]
    assert float(edges.max()) > 1e3 * float(edges.min())  # four orders of magnitude


def test_volrend_alpha_side():
    rng = np.random.default_rng(3)
    alphas = rng.uniform(0, 0.3, (9, 17)).astype(np.float32)
    alphas[0, 3] = 1.0  # an opaque sample: a zero in the product
    prefix = rng.uniform(0.2, 1.0, 9).astype(np.float32)
    close(t_vr.exclusive_prod(T(1 - alphas)), j_vr.exclusive_prod(jnp.asarray(1 - alphas)))
    for pre in (None, prefix):
        pj = None if pre is None else jnp.asarray(pre)
        pt = None if pre is None else T(pre)
        close(t_vr.render_transmittance_from_alpha(T(alphas), pt),
              j_vr.render_transmittance_from_alpha(jnp.asarray(alphas), pj))
        for a, b in zip(t_vr.render_weight_from_alpha(T(alphas), pt),
                        j_vr.render_weight_from_alpha(jnp.asarray(alphas), pj)):
            close(a, b)
    for eps, thre in ((1e-4, 0.0), (0.05, 0.1)):
        vis = t_vr.render_visibility_from_alpha(T(alphas), early_stop_eps=eps, alpha_thre=thre)
        same(vis, j_vr.render_visibility_from_alpha(jnp.asarray(alphas), eps, thre))
    assert not bool(vis.all())


def test_render_weight_from_density_prefix_trans():
    rng = np.random.default_rng(4)
    edges = np.sort(rng.uniform(0.1, 3.0, (7, 13)).astype(np.float32), axis=-1)
    t0, t1 = edges[:, :-1], edges[:, 1:]
    sig = rng.uniform(0, 3, (7, 12)).astype(np.float32)
    prefix = rng.uniform(0.1, 1.0, (7, 1)).astype(np.float32)
    got = t_vr.render_weight_from_density(T(t0), T(t1), T(sig), prefix_trans=T(prefix))
    ref = j_vr.render_weight_from_density(t0, t1, sig, prefix_trans=prefix)
    for a, b in zip(got, ref):
        close(a, b)
    close(got[0], t_vr.render_weight_from_density(T(t0), T(t1), T(sig))[0] * T(prefix))


@pytest.mark.parametrize("degs,identity", [((0, 10), True), ((0, 4), False), ((2, 5), True),
                                           ((3, 3), True)])
def test_sinusoidal_encode(degs, identity):
    x = np.random.default_rng(5).uniform(-2, 2, (50, 3)).astype(np.float32)
    got = t_mlp.sinusoidal_encode(T(x), *degs, use_identity=identity)
    close(got, j_mlp.sinusoidal_encode(jnp.asarray(x), *degs, use_identity=identity))
    if degs[0] < degs[1]:
        assert got.shape[-1] == t_mlp._enc_dim(3, *degs, identity)


# -- the MLP fields ---------------------------------------------------------------------------


def _grads_match(loss_t, module, loss_j_fn, params_j, x_t, x_j, tol=FIELD_TOL):
    """Gradients of a scalar loss in every parameter and in the positions,
    against JAX's, each to ``tol`` of its scale."""
    leaves = list(module.parameters())
    got = torch.autograd.grad(loss_t, leaves + [x_t])
    ref_p, ref_x = jax.grad(loss_j_fn, argnums=(0, 1))(params_j, x_j)
    ref = by_name(ref_p)
    for (name, _), g in zip(module.named_parameters(), got[:-1]):
        on_scale(g, ref[name], tol, name)
    on_scale(got[-1], ref_x, tol, "positions")


def _points(seed, n=(40, 5)):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.2, 1.2, n + (3,)).astype(np.float32)
    d = rng.normal(size=n + (3,)).astype(np.float32)
    return rng, x, d / np.linalg.norm(d, axis=-1, keepdims=True)


def _loss(lib, outs, g):
    return sum(lib.sum(o * w) for o, w in zip(outs, g))


def test_vanilla_nerf_forward_density_and_gradients():
    cfg_j, cfg_t = j_mlp.VanillaNeRFConfig(**TINY_VANILLA), t_mlp.VanillaNeRFConfig(**TINY_VANILLA)
    pj = np_tree(j_mlp.init_vanilla_nerf(jax.random.PRNGKey(0), cfg_j))
    field = interop.vanilla_nerf_from_tree(pj)
    assert {n: tuple(p.shape) for n, p in field.named_parameters()} == \
        {k: v.shape for k, v in by_name(pj).items()}
    tree = {n: tuple(p.shape) for n, p in
            t_mlp.init_vanilla_nerf(cfg_t, torch.Generator().manual_seed(0)).named_parameters()}
    assert tree == {n: tuple(p.shape) for n, p in field.named_parameters()}
    rng, x, d = _points(6)
    g = [rng.normal(size=(40, 5, c)).astype(np.float32) for c in (3, 1)]
    ref = j_mlp.vanilla_forward(pj, jnp.asarray(x), jnp.asarray(d), cfg_j)
    for a, b in zip(t_mlp.vanilla_forward(field, T(x), T(d), cfg_t), ref):
        on_scale(a, b, FIELD_TOL)
    on_scale(t_mlp.vanilla_query_density(field, T(x), cfg_t),
             j_mlp.vanilla_query_density(pj, jnp.asarray(x), cfg_j), FIELD_TOL)
    xt = T(x).requires_grad_(True)
    loss = _loss(torch, t_mlp.vanilla_forward(field, xt, T(d), cfg_t), [T(a) for a in g])
    _grads_match(loss, field,
                 lambda p, xx: _loss(jnp, j_mlp.vanilla_forward(p, xx, jnp.asarray(d), cfg_j), g),
                 pj, xt, jnp.asarray(x), MLP_GRAD_TOL)


def _tnerf_cfgs():
    kw = dict(warp_depth=2, warp_width=16)
    return (j_mlp.TNeRFConfig(base=j_mlp.VanillaNeRFConfig(**TINY_VANILLA), **kw),
            t_mlp.TNeRFConfig(base=t_mlp.VanillaNeRFConfig(**TINY_VANILLA), **kw))


def test_tnerf_forward_density_and_gradients():
    cfg_j, cfg_t = _tnerf_cfgs()
    pj = np_tree(j_mlp.init_tnerf(jax.random.PRNGKey(1), cfg_j))
    field = interop.tnerf_from_tree(pj)
    rng, x, d = _points(7)
    t = rng.uniform(0, 1, (40, 5, 1)).astype(np.float32)
    t[:10] = 0.0  # the warp is identically zero at t = 0
    ref = j_mlp.tnerf_forward(pj, jnp.asarray(x), jnp.asarray(t), jnp.asarray(d), cfg_j)
    out = t_mlp.tnerf_forward(field, T(x), T(t), T(d), cfg_t)
    for a, b in zip(out, ref):
        on_scale(a, b, FIELD_TOL)
    base = t_mlp.vanilla_forward(field.base, T(x), T(d), cfg_t.base)
    for a, b in zip(base, out):
        same(a[:10], b[:10].detach())
    on_scale(t_mlp.tnerf_query_density(field, T(x), T(t), cfg_t),
             j_mlp.tnerf_query_density(pj, jnp.asarray(x), jnp.asarray(t), cfg_j), FIELD_TOL)
    g = [rng.normal(size=(40, 5, c)).astype(np.float32) for c in (3, 1)]
    xt = T(x).requires_grad_(True)
    loss = _loss(torch, t_mlp.tnerf_forward(field, xt, T(t), T(d), cfg_t), [T(a) for a in g])
    _grads_match(loss, field, lambda p, xx: _loss(
        jnp, j_mlp.tnerf_forward(p, xx, jnp.asarray(t), jnp.asarray(d), cfg_j), g),
        pj, xt, jnp.asarray(x), MLP_GRAD_TOL)


def test_ndr_tnerf_forward_and_gradients():
    kw = dict(width=16, time_feat=8)
    cfg_j = j_mlp.NDRTNeRFConfig(base=j_mlp.VanillaNeRFConfig(**TINY_VANILLA), **kw)
    cfg_t = t_mlp.NDRTNeRFConfig(base=t_mlp.VanillaNeRFConfig(**TINY_VANILLA), **kw)
    pj = np_tree(j_mlp.init_ndr_tnerf(jax.random.PRNGKey(2), cfg_j))
    rng = np.random.default_rng(8)
    # last layers redrawn N(0, 0.03²), so the warp moves points by up to
    # ~0.75; at 0.3 the three blocks amplify a first-block rounding
    # difference of 3e-6 to 2e-4 (sines of rotated, lifted coordinates)
    for b in pj["blocks"].values():
        for k in ("warp1", "warp2"):
            last = f"w{len(b[k]) // 2 - 1}"
            b[k][last] = rng.normal(size=b[k][last].shape).astype(np.float32) * 0.03
    field = interop.ndr_tnerf_from_tree(pj)
    port_init = t_mlp.init_ndr_tnerf(cfg_t, torch.Generator().manual_seed(0))
    assert {n: tuple(p.shape) for n, p in port_init.named_parameters()} == \
        {n: tuple(p.shape) for n, p in field.named_parameters()}
    w_last = port_init.blocks["1"]["warp2"].w1
    assert 0.0 <= float(w_last.min()) and float(w_last.max()) <= 1e-4
    _, x, d = _points(9)
    t = rng.uniform(0, 1, (40, 5, 1)).astype(np.float32)
    warped = t_mlp.ndr_warp(field, T(x), T(t), cfg_t)
    close(warped, j_mlp.ndr_warp(pj, jnp.asarray(x), jnp.asarray(t), cfg_j), rtol=FIELD_TOL,
          atol=1e-5)
    assert float((warped - T(x)).abs().max()) > 1e-2
    ref = j_mlp.ndr_tnerf_forward(pj, jnp.asarray(x), jnp.asarray(t), jnp.asarray(d), cfg_j)
    out = t_mlp.ndr_tnerf_forward(field, T(x), T(t), T(d), cfg_t)
    for a, b in zip(out, ref):
        on_scale(a, b, FIELD_TOL)
    g = [rng.normal(size=(40, 5, c)).astype(np.float32) for c in (3, 1)]
    xt = T(x).requires_grad_(True)
    loss = _loss(torch, t_mlp.ndr_tnerf_forward(field, xt, T(t), T(d), cfg_t), [T(a) for a in g])
    _grads_match(loss, field, lambda p, xx: _loss(
        jnp, j_mlp.ndr_tnerf_forward(p, xx, jnp.asarray(t), jnp.asarray(d), cfg_j), g),
        pj, xt, jnp.asarray(x), MLP_GRAD_TOL)


# -- NGP and spectral fields: the proposal field, unbounded fields ---------------------------


@pytest.mark.parametrize("unbounded", [False, True])
def test_query_density_field(unbounded):
    cfg_j = j_ngp.NGPDensityConfig(aabb=AABB, unbounded=unbounded, **TINY_PROP)
    cfg_t = t_ngp.NGPDensityConfig(aabb=AABB, unbounded=unbounded, **TINY_PROP)
    assert cfg_t.grid._asdict() == cfg_j.grid._asdict()
    pj = np_tree(j_ngp.init_ngp_density(jax.random.PRNGKey(3), cfg_j))
    rng = np.random.default_rng(10)
    pj["table"] = rng.normal(size=pj["table"].shape).astype(np.float32)
    field = interop.ngp_density_from_tree(pj)
    assert {n: tuple(p.shape) for n, p in t_ngp.init_ngp_density(
        cfg_t, torch.Generator().manual_seed(0)).named_parameters()} == \
        {n: tuple(p.shape) for n, p in field.named_parameters()}
    x = rng.uniform(-3, 3, (60, 4, 3)).astype(np.float32)
    got = t_ngp.query_density_field(field, cfg_t, T(x))
    close(got, j_ngp.query_density_field(pj, cfg_j, jnp.asarray(x)), rtol=FIELD_TOL, atol=1e-5)
    outside = (np.abs(x) >= 1.0).any(-1)
    assert bool((got[..., 0][T(outside)] > 0).all()) == unbounded
    g = rng.normal(size=(60, 4, 1)).astype(np.float32)
    xt = T(x).requires_grad_(True)
    _grads_match((t_ngp.query_density_field(field, cfg_t, xt) * T(g)).sum(), field,
                 lambda p, xx: jnp.sum(j_ngp.query_density_field(p, cfg_j, xx) * g),
                 pj, xt, jnp.asarray(x))


def test_unbounded_ngp_field():
    kw = dict(aabb=AABB, unbounded=True, num_semantic_classes=3, **TINY_NGP)
    cfg_j, cfg_t = j_ngp.NGPConfig(**kw), t_ngp.NGPConfig(**kw)
    pj = np_tree(j_ngp.init_ngp(jax.random.PRNGKey(4), cfg_j))
    rng = np.random.default_rng(11)
    pj["table"] = rng.normal(size=pj["table"].shape).astype(np.float32)
    field = interop.member_from_tree(pj)
    t_ngp.init_ngp(cfg_t, torch.Generator().manual_seed(0))  # no longer refused
    x = rng.uniform(-4, 4, (50, 6, 3)).astype(np.float32)
    _, _, d = _points(12, (50, 6))
    out_t = t_ngp.forward(field, cfg_t, T(x), T(d))
    out_j = j_ngp.forward(pj, cfg_j, jnp.asarray(x), jnp.asarray(d))
    for a, b in zip(out_t, out_j):
        close(a, b, rtol=FIELD_TOL, atol=1e-5)
    assert bool((out_t[1] > 0).all())  # no selector: density everywhere


def test_unbounded_spectral_field_and_route(monkeypatch):
    """An unbounded spectral field contracts the scene; its trunk takes the
    field kernel as JAX's ``_use_fused_field`` does (no condition on
    ``unbounded``), and the packed kernels, whose selector is the unit
    cube's, decline it: its train route is ``field``."""
    kw = dict(aabb=AABB, neurons=32, layers=2, n_levels=4, freqs_per_level=4, base_freq=2.0,
              max_freq=16.0, num_semantic_classes=3, unbounded=True, compute_dtype="float32")
    cfg_j, cfg_t = j_sp.SpectralConfig(**kw, fused="off"), t_sp.SpectralConfig(**kw)
    pj = np_tree(j_sp.init_spectral(jax.random.PRNGKey(5), cfg_j))
    field = t_sp.SpectralField.from_tree(pj)
    rng = np.random.default_rng(13)
    x = rng.uniform(-5, 5, (30, 8, 3)).astype(np.float32)
    _, _, d = _points(14, (30, 8))
    out_t = t_sp.forward(field, cfg_t, T(x), T(d))
    out_j = j_sp.forward(pj, cfg_j, jnp.asarray(x), jnp.asarray(d))
    for a, b in zip(out_t, out_j):
        on_scale(a, b, FIELD_TOL)
    pk = dict(aabb=AABB, neurons=16, layers=2, n_levels=2, freqs_per_level=4, unbounded=True,
              compute_dtype="float32")
    pcj, pct = j_sp.SpectralDensityConfig(**pk, fused="off"), t_sp.SpectralDensityConfig(**pk)
    ppj = np_tree(j_sp.init_spectral_density(jax.random.PRNGKey(6), pcj))
    close(t_sp.query_density_field(t_sp.SpectralDensityField.from_tree(ppj), pct, T(x)),
          j_sp.query_density_field(ppj, pcj, jnp.asarray(x)), rtol=FIELD_TOL, atol=1e-5)

    bf16 = cfg_t._replace(compute_dtype="bfloat16")
    assert t_flag.default_route(bf16) == "field"
    assert t_flag.default_route(bf16._replace(unbounded=False)) == "lossgrad"
    seen = []
    real = t_sp.fused_spectral_field
    monkeypatch.setattr(t_sp, "fused_spectral_field", lambda *a: seen.append(a[3]) or real(*a))
    t_sp.query_density(field, bf16, T(x))
    close(seen[0], t_con.contract_to_unisphere(T(x), T(AABB)).reshape(-1, 3))
    rays_d = T(d[:, 0])
    with pytest.raises(ValueError, match="unbounded"):
        t_sp.forward_packed(field, bf16, T(x), rays_d)
    with pytest.raises(ValueError, match="unbounded"):
        t_sp.forward_packed_volrend(field, bf16, T(x), rays_d, T(x[..., 0]), T(x[..., 0]),
                                    torch.zeros(30, dtype=torch.bool))


# -- the trainers -----------------------------------------------------------------------------


def _occ_draws(key, n, warm):
    """The occupancy update's draws from its key, as ``update_occ_grid``
    splits it."""
    k_jit, k_uni, k_occ = jax.random.split(key, 3)
    n_sub = n // 4
    return {
        "jitter": T(jax.random.uniform(k_jit, (n if warm else 2 * n_sub, 3))),
        "uniform_idx": T(jax.random.randint(k_uni, (n_sub,), 0, n)).long(),
        "occ_u": T(jax.random.uniform(k_occ, (n_sub,))),
    }


def _batch(rng, R):
    """Rays from inside the box toward every direction; red up, blue down."""
    o, d = _rays(rng, R)
    px = np.where(d[:, 1:2] > 0, [[1.0, 0.2, 0.2]], [[0.2, 0.2, 1.0]]).astype(np.float32)
    return o, d, px


def _livelier(state_j, rng, keys=("table",)):
    """NGP tables redrawn N(0, 1), so cells differ in density."""
    params = np_tree(state_j["params"])
    for path in keys:
        node = params
        *head, leaf = path.split("/")
        for k in head:
            node = node[k]
        node[leaf] = rng.normal(size=node[leaf].shape).astype(np.float32)
    return {**state_j, "params": jax.tree.map(jnp.asarray, params)}, params


def _port_state(state_t, module, occ=None):
    return t_ex.TrainerState(module, state_t.opt, occ if occ is not None else state_t.occ, 0)


def _check_step(module, p0, out_j, lr, mu_t, grad_tol=1e-3):
    """One Adam step of the port against JAX's: the gradient (from the
    first moments) to ``grad_tol`` of each tensor's max-abs, and the update,
    as the module docstring sets out, where JAX's moment is over twice
    that tolerance (there the gradient's sign is settled)."""
    new_j = by_name(out_j["params"])
    mu_j = by_name(out_j["opt"][0].mu)
    sizes = [p.numel() for p in module.parameters()]
    for (name, p), m in zip(module.named_parameters(), torch.split(mu_t, sizes)):
        on_scale(m.reshape(p.shape), mu_j[name], grad_tol, name)
        start = p0[name]
        d_t, d_j = p.detach().numpy() - start, new_j[name] - start
        tol = 1e-3 * lr + 2 * np.finfo(np.float32).eps * np.abs(start)
        sure = np.abs(mu_j[name]) > 2 * grad_tol * np.abs(mu_j[name]).max()
        zero = mu_j[name] == 0
        assert np.all(np.abs(d_t - d_j)[sure] <= tol[sure]), name
        assert np.all(d_t[zero] == 0), name
        assert np.all(np.abs(d_t) <= lr * (1 + 1e-3) + tol), name


def _check_occ(occ_t, occ_j, rtol=1e-5):
    close(occ_t.occs, occ_j.occs, rtol=rtol, atol=1e-7)
    same(occ_t.binaries, occ_j.binaries)
    assert 0 < int(occ_t.binaries.sum()) < occ_t.binaries.numel()


OCC_KW = dict(grid_resolution=(8, 8, 8), render_step_size=0.05, max_samples=16, n_candidates=64)


def test_ngp_occ_trainer_step_matches_jax():
    rng = np.random.default_rng(20)
    state_j, step_j, _ = j_ex.make_ngp_occ_trainer(AABB, ngp_kwargs=TINY_NGP, **OCC_KW)
    state_j, params = _livelier(state_j, rng)
    state_t, step_t, _ = t_ex.make_ngp_occ_trainer(AABB, ngp_kwargs=TINY_NGP, device="cpu",
                                                   **OCC_KW)
    field = interop.member_from_tree(params)
    p0 = {n: p.detach().numpy().copy() for n, p in field.named_parameters()}
    o, d, px = _batch(rng, 64)
    bk = np.array([0.3, 0.6, 0.1], np.float32)
    key = jax.random.PRNGKey(21)
    out_j, loss_j = step_j(state_j, o, d, px, bk, key)
    state, loss_t, n = step_t(_port_state(state_t, field), T(o), T(d), T(px), T(bk),
                              occ_draws=_occ_draws(key, 512, True))
    close(loss_t, loss_j, rtol=1e-4)
    assert state.step == 1 and int(n) > 0
    _check_occ(state.occ, out_j["occ"])
    _check_step(field, p0, out_j, 1e-2, state.opt.mu)


def test_mlp_occ_trainer_step_matches_jax():
    rng = np.random.default_rng(22)
    kw = dict(OCC_KW, lr=1e-3)
    state_j, step_j = j_ex.make_mlp_occ_trainer(
        AABB, mlp_cfg=j_mlp.VanillaNeRFConfig(**TINY_VANILLA), **kw)
    state_t, step_t = t_ex.make_mlp_occ_trainer(
        AABB, mlp_cfg=t_mlp.VanillaNeRFConfig(**TINY_VANILLA), device="cpu", **kw)
    params = np_tree(state_j["params"])
    field = interop.vanilla_nerf_from_tree(params)
    p0 = {n: p.detach().numpy().copy() for n, p in field.named_parameters()}
    o, d, px = _batch(rng, 64)
    bk = np.ones(3, np.float32)
    key = jax.random.PRNGKey(23)
    out_j, loss_j = step_j(state_j, o, d, px, bk, key)
    state, loss_t, _ = step_t(_port_state(state_t, field), T(o), T(d), T(px), T(bk),
                              occ_draws=_occ_draws(key, 512, True))
    close(loss_t, loss_j, rtol=1e-4)
    _check_occ(state.occ, out_j["occ"], rtol=MLP_OCC_RTOL)
    _check_step(field, p0, out_j, 1e-3, state.opt.mu)


def test_tnerf_occ_trainer_step_matches_jax():
    """After the warm-up: the step-256 update draws n/2 cells (uniform and
    occupied) and one timestamp for each."""
    rng = np.random.default_rng(24)
    cfg_j, cfg_t = _tnerf_cfgs()
    kw = dict(OCC_KW, lr=1e-3)
    state_j, step_j = j_ex.make_tnerf_occ_trainer(AABB, tnerf_cfg=cfg_j, **kw)
    state_t, step_t = t_ex.make_tnerf_occ_trainer(AABB, tnerf_cfg=cfg_t, device="cpu", **kw)
    params = np_tree(state_j["params"])
    field = interop.tnerf_from_tree(params)
    occs = rng.uniform(0, 0.02, 512).astype(np.float32)
    bins = rng.uniform(size=(8, 8, 8)) < 0.5
    state_j = {**state_j, "step": jnp.asarray(256), "occ": state_j["occ"]._replace(
        occs=jnp.asarray(occs), binaries=jnp.asarray(bins))}
    occ_t = state_t.occ._replace(occs=T(occs), binaries=T(bins))
    p0 = {n: p.detach().numpy().copy() for n, p in field.named_parameters()}
    o, d, px = _batch(rng, 64)
    ts = rng.uniform(0, 1, 64).astype(np.float32)
    ts[:8] = 0.0
    bk = np.ones(3, np.float32)
    key = jax.random.PRNGKey(25)
    out_j, loss_j = step_j(state_j, o, d, px, ts, bk, key)
    k_occ, k_t = jax.random.split(key)
    state = t_ex.TrainerState(field, state_t.opt, occ_t, 256)
    state, loss_t, _ = step_t(state, T(o), T(d), T(px), T(ts), T(bk),
                              occ_draws=_occ_draws(k_occ, 512, False),
                              occ_times=T(jax.random.uniform(k_t, (256, 1))))
    close(loss_t, loss_j, rtol=1e-4)
    _check_occ(state.occ, out_j["occ"], rtol=MLP_OCC_RTOL)
    _check_step(field, p0, out_j, 1e-3, state.opt.mu, MLP_STEP_GRAD_TOL)


def test_ngp_prop_trainer_step_matches_jax(monkeypatch):
    """'lindisp' at near 0.2 and far 1e3: the rgb loss reaches the proposal
    field through the sampled intervals (nothing but ``prop_loss`` stops
    the gradient), so the proposal field's gradients catch a stray
    detach."""
    rng = np.random.default_rng(26)
    kw = dict(num_samples=16, prop_samples=(32,), ngp_kwargs=TINY_NGP, prop_kwargs=TINY_PROP)
    state_j, step_j = j_ex.make_ngp_prop_trainer(AABB, **kw)
    state_j, params = _livelier(state_j, rng, ("field/table", "prop/table"))
    state_t, step_t = t_ex.make_ngp_prop_trainer(AABB, device="cpu", **kw)
    module = torch.nn.ModuleDict({"field": interop.member_from_tree(params["field"]),
                                  "prop": interop.ngp_density_from_tree(params["prop"])})
    p0 = {n: p.detach().numpy().copy() for n, p in module.named_parameters()}
    o, d, px = _batch(rng, 64)
    bk = np.array([0.3, 0.6, 0.1], np.float32)
    key = jax.random.PRNGKey(27)
    out_j, loss_j = step_j(state_j, o, d, px, bk, key)
    noise = T(jax.random.uniform(jax.random.split(key)[1], (64, 17)))
    state, loss_t, n = step_t(_port_state(state_t, module), T(o), T(d), T(px), T(bk),
                              noises=[noise])
    close(loss_t, loss_j, rtol=1e-4)
    assert int(n) == 64 * 16 and state.occ is None
    _check_step(module, p0, out_j, 1e-2, state.opt.mu)

    # the rgb loss alone moves the proposal field through the intervals, by
    # far more than the gradient's tolerance: a detach would show above
    monkeypatch.setattr(t_ex, "prop_loss", lambda *a: torch.zeros(()))
    again = torch.nn.ModuleDict({"field": interop.member_from_tree(params["field"]),
                                 "prop": interop.ngp_density_from_tree(params["prop"])})
    rgb_only, _, _ = step_t(_port_state(state_t, again), T(o), T(d), T(px), T(bk),
                            noises=[noise])
    sizes = [p.numel() for p in module.parameters()]
    share = [float(part.abs().max() / full.abs().max()) for (name, _), full, part in zip(
        module.named_parameters(), torch.split(state.opt.mu, sizes),
        torch.split(rgb_only.opt.mu, sizes)) if name.startswith("prop.")]
    assert max(share) > 3e-3, share  # three times the gradient's tolerance


def test_ngp_occ_trainer_five_steps_and_render():
    """The slice as a whole: five steps (the grid updated at step 0) and
    one render of the trained state, against JAX on the same weights and
    draws."""
    rng = np.random.default_rng(28)
    state_j, step_j, render_j = j_ex.make_ngp_occ_trainer(AABB, ngp_kwargs=TINY_NGP, **OCC_KW)
    state_j, params = _livelier(state_j, rng)
    state_t, step_t, render_t = t_ex.make_ngp_occ_trainer(AABB, ngp_kwargs=TINY_NGP,
                                                          device="cpu", **OCC_KW)
    state = _port_state(state_t, interop.member_from_tree(params))
    key = jax.random.PRNGKey(29)
    losses_j, losses_t = [], []
    for i in range(5):
        key, k_batch, k_step = jax.random.split(key, 3)
        o, d, px = _batch(np.random.default_rng(100 + i), 64)
        bk = np.asarray(jax.random.uniform(k_batch, (3,)))
        state_j, lj = step_j(state_j, o, d, px, bk, k_step)
        state, lt, _ = step_t(state, T(o), T(d), T(px), T(bk),
                              occ_draws=_occ_draws(k_step, 512, True) if i == 0 else None)
        losses_j.append(float(lj))
        losses_t.append(float(lt))
    close(np.array(losses_t), np.array(losses_j), rtol=1e-3)
    _check_occ(state.occ, state_j["occ"])
    o, d, _ = _batch(np.random.default_rng(200), 96)
    out_j = render_j(state_j, o, d, jnp.ones(3))
    out_t = render_t(state, T(o), T(d), torch.ones(3))
    for k in ("rgb", "opacity", "depth"):
        close(out_t[k], out_j[k], rtol=1e-3, atol=1e-4)
    assert int(out_t["n_samples"]) == int(out_j["n_samples"]) > 0


def test_trainers_refuse_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        t_ex.make_ngp_occ_trainer(AABB, ngp_kwargs=TINY_NGP, **OCC_KW)
    with pytest.raises(RuntimeError, match="is_available"):
        t_ex.make_ngp_prop_trainer(AABB, ngp_kwargs=TINY_NGP, prop_kwargs=TINY_PROP)


# -- T-NeRF's relu density dies in some runs, in both packages ----------------------------------

BALL_AABB = (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5)
DEATH_KW = dict(grid_resolution=(16, 16, 16), render_step_size=0.04, max_samples=32,
                n_candidates=256)
DEATH_STEPS = 16


def _look_at(pos):
    fwd = -pos / np.linalg.norm(pos)
    right = np.cross(fwd, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.stack([right, np.cross(right, fwd), -fwd], axis=1)
    c2w[:3, 3] = pos
    return c2w


def _ball_views(n=20, size=32, angle_x=0.6911):
    """(RGBA uint8 [n, size, size, 4], c2w [n, 4, 4], K [3, 3]): a red ball
    of radius 0.8 at the origin, Lambert-shaded, alpha 0 off it, seen from
    a Fibonacci lattice of cameras at radius 4 looking at the origin."""
    focal = 0.5 * size / np.tan(0.5 * angle_x)
    i = np.arange(n) + 0.5
    y = 1.0 - 2.0 * i / n
    phi = np.pi * (3.0 - np.sqrt(5.0)) * i
    pos = 4.0 * np.stack([np.sqrt(1 - y * y) * np.cos(phi), y, np.sqrt(1 - y * y) * np.sin(phi)], 1)
    c2ws = np.stack([_look_at(p) for p in pos])
    v, u = np.meshgrid(np.arange(size) + 0.5, np.arange(size) + 0.5, indexing="ij")
    d_cam = np.stack([(u - size / 2) / focal, -(v - size / 2) / focal, -np.ones_like(u)], -1)
    images = []
    for c2w in c2ws:
        d = d_cam.reshape(-1, 3) @ c2w[:3, :3].T
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        o = c2w[:3, 3]
        b = d @ o
        disc = b * b - (o @ o - 0.64)
        t = -b - np.sqrt(np.maximum(disc, 0.0))
        normal = (o + t[:, None] * d) / 0.8
        shade = 0.35 + 0.65 * np.clip(normal @ np.array([0.4, 0.8, 0.45]), 0.0, 1.0)
        rgba = np.zeros((size * size, 4))
        rgba[disc > 0, :3] = shade[disc > 0, None] * np.array([0.9, 0.2, 0.15])
        rgba[disc > 0, 3] = 1.0
        images.append((rgba.reshape(size, size, 4) * 255 + 0.5).astype(np.uint8))
    K = np.array([[focal, 0, size / 2], [0, focal, size / 2], [0, 0, 1]], np.float32)
    return torch.as_tensor(np.stack(images)), torch.as_tensor(c2ws), torch.as_tensor(K)


def _cell_centres(res):
    g = (np.arange(res) + 0.5) * (3.0 / res) - 1.5
    return np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3).astype(np.float32)


def _max_density(query, params, cells):
    """The largest density over ``cells`` at t = 0, 0.5 and 1 (0: the relu
    density takes no gradient from any sample again)."""
    return max(float(np.max(np.asarray(query(params, cells, np.full((len(cells), 1), t,
                                                                     np.float32)))))
               for t in (0.0, 0.5, 1.0))


def _nudged(tree, k):
    """Every element of ``tree`` moved one float32 ulp up or down, the
    directions drawn from ``k``."""
    rng = np.random.default_rng(k)
    return jax.tree.map(lambda a: np.nextafter(a, np.where(rng.uniform(size=a.shape) < 0.5,
                                                           np.float32(np.inf),
                                                           np.float32(-np.inf))).astype(np.float32),
                        np_tree(tree))


def _tnerf_runs(seed, nudge=None):
    """DEATH_STEPS steps of each package's T-NeRF trainer from JAX's init
    at ``seed`` (moved one ulp by ``_nudged(·, nudge)`` if given), on the
    same batches of the ball's views and the same draws → (JAX's losses,
    the port's, JAX's largest density at the end, the port's)."""
    views = _ball_views()
    times = torch.linspace(0, 1, views[0].shape[0])
    state_j, step_j = j_ex.make_tnerf_occ_trainer(BALL_AABB, seed=seed, **DEATH_KW)
    params = np_tree(state_j["params"]) if nudge is None else _nudged(state_j["params"], nudge)
    state_j = {**state_j, "params": jax.tree.map(jnp.asarray, params)}
    state_t, step_t = t_ex.make_tnerf_occ_trainer(BALL_AABB, device="cpu", **DEATH_KW)
    state = t_ex.TrainerState(interop.tnerf_from_tree(params), state_t.opt, state_t.occ, 0)
    n = int(np.prod(DEATH_KW["grid_resolution"]))
    gen = torch.Generator().manual_seed(5000 + seed)
    losses_j, losses_t = [], []
    for i in range(DEATH_STEPS):
        o, d, px, bk, ids = sample_batch(gen, *views, 128)
        ts = times[ids]
        key = jax.random.PRNGKey(7000 + 100 * seed + i)
        state_j, lj = step_j(state_j, o.numpy(), d.numpy(), px.numpy(), ts.numpy(), bk.numpy(),
                             key)
        draws = {}
        if i % 16 == 0:  # the warm-up's update, every cell
            k_occ, k_t = jax.random.split(key)
            draws = dict(occ_draws=_occ_draws(k_occ, n, True),
                         occ_times=T(jax.random.uniform(k_t, (n, 1))))
        state, lt, _ = step_t(state, o, d, px, ts, bk, **draws)
        losses_j.append(float(lj))
        losses_t.append(float(lt))
    cells = _cell_centres(DEATH_KW["grid_resolution"][0])
    with torch.no_grad():
        dens_t = _max_density(lambda p, x, t: t_mlp.tnerf_query_density(p, T(x), T(t)),
                              state.params, cells)
    dens_j = _max_density(j_mlp.tnerf_query_density, state_j["params"], cells)
    return np.array(losses_j), np.array(losses_t), dens_j, dens_t


@pytest.mark.parametrize("seed, dies", [(1, True), (14, False)])
def test_tnerf_trainer_dies_where_jax_does(seed, dies):
    """T-NeRF's relu density dies in its first steps in most runs at these
    sizes, JAX's trainer the same: on the same weights, batches and draws
    the port dies where JAX does and lives where JAX lives (seed 1 died and
    seed 14 lived in both packages from JAX's init and from each of ten
    one-ulp nudges of it: the ``__main__`` count below). The first loss
    agrees at rtol 1e-4. Later losses of a living field are not compared:
    Adam's first step moves every weight whose gradient is not exactly 0
    by ±lr, the warp's gradient through sines of x·2^9 has elements whose
    sign the summation order decides (``MLP_STEP_GRAD_TOL``), and a
    one-ulp nudge of JAX's own weights parts its trajectory the same way; a dead
    field renders the background alone, so its last loss agrees at 1e-5."""
    losses_j, losses_t, dens_j, dens_t = _tnerf_runs(seed)
    close(losses_t[0], losses_j[0], rtol=1e-4)
    assert (dens_j == 0) == dies and (dens_t == 0) == dies, (dens_j, dens_t)
    if dies:
        close(losses_t[-1], losses_j[-1], rtol=1e-5)
    assert np.isfinite(losses_t).all()


if __name__ == "__main__":
    # The death count behind the test above, over a range of seeds, each from JAX's init and
    # from NUDGES one-ulp nudges of it, on the CPU:
    #   PYTHONPATH=. python tests/test_torch_examples.py FIRST_SEED END_SEED NUDGES
    import sys

    jax.config.update("jax_platforms", "cpu")
    first, end, nudges = map(int, sys.argv[1:4])
    torch.set_num_threads(1)
    for seed in range(first, end):
        runs = [_tnerf_runs(seed, k) for k in [None] + list(range(1, nudges + 1))]
        dead_j = [r[2] == 0 for r in runs]
        dead_t = [r[3] == 0 for r in runs]
        print(f"seed {seed}: died at JAX's init: JAX {dead_j[0]}, port {dead_t[0]}; over the init "
              f"and {nudges} nudges: JAX {sum(dead_j)}, port {sum(dead_t)} of {len(runs)}; "
              f"both alike in {sum(a == b for a, b in zip(dead_j, dead_t))}", flush=True)
