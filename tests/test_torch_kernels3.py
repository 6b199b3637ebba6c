"""The backwards of the port's render and trunk kernels on the CPU: their
plain versions, which is what the wrappers run for CPU tensors and what
``chip_smoke.py`` holds the CUDA kernels to on the card, against the JAX
package at tiny sizes.

Inputs come from a seeded numpy generator and go through both sides. Each
plain backward is held twice: to ``jax.vjp`` of the unfused oracle chain
the JAX package's own kernel tests use (``tests/test_pallas_fused_mlp.py``,
``test_pallas_fused_field.py``, ``test_pallas_fused_volrend.py``) and to the
Pallas kernel itself in interpret mode. Tolerances, each with its reason:
  * forward of the MLP in bf16: 2e-2 of the output's scale, the JAX tests'
    own (bf16 rounding flips of hidden activations);
  * gradients in bf16, the Pallas kernels' and the oracles': 5e-2 of each
    leaf's max-abs, the JAX kernel tests' own limit (bf16 cotangents
    between layers, other summation orders, and an encode backward that
    rounds dproj to bf16 in the JAX package and not under autograd here);
    the cotangents are the JAX kernel tests' (a weight per output channel,
    noise on the render's weights);
  * the position gradient against a Pallas kernel: see ``POS_TOL``.
The biases are the initialiser's zeros: a Pallas kernel adds hidden biases
in f32 before the bf16 rounding, the plain chain after.
"""



import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apnerf_tpu.models import nn as j_nn
from apnerf_tpu.models import spectral as j_sp
from apnerf_tpu.ops import volrend as j_vr
from apnerf_tpu.ops.pallas import fused_mlp as j_fm
from apnerf_tpu_torch.models import spectral as t_sp
from apnerf_tpu_torch.models.nn import MLP
from apnerf_tpu_torch.ops.cuda import fused_field_heads as t_ffh
from apnerf_tpu_torch.ops.cuda import fused_field_volrend as t_fvr
from apnerf_tpu_torch.ops.cuda import fused_mlp as t_fm

AABB = (-1.0, -1.0, -1.0, 1.0, 1.0, 1.0)
C = 5
R, S = 128, 8  # whole 128-ray blocks, as the TPU layout plan of the fused render asks
COUNTERS = (
    t_fm.fused_spectral_field, t_fm.fused_spectral_field_bwd, t_fm.fused_mlp_apply,
    t_fm.fused_mlp_apply_bwd, t_ffh.fused_field_heads, t_ffh.fused_field_heads_bwd,
    t_fvr.fused_field_volrend, t_fvr.fused_field_volrend_bwd,
)


def T(a):
    return torch.as_tensor(np.array(a))


def on_scale(port, ref, rel, name=""):
    port = port.detach().float().numpy() if torch.is_tensor(port) else np.asarray(port)
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (name, port.shape, ref.shape)
    err = np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-6)
    assert err <= rel, (name, err, rel)


def no_launches():
    """On the CPU every wrapper takes its plain version and counts nothing."""
    return all(f.launches == 0 for f in COUNTERS)


# -- the MLP kernel's plain version (fused_mlp_apply) ------------------------------


def _mlp(layers, seed=0, din=32, h=32, dout=8):
    params = jax.tree.map(
        np.asarray, j_nn.init_mlp(jax.random.PRNGKey(seed), [din] + [h] * layers + [dout]))
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(256, din)).astype(np.float32)
    g = rng.normal(size=(256, dout)).astype(np.float32)
    return params, x, g


@pytest.mark.parametrize("x_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("layers", [2, 3])
def test_mlp_apply_plain_forward_matches_jax(layers, x_dtype):
    params, x, _ = _mlp(layers)
    xj = jnp.asarray(x, jnp.bfloat16 if x_dtype == "bfloat16" else jnp.float32)
    xt = T(x).to(torch.bfloat16 if x_dtype == "bfloat16" else torch.float32)
    mlp = MLP.from_tree(params)  # from the JAX init_mlp dict
    with torch.no_grad():
        y = t_fm.fused_mlp_apply(mlp, xt)
        assert torch.equal(y, t_fm.fused_mlp_apply_plain(mlp, xt)) and no_launches()
    assert y.dtype == torch.float32 and y.shape == (256, 8)
    pj = jax.tree.map(jnp.asarray, params)
    on_scale(y, j_nn.apply_mlp(pj, xj, compute_dtype=jnp.bfloat16), 2e-2)
    on_scale(y, j_fm.fused_mlp_apply(pj, xj), 2e-2)  # the Pallas kernel, interpret mode


@pytest.mark.parametrize("ref", ["oracle", "pallas"])
@pytest.mark.parametrize("x_dtype", ["bfloat16", "float32"])
def test_mlp_apply_plain_backward_matches_jax(x_dtype, ref):
    params, x, g = _mlp(3, seed=1)
    xj = jnp.asarray(x, jnp.bfloat16 if x_dtype == "bfloat16" else jnp.float32)
    xt = T(x).to(torch.bfloat16 if x_dtype == "bfloat16" else torch.float32)
    mlp = MLP.from_tree(params)
    grads, dx = t_fm.fused_mlp_apply_bwd(mlp.layers(), xt, T(g), True)
    assert dx.dtype == xt.dtype and no_launches()  # dx in x's dtype
    # the same through autograd and the wrapper
    xt2 = xt.clone().requires_grad_(True)
    t_fm.fused_mlp_apply(mlp, xt2).backward(T(g))
    assert torch.equal(xt2.grad, dx) and torch.equal(mlp.w0.grad, grads[0])
    fn = (j_fm.fused_mlp_apply if ref == "pallas"
          else lambda p, x_: j_nn.apply_mlp(p, x_, compute_dtype=jnp.bfloat16))
    _, vjp = jax.vjp(fn, jax.tree.map(jnp.asarray, params), xj)
    gp, gx = vjp(jnp.asarray(g))
    for i in range(4):
        on_scale(grads[2 * i], gp[f"w{i}"], 5e-2, f"w{i}")
        on_scale(grads[2 * i + 1], gp[f"b{i}"], 5e-2, f"b{i}")
    assert gx.dtype == xj.dtype
    on_scale(dx, np.asarray(gx, np.float32), 5e-2, "dx")


# -- the field kernel's plain backward (fused_spectral_field) ------------------------


def _spectral_setup(shape):
    """The main trunk's shape family (3 hidden layers, 1 + G outputs) or
    the proposal field's (2 hidden layers, one output), narrow."""
    if shape == "main trunk":
        cfg = j_sp.SpectralConfig(aabb=AABB, n_levels=4, freqs_per_level=2, base_freq=4.0,
                                  max_freq=32.0, neurons=32, layers=3, geo_feat_dim=7)
        params = j_sp.init_spectral(jax.random.PRNGKey(0), cfg)
    else:
        cfg = j_sp.SpectralDensityConfig(aabb=AABB, neurons=16, layers=2, n_levels=2,
                                         freqs_per_level=2, base_freq=2.0, max_freq=8.0)
        params = j_sp.init_spectral_density(jax.random.PRNGKey(0), cfg)
    params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(2)
    u = rng.uniform(size=(256, 3)).astype(np.float32)
    g = rng.normal(size=(256, params["mlp_base"][f"b{cfg.layers}"].shape[0])).astype(np.float32)
    return params, u, g


@pytest.mark.parametrize("ref", ["oracle", "pallas"])
@pytest.mark.parametrize("shape", ["main trunk", "proposal field"])
def test_spectral_field_plain_backward_matches_jax(shape, ref):
    params, u, g = _spectral_setup(shape)
    mlp = MLP.from_tree(params["mlp_base"])
    W, phase = T(params["W"]), T(params["phase"])
    dW, dphase, grads, du = t_fm.fused_spectral_field_bwd(
        W, phase, mlp.layers(), T(u), T(g), True)
    assert no_launches()
    # the same through autograd and the wrapper
    ut = T(u).requires_grad_(True)
    Wp = W.clone().requires_grad_(True)
    t_fm.fused_spectral_field(Wp, phase, mlp, ut).backward(T(g))
    assert torch.equal(ut.grad, du) and torch.equal(Wp.grad, dW)

    def oracle(W_, ph, p, u_):
        enc = j_sp._spectral_encode_core(W_, ph, u_, "bfloat16")
        return j_nn.apply_mlp(p, enc, compute_dtype=jnp.bfloat16)

    fn = j_fm.fused_spectral_field if ref == "pallas" else oracle
    pj = jax.tree.map(jnp.asarray, params)
    _, vjp = jax.vjp(fn, pj["W"], pj["phase"], pj["mlp_base"], jnp.asarray(u))
    gW, gph, gp, gu = vjp(jnp.asarray(g))
    on_scale(dW, gW, 5e-2, "W")
    on_scale(dphase, gph, 5e-2, "phase")
    for i in range(mlp.n_layers):
        on_scale(grads[2 * i], gp[f"w{i}"], 5e-2, f"w{i}")
        on_scale(grads[2 * i + 1], gp[f"b{i}"], 5e-2, f"b{i}")
    assert np.abs(np.asarray(gu)).sum() > 0
    on_scale(du, gu, 5e-2, "du")


# -- the packed field's and the fused render's plain backwards -------------------------


# The position gradient is a per-sample quantity, not a sum over samples:
# against the oracle chain it holds at the gradients' 5e-2; in the Pallas
# kernels single samples differ from the oracle chain itself by up to 0.15
# of the tensor's scale (a hidden unit at the edge of its ReLU, whose mask
# the kernel takes from the f32 pre-activation and the chains from the bf16
# activation, moves that sample's whole gradient), so there 2e-1.
POS_TOL = {"oracle": 5e-2, "pallas": 2e-1}


def _field_setup(seed=0):
    kw = dict(aabb=AABB, n_levels=4, freqs_per_level=2, base_freq=4.0, max_freq=32.0,
              neurons=32, layers=3, geo_feat_dim=7, num_semantic_classes=C)
    cfg_j, cfg_t = j_sp.SpectralConfig(**kw), t_sp.SpectralConfig(**kw)
    params = jax.tree.map(np.asarray, j_sp.init_spectral(jax.random.PRNGKey(seed), cfg_j))
    rng = np.random.default_rng(seed + 1)
    pos = rng.uniform(-1.3, 1.3, (R, S, 3)).astype(np.float32)  # straddles the box
    dirs = rng.normal(size=(R, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    edges = np.sort(rng.uniform(0.1, 3.0, (R, S + 1)).astype(np.float32), axis=-1)
    miss = (np.arange(R) % 17) == 0
    return cfg_j, cfg_t, params, (pos, dirs, edges[:, :-1].copy(), edges[:, 1:].copy(), miss), rng


def _port_grads(field, outs, cotangents, pos):
    leaves = list(field.parameters())
    grads = torch.autograd.grad(outs, leaves + [pos], cotangents)
    return {n: g for (n, _), g in zip(field.named_parameters(), grads)}, grads[-1]


def _compare_tree(got, ref_tree, rel):
    ref = {
        ".".join(k.key for k in path): np.asarray(v)
        for path, v in jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    }
    assert set(got) == set(ref)
    for k in ref:
        on_scale(got[k], ref[k], rel, k)


def _oracle_packed(params, cfg, pos, rays_d):
    dirs = jnp.broadcast_to(rays_d[:, None, :], pos.shape)
    rgb, density, sem = j_sp.forward(params, cfg, pos, dirs)
    return jnp.concatenate([rgb, density, sem], axis=-1)  # [R, S, 4 + C], the port's layout


@pytest.mark.parametrize("ref", ["oracle", "pallas"])
def test_field_heads_plain_backward_matches_jax(ref):
    cfg_j, cfg_t, params, (pos, dirs, _, _, _), rng = _field_setup()
    # a weight per channel, the same on every sample, so that every head gets
    # a cotangent (the JAX kernel test's loss)
    g = np.broadcast_to(rng.normal(size=(4 + C,)).astype(np.float32), (R, S, 4 + C)).copy()
    field = t_sp.SpectralField.from_tree(params)
    pos_t = T(pos).requires_grad_(True)
    y = t_sp.forward_packed(field, cfg_t, pos_t, T(dirs))
    got, dpos = _port_grads(field, [y], [T(g)], pos_t)
    # the wrapper's backward entry computes the same on CPU tensors
    u, sh = t_sp._packed_inputs(cfg_t, T(pos), T(dirs))
    direct, du = t_ffh.fused_field_heads_bwd(
        list(field.parameters()), u, sh, S, T(g).reshape(-1, 4 + C), True)
    assert torch.equal(direct[0], got["W"]) and du.shape == (R * S, 3) and no_launches()
    if ref == "pallas":
        fn = lambda p, x: jnp.moveaxis(j_sp.forward_packed(p, cfg_j, x, jnp.asarray(dirs)), 0, -1)
    else:
        fn = lambda p, x: _oracle_packed(p, cfg_j, x, jnp.asarray(dirs))
    _, vjp = jax.vjp(fn, jax.tree.map(jnp.asarray, params), jnp.asarray(pos))
    gp, gx = vjp(jnp.asarray(g))
    _compare_tree(got, gp, 5e-2)
    assert np.abs(np.asarray(gx)).sum() > 0  # the position gradient flows
    on_scale(dpos, gx, POS_TOL[ref], "positions")


def _oracle_volrend(params, cfg, pos, rays_d, t0, t1, miss):
    dirs = jnp.broadcast_to(rays_d[:, None, :], pos.shape)
    rgb, density, sem = j_sp.forward(params, cfg, pos, dirs)
    w, _, _ = j_vr.render_weight_from_density(t0, t1, density[..., 0] * (~miss[:, None]))
    acc = jnp.concatenate([
        jnp.einsum("rs,rsc->rc", w, rgb), jnp.sum(w, axis=-1, keepdims=True),
        jnp.sum(w * 0.5 * (t0 + t1), axis=-1, keepdims=True), jnp.einsum("rs,rsc->rc", w, sem),
    ], axis=-1)
    return acc, w  # [R, 5 + C], the port's layout


@pytest.mark.parametrize("ref", ["oracle", "pallas"])
def test_field_volrend_plain_backward_matches_jax(ref):
    cfg_j, cfg_t, params, (pos, dirs, t0, t1, miss), rng = _field_setup()
    # cotangents on both outputs, so the weights' own cotangent is exercised:
    # a weight per channel of the per-ray sums, the same on every ray, and
    # noise on the weights (the JAX kernel test's loss)
    g_acc = np.broadcast_to(rng.normal(size=(5 + C,)).astype(np.float32), (R, 5 + C)).copy()
    g_w = rng.normal(size=(R, S)).astype(np.float32)
    field = t_sp.SpectralField.from_tree(params)
    pos_t = T(pos).requires_grad_(True)
    acc, w = t_sp.forward_packed_volrend(field, cfg_t, pos_t, T(dirs), T(t0), T(t1), T(miss))
    got, dpos = _port_grads(field, [acc, w], [T(g_acc), T(g_w)], pos_t)
    # the wrapper's backward entry (per-ray cotangents rounded to bf16, as the
    # kernels round them) agrees with plain autograd to that rounding
    u, sh = t_sp._packed_inputs(cfg_t, T(pos), T(dirs))
    dt = ((T(t1) - T(t0)) * ~T(miss)[:, None]).reshape(-1)
    tm = (0.5 * (T(t0) + T(t1))).reshape(-1)
    direct, du = t_fvr.fused_field_volrend_bwd(
        list(field.parameters()), u, sh, dt, tm, S, T(g_acc), T(g_w).reshape(-1), True)
    assert du.shape == (R * S, 3) and no_launches()
    for (name, _), d in zip(field.named_parameters(), direct):
        on_scale(d, got[name].numpy(), 1e-2, name)
    no_gw, _ = t_fvr.fused_field_volrend_bwd(
        list(field.parameters()), u, sh, dt, tm, S, T(g_acc), None, False)
    assert not torch.equal(no_gw[0], direct[0])  # the weights' cotangent counts
    args = tuple(jnp.asarray(a) for a in (dirs, t0, t1, miss))
    if ref == "pallas":
        def fn(p, x):
            a, ww = j_sp.forward_packed_volrend(p, cfg_j, x, *args)
            return a.T, ww
    else:
        fn = lambda p, x: _oracle_volrend(p, cfg_j, x, *args)
    _, vjp = jax.vjp(fn, jax.tree.map(jnp.asarray, params), jnp.asarray(pos))
    gp, gx = vjp((jnp.asarray(g_acc), jnp.asarray(g_w)))
    _compare_tree(got, gp, 5e-2)
    on_scale(dpos, gx, POS_TOL[ref], "positions")


# -- what the wrappers refuse ------------------------------------------------------------


def test_backward_wrappers_refuse_what_they_do_not_take():
    """The CPU branch is taken for CPU tensors only: another device raises,
    on the forward and on the backward entry of each kernel. What a CUDA
    call would refuse (wrong dtype, non-contiguous) raises from the checks
    the wrappers share."""
    _, cfg_t, params, (pos, dirs, t0, t1, miss), _ = _field_setup()
    field = t_sp.SpectralField.from_tree(params)
    leaves = list(field.parameters())
    meta = lambda *shape: torch.empty(shape, device="meta")
    N = 16
    with pytest.raises(ValueError, match="unsupported device"):
        t_ffh.fused_field_heads_bwd(leaves, meta(N, 3), meta(2, 16), 8, meta(N, 4 + C))
    with pytest.raises(ValueError, match="unsupported device"):
        t_fvr.fused_field_volrend_bwd(leaves, meta(N, 3), meta(2, 16), meta(N), meta(N), 8,
                                      meta(2, 5 + C))
    mlp = field.mlp_base
    with pytest.raises(ValueError, match="unsupported device"):
        t_fm.fused_spectral_field_bwd(field.W, field.phase, mlp.layers(), meta(N, 3), meta(N, 8))
    with pytest.raises(ValueError, match="unsupported device"):
        t_fm.fused_mlp_apply(mlp, meta(N, 16))
    with pytest.raises(ValueError, match="unsupported device"):
        t_fm.fused_mlp_apply_bwd(mlp.layers(), meta(N, 16), meta(N, 8))
    x = torch.zeros((N, 16))
    with pytest.raises(ValueError, match="must be contiguous"):
        t_fm.check_tensor("fused_mlp_apply", x.T, "x", torch.float32, (16, N), x.device)
    with pytest.raises(ValueError, match="must be torch.float32"):
        t_fm.check_tensor("fused_mlp_apply_bwd", x.double(), "g", torch.float32, (N, 16), x.device)
    with pytest.raises(ValueError, match="must be contiguous"):
        t_ffh.check_tensor("fused_field_heads_bwd", x.T, "g", torch.float32, (16, N), x.device)
    with pytest.raises(ValueError, match="bf16 or f32"):
        t_fm._mlp_call("fused_mlp_apply", mlp.layers(), x.double())
    with pytest.raises(ValueError, match="unknown trunk route"):
        t_sp.query_density(field, cfg_t, T(pos), trunk="fastest")
    assert no_launches()
