"""Rays of more than 1024 samples, and bins past 1024, on the CPU at tiny
shapes: the kernels' launch plans, their arithmetic emulated in numpy, and
the port's plain versions against the JAX package past 1024 samples.

On the card the weights kernels walk a row of more than 1024 samples in
spans of 1024 (``csrc/volrend.cu``), the ray kernels of the field-and-
render kernels size their blocks from S (``csrc/fused_field_volrend.cu``)
and the gathers' backward sums each bin's run of a sorted row
(``csrc/gather_rows.cu``); here the wrappers take their plain versions.
Tolerances, each with its reason:
  * the launch plans (lane span, passes, rays a block, shared memory):
    exact;
  * the weights kernels' span-by-span arithmetic, emulated in float32
    numpy lane by lane, against the float64 plain version: max-abs 1e-6 on
    the weights, 1e-6 of each gradient's max-abs (``test_torch_weights.py``'s
    ``EMU_TOL``; float32 sums in another order over up to 8192 samples);
  * the gathers' backward, its numpy emulation
    (``test_torch_determinism.kernel_emulation``) against ``scatter_add_``:
    bit for bit;
  * ``fused_render_weights`` against JAX's Pallas kernel in interpret mode,
    forward and VJP: ``test_torch_weights.py``'s ``W_TOL`` and ``GRAD_TOL``;
  * ``prop_loss`` and its gradient against ``jax.grad``: rtol 1e-5, and
    atol 1e-6 of the gradient's max-abs, as in ``test_torch_determinism.py``;
  * one flagship member step against JAX's: ``test_torch_train.py``'s
    tolerances (loss and aux rtol 1e-5 in float32, parameters 2e-3 of
    max-abs plus 1e-2 learning rates).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_determinism import kernel_emulation

from apnerf_tpu.config import PipelineConfig
from apnerf_tpu.data import dataset as j_ds
from apnerf_tpu.models import propnet as j_prop
from apnerf_tpu.ops import occupancy as j_occ
from apnerf_tpu.ops import volrend as j_vr
from apnerf_tpu.ops.pallas import fused_render_weights as j_fused_render_weights
from apnerf_tpu.train import flagship as j_fl
from apnerf_tpu_torch.data import dataset as t_ds
from apnerf_tpu_torch.models import propnet as t_prop
from apnerf_tpu_torch.ops.cuda import field_images
from apnerf_tpu_torch.ops.cuda import fused_field_volrend as t_fvr
from apnerf_tpu_torch.ops.cuda import gather_rows as t_gr
from apnerf_tpu_torch.ops.cuda.launch import MAX_SMEM
from apnerf_tpu_torch.ops.cuda.volrend_cuda import (
    LANE_SPANS,
    SPAN_SAMPLES,
    fused_render_weights,
    fused_render_weights_plain,
    lane_span,
    span_count,
)
from apnerf_tpu_torch.train import flagship as t_fl

W_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
EMU_TOL = 1e-6
LONG = (1, 128, 1024, 1025, 2048, 4096, 8192)


def T(a):
    return torch.as_tensor(np.array(a))


# -- the launch plans --------------------------------------------------------------------


def test_weights_plan_for_every_length():
    """K2's instance and its passes for every S in 1..8192: one pass of the
    smallest instance that covers the row up to 1024, the widest past it."""
    for S in range(1, 8193):
        v, n = lane_span(S), span_count(S)
        assert v in LANE_SPANS and n == -(-S // SPAN_SAMPLES), S
        if S <= SPAN_SAMPLES:
            assert n == 1 and 32 * v >= S, S
        else:
            assert v == LANE_SPANS[-1] and (n - 1) * SPAN_SAMPLES < S <= n * SPAN_SAMPLES, S
    with pytest.raises(ValueError):
        span_count(0)


@pytest.mark.parametrize("c_pad", [c for _, c in field_images.TIERS] + [32])
@pytest.mark.parametrize("S", LONG + (30000, 65536))
def test_ray_kernels_fit_their_shared_memory(S, c_pad):
    """The ray kernels' blocks at every tier's classes (and the shipping
    29, padded to 32): within ``MAX_SMEM`` with their rays' rows in shared
    memory, or staged in device memory where one warp's do not fit."""
    rays, smem, staged = t_fvr.ray_plan(S, c_pad)
    chan = 4 * 2 * t_fvr.ray_chan(c_pad)
    assert 1 <= rays <= t_fvr.RAY_WARPS and smem <= MAX_SMEM
    if staged:
        assert 4 * 2 * S + chan > MAX_SMEM and smem == rays * chan
    else:
        assert smem == rays * (4 * 2 * S + chan)
        assert rays == t_fvr.RAY_WARPS or (rays + 1) * (4 * 2 * S + chan) > MAX_SMEM
    rays, smem, staged = t_fvr.fwd_ray_plan(S)
    assert 1 <= rays <= t_fvr.RAY_WARPS and smem <= MAX_SMEM
    assert (staged, smem) == ((True, 0) if 4 * S > MAX_SMEM else (False, rays * 4 * S))
    # up to the last tier at 8192 samples the rays' rows stay in shared memory
    assert t_fvr.ray_plan(S, c_pad)[2] == (S > 8192)


@pytest.mark.parametrize("S", [64, 128, 256, 512])
def test_shipping_shapes_keep_their_instances(S):
    """The paths' shapes launch as before: 8 rays a block with the parent's
    shared memory, and the weights kernels' one-pass instances."""
    c_pad = 32  # 29 classes padded to 16
    assert t_fvr.ray_plan(S, c_pad) == (8, 8 * (2 * S + 2 * 128) * 4, False)
    assert t_fvr.fwd_ray_plan(S) == (8, 8 * S * 4, False)
    assert (lane_span(S), span_count(S)) == ({64: 2, 128: 4, 256: 8, 512: 16}[S], 1)


# -- the weights kernels' spans, lane by lane -----------------------------------------------


def _lanes_before(v):
    for off in (1, 2, 4, 8, 16):
        u = np.zeros_like(v)
        u[:, off:] = v[:, :-off]
        v = v + u
    out = np.zeros_like(v)
    out[:, 1:] = v[:, :-1]
    return out


def _lanes_after(v):
    for off in (1, 2, 4, 8, 16):
        u = np.zeros_like(v)
        u[:, :-off] = v[:, off:]
        v = v + u
    out = np.zeros_like(v)
    out[:, :-1] = v[:, 1:]
    return out


def _spans(a, n):
    """[R, S] → n spans of [R, 32, 32] (lane l's 32 samples), zeros past S."""
    R, S = a.shape
    return np.pad(a, ((0, 0), (0, n * SPAN_SAMPLES - S))).reshape(R, n, 32, 32)


def _emulate_spans(t0, t1, sig, g=None):
    """The ``_spans`` kernels of ``csrc/volrend.cu`` in float32 → w, or
    (dsigma, dt0, dt1): each span as the one-pass kernel at V = 32 but for
    alpha, formed as -expm1(-s), with the optical depth before the span
    carried first to last and the suffix of g w after it last to first,
    each span's total (its lanes' scan at the end lane) added to the carry
    once."""
    R, S = sig.shape
    n = span_count(S)
    a, dt, sg = _spans(t0, n), _spans(t1, n), _spans(sig, n)
    dt = dt - a
    s = sg * dt
    carry = np.zeros((R, 1), np.float32)
    w, gte = np.empty_like(s), np.empty_like(s)
    for p in range(n):
        total = np.zeros((R, 32), np.float32)
        for j in range(32):
            total = total + s[:, p, :, j]
        before = _lanes_before(total)
        excl = carry + before
        for j in range(32):
            tr, e = np.exp(-excl), np.exp(-s[:, p, :, j])
            excl = excl + s[:, p, :, j]
            w[:, p, :, j] = tr * -np.expm1(-s[:, p, :, j])
            gte[:, p, :, j] = tr * e
        carry = carry + (before + total)[:, 31:]
    cut = lambda x: x.reshape(R, -1)[:, :S]  # noqa: E731
    if g is None:
        return cut(w)
    gw, gte = _spans(g, n) * w, _spans(g, n) * gte
    dsig, ddt = np.empty_like(s), np.empty_like(s)
    gcarry = np.zeros((R, 1), np.float32)
    for p in reversed(range(n)):
        gw_total = np.zeros((R, 32), np.float32)
        for j in reversed(range(32)):
            gw_total = gw_total + gw[:, p, :, j]
        after = _lanes_after(gw_total)
        suffix = gcarry + after
        for j in reversed(range(32)):
            bracket = gte[:, p, :, j] - suffix
            suffix = suffix + gw[:, p, :, j]
            dsig[:, p, :, j] = dt[:, p, :, j] * bracket
            ddt[:, p, :, j] = sg[:, p, :, j] * bracket
        gcarry = gcarry + (after + gw_total)[:, :1]
    return cut(dsig), cut(-ddt), cut(ddt)


@pytest.mark.parametrize("S", [1025, 1100, 2048, 8192])
def test_span_arithmetic_matches_the_plain_version(S):
    rng = np.random.default_rng(200 + S)
    R = 4
    edges = np.sort(rng.uniform(0.1, 20.1, (R, S + 1)).astype(np.float32), axis=-1)
    t0, t1 = edges[:, :-1].copy(), edges[:, 1:].copy()
    sig = rng.uniform(0, 2, (R, S)).astype(np.float32)
    g = rng.normal(size=sig.shape).astype(np.float32)
    leaves = [T(a).double().requires_grad_(True) for a in (sig, t0, t1)]
    w = fused_render_weights_plain(leaves[1], leaves[2], leaves[0])
    np.testing.assert_allclose(_emulate_spans(t0, t1, sig), w.detach().numpy(), rtol=0,
                               atol=EMU_TOL)
    ref = torch.autograd.grad(w, leaves, T(g).double())
    for got, want in zip(_emulate_spans(t0, t1, sig, g), ref):
        want = want.numpy()
        assert np.abs(got - want).max() <= EMU_TOL * np.abs(want).max()


# -- the gathers' backward, bin by bin ------------------------------------------------------


def _sorted_rows(rng, R, Q, K):
    """Searchsorted of sorted queries into sorted edges, as ``_outer`` and
    the inverse CDF give them: runs of one bin, empty bins."""
    edges = np.sort(rng.uniform(0, 1, (R, K)), axis=-1)
    qs = np.sort(rng.uniform(0, 1, (R, Q)) ** 3, axis=-1)
    return np.stack([np.searchsorted(e, x, side="right") - 1 for e, x in zip(edges, qs)]
                    ).clip(0, K - 1)


@pytest.mark.parametrize("case,R,Q,K", [
    ("sorted", 6, 40, 9), ("sorted", 4, 300, 257), ("sorted", 2, 1100, 1101),
    ("one bin takes every term", 3, 64, 5), ("empty bins", 3, 16, 200), ("runs of one", 3, 32, 40),
    ("one bin", 2, 8, 1), ("out of range", 3, 24, 9), ("unsorted rows", 4, 40, 9),
    ("sorted", 1, 4096, 8193),
])
def test_run_sums_are_scatter_add(case, R, Q, K):
    rng = np.random.default_rng([sum(map(ord, case)), R, Q, K])
    idx = [_sorted_rows(rng, R, Q, K) for _ in range(2)]
    if case == "one bin takes every term":
        idx = [np.full((R, Q), 2, np.int64) for _ in idx]
    elif case == "runs of one":
        idx = [np.stack([np.sort(rng.choice(K, Q, replace=False)) for _ in range(R)])
               for _ in idx]
    elif case == "out of range":  # sorted, past both ends
        idx = [np.sort(rng.integers(-4, K + 4, (R, Q)), axis=-1) for _ in idx]
    elif case == "unsorted rows":  # every other row shuffled in one of its lists
        for r in range(0, R, 2):
            rng.shuffle(idx[r % 2][r])
    gs = [(rng.normal(size=(R, Q)) * 10.0 ** rng.uniform(-3, 3, (R, Q))).astype(np.float32)
          for _ in idx]
    pairs = list(zip(gs, [i.astype(np.int64) for i in idx]))
    plain = torch.zeros(R, K)
    for g, i in pairs:
        plain.scatter_add_(-1, T(i).clamp(0, K - 1), T(g) * T((i >= 0) & (i < K)))
    got = kernel_emulation(K, pairs)
    if case != "out of range":
        assert torch.equal(t_gr.gather_rows_bwd(K, [(T(g), T(i)) for g, i in pairs]), plain)
    assert np.array_equal(got, plain.numpy())


# -- past 1024 samples against the JAX package --------------------------------------------


@pytest.mark.parametrize("R,S", [(8, 1100), (4, 2048)])
def test_weights_past_1024_match_jax(R, S):
    rng = np.random.default_rng(S)
    edges = np.sort(rng.uniform(0.1, 5.0, (R, S + 1)).astype(np.float32), axis=-1)
    t0, t1 = edges[:, :-1].copy(), edges[:, 1:].copy()
    sig = rng.uniform(0, 20, (R, S)).astype(np.float32)
    sig[:, -S // 8:] = 0.0  # a padded tail, as the march leaves it
    g = rng.normal(size=sig.shape).astype(np.float32)
    leaves = [T(a).requires_grad_(True) for a in (t0, t1, sig)]
    w = fused_render_weights(*leaves)
    got = torch.autograd.grad(w, leaves, T(g))
    ref, vjp = jax.vjp(j_fused_render_weights, t0, t1, sig)
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(ref), **W_TOL)
    for a, b in zip(got, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)


def test_prop_loss_past_1024_matches_jax():
    """``prop_loss`` of a level of 1100 proposal samples (its gathers into
    1101 bins) and 1100 final samples, against ``jax.grad``."""
    rng = np.random.default_rng(1100)
    R = 4
    o = rng.uniform(-0.5, 0.5, (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    near = rng.uniform(0.1, 0.3, R).astype(np.float32)

    def sig(t0, t1):
        tm = 0.5 * (t0 + t1)
        return 5.0 * jnp.exp(-((tm - 1.0) ** 2) * 4.0)

    t0, t1, lv = j_prop.propnet_sampling(
        jax.random.PRNGKey(6), [sig], [1100], 1100, o, d, near, near + 2.0,
        sampling_type="uniform", stratified=True, use_onehot=False,
    )
    wf = np.asarray(j_vr.render_weight_from_density(t0, t1, sig(t0, t1))[0])
    edges, w0 = (np.asarray(x) for x in lv[0])
    w0 = w0 * rng.uniform(0.2, 1.0, w0.shape).astype(np.float32)  # the loss live in places
    # multiples of 2^-20 below 1, so that both packages' cumsums over the 1100
    # weights are exact in any order (a last-digit difference of the envelope
    # is amplified by the loss's division by the final weight)
    w0 = (np.round(w0 * 2.0**20) / 2.0**20).astype(np.float32)
    t0, t1 = np.asarray(t0), np.asarray(t1)
    assert edges.shape == (R, 1101) and t0.shape == (R, 1100)

    grad_j = np.asarray(jax.grad(lambda w: j_prop.prop_loss([(edges, w)], t0, t1, wf))(
        jnp.asarray(w0)))
    w_t = T(w0).requires_grad_(True)
    loss_t = t_prop.prop_loss([(T(edges), w_t)], T(t0), T(t1), T(wf))
    (grad_t,) = torch.autograd.grad(loss_t, [w_t])
    np.testing.assert_allclose(float(loss_t.detach()),
                               float(j_prop.prop_loss([(edges, w0)], t0, t1, wf)), rtol=1e-5)
    assert np.abs(grad_j).max() > 0
    np.testing.assert_allclose(grad_t.numpy(), grad_j, rtol=1e-5,
                               atol=1e-6 * np.abs(grad_j).max())


def _jax_state(cfg, member):
    tree = {}
    for name, v in member.state_dict().items():
        *path, leaf = name.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(v.numpy())
    opt = j_fl.make_optimizer(cfg, j_fl.default_spectral_schedule(cfg))
    return tree, opt.init(tree), j_occ.init_occ_grid(cfg.aabb, cfg.main_grid_resolution)


def test_member_step_past_1024_matches_jax(monkeypatch):
    """One flagship member step at a 2 x 32 trunk, 3 classes and 8 rays of
    1100 final and 1100 proposal samples, in float32, on the default route
    and on autograd (``field``), against JAX's autodiff branch."""
    monkeypatch.setenv("APNERF_FUSED_LOSSGRAD", "0")
    for mod in (j_fl, t_fl):
        for fn in ("make_spectral_config", "make_prop_config"):
            orig = getattr(mod, fn)
            monkeypatch.setattr(mod, fn,
                                lambda c, orig=orig: orig(c)._replace(compute_dtype="float32"))
    R, S = 8, 1100
    cfg = PipelineConfig(
        aabb=(-1.0, -1.0, -1.0, 1.0, 1.0, 1.0), img_w=32, img_h=24, num_rays=R,
        max_samples_train=S, num_prop_samples=1100, num_semantic_classes=3, n_ensembles=1,
        max_images=4, n_levels=4, spectral_freqs_per_level=2, base_resolution=4,
        max_resolution=32, spectral_neurons=32, spectral_layers=2, geo_feat_dim=7,
        prop_neurons=16,
    )
    state_t = t_fl.init_flagship_ensemble(cfg, torch.Generator().manual_seed(0))
    params, opt_state, occ = _jax_state(cfg, state_t.members[0])
    rng = np.random.default_rng(5)
    o = rng.uniform(-2, 2, (R, 3)).astype(np.float32)
    vd = rng.normal(size=(R, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    arrays = (o, vd, rng.uniform(size=(R, 3)).astype(np.float32),
              rng.uniform(0.1, 3.0, R).astype(np.float32),
              rng.integers(0, 3, R).astype(np.int32), np.ones(3, np.float32))
    k_occ = jax.random.PRNGKey(6)
    out_j = jax.jit(j_fl.make_flagship_member_core(cfg))(
        params, opt_state, occ, j_ds.RayBatch(*map(jnp.asarray, arrays)), k_occ,
        jnp.asarray(0), jnp.asarray(1e-3))
    _, k_samp = jax.random.split(k_occ)
    noise = T(jax.random.uniform(jax.random.split(k_samp)[1], (R, S + 1)))
    lr = float(t_fl.default_spectral_schedule(cfg)(1))
    flat = {".".join(k.key for k in path): np.asarray(v, np.float32)
            for path, v in jax.tree_util.tree_flatten_with_path(out_j[0])[0]}
    for route in ("lossgrad", "field"):
        member = copy.deepcopy(state_t.members[0])
        out_t = t_fl.make_flagship_member_core(cfg, route=route)(
            member, copy.deepcopy(state_t.opt[0]), t_ds.RayBatch(*map(T, arrays)), 0,
            noise=noise)
        for a, b in zip(out_t[1:6], out_j[3:8]):
            np.testing.assert_allclose(np.asarray(a.detach() if torch.is_tensor(a) else a),
                                       np.asarray(b), rtol=1e-5)
        assert not bool(out_t.skipped) and not bool(out_j[8])
        for name, p in member.named_parameters():
            err = np.abs(p.detach().numpy() - flat[name]).max()
            assert err <= 2e-3 * max(np.abs(flat[name]).max(), 1e-6) + 1e-2 * lr, (route, name)
