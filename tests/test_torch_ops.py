"""Parity of the port's ops (``apnerf_tpu_torch/ops``, ``active/uncertainty``,
``models/nn``, ``models/propnet``) with the JAX package's, on the CPU.

Inputs come from a seeded numpy generator and go to both implementations;
random draws are made with JAX and handed to the port. Tolerances:
  * elementwise float32 math: rtol 1e-5 / atol 1e-6 (same formula, the
    frameworks may fuse or order a 3-term sum differently);
  * scans and reductions over <= 257 terms: rtol 1e-5 / atol 1e-5;
  * bf16 MLP outputs: 2e-2 of the tensor's max-abs (a one-ulp difference
    in a bf16 hidden activation propagates);
  * the CUDA weights kernel's plain version against the Pallas kernel in
    interpret mode: the Pallas test's own rtol 1e-5 / atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apnerf_tpu.active import uncertainty as j_unc
from apnerf_tpu.models import nn as j_nn
from apnerf_tpu.models import propnet as j_prop
from apnerf_tpu.ops import grid_march as j_gm
from apnerf_tpu.ops import occupancy as j_occ
from apnerf_tpu.ops import pdf as j_pdf
from apnerf_tpu.ops import rays as j_rays
from apnerf_tpu.ops import sh as j_sh
from apnerf_tpu.ops import volrend as j_vr
from apnerf_tpu.ops.pallas import fused_render_weights as j_fused_render_weights
from apnerf_tpu_torch.active import uncertainty as t_unc
from apnerf_tpu_torch.models import nn as t_nn
from apnerf_tpu_torch.models import propnet as t_prop
from apnerf_tpu_torch.ops import grid_march as t_gm
from apnerf_tpu_torch.ops import occupancy as t_occ
from apnerf_tpu_torch.ops import pdf as t_pdf
from apnerf_tpu_torch.ops import rays as t_rays
from apnerf_tpu_torch.ops import sh as t_sh
from apnerf_tpu_torch.ops import volrend as t_vr
from apnerf_tpu_torch.ops.cuda.volrend_cuda import fused_render_weights

EW = dict(rtol=1e-5, atol=1e-6)
SCAN = dict(rtol=1e-5, atol=1e-5)


def T(a):
    return torch.as_tensor(np.array(a))


def close(port, ref, **tol):
    np.testing.assert_allclose(
        np.asarray(port.detach() if torch.is_tensor(port) else port),
        np.asarray(ref), **(tol or EW),
    )


def _intervals(rng, R=16, S=48, zero_tail=5):
    edges = np.sort(rng.uniform(0.1, 5.0, (R, S + 1)).astype(np.float32), axis=-1)
    sig = rng.uniform(0, 20, (R, S)).astype(np.float32)
    sig[:, -zero_tail:] = 0.0
    return edges[:, :-1].copy(), edges[:, 1:].copy(), sig


# -- rays, sh, aabb -----------------------------------------------------------


def _poses(rng, n):
    out = []
    for _ in range(n):
        q = rng.normal(size=4)
        out.append(j_rays.pose_matrix_from_quat(rng.uniform(-2, 2, 3), q / np.linalg.norm(q)))
    return np.stack(out).astype(np.float32)


def test_host_helpers_identical():
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(
        t_rays.make_intrinsics(64, 48, 1.2), j_rays.make_intrinsics(64, 48, 1.2)
    )
    pos, q = rng.normal(size=3), rng.normal(size=4)
    np.testing.assert_array_equal(
        t_rays.pose_matrix_from_quat(pos, q), j_rays.pose_matrix_from_quat(pos, q)
    )


def test_pixel_dirs_and_rays_from_pixels():
    rng = np.random.default_rng(1)
    K = j_rays.make_intrinsics(40, 30)
    x = rng.uniform(0, 40, 50).astype(np.float32)
    y = rng.uniform(0, 30, 50).astype(np.float32)
    close(t_rays.pixel_dirs(T(x), T(y), T(K)), j_rays.pixel_dirs(x, y, K))
    c2w = _poses(rng, 50)
    rj = j_rays.rays_from_pixels(x, y, c2w, K)
    rt = t_rays.rays_from_pixels(T(x), T(y), T(c2w), T(K))
    close(rt.origins, rj.origins)
    close(rt.viewdirs, rj.viewdirs)


@pytest.mark.parametrize("scale", [None, 0.3])
def test_image_rays(scale):
    rng = np.random.default_rng(2)
    K = j_rays.make_intrinsics(20, 16)
    c2w = _poses(rng, 1)[0]
    if scale is None:
        rj = j_rays.image_rays(c2w, K, 20, 16)
        rt = t_rays.image_rays(T(c2w), T(K), 20, 16)
    else:
        rj = j_rays.subsampled_image_rays(c2w, K, 20, 16, scale)
        rt = t_rays.subsampled_image_rays(T(c2w), T(K), 20, 16, scale)
    close(rt.origins, rj.origins)
    close(rt.viewdirs, rj.viewdirs)


def test_sh_encode_deg4():
    d = np.random.default_rng(3).normal(size=(64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    close(t_sh.sh_encode_deg4(T(d)), j_sh.sh_encode_deg4(d))


def test_ray_aabb_intersect():
    rng = np.random.default_rng(4)
    o = rng.uniform(-3, 3, (200, 3)).astype(np.float32)
    d = rng.normal(size=(200, 3)).astype(np.float32)
    d[:10, 0] = 0.0  # axis-parallel rays
    aabb = np.array([-1, -1, -1, 1, 2, 1], np.float32)
    tj = j_gm.ray_aabb_intersect(o, d, aabb, near_plane=0.1)
    tt = t_gm.ray_aabb_intersect(T(o), T(d), T(aabb), near_plane=0.1)
    for a, b in zip(tt, tj):
        close(a, b)
    assert (np.asarray(tj[0]) == 1e10).any()  # some rays miss


# -- volume rendering -----------------------------------------------------------


def test_exclusive_sum():
    x = np.random.default_rng(5).uniform(size=(8, 33)).astype(np.float32)
    close(t_vr.exclusive_sum(T(x)), j_vr.exclusive_sum(x), **SCAN)


def test_render_transmittance_from_density():
    t0, t1, sig = _intervals(np.random.default_rng(6))
    for a, b in zip(
        t_vr.render_transmittance_from_density(T(t0), T(t1), T(sig)),
        j_vr.render_transmittance_from_density(t0, t1, sig),
    ):
        close(a, b, **SCAN)


@pytest.mark.parametrize("S", [48, 257])
def test_render_weight_from_density(S):
    t0, t1, sig = _intervals(np.random.default_rng(7), S=S)
    got = t_vr.render_weight_from_density(T(t0), T(t1), T(sig))
    ref = j_vr.render_weight_from_density(t0, t1, sig)
    for a, b in zip(got, ref):
        close(a, b, **SCAN)


def test_accumulate_render_outputs_and_variance():
    rng = np.random.default_rng(8)
    t0, t1, sig = _intervals(rng, R=12, S=20)
    w = np.asarray(j_vr.render_weight_from_density(t0, t1, sig)[0])
    rgb = rng.uniform(size=(12, 20, 3)).astype(np.float32)
    sem = rng.normal(size=(12, 20, 5)).astype(np.float32)
    bk = np.array([0.2, 0.5, 1.0], np.float32)
    close(t_vr.accumulate_along_rays(T(w)), j_vr.accumulate_along_rays(w), **SCAN)
    close(t_vr.accumulate_along_rays(T(w), T(rgb)), j_vr.accumulate_along_rays(w, rgb), **SCAN)
    ot = t_vr.render_outputs(T(w), T(t0), T(t1), T(rgb), sems=T(sem), render_bkgd=T(bk))
    oj = j_vr.render_outputs(w, t0, t1, rgb, sems=sem, render_bkgd=bk)
    assert set(ot) == set(oj)
    for k in oj:
        close(ot[k], oj[k], **SCAN)
    mean = np.asarray(j_vr.accumulate_along_rays(w, rgb))
    close(t_vr.render_variance(T(w), T(rgb), T(mean)), j_vr.render_variance(w, rgb, mean), **SCAN)


def test_weights_kernel_plain_matches_pallas_interpret():
    """The CUDA weights kernel's plain version against the Pallas kernel,
    run in interpret mode as ``tests/test_pallas_volrend.py`` runs it."""
    t0, t1, sig = _intervals(np.random.default_rng(9), R=24, S=64, zero_tail=7)
    ref = j_fused_render_weights(t0, t1, sig)
    fused_render_weights.launches = 0
    w, trans, alpha = fused_render_weights(T(t0), T(t1), T(sig))
    close(w, ref)
    # a CPU tensor takes the plain version and launches nothing
    assert fused_render_weights.launches == 0
    rj = j_vr.render_weight_from_density(t0, t1, sig)
    close(trans, rj[1], **SCAN)
    close(alpha, rj[2], **SCAN)


def test_weights_wrapper_rejects_unsupported_device():
    x = torch.zeros((2, 4), device="meta")
    with pytest.raises(ValueError):
        fused_render_weights(x, x, x)


# -- inverse CDF ------------------------------------------------------------------


def _weighted_bins(rng, R=10, B=24):
    bins = np.sort(rng.uniform(0, 1, (R, B + 1)).astype(np.float32), axis=-1)
    bins[:, 0], bins[:, -1] = 0.0, 1.0
    w = rng.uniform(0, 1, (R, B)).astype(np.float32)
    w[0] = 0.0  # an empty ray
    w[1, :5] = 0.0  # leading empty bins
    w[2, 3:9] = 0.0  # interior empty bins
    return bins, w


def test_searchsorted():
    rng = np.random.default_rng(10)
    keys = np.sort(rng.uniform(size=(6, 17)).astype(np.float32), axis=-1)
    q = rng.uniform(-0.1, 1.1, (6, 30)).astype(np.float32)
    q[:, :3] = keys[:, 4:7]  # exact hits
    for a, b in zip(t_pdf.searchsorted(T(keys), T(q)), j_pdf.searchsorted(keys, q)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("stratified", [False, True])
def test_sample_from_weighted(stratified):
    bins, w = _weighted_bins(np.random.default_rng(11))
    key = jax.random.PRNGKey(3)
    n = 33
    sj, cj = j_pdf.sample_from_weighted(bins, w, n, key=key, stratified=stratified)
    noise = np.asarray(jax.random.uniform(key, (w.shape[0], n)))
    st, ct = t_pdf.sample_from_weighted(T(bins), T(w), n, stratified=stratified, noise=T(noise))
    close(ct, cj, **SCAN)
    close(st, sj, **SCAN)


@pytest.mark.parametrize("stratified", [False, True])
def test_importance_sampling_matches_both_jax_paths(stratified):
    """The port's searchsorted path equals both JAX paths, including the
    one-hot TPU path the proposal renderer runs."""
    bins, w = _weighted_bins(np.random.default_rng(12))
    key = jax.random.PRNGKey(4)
    n = 20
    noise = T(np.asarray(jax.random.uniform(key, (w.shape[0], n + 1))))
    et, mt = t_pdf.importance_sampling(T(bins), T(w), n, stratified=stratified, noise=noise)
    for fn in (j_pdf.importance_sampling, j_pdf.importance_sampling_onehot):
        ej, mj = fn(bins, w, n, key=key, stratified=stratified)
        close(et, ej, **SCAN)
        close(mt, mj, **SCAN)


# -- occupancy ----------------------------------------------------------------------


def _occ_eval(x, lib):
    return (lib.sin(3.0 * x[:, 0]) * lib.cos(2.0 * x[:, 2]) + 0.2 * x[:, 1]) ** 2 * 0.02


@pytest.mark.parametrize("warm", [True, False])
def test_update_occ_grid(warm):
    aabb = (-1.0, 0.0, -1.0, 1.0, 0.5, 1.0)
    res = (10, 3, 8)
    n = int(np.prod(res))
    rng = np.random.default_rng(13)
    occs0 = rng.uniform(0, 0.02, n).astype(np.float32)
    occs0[:7] = -1.0  # invisible cells
    sj = j_occ.init_occ_grid(aabb, res)._replace(occs=jnp.asarray(occs0))
    sj = sj._replace(binaries=jnp.asarray(occs0 > 0.01).reshape(res))
    st = t_occ.init_occ_grid(aabb, res)
    st = st._replace(occs=T(occs0), binaries=T(occs0 > 0.01).reshape(res))
    np.testing.assert_array_equal(st.aabb.numpy(), np.asarray(sj.aabb))
    step = 0 if warm else 100
    key = jax.random.PRNGKey(5)
    k_jit, k_uni, k_occ = jax.random.split(key, 3)
    n_sub = n // 4
    draws = {
        "jitter": T(np.asarray(jax.random.uniform(k_jit, (n if warm else 2 * n_sub, 3)))),
        "uniform_idx": T(np.asarray(jax.random.randint(k_uni, (n_sub,), 0, n))).long(),
        "occ_u": T(np.asarray(jax.random.uniform(k_occ, (n_sub,)))),
    }
    oj = j_occ.update_occ_grid(
        sj, lambda x: _occ_eval(x, jnp), key, jnp.asarray(step), 3e-3, warmup_steps=8
    )
    ot = t_occ.update_occ_grid(
        st, lambda x: _occ_eval(x, torch), step, 3e-3, warmup_steps=8, draws=draws
    )
    close(ot.occs, oj.occs, **SCAN)
    np.testing.assert_array_equal(ot.binaries.numpy(), np.asarray(oj.binaries))


def test_cell_centers_world():
    aabb = (-1.0, 0.0, -1.0, 1.0, 0.5, 1.0)
    res = (5, 3, 4)
    idx = np.arange(60)
    jit = np.random.default_rng(14).uniform(size=(60, 3)).astype(np.float32)
    close(
        t_occ.cell_centers_world(t_occ.init_occ_grid(aabb, res), T(idx), T(jit)),
        j_occ.cell_centers_world(j_occ.init_occ_grid(aabb, res), idx, jit),
    )


def test_occ_update_draws_from_generator():
    st = t_occ.init_occ_grid((-1, -1, -1, 1, 1, 1), (4, 4, 4))
    g = torch.Generator().manual_seed(0)
    for step in (0, 300):
        out = t_occ.update_occ_grid(st, lambda x: x[:, 0] ** 2, step, generator=g)
        assert out.occs.shape == (64,) and out.binaries.shape == (4, 4, 4)
        assert torch.isfinite(out.occs).all()


# -- predictive information --------------------------------------------------------


def test_predictive_information():
    rng = np.random.default_rng(15)
    E, V, P, C = 2, 3, 11, 6
    args = (
        rng.uniform(0, 0.3, (E, V, P, 3)).astype(np.float32),
        rng.uniform(0, 2.0, (E, V, P)).astype(np.float32),
        rng.normal(size=(E, V, P, C)).astype(np.float32),
        rng.uniform(0, 1, (E, V, P)).astype(np.float32),
    )
    pj = j_unc.predictive_information(*args)
    pt = t_unc.predictive_information(*map(T, args))
    for a, b in zip(pt, pj):
        close(a, b, rtol=1e-5, atol=1e-6)
    close(pt.total, pj.total, rtol=1e-5, atol=1e-6)


# -- MLP ------------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mlp(dtype):
    params = j_nn.init_mlp(jax.random.PRNGKey(0), [24, 32, 32, 5])
    rng = np.random.default_rng(16)
    params = {k: v + rng.normal(0, 0.1, v.shape).astype(np.float32) for k, v in params.items()}
    x = rng.normal(size=(40, 24)).astype(np.float32)
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (None, None)
    yj = np.asarray(j_nn.apply_mlp(params, x, compute_dtype=jd))
    yt = t_nn.apply_mlp(t_nn.MLP.from_tree(params), T(x), compute_dtype=td)
    assert yt.dtype == torch.float32
    if dtype == "float32":
        close(yt, yj, rtol=1e-5, atol=1e-5)
    else:
        assert np.abs(yt.detach().numpy() - yj).max() <= 2e-2 * np.abs(yj).max()


def test_init_mlp_layout():
    m = t_nn.init_mlp([6, 16, 3], torch.Generator().manual_seed(0))
    assert [tuple(p.shape) for p in m.parameters()] == [(6, 16), (16,), (16, 3), (3,)]
    assert list(dict(m.named_parameters())) == ["w0", "b0", "w1", "b1"]
    assert float(m.w0.abs().max()) <= np.sqrt(6 / 6)


# -- proposal sampling ----------------------------------------------------------------


@pytest.mark.parametrize("per_ray", [False, True])
def test_transform_stot(per_ray):
    """The 'uniform' warp, with scalar or per-ray [R] bounds."""
    rng = np.random.default_rng(17)
    s = np.sort(rng.uniform(size=(5, 9)).astype(np.float32), axis=-1)
    lo = rng.uniform(0.1, 1, 5).astype(np.float32)
    hi = lo + rng.uniform(0.5, 3, 5).astype(np.float32)
    if not per_ray:
        lo, hi = np.float32(lo[0]), np.float32(hi[0])
    close(t_prop.transform_stot(T(s), T(lo), T(hi)), j_prop.transform_stot("uniform", s, lo, hi))


@pytest.mark.parametrize("stratified", [False, True])
def test_propnet_sampling_and_prop_loss(stratified):
    rng = np.random.default_rng(18)
    R = 12
    o = rng.uniform(-0.5, 0.5, (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    near = rng.uniform(0.1, 0.3, R).astype(np.float32)
    far = near + 2.0

    def sig(t0, t1, lib):
        tm = 0.5 * (t0 + t1)
        return 5.0 * lib.exp(-((tm - 1.0) ** 2) * 4.0)

    key = jax.random.PRNGKey(6)
    t0j, t1j, lvj = j_prop.propnet_sampling(
        key, [lambda a, b: sig(a, b, jnp)], [16], 24, o, d, near, far,
        sampling_type="uniform", stratified=stratified, use_onehot=True,
    )
    noise = np.asarray(jax.random.uniform(jax.random.split(key)[1], (R, 25)))
    t0t, t1t, lvt = t_prop.propnet_sampling(
        [lambda a, b: sig(a, b, torch)], [16], 24, T(o), T(d), T(near), T(far),
        stratified=stratified, noises=[T(noise)],
    )
    close(t0t, t0j, **SCAN)
    close(t1t, t1j, **SCAN)
    for (ej, wj), (et, wt) in zip(lvj, lvt):
        close(et, ej, **SCAN)
        close(wt, wj, **SCAN)
    wf = np.asarray(j_vr.render_weight_from_density(t0j, t1j, sig(t0j, t1j, jnp))[0])
    lj = j_prop.prop_loss(lvj, t0j, t1j, wf, use_onehot=True)
    lt = t_prop.prop_loss(lvt, t0t, t1t, T(wf))
    close(lt, lj, rtol=1e-4, atol=1e-6)
