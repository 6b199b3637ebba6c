"""Parity of the port's (ngp, occ) oracle path with the JAX package's, on
the CPU at tiny sizes: the hash grid (4 levels of 2^10 entries, two of
them dense and two hashed), the occupancy march (a 16³ grid), the NGP
field (a 2×32 base MLP), its renderer, the member step, the occupancy
cadence, the invisible-cell marking, checkpoints both ways and a loop
through ``ActiveNeRFMapper``.

Inputs come from a seeded numpy generator and random draws from
``jax.random``, handed to the port. Tolerances, each with its reason:
  * integer results (hash and stride indices, the lattice, the
    compaction's indices and masks, the march's intervals and masks, the
    occupancy lookup, the binary grids, the invisible-cell marking):
    exactly equal;
  * the hash encoding: rtol 1e-5 / atol 1e-6 on a unit-scale table (the
    same products, the 8 corners summed in another order); its table
    gradient the same (JAX scatters per feature, PyTorch's ``index_add_``
    adds rows, in other orders), its position gradient rtol 1e-4 / atol
    1e-5 (sums over levels of products scaled by the resolution);
  * the field and the renders in float32: rtol 1e-4 / atol 1e-5 (a
    matmul chain and an exp; the renders' sums over samples);
  * the member step: loss terms rtol 1e-4; Adam's moments 1e-2 of each
    tensor's max-abs: a hidden unit whose pre-activation lies within
    rounding of 0 flips its ReLU when a matmul sums in another order
    (PyTorch's CPU thread count changes the order), which moves its
    layer's gradient by one sample's share (the first layer's bias moment
    read 2.2e-3 of its max-abs on one thread, 2.5e-7 on eight; every other
    leaf under 5e-7); the update of each parameter element against JAX's
    to 1e-3 of the learning rate plus 2 f32 ulp of the element, wherever
    JAX's first moment is over 2e-2 of its tensor's max-abs (Adam's first
    step moves an element by the learning rate times its gradient's sign,
    and the moments agree to 1e-2, so the sign is settled there), exactly
    0 where JAX's gradient is exactly 0 (table rows no sample reached),
    and at most one learning rate elsewhere; the occupancy grid's EMA
    rtol 1e-5 and its binaries exact.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apnerf_tpu.config import PipelineConfig as JaxConfig
from apnerf_tpu.data import dataset as j_ds
from apnerf_tpu.models import ngp as j_ngp
from apnerf_tpu.ops import grid_march as j_gm
from apnerf_tpu.ops import hashgrid as j_hg
from apnerf_tpu.ops import occupancy as j_occ
from apnerf_tpu.render import renderer as j_rr
from apnerf_tpu.train import step as j_step
from apnerf_tpu_torch import interop
from apnerf_tpu_torch.config import PipelineConfig
from apnerf_tpu_torch.data import dataset as t_ds
from apnerf_tpu_torch.models import ngp as t_ngp
from apnerf_tpu_torch.ops import grid_march as t_gm
from apnerf_tpu_torch.ops import hashgrid as t_hg
from apnerf_tpu_torch.ops import occupancy as t_occ
from apnerf_tpu_torch.render import renderer as t_rr
from apnerf_tpu_torch.train import phase as t_phase
from apnerf_tpu_torch.train import step as t_step

GRID = dict(n_levels=4, n_features=4, log2_table_size=10, base_resolution=4, max_resolution=32)
FIELD = dict(aabb=(-1.0, -1.0, -1.0, 1.0, 1.0, 1.0), neurons=32, layers=2, geo_feat_dim=7,
             n_levels=4, n_features=4, log2_hashmap_size=10, base_resolution=4,
             max_resolution=32, num_semantic_classes=5)
FIELD_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """This file's tests run PyTorch on one CPU thread, restored after: the
    suite runs several test processes at once, and many small ops on a
    pool of threads per process oversubscribe the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(a):
    return torch.as_tensor(np.array(a))


def close(port, ref, **tol):
    port = port.detach().numpy() if torch.is_tensor(port) else np.asarray(port)
    np.testing.assert_allclose(port, np.asarray(ref), **tol)


def same(port, ref):
    port = port.detach().numpy() if torch.is_tensor(port) else np.asarray(port)
    np.testing.assert_array_equal(port, np.asarray(ref))


def on_scale(port, ref, rel, atol=0.0, name=""):
    port = port.detach().numpy() if torch.is_tensor(port) else np.asarray(port)
    ref = np.asarray(ref, np.float32).reshape(port.shape)
    err = np.abs(port - ref).max()
    assert err <= rel * max(np.abs(ref).max(), 1e-12) + atol, (name, err)


# -- the hash grid -------------------------------------------------------------------------


def test_grid_has_dense_and_hashed_levels():
    cfg = t_hg.HashGridConfig(**GRID)
    dense = [(int(r) + 1) ** 3 <= cfg.table_size for r in cfg.resolutions]
    assert dense == [True, True, False, False]
    same(cfg.resolutions, j_hg.HashGridConfig(**GRID).resolutions)


@pytest.mark.parametrize("res", [4, 8, 32, 4096])
def test_level_indices_exact(res):
    rng = np.random.default_rng(1)
    coords = rng.integers(0, res + 2, (200, 3)).astype(np.int32)
    # a coordinate whose products with the primes wrap in uint32
    coords[0] = (4097, 4096, 3001) if res == 4096 else (res + 1, res, 0)
    T_ = 1 << 10
    same(t_hg._level_indices(T(coords), res, T_), j_hg._level_indices(jnp.asarray(coords), res, T_))
    if res == 4096:
        assert 4097 * 2654435761 > 2**32


@pytest.mark.parametrize("n_features", [4, 2, 3])
def test_hash_encode_and_gradients(n_features):
    """Rows of 4 and 2 features are gathered as one wide element each, 3 as
    floats."""
    grid = {**GRID, "n_features": n_features}
    cfg = t_hg.HashGridConfig(**grid)
    rng = np.random.default_rng(2)
    table = rng.normal(size=(4, 1 << 10, n_features)).astype(np.float32)
    x = rng.uniform(0, 1, (300, 3)).astype(np.float32)
    x[:3] = [[0.0, 0.5, 1.0], [1.0, 1.0, 1.0], [0.25, 0.125, 0.0]]  # corners and lattice points
    g = rng.normal(size=(300, 4 * n_features)).astype(np.float32)
    jcfg = j_hg.HashGridConfig(**grid)
    yj, vjp = jax.vjp(lambda t, p: j_hg.hash_encode(t, p, jcfg), jnp.asarray(table), jnp.asarray(x))
    dt_j, dx_j = vjp(jnp.asarray(g))
    tt, xt = T(table).requires_grad_(True), T(x).requires_grad_(True)
    yt = t_hg.hash_encode(tt, xt, cfg)
    dt_t, dx_t = torch.autograd.grad(yt, [tt, xt], T(g))
    close(yt, yj, rtol=1e-5, atol=1e-6)
    close(dt_t, dt_j, rtol=1e-5, atol=1e-6)
    close(dx_t, dx_j, rtol=1e-4, atol=1e-5)
    close(yt, j_hg.hash_encode_ref(jnp.asarray(table), jnp.asarray(x), jcfg), rtol=1e-5, atol=1e-6)


def test_init_hash_table_range():
    cfg = t_hg.HashGridConfig(**GRID)
    t = t_hg.init_hash_table(cfg, torch.Generator().manual_seed(0))
    assert t.shape == (4, 1024, 4) and t.dtype == torch.float32
    assert float(t.abs().max()) <= 1e-4 and float(t.std()) > 4e-5


# -- the march ----------------------------------------------------------------------------


@pytest.mark.parametrize("cone", [0.0, 0.004])
def test_candidate_lattice_exact(cone):
    same(t_gm.candidate_lattice(300, 0.1, 1e-2, cone), j_gm.candidate_lattice(300, 0.1, 1e-2, cone))


def test_compact_mask_exact():
    rng = np.random.default_rng(3)
    mask = rng.uniform(size=(64, 200)) < rng.uniform(0, 0.4, (64, 1))
    mask[0] = False
    mask[1] = True
    idx_j, valid_j = j_gm.compact_mask(jnp.asarray(mask), 32)
    idx_t, valid_t = t_gm.compact_mask(T(mask), 32)
    same(valid_t, valid_j)
    same(idx_t, idx_j)


def _grid(rng, n=16, p=0.3):
    return rng.uniform(size=(n, n, n)) < p


def _rays(rng, R, scale=1.6):
    o = rng.uniform(-scale, scale, (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def test_occupancy_lookup_exact():
    rng = np.random.default_rng(4)
    b = _grid(rng)
    aabb = np.array([-1, -1, -1, 1, 1, 1], np.float32)
    pos = rng.uniform(-1.3, 1.3, (40, 7, 3)).astype(np.float32)
    same(t_gm.occupancy_lookup(T(b), T(aabb), T(pos)),
         j_gm.occupancy_lookup(jnp.asarray(b), jnp.asarray(aabb), jnp.asarray(pos)))


@pytest.mark.parametrize("near", [False, True])
def test_march_rays_exact(near):
    rng = np.random.default_rng(5)
    b = _grid(rng)
    aabb = np.array([-1, -1, -1, 1, 1, 1], np.float32)
    o, d = _rays(rng, 64)
    lat = j_gm.candidate_lattice(512, 0.0, 1e-2, 0.004)
    near_planes = rng.uniform(0, 1, 64).astype(np.float32) if near else None
    sj = j_gm.march_rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(b), jnp.asarray(aabb),
                         jnp.asarray(lat), 32,
                         near_planes=None if near_planes is None else jnp.asarray(near_planes))
    st = t_gm.march_rays(T(o), T(d), T(b), T(aabb), T(lat), 32,
                         near_planes=None if near_planes is None else T(near_planes))
    for a, r in zip(st, sj):
        same(a, r)
    assert 0 < int(st.valid.sum()) < st.valid.numel()
    assert all(t.is_contiguous() for t in st)


# -- the field and its renderer -----------------------------------------------------------


def _field(seed=0, **kw):
    jcfg = j_ngp.NGPConfig(**{**FIELD, **kw})
    params = j_ngp.init_ngp(jax.random.PRNGKey(seed), jcfg)
    tcfg = t_ngp.NGPConfig(**{**FIELD, **kw})
    return jcfg, params, tcfg, t_ngp.NGPField.from_tree(jax.tree.map(np.asarray, params))


def test_config_and_init_match_jax():
    jcfg, params, tcfg, field = _field()
    assert tcfg.grid._asdict() == jcfg.grid._asdict()
    tree = {n: p.shape for n, p in t_ngp.init_ngp(tcfg, torch.Generator().manual_seed(0))
            .named_parameters()}
    flat = {".".join(k.key for k in path): v.shape
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    assert {k: tuple(v) for k, v in tree.items()} == {k: tuple(v) for k, v in flat.items()}
    # the contracted field has the same parameters (test_torch_examples.py holds its outputs)
    unbounded = t_ngp.init_ngp(tcfg._replace(unbounded=True), torch.Generator().manual_seed(0))
    assert {n: tuple(p.shape) for n, p in unbounded.named_parameters()} == tree


def test_forward_matches_jax():
    jcfg, params, tcfg, field = _field(1)
    # a table at unit scale so the hash features are not buried under the biases
    rng = np.random.default_rng(6)
    params["table"] = jnp.asarray(rng.normal(size=params["table"].shape).astype(np.float32))
    field = t_ngp.NGPField.from_tree(jax.tree.map(np.asarray, params))
    pos = rng.uniform(-1.2, 1.2, (50, 6, 3)).astype(np.float32)
    dirs = rng.normal(size=(50, 6, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    out_j = j_ngp.forward(params, jcfg, jnp.asarray(pos), jnp.asarray(dirs))
    out_t = t_ngp.forward(field, tcfg, T(pos), T(dirs))
    assert len(out_t) == 3
    for a, b in zip(out_t, out_j):
        close(a, b, **FIELD_TOL)
    assert float((out_t[1] == 0).float().mean()) > 0.1  # the selector zeroes outside the box


def _occ_states(rng, res=(16, 16, 16), p=0.4):
    aabb = FIELD["aabb"]
    occs = rng.uniform(0, 0.02, int(np.prod(res))).astype(np.float32)
    b = (rng.uniform(size=res) < p)
    sj = j_occ.init_occ_grid(aabb, res)._replace(occs=jnp.asarray(occs), binaries=jnp.asarray(b))
    st = t_occ.init_occ_grid(aabb, res)._replace(occs=T(occs), binaries=T(b))
    return sj, st


@pytest.mark.parametrize("with_variance", [False, True])
def test_render_rays_matches_jax(with_variance, monkeypatch):
    # the call site hands the weights kernel what its wrapper takes on the
    # card: three contiguous float32 [R, S] tensors
    seen = []
    real = t_rr.fused_render_weights
    monkeypatch.setattr(t_rr, "fused_render_weights", lambda *a: seen.append(a) or real(*a))
    jcfg, params, tcfg, field = _field(2)
    rng = np.random.default_rng(7)
    params["table"] = jnp.asarray(rng.normal(size=params["table"].shape).astype(np.float32))
    field = t_ngp.NGPField.from_tree(jax.tree.map(np.asarray, params))
    sj, st = _occ_states(rng)
    o, d = _rays(rng, 64)
    lat = j_gm.candidate_lattice(256, 0.0, 1e-2, 0.004)
    bkgd = np.array([0.2, 0.5, 0.9], np.float32)
    kw = dict(render_bkgd=bkgd, alpha_thre=0.01, with_variance=with_variance)
    out_j = j_rr.render_rays(
        lambda p, v: j_ngp.forward(params, jcfg, p, v), jnp.asarray(o), jnp.asarray(d), sj,
        jnp.asarray(lat), 32, occ_mean=jnp.mean(sj.occs), **{**kw, "render_bkgd": jnp.asarray(bkgd)})
    out_t = t_rr.render_rays(
        lambda p, v: t_ngp.forward(field, tcfg, p, v), T(o), T(d), st, T(lat), 32,
        occ_mean=st.occs.mean(), **{**kw, "render_bkgd": T(bkgd)})
    assert set(out_t) == set(out_j)
    assert seen and all(x.dtype == torch.float32 and x.is_contiguous() and x.shape == a[2].shape
                        and x.dim() == 2 for a in seen for x in a)
    for k in out_j:
        close(out_t[k], out_j[k], **FIELD_TOL, err_msg=k)
    # the visibility test removed samples the march kept
    assert 0 < int(out_t["n_samples"]) < int(t_gm.march_rays(
        T(o), T(d), st.binaries, st.aabb, T(lat), 32).valid.sum())


# -- the occupancy cadence and the invisible cells -----------------------------------------


def _occ_draws(key, n, warm):
    k_jit, k_uni, k_occ = jax.random.split(key, 3)
    n_sub = n // 4
    return {
        "jitter": T(jax.random.uniform(k_jit, (n if warm else 2 * n_sub, 3))),
        "uniform_idx": T(jax.random.randint(k_uni, (n_sub,), 0, n)).long(),
        "occ_u": T(jax.random.uniform(k_occ, (n_sub,))),
    }


@pytest.mark.parametrize("step", [32, 33, 300, 301])
def test_maybe_update_occ_grid(step):
    rng = np.random.default_rng(8)
    sj, st = _occ_states(rng, res=(6, 4, 5))
    fn = lambda x, lib: (lib.sin(3.0 * x[:, 0]) * lib.cos(2.0 * x[:, 2])) ** 2 * 0.02
    key = jax.random.PRNGKey(step)
    oj = j_occ.maybe_update_occ_grid(sj, lambda x: fn(x, jnp), key, jnp.asarray(step), 3e-3,
                                     every_n=16, warmup_steps=256)
    ot = t_occ.maybe_update_occ_grid(st, lambda x: fn(x, torch), step, 3e-3, every_n=16,
                                     warmup_steps=256, draws=_occ_draws(key, 120, step < 256))
    close(ot.occs, oj.occs, rtol=1e-5, atol=1e-7)
    same(ot.binaries, oj.binaries)
    if step % 16:
        assert ot is st  # no update, no draw
    else:
        assert not torch.equal(ot.occs, st.occs)


def test_mark_invisible_cells_exact():
    from apnerf_tpu_torch.ops.rays import make_intrinsics, pose_matrix_from_quat

    aabb = (-2.0, 0.0, -2.0, 2.0, 2.0, 2.0)
    res = (10, 5, 10)
    K = make_intrinsics(32, 24, np.pi / 2)
    mats = np.stack([
        pose_matrix_from_quat(np.array([0.3, 1.0, -0.2]), np.array([0, np.sin(a / 2), 0, np.cos(a / 2)]))
        for a in (0.0, 2.0)
    ]).astype(np.float32)
    oj = j_occ.mark_invisible_cells(j_occ.init_occ_grid(aabb, res), jnp.asarray(K),
                                    jnp.asarray(mats), 32, 24, 0.5)
    ot = t_occ.mark_invisible_cells(t_occ.init_occ_grid(aabb, res), T(K), T(mats), 32, 24, 0.5)
    same(ot.occs, oj.occs)
    assert 0 < int((ot.occs < 0).sum()) < ot.occs.numel()


# -- the member step ----------------------------------------------------------------------


def _train_cfg(cls, **kw):
    return cls(**{**dict(
        aabb=FIELD["aabb"], main_neurons=32, main_layer=2, geo_feat_dim=7, n_levels=4,
        log2_hashmap_size=10, base_resolution=4, max_resolution=32, num_semantic_classes=5,
        main_grid_size=0.125, num_rays=64, max_samples_train=32, n_candidates=512,
        render_step_size=1e-2, n_ensembles=2, occ_warmup_steps=4, training_steps=40,
    ), **kw})


def _batch(rng, R=64):
    o, d = _rays(rng, R, scale=0.8)
    return (o, d, rng.uniform(size=(R, 3)).astype(np.float32),
            rng.uniform(0.1, 2.0, R).astype(np.float32), rng.integers(0, 5, R).astype(np.int32),
            np.array([0.3, 0.6, 0.1], np.float32))


def _jax_member(field):
    tree = {}
    for name, v in field.state_dict().items():
        *path, leaf = name.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        # a copy: a CPU array made from the tensor's buffer can share it,
        # and the port's step updates that buffer in place
        node[leaf] = jnp.array(v.numpy(), copy=True)
    return tree


@pytest.mark.parametrize("step", [0, 5])
def test_member_step_matches_jax(step):
    cfg_j, cfg_t = _train_cfg(JaxConfig), _train_cfg(PipelineConfig)
    state_t = t_step.init_ensemble(cfg_t, torch.Generator().manual_seed(0))
    member = state_t.members[0]
    with torch.no_grad():  # a livelier table than U(±1e-4), so densities vary
        member.table.normal_(0.0, 1.0, generator=torch.Generator().manual_seed(1))
    params = _jax_member(member)
    opt_j = j_step.make_optimizer(cfg_j)
    opt_state = opt_j.init(params)
    rng = np.random.default_rng(9)
    sj, st = _occ_states(rng, res=cfg_t.main_grid_resolution, p=0.5)
    arrays = _batch(rng)
    k_occ = jax.random.PRNGKey(11)
    out_j = jax.jit(j_step.make_member_core(cfg_j))(
        params, opt_state, sj, j_ds.RayBatch(*map(jnp.asarray, arrays)), k_occ,
        jnp.asarray(step), jnp.asarray(1e-3))
    n = st.occs.numel()
    draws = _occ_draws(k_occ, n, step < cfg_t.occ_warmup_steps) if step % 16 == 0 else None
    p0 = {name: p.detach().clone() for name, p in member.named_parameters()}
    out_t = t_step.make_member_core(cfg_t, t_step.make_lattice(cfg_t))(
        member, state_t.opt[0], t_ds.RayBatch(*map(T, arrays)), step, occ=st, occ_thre=1e-3,
        occ_draws=draws)
    for a, b in zip(out_t[1:5], out_j[3:7]):
        close(a, b, rtol=1e-4)
    assert int(out_t.n_samples) == int(out_j[7]) > 0
    assert not bool(out_t.skipped) and not bool(out_j[8])
    close(out_t.occ.occs, out_j[2].occs, rtol=1e-5, atol=1e-7)
    same(out_t.occ.binaries, out_j[2].binaries)
    lr = float(t_step.default_ngp_schedule(cfg_t)(0))

    def by_name(tree):
        return {".".join(k.key for k in path): np.asarray(v)
                for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

    new_j, mu_j = by_name(out_j[0]), by_name(out_j[1][0].mu)
    for name, p in member.named_parameters():
        start = p0[name].numpy()
        d_t, d_j = p.detach().numpy() - start, new_j[name] - start
        tol = 1e-3 * lr + 2 * np.finfo(np.float32).eps * np.abs(start)
        sure = np.abs(mu_j[name]) > 2e-2 * np.abs(mu_j[name]).max()
        zero = mu_j[name] == 0
        assert np.all(np.abs(d_t - d_j)[sure] <= tol[sure]), name
        assert np.all(d_t[zero] == 0), name
        assert np.all(np.abs(d_t) <= lr * (1 + 1e-3) + tol), name
        assert sure.any() and np.all(np.abs(d_j[sure]) >= 0.99 * lr), name  # ±lr there
    leaves_j = jax.tree_util.tree_leaves(out_j[1])
    leaves_t = interop.opt_leaves(member, out_t.opt)
    assert int(leaves_t[0]) == int(leaves_j[0]) == 1
    for i, (a, b) in enumerate(zip(leaves_t[1:-1], leaves_j[1:-1])):
        on_scale(T(a), b, 1e-2, name=f"opt leaf {i}")


def test_member_step_refuses_a_spectrum_decay():
    with pytest.raises(ValueError, match="spectrum"):
        cfg = _train_cfg(PipelineConfig, spectral_spectrum_wd=1e-3)
        t_step.make_member_core(cfg, t_step.make_lattice(cfg))


def test_phase_updates_grids_and_draws_per_member():
    """The ngp core through ``make_train_phase``: two steps of two members,
    the grids replaced in the state (the old ones left as they were),
    losses finite, the generator's draws distinct per member."""
    cfg = _train_cfg(PipelineConfig, img_w=32, img_h=24, max_images=4, occ_warmup_steps=1)
    rng = np.random.default_rng(10)
    images = rng.integers(0, 256, (4, 24, 32, 3)).astype(np.uint8)
    depths = rng.uniform(0.1, 2.0, (4, 24, 32)).astype(np.float32)
    sems = rng.integers(0, 5, (4, 24, 32)).astype(np.int32)
    mats = np.stack([np.eye(4, dtype=np.float32)] * 4)
    mats[:, :3, 3] = rng.uniform(-0.3, 0.3, (4, 3))
    ds = t_ds.RayDataset(True, num_rays=64, num_models=2, width=32, height=24, max_images=4,
                         device="cpu")
    ds.update_data(images, depths, sems, mats)
    state = t_step.init_ensemble(cfg, torch.Generator().manual_seed(2))
    old = list(state.occ)
    pools, counts = t_phase.pools_from_dataset(ds)
    state, losses = t_phase.make_ngp_train_phase(cfg, t_step.make_lattice(cfg))(
        state, ds.images, ds.depths, ds.semantics, ds.camtoworlds, ds.K, pools, counts,
        ds.size, 2, False, torch.Generator().manual_seed(3), occ_thre=1e-3)
    assert state.step == 2 and losses.shape == (2, 2) and bool(torch.isfinite(losses).all())
    assert all(float(o.occs.abs().sum()) == 0 for o in old)
    assert not torch.equal(state.occ[0].occs, state.occ[1].occs)
    assert [int(o.count) for o in state.opt] == [2, 2]


# -- checkpoints both ways, and the loop --------------------------------------------------

AABB = (-8.0, 0.0, -8.0, 0.0, 3.0, 0.0)


def _loop_cfg(cls, tmp, **kw):
    """A tiny ngp+occ configuration. ``alpha_thre`` is 0: at this size the
    first ``max_samples_train`` lattice intervals of a ray all lie in the
    lattice's linear phase, where a freshly initialized field's alpha
    (σ ≈ e⁻¹ everywhere) sits just under the threshold clamped by the
    grid's mean occupancy, so no sample would be visible and nothing
    would train (the JAX mapper behaves the same way at this size)."""
    return cls(**{**dict(
        save_path=str(tmp), aabb=AABB, field_type="ngp", sampler_type="occ", n_ensembles=2,
        img_w=40, img_h=40, max_images=128, training_steps=120, num_rays=128,
        max_samples_train=32, max_samples_test=48, main_neurons=32, geo_feat_dim=7, n_levels=4,
        log2_hashmap_size=12, max_resolution=64, occ_warmup_steps=16, n_candidates=512,
        render_step_size=2e-2, alpha_thre=0.0, planning_step=1, num_traj=2, sample_disc=10,
        num_semantic_classes=8, global_origin=(-4.0, 1.5, -4.0, 0.0, 0.0, 0.0, 1.0),
        test_loc=((-3.7, 1.5, -4.4),),
    ), **kw})


def _mapper(tmp, name, seed=9, **kw):
    from apnerf_tpu_torch.active.mapper import ActiveNeRFMapper
    from apnerf_tpu_torch.sim.fake import FakeSim

    cfg = _loop_cfg(PipelineConfig, tmp, **kw)
    return ActiveNeRFMapper(cfg, FakeSim(aabb=AABB, img_w=40, img_h=40), save_path=str(tmp / name),
                            seed=seed, device="cpu", checkpoint_every=10**9, max_samples_unc=32,
                            unc_scale=0.2)


@pytest.fixture(scope="module")
def loop(tmp_path_factory):
    """An ngp+occ mapper after the initial scan, 120 train steps with an
    evaluation, and one planning step."""
    tmp = tmp_path_factory.mktemp("ngp")
    m = _mapper(tmp, "loop")
    m.initialization()
    losses = m.nerf_training(120, initial_train=True)
    m.planning(1, 20)
    return tmp, m, losses


def test_loop_trains_and_evaluates(loop):
    _, m, losses = loop
    assert len(losses) == 120 and np.isfinite(losses).all()
    assert np.mean(losses[-20:]) < 0.8 * np.mean(losses[:20])
    assert m.state.step == 140 and len(m.loss_hist) == 2
    rows = np.asarray(m.errors_hist)
    assert rows.shape[1] == 4 and np.isfinite(rows).all() and rows[0, 0] == -1.0
    assert np.isfinite([r[2] for r in m.metrics_ext_hist]).all()
    pi = np.asarray(m.trajector_uncertainty_list[0])
    assert pi.shape == (2, 4) and np.isfinite(pi).all()
    assert m.binaries_host().shape == (2,) + m.cfg.main_grid_resolution


def test_evaluation_draws_nothing(loop):
    """``_evaluate`` leaves the mapper's generator where it was, so
    milestone evaluations inside one run change none of its draws."""
    _, m, _ = loop
    before = m.generator.get_state().clone()
    m._evaluate(-1)
    m._evaluate(-1)
    assert torch.equal(before, m.generator.get_state())
    np.testing.assert_array_equal(m.errors_hist[-1], m.errors_hist[-2])


def test_ngp_checkpoints_cross_packages(loop):
    """The JAX mapper loads the port's ngp checkpoint and the port the JAX
    mapper's: parameters, Adam leaves, grids and step exact."""
    from apnerf_tpu.active.mapper import ActiveNeRFMapper as JaxMapper
    from apnerf_tpu.sim.fake import FakeSim as JaxFakeSim

    tmp, m, _ = loop
    m.save_checkpoints()
    ckpt = os.path.join(m.save_path, "checkpoints")
    jm = JaxMapper(_loop_cfg(JaxConfig, tmp), JaxFakeSim(aabb=AABB, img_w=40, img_h=40),
                   save_path=str(tmp / "jax"), seed=1)
    jm.load_checkpoints(ckpt)
    assert int(jm.state.step) == m.state.step
    got = jax.tree.map(np.asarray, jm.state.params)
    for i, member in enumerate(m.members):
        for name, p in member.named_parameters():
            node = got
            for key in name.split("."):
                node = node[key]
            same(p, node[i])
        leaves_j = [np.asarray(x)[i] if np.asarray(x).ndim else np.asarray(x)
                    for x in jax.tree_util.tree_leaves(jm.state.opt_state)]
        for a, b in zip(interop.opt_leaves(member, m.state.opt[i]), leaves_j):
            same(a, b)
    same(m.binaries_host(), jm.state.occ.binaries)
    same(torch.stack([o.occs for o in m.occ]), jm.state.occ.occs)

    params = jax.tree.map(lambda x: x + 1.0, jm.state.params)
    jm.state = jm.state._replace(params=params, step=jnp.asarray(77))
    jm.save_checkpoints()
    m2 = _mapper(tmp, "from_jax", seed=4)
    m2.load_checkpoints(os.path.join(jm.save_path, "checkpoints"))
    assert m2.state.step == 77
    for a, b in zip(m2.members, interop.params_from_jax(jax.tree.map(np.asarray, params))):
        for (n, p), q in zip(a.named_parameters(), b.parameters()):
            same(p, q.detach())
            assert p.requires_grad, n
    for a, b in zip(m2.state.opt, m.state.opt):
        same(a.mu, b.mu)


def test_mark_invisible_in_the_mapper(tmp_path):
    m = _mapper(tmp_path, "inv", mark_invisible=True, img_w=40)
    m.initialization()
    occs = [o.occs for o in m.occ]
    assert torch.equal(occs[0], occs[1]) and 0 < int((occs[0] < 0).sum()) < occs[0].numel()
    assert set(torch.unique(occs[0]).tolist()) == {-1.0, 0.0}


@pytest.mark.parametrize("path", ["ngp+occ", "spectral+prop"])
def test_quality_harness_rows(path):
    """``quality.run_path`` at a tiny size on the CPU: a milestone row and
    the final row, finite, in order, naming the device."""
    from apnerf_tpu_torch import quality

    tiny = dict(num_rays=64, max_samples_train=16, max_samples_test=24, main_neurons=32,
                geo_feat_dim=7, n_levels=4, log2_hashmap_size=12, max_resolution=64,
                n_candidates=256, render_step_size=4e-2, spectral_neurons=32,
                spectral_freqs_per_level=2, prop_neurons=16, num_prop_samples=8)
    lines = []
    rows = quality.run_path(path, 30, img=24, milestones=[10, 30, 99], device="cpu",
                            overrides=tiny, out=lines.append)
    assert [r["steps"] for r in rows] == [10, 30] and len(lines) == 2
    for r in rows:
        assert r["path"] == path and r["device"] == "cpu"
        assert np.isfinite([r["psnr"], r["depth_mse"], r["sem_ce"], r["miou"]]).all()
