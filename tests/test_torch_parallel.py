"""The port's multi-device layer (``apnerf_tpu_torch/parallel/``) on the
CPU: ``gloo`` ranks started by ``parallel/launch.py``, against the port's
unsharded paths and against the JAX package.

Every unsharded reference runs in this process on one PyTorch thread, as
every rank does: a CPU matmul's last bits can depend on the thread count.
Two launches carry most of the checks, a (2, 1) and a (2, 2) mesh, each
running several programs of ``parallel/runs.py``. Tolerances, each with
its reason:
  * ``fetch_rays(shard=...)`` against JAX's, and the shards' concatenation
    against the unsharded fetch: exact;
  * the ensemble step against JAX's ``make_train_step``: the tolerances of
    ``tests/test_torch_ngp.py::test_member_step_matches_jax`` (loss terms
    rtol 1e-4, the grid's EMA rtol 1e-5 and binaries exact, each updated
    element within 1e-3 learning rates of JAX's where its gradient is not
    near zero);
  * ``grad_reduce=None`` and a (2, 1) mesh: bit for bit (a (2, 1) rank
    does the unsharded member's arithmetic, and a gather is exact);
  * (2, 2) against the unsharded phase at float32: losses rtol 1e-5, every
    parameter within 1e-5 of its tensor's max-abs, Adam's first moment
    (the averaged gradient) likewise; the (ngp, occ) phase within
    ``chip_smoke.py``'s ``NGP_STEP_TOL`` (loss 5e-7 relative, updates
    1.5e-4 and gradients 5e-5 of their tensor's max-abs), its grids' EMA
    rtol 1e-5 / atol 1e-7 (the density of parameters that differ by
    rounding, as ``tests/test_torch_ngp.py``) and binaries exact;
  * (2, 2) against JAX's ``make_shardmap_flagship_phase`` at float32, on
    JAX's own per-shard jitter: losses rtol 1e-5 and parameters within
    ``tests/test_torch_train.py``'s float32 bound for a phase (2e-3 of
    each tensor's max-abs plus 1e-2 learning rates a step);
  * the sharded renders: bit for bit (a rank renders whole views, so its
    calls are the unsharded render's).
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apnerf_tpu.data import dataset as j_ds
from apnerf_tpu_torch.config import PipelineConfig
from apnerf_tpu_torch.data import dataset as t_ds
from apnerf_tpu_torch.parallel import runs
from apnerf_tpu_torch.parallel.launch import launch, plan
from apnerf_tpu_torch.parallel.mesh import Mesh, mesh_shape, shard_ensemble_state
from apnerf_tpu_torch.train import flagship as t_fl
from apnerf_tpu_torch.train import phase as t_phase
from apnerf_tpu_torch.train import step as t_step

H, W, N_IMG = 24, 32, 4
FLAGSHIP = PipelineConfig(
    aabb=(-1.0, -1.0, -1.0, 1.0, 1.0, 1.0), img_w=W, img_h=H, num_rays=64,
    max_samples_train=8, num_prop_samples=8, num_semantic_classes=5, n_ensembles=2,
    max_images=N_IMG, n_levels=4, spectral_freqs_per_level=2, base_resolution=4,
    max_resolution=32, spectral_neurons=32, spectral_layers=3, geo_feat_dim=7, prop_neurons=16,
)
NGP = dataclasses.replace(
    FLAGSHIP, field_type="ngp", sampler_type="occ", main_neurons=32, main_layer=2,
    log2_hashmap_size=10, main_grid_size=0.125, max_samples_train=32, n_candidates=512,
    render_step_size=1e-2, occ_warmup_steps=4, occ_every_n=2, training_steps=40,
)
NGP_STEP_TOL = (5e-7, 1.5e-4, 5e-5)  # chip_smoke.py: loss, update, gradient
V, P = 4, 16  # render views and rays a view


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(a):
    return torch.as_tensor(np.array(a))


bits = runs.same_bits  # an array (or a rank's digest of one) against an array


def _scene(seed=7):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (N_IMG, H, W, 3)).astype(np.uint8)
    depths = rng.uniform(0.1, 2.0, (N_IMG, H, W)).astype(np.float32)
    sems = rng.integers(0, 5, (N_IMG, H, W)).astype(np.int32)
    mats = np.stack([np.eye(4, dtype=np.float32)] * N_IMG)
    mats[:, :3, 3] = rng.uniform(-0.3, 0.3, (N_IMG, 3))
    return images, depths, sems, mats


def _store(cfg):
    ds = t_ds.RayDataset(True, num_rays=cfg.num_rays, num_models=2, width=W, height=H,
                         max_images=N_IMG, device="cpu")
    ds.update_data(*_scene())
    pools, counts = t_phase.pools_from_dataset(ds)
    return (ds.images, ds.depths, ds.semantics, ds.camtoworlds, ds.K, pools, counts, ds.size)


def _flagship_state():
    return t_fl.init_flagship_ensemble(FLAGSHIP, torch.Generator().manual_seed(1))


def _ngp_state():
    state = t_step.init_ensemble(NGP, torch.Generator().manual_seed(2))
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():  # a livelier table than U(±1e-4): densities vary, the fields train
        for m in state.members:
            m.table.normal_(0.0, 1.0, generator=g)
    return state


def _render_rays(n_views=V, seed=5):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.5, 0.5, (n_views, P, 3)).astype(np.float32)
    d = rng.normal(size=(n_views, P, 3)).astype(np.float32)
    return T(o), T(d / np.linalg.norm(d, axis=-1, keepdims=True))


def _jobs(f32: bool, jax_draws=None):
    """The programs of one launch: the phases, the step, the renders."""
    o, d = _render_rays()
    o3, d3 = _render_rays(3, seed=6)
    todo = [
        (runs.train_job, dict(cfg=FLAGSHIP, kind="flagship", state=_flagship_state(),
                              store=_store(FLAGSHIP), n_steps=3, seed=3,
                              dtype="float32" if f32 else None)),
        (runs.train_job, dict(cfg=NGP, kind="ngp", state=_ngp_state(), store=_store(NGP),
                              n_steps=4, seed=3)),
        (runs.train_job, dict(cfg=NGP, kind="step", state=_ngp_state(), store=_store(NGP),
                              n_steps=2, seed=4, image_idx=[[0, 2], [3, 1]])),
        (runs.render_job, dict(cfg=FLAGSHIP, state=_flagship_state(), origins=o, viewdirs=d,
                               bkgd=torch.zeros(3), max_samples=16, with_variance=True)),
        (runs.render_job, dict(cfg=FLAGSHIP, state=_flagship_state(), origins=o3, viewdirs=d3,
                               bkgd=torch.ones(3), max_samples=16, with_variance=False)),
        (runs.render_job, dict(cfg=NGP, state=_ngp_state(), origins=o, viewdirs=d,
                               bkgd=torch.ones(3), max_samples=32, with_variance=True)),
    ]
    if jax_draws is not None:
        todo.append((runs.train_job, dict(
            cfg=FLAGSHIP, kind="flagship", state=_flagship_state(), store=_store(FLAGSHIP),
            n_steps=len(jax_draws), draws=jax_draws, dtype="float32")))
    return todo


def _unsharded(todo):
    return [job(Mesh.single(), **copy.deepcopy(kw)) for job, kw in todo]


@pytest.fixture(scope="module")
def mesh_21():
    todo = _jobs(f32=False)
    return launch(runs.jobs, 2, 1, todo, device="cpu", timeout=300), _unsharded(todo)


# -- unit 1: fetch_rays' shard ------------------------------------------------------------


def _fetch_draws(key, num_rays):
    k_x, k_y, k_bkgd = jax.random.split(key, 3)
    return {"x": T(jax.random.randint(k_x, (num_rays,), 0, W)),
            "y": T(jax.random.randint(k_y, (num_rays,), 0, H)),
            "bkgd": T(jax.random.uniform(k_bkgd, (3,)))}


@pytest.mark.parametrize("n", [2, 4])
def test_fetch_rays_shards_match_jax(n):
    images, depths, sems, mats = _scene()
    K = t_ds.make_intrinsics(W, H, np.pi / 2)
    key = jax.random.PRNGKey(8)
    args_t = (T(images), T(depths), T(sems), T(mats), T(K), torch.tensor(2), 48)
    whole = t_ds.fetch_rays(*args_t, draws=_fetch_draws(key, 48))
    parts = []
    for i in range(n):
        bj = j_ds.fetch_rays(images, depths, sems, mats, K, jnp.asarray(2), key, 48,
                             shard=(i, n))
        bt = t_ds.fetch_rays(*args_t, draws=_fetch_draws(key, 48), shard=(i, n))
        for name, a, b in zip(bt._fields, bt, bj):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
        parts.append(bt)
    for name, a, *ps in zip(whole._fields, whole, *parts):
        joined = ps[0] if name == "color_bkgd" else torch.cat(ps)
        assert bits(joined.numpy(), a.numpy()), name
    with pytest.raises(ValueError, match="num_rays 48 % data axis 5 != 0"):
        t_ds.fetch_rays(*args_t, draws=_fetch_draws(key, 48), shard=(0, 5))


# -- unit 2: one ensemble step for given images -------------------------------------------


def _jax_tree(module):
    tree = {}
    for name, v in module.state_dict().items():
        *path, leaf = name.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = jnp.array(v.numpy(), copy=True)
    return tree


def _occ_draws(key, n, warm):
    k_jit, k_uni, k_occ = jax.random.split(key, 3)
    n_sub = n // 4
    return {"jitter": T(jax.random.uniform(k_jit, (n if warm else 2 * n_sub, 3))),
            "uniform_idx": T(jax.random.randint(k_uni, (n_sub,), 0, n)).long(),
            "occ_u": T(jax.random.uniform(k_occ, (n_sub,)))}


def test_train_step_matches_jax():
    from apnerf_tpu.config import PipelineConfig as JaxConfig
    from apnerf_tpu.ops import occupancy as j_occ
    from apnerf_tpu.train import step as j_step

    cfg_j = JaxConfig(**{f.name: getattr(NGP, f.name) for f in dataclasses.fields(JaxConfig)})
    state_t = _ngp_state()
    opt_j = j_step.make_optimizer(cfg_j)
    trees = [_jax_tree(m) for m in state_t.members]
    stack = lambda ts: jax.tree.map(lambda *xs: jnp.stack(xs), *ts)  # noqa: E731
    grid = j_occ.init_occ_grid(cfg_j.aabb, cfg_j.main_grid_resolution)
    state_j = j_step.EnsembleState(params=stack(trees), opt_state=stack([opt_j.init(t) for t in trees]),
                                   occ=stack([grid] * 2), step=jnp.asarray(0))
    images, depths, sems, mats = _scene()
    K = t_ds.make_intrinsics(W, H, np.pi / 2)
    idx, key = np.array([2, 0], np.int32), jax.random.PRNGKey(7)
    out_j = j_step.make_train_step(cfg_j)(state_j, images, depths, sems, mats, K,
                                          jnp.asarray(idx), key, jnp.asarray(1e-3))
    k_fetch, k_occ = jax.random.split(key)
    fetch = [_fetch_draws(k, NGP.num_rays) for k in jax.random.split(k_fetch, 2)]
    n = state_t.occ[0].occs.numel()
    draws = {**{k: torch.stack([f[k] for f in fetch]) for k in ("x", "y", "bkgd")},
             "occ": [_occ_draws(k, n, True) for k in jax.random.split(k_occ, 2)]}
    p0 = [{k: v.detach().clone() for k, v in m.named_parameters()} for m in state_t.members]
    out_t = t_step.make_train_step(NGP, t_step.make_lattice(NGP))(
        state_t, T(images), T(depths), T(sems), T(mats), T(K), T(idx), 1e-3, draws=draws)
    for name in ("loss", "loss_rgb", "loss_dep", "loss_sem"):
        np.testing.assert_allclose(getattr(out_t, name).numpy(), np.asarray(getattr(out_j, name)),
                                   rtol=1e-4, err_msg=name)
    assert out_t.n_samples.tolist() == np.asarray(out_j.n_samples).tolist()
    assert min(out_t.n_samples.tolist()) > 0 and not out_t.skipped.any()
    assert out_t.state.step == 1 and [int(o.count) for o in out_t.state.opt] == [1, 1]
    lr = float(t_step.default_ngp_schedule(NGP)(0))
    for m, member in enumerate(out_t.state.members):
        occ_j = jax.tree.map(lambda a: np.asarray(a)[m], out_j.state.occ)
        np.testing.assert_allclose(out_t.state.occ[m].occs.numpy(), occ_j.occs, rtol=1e-5,
                                   atol=1e-7)
        assert bits(out_t.state.occ[m].binaries.numpy(), occ_j.binaries)
        new_j = {".".join(k.key for k in path): np.asarray(v)[m] for path, v in
                 jax.tree_util.tree_flatten_with_path(out_j.state.params)[0]}
        mu_j = {".".join(k.key for k in path): np.asarray(v)[m] for path, v in
                jax.tree_util.tree_flatten_with_path(out_j.state.opt_state[0].mu)[0]}
        for name, p in member.named_parameters():
            start = p0[m][name].numpy()
            d_t, d_j = p.detach().numpy() - start, new_j[name] - start
            tol = 1e-3 * lr + 2 * np.finfo(np.float32).eps * np.abs(start)
            sure = np.abs(mu_j[name]) > 2e-2 * np.abs(mu_j[name]).max()
            assert sure.any() and np.all(np.abs(d_t - d_j)[sure] <= tol[sure]), (m, name)


# -- unit 3: grad_reduce ----------------------------------------------------------------------


def test_grad_reduce_none_changes_nothing():
    """The unsharded phases with ``grad_reduce=None`` (the default) and with
    an identity ``grad_reduce``, and through ``make_train_phase``'s own
    single-rank mesh: the same losses and parameters, bit for bit."""
    store = _store(FLAGSHIP)

    def run(kind, build):
        state = _flagship_state() if kind == "flagship" else _ngp_state()
        gen = torch.Generator().manual_seed(3)
        state, losses = build()(state, *store[:-1], store[-1], 3, False, gen, occ_thre=1e-3)
        return losses.numpy(), runs.state_arrays(state)["params"]

    lattice = t_step.make_lattice(NGP)
    identity = lambda g: list(g)  # noqa: E731
    builds = {
        "flagship": (lambda: t_fl.make_flagship_train_phase(FLAGSHIP),
                     lambda: t_phase.make_train_phase(FLAGSHIP, t_fl.make_flagship_member_core(
                         FLAGSHIP, grad_reduce=identity), Mesh.single())),
        "ngp": (lambda: t_phase.make_ngp_train_phase(NGP, lattice),
                lambda: t_phase.make_train_phase(NGP, t_step.make_member_core(
                    NGP, lattice, grad_reduce=identity), Mesh.single())),
    }
    for kind, (plain, reduced) in builds.items():
        a, b = run(kind, plain), run(kind, reduced)
        assert bits(a[0], b[0]) and bits(a[1], b[1]), kind


# -- unit 4: the mesh ------------------------------------------------------------------------


def test_mesh_shape_matches_jax_make_mesh():
    from apnerf_tpu.parallel.mesh import make_mesh

    checked = 0
    for devices in (1, 2, 3, 4, 6, 8):
        for n_ens in (1, 2, 3):
            for n_data in (None, 1, 2):
                try:
                    ref = make_mesh(n_ens, n_data, devices=jax.devices()[:devices])
                except (ValueError, TypeError):
                    with pytest.raises(ValueError):
                        mesh_shape(devices, n_ens, n_data)
                    continue
                assert mesh_shape(devices, n_ens, n_data) == (ref.shape["ens"], ref.shape["data"])
                checked += 1
    assert checked >= 40


def test_a_rank_keeps_its_members_and_its_rays():
    state = _flagship_state()
    mesh = Mesh(2, 2, rank=3, device="cpu")
    assert (mesh.ens_index, mesh.data_index) == (1, 1)
    assert mesh.members(4) == range(2, 4) and mesh.rays(64) == slice(32, 64)
    assert [mesh.views(5) for mesh in (Mesh(1, 2, 0, "cpu"), Mesh(1, 2, 1, "cpu"))] == [
        slice(0, 2), slice(2, 5)]
    mine = shard_ensemble_state(copy.deepcopy(state), Mesh(2, 1, rank=1, device="cpu"))
    assert len(mine.members) == 1 and torch.equal(mine.members[0].main.W, state.members[1].main.W)
    with pytest.raises(ValueError, match="n_ensembles 3 % mesh ens axis 2 != 0"):
        mesh.members(3)
    with pytest.raises(ValueError, match="num_rays 31 % data axis 2 != 0"):
        mesh.rays(31)
    assert plan(4, "cpu") == ("gloo", [torch.device("cpu")] * 4)


# -- units 5-9 on a (2, 1) mesh: bit for bit --------------------------------------------------


def test_sharded_phases_and_step_are_bit_equal_on_2_1(mesh_21):
    ranks, ref = mesh_21
    for r in ranks:
        for got, want in zip(r[:3], ref[:3]):
            for k in ("losses", "params", "mu", "count", "occs", "binaries"):
                assert bits(got[k], want[k]), k
    assert ranks[0][0]["losses"].shape == (3, 2) and ranks[0][2]["losses"].shape == (2, 2)


def test_sharded_renders_are_bit_equal_on_2_1(mesh_21):
    ranks, ref = mesh_21
    for r in ranks:
        for got, want in zip(r[3:6], ref[3:6]):
            assert set(got) == set(want)
            for k in want:
                if k != "seconds":
                    assert bits(got[k], want[k]), k


# -- units 5-9 on a (2, 2) mesh --------------------------------------------------------------


def _jax_phase_draws(keys, E, R, S, n_data):
    """The port's draws for JAX's shard_map phase on ``keys``: JAX's picks
    and pixels, and each member's jitter as JAX's data shards make it, the
    local [R / n_data, S + 1] draw of the member's key on every shard."""
    draws = []
    for key in keys:
        k_pick, k_fetch, k_occ = jax.random.split(key, 3)
        coin, pick = zip(*[[float(jax.random.uniform(k)) for k in jax.random.split(pk)]
                           for pk in jax.random.split(k_pick, E)])
        fetch = [_fetch_draws(k, R) for k in jax.random.split(k_fetch, E)]
        noise = []
        for k in jax.random.split(k_occ, E):
            _, k_samp = jax.random.split(k)
            local = T(jax.random.uniform(jax.random.split(k_samp)[1], (R // n_data, S + 1)))
            noise.append(torch.cat([local] * n_data))
        draws.append({"coin": T(np.float32(coin)), "pick": T(np.float32(pick)),
                      **{k: torch.stack([f[k] for f in fetch]) for k in ("x", "y", "bkgd")},
                      "noise": torch.stack(noise)})
    return draws


@pytest.fixture(scope="module")
def mesh_22():
    keys = jax.random.split(jax.random.PRNGKey(2), 2)
    draws = _jax_phase_draws(keys, 2, FLAGSHIP.num_rays, FLAGSHIP.max_samples_train, 2)
    todo = _jobs(f32=True, jax_draws=draws)
    return launch(runs.jobs, 2, 2, todo, device="cpu", timeout=300), _unsharded(todo[:-1]), keys


def _on_scale(got, want, rel):
    err = np.abs(got - want).max(axis=-1)
    return np.all(err <= rel * np.maximum(np.abs(want).max(axis=-1), 1e-12))


def test_sharded_flagship_phase_on_2_2(mesh_22):
    ranks, ref, _ = mesh_22
    want = ref[0]
    got = ranks[0][0]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    assert _on_scale(got["params"], want["params"], 1e-5)
    assert _on_scale(got["mu"], want["mu"], 1e-5)
    assert bits(got["count"], want["count"]) and got["step"] == 3
    for r in ranks:  # every rank holds the same members and losses
        assert bits(r[0]["params"], got["params"]) and bits(r[0]["losses"], got["losses"])


def test_sharded_occ_phase_and_step_on_2_2(mesh_22):
    ranks, ref, _ = mesh_22
    for got, want in zip(ranks[0][1:3], ref[1:3]):
        rel = np.abs(got["losses"] - want["losses"]) / np.abs(want["losses"])
        assert rel.max() <= NGP_STEP_TOL[0], rel.max()
        assert _on_scale(got["params"], want["params"], NGP_STEP_TOL[1])
        assert _on_scale(got["mu"], want["mu"], NGP_STEP_TOL[2])
        np.testing.assert_allclose(got["occs"], want["occs"], rtol=1e-5, atol=1e-7)
        assert bits(got["binaries"], want["binaries"])
    assert not bits(ranks[0][1]["params"], _ngp_arrays()["params"])  # the fields trained
    for r in ranks:
        for got, want in zip(r[1:3], ranks[0][1:3]):
            assert all(bits(got[k], want[k]) for k in ("losses", "params", "occs"))


def _ngp_arrays():
    return runs.state_arrays(_ngp_state())


def test_sharded_renders_are_bit_equal_on_2_2(mesh_22):
    ranks, ref, _ = mesh_22
    for r in ranks:
        for got, want in zip(r[3:6], ref[3:6]):
            for k in want:
                if k != "seconds":
                    assert bits(got[k], want[k]), k
    assert ranks[0][4]["rgb"].shape == (2, 3, P, 3)  # 3 views over 2 data ranks


def test_sharded_flagship_phase_matches_jax_shard_map(mesh_22, monkeypatch):
    """JAX's shard_map phase on a (2, 2) mesh of 4 virtual devices, float32
    field, against the port's (2, 2) phase on the same draws, where each
    member's jitter is JAX's: one local draw repeated on both data shards
    (the reference-side divergence, ROADMAP)."""
    from apnerf_tpu.parallel.mesh import make_mesh
    from apnerf_tpu.parallel.sharding import make_shardmap_flagship_phase
    from apnerf_tpu.train import flagship as j_fl
    from apnerf_tpu.train import phase as j_phase
    from apnerf_tpu.train import step as j_step
    from apnerf_tpu.ops import occupancy as j_occ
    from apnerf_tpu.config import PipelineConfig as JaxConfig

    ranks, _, keys = mesh_22
    monkeypatch.setenv("APNERF_FUSED_LOSSGRAD", "0")
    for fn in ("make_spectral_config", "make_prop_config"):
        orig = getattr(j_fl, fn)
        monkeypatch.setattr(j_fl, fn, lambda c, orig=orig: orig(c)._replace(compute_dtype="float32"))
    cfg_j = JaxConfig(**{f.name: getattr(FLAGSHIP, f.name) for f in dataclasses.fields(JaxConfig)})
    members = _flagship_state().members
    trees = [_jax_tree(m) for m in members]
    opt = j_fl.make_optimizer(cfg_j, j_fl.default_spectral_schedule(cfg_j))
    stack = lambda ts: jax.tree.map(lambda *xs: jnp.stack(xs), *ts)  # noqa: E731
    grid = j_occ.init_occ_grid(cfg_j.aabb, cfg_j.main_grid_resolution)
    state = j_step.EnsembleState(params=stack(trees), opt_state=stack([opt.init(t) for t in trees]),
                                 occ=stack([grid] * 2), step=jnp.asarray(0))
    ds = j_ds.RayDataset(True, num_rays=FLAGSHIP.num_rays, num_models=2, width=W, height=H,
                         max_images=N_IMG)
    ds.update_data(*_scene())
    pools, counts = j_phase.pools_from_dataset(ds)
    mesh = make_mesh(n_ens=2, n_data=2, devices=jax.devices()[:4])
    with jax.set_mesh(mesh):
        state, losses = make_shardmap_flagship_phase(cfg_j, mesh)(
            state, ds.images, ds.depths, ds.semantics, ds.camtoworlds, ds.K, pools, counts,
            jnp.asarray(ds.size), keys, jnp.asarray(1e-3), jnp.asarray(False))
    got = ranks[0][-1]
    np.testing.assert_allclose(got["losses"], np.asarray(losses), rtol=1e-5)
    lr = float(t_fl.default_spectral_schedule(FLAGSHIP)(len(keys)))
    sizes = [p.numel() for p in members[0].parameters()]
    names = [n for n, _ in members[0].named_parameters()]
    for m in range(2):
        flat = {".".join(k.key for k in path): np.asarray(v)[m] for path, v in
                jax.tree_util.tree_flatten_with_path(state.params)[0]}
        for name, p in zip(names, np.split(got["params"][m], np.cumsum(sizes)[:-1])):
            ref = np.asarray(flat[name], np.float32).ravel()
            err = np.abs(p - ref).max()
            assert err <= 2e-3 * max(np.abs(ref).max(), 1e-6) + 1e-2 * len(keys) * lr, (name, err)


def test_a_failing_rank_fails_the_launch():
    """A program that raises in its ranks ends the launch with an error
    (nothing falls back), well inside the launch's time limit."""
    import torch.multiprocessing as mp

    todo = [(runs.train_job, dict(cfg=FLAGSHIP, kind="no such job", state=_flagship_state(),
                                  store=_store(FLAGSHIP), n_steps=1))]
    with pytest.raises(mp.ProcessRaisedException, match="unknown train job"):
        launch(runs.jobs, 2, 1, todo, device="cpu", quiet=True, timeout=120)
