"""The member core's four autograd train routes (``train/flagship.py``:
``volrend``, ``packed``, ``field``, ``trunk``, and the proposal field's
opt-in kernel route) against the JAX member core on the same route, on the
CPU at a tiny size.

The JAX package picks a route with its environment gates and runs that
route's Pallas kernels in interpret mode; the port takes the route as an
argument and, for CPU tensors, its kernels' plain versions. Both sides get
the same parameters, batch (seeded numpy) and jitter (``jax.random``).
Tolerances:
  * loss and aux in bf16: rtol 1e-2;
  * every gradient leaf, read back from Adam's first moment (g = mu /
    (1 - b1) after one step from zero moments): 5e-2 of the leaf's scale,
    the JAX kernel tests' limit for bf16 gradients;
  * the updated parameters: 5e-2 of each tensor's scale plus 3 learning
    rates, as ``tests/test_torch_train.py`` holds them (an early Adam step
    moves an element by about one learning rate whatever its gradient);
  * the port's five routes against each other in float32: loss rtol 1e-5,
    gradients 1e-4 of each leaf's scale, the same math in other orders.
A route that names a trunk kernel raises for a field the kernels do not
take on any device but the CPU (held with tensors on the ``meta`` device).
"""


import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apnerf_tpu.config import PipelineConfig
from apnerf_tpu.data import dataset as j_ds
from apnerf_tpu.ops import occupancy as j_occ
from apnerf_tpu.train import flagship as j_fl
from apnerf_tpu_torch.data import dataset as t_ds
from apnerf_tpu_torch.models import spectral as t_sp
from apnerf_tpu_torch.ops.cuda import fused_field_heads as t_ffh
from apnerf_tpu_torch.ops.cuda import fused_field_volrend as t_fvr
from apnerf_tpu_torch.ops.cuda import fused_mlp as t_fm
from apnerf_tpu_torch.train import flagship as t_fl

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


# -- the member step on each route ---------------------------------------------------

# the JAX package's gates that pick each route of its member core's loss_fn
# branch (models/spectral.py: use_packed_volrend, use_packed_field,
# _use_fused_field, _trunk_apply)
JAX_GATES = {
    "volrend": dict(APNERF_FUSED_VR="1", APNERF_FUSED_HEADS="0", APNERF_FUSED_FIELD="0"),
    "packed": dict(APNERF_FUSED_VR="0", APNERF_FUSED_HEADS="1", APNERF_FUSED_FIELD="0"),
    "field": dict(APNERF_FUSED_VR="0", APNERF_FUSED_HEADS="0", APNERF_FUSED_FIELD="1"),
    "trunk": dict(APNERF_FUSED_VR="0", APNERF_FUSED_HEADS="0", APNERF_FUSED_FIELD="0",
                  APNERF_FUSED_MLP="1"),
}


def _train_cfg():
    return PipelineConfig(
        aabb=AABB, img_w=32, img_h=24, num_rays=R, max_samples_train=S, num_prop_samples=8,
        num_semantic_classes=C, n_ensembles=1, max_images=4, n_levels=4,
        spectral_freqs_per_level=2, base_resolution=4, max_resolution=32, spectral_neurons=32,
        spectral_layers=3, geo_feat_dim=7, prop_neurons=16,
    )


def _batch_arrays():
    rng = np.random.default_rng(5)
    o = rng.uniform(-2, 2, (R, 3)).astype(np.float32)
    vd = rng.normal(size=(R, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    return (o, vd, rng.uniform(size=(R, 3)).astype(np.float32),
            rng.uniform(0.1, 3.0, R).astype(np.float32),
            rng.integers(0, C, R).astype(np.int32), np.ones(3, np.float32))


def _noise(k_occ):
    """The stratified draw of the member core's proposal sampling."""
    _, k_samp = jax.random.split(k_occ)
    return T(jax.random.uniform(jax.random.split(k_samp)[1], (R, S + 1)))


def _jax_member_state(cfg, member):
    tree = {}
    for name, v in member.state_dict().items():
        *path, leaf = name.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(v.numpy())
    opt = j_fl.make_optimizer(cfg, j_fl.default_spectral_schedule(cfg))
    return tree, opt.init(tree), j_occ.init_occ_grid(cfg.aabb, cfg.main_grid_resolution)


def _first_moment(opt_state):
    """The Adam first moment tree of an optax state."""
    for s in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(s, "mu"):
            return s.mu
    raise AssertionError("no Adam state")


@pytest.mark.parametrize("route,fused_prop", [
    ("volrend", False), ("packed", False), ("field", False), ("trunk", False), ("field", True),
])
def test_member_step_on_route_matches_jax(route, fused_prop, monkeypatch):
    """One member step of the port on ``route`` against the JAX member core
    on the same route (its Pallas kernels in interpret mode): the same
    parameters, batch and jitter."""
    monkeypatch.setenv("APNERF_FUSED_LOSSGRAD", "0")
    for k, v in JAX_GATES[route].items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("APNERF_FUSED_PROP", "1" if fused_prop else "0")
    cfg = _train_cfg()
    state_t = t_fl.init_flagship_ensemble(cfg, torch.Generator().manual_seed(0))
    member = state_t.members[0]
    params_j, opt_j, occ_j = _jax_member_state(cfg, member)
    arrays = _batch_arrays()
    k_occ = jax.random.PRNGKey(6)
    # not jitted: the CPU runtime refuses some of the interpreted kernels'
    # bf16 products inside a compiled program
    out_j = j_fl.make_flagship_member_core(cfg)(
        params_j, opt_j, occ_j, j_ds.RayBatch(*map(jnp.asarray, arrays)), k_occ,
        jnp.asarray(0), jnp.asarray(1e-3),
    )
    out_t = t_fl.make_flagship_member_core(cfg, route=route, fused_prop=fused_prop)(
        member, state_t.opt[0], t_ds.RayBatch(*map(T, arrays)), 0, noise=_noise(k_occ))
    assert no_launches()
    for a, b in zip(out_t[1:6], out_j[3:8]):  # loss, the three terms, n_samples
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-2)
    assert not bool(out_t.skipped) and not bool(out_j[8]) and int(out_t.opt.count) == 1
    # every gradient leaf, from the first moments after one step from zero
    mu_j = {
        ".".join(k.key for k in path): np.asarray(v)
        for path, v in jax.tree_util.tree_flatten_with_path(_first_moment(out_j[1]))[0]
    }
    sizes = [p.numel() for p in member.parameters()]
    for (name, p), mu in zip(member.named_parameters(), torch.split(out_t.opt.mu, sizes)):
        on_scale(mu.reshape(p.shape) / 0.1, mu_j[name] / 0.1, 5e-2, name)
    # the Adam update
    lr = float(t_fl.default_spectral_schedule(cfg)(1))
    new_j = {
        ".".join(k.key for k in path): np.asarray(v, np.float32)
        for path, v in jax.tree_util.tree_flatten_with_path(out_j[0])[0]
    }
    for name, p in member.named_parameters():
        err = np.abs(p.detach().numpy() - new_j[name]).max()
        assert err <= 5e-2 * max(np.abs(new_j[name]).max(), 1e-6) + 3.0 * lr, (name, err)


def test_routes_agree_in_float32(monkeypatch):
    """All five routes of the port take the same step from the same member
    on one batch with a float32 field: the same math in other orders."""
    for fn in ("make_spectral_config", "make_prop_config"):
        orig = getattr(t_fl, fn)
        monkeypatch.setattr(
            t_fl, fn, lambda c, orig=orig: orig(c)._replace(compute_dtype="float32"))
    cfg = _train_cfg()
    state = t_fl.init_flagship_ensemble(cfg, torch.Generator().manual_seed(3))
    arrays = _batch_arrays()
    noise = _noise(jax.random.PRNGKey(2))
    outs = {}
    for route in t_fl.ROUTES:
        member = copy.deepcopy(state.members[0])
        outs[route] = t_fl.make_flagship_member_core(cfg, route=route)(
            member, state.opt[0], t_ds.RayBatch(*map(T, arrays)), 0, noise=noise)
    sizes = [p.numel() for p in state.members[0].parameters()]
    ref = outs["field"]
    for route, out in outs.items():
        for a, b in zip(out[1:6], ref[1:6]):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, err_msg=route)
        for (name, _), a, b in zip(state.members[0].named_parameters(),
                                   torch.split(out.opt.mu, sizes), torch.split(ref.opt.mu, sizes)):
            on_scale(a, b.numpy(), 1e-4, f"{route} {name}")
    with pytest.raises(ValueError, match="unknown train route"):
        t_fl.make_flagship_member_core(cfg, route="fastest")


@pytest.mark.parametrize("why", ["float32", "depth"])
def test_kernel_routes_refuse_a_field_off_the_cpu(why):
    """A route that names a trunk kernel never becomes the plain chain off
    the CPU: a field the kernels do not take (f32, or a trunk of another
    depth) raises for a tensor on any other device, on the field route, the
    MLP route and the proposal field's kernel route. The same field on the
    CPU runs the plain chain, and the proposal field's default, which names
    no kernel, runs it anywhere."""
    if why == "float32":
        s_cfg = t_sp.SpectralConfig(aabb=AABB, neurons=32, layers=3, n_levels=4,
                                    freqs_per_level=2, geo_feat_dim=7, compute_dtype="float32")
        p_cfg = t_sp.SpectralDensityConfig(aabb=AABB, neurons=16, compute_dtype="float32")
    else:
        s_cfg = t_sp.SpectralConfig(aabb=AABB, neurons=32, layers=4, n_levels=4,
                                    freqs_per_level=2, geo_feat_dim=7)
        p_cfg = t_sp.SpectralDensityConfig(aabb=AABB, neurons=16, layers=1)
    g = torch.Generator().manual_seed(0)
    main, prop = t_sp.init_spectral(s_cfg, g), t_sp.init_spectral_density(p_cfg, g)
    off_cpu = torch.empty((4, 3), device="meta")
    for trunk in ("field", "mlp"):
        with pytest.raises(ValueError, match="bfloat16 field with 2 or 3 hidden layers"):
            t_sp.query_density(main, s_cfg, off_cpu, trunk=trunk)
        assert t_sp.query_density(main, s_cfg, torch.zeros(4, 3), trunk=trunk).shape == (4, 1)
    with pytest.raises(ValueError, match="bfloat16 field with 2 or 3 hidden layers"):
        t_sp.query_density_field(prop, p_cfg, off_cpu, fused=True)
    assert t_sp.query_density_field(prop, p_cfg, torch.zeros(4, 3), fused=True).shape == (4, 1)
    prop_meta = t_sp.init_spectral_density(p_cfg, g).to("meta")
    assert t_sp.query_density_field(prop_meta, p_cfg, off_cpu).shape == (4, 1)
    assert no_launches()
