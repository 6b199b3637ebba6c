"""The weights kernel's function and its callers on the CPU, against the
JAX package.

* ``fused_render_weights`` (the weights alone, as the JAX function
  returns them) on CPU tensors, its plain version, against the Pallas
  kernel in interpret mode, values and the gradients to sigma, t0 and t1
  at S in {1, 31, 64, 130, 256}: rtol 1e-5 / atol 1e-6 on the weights
  (the Pallas test's own), rtol / atol 1e-5 on the gradients (suffix
  sums over up to 256 terms in two orders).
* The wrapper's choice of the kernels' lane-span instance for every S
  from 1 to 1024, its passes past 1024 up to 8192, and its vector
  accesses.
* The kernels' arithmetic, emulated in float32 numpy lane by lane (each
  lane's span, its serial sums, the warp's shuffle scans in the order
  the kernels take them), against autograd through the plain version:
  max-abs 1e-6 on the weights, 1e-6 of each gradient's max-abs (float32
  sums in another order; numpy's and torch's exp).
* The harness's 100-step ``nerf_training(initial_train=True)`` calls of
  both mappers at a tiny size, call by call: the optimizer counts that
  pick each step's learning rate, the schedule at every count, the
  mapper's learning-rate record, ``state.step``, ``recent_bias`` and the
  pools, counts and dataset size each call hands its train phase (which
  draws every step's image from them with ``_sample_pool_index``):
  exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apnerf_tpu.ops.pallas import fused_render_weights as j_fused_render_weights
from apnerf_tpu_torch.ops.cuda import volrend_cuda
from apnerf_tpu_torch.ops.cuda.volrend_cuda import (
    LANE_SPANS,
    SPAN_SAMPLES,
    fused_render_weights,
    fused_render_weights_plain,
    lane_span,
    span_count,
    vector_access,
)

W_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
EMU_TOL = 1e-6


def T(a):
    return torch.as_tensor(np.array(a))


def _intervals(rng, R, S):
    edges = np.sort(rng.uniform(0.1, 5.0, (R, S + 1)).astype(np.float32), axis=-1)
    sig = rng.uniform(0, 20, (R, S)).astype(np.float32)
    sig[:, -max(S // 8, 1):] = 0.0  # a padded tail, as the march leaves it
    return edges[:, :-1].copy(), edges[:, 1:].copy(), sig


# -- the function against the JAX package -----------------------------------------


@pytest.mark.parametrize("S", [1, 31, 64, 130, 256])
def test_weights_and_gradients_match_jax(S):
    rng = np.random.default_rng(S)
    t0, t1, sig = _intervals(rng, 8, S)
    g = rng.normal(size=sig.shape).astype(np.float32)
    leaves = [T(a).requires_grad_(True) for a in (t0, t1, sig)]
    fused_render_weights.launches = 0
    w = fused_render_weights(*leaves)
    assert isinstance(w, torch.Tensor) and w.shape == (8, S)
    got = torch.autograd.grad(w, leaves, T(g))
    assert fused_render_weights.launches == 0  # CPU: the plain version
    ref, vjp = jax.vjp(j_fused_render_weights, t0, t1, sig)
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(ref), **W_TOL)
    for a, b in zip(got, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)


# -- the wrapper's launch terms ------------------------------------------------------


def test_lane_span_for_every_width():
    for S in range(1, SPAN_SAMPLES + 1):
        v = lane_span(S)
        # the smallest instance whose warp covers the row
        assert v in LANE_SPANS and 32 * v >= S, S
        assert v == LANE_SPANS[0] or 32 * LANE_SPANS[LANE_SPANS.index(v) - 1] < S, S
    assert [lane_span(S) for S in (64, 128, 256, 512)] == [2, 4, 8, 16]
    # past one warp's span the widest instance in passes of SPAN_SAMPLES
    for S in range(SPAN_SAMPLES + 1, 8193):
        assert lane_span(S) == LANE_SPANS[-1] and span_count(S) == -(-S // SPAN_SAMPLES), S
    with pytest.raises(ValueError):
        lane_span(0)


def test_vector_access_needs_aligned_rows_and_pointers():
    assert vector_access(128, 4, [0, 16, 4096])
    assert vector_access(64, 2, [8, 24])  # float2 at a span of 2
    assert vector_access(33, 1, [4, 12])  # one float at a time is always aligned
    assert not vector_access(130, 8, [0, 16])  # rows of 130 floats break 16-B alignment
    assert not vector_access(128, 4, [0, 4])  # a pointer one float past a boundary
    assert not vector_access(33, 2, [0, 8])


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros((2, 4), device="meta")
    with pytest.raises(ValueError):
        fused_render_weights(x, x, x)
    cpu = torch.zeros((2, 4))
    with pytest.raises(ValueError):  # the backward kernel exists for CUDA tensors only
        volrend_cuda.fused_render_weights_bwd(cpu, cpu, cpu, cpu)


# -- the kernels' arithmetic, lane by lane --------------------------------------------


def _lanes(a, V):
    """[R, S] → [R, 32, V]: lane l's span of V samples, zeros past S."""
    R, S = a.shape
    return np.pad(a, ((0, 0), (0, 32 * V - S))).reshape(R, 32, V)


def _lanes_before(v):
    """The warp's exclusive scan: five __shfl_up_sync adds, then a shift."""
    for off in (1, 2, 4, 8, 16):
        u = np.zeros_like(v)
        u[:, off:] = v[:, :-off]
        v = v + u
    out = np.zeros_like(v)
    out[:, 1:] = v[:, :-1]
    return out


def _lanes_after(v):
    """The warp's exclusive suffix scan: five __shfl_down_sync adds, then a shift."""
    for off in (1, 2, 4, 8, 16):
        u = np.zeros_like(v)
        u[:, :-off] = v[:, off:]
        v = v + u
    out = np.zeros_like(v)
    out[:, :-1] = v[:, 1:]
    return out


def _emulate(t0, t1, sig, g=None):
    """The forward kernel → w, or the backward kernel → (dsigma, dt0, dt1),
    in float32 as ``csrc/volrend.cu`` orders its sums."""
    R, S = sig.shape
    V = lane_span(S)
    a, dt, sg = _lanes(t0, V), _lanes(t1, V), _lanes(sig, V)
    dt = dt - a
    s = sg * dt
    total = np.zeros((R, 32), np.float32)
    for j in range(V):
        total = total + s[..., j]
    excl = _lanes_before(total)
    w, gte = np.empty_like(s), np.empty_like(s)
    for j in range(V):
        tr, e = np.exp(-excl), np.exp(-s[..., j])
        excl = excl + s[..., j]
        w[..., j] = tr * (np.float32(1) - e)
        gte[..., j] = tr * e
    if g is None:
        return w.reshape(R, -1)[:, :S]
    gg = _lanes(g, V)
    gw, gte = gg * w, gg * gte
    gw_total = np.zeros((R, 32), np.float32)
    for j in reversed(range(V)):
        gw_total = gw_total + gw[..., j]
    suffix = _lanes_after(gw_total)
    dsig, ddt = np.empty_like(s), np.empty_like(s)
    for j in reversed(range(V)):
        bracket = gte[..., j] - suffix
        suffix = suffix + gw[..., j]
        dsig[..., j] = dt[..., j] * bracket
        ddt[..., j] = sg[..., j] * bracket
    cut = lambda x: x.reshape(R, -1)[:, :S]  # noqa: E731
    return cut(dsig), cut(-ddt), cut(ddt)


@pytest.mark.parametrize("S", [1, 33, 64, 130, 1024])
def test_kernel_arithmetic_matches_the_plain_version(S):
    rng = np.random.default_rng(100 + S)
    edges = np.sort(rng.uniform(0.1, 20.1, (16, S + 1)).astype(np.float32), axis=-1)
    t0, t1 = edges[:, :-1].copy(), edges[:, 1:].copy()
    sig = rng.uniform(0, 2, (16, S)).astype(np.float32)
    g = rng.normal(size=sig.shape).astype(np.float32)
    leaves = [T(a).requires_grad_(True) for a in (sig, t0, t1)]
    w = fused_render_weights_plain(leaves[1], leaves[2], leaves[0])
    np.testing.assert_allclose(_emulate(t0, t1, sig), w.detach().numpy(), rtol=0, atol=EMU_TOL)
    ref = torch.autograd.grad(w, leaves, T(g))
    for got, want in zip(_emulate(t0, t1, sig, g), ref):
        want = want.numpy()
        assert np.abs(got - want).max() <= EMU_TOL * np.abs(want).max()


# -- the harness's train calls, port against JAX ---------------------------------------


TINY = dict(num_rays=32, max_samples_train=8, max_samples_test=8, spectral_neurons=16,
            spectral_freqs_per_level=2, n_levels=4, geo_feat_dim=7, prop_neurons=16,
            num_prop_samples=8)
STEPS, IMG, SEED = 200, 16, 9


def _jax_mapper(tmp, monkeypatch):
    """``scripts/quality_headtohead.build_mapper`` at the same shrink (its
    ensemble initialised under one ``jit``: op by op it takes ~10 s)."""
    from apnerf_tpu.active.mapper import ActiveNeRFMapper
    from apnerf_tpu.config import PipelineConfig
    from apnerf_tpu.sim.fake import FakeSim
    from apnerf_tpu.train import flagship as j_fl
    from apnerf_tpu_torch import quality

    init = j_fl.init_flagship_ensemble
    monkeypatch.setattr(j_fl, "init_flagship_ensemble",
                        lambda key, cfg: jax.jit(lambda k: init(k, cfg))(key))
    sim = FakeSim(aabb=quality.AABB, img_w=IMG, img_h=IMG)
    loc, quat = quality.held_out_poses()
    cfg = PipelineConfig(
        aabb=quality.AABB, num_semantic_classes=sim.num_semantic_classes, n_ensembles=2,
        max_images=64, img_w=IMG, img_h=IMG, training_steps=STEPS, field_type="spectral",
        sampler_type="prop", global_origin=quality.CENTER + (0.0, 0.0, 0.0, 1.0),
        test_loc=loc, test_quat=quat, **TINY,
    )
    m = ActiveNeRFMapper(cfg, sim, save_path=str(tmp), seed=SEED, checkpoint_every=10**9)
    m.save_viz = False
    m.initialization()
    return m


def _record_phase(m, calls, jax_side):
    """Wrap the mapper's train phase: what each call hands it."""
    phase = m.train_phase_fn

    def spy(state, images, depths, semantics, camtoworlds, K, pools, counts, size, *rest,
            **kw):
        n, recent = ((rest[0].shape[0], rest[2]) if jax_side else (rest[0], rest[1]))
        calls.append(dict(pools=np.asarray(pools), counts=np.asarray(counts),
                          size=int(size), steps=int(n), recent_bias=bool(recent)))
        return phase(state, images, depths, semantics, camtoworlds, K, pools, counts, size,
                     *rest, **kw)

    m.train_phase_fn = spy


def _jax_counts(state):
    """Each member's optimizer update count (optax's, stacked over members)."""
    leaves = jax.tree_util.tree_flatten_with_path(state.opt_state)[0]
    counts = [np.asarray(v) for path, v in leaves if "count" in jax.tree_util.keystr(path)]
    assert counts and all(np.array_equal(c, counts[0]) for c in counts)
    return counts[0].tolist()


def test_harness_train_calls_match_jax(tmp_path, monkeypatch):
    from apnerf_tpu.train import flagship as j_fl
    from apnerf_tpu_torch import quality
    from apnerf_tpu_torch.train import flagship as t_fl

    mt, cfg_t = quality.build_mapper("spectral+prop", STEPS, img=IMG, seed=SEED, device="cpu",
                                     overrides=TINY)
    mj = _jax_mapper(tmp_path, monkeypatch)
    assert mj.cfg.training_steps == cfg_t.training_steps == STEPS
    assert mj.steps_per_call == mt.steps_per_call == 100
    rec_t, rec_j = [], []
    _record_phase(mt, rec_t, False)
    _record_phase(mj, rec_j, True)
    for call in range(STEPS // 100):
        before_t = [int(o.count) for o in mt.state.opt]
        before_j = _jax_counts(mj.state)
        mt.nerf_training(100, initial_train=True, evaluate=False)
        mj.nerf_training(100, initial_train=True, evaluate=False)
        after_t = [int(o.count) for o in mt.state.opt]
        after_j = _jax_counts(mj.state)
        # each step's learning rate is the schedule at the member's count
        assert before_t == before_j and after_t == after_j == [100 * (call + 1)] * 2, call
        assert int(mt.state.step) == int(mj.state.step) == 100 * (call + 1)
        np.testing.assert_array_equal(mt.learning_rate_lst, mj.learning_rate_lst)
        a, b = rec_t[-1], rec_j[-1]
        assert (a["size"], a["steps"], a["recent_bias"]) == (b["size"], b["steps"],
                                                              b["recent_bias"]) == (39, 100, False)
        np.testing.assert_array_equal(a["counts"], b["counts"])
        np.testing.assert_array_equal(a["pools"], b["pools"])
    assert len(rec_t) == len(rec_j) == STEPS // 100
    counts = np.arange(STEPS + 1)
    np.testing.assert_array_equal(
        np.asarray([float(t_fl.default_spectral_schedule(cfg_t)(c)) for c in counts]),
        np.asarray(jax.vmap(j_fl.default_spectral_schedule(mj.cfg))(jnp.asarray(counts))))
