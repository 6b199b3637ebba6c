"""The proposal loss's gathers and their fixed-order backward
(``apnerf_tpu_torch/ops/cuda/gather_rows.py``), on the CPU at tiny shapes.

On the card ``gather_rows_bwd`` is a CUDA kernel that sums each row's
cotangents in ascending order without atomics (``csrc/gather_rows.cu``);
here its plain version, ``scatter_add_``, runs. Tolerances:
  * ``gather_rows`` forward against ``torch.gather``, its backward against
    ``scatter_add_`` into zeros and against a numpy emulation of the
    kernel's arithmetic (each bin's float32 sum from 0, list a's terms then
    list b's, each ascending: in a sorted row each run added by its first
    lane from shuffles, chunk by chunk, in an unsorted row each bin's terms
    picked from the whole row): bit for bit;
  * the port's ``prop_loss`` gradient against ``jax.grad`` of the JAX
    package's: rtol 1e-5, atol 1e-6 of the gradient's max-abs (the same
    sums, XLA's transpose of the gather and of the cumsum in its own order);
  * the member steps' and the NGP + proposal trainer's backward calls:
    exact.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apnerf_tpu.models import propnet as j_prop
from apnerf_tpu.ops import volrend as j_vr
from apnerf_tpu_torch.config import PipelineConfig
from apnerf_tpu_torch.data import dataset as t_ds
from apnerf_tpu_torch.models import propnet as t_prop
from apnerf_tpu_torch.ops.cuda import gather_rows as t_gr
from apnerf_tpu_torch.train import examples as t_ex
from apnerf_tpu_torch.train import flagship as t_fl


def T(a):
    return torch.as_tensor(np.array(a))


def _chunk(ks, gs, q0, n_bins):
    """Lane l's query q0 + l of a clamped row: (bins, cotangents); past the
    row's end the bin ``n_bins`` and 0."""
    q = q0 + np.arange(32)
    inside = q < len(ks)
    q = np.minimum(q, len(ks) - 1)
    return np.where(inside, ks[q], n_bins), np.where(inside, gs[q], 0).astype(np.float32)


def _sum_runs(ks, gs, n_bins, o, first):
    """``sum_runs`` of ``csrc/gather_rows.cu`` on one list of one row, lane
    by lane: chunks of 32 queries in groups of 4, each run's terms added in
    order by its first lane (from 0 for list a, else from the output as it
    stood at the group's start), a run through lane 31 carried on → False
    where the list is not sorted."""
    Q, lanes = len(ks), np.arange(32)
    carry, carry_bin = np.float32(0), -2
    for g0 in range(0, Q, 128):
        chunks = [_chunk(ks, gs, g0 + 32 * j, n_bins) for j in range(4)]
        frm = [np.array([o[k] if not first and 0 <= k < n_bins else 0 for k in c[0]], np.float32)
               for c in chunks]
        for j, (k, v) in enumerate(chunks):
            if g0 + 32 * j >= Q:
                break
            prev = np.concatenate([[carry_bin], k[:-1]])
            if np.any(k < prev):
                return False
            if 0 <= carry_bin < n_bins and k[0] != carry_bin:
                o[carry_bin] = carry
            start = (lanes == 0) | (k != prev)
            ends = (lanes == 31) | (k != np.concatenate([k[1:], k[-1:]]))
            length = [int(np.argmax(ends[lane:])) + 1 for lane in lanes]
            s = frm[j].copy()
            if k[0] == carry_bin:
                s[0] = carry
            for lane in np.nonzero(start)[0]:
                for i in range(length[lane]):
                    s[lane] = np.float32(s[lane] + v[lane + i])
                if lane + length[lane] < 32 and 0 <= k[lane] < n_bins:
                    o[k[lane]] = s[lane]
            carry, carry_bin = s[np.nonzero(start)[0].max()], int(k[31])
    if 0 <= carry_bin < n_bins:
        o[carry_bin] = carry
    return True


def kernel_emulation(n_bins, pairs):
    """The arithmetic of ``csrc/gather_rows.cu`` in numpy: a row's output
    zeroed, then list a's runs and list b's (``_sum_runs``) where both lists
    are sorted; else each bin's float32 sum from 0 over list a's terms, then
    list b's, in ascending q. Indices are clamped to [-1, n_bins]: outside
    the row they add nothing."""
    R, Q = pairs[0][0].shape
    out = np.full((R, n_bins), np.nan, np.float32)  # every bin must be written
    for r in range(R):
        o = out[r]
        o[:] = 0
        rows = [(np.clip(idx[r], -1, n_bins), g[r].astype(np.float32)) for g, idx in pairs]
        if all(_sum_runs(ks, gs, n_bins, o, first=i == 0) for i, (ks, gs) in enumerate(rows)):
            continue
        for b in range(n_bins):
            s = np.float32(0)
            for ks, gs in rows:
                for x in gs[ks == b]:
                    s = np.float32(s + x)
            o[b] = s
    return out


def _indices(case, rng, R, Q, K):
    """[R, Q] int64 indices into K bins, as each case names them."""
    if case == "repeated":  # searchsorted of sorted queries: runs of one bin
        edges = np.sort(rng.uniform(0, 1, (R, K)), axis=-1)
        qs = np.sort(rng.uniform(0, 1, (R, Q)) ** 3, axis=-1)
        return np.stack([np.searchsorted(e, x, side="right") - 1 for e, x in zip(edges, qs)]
                        ).clip(0, K - 1)
    if case == "clamped last bins":  # idx_hi_r.clamp(0, S): most queries past the last edge
        idx = np.sort(rng.integers(K // 2, K + 8, (R, Q)), axis=-1)
        return idx.clip(0, K - 1)
    if case == "one bin":
        return np.full((R, Q), rng.integers(0, K), np.int64)
    if case == "unsorted":  # any order, bins visited several times
        return rng.integers(0, K, (R, Q))
    raise ValueError(case)


@pytest.mark.parametrize("n_lists", [1, 2])
@pytest.mark.parametrize("case,Q", [
    ("repeated", 24), ("clamped last bins", 24), ("one bin", 24), ("unsorted", 24),
    ("repeated", 300),  # past the kernel's 128-query tile
])
def test_gather_rows_bits(case, Q, n_lists):
    rng = np.random.default_rng([sum(map(ord, case)), Q, n_lists])
    R, K = 16, 9
    src = rng.normal(size=(R, K)).astype(np.float32)
    idx = [_indices(case, rng, R, Q, K).astype(np.int64) for _ in range(n_lists)]
    # cotangents over six decades, so that the order of a sum shows in its bits
    gs = [(rng.normal(size=(R, Q)) * 10.0 ** rng.uniform(-3, 3, (R, Q))).astype(np.float32)
          for _ in range(n_lists)]
    s = T(src).requires_grad_(True)
    if n_lists == 1:
        outs = (t_gr.gather_rows(s, T(idx[0])),)
    else:
        outs = t_gr.gather_rows_pair(s, *map(T, idx))
    for o, i in zip(outs, idx):
        assert torch.equal(o, torch.gather(T(src), -1, T(i)))
    (d_src,) = torch.autograd.grad(outs, s, [T(g) for g in gs])
    plain = torch.zeros(R, K)
    for g, i in zip(gs, idx):
        plain.scatter_add_(-1, T(i), T(g))
    emulated = kernel_emulation(K, list(zip(gs, idx)))
    assert np.array_equal(d_src.numpy(), plain.numpy())
    assert np.array_equal(emulated, plain.numpy())
    assert t_gr.gather_rows_bwd.launches == 0  # the plain version counts nothing
    if case in ("repeated", "one bin"):
        # the check sees the order: the same terms summed last to first differ
        backwards = kernel_emulation(K, [(g[:, ::-1], i[:, ::-1]) for g, i in zip(gs, idx)])
        assert not np.array_equal(backwards, emulated)


def test_gather_rows_refuses_what_the_kernel_does_not_take():
    g = torch.zeros(4, 6, device="meta")
    idx = torch.zeros(4, 6, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        t_gr.gather_rows_bwd(5, [(g, idx)])
    with pytest.raises(ValueError, match="one shape"):
        t_gr.gather_rows_pair(torch.zeros(4, 5), torch.zeros(4, 6, dtype=torch.int64),
                              torch.zeros(4, 7, dtype=torch.int64))


def _prop_inputs():
    """The inputs of ``tests/test_torch_ops.py::test_propnet_sampling_and_prop_loss``
    (stratified): JAX's proposal levels and final intervals and weights,
    the level weights scaled down."""
    rng = np.random.default_rng(18)
    R = 12
    o = rng.uniform(-0.5, 0.5, (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    near = rng.uniform(0.1, 0.3, R).astype(np.float32)
    far = near + 2.0

    def sig(t0, t1):
        tm = 0.5 * (t0 + t1)
        return 5.0 * jnp.exp(-((tm - 1.0) ** 2) * 4.0)

    t0j, t1j, lvj = j_prop.propnet_sampling(
        jax.random.PRNGKey(6), [sig], [16], 24, o, d, near, far,
        sampling_type="uniform", stratified=True, use_onehot=True,
    )
    wf = j_vr.render_weight_from_density(t0j, t1j, sig(t0j, t1j))[0]
    # the envelope of the same density covers every final weight, so the
    # loss and its gradient are 0 there: the level weights are scaled down
    # by a seeded factor per bin, so that the envelope falls short in places
    scale = rng.uniform(0.2, 1.0, np.asarray(lvj[0][1]).shape).astype(np.float32)
    return [(np.asarray(e), np.asarray(w) * scale) for e, w in lvj], np.asarray(t0j), \
        np.asarray(t1j), np.asarray(wf)


@pytest.mark.parametrize("use_onehot", [True, False])
def test_prop_loss_gradient_matches_jax(use_onehot):
    levels, t0, t1, wf = _prop_inputs()

    def loss_j(ws):
        return j_prop.prop_loss([(e, w) for (e, _), w in zip(levels, ws)], t0, t1, wf,
                                use_onehot=use_onehot)

    grads_j = jax.grad(loss_j)([jnp.asarray(w) for _, w in levels])
    ws = [T(w).requires_grad_(True) for _, w in levels]
    loss_t = t_prop.prop_loss([(T(e), w) for (e, _), w in zip(levels, ws)], T(t0), T(t1), T(wf))
    grads_t = torch.autograd.grad(loss_t, ws)
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j([w for _, w in levels])),
                               rtol=1e-5)
    for gt, gj in zip(grads_t, grads_j):
        gj = np.asarray(gj)
        assert np.abs(gj).max() > 0
        np.testing.assert_allclose(gt.numpy(), gj, rtol=1e-5, atol=1e-6 * np.abs(gj).max())


# -- how often a step runs the backward ----------------------------------------------

R, S, C = 128, 8, 5


def _member_step_inputs():
    cfg = PipelineConfig(
        aabb=(-1.0, -1.0, -1.0, 1.0, 1.0, 1.0), img_w=32, img_h=24, num_rays=R,
        max_samples_train=S, num_prop_samples=8, num_semantic_classes=C, n_ensembles=1,
        max_images=4, n_levels=4, spectral_freqs_per_level=2, base_resolution=4,
        max_resolution=32, spectral_neurons=32, spectral_layers=3, geo_feat_dim=7,
        prop_neurons=16,
    )
    rng = np.random.default_rng(5)
    o = rng.uniform(-2, 2, (R, 3)).astype(np.float32)
    vd = rng.normal(size=(R, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    batch = t_ds.RayBatch(T(o), T(vd), T(rng.uniform(size=(R, 3)).astype(np.float32)),
                          T(rng.uniform(0.1, 3.0, R).astype(np.float32)),
                          T(rng.integers(0, C, R).astype(np.int32)), T(np.ones(3, np.float32)))
    noise = T(rng.uniform(size=(R, S + 1)).astype(np.float32))
    return cfg, batch, noise


def _counting(monkeypatch):
    calls = []
    real = t_gr.gather_rows_bwd

    def counted(n_bins, pairs):
        calls.append((n_bins, [tuple(g.shape) for g, _ in pairs]))
        return real(n_bins, pairs)

    monkeypatch.setattr(t_gr, "gather_rows_bwd", counted)
    return calls


@pytest.mark.parametrize("route", t_fl.ROUTES[:-1])  # every route but `plain`
def test_member_step_runs_one_backward_a_level(route, monkeypatch):
    """Each flagship member step runs one ``gather_rows_bwd``: ``_outer``'s
    two gathers of the proposal level, at [R, S] into Sp + 1 bins (the
    inverse CDF's gathers carry no gradient into the loss: the sampled
    intervals are detached)."""
    cfg, batch, noise = _member_step_inputs()
    state = t_fl.init_flagship_ensemble(cfg, torch.Generator().manual_seed(0))
    core = t_fl.make_flagship_member_core(cfg, route=route)
    real = t_gr.gather_rows_bwd
    calls = _counting(monkeypatch)
    for step in range(2):
        out = core(state.members[0], state.opt[0], batch, step, noise=noise)
        state = state._replace(opt=[out.opt])
        assert calls == [(cfg.num_prop_samples + 1, [(R, S), (R, S)])] * (step + 1), route
    assert not bool(out.skipped) and real.launches == 0  # the plain version counts nothing


def test_prop_trainer_step_runs_two_backwards(monkeypatch):
    """The NGP + proposal trainer's step: the inverse CDF's ``cdf`` gathers
    (its sampled edges carry the proposal field's gradient) and
    ``_outer``'s; the edges' gathers of level 0 read the fixed s grid."""
    state, step = t_ex.make_ngp_prop_trainer(
        (-1.0, -1.0, -1.0, 1.0, 1.0, 1.0), device="cpu", num_samples=16, prop_samples=(32,),
        ngp_kwargs=dict(neurons=32, layers=1, n_levels=4, n_features=2, log2_hashmap_size=10,
                        base_resolution=4, max_resolution=16, geo_feat_dim=7),
        prop_kwargs=dict(n_levels=2, log2_hashmap_size=8, max_resolution=16))
    rng = np.random.default_rng(26)
    n = 16
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    args = (T(rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)), T(d),
            T(rng.uniform(size=(n, 3)).astype(np.float32)), T(np.full(3, 0.5, np.float32)))
    calls = _counting(monkeypatch)
    state, loss, _ = step(copy.copy(state), *args,
                          noises=[T(rng.uniform(size=(n, 17)).astype(np.float32))])
    assert np.isfinite(float(loss))
    assert sorted(calls) == sorted([(33, [(n, 17), (n, 17)]), (33, [(n, 16), (n, 16)])])
