"""The hash grid table's gradient (``ops/cuda/hash_table.py``, kernel
``csrc/hash_table_bwd.cu``) on the CPU, where the wrapper takes its plain
version, ``index_add_`` of the weighted terms.

The kernel cannot run here, so its order of adds is emulated in numpy
float32 (``hash_table_bwd_emulated``, the function ``chip_smoke.py`` holds
the card's bits to): the terms partitioned by bucket in ascending m, each
bucket's segments and chunks, each chunk summed by its tree, each key's
sum chained into the slice chunk after chunk, the segments chained. Tolerances, each with its reason:
  * the emulation against a float64 sum of the same terms: every entry
    within ``order_depth(the largest bucket's terms)`` x 2^-24 x the sum of
    its terms' magnitudes, the bound of a float32 sum in which no term
    passes more dependent roundings than that (the product's own rounding
    counted where there are weights);
  * the plain version against ``index_add_``: bit for bit (it is that);
  * the new autograd Function against autograd through the gather and the
    weighted sum: bit for bit (the same multiplies and sums);
  * JAX's table gradient against the port's with the emulated order in
    place of the plain version: rtol 1e-5 / atol 1e-6, as
    ``tests/test_torch_ngp.py`` holds the plain version (the same sums in
    another order);
  * JAX's gradient in the positions against the port's: rtol 1e-4 / atol
    1e-5 of the largest entry's scale. The chain rule runs through the
    trilinear weights' products and the level's resolution (x 16 to x 128
    here) in each package's own order; float32 rounding there reads a few
    1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apnerf_tpu.ops import hashgrid as j_hg
from apnerf_tpu_torch.ops import hashgrid as t_hg
from apnerf_tpu_torch.ops.cuda import hash_table
from apnerf_tpu_torch.ops.cuda.hash_table import (
    BATCH,
    CHUNK,
    SEGMENT,
    hash_table_bwd,
    hash_table_bwd_emulated,
    hash_table_bwd_plain,
    order_depth,
    plan,
    row_bits,
)

U = 2.0 ** -24


def _witness(n_rows, idx, g, w=None):
    """Each row's sum in float64 and the sum of its terms' magnitudes."""
    idx = np.asarray(idx)
    terms = np.asarray(g, np.float64)
    if w is not None:
        terms = np.repeat(terms, idx.shape[0] // terms.shape[0], axis=0) * np.asarray(w)[:, None]
    keep = (idx >= 0) & (idx < n_rows)
    s = np.zeros((n_rows, terms.shape[1]))
    a = np.zeros((n_rows, terms.shape[1]))
    np.add.at(s, idx[keep], terms[keep])
    np.add.at(a, idx[keep], np.abs(terms[keep]))
    return s, a


def _depth(n_rows, idx, F, weighted):
    keep = (idx >= 0) & (idx < n_rows)
    return order_depth(int(np.bincount(idx[keep] >> row_bits(F)).max()), weighted)


def _within_bound(n_rows, idx, g, w=None):
    got = hash_table_bwd_emulated(n_rows, idx, g, w)
    s, a = _witness(n_rows, idx, g, w)
    err = np.abs(got - s)
    limit = _depth(n_rows, idx, g.shape[1], w is not None) * U * a
    assert (err <= limit).all(), float((err / np.maximum(a, 1e-30)).max())
    # rows that no index reaches stay exactly 0; a zeroed or negated output fails
    assert (got[a == 0] == 0).all()
    assert not (np.abs(s) <= limit).all() and not (np.abs(-got - s) <= limit).all()
    return got


def _case(kind, M, F, n_rows, seed):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(M, F)).astype(np.float32)
    if kind == "one row":  # one key, every chunk one run of its tree
        idx = np.full(M, n_rows // 2)
    elif kind == "few rows":  # keys of hundreds of terms, across chunks
        idx = rng.integers(0, 5, M) * 7
    elif kind == "skewed":  # a few long runs among many short ones, as a coarse level's corners
        idx = np.where(rng.uniform(size=M) < 0.5, rng.integers(0, 3, M), rng.integers(0, n_rows, M))
    elif kind == "distinct":  # a term a key
        idx = rng.permutation(n_rows)[:M]
    elif kind == "out of range":
        idx = rng.integers(-3, n_rows + 3, M)
    else:
        idx = rng.integers(0, n_rows, M)
    return idx.astype(np.int32), g


CASES = [
    ("one row", 5000, 4, 64),
    ("one row", 3 * 64 + 31, 2, 8),
    ("few rows", 4099, 4, 40),
    ("few rows", 640, 1, 40),
    ("skewed", 6000, 4, 3000),
    ("skewed", 2500, 3, 1000),
    ("distinct", 2000, 4, 2048),
    ("uniform", 3333, 8, 500),
    ("uniform", 700, 11, 50),
    ("uniform", 17, 4, 4),
    ("out of range", 1500, 2, 30),
]


@pytest.mark.parametrize("segment", [2048, SEGMENT])
@pytest.mark.parametrize("kind,M,F,n_rows", CASES)
def test_emulated_order_within_its_bound(kind, M, F, n_rows, segment, monkeypatch):
    """The kernel's order of adds, at its own segment and at 2048 (buckets
    split into many segments at these sizes), against the float64 sums."""
    monkeypatch.setattr(hash_table, "SEGMENT", segment)
    idx, g = _case(kind, M, F, n_rows, M + F)
    _within_bound(n_rows, idx, g)


def test_emulated_order_is_not_index_add():
    """The order differs from the serial one: a chunk's tree changes the bits."""
    idx, g = _case("one row", 5000, 4, 64, 0)
    assert not np.array_equal(hash_table_bwd_emulated(64, idx, g),
                              hash_table_bwd(64, torch.as_tensor(idx), torch.as_tensor(g)).numpy())


@pytest.mark.parametrize("kind,M,F,n_rows", CASES[:4])
def test_emulated_order_depends_on_the_sorted_positions_alone(kind, M, F, n_rows):
    """Terms shuffled among other buckets' terms, each bucket's terms kept in
    their order, give the same bits: the partition is stable, so each bucket
    gets the same sequence of terms."""
    idx, g = _case(kind, M, F, n_rows, 5)
    idx = np.where(np.arange(M) % 3 == 0, idx + (3 << row_bits(F)), idx).astype(np.int32)
    n_rows = n_rows + (4 << row_bits(F))
    bucket = idx >> row_bits(F)
    buckets_at = bucket[np.random.default_rng(6).permutation(M)]
    rows = np.empty(M, np.int64)
    for b in np.unique(bucket):
        rows[buckets_at == b] = np.nonzero(bucket == b)[0]
    np.testing.assert_array_equal(hash_table_bwd_emulated(n_rows, idx[rows], g[rows]),
                                  hash_table_bwd_emulated(n_rows, idx, g))
    assert not np.array_equal(rows, np.arange(M))


@pytest.mark.parametrize("kind,M,F,n_rows", CASES)
def test_plain_version_is_index_add(kind, M, F, n_rows):
    idx, g = _case(kind, M, F, n_rows, 3)
    keep = (idx >= 0) & (idx < n_rows)
    idx, g = idx[keep], g[keep]
    ref = torch.zeros((n_rows, F)).index_add_(0, torch.as_tensor(idx), torch.as_tensor(g))
    got = hash_table_bwd(n_rows, torch.as_tensor(idx), torch.as_tensor(g))
    assert torch.equal(got, ref)


@pytest.mark.parametrize("M", [1, BATCH - 1, BATCH, BATCH + 1, 2 ** 21, 33_554_432])
def test_tiles(M):
    """Tiles are whole batches that cover the terms, about one a slot of the
    card; the scratch holds a partial slice for every split bucket."""
    for slots in (264, 396, 1):
        p = plan(M, 4, 8_388_608, slots)
        assert p.tile % BATCH == 0 and p.n_tiles * p.tile >= M > (p.n_tiles - 1) * p.tile
        assert p.n_tiles <= slots or p.tile == BATCH
        assert p.n_groups * hash_table.GROUP >= p.n_tiles
        # a split bucket has more than SEGMENT terms: its segments number < 2 terms / SEGMENT
        assert p.max_slots * SEGMENT >= 2 * M


def test_the_tile_is_the_kernels():
    """The host's mirror of the kernel's constants."""
    src = (hash_table.build.CSRC / "hash_table_bwd.cu").read_text()
    for name, value in (("kThreads", hash_table.THREADS), ("kItems", hash_table.ITEMS),
                        ("kSegment", SEGMENT), ("kSliceFloats", hash_table.SLICE_FLOATS),
                        ("kGroup", hash_table.GROUP),
                        ("kPartItems", hash_table.BATCH_ITEMS)):
        assert f"constexpr int {name} = {value};" in src, name
    assert "constexpr int kPartWarps = 8;" in src and BATCH == 8 * 32 * hash_table.BATCH_ITEMS
    assert "int n_buckets, int one_row" in src and CHUNK == 1024


def test_other_devices_raise():
    g = torch.zeros((4, 2), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        hash_table_bwd(8, torch.zeros(4, dtype=torch.int32, device="meta"), g)


@pytest.mark.parametrize("n_rows,F", [(2 << 13, 2), (2 << 12, 4), (3 << 12, 3)])
def test_bucket_boundary(n_rows, F):
    """Keys either side of a bucket's edge land in their own buckets' slices."""
    edge = 1 << row_bits(F)
    rng = np.random.default_rng(F)
    keys = np.array([edge - 2, edge - 1, edge, edge + 1, 2 * edge - 1])
    idx = keys[rng.integers(0, len(keys), 9000)].astype(np.int32)
    g = rng.normal(size=(9000, F)).astype(np.float32)
    got = _within_bound(n_rows, idx, g)
    assert (got[keys].any(axis=1)).all()


@pytest.mark.parametrize("keys", [1, 3])
def test_a_bucket_split_into_segments(keys):
    """The one-index case scaled down: more than SEGMENT terms on one bucket,
    summed a segment a block and combined in segment order."""
    M = SEGMENT + SEGMENT // 4 + 7
    rng = np.random.default_rng(keys)
    idx = (100 + 9 * rng.integers(0, keys, M)).astype(np.int32)
    g = rng.normal(size=(M, 4)).astype(np.float32)
    _within_bound(1000, idx, g)
    assert order_depth(M) < M // 100  # no serial walk of the run: its roundings a hundredth of it


def test_keys_wrapped_by_the_table():
    """Positions outside the unit cube: a dense level's negative flat index
    wraps once by L·T and is clamped; the partition takes keys by their bits."""
    grid = dict(n_levels=4, n_features=4, log2_table_size=10, base_resolution=4,
                max_resolution=32)
    cfg = t_hg.HashGridConfig(**grid)
    rng = np.random.default_rng(7)
    x = torch.as_tensor(rng.uniform(-0.3, 1.3, (400, 3)).astype(np.float32))
    idx, w = t_hg._corner_indices_and_weights(x, cfg)
    idx, w = idx.reshape(-1).numpy(), w.reshape(-1).numpy()
    level = np.repeat(np.arange(4), 400 * 8)
    assert ((idx // (1 << 10)) != level).any()  # some keys left their level
    g = rng.normal(size=(4 * 400, 4)).astype(np.float32)
    _within_bound(4 << 10, idx, g, w)


@pytest.mark.parametrize("samples_a_cell", [4, 64])
def test_march_like_chunks(samples_a_cell):
    """A march's samples along a ray share their cells' corners: a key's
    terms come back every 8 terms, and a chunk holds few keys (64 samples
    a cell) or some hundreds (4)."""
    rng = np.random.default_rng(samples_a_cell)
    cells = rng.integers(0, 9000, 12288 // samples_a_cell)
    corners = np.array([0, 1, 30, 31, 900, 901, 930, 931])
    idx = (np.repeat(cells, samples_a_cell * 8) + np.tile(corners, 12288)).astype(np.int32)
    g = rng.normal(size=(12288, 4)).astype(np.float32)
    w = rng.uniform(0, 1, idx.shape[0]).astype(np.float32)
    _within_bound(10000, idx, g, w)


@pytest.mark.parametrize("F", [1, 2, 3, 4, 8])
def test_features(F):
    idx, g = _case("skewed", 5000, F, 20000, F)
    _within_bound(20000, idx, g)


@pytest.mark.parametrize("F,K", [(4, 8), (2, 8), (3, 1)])
def test_weighted_form_within_its_bound(F, K):
    """The weighted form, w[m] * g[m // K], against its float64 sum (the
    product's own rounding in the bound), and its plain version against
    index_add_ of the products taken as separate multiplies."""
    rng = np.random.default_rng(F + K)
    M = 6000 * K // K
    idx = np.where(rng.uniform(size=M) < 0.3, rng.integers(0, 4, M),
                   rng.integers(0, 3000, M)).astype(np.int32)
    g = rng.normal(size=(M // K, F)).astype(np.float32)
    w = rng.uniform(0, 1, M).astype(np.float32)
    _within_bound(3000, idx, g, w)
    rows = torch.as_tensor(g).repeat_interleave(K, dim=0) * torch.as_tensor(w)[:, None]
    ref = torch.zeros((3000, F)).index_add_(0, torch.as_tensor(idx), rows)
    got = hash_table_bwd_plain(3000, torch.as_tensor(idx), torch.as_tensor(g), torch.as_tensor(w))
    assert torch.equal(got, ref)


def test_gather_blend_matches_autograd():
    """``_RowGatherInterp``, its forward and both gradients, against
    autograd through the row gather and the weighted sum, bit for bit."""
    grid = dict(n_levels=3, n_features=4, log2_table_size=9, base_resolution=4,
                max_resolution=24)
    cfg = t_hg.HashGridConfig(**grid)
    rng = np.random.default_rng(4)
    table = torch.as_tensor(rng.normal(size=(3 << 9, 4)).astype(np.float32))
    x = torch.as_tensor(rng.uniform(0, 1, (200, 3)).astype(np.float32))
    idx, w = t_hg._corner_indices_and_weights(x, cfg)
    g = torch.as_tensor(rng.normal(size=(3, 200, 4)).astype(np.float32))
    outs = []
    for fused in (True, False):
        tt, ww = table.clone().requires_grad_(True), w.clone().requires_grad_(True)
        if fused:
            out = t_hg._RowGatherInterp.apply(tt, idx.reshape(-1), ww)
        else:
            out = (tt[idx.reshape(-1).long()].view(3, 200, 8, 4) * ww[..., None]).sum(dim=2)
        outs.append((out.detach(), *torch.autograd.grad(out, [tt, ww], g)))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_gather_blend_saves_the_table_only_for_the_weights_gradient():
    """Without the weights' gradient the table is not saved: an in-place
    update between the forward and the backward leaves the table's gradient
    as it was (it reads the cotangent and the weights alone); with it, the
    table is saved and autograd refuses the update."""
    grid = dict(n_levels=2, n_features=4, log2_table_size=8, base_resolution=4,
                max_resolution=16)
    cfg = t_hg.HashGridConfig(**grid)
    rng = np.random.default_rng(5)
    table = torch.as_tensor(rng.normal(size=(2 << 8, 4)).astype(np.float32))
    x = torch.as_tensor(rng.uniform(0, 1, (50, 3)).astype(np.float32))
    idx, w = t_hg._corner_indices_and_weights(x, cfg)
    g = torch.as_tensor(rng.normal(size=(2, 50, 4)).astype(np.float32))
    grads = []
    for update in (False, True):
        tt = table.clone().requires_grad_(True)
        out = t_hg._RowGatherInterp.apply(tt, idx.reshape(-1), w)
        if update:
            with torch.no_grad():
                tt.add_(1.0)
        grads.append(torch.autograd.grad(out, tt, g)[0])
    assert torch.equal(grads[0], grads[1])
    tt, ww = table.clone().requires_grad_(True), w.clone().requires_grad_(True)
    out = t_hg._RowGatherInterp.apply(tt, idx.reshape(-1), ww)
    with torch.no_grad():
        tt.add_(1.0)
    with pytest.raises(RuntimeError, match="inplace"):
        torch.autograd.grad(out, [tt, ww], g)


@pytest.mark.parametrize("n_features", [4, 2])
def test_hash_encode_table_gradient_in_the_kernels_order_matches_jax(n_features, monkeypatch):
    """The port's hash encoding with the kernel's emulated order as its
    table backward, against JAX's VJP: 4 levels of 2^10 entries (two dense,
    two hashed), 300 points, the coarse levels' entries each taking many
    of the 4800 terms."""
    grid = dict(n_levels=4, n_features=n_features, log2_table_size=10, base_resolution=4,
                max_resolution=32)
    cfg = t_hg.HashGridConfig(**grid)
    rng = np.random.default_rng(12)
    table = rng.normal(size=(4, 1 << 10, n_features)).astype(np.float32)
    x = rng.uniform(0, 1, (300, 3)).astype(np.float32)
    g = rng.normal(size=(300, 4 * n_features)).astype(np.float32)
    jcfg = j_hg.HashGridConfig(**grid)
    _, vjp = jax.vjp(lambda t: j_hg.hash_encode(t, jnp.asarray(x), jcfg), jnp.asarray(table))
    (dt_j,) = vjp(jnp.asarray(g))
    seen = []

    def in_kernel_order(n_rows, idx, gg, weights):
        seen.append((idx.shape[0], gg.shape[0]))
        return torch.as_tensor(hash_table_bwd_emulated(n_rows, idx.numpy(), gg.numpy(),
                                                       weights.numpy()))

    monkeypatch.setattr(t_hg, "hash_table_bwd", in_kernel_order)
    tt = torch.as_tensor(table).requires_grad_(True)
    (dt_t,) = torch.autograd.grad(t_hg.hash_encode(tt, torch.as_tensor(x), cfg), [tt],
                                  torch.as_tensor(g))
    assert seen == [(4 * 300 * 8, 4 * 300)]
    np.testing.assert_allclose(dt_t.numpy(), np.asarray(dt_j), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n_features", [4, 2])
def test_hash_encode_position_gradient_matches_jax(n_features):
    """The gradient in the positions (JAX's d_weights: the rows gathered
    again), against ``jax.vjp`` in x."""
    grid = dict(n_levels=4, n_features=n_features, log2_table_size=10, base_resolution=16,
                max_resolution=128)
    cfg = t_hg.HashGridConfig(**grid)
    rng = np.random.default_rng(13)
    table = rng.normal(size=(4, 1 << 10, n_features)).astype(np.float32)
    x = rng.uniform(0.05, 0.95, (300, 3)).astype(np.float32)
    g = rng.normal(size=(300, 4 * n_features)).astype(np.float32)
    jcfg = j_hg.HashGridConfig(**grid)
    _, vjp = jax.vjp(lambda xx: j_hg.hash_encode(jnp.asarray(table), xx, jcfg), jnp.asarray(x))
    (dx_j,) = vjp(jnp.asarray(g))
    xt = torch.as_tensor(x).requires_grad_(True)
    (dx_t,) = torch.autograd.grad(t_hg.hash_encode(torch.as_tensor(table), xt, cfg), [xt],
                                  torch.as_tensor(g))
    dx_j = np.asarray(dx_j)
    np.testing.assert_allclose(dx_t.numpy(), dx_j, rtol=1e-4, atol=1e-5 * np.abs(dx_j).max())
