"""The hash grid table's backward (``ops/cuda/hash_table.py``, kernel
``csrc/hash_table_bwd.cu``) on the CPU, where the wrapper takes its plain
version, ``index_add_``.

The kernel cannot run here, so its summation order is emulated in numpy,
lane by lane and in float32 (``emulate``): the stable sort, the tiles of
sorted positions, each chunk of 32 scanned by segments of equal keys with
the same rounds of adds, the carry from chunk to chunk, the head and tail
slots and the second pass over tiles. Tolerances, each with its reason:
  * the emulation against a float64 sum: every row within
    (5 + tile / 32 + tiles) x 2^-24 x the sum of its terms' magnitudes,
    the bound of a float32 sum whose longest chain of dependent adds is
    that deep (5 scan rounds, a carry a chunk, a head slot a tile);
  * the plain version against ``index_add_``: bit for bit (it is that);
  * JAX's table gradient against the port's with the emulated order in
    place of the plain version: rtol 1e-5 / atol 1e-6, as
    ``tests/test_torch_ngp.py`` holds the plain version (the same sums in
    another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apnerf_tpu.ops import hashgrid as j_hg
from apnerf_tpu_torch.ops import hashgrid as t_hg
from apnerf_tpu_torch.ops.cuda import hash_table
from apnerf_tpu_torch.ops.cuda.hash_table import TILE, hash_table_bwd, n_tiles

U = 2.0 ** -24


def emulate(n_rows, idx, g, tile=TILE):
    """The kernel's two passes in numpy float32, lane by lane."""
    idx, g = np.asarray(idx), np.asarray(g, np.float32)
    M, F = g.shape
    order = np.argsort(idx, kind="stable")
    skey, gs = idx[order].astype(np.int64), g[order]
    out = np.zeros((n_rows, F), np.float32)
    T = -(-M // tile)
    head, tail = np.zeros((T, F), np.float32), np.zeros((T, F), np.float32)
    cont = np.zeros(T, bool)
    lanes = np.arange(32)
    for t in range(T):
        p0, p1 = t * tile, min(t * tile + tile, M)
        first = skey[p0]
        prev_key = skey[p0 - 1] if p0 > 0 else -1
        next_key = skey[p1] if p1 < M else -1
        from_prev = p0 > 0 and prev_key == first
        cont[t] = first == skey[p1 - 1] and from_prev and p1 < M and next_key == first

        def flush(key, v, is_head, is_tail):
            if 0 <= key < n_rows:
                (head[t] if is_head else tail[t] if is_tail else out[key])[:] = v

        have_carry, carry_touch, carry_key, carry = False, False, -1, np.zeros(F, np.float32)
        for c0 in range(p0, p1, 32):
            p = c0 + lanes
            valid = p < p1
            at = np.minimum(p, M - 1)
            k = np.where(valid, skey[at], -1)
            v = np.where(valid[:, None], gs[at], np.float32(0)).astype(np.float32)
            joins = have_carry and k[0] == carry_key
            if have_carry and not joins:
                flush(carry_key, carry, carry_touch and from_prev, False)
            start = np.r_[True, k[1:] != k[:-1]]
            s = np.maximum.accumulate(np.where(start, lanes, 0))
            d = 1
            while d < 32:
                up = np.roll(v, d, axis=0)  # lane l reads lane l - d's value of the round before
                v = np.where((lanes - d >= s)[:, None], v + up, v).astype(np.float32)
                d *= 2
            if joins:
                v[s == 0] = carry + v[s == 0]
            touch = (s == 0) & (c0 == p0 or (joins and carry_touch))
            k_dn = np.r_[k[1:], k[-1]]
            end = valid & ((lanes == 31) | (k_dn != k))
            at_last = p == p1 - 1
            for lane in np.nonzero(end & ~((lanes == 31) & ~at_last))[0]:
                flush(k[lane], v[lane], touch[lane] and from_prev,
                      at_last[lane] and next_key == k[lane])
            have_carry = bool(valid[31] and not at_last[31])
            if have_carry:
                carry_key, carry_touch, carry = k[31], touch[31], v[31].copy()
    for t in range(T):
        p1 = min(t * tile + tile, M)
        key = skey[p1 - 1]
        if p1 >= M or skey[p1] != key or cont[t] or not 0 <= key < n_rows:
            continue
        acc = tail[t].copy()
        for u in range(t + 1, T):
            acc = (acc + head[u]).astype(np.float32)
            if not cont[u]:
                break
        out[key] = acc
    return out


def _witness(n_rows, idx, g):
    """Each row's sum in float64 and the sum of its terms' magnitudes."""
    keep = (idx >= 0) & (idx < n_rows)
    s = np.zeros((n_rows, g.shape[1]))
    a = np.zeros((n_rows, g.shape[1]))
    np.add.at(s, idx[keep], g[keep].astype(np.float64))
    np.add.at(a, idx[keep], np.abs(g[keep]).astype(np.float64))
    return s, a


def _case(kind, M, F, n_rows, seed):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(M, F)).astype(np.float32)
    if kind == "one row":  # one run over every tile
        idx = np.full(M, n_rows // 2)
    elif kind == "few rows":  # runs of hundreds, across tiles
        idx = rng.integers(0, 5, M) * 7
    elif kind == "skewed":  # a few long runs among many short ones, as a coarse level's corners
        idx = np.where(rng.uniform(size=M) < 0.5, rng.integers(0, 3, M), rng.integers(0, n_rows, M))
    elif kind == "distinct":  # runs of one
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


@pytest.mark.parametrize("tile", [64, TILE])
@pytest.mark.parametrize("kind,M,F,n_rows", CASES)
def test_emulated_order_within_its_bound(kind, M, F, n_rows, tile):
    """The kernel's order of adds, at its own tile and at 64 (runs across
    many tiles at these sizes), against the float64 sums."""
    idx, g = _case(kind, M, F, n_rows, M + F)
    got = emulate(n_rows, idx, g, tile)
    s, a = _witness(n_rows, idx, g)
    depth = 5 + tile // 32 + -(-M // tile)
    err = np.abs(got - s)
    assert (err <= depth * U * a).all(), float((err / np.maximum(a, 1e-30)).max())
    # rows that no index reaches stay exactly 0
    assert (got[a == 0] == 0).all()


def test_emulated_order_is_not_index_add():
    """The order differs from the serial one: on long runs the bits do."""
    idx, g = _case("one row", 5000, 4, 64, 0)
    assert not np.array_equal(emulate(64, idx, g), hash_table_bwd(64, torch.as_tensor(idx),
                                                                    torch.as_tensor(g)).numpy())


@pytest.mark.parametrize("kind,M,F,n_rows", CASES[:4])
def test_emulated_order_depends_on_the_sorted_positions_alone(kind, M, F, n_rows):
    """Rows shuffled among other indices' rows, each index's rows kept in
    their order, give the same bits: the sort is stable, so they sort to
    the same sequence."""
    idx, g = _case(kind, M, F, n_rows, 5)
    keys_at = idx[np.random.default_rng(6).permutation(M)]
    rows = np.empty(M, np.int64)
    for key in np.unique(idx):
        rows[keys_at == key] = np.nonzero(idx == key)[0]
    np.testing.assert_array_equal(emulate(n_rows, idx[rows], g[rows]), emulate(n_rows, idx, g))
    assert not np.array_equal(rows, np.arange(M)) or kind == "one row"


@pytest.mark.parametrize("kind,M,F,n_rows", CASES)
def test_plain_version_is_index_add(kind, M, F, n_rows):
    idx, g = _case(kind, M, F, n_rows, 3)
    keep = (idx >= 0) & (idx < n_rows)
    idx, g = idx[keep], g[keep]
    ref = torch.zeros((n_rows, F)).index_add_(0, torch.as_tensor(idx), torch.as_tensor(g))
    got = hash_table_bwd(n_rows, torch.as_tensor(idx), torch.as_tensor(g))
    assert torch.equal(got, ref)


@pytest.mark.parametrize("M", [0, 1, TILE - 1, TILE, TILE + 1, 33_554_432])
def test_tiles(M):
    assert n_tiles(M) * TILE >= M and (n_tiles(M) - 1) * TILE < max(M, 1)


def test_the_tile_is_the_kernels():
    src = (hash_table.build.CSRC / "hash_table_bwd.cu").read_text()
    assert f"constexpr int kTile = {TILE};" in src


def test_other_devices_raise():
    g = torch.zeros((4, 2), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        hash_table_bwd(8, torch.zeros(4, dtype=torch.int32, device="meta"), g)


@pytest.mark.parametrize("n_features", [4, 2])
def test_hash_encode_table_gradient_in_the_kernels_order_matches_jax(n_features, monkeypatch):
    """The port's hash encoding with the kernel's emulated order as its
    table backward, against JAX's VJP: 4 levels of 2^10 entries (two dense,
    two hashed), 300 points, the coarse levels' entries each taking many
    of the 4800 rows."""
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

    def in_kernel_order(n_rows, idx, gg):
        seen.append(idx.shape[0])
        return torch.as_tensor(emulate(n_rows, idx.numpy(), gg.numpy(), 64))

    monkeypatch.setattr(t_hg, "hash_table_bwd", in_kernel_order)
    tt = torch.as_tensor(table).requires_grad_(True)
    (dt_t,) = torch.autograd.grad(t_hg.hash_encode(tt, torch.as_tensor(x), cfg), [tt],
                                  torch.as_tensor(g))
    assert seen == [4 * 300 * 8]
    np.testing.assert_allclose(dt_t.numpy(), np.asarray(dt_j), rtol=1e-5, atol=1e-6)
