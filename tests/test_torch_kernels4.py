"""Host side of the main field's Hopper tile (``apnerf_tpu_torch/ops/cuda/
field_images.py`` and what ``prepare_field`` builds from it): the weight
repacking into tile images against a numpy reference and back, the
shared-memory budgets against the ``.cuh`` layouts, the wrappers'
refusals, and the launch plans. CPU only; the kernels themselves are held
against their plain versions on the card by ``chip_smoke.py``."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from apnerf_tpu_torch.ops.cuda import field_images as fi
from apnerf_tpu_torch.ops.cuda import fused_field_heads as t_ffh
from apnerf_tpu_torch.ops.cuda import fused_field_volrend as t_fvr

CSRC = Path(fi.__file__).resolve().parents[2] / "csrc"
FIELDS = [(3, 15, 29), (2, 15, 29), (3, 7, 5), (2, 3, 1)]  # hidden layers, geo, classes


def _leaves(n_hidden, G, C, seed=0):
    """Seeded f32 leaves of the field the kernels take, as numpy arrays."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in fi.leaf_layout(n_hidden, G, C).shapes]


def _bf16(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _to_image(mat: np.ndarray) -> np.ndarray:
    """``mat [rows, 64]`` → its tile image as a flat array of the same dtype."""
    rows = mat.shape[0]
    r, c = np.arange(rows)[:, None], np.arange(64)[None, :]
    out = np.zeros(rows * 64, dtype=mat.dtype)
    out[fi.img_off(r, c) // 2] = mat
    return out


def _from_image(img: np.ndarray, rows: int) -> np.ndarray:
    """The inverse of ``_to_image``."""
    r, c = np.arange(rows)[:, None], np.arange(64)[None, :]
    return img[fi.img_off(r, c) // 2]


def _ref_image(rows, element):
    """A tile image built the slow way: element(r, c) at byte
    r*128 + ((c//8 ^ r%8) * 16) + (c%8)*2."""
    img = np.zeros(rows * 64, dtype=np.float32)
    for r in range(rows):
        for c in range(64):
            img[(r * 128 + (((c // 8) ^ (r % 8)) * 16) + (c % 8) * 2) // 2] = element(r, c)
    return img


def _at(w, i, j):
    return w[i, j] if 0 <= i < w.shape[0] and 0 <= j < w.shape[1] else 0.0


def _ref_forward(leaves, n_hidden):
    trunk = leaves[2: 2 + 2 * (n_hidden + 1): 2]
    head = leaves[2 + 2 * (n_hidden + 1):][0:6:2]
    semh = leaves[2 + 2 * (n_hidden + 1):][6:12:2]
    out = []
    for l in range(n_hidden):
        for kb in range(4):
            out.append(_ref_image(256, lambda n, k: _at(trunk[l], 64 * kb + k, n)))
    for kb in range(4):
        out.append(_ref_image(16, lambda n, k: _at(trunk[n_hidden], 64 * kb + k, n)))
    out += [_ref_image(64, lambda n, k: _at(head[0], k, n)),
            _ref_image(64, lambda n, k: _at(semh[0], k - 16, n)),
            _ref_image(64, lambda n, k: _at(head[1], k, n)),
            _ref_image(64, lambda n, k: _at(semh[1], k, n)),
            _ref_image(16, lambda n, k: _at(head[2], k, n)),
            _ref_image(64, lambda n, k: _at(semh[2], k, n))]
    return np.concatenate(out)


def _ref_backward(leaves, n_hidden):
    trunk = leaves[2: 2 + 2 * (n_hidden + 1): 2]
    head = leaves[2 + 2 * (n_hidden + 1):][0:6:2]
    semh = leaves[2 + 2 * (n_hidden + 1):][6:12:2]
    out = [_ref_image(64, lambda n, k: _at(head[2], n, k)),
           _ref_image(64, lambda n, k: _at(semh[2], n, k)),
           _ref_image(64, lambda n, k: _at(head[1], n, k)),
           _ref_image(64, lambda n, k: _at(semh[1], n, k)),
           _ref_image(32, lambda n, k: _at(head[0], n, k)),
           _ref_image(32, lambda n, k: _at(semh[0], n - 16, k)),
           _ref_image(256, lambda n, k: _at(trunk[n_hidden], n, k))]
    for l in range(n_hidden - 1, -1, -1):
        for kb in range(4):
            out.append(_ref_image(256, lambda n, k: _at(trunk[l], n, 64 * kb + k)))
    return np.concatenate(out)


def test_image_round_trip_and_offsets():
    """``img_off`` is a bijection of a [rows, 64] tile onto its bytes, rows
    stay 128 bytes apart, and an image built from it reads back."""
    for rows in (16, 32, 64, 256):
        r, c = np.arange(rows)[:, None], np.arange(64)[None, :]
        off = fi.img_off(r, c)
        assert sorted(off.reshape(-1).tolist()) == list(range(0, rows * 128, 2))
        assert (off // 128 == r).all()
        # a 16-byte chunk stays whole: wgmma and the 16-byte stores rely on it
        assert (off[:, 0::8] % 16 == 0).all() and (np.diff(off.reshape(rows, 8, 8), axis=2) == 2).all()
        mat = np.random.default_rng(rows).standard_normal((rows, 64)).astype(np.float32)
        assert np.array_equal(_from_image(_to_image(mat), rows), mat)


@pytest.mark.parametrize("n_hidden,G,C", FIELDS)
def test_weight_images_match_the_reference(n_hidden, G, C):
    """``field_weights`` (what ``prepare_field`` hands the kernels): the
    forward and backward slabs equal images built element by element from
    the bf16 weights, the bias buffer holds every bias at its offset with
    zero padding, and the slab schedules cover the buffers exactly."""
    leaves = _leaves(n_hidden, G, C)
    tensors = [torch.from_numpy(x) for x in leaves]
    w, (fwd, bwd, bias) = t_ffh.field_weights(tensors, torch.device("cpu"), n_hidden, G, C)
    assert fwd.dtype == torch.bfloat16 and bwd.dtype == torch.bfloat16
    assert (w.n_hidden, w.geo, w.n_classes) == (n_hidden, G, C)
    assert w.wfwd == fwd.data_ptr() and w.wbwd == bwd.data_ptr() and w.bias == bias.data_ptr()
    rounded = [_bf16(x) for x in leaves]
    assert np.array_equal(fwd.float().numpy(), _ref_forward(rounded, n_hidden))
    assert np.array_equal(bwd.float().numpy(), _ref_backward(rounded, n_hidden))
    for slabs, buf in ((fi.fwd_slabs(n_hidden), fwd), (fi.bwd_slabs(n_hidden), bwd)):
        assert slabs[0][0] == 0 and all(a[0] + a[1] == b[0] for a, b in zip(slabs, slabs[1:]))
        assert slabs[-1][0] + slabs[-1][1] == buf.numel() * 2
        assert all(size % 16 == 0 and off % 1024 == 0 and size <= fi.SLAB_BYTES
                   for off, size in slabs)
    offs = fi.bias_offsets(n_hidden)
    got = bias.numpy()
    assert got.shape == (offs["total"],)
    biases = leaves[3::2]
    at = [l * fi.H for l in range(n_hidden)] + [offs[k] for k in (
        "trunk_out", "rb0", "rb1", "rb2", "sb0", "sb1", "sb2")]
    used = np.zeros(offs["total"], dtype=bool)
    for o, b in zip(at, biases):
        assert np.array_equal(got[o: o + b.size], b)
        used[o: o + b.size] = True
    assert not got[~used].any()


@pytest.mark.parametrize("n_hidden,G,C", FIELDS[:2])
def test_weight_images_invert(n_hidden, G, C):
    """Every weight comes back from the slabs: the forward image of a trunk
    layer is its transpose by 64-column blocks, the backward image the
    weight itself, and the semantic head's first layer sits at rows 16..."""
    leaves = _leaves(n_hidden, G, C, seed=1)
    tensors = [torch.from_numpy(x) for x in leaves]
    _, (fwd, bwd, _) = t_ffh.field_weights(tensors, torch.device("cpu"), n_hidden, G, C)
    fwd, bwd = fwd.float().numpy(), bwd.float().numpy()
    fs, bs = fi.fwd_slabs(n_hidden), fi.bwd_slabs(n_hidden)
    for l in range(n_hidden):
        w = _bf16(leaves[2 + 2 * l])
        cols = [_from_image(fwd[fs[4 * l + kb][0] // 2:][: 256 * 64], 256).T for kb in range(4)]
        assert np.array_equal(np.concatenate(cols, axis=0), w)
        first = 4 + 4 * (n_hidden - 1 - l)
        rows = [_from_image(bwd[bs[first + kb][0] // 2:][: 256 * 64], 256) for kb in range(4)]
        assert np.array_equal(np.concatenate(rows, axis=1), w)
    sem0 = _bf16(leaves[2 + 2 * (n_hidden + 1) + 6])  # [G, 64]
    img = _from_image(fwd[fs[4 * n_hidden + 1][0] // 2 + 4096:][:4096], 64)  # [n, k]
    assert np.array_equal(img[:, 16: 16 + G], sem0.T) and not img[:, :16].any()
    assert not img[:, 16 + G:].any()
    back = _from_image(bwd[bs[2][0] // 2 + 32 * 64:][: 32 * 64], 32)  # [n - 16, k]
    assert np.array_equal(back[16: 16 + G], sem0) and not back[:16].any()


def _constants(name):
    text = (CSRC / name).read_text()
    return {m.group(1): int(m.group(2))
            for m in re.finditer(r"constexpr int (k\w+) = (\d+);", text)}


def test_shared_memory_budgets_mirror_the_kernels():
    """The Python mirrors of ``fwd_smem``, ``bwd_smem`` and ``dw_smem`` use
    the kernels' own constants, and every kernel of the tile fits one
    block's 232,448 bytes at each trunk depth the wrappers accept."""
    tile, vol = _constants("field_tile.cuh"), _constants("fused_field_volrend.cu")
    assert (tile["kM"], tile["kH"], tile["kHh"], tile["kTOut"], tile["kRgbPad"],
            tile["kCPad"]) == (fi.M, fi.H, fi.HH, fi.T_OUT, fi.RGB_PAD, fi.C_PAD)
    assert (tile["kFwdStages"], vol["kBwdStages"], vol["kDwStages"]) == (
        fi.FWD_STAGES, fi.BWD_STAGES, fi.DW_STAGES)
    assert (tile["kTileRows"], tile["kPassRows"], tile["kAlignSlack"]) == (
        fi.TILE_ROWS, fi.PASS_ROWS, fi.ALIGN_SLACK)
    assert fi.SLAB_BYTES == 256 * 128 and fi.DW_STAGE_BYTES == 6 * fi.IMG_BYTES
    assert fi.MAX_SMEM == 232448
    for n_hidden in (2, 3):
        assert fi.bias_offsets(n_hidden)["total"] == n_hidden * fi.H + 352
        assert fi.n_bias(n_hidden) == n_hidden * 256 + 16 + 4 * 64 + 4 * 128
        fwd = fi.fwd_smem_bytes(n_hidden)
        # ring, two activation buffers, the biases rounded up to 128 bytes, two tiles of
        # coordinates per warpgroup, barriers, slack
        assert fwd == (4 * 32768 + 2 * 32768 + -(-(n_hidden * 256 + 352) * 4 // 128) * 128
                       + 4 * 768 + 64 + 1024)
        assert fwd <= fi.MAX_SMEM
        # the largest staging area (64 rows of 4 + 64 classes, f32) fits the buffer it reuses
        assert 64 * (5 + fi.MAX_CLASSES) * 4 <= 4 * fi.IMG_BYTES
    assert fi.bwd_smem_bytes() == 4 * 32768 + 2 * 32768 + 2 * 768 + 64 + 1024 <= fi.MAX_SMEM
    assert fi.dw_smem_bytes() == 3 * 6 * 8192 + 48 + 1024 <= fi.MAX_SMEM
    # the backward's f32 phase cotangent [64, 128] is exactly one buffer
    assert 64 * fi.M * 4 == 4 * fi.IMG_BYTES


def test_wrappers_refuse_what_the_tile_does_not_take():
    """Widths other than the shipping field's raise before any launch, on
    shapes alone; a tensor that is neither on the CPU nor on a card raises
    on every entry."""
    good = fi.leaf_layout(3, 15, 29).shapes
    assert fi.check_widths("t", good) == (3, 15, 29)
    assert fi.check_widths("t", fi.leaf_layout(2, 4, 64).shapes) == (2, 4, 64)

    def field(M=128, H=256, hh=64, G=15, C=29, n_hidden=3):
        shapes = [(3, M), (M,)]
        widths = [2 * M] + [H] * n_hidden + [1 + G]
        for a, b in zip(widths[:-1], widths[1:]):
            shapes += [(a, b), (b,)]
        for a, b in ((16 + G, hh), (hh, hh), (hh, 3), (G, hh), (hh, hh), (hh, C)):
            shapes += [(a, b), (b,)]
        return shapes

    for bad in (dict(M=64), dict(H=128), dict(hh=32), dict(G=16), dict(C=65)):
        with pytest.raises(ValueError, match="unsupported widths"):
            fi.check_widths("t", field(**bad))
    for n_hidden in (1, 4):
        with pytest.raises(ValueError, match="2 or 3 hidden layers"):
            fi.check_widths("t", field(n_hidden=n_hidden))
    with pytest.raises(ValueError, match="pairs"):
        fi.check_widths("t", good[:-1])
    wrong = list(good)
    wrong[4] = (256, 255)
    with pytest.raises(ValueError, match="leaf 4 has shape"):
        fi.check_widths("t", wrong)

    leaves = [torch.empty(s, device="meta") for s in good]
    with pytest.raises(ValueError, match="unsupported widths"):
        t_ffh.prepare_field("t", [torch.empty(s, device="meta") for s in field(H=128)], "meta")
    with pytest.raises(ValueError, match="must be torch.float32"):
        t_ffh.prepare_field("t", [t.double() for t in leaves], torch.device("meta"))
    meta = lambda *shape: torch.empty(shape, device="meta")
    N = 16
    with pytest.raises(ValueError, match="unsupported device"):
        t_ffh.fused_field_heads(leaves, meta(N, 3), meta(2, 16), 8)
    with pytest.raises(ValueError, match="unsupported device"):
        t_fvr.fused_field_volrend(leaves, meta(N, 3), meta(2, 16), meta(N), meta(N), 8)
    with pytest.raises(ValueError, match="unsupported device"):
        t_fvr.fused_field_volrend_lossgrad(
            leaves, meta(N, 3), meta(2, 16), meta(N), meta(N), meta(2, 3), meta(2), meta(2),
            meta(3), 8)
    for fn in (t_ffh.fused_field_heads, t_ffh.fused_field_heads_bwd, t_fvr.fused_field_volrend,
               t_fvr.fused_field_volrend_bwd, t_fvr.fused_field_volrend_lossgrad):
        assert fn.launches == 0


@pytest.mark.parametrize("n_sm", [132, 114, 8])
def test_field_launch_plan(n_sm):
    """Persistent blocks: one per SM, never more than there are 128-row
    passes; scratch rows are whole passes; together the blocks' strides
    visit every pass once."""
    assert fi.padded_rows(1) == 128 and fi.padded_rows(128) == 128 and fi.padded_rows(129) == 256
    for n_rows in (1, 127, 128, 129, 128 * n_sm - 1, 128 * n_sm, 128 * n_sm + 1, 1 << 20):
        grid = fi.field_grid(n_rows, n_sm)
        n_pass = fi.padded_rows(n_rows) // 128
        assert 1 <= grid <= min(n_sm, n_pass)
        assert grid == n_sm or grid == n_pass
        seen = sorted(p for b in range(grid) for p in range(b, n_pass, grid))
        assert seen == list(range(n_pass))


@pytest.mark.parametrize("n_hidden,n_tiles,n_sm", [(3, 4096, 132), (2, 4096, 132), (3, 2, 132),
                                                    (3, 4096, 16), (2, 37, 114)])
def test_weight_gradient_launch_plan(n_hidden, n_tiles, n_sm):
    """Every weight has its item, in the leaves' order; an item's chunks
    partition the row tiles with none empty; blocks, partials and sums are
    laid end to end; at the train shape the launch is one wave."""
    plan = fi.dw_plan(n_hidden, n_tiles, n_sm)
    items = [row[0] for row in plan.items]
    assert len(items) == 2 * n_hidden + 5 <= 16
    assert [(i.x, i.y) for i in items[: 2 * n_hidden: 2]] == [
        ("enc" if l == 0 else f"h{l - 1}", f"gh{l}") for l in range(n_hidden)]
    assert [(i.x, i.y) for i in items[2 * n_hidden:]] == [
        (f"h{n_hidden - 1}", "gt")] * 2 + [("xs", "g1"), ("hid1", "g2"), ("hid2", "gout")]
    block = p_off = out_off = 0
    for it, chunks, chunk_tiles, first_block, p, o in plan.items:
        assert (first_block, p, o) == (block, p_off, out_off)
        assert chunks >= 1 and (chunks - 1) * chunk_tiles < n_tiles <= chunks * chunk_tiles
        assert it.n in (64, 256) and max(it.x_img) < it.x_imgs
        assert max(it.y_img) + (4 if it.n == 256 else 1) <= it.y_imgs
        block += chunks
        p_off += chunks * 2 * 64 * it.n
        out_off += 2 * 64 * it.n
    assert (plan.n_blocks, plan.partial_floats, plan.out_floats) == (block, p_off, out_off)
    if n_tiles >= n_sm >= 2 * len(items):
        assert n_sm - 2 * len(items) <= plan.n_blocks <= n_sm
    # the sums are the leaves' gradients: two 128-row halves make a trunk matrix
    assert plan.out_floats == n_hidden * 256 * 256 + 256 * 64 + 3 * 2 * 64 * 64
