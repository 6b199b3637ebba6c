"""Host side of the field's Hopper tile (``apnerf_tpu_torch/ops/cuda/
field_images.py`` and what ``prepare_field`` builds from it), at each of
the tile's nine (M, H) instances: the weight repacking into tile images
against a numpy reference and back, for the whole field and for the trunk
alone (the trunk kernels' backwards), the shared-memory budgets against
the ``.cuh`` layouts, the wrappers' refusals, and the launch plans. CPU
only; the kernels themselves are held against their plain versions on the
card by ``chip_smoke.py``."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from apnerf_tpu_torch.ops.cuda import field_images as fi
from apnerf_tpu_torch.ops.cuda import fused_field_heads as t_ffh
from apnerf_tpu_torch.ops.cuda import fused_field_volrend as t_fvr
from apnerf_tpu_torch.ops.cuda import fused_mlp as t_fm

CSRC = Path(fi.__file__).resolve().parents[2] / "csrc"
# (M, H, hidden layers, geo, classes): the shipping field at its depths and
# narrow heads' widths, then every other instance once
FIELDS = [(128, 256, 3, 15, 29), (128, 256, 2, 15, 29), (128, 256, 3, 7, 5),
          (128, 256, 2, 3, 1)] + [
    (m, h, 2 + (i % 2), (7, 15, 1)[i % 3], (29, 5, 64)[i % 3])
    for i, (m, h) in enumerate(w for w in fi.WIDTHS if w != (128, 256))]


def _leaves(shapes, seed=0):
    """Seeded f32 leaves of these shapes, as numpy arrays."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


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


def _ref_trunk(trunk, M, H, heads):
    """The trunk's forward and backward images, element by element."""
    nh = len(trunk) - 1
    fwd, bwd = [], [_ref_image(H, lambda n, k: _at(trunk[nh], n, k))]
    for l in range(nh):
        for kb in range((2 * M if l == 0 else H) // 64):
            fwd.append(_ref_image(H, lambda n, k: _at(trunk[l], 64 * kb + k, n)))
    if heads:
        for kb in range(H // 64):
            fwd.append(_ref_image(16, lambda n, k: _at(trunk[nh], 64 * kb + k, n)))
    for l in range(nh - 1, 0, -1):
        for kb in range(H // 64):
            bwd.append(_ref_image(H, lambda n, k: _at(trunk[l], n, 64 * kb + k)))
    for kb in range(H // 64):
        bwd.append(_ref_image(2 * M, lambda n, k: _at(trunk[0], n, 64 * kb + k)))
    return fwd, bwd


def _ref_field(leaves, M, H, n_hidden):
    trunk = leaves[2: 2 + 2 * (n_hidden + 1): 2]
    head = leaves[2 + 2 * (n_hidden + 1):][0:6:2]
    semh = leaves[2 + 2 * (n_hidden + 1):][6:12:2]
    hh = H // 4
    fwd, bwd_trunk = _ref_trunk(trunk, M, H, heads=True)
    fwd += [_ref_image(hh, lambda n, k: _at(head[0], k, n)),
            _ref_image(hh, lambda n, k: _at(semh[0], k - 16, n)),
            _ref_image(hh, lambda n, k: _at(head[1], k, n)),
            _ref_image(hh, lambda n, k: _at(semh[1], k, n)),
            _ref_image(16, lambda n, k: _at(head[2], k, n)),
            _ref_image(64, lambda n, k: _at(semh[2], k, n))]
    bwd = [_ref_image(hh, lambda n, k: _at(head[2], n, k)),
           _ref_image(hh, lambda n, k: _at(semh[2], n, k)),
           _ref_image(hh, lambda n, k: _at(head[1], n, k)),
           _ref_image(hh, lambda n, k: _at(semh[1], n, k)),
           _ref_image(32, lambda n, k: _at(head[0], n, k)),
           _ref_image(32, lambda n, k: _at(semh[0], n - 16, k))] + bwd_trunk
    return np.concatenate(fwd), np.concatenate(bwd)


def _check_slabs(slabs, buf):
    assert slabs[0][0] == 0 and all(a[0] + a[1] == b[0] for a, b in zip(slabs, slabs[1:]))
    assert slabs[-1][0] + slabs[-1][1] == buf.numel() * 2
    assert all(size % 16 == 0 and off % 1024 == 0 for off, size in slabs)


@pytest.mark.parametrize("rows", [16, 32, 64, 128, 256])
def test_image_round_trip_and_offsets(rows):
    """``img_off`` is a bijection of a [rows, 64] tile onto its bytes, rows
    stay 128 bytes apart, and an image built from it reads back."""
    r, c = np.arange(rows)[:, None], np.arange(64)[None, :]
    off = fi.img_off(r, c)
    assert sorted(off.reshape(-1).tolist()) == list(range(0, rows * 128, 2))
    assert (off // 128 == r).all()
    # a 16-byte chunk stays whole: wgmma and the 16-byte stores rely on it
    assert (off[:, 0::8] % 16 == 0).all() and (np.diff(off.reshape(rows, 8, 8), axis=2) == 2).all()
    mat = np.random.default_rng(rows).standard_normal((rows, 64)).astype(np.float32)
    assert np.array_equal(_from_image(_to_image(mat), rows), mat)
    if rows >= 128:
        # a 64-row block of a taller image is an image itself (the kernels
        # address the rows of a [2M, 64] or [H, 64] slab that way)
        lower = _from_image(_to_image(mat)[64 * 64:], 64)
        assert np.array_equal(lower, mat[64:128])


@pytest.mark.parametrize("M,H,n_hidden,G,C", FIELDS)
def test_weight_images_match_the_reference(M, H, n_hidden, G, C):
    """``field_weights`` (what ``prepare_field`` hands the kernels): the
    forward and backward slabs equal images built element by element from
    the bf16 weights, the bias buffer holds every bias at its offset with
    zero padding, and the slab schedules cover the buffers exactly, every
    slab in one ring slot."""
    leaves = _leaves(fi.leaf_layout(M, H, n_hidden, G, C).shapes)
    tensors = [torch.from_numpy(x) for x in leaves]
    w, (fwd, bwd, bias) = t_ffh.field_weights(tensors, torch.device("cpu"), M, H, n_hidden, G, C)
    assert fwd.dtype == torch.bfloat16 and bwd.dtype == torch.bfloat16
    assert (w.tile_m, w.tile_h, w.n_hidden, w.geo, w.n_classes) == (M, H, n_hidden, G, C)
    assert w.wfwd == fwd.data_ptr() and w.wbwd == bwd.data_ptr() and w.bias == bias.data_ptr()
    ref_f, ref_b = _ref_field([_bf16(x) for x in leaves], M, H, n_hidden)
    assert np.array_equal(fwd.float().numpy(), ref_f)
    assert np.array_equal(bwd.float().numpy(), ref_b)
    fs, bs = fi.fwd_slabs(M, H, n_hidden), fi.bwd_slabs(M, H, n_hidden)
    _check_slabs(fs, fwd)
    _check_slabs(bs, bwd)
    assert max(size for _, size in fs) <= fi.fwd_slot_bytes(H)
    assert max(size for _, size in bs) <= fi.bwd_slot_bytes(M, H)
    offs = fi.bias_offsets(H, n_hidden)
    got = bias.numpy()
    assert got.shape == (offs["total"],)
    biases = leaves[3::2]
    at = [l * H for l in range(n_hidden)] + [offs[k] for k in (
        "trunk_out", "rb0", "rb1", "rb2", "sb0", "sb1", "sb2")]
    used = np.zeros(offs["total"], dtype=bool)
    for o, b in zip(at, biases):
        assert np.array_equal(got[o: o + b.size], b)
        used[o: o + b.size] = True
    assert not got[~used].any()


# (input width, the encode's frequencies or 0 for an input x, H, hidden
# layers, output): the trunk kernels' backwards on the tile
TRUNKS = [(256, 128, 256, 3, 16), (64, 32, 64, 2, 1), (128, 64, 128, 3, 8), (256, 0, 256, 3, 16),
          (48, 0, 64, 2, 1), (160, 0, 128, 2, 16), (64, 0, 256, 3, 7)]


@pytest.mark.parametrize("din,m,H,n_hidden,out", TRUNKS)
def test_trunk_images_match_the_reference(din, m, H, n_hidden, out):
    """The trunk alone, as the trunk kernels' backwards repack it: its
    slabs equal the reference images (the first layer's zero past the
    input's width, up to the instance's 2M), its biases sit where the whole
    field's do, and its schedules have no head slab."""
    shapes = fi.trunk_layout(din, H, n_hidden, out).shapes
    assert fi.check_trunk("t", shapes, m) == (din, m or min(x for x in fi.M_SET if 2 * x >= din),
                                              H, n_hidden, out)
    M = fi.check_trunk("t", shapes, m)[1]
    leaves = _leaves(shapes, seed=3)
    fwd, bwd, bias = t_ffh.repack([torch.from_numpy(x) for x in leaves], torch.device("cpu"),
                                  ("trunk", din, M, H, n_hidden, out))
    ref_f, ref_b = _ref_trunk([_bf16(x) for x in leaves[0::2]], M, H, heads=False)
    assert np.array_equal(fwd.float().numpy(), np.concatenate(ref_f))
    assert np.array_equal(bwd.float().numpy(), np.concatenate(ref_b))
    fs, bs = fi.fwd_slabs(M, H, n_hidden, heads=False), fi.bwd_slabs(M, H, n_hidden, heads=False)
    _check_slabs(fs, fwd)
    _check_slabs(bs, bwd)
    # the trunk's schedules are the whole field's less the heads' slabs
    full_b = fi.bwd_slabs(M, H, n_hidden)
    skip = full_b[3][0]
    assert [(o + skip, b) for o, b in bs] == full_b[3:]
    assert fs == fi.fwd_slabs(M, H, n_hidden)[: len(fs)]
    got = bias.numpy()
    offs = fi.bias_offsets(H, n_hidden)
    for l in range(n_hidden):
        assert np.array_equal(got[l * H: (l + 1) * H], leaves[2 * l + 1])
    assert np.array_equal(got[offs["trunk_out"]: offs["trunk_out"] + out], leaves[-1])
    assert not got[offs["trunk_out"] + out:].any()


@pytest.mark.parametrize("M,H,n_hidden,G,C", FIELDS[:2] + FIELDS[4::3])
def test_weight_images_invert(M, H, n_hidden, G, C):
    """Every weight comes back from the slabs: the forward image of a trunk
    layer is its transpose by 64-column blocks, the backward image the
    weight itself, and the semantic head's first layer sits at rows 16..."""
    leaves = _leaves(fi.leaf_layout(M, H, n_hidden, G, C).shapes, seed=1)
    tensors = [torch.from_numpy(x) for x in leaves]
    _, (fwd, bwd, _) = t_ffh.field_weights(tensors, torch.device("cpu"), M, H, n_hidden, G, C)
    fwd, bwd = fwd.float().numpy(), bwd.float().numpy()
    fs, bs = fi.fwd_slabs(M, H, n_hidden), fi.bwd_slabs(M, H, n_hidden)
    hh = H // 4
    first_fwd = 0
    for l in range(n_hidden):
        w = _bf16(leaves[2 + 2 * l])
        n_kb = (2 * M if l == 0 else H) // 64
        cols = [_from_image(fwd[fs[first_fwd + kb][0] // 2:][: H * 64], H).T for kb in range(n_kb)]
        assert np.array_equal(np.concatenate(cols, axis=0), w)
        first_fwd += n_kb
        # the backward walks the hidden layers downwards, the first layer last
        first = 4 + (n_hidden - 1 - l) * H // 64
        rows = w.shape[0]
        back = [_from_image(bwd[bs[first + kb][0] // 2:][: rows * 64], rows) for kb in range(H // 64)]
        assert np.array_equal(np.concatenate(back, axis=1), w)
    sem0 = _bf16(leaves[2 + 2 * (n_hidden + 1) + 6])  # [G, hh]
    img = _from_image(fwd[fs[first_fwd + 1][0] // 2 + hh * 64:][: hh * 64], hh)  # [n, k]
    assert np.array_equal(img[:, 16: 16 + G], sem0.T) and not img[:, :16].any()
    assert not img[:, 16 + G:].any()
    back = _from_image(bwd[bs[2][0] // 2 + 32 * 64:][: 32 * 64], 32)  # [n - 16, k]
    assert np.array_equal(back[16: 16 + G, :hh], sem0) and not back[:16].any()


def _constants(name):
    text = (CSRC / name).read_text()
    return {m.group(1): int(m.group(2))
            for m in re.finditer(r"constexpr int (k\w+) = (\d+);", text)}


@pytest.mark.parametrize("M,H", fi.WIDTHS)
def test_shared_memory_budgets_mirror_the_kernels(M, H):
    """The Python mirrors of ``fwd_smem``, ``bwd_smem`` and ``dw_smem`` use
    the kernels' own constants, the instances are the kernels' own list, and
    every kernel of the tile fits one block's 232,448 bytes at each trunk
    depth the wrappers accept."""
    tile, vol = _constants("field_tile.cuh"), _constants("fused_field_volrend.cu")
    assert (tile["kShw"], tile["kTOut"], tile["kRgbPad"], tile["kCPad"]) == (
        fi.SHW, fi.T_OUT, fi.RGB_PAD, fi.C_PAD)
    assert (tile["kFwdStages"], vol["kBwdStages"], vol["kDwStages"]) == (
        fi.FWD_STAGES, fi.BWD_STAGES, fi.DW_STAGES)
    assert (tile["kTileRows"], tile["kPassRows"], tile["kAlignSlack"]) == (
        fi.TILE_ROWS, fi.PASS_ROWS, fi.ALIGN_SLACK)
    text = (CSRC / "field_tile.cuh").read_text()
    listed = text[text.index("#define APNERF_TILE_WIDTHS"):].split("\n\n")[0]
    assert tuple((int(a), int(b)) for a, b in re.findall(r"X\((\d+), (\d+)\)", listed)) == fi.WIDTHS
    assert fi.ACT_BYTES == 4 * fi.IMG_BYTES and fi.DW_STAGE_BYTES == 6 * fi.IMG_BYTES
    assert fi.MAX_SMEM == 232448
    hh = H // 4
    for n_hidden in (2, 3):
        assert fi.bias_offsets(H, n_hidden)["total"] == n_hidden * H + 16 + 4 * hh + 16 + 64
        assert fi.n_bias(M, H, n_hidden) == n_hidden * H + 16 + 4 * hh + 4 * M
        fwd = fi.fwd_smem_bytes(H, n_hidden)
        # ring, two activation buffers, the biases rounded up to 128 bytes, two tiles of
        # coordinates per warpgroup, barriers, slack
        assert fwd == (4 * max(H * 128, 80 * 128) + 2 * 32768
                       + -(-(n_hidden * H + H + 96) * 4 // 128) * 128 + 4 * 768 + 64 + 1024)
        assert fwd <= fi.MAX_SMEM
    # the largest staging area (64 rows of 4 + 64 classes, f32) and the
    # backward's f32 phase cotangent [64, M] fit the buffer they reuse
    assert 64 * (5 + fi.MAX_CLASSES) * 4 <= fi.ACT_BYTES and 64 * M * 4 <= fi.ACT_BYTES
    # a buffer holds the encoding, a hidden activation, and the heads' images 0..3
    assert 2 * M // 64 <= 4 and H // 64 <= 4
    bwd = fi.bwd_smem_bytes(M, H)
    assert bwd == 4 * max(H, 2 * M) * 128 + 2 * 32768 + 2 * 768 + 64 + 1024 <= fi.MAX_SMEM
    assert fi.dw_smem_bytes() == 3 * 6 * 8192 + 48 + 1024 <= fi.MAX_SMEM


def _field(M=128, H=256, hh=None, G=15, C=29, n_hidden=3):
    hh = H // 4 if hh is None else hh
    shapes = [(3, M), (M,)]
    widths = [2 * M] + [H] * n_hidden + [1 + G]
    for a, b in zip(widths[:-1], widths[1:]):
        shapes += [(a, b), (b,)]
    for a, b in ((16 + G, hh), (hh, hh), (hh, 3), (G, hh), (hh, hh), (hh, C)):
        shapes += [(a, b), (b,)]
    return shapes


def test_wrappers_refuse_what_the_tile_does_not_take():
    """The nine (M, H) pairs with heads H / 4 go; widths past the set's
    edges (M = 256, H = 512, heads other than H / 4, geo 16, classes 65)
    and between its members (M = 96, H = 96) raise before any launch, on
    shapes alone, with a message that names the set; a tensor that is
    neither on the CPU nor on a card raises on every entry."""
    good = fi.leaf_layout(128, 256, 3, 15, 29).shapes
    assert fi.check_widths("t", good) == (128, 256, 3, 15, 29)
    assert fi.check_widths("t", fi.leaf_layout(128, 256, 2, 4, 64).shapes) == (128, 256, 2, 4, 64)
    for m, h in fi.WIDTHS:
        assert fi.check_widths("t", _field(M=m, H=h, G=1, C=1)) == (m, h, 3, 1, 1)

    for bad in (dict(M=256), dict(H=512), dict(hh=32), dict(H=128, hh=64), dict(G=16),
                dict(C=65), dict(M=96), dict(H=96)):
        with pytest.raises(ValueError, match=r"unsupported widths.*M in \(32, 64, 128\), H in "
                                             r"\(64, 128, 256\), heads H / 4"):
            fi.check_widths("t", _field(**bad))
    for n_hidden in (1, 4):
        with pytest.raises(ValueError, match="2 or 3 hidden layers"):
            fi.check_widths("t", _field(n_hidden=n_hidden))
    with pytest.raises(ValueError, match="pairs"):
        fi.check_widths("t", good[:-1])
    wrong = list(good)
    wrong[4] = (256, 255)
    with pytest.raises(ValueError, match="leaf 4 has shape"):
        fi.check_widths("t", wrong)
    # the trunk alone: the encode's M, an input x, H, the output's width
    trunk = lambda din, H=256, out=16, nh=3: list(fi.trunk_layout(din, H, nh, out).shapes)
    for shapes, m in ((trunk(512), 256), (trunk(24), 12), (trunk(272), 0), (trunk(40), 0),
                      (trunk(256, H=100), 128), (trunk(256, out=17), 128), (trunk(256, H=512), 0)):
        with pytest.raises(ValueError, match="unsupported trunk widths"):
            fi.check_trunk("t", shapes, m)
    with pytest.raises(ValueError, match="2 or 3 hidden layers"):
        fi.check_trunk("t", trunk(256, nh=1), 128)

    leaves = [torch.empty(s, device="meta") for s in good]
    with pytest.raises(ValueError, match="unsupported widths"):
        t_ffh.prepare_field("t", [torch.empty(s, device="meta") for s in _field(H=512)], "meta")
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
    layers = [(meta(*s), meta(s[1])) for s in fi.trunk_layout(256, 256, 3, 16).shapes[0::2]]
    with pytest.raises(ValueError, match="unsupported device"):
        t_fm.fused_spectral_field_bwd(meta(3, 128), meta(128), layers, meta(N, 3), meta(N, 16))
    with pytest.raises(ValueError, match="unsupported device"):
        t_fm.fused_mlp_apply_bwd(layers, meta(N, 256), meta(N, 16))
    for fn in (t_ffh.fused_field_heads, t_ffh.fused_field_heads_bwd, t_fvr.fused_field_volrend,
               t_fvr.fused_field_volrend_bwd, t_fvr.fused_field_volrend_lossgrad,
               t_fm.fused_spectral_field_bwd, t_fm.fused_mlp_apply_bwd):
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


@pytest.mark.parametrize("M,H,n_hidden,n_tiles,n_sm,heads", [
    (128, 256, 3, 4096, 132, True), (128, 256, 2, 4096, 132, True), (128, 256, 3, 2, 132, True),
    (128, 256, 3, 4096, 16, True), (128, 256, 2, 37, 114, True), (32, 64, 3, 4096, 132, True),
    (64, 128, 2, 4096, 132, True), (32, 256, 3, 1024, 132, True), (128, 64, 3, 4096, 132, True),
    (128, 256, 3, 4096, 132, False), (32, 64, 2, 2048, 132, False), (64, 128, 3, 512, 132, False),
    (128, 64, 2, 4096, 132, False)])
def test_weight_gradient_launch_plan(M, H, n_hidden, n_tiles, n_sm, heads):
    """Every weight has its items, in the leaves' order (a trunk matrix one
    per 128 input rows, the trunk alone without the heads' three); an item's
    chunks partition the row tiles with none empty; blocks, partials and
    sums are laid end to end; at the train shape the launch is one wave."""
    plan = fi.dw_plan(M, H, n_hidden, n_tiles, n_sm, heads)
    items = [row[0] for row in plan.items]
    per = [-(-2 * M // 128)] + [-(-H // 128)] * n_hidden  # items of w0 .. w_last
    assert len(items) == sum(per) + (3 if heads else 0) <= 16
    k = 0
    for l, count in enumerate(per):
        x = "enc" if l == 0 else f"h{l - 1}"
        y = f"gh{l}" if l < n_hidden else "gt"
        for p in range(count):
            it = items[k + p]
            x_imgs = 2 * M // 64 if l == 0 else H // 64
            assert (it.x, it.y, it.x_imgs, it.n) == (x, y, x_imgs, H if l < n_hidden else 64)
            assert it.x_img == (2 * p, min(2 * p + 1, x_imgs - 1)) and it.y_img == (0, 0)
        k += count
    assert [(i.x, i.y) for i in items[k:]] == ([("xs", "g1"), ("hid1", "g2"), ("hid2", "gout")]
                                               if heads else [])
    block = p_off = out_off = 0
    for it, chunks, chunk_tiles, first_block, p, o in plan.items:
        assert (first_block, p, o) == (block, p_off, out_off)
        assert chunks >= 1 and (chunks - 1) * chunk_tiles < n_tiles <= chunks * chunk_tiles
        assert it.n in (64, 128, 256) and max(it.x_img) < it.x_imgs
        shared = it.y_img[0] == it.y_img[1]
        assert max(it.y_img) + (it.n // 64 if shared else 1) <= it.y_imgs
        assert shared or it.n == 64  # above 64 columns the dY images are shared
        block += chunks
        p_off += chunks * 2 * 64 * it.n
        out_off += 2 * 64 * it.n
    assert (plan.n_blocks, plan.partial_floats, plan.out_floats) == (block, p_off, out_off)
    if n_tiles >= n_sm >= 2 * len(items):
        assert n_sm - 2 * len(items) <= plan.n_blocks <= n_sm
    assert plan.out_floats == 2 * 64 * sum(i.n for i in items)


@pytest.mark.parametrize("din,m,H,n_hidden,out", TRUNKS)
def test_trunk_weight_gradients_assemble(din, m, H, n_hidden, out):
    """The trunk alone's dW plan (the backwards of the trunk kernels): each
    matrix's gradient is read from its items' reduced blocks, row r of dW
    from item r // 128, warpgroup r % 128 // 64, row r % 64 of that block;
    a lone last X image's second copy is never read."""
    M = fi.check_trunk("t", fi.trunk_layout(din, H, n_hidden, out).shapes, m)[1]
    plan = fi.dw_plan(M, H, n_hidden, 64, 132, heads=False)
    out_buf = torch.arange(plan.out_floats, dtype=torch.float64)
    shapes = [(din, H)] + [(H, H)] * (n_hidden - 1) + [(H, out)]
    grads, n_items = fi.matrix_grads(plan, out_buf, shapes)
    assert n_items == len(plan.items)
    i = 0
    for (rows, cols), g in zip(shapes, grads):
        assert g.shape == (rows, cols)
        r, c = np.arange(rows)[:, None], np.arange(cols)[None, :]
        it, *_, off = plan.items[i + 0]
        n = it.n
        item_off = np.array([plan.items[i + k][5] for k in range(-(-rows // 128))])
        want = item_off[r // 128] + ((r % 128) // 64 * 64 + r % 64) * n + c
        assert np.array_equal(g.numpy(), want.astype(np.float64))
        i += -(-rows // 128)


# (input width, the encode's frequencies or 0 for an input x, H, hidden
# layers, output): trunks between two of the tile's instances
PADDED_TRUNKS = [(96, 48, 96, 3, 16), (16, 8, 16, 2, 3), (80, 0, 112, 2, 1), (256, 0, 240, 3, 7)]


@pytest.mark.parametrize("din,m,h,n_hidden,out", PADDED_TRUNKS)
def test_padded_trunk_is_the_trunk(din, m, h, n_hidden, out):
    """A trunk between two instances runs on the next one zero-padded
    (``field_train.pad_trunk``): in float64, the padded trunk's output and,
    once ``unpad_trunk_grads`` cuts them back, its gradients (every layer,
    dW_spec and dphase) equal the trunk's own."""
    from apnerf_tpu_torch.ops.cuda import field_train as t_ft

    shapes = fi.trunk_layout(din, h, n_hidden, out).shapes
    _, M, H, _, _ = fi.check_trunk("t", shapes, m)
    assert (M, H) == (min(x for x in fi.M_SET if 2 * x >= din),
                      min(x for x in fi.H_SET if x >= h)) != ((m or M), h)
    gen = torch.Generator().manual_seed(5)
    f64 = torch.float64
    flat = [torch.randn(s, generator=gen, dtype=f64) for s in shapes]
    W = torch.randn((3, m), generator=gen, dtype=f64) if m else None
    phase = torch.rand((m,), generator=gen, dtype=f64) if m else None
    u = torch.rand((40, 3), generator=gen, dtype=f64)
    x = torch.randn((40, din), generator=gen, dtype=f64)
    cot = torch.randn((40, out), generator=gen, dtype=f64)

    def forward_and_grads(flat, W, phase):
        flat = [t.clone().requires_grad_(True) for t in flat]
        spec = [t.clone().requires_grad_(True) for t in (W, phase)] if m else []
        h_ = t_fm.encode_plain(*spec, u, f64) if m else x
        for l in range(n_hidden + 1):
            h_ = h_ @ flat[2 * l] + flat[2 * l + 1]
            h_ = torch.relu(h_) if l < n_hidden else h_
        return h_, torch.autograd.grad(h_, spec + flat, cot)

    y, g = forward_and_grads(flat, W, phase)
    y_p, g_p = forward_and_grads(*t_ft.pad_trunk(flat, W, phase, M, H))
    grads, spectrum = t_ft.unpad_trunk_grads(list(g_p[2:] if m else g_p),
                                             tuple(g_p[:2]) if m else None, m, M, h)
    torch.testing.assert_close(y_p, y, rtol=0, atol=1e-9)
    for a, b in zip(list(spectrum or ()) + grads, g):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=0, atol=1e-9)
