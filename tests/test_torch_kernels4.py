"""Host side of the field's Hopper tile (``apnerf_tpu_torch/ops/cuda/
field_images.py`` and what ``prepare_field`` builds from it), at each of
the tile's four instances H and at widths between them: the weight
repacking into tile images against a numpy reference and back, for the
whole field and for the trunk alone (the trunk kernels, forward and
backward), the shared-memory budgets against the ``.cuh`` layouts, the
wrappers' refusals, and the launch plans. CPU only; the kernels themselves
are held against their plain versions on the card by ``chip_smoke.py``."""

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
# narrow heads' widths, then every instance and widths between them, then
# the wider tiers (geo past 15, classes past 64) on every instance
FIELDS = [(128, 256, 3, 15, 29), (128, 256, 2, 15, 29), (128, 256, 3, 7, 5),
          (128, 256, 2, 3, 1)] + [
    (m, h, 2 + (i % 2), (7, 15, 1)[i % 3], (29, 5, 64)[i % 3])
    for i, (m, h) in enumerate(((32, 64), (64, 128), (32, 256), (256, 512), (48, 96),
                                (16, 100), (128, 512), (40, 64)))] + [
    (128, 256, 3, 31, 101), (32, 64, 2, 47, 256), (64, 128, 3, 15, 65), (16, 100, 3, 16, 3),
    (48, 512, 2, 31, 150), (256, 512, 3, 47, 129)]


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


def _enc_row(m, r):
    """The row of w0 that the forward encoding's column r multiplies, or -1:
    [cos of m | sin of m], zero-padded to whole 64-column blocks."""
    return r if r < 2 * m else -1


def _pair_row(m, r):
    """The row of w0 of the backward's first-layer column r, or -1: blocks
    of 32 frequencies, [cos 16 | sin 16] twice."""
    f = 16 * (r // 32) + r % 16
    return -1 if f >= m else f if r % 32 < 16 else m + f


def _ref_trunk(trunk, m, n_kb, H, heads, out=16):
    """The trunk's forward and backward images, element by element; m
    frequencies of the encode, or 0 for an input x; with the heads the
    trunk output ``out`` columns wide (the tier's T_out)."""
    nh = len(trunk) - 1
    row = (lambda r: _enc_row(m, r)) if m else (lambda r: r)
    brow = (lambda r: _pair_row(m, r)) if m else (lambda r: r)
    w0 = lambda r, n: _at(trunk[0], row(r), n) if row(r) >= 0 else 0.0
    b0 = lambda r, n: _at(trunk[0], brow(r), n) if brow(r) >= 0 else 0.0
    fwd = [_ref_image(H, lambda n, k: w0(64 * b + k, n)) for b in range(n_kb)]
    for l in range(1, nh):
        for kb in range(H // 64):
            fwd.append(_ref_image(H, lambda n, k: _at(trunk[l], 64 * kb + k, n)))
    if heads:
        for kb in range(H // 64):
            fwd.append(_ref_image(out, lambda n, k: _at(trunk[nh], 64 * kb + k, n)))
    for ch in range(0 if heads else -(-out // 16)):
        for kb in range(H // 64):
            fwd.append(_ref_image(16, lambda n, k: _at(trunk[nh], 64 * kb + k, 16 * ch + n)))
    bwd = [_ref_image(H, lambda n, k: _at(trunk[nh], n, 64 * t + k))
           for t in range(1 if heads else -(-out // 64))]
    for l in range(nh - 1, 0, -1):
        for kb in range(H // 64):
            bwd.append(_ref_image(H, lambda n, k: _at(trunk[l], n, 64 * kb + k)))
    n_back = -(-m // 32) if m else n_kb
    g = 1 if n_back == 1 else 2 if n_back == 2 else 4 if n_back <= 4 else 1
    if not heads and out > 64:  # a wider trunk output takes the one-block-a-product instance
        g = 1
    for grp in range(-(-n_back // g)):
        for kb in range(H // 64):
            bwd.append(_ref_image(64 * g, lambda n, k: b0(64 * g * grp + n, 64 * kb + k)))
    return fwd, bwd


def _tier(G, C):
    """(T_out, C_pad): the first of (16, 64), (32, 128), (48, 256) that
    takes 1 + G and C."""
    return next(t for t in ((16, 64), (32, 128), (48, 256)) if 1 + G <= t[0] and C <= t[1])


def _ref_field(leaves, m, H, n_hidden, t_out=16, c_tile=64):
    trunk = leaves[2: 2 + 2 * (n_hidden + 1): 2]
    head = leaves[2 + 2 * (n_hidden + 1):][0:6:2]
    semh = leaves[2 + 2 * (n_hidden + 1):][6:12:2]
    hh, hi = H // 4, fi.head_imgs(H)
    fwd, bwd_trunk = _ref_trunk(trunk, m, fi.enc_blocks(m), H, heads=True, out=t_out)
    fwd += [_ref_image(hh, lambda n, k: _at(head[0], k, n)),
            _ref_image(hh, lambda n, k: _at(semh[0], k - 16, n))]
    fwd += [_ref_image(hh, lambda n, k: _at(w[1], 64 * kb + k, n))
            for w in (head, semh) for kb in range(hi)]
    fwd += [_ref_image(16, lambda n, k: _at(head[2], 64 * kb + k, n)) for kb in range(hi)]
    # the semantic output 64 columns a slab
    fwd += [_ref_image(64, lambda n, k: _at(semh[2], 64 * kb + k, 64 * ch + n))
            for ch in range(c_tile // 64) for kb in range(hi)]
    bwd = [_ref_image(hh, lambda n, k: _at(head[2], n, k))]
    bwd += [_ref_image(hh, lambda n, k: _at(semh[2], n, 64 * ch + k)) for ch in range(c_tile // 64)]
    bwd += [_ref_image(hh, lambda n, k: _at(w[1], n, 64 * kb + k))
            for w in (head, semh) for kb in range(hi)]
    bwd += [_ref_image(16 + t_out, lambda n, k: _at(head[0], n, 64 * kb + k)) for kb in range(hi)]
    bwd += [_ref_image(16 + t_out, lambda n, k: _at(semh[0], n - 16, 64 * kb + k))
            for kb in range(hi)]
    return np.concatenate(fwd), np.concatenate(bwd + bwd_trunk)


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
    the bf16 weights, zero past the field's own widths up to its instance
    (the encoding's padded frequencies, the trunk's and the heads' units),
    the bias buffer holds every bias at its offset with zero padding, and
    the slab schedules cover the buffers exactly, every slab in one ring
    slot; at the field's tier (T_out, C_pad)."""
    leaves = _leaves(fi.leaf_layout(M, H, n_hidden, G, C).shapes)
    tensors = [torch.from_numpy(x) for x in leaves]
    w, (fwd, bwd, bias) = t_ffh.field_weights(tensors, torch.device("cpu"), M, H, n_hidden, G, C)
    Hi, n_kb, (t_out, c_tile) = fi.instance(H), fi.enc_blocks(M), _tier(G, C)
    assert fi.tier(G, C) == (t_out, c_tile)
    assert fwd.dtype == torch.bfloat16 and bwd.dtype == torch.bfloat16
    assert (w.tile_h, w.n_hidden, w.geo, w.n_classes, w.t_out, w.c_tile, w.n_freq, w.n_kb) == (
        Hi, n_hidden, G, C, t_out, c_tile, M, n_kb)
    assert w.wfwd == fwd.data_ptr() and w.wbwd == bwd.data_ptr() and w.bias == bias.data_ptr()
    ref_f, ref_b = _ref_field([_bf16(x) for x in leaves], M, Hi, n_hidden, t_out, c_tile)
    assert np.array_equal(fwd.float().numpy(), ref_f)
    assert np.array_equal(bwd.float().numpy(), ref_b)
    fs = fi.fwd_slabs(Hi, n_hidden, n_kb, True, 0, t_out, c_tile)
    bs = fi.bwd_slabs(Hi, n_hidden, fi.pair_blocks(M), True, 0, t_out, c_tile)
    _check_slabs(fs, fwd)
    _check_slabs(bs, bwd)
    assert max(size for _, size in fs) <= fi.fwd_slot_bytes(Hi)
    assert max(size for _, size in bs) <= fi.bwd_slot_bytes(Hi)
    offs = fi.bias_offsets(Hi, n_hidden, t_out, c_tile)
    got = bias.numpy()
    assert got.shape == (offs["total"],)
    biases = leaves[3::2]
    at = [l * Hi for l in range(n_hidden)] + [offs[k] for k in (
        "trunk_out", "rb0", "rb1", "rb2", "sb0", "sb1", "sb2")]
    used = np.zeros(offs["total"], dtype=bool)
    for o, b in zip(at, biases):
        assert np.array_equal(got[o: o + b.size], b)
        used[o: o + b.size] = True
    assert not got[~used].any()


# (input width, the encode's frequencies or 0 for an input x, H, hidden
# layers, output): the trunk kernels on the tile
TRUNKS = [(256, 128, 256, 3, 16), (64, 32, 64, 2, 1), (128, 64, 128, 3, 8), (256, 0, 256, 3, 16),
          (48, 0, 64, 2, 1), (160, 0, 128, 2, 16), (64, 0, 256, 3, 7), (512, 256, 512, 3, 32),
          (512, 0, 512, 3, 17), (96, 48, 100, 2, 64), (1472, 0, 256, 3, 130)]


@pytest.mark.parametrize("din,m,H,n_hidden,out", TRUNKS)
def test_trunk_images_match_the_reference(din, m, H, n_hidden, out):
    """The trunk alone, as the trunk kernels repack it: its slabs equal the
    reference images (the first layer's k-blocks zero past the input's
    width or at padded frequencies; the output layer 16 columns a forward
    slab and 64 a backward one), its biases sit where the whole field's do,
    and its schedules have no head slab."""
    shapes = fi.trunk_layout(din, H, n_hidden, out).shapes
    assert fi.check_trunk("t", shapes, m) == (din, H, n_hidden, out)
    Hi = fi.instance(H)
    n_kb = fi.enc_blocks(m) if m else fi.x_blocks(din)
    leaves = _leaves(shapes, seed=3)
    fwd, bwd, bias = t_ffh.repack([torch.from_numpy(x) for x in leaves], torch.device("cpu"),
                                  ("trunk", din, m, H, n_hidden, out))
    ref_f, ref_b = _ref_trunk([_bf16(x) for x in leaves[0::2]], m, n_kb, Hi, heads=False,
                              out=out)
    assert np.array_equal(fwd.float().numpy(), np.concatenate(ref_f))
    assert np.array_equal(bwd.float().numpy(), np.concatenate(ref_b))
    fs = fi.fwd_slabs(Hi, n_hidden, n_kb, heads=False, out=out)
    bs = fi.bwd_slabs(Hi, n_hidden, fi.pair_blocks(m) if m else n_kb, heads=False, out=out)
    _check_slabs(fs, fwd)
    _check_slabs(bs, bwd)
    assert max(size for _, size in fs) <= fi.fwd_slot_bytes(Hi)
    assert max(size for _, size in bs) <= fi.bwd_slot_bytes(Hi)
    # the trunk's forward schedule is the whole field's up to the trunk output
    n_trunk = n_kb + (n_hidden - 1) * Hi // 64
    assert fs[: n_trunk + 1] == fi.fwd_slabs(Hi, n_hidden, n_kb)[: n_trunk + 1]
    got = bias.numpy()
    offs = fi.bias_offsets(Hi, n_hidden)
    assert got.shape == (n_hidden * Hi + 16 * -(-out // 16),)
    for l in range(n_hidden):
        assert np.array_equal(got[l * Hi: l * Hi + H], leaves[2 * l + 1])
        assert not got[l * Hi + H: (l + 1) * Hi].any()
    assert np.array_equal(got[offs["trunk_out"]: offs["trunk_out"] + out], leaves[-1])
    assert not got[offs["trunk_out"] + out:].any()


@pytest.mark.parametrize("M,H,n_hidden,G,C", FIELDS[:2] + FIELDS[4::3])
def test_weight_images_invert(M, H, n_hidden, G, C):
    """Every weight comes back from the slabs: the forward image of a trunk
    layer is its transpose by 64-column blocks (the first layer's rows in
    the encoding's column order), the backward image the weight itself, and
    the semantic head's first layer sits at rows 16.. (at every tier: the
    head slabs before the trunk's are 2 + C_pad / 64)."""
    leaves = _leaves(fi.leaf_layout(M, H, n_hidden, G, C).shapes, seed=1)
    tensors = [torch.from_numpy(x) for x in leaves]
    _, (fwd, bwd, _) = t_ffh.field_weights(tensors, torch.device("cpu"), M, H, n_hidden, G, C)
    fwd, bwd = fwd.float().numpy(), bwd.float().numpy()
    Hi, n_kb, (t_out, c_tile) = fi.instance(H), fi.enc_blocks(M), _tier(G, C)
    fs = fi.fwd_slabs(Hi, n_hidden, n_kb, True, 0, t_out, c_tile)
    bs = fi.bwd_slabs(Hi, n_hidden, fi.pair_blocks(M), True, 0, t_out, c_tile)
    hh, hi = Hi // 4, fi.head_imgs(Hi)
    n_head = 2 + c_tile // 64  # the heads' backward slabs
    # the kernels' column of each row of w0, forward and backward
    order = np.argsort(np.where(fi.enc_rows(M) >= 0, fi.enc_rows(M), 1 << 30))[: 2 * M]
    b_order = np.argsort(np.where(fi.pair_rows(M) >= 0, fi.pair_rows(M), 1 << 30))[: 2 * M]
    first_fwd = 0
    for l in range(n_hidden):
        w = _bf16(leaves[2 + 2 * l])
        n_kb_l = n_kb if l == 0 else Hi // 64
        blocks = [_from_image(fwd[fs[first_fwd + kb][0] // 2:][: Hi * 64], Hi).T
                  for kb in range(n_kb_l)]
        full = np.concatenate(blocks, axis=0)  # [k, n]
        assert np.array_equal(full[order] if l == 0 else full[:H], w[:, :H])
        assert not full[:, H:].any()
        first_fwd += n_kb_l
        if l == 0:
            first = n_head + 1 + (n_hidden - 1) * Hi // 64
            g = fi.back_group(fi.pair_blocks(M)) or 1
            rows = 64 * g
            back = np.concatenate(
                [np.concatenate([_from_image(bwd[bs[first + grp * Hi // 64 + kb][0] // 2:]
                                             [: rows * 64], rows) for kb in range(Hi // 64)],
                                axis=1)
                 for grp in range(fi.back_blocks(fi.pair_blocks(M)) // g)], axis=0)
            assert np.array_equal(back[b_order][:, :H], w)  # [kernel column, unit]
        else:
            first = n_head + 1 + (n_hidden - 1 - l) * Hi // 64
            back = [_from_image(bwd[bs[first + kb][0] // 2:][: Hi * 64], Hi)
                    for kb in range(Hi // 64)]
            assert np.array_equal(np.concatenate(back, axis=1)[:H, :H], w)
    first_fwd += 1  # the trunk output's slab
    sem0 = _bf16(leaves[2 + 2 * (n_hidden + 1) + 6])  # [G, hh']
    hh_own = H // 4
    img = _from_image(fwd[fs[first_fwd][0] // 2 + hh * 64:][: hh * 64], hh)  # [n, k]
    assert np.array_equal(img[:hh_own, 16: 16 + G], sem0.T) and not img[:, :16].any()
    assert not img[:, 16 + G:].any() and not img[hh_own:].any()
    rows = 16 + t_out
    back = np.concatenate([_from_image(bwd[bs[n_head - 1][0] // 2 + (hi + kb) * rows * 64:]
                                       [: rows * 64], rows)
                           for kb in range(hi)], axis=1)  # [n - 16, k]
    assert np.array_equal(back[16: 16 + G, :hh_own], sem0) and not back[:16].any()


def _constants(name):
    text = (CSRC / name).read_text()
    return {m.group(1): int(m.group(2))
            for m in re.finditer(r"constexpr int (k\w+) = (\d+);", text)}


@pytest.mark.parametrize("H,n_kb", [(h, k) for h in fi.WIDTHS for k in (1, 8)])
def test_shared_memory_budgets_mirror_the_kernels(H, n_kb):
    """The Python mirrors of ``fwd_smem``, ``bwd_smem`` and ``dw_smem`` use
    the kernels' own constants, the instances are the kernels' own list, and
    every kernel of the tile fits one block's 232,448 bytes at each trunk
    depth the wrappers accept and at each tier of the trunk output and
    the classes, whatever the first layer's width (it streams one k-block at
    a time: the budgets do not depend on it)."""
    tile, vol = _constants("field_tile.cuh"), _constants("fused_field_volrend.cu")
    assert (tile["kShw"], tile["kRgbPad"], tile["kSemChunk"], tile["kOutChunk"]) == (
        fi.SHW, fi.RGB_PAD, fi.SEM_CHUNK, fi.OUT_CHUNK)
    assert vol["kDwStages"] == fi.DW_STAGES and tile["kBlockFreqs"] == fi.BLOCK_FREQS
    assert (tile["kTileRows"], tile["kAlignSlack"]) == (fi.TILE_ROWS, fi.ALIGN_SLACK)
    text = (CSRC / "field_tile.cuh").read_text()
    listed = text[text.index("#define APNERF_TILE_WIDTHS"):].split("\n")[0]
    assert tuple(int(a) for a in re.findall(r"X\((\d+)\)", listed)) == fi.WIDTHS
    listed = text[text.index("#define APNERF_FIELD_TIERS"):].split("\n")[0]
    tiers = re.findall(r"X\((\d+), (\d+), (\d+)\)", listed)
    assert [int(t) for t, _, _ in tiers] == list(range(len(fi.TIERS)))
    assert tuple((int(o), int(c)) for _, o, c in tiers) == fi.TIERS
    assert (fi.MAX_GEO, fi.MAX_CLASSES) == (63, 1024)
    assert [fi.tier(g, c) for g, c in ((15, 64), (16, 1), (1, 65), (31, 128), (32, 5),
                                       (3, 129), (47, 256), (48, 1), (1, 257), (63, 1024))] == [
        (16, 64), (32, 128), (32, 128), (32, 128), (48, 256), (48, 256), (48, 256),
        (64, 1024), (64, 1024), (64, 1024)]
    assert [fi.xs_imgs(t) for t, _ in fi.TIERS] == [1, 1, 1, 2]
    assert fi.BUF_BYTES == 8 * fi.IMG_BYTES and fi.DW_STAGE_BYTES == 6 * fi.IMG_BYTES
    assert fi.buf_bytes(H) == (16 if H == 1024 else 8) * fi.IMG_BYTES
    assert fi.MAX_SMEM == 232448
    assert (fi.split(H), fi.halves(H), fi.pass_rows(H), fi.stages(H)) == {
        512: (2, 1, 64, 2), 1024: (2, 2, 64, 1)}.get(H, (1, 1, 128, 4))
    assert fi.trunk_slab_bytes(H) == (512 if H == 1024 else H) * 128
    hh = H // 4
    for (t_out, c_tile), n_hidden in ((t, n) for t in fi.TIERS for n in (2, 3)):
        assert fi.bias_offsets(H, n_hidden, t_out, c_tile)["total"] == (
            n_hidden * H + t_out + 4 * hh + 16 + c_tile)
        for t_pad, mp in ((t_out, 32 * n_kb), (64 * n_kb, 0)):
            assert fi.n_bias(H, n_hidden, t_pad, mp) == n_hidden * H + t_pad + 4 * hh + 4 * mp
        fwd = fi.fwd_smem_bytes(H, n_hidden, t_out, c_tile)
        # ring, the activation buffers, the biases rounded up to 128 bytes, two
        # tiles of coordinates per tile, the trunk output's staging, barriers, slack
        assert fwd == (fi.stages(H) * fi.fwd_slot_bytes(H) + fi.buf_bytes(H)
                       + -(-(n_hidden * H + H + t_out + 16 + c_tile) * 4 // 128) * 128
                       + 4 * 768 + 2 * 4096 + 16 * fi.stages(H) + 1024)
        assert fwd <= fi.MAX_SMEM
        # every slab of the whole field's schedules fits its slot
        assert max(b for _, b in fi.fwd_slabs(H, n_hidden, n_kb, True, 0, t_out, c_tile)) <= \
            fi.fwd_slot_bytes(H)
        assert max(b for _, b in fi.bwd_slabs(H, n_hidden, n_kb, True, 0, t_out, c_tile)) <= \
            fi.bwd_slot_bytes(H)
    assert fi.fwd_smem_bytes(H, 3) == fi.fwd_smem_bytes(H, 3, 16, 64)
    # every slab of the trunk alone's schedules fits its slot, at both depths
    for n_hidden in (2, 3):
        for out in (1, 17, 64, 300):
            assert max(b for _, b in fi.fwd_slabs(H, n_hidden, n_kb, False, out)) <= \
                fi.fwd_slot_bytes(H)
            assert max(b for _, b in fi.bwd_slabs(H, n_hidden, n_kb, False, out)) <= \
                fi.bwd_slot_bytes(H)
    # the staging areas fit a tile's buffer: at C_pad = 64 all of a tile's
    # values (64 rows of 5 + 64 f32); past it the density and rgb over the
    # rgb head's activation and a [64, 64] f32 chunk of logits past the
    # heads' activations; a tile's buffer holds a hidden activation and the
    # heads' images (2 kHI activations twice, the input and gt's f32 copy,
    # [64, 48] f32 at T_out = 48 over the first two images)
    tile_bytes = fi.buf_bytes(H) // (2 // fi.split(H))
    assert 64 * (5 + 64) * 4 <= tile_bytes
    assert 64 * 5 * 4 <= fi.IMG_BYTES * fi.head_imgs(H)
    assert 2 * fi.head_imgs(H) * fi.IMG_BYTES + 64 * 64 * 4 <= tile_bytes
    assert H // 64 * fi.IMG_BYTES <= tile_bytes
    assert (4 * fi.head_imgs(H)) * fi.IMG_BYTES <= tile_bytes
    assert (2 * fi.head_imgs(H) + 2) * fi.IMG_BYTES <= tile_bytes
    assert 64 * 32 * 4 <= fi.IMG_BYTES and 64 * 64 * 4 <= 2 * fi.IMG_BYTES
    bwd = fi.bwd_smem_bytes(H)
    assert bwd == (fi.stages(H) * max(fi.trunk_slab_bytes(H), 32768) + fi.buf_bytes(H) + 2 * 768
                   + 2 * 8192 + 16 * fi.stages(H) + 1024) <= fi.MAX_SMEM
    # a tile's saved encoding of up to four k-blocks (the one-group backward) fits a slot
    assert 4 * fi.IMG_BYTES <= fi.bwd_slot_bytes(H)
    assert fi.dw_smem_bytes() == 3 * 6 * 8192 + 48 + 1024 <= fi.MAX_SMEM



@pytest.mark.parametrize("H,tier", [(h, t) for h in fi.WIDTHS for t in fi.TIERS])
def test_each_instance_and_tier_fits_its_block(H, tier):
    """At every instance H and tier (T_out, C_pad): the forward's shared
    memory fits one block at both depths; every slab fits its ring slot;
    the heads' input (one image, or two at T_out = 64) sits past the hidden
    activation and the heads' activations in a tile's buffer; and the
    weight-gradient plan's head items are products the kernel takes (n of
    64, 128 or 256, at most 128 where the warpgroups read different dY
    images), the first layer's items per image of its input, and the
    output layer's images each read by one warpgroup of one item per 128
    of the heads' input rows."""
    t_out, c_tile = tier
    xi, hi = fi.xs_imgs(t_out), fi.head_imgs(H)
    imgs = fi.buf_bytes(H) // (2 // fi.split(H)) // fi.IMG_BYTES  # a tile's buffer
    assert xi == (2 if t_out == 64 else 1)
    assert 2 * hi <= imgs - xi and H // 64 <= imgs
    for n_hidden in (2, 3):
        assert fi.fwd_smem_bytes(H, n_hidden, t_out, c_tile) <= fi.MAX_SMEM
        for n_kb in (1, 4, 8):
            assert max(b for _, b in fi.fwd_slabs(H, n_hidden, n_kb, True, 0, *tier)) <= \
                fi.fwd_slot_bytes(H)
            assert max(b for _, b in fi.bwd_slabs(H, n_hidden, n_kb, True, 0, *tier)) <= \
                fi.bwd_slot_bytes(H)
    # the heads' first layer is one [H / 4, 64] image per head and per image of its
    # input: one slab, or at H = 1024 one image a slab after the trunk output's k-blocks
    fwd = fi.fwd_slabs(H, 3, 4, True, 0, *tier)
    n_trunk = fi.halves(H) * (4 + 2 * H // 64)
    n_out, n_l1 = (H // 64, 2 * xi) if fi.per_image(H) else (1, 1)
    assert sum(b for _, b in fwd[n_trunk: n_trunk + n_out]) == H // 64 * t_out * 128
    assert [b for _, b in fwd[n_trunk + n_out: n_trunk + n_out + n_l1]] == \
        [2 * xi * (H // 4) * fi.IMG_ROW_BYTES // n_l1] * n_l1
    heads = fi._head_items(H, c_tile, t_out)
    per = max(1, hi // 2)  # the first layer's items per image of its input
    assert [h[2] for h in heads[:xi * per]] == [(x, x) for x in range(xi) for _ in range(per)]
    assert all(h[0] == "xs" and h[1] == xi for h in heads[:xi * per])
    read = []
    for x, x_imgs, x_img, y, y_imgs, y_img, n in heads:
        assert n in (64, 128, 256) and (y_img[0] == y_img[1] or n <= 128)
        assert max(x_img) < x_imgs and max(y_img) + n // 64 <= y_imgs
        if y == "gout":
            read += [y_img[0] + j for j in range(n // 64)]
            if y_img[1] != y_img[0]:
                read += [y_img[1] + j for j in range(n // 64)]
    # each output image once per 128 of the head's input rows
    assert sorted(read) == sorted(list(range(1 + c_tile // 64)) * per)


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
    """Every field from H = 4 to 1024 with heads H // 4 goes, on any number
    of frequencies up to H = 512 and 1 to 256 past it (H = 96, 512, 600 and
    1024, M = 256 among them), with 1 to 63 geometry features and 1 to 1024
    classes (geo 16, 31, 48 and 63, classes 65, 256, 257 and 1024 among
    them); widths past the set's edges (H = 2048, heads other than H // 4,
    geo 64, classes 1025, 257 frequencies at H = 1024) and another depth
    raise before any
    launch, on shapes alone, with a message that names the set; the trunk
    alone takes any H up to 512, any output and the encode or an input a
    multiple of 16 wide; a tensor that is neither on the CPU nor on a card
    raises on every entry."""
    good = fi.leaf_layout(128, 256, 3, 15, 29).shapes
    assert fi.check_widths("t", good) == (128, 256, 3, 15, 29)
    assert fi.check_widths("t", fi.leaf_layout(128, 256, 2, 4, 64).shapes) == (128, 256, 2, 4, 64)
    for G, C in ((16, 29), (31, 101), (15, 65), (47, 256), (1, 256), (47, 1), (48, 257),
                 (63, 1024), (1, 1024), (63, 1), (63, 847)):
        assert fi.check_widths("t", _field(G=G, C=C)) == (128, 256, 3, G, C)
        assert fi.check_widths("t", _field(M=256, H=512, G=G, C=C)) == (256, 512, 3, G, C)
        assert fi.check_widths("t", _field(M=256, H=1024, G=G, C=C)) == (256, 1024, 3, G, C)
    for m, h in ((32, 64), (64, 128), (128, 256), (256, 512), (48, 96), (16, 100), (1, 4),
                 (300, 512), (128, 1024), (256, 1024), (1, 1024), (100, 600), (8, 513)):
        assert fi.check_widths("t", _field(M=m, H=h, G=1, C=1)) == (m, h, 3, 1, 1)
    assert fi.check_widths("t", _field(H=96)) == (128, 96, 3, 15, 29)
    assert fi.check_widths("t", _field(M=256, H=512)) == (256, 512, 3, 15, 29)

    for bad in (dict(H=2048), dict(hh=32), dict(H=128, hh=64), dict(H=512, hh=64), dict(G=64),
                dict(C=1025), dict(G=64, C=1025), dict(H=3, hh=0), dict(M=257, H=1024),
                dict(M=300, H=600), dict(H=1024, hh=128)):
        with pytest.raises(ValueError, match=r"unsupported widths.*instances H in \(64, 128, "
                                             r"256, 512, 1024\): H 4\.\.1024 with heads H // 4, "
                                             r"any number of frequencies up to H = 512 and "
                                             r"1\.\.256 past it.*geo 1\.\.63, classes "
                                             r"1\.\.1024"):
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
    for shapes, m in ((trunk(512), 256), (trunk(24), 12), (trunk(272), 0), (trunk(1472), 0),
                      (trunk(256, H=100), 128), (trunk(256, out=17), 128),
                      (trunk(256, H=512), 0), (trunk(512, H=512, out=64), 0),
                      (trunk(512, H=1024), 256), (trunk(512, H=1024, out=1024), 0),
                      (trunk(96, H=700, out=17), 48)):
        assert fi.check_trunk("t", shapes, m) == (shapes[0][0], shapes[0][1], 3, shapes[-2][1])
    for shapes, m in ((trunk(512, H=2048), 256), (trunk(40), 0), (trunk(24), 0),
                      (trunk(256), 64), (trunk(528, H=1024), 0), (trunk(514, H=1024), 257),
                      (trunk(512, H=1024, out=1025), 0)):
        with pytest.raises(ValueError, match="unsupported trunk widths"):
            fi.check_trunk("t", shapes, m)
    with pytest.raises(ValueError, match="2 or 3 hidden layers"):
        fi.check_trunk("t", trunk(256, nh=1), 128)

    leaves = [torch.empty(s, device="meta") for s in good]
    with pytest.raises(ValueError, match="unsupported widths"):
        t_ffh.prepare_field("t", [torch.empty(s, device="meta") for s in _field(H=2048)], "meta")
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
    """Persistent blocks: one per SM, never more than there are passes (128
    rows, 64 at H = 512); scratch rows are whole passes; together the
    blocks' strides visit every pass once."""
    assert fi.padded_rows(1) == 128 and fi.padded_rows(128) == 128 and fi.padded_rows(129) == 256
    assert fi.padded_rows(1, 512) == 64 and fi.padded_rows(129, 512) == 192
    for H in fi.WIDTHS:
        p = fi.pass_rows(H)
        for n_rows in (1, 127, 128, 129, p * n_sm - 1, p * n_sm, p * n_sm + 1, 24000, 163268,
                       1 << 20):
            grid = fi.field_grid(n_rows, n_sm, H)
            n_pass = fi.padded_rows(n_rows, H) // p
            assert n_pass * p >= n_rows > (n_pass - 1) * p
            assert 1 <= grid <= min(n_sm, n_pass)
            assert grid == n_sm or grid == n_pass
            seen = sorted(q for b in range(grid) for q in range(b, n_pass, grid))
            assert seen == list(range(n_pass))


@pytest.mark.parametrize("H,n_hidden,n_kb,n_tiles,n_sm,heads,out,c_tile", [
    (256, 3, 4, 4096, 132, True, 0, 64), (256, 2, 4, 4096, 132, True, 0, 64),
    (256, 3, 4, 2, 132, True, 0, 64), (256, 3, 4, 4096, 16, True, 0, 64),
    (256, 2, 4, 37, 114, True, 0, 64), (64, 3, 1, 4096, 132, True, 0, 64),
    (128, 2, 2, 4096, 132, True, 0, 64), (256, 3, 1, 1024, 132, True, 0, 64),
    (64, 3, 4, 4096, 132, True, 0, 64), (512, 3, 8, 2048, 132, True, 0, 64),
    (256, 3, 4, 4096, 132, False, 16, 64), (64, 2, 1, 2048, 132, False, 1, 64),
    (128, 3, 2, 512, 132, False, 64, 64), (64, 2, 4, 4096, 132, False, 17, 64),
    (512, 3, 8, 1024, 132, False, 32, 64), (256, 3, 23, 4096, 132, False, 300, 64),
    (256, 3, 4, 4096, 132, True, 0, 128), (256, 3, 4, 4096, 132, True, 0, 256),
    (64, 2, 1, 2048, 132, True, 0, 256), (512, 3, 8, 2048, 132, True, 0, 128),
    (512, 2, 4, 2048, 132, True, 0, 256)])
def test_weight_gradient_launch_plan(H, n_hidden, n_kb, n_tiles, n_sm, heads, out, c_tile):
    """Every weight has its items, in the leaves' order (a trunk matrix one
    per 128 input rows and group of up to 256 output columns, the trunk
    alone without the heads' items); an item's images fit a stage and its
    chunks partition the row tiles with none empty; blocks, partials and
    sums are laid end to end; at the train shape the launch is one wave.
    Past 64 classes (``c_tile``) the output layer's dY is the rgb image and
    ``c_tile`` / 64 semantic ones, an item a head."""
    plan = fi.dw_plan(H, n_hidden, n_kb, n_tiles, n_sm, heads, out, c_tile)
    items = [row[0] for row in plan.items]
    groups = lambda y_imgs: -(-y_imgs // 4) if y_imgs % 4 in (0, 1, 2) else y_imgs // 4 + 1
    n_gt = 1 if heads else -(-out // 64)
    per = ([-(-n_kb // 2) * -(-H // 256)] + [-(-H // 128) * -(-H // 256)] * (n_hidden - 1)
           + [-(-H // 128) * len(fi._col_groups(n_gt))])
    n_heads = (3 + (c_tile > 64) if H < 512 else 5) if heads else 0
    assert len(items) == sum(per) + n_heads
    k = 0
    for l, count in enumerate(per):
        x = "enc" if l == 0 else f"h{l - 1}"
        y = f"gh{l}" if l < n_hidden else "gt"
        x_imgs = n_kb if l == 0 else H // 64
        y_imgs = H // 64 if l < n_hidden else n_gt
        cols = 0
        for it in items[k: k + count]:
            assert (it.x, it.y, it.x_imgs, it.y_imgs) == (x, y, x_imgs, y_imgs)
            assert it.x_img[1] == min(it.x_img[0] + 1, x_imgs - 1) and it.y_img[0] == it.y_img[1]
            cols += it.n if it.x_img == items[k].x_img else 0
        assert cols == 64 * y_imgs
        k += count
    assert [(i.x, i.y) for i in items[k:]] == ([("xs", "g1"), ("hid1", "g2")]
                                               + [("hid2", "gout")] * (1 + (c_tile > 64))
                                               if heads and H < 512 else
                                               [("xs", "g1"), ("hid1", "g2"), ("hid1", "g2"),
                                                ("hid2", "gout"), ("hid2", "gout")]
                                               if heads else [])
    if heads:
        # the output layer: every semantic column once, from gout's images past rgb's
        outs = [i for i in items[k:] if i.y == "gout"]
        assert all(i.y_imgs == 1 + c_tile // 64 for i in outs)
        sem = outs[-1]
        if len(outs) == 1:  # one head a warpgroup: rgb's image, then the semantic one
            assert sem.y_img == (0, 1) and sem.n == c_tile == 64
        else:
            cols = sem.n * (1 if sem.y_img[0] == sem.y_img[1] else 2)
            assert cols == c_tile and sem.y_img[0] == 1
    block = p_off = out_off = 0
    for it, chunks, chunk_tiles, first_block, p, o in plan.items:
        assert (first_block, p, o) == (block, p_off, out_off)
        assert chunks >= 1 and (chunks - 1) * chunk_tiles < n_tiles <= chunks * chunk_tiles
        assert it.n in (64, 128, 256) and max(it.x_img) < it.x_imgs
        shared = it.y_img[0] == it.y_img[1]
        assert max(it.y_img) + it.n // 64 <= it.y_imgs
        # the stage holds two X images and up to four dY images
        assert (it.n // 64 if shared else 2 * it.n // 64) <= 4
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
    from the item of input rows r // 128 and of its column, warpgroup r %
    128 // 64, row r % 64 of that block; a lone last X image's second copy
    is never read."""
    Hi = fi.instance(H)
    n_kb = fi.enc_blocks(m) if m else fi.x_blocks(din)
    plan = fi.dw_plan(Hi, n_hidden, n_kb, 64, 132, heads=False, out=out)
    out_buf = torch.arange(plan.out_floats, dtype=torch.float64)
    shapes = [(64 * n_kb, H)] + [(H, H)] * (n_hidden - 1) + [(H, out)]
    grads, n_items = fi.matrix_grads(plan, out_buf, shapes)
    assert n_items == len(plan.items)
    i = 0
    for (rows, cols), g in zip(shapes, grads):
        assert g.shape == (rows, cols)
        its = []
        while i < len(plan.items) and (not its or plan.items[i][0].x == its[0][0].x):
            its.append(plan.items[i])
            i += 1
        want = np.zeros((rows, cols))
        for it, *_, off in its:
            r0, c0 = 64 * it.x_img[0], 64 * it.y_img[0]
            for w in range(2):
                r = np.arange(64)[:, None]
                c = np.arange(it.n)[None, :]
                vals = off + (w * 64 + r) * it.n + c
                rr, cc = r0 + 64 * w + r, c0 + c
                if w == 1 and it.x_img[1] == it.x_img[0]:
                    continue  # the lone image's second copy
                ok = (rr < rows) & (cc < cols)
                rr_, cc_ = np.broadcast_to(rr, ok.shape), np.broadcast_to(cc, ok.shape)
                want[rr_[ok], cc_[ok]] = vals[ok]
        assert np.array_equal(g.numpy(), want)


# (input width, the encode's frequencies or 0 for an input x, H, hidden
# layers, output): trunks between two of the tile's instances
PADDED_TRUNKS = [(96, 48, 96, 3, 16), (16, 8, 16, 2, 3), (80, 0, 112, 2, 1), (256, 0, 240, 3, 7),
                 (512, 256, 300, 3, 17), (48, 24, 100, 2, 64)]


def _pad_trunk(flat, W, phase, M, H):
    """A trunk (its w0, b0, w1, ...) zero-padded to M frequencies and a
    width H: W and phase zero at the new frequencies, and with them the
    first layer's rows for their cos and sin; zero units past the width."""
    n = len(flat) // 2

    def grow(t, shape):
        z = t.new_zeros(shape)
        z[tuple(slice(0, k) for k in t.shape)] = t
        return z

    out = []
    for l in range(n):
        w, b = flat[2 * l], flat[2 * l + 1]
        w = grow(w, (w.shape[0] if l == 0 else H, w.shape[1] if l == n - 1 else H))
        if l == 0 and W is not None:  # rows [cos of m, sin of m] → [cos of M, sin of M]
            m = W.shape[1]
            z = w.new_zeros((M - m, H))
            w = torch.cat([w[:m], z, w[m:], z])
        out += [w, b if l == n - 1 else grow(b, (H,))]
    if W is not None:
        W, phase = grow(W, (3, M)), grow(phase, (M,))
    return out, W, phase


@pytest.mark.parametrize("din,m,h,n_hidden,out", PADDED_TRUNKS)
def test_padded_trunk_is_the_trunk(din, m, h, n_hidden, out):
    """A trunk between two instances runs on the next one zero-padded, the
    padding in the index tables (``field_images.trunk_index_tables``): its
    images equal those of the trunk zero-padded by hand to the instance's
    width, and in float64 that padded trunk's output and, cut back, its
    gradients (every layer, dW_spec and dphase) equal the trunk's own
    (``tests/test_torch_widths2.py`` runs the images themselves). The
    encode's frequencies and x's columns are not padded: the first layer's
    k-blocks are zero past them."""
    shapes = fi.trunk_layout(din, h, n_hidden, out).shapes
    assert fi.check_trunk("t", shapes, m) == (din, h, n_hidden, out)
    H = fi.instance(h)
    M = m
    assert H != h
    gen = torch.Generator().manual_seed(5)
    f64 = torch.float64
    flat = [torch.randn(s, generator=gen, dtype=f64) for s in shapes]
    W = torch.randn((3, m), generator=gen, dtype=f64) if m else None
    phase = torch.rand((m,), generator=gen, dtype=f64) if m else None
    padded, W_p, phase_p = _pad_trunk(flat, W, phase, M, H)
    cpu = torch.device("cpu")
    own = t_ffh.repack([t.float() for t in flat], cpu, ("trunk", din, m, h, n_hidden, out))
    by_hand = t_ffh.repack([t.float() for t in padded], cpu, ("trunk", din, M, H, n_hidden, out))
    for a, b in zip(own, by_hand):
        assert torch.equal(a, b)

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
    y_p, g_p = forward_and_grads(padded, W_p, phase_p)
    torch.testing.assert_close(y_p, y, rtol=0, atol=1e-9)
    k = 2 if m else 0
    if m:
        torch.testing.assert_close(g_p[0][:, :m], g[0], rtol=0, atol=1e-9)
        torch.testing.assert_close(g_p[1][:m], g[1], rtol=0, atol=1e-9)
    for l in range(n_hidden + 1):
        dw, db = g_p[k + 2 * l], g_p[k + 2 * l + 1]
        if l == 0 and m:
            dw = torch.cat([dw[:m], dw[M: M + m]])
        dw = dw[:, :h] if l == 0 else dw[:h] if l == n_hidden else dw[:h, :h]
        torch.testing.assert_close(dw, g[k + 2 * l], rtol=0, atol=1e-9)
        torch.testing.assert_close(db if l == n_hidden else db[:h], g[k + 2 * l + 1], rtol=0,
                                   atol=1e-9)
