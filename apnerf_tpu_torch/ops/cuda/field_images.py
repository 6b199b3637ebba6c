"""Host side of the main field's Hopper tile (``csrc/hopper_tile.cuh``,
``csrc/field_tile.cuh``, ``csrc/fused_field_volrend.cu``): the tile
images the kernels multiply from, the slab schedules their producer warps
stream, the shared-memory budgets and the launch plans. Everything here is
plain Python and numpy, so the CPU tests hold it against a reference; the
``.cuh`` files mirror the numbers.

**Tile image.** ``[rows, 64]`` bf16, a row 128 bytes, the eight 16-byte
chunks of row ``r`` stored at chunk index ``c ^ (r & 7)``: the layout
``wgmma``'s 128-byte-swizzle descriptor reads. A weight is repacked once
per call into such images, in the order the kernel consumes them, so one
1-D ``cp.async.bulk`` per slab brings it to shared memory.

**Forward slabs** (``B[n][k] = w[k0 + k][n]``, rows are output units):
each trunk hidden layer as four ``[256, 64]`` images (one per 64 input
columns), the trunk's last layer as four ``[16, 64]`` images, then per
head layer the rgb and the semantic image side by side. The semantic
head's first layer sits at input rows 16.. so both heads read the same
``[SH | geo]`` tile.

**Backward slabs** (``B[n][k] = w[n][k0 + k]``, rows are input units), in
the order the field backward walks: heads from the top, the trunk's last
layer, the hidden layers downwards, the first layer for the encode.

The widths are the shipping field's: 128 frequencies, a 256-wide trunk of
2 or 3 hidden layers, 64-wide heads, at most 15 geometry features and 64
classes. Another width raises in ``prepare_field``.
"""

from __future__ import annotations

import functools
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np

from .launch import MAX_SMEM

M = 128  # spectral frequencies: the encoding is 2 M = 256 wide
H = 256  # trunk width
HH = 64  # head width
SHW = 16  # SH features of a direction
T_OUT = 16  # trunk output width, padded (1 + geo <= 16)
RGB_PAD = 16  # rgb head output width, padded
C_PAD = 64  # semantic head output width, padded
MAX_GEO = 15
MAX_CLASSES = 64

IMG_COLS = 64
IMG_ROW_BYTES = 128
TILE_ROWS = 64  # rows of one warpgroup's tile
PASS_ROWS = 128  # rows a block handles per pass: two consumer warpgroups
IMG_BYTES = TILE_ROWS * IMG_ROW_BYTES  # a 64-row image
SLAB_BYTES = 256 * IMG_ROW_BYTES  # a ring slot: a [256, 64] image

ALIGN_SLACK = 1024  # the kernels align their dynamic shared memory themselves
FWD_STAGES = 4
BWD_STAGES = 4
DW_STAGES = 3
DW_STAGE_BYTES = 6 * IMG_BYTES  # two X images and up to four dY images


def img_off(r, c):
    """Byte offset of element (r, c) of a tile image (``hopper::img_off``)."""
    return r * IMG_ROW_BYTES + ((((c >> 3) ^ r) & 7) << 4) + ((c & 7) << 1)


# ---- slab schedules ------------------------------------------------------------


def fwd_slabs(n_hidden: int) -> List[Tuple[int, int]]:
    """(byte offset, bytes) of each forward slab, in consumption order."""
    slabs = [(i * SLAB_BYTES, SLAB_BYTES) for i in range(4 * n_hidden)]
    off = 4 * n_hidden * SLAB_BYTES
    for size in (4 * T_OUT * IMG_ROW_BYTES,  # trunk output: four [16, 64] images
                 2 * IMG_BYTES,  # heads, first layer: rgb | sem
                 2 * IMG_BYTES,  # second layer
                 RGB_PAD * IMG_ROW_BYTES + IMG_BYTES):  # outputs: rgb [16, 64] | sem [64, 64]
        slabs.append((off, size))
        off += size
    return slabs


def bwd_slabs(n_hidden: int) -> List[Tuple[int, int]]:
    """(byte offset, bytes) of each backward weight slab, in consumption order."""
    slabs, off = [], 0
    for size in (2 * IMG_BYTES,  # head outputs back: rgb | sem
                 2 * IMG_BYTES,  # second layer back
                 2 * 32 * IMG_ROW_BYTES,  # first layer back: two [32, 64] images
                 SLAB_BYTES):  # trunk output back
        slabs.append((off, size))
        off += size
    for _ in range(4 * n_hidden):  # hidden layers n_hidden - 1 .. 1, then the encode's
        slabs.append((off, SLAB_BYTES))
        off += SLAB_BYTES
    return slabs


def n_bias(n_hidden: int) -> int:
    """Width of a row of per-tile column sums (``n_bias()`` of
    ``csrc/fused_field_volrend.cu``): the trunk's pre-activations, its
    output, the four head layers, dphase and the three rows of dW_spec."""
    return n_hidden * H + T_OUT + 4 * HH + 4 * M


def bias_offsets(n_hidden: int) -> Dict[str, int]:
    """Float offsets of each layer's bias in the kernels' bias buffer."""
    o = n_hidden * H
    return {"trunk_out": o, "rb0": o + 16, "sb0": o + 80, "rb1": o + 144, "sb1": o + 208,
            "rb2": o + 272, "sb2": o + 288, "total": o + 352}


# ---- index tables: image = flat_source[index] ----------------------------------


class LeafLayout(NamedTuple):
    """Where each leaf starts in the flat f32 concatenation of the leaves,
    and the index of the zero appended after them."""

    offsets: Tuple[int, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    zero: int


def leaf_layout(n_hidden: int, G: int, C: int) -> LeafLayout:
    shapes: List[Tuple[int, ...]] = [(3, M), (M,)]
    widths = [2 * M] + [H] * n_hidden + [1 + G]
    for a, b in zip(widths[:-1], widths[1:]):
        shapes += [(a, b), (b,)]
    for a, b in ((SHW + G, HH), (HH, HH), (HH, 3), (G, HH), (HH, HH), (HH, C)):
        shapes += [(a, b), (b,)]
    offsets, total = [], 0
    for s in shapes:
        offsets.append(total)
        total += int(np.prod(s))
    return LeafLayout(tuple(offsets), tuple(shapes), total)


def _image_index(rows: int, src_index) -> np.ndarray:
    """The flat index table of one image: ``src_index(r, c)`` gives the
    source index of element (r, c) as an int64 array."""
    r, c = np.arange(rows)[:, None], np.arange(IMG_COLS)[None, :]
    out = np.empty(rows * IMG_COLS, dtype=np.int64)
    out[img_off(r, c) // 2] = np.broadcast_to(src_index(r, c), (rows, IMG_COLS))
    return out


def _fwd_image(lay: LeafLayout, leaf: int, rows: int, k0: int = 0, k_shift: int = 0):
    """B[n][k] = w[k0 + k - k_shift][n] where that element exists, else 0."""
    w_in, w_out = lay.shapes[leaf]
    base = lay.offsets[leaf]

    def src(n, k):
        kk = k0 + k - k_shift
        ok = (kk >= 0) & (k >= k_shift) & (kk < w_in) & (n < w_out)
        return np.where(ok, base + kk * w_out + n, lay.zero)

    return _image_index(rows, src)


def _bwd_image(lay: LeafLayout, leaf: int, rows: int, k0: int = 0, n_shift: int = 0):
    """B[n][k] = w[n - n_shift][k0 + k] where that element exists, else 0."""
    w_in, w_out = lay.shapes[leaf]
    base = lay.offsets[leaf]

    def src(n, k):
        nn, kk = n - n_shift, k0 + k
        ok = (nn >= 0) & (nn < w_in) & (kk < w_out)
        return np.where(ok, base + nn * w_out + kk, lay.zero)

    return _image_index(rows, src)


def _leaf_ids(n_hidden: int):
    """Leaf numbers of the weights: trunk (n_hidden + 1), rgb head, sem head."""
    trunk = [2 + 2 * i for i in range(n_hidden + 1)]
    first = 2 + 2 * (n_hidden + 1)
    return trunk, [first, first + 2, first + 4], [first + 6, first + 8, first + 10]


@functools.lru_cache(maxsize=None)
def index_tables(n_hidden: int, G: int, C: int):
    """→ (forward image index, backward image index, bias index): int64
    arrays into the flat f32 concatenation of the leaves followed by one
    zero. ``flat.to(bf16)[fwd]`` is the forward weight buffer, and so on."""
    lay = leaf_layout(n_hidden, G, C)
    trunk, head, semh = _leaf_ids(n_hidden)
    fwd = []
    for l in range(n_hidden):
        for kb in range(4):
            fwd.append(_fwd_image(lay, trunk[l], 256, k0=64 * kb))
    for kb in range(4):
        fwd.append(_fwd_image(lay, trunk[n_hidden], T_OUT, k0=64 * kb))
    fwd += [_fwd_image(lay, head[0], 64), _fwd_image(lay, semh[0], 64, k_shift=SHW),
            _fwd_image(lay, head[1], 64), _fwd_image(lay, semh[1], 64),
            _fwd_image(lay, head[2], RGB_PAD), _fwd_image(lay, semh[2], 64)]
    bwd = [_bwd_image(lay, head[2], 64), _bwd_image(lay, semh[2], 64),
           _bwd_image(lay, head[1], 64), _bwd_image(lay, semh[1], 64),
           _bwd_image(lay, head[0], 32), _bwd_image(lay, semh[0], 32, n_shift=SHW),
           _bwd_image(lay, trunk[n_hidden], 256)]
    for l in range(n_hidden - 1, -1, -1):
        for kb in range(4):
            bwd.append(_bwd_image(lay, trunk[l], 256, k0=64 * kb))
    offs = bias_offsets(n_hidden)
    bias = np.full(offs["total"], lay.zero, dtype=np.int64)

    def put(at, leaf):
        n = lay.shapes[leaf][0]
        bias[at: at + n] = lay.offsets[leaf] + np.arange(n)

    for l in range(n_hidden):
        put(l * H, trunk[l] + 1)
    put(offs["trunk_out"], trunk[n_hidden] + 1)
    for name, leaf in (("rb0", head[0]), ("sb0", semh[0]), ("rb1", head[1]), ("sb1", semh[1]),
                       ("rb2", head[2]), ("sb2", semh[2])):
        put(offs[name], leaf + 1)
    fwd, bwd = np.concatenate(fwd), np.concatenate(bwd)
    assert fwd.size * 2 == sum(b for _, b in fwd_slabs(n_hidden))
    assert bwd.size * 2 == sum(b for _, b in bwd_slabs(n_hidden))
    return fwd, bwd, bias


# ---- shared-memory budgets (mirrors of the .cuh layouts) -----------------------


def fwd_smem_bytes(n_hidden: int) -> int:
    """``fwd_smem()`` of ``csrc/field_tile.cuh``: the slab ring, one
    activation buffer per consumer warpgroup, the biases, the barriers."""
    bias = -(-bias_offsets(n_hidden)["total"] * 4 // 128) * 128
    u_tiles = 2 * 2 * TILE_ROWS * 3 * 4  # per warpgroup: this pass's coordinates and the next's
    return (ALIGN_SLACK + FWD_STAGES * SLAB_BYTES + 2 * 4 * IMG_BYTES + bias + u_tiles
            + 16 * FWD_STAGES)


def bwd_smem_bytes() -> int:
    """``bwd_smem()`` of ``csrc/fused_field_volrend.cu``: the slab ring, one
    cotangent buffer and one tile of coordinates per consumer warpgroup, the
    barriers."""
    return (ALIGN_SLACK + BWD_STAGES * SLAB_BYTES + 2 * 4 * IMG_BYTES + 2 * TILE_ROWS * 3 * 4
            + 16 * BWD_STAGES)


def dw_smem_bytes() -> int:
    """``dw_smem()`` of ``csrc/fused_field_volrend.cu``."""
    return ALIGN_SLACK + DW_STAGES * DW_STAGE_BYTES + 16 * DW_STAGES


# ---- launch plans ----------------------------------------------------------------


def padded_rows(n_rows: int) -> int:
    """Rows of the scratch buffers: whole passes."""
    return -(-n_rows // PASS_ROWS) * PASS_ROWS


def field_grid(n_rows: int, n_sm: int) -> int:
    """Blocks of the persistent field kernels: one per SM, each walking
    passes ``blockIdx, blockIdx + grid, ...`` of 128 rows."""
    return max(1, min(n_sm, padded_rows(n_rows) // PASS_ROWS))


class DwItem(NamedTuple):
    """One product of the weight-gradient kernel, per consumer warpgroup w:
    ``P[64, n] = X_image(x_img[w])^T @ dY_images(y_img[w] ..)`` summed over a
    chunk of row tiles. ``x`` and ``y`` name the scratch buffers."""

    x: str
    x_imgs: int  # images per row tile in that buffer
    x_img: Tuple[int, int]
    y: str
    y_imgs: int
    y_img: Tuple[int, int]
    n: int  # 64 or 256
    chunks: int


def dw_items(n_hidden: int, n_tiles: int, n_sm: int) -> List[DwItem]:
    """The weight-gradient kernel's products, in the order of their outputs:
    per trunk matrix two items (input columns 0:128, 128:256), then the
    three head layers (rgb on warpgroup 0, semantics on 1). The pass is
    bound by device memory, so an item gets row chunks (blocks) in
    proportion to the images it reads per row tile, ``n_sm`` blocks in all."""
    plan = []
    for l in range(n_hidden):
        x = "enc" if l == 0 else f"h{l - 1}"
        for mp in range(2):
            plan.append((x, 4, (2 * mp, 2 * mp + 1), f"gh{l}", 4, (0, 0), 256))
    for mp in range(2):
        plan.append((f"h{n_hidden - 1}", 4, (2 * mp, 2 * mp + 1), "gt", 1, (0, 0), 64))
    plan += [("xs", 1, (0, 0), "g1", 2, (0, 1), 64), ("hid1", 2, (0, 1), "g2", 2, (0, 1), 64),
             ("hid2", 2, (0, 1), "gout", 2, (0, 1), 64)]

    def images(p):  # read per row tile
        return len(set(p[2])) + (4 if p[6] == 256 else len(set(p[5])))

    total = sum(images(p) for p in plan)
    return [DwItem(*p, chunks=max(1, min(n_tiles, n_sm * images(p) // total))) for p in plan]


class DwPlan(NamedTuple):
    """The weight-gradient launch: per item its row chunks (one block each),
    the row tiles of a chunk, its first block, and where its partials
    ``[chunks, 2, 64, n]`` and its sums ``[2, 64, n]`` start (floats)."""

    items: Tuple[Tuple[DwItem, int, int, int, int, int], ...]
    n_blocks: int
    partial_floats: int
    out_floats: int


def dw_plan(n_hidden: int, n_tiles: int, n_sm: int) -> DwPlan:
    rows, block, p_off, out_off = [], 0, 0, 0
    for it in dw_items(n_hidden, n_tiles, n_sm):
        chunk_tiles = -(-n_tiles // it.chunks)
        chunks = -(-n_tiles // chunk_tiles)  # no chunk is empty
        rows.append((it, chunks, chunk_tiles, block, p_off, out_off))
        size = 2 * TILE_ROWS * it.n
        block += chunks
        p_off += chunks * size
        out_off += size
    return DwPlan(tuple(rows), block, p_off, out_off)


def check_widths(who: str, shapes: Sequence[Tuple[int, ...]]):
    """Raise unless the leaves' shapes are a field these kernels take →
    (n_hidden, G, C)."""
    if len(shapes) % 2 or len(shapes) < 2 + 12:
        raise ValueError(f"{who}: W, phase, then (w, b) pairs")
    n_trunk = (len(shapes) - 2 - 12) // 2
    if n_trunk not in (3, 4):
        raise ValueError(f"{who}: the trunk needs 2 or 3 hidden layers and each head 2")
    n_hidden = n_trunk - 1
    m = shapes[0][1] if len(shapes[0]) == 2 else -1
    h = shapes[2][1] if len(shapes[2]) == 2 else -1
    out_t = shapes[2 + 2 * n_hidden][1] if len(shapes[2 + 2 * n_hidden]) == 2 else -1
    first = 2 + 2 * n_trunk
    hh = shapes[first][1] if len(shapes[first]) == 2 else -1
    C = shapes[first + 10][1] if len(shapes[first + 10]) == 2 else -1
    G = out_t - 1
    if m != M or h != H or hh != HH or not 1 <= G <= MAX_GEO or not 1 <= C <= MAX_CLASSES:
        raise ValueError(
            f"{who}: unsupported widths M={m} H={h} head={hh} geo={G} classes={C} (the "
            f"kernels take M={M}, H={H}, head={HH}, geo <= {MAX_GEO}, classes <= {MAX_CLASSES})")
    want = leaf_layout(n_hidden, G, C).shapes
    for i, (got, exp) in enumerate(zip(shapes, want)):
        if tuple(got) != tuple(exp):
            raise ValueError(f"{who}: leaf {i} has shape {tuple(got)}, expected {tuple(exp)}")
    return n_hidden, G, C
