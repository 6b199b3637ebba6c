"""Host side of the field's Hopper tile (``csrc/hopper_tile.cuh``,
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
each trunk hidden layer as one ``[H, 64]`` image per 64 input columns
(2M / 64 for the first, H / 64 for the others), then with the heads the
trunk's last layer as H / 64 ``[16, 64]`` images and per head layer the
rgb and the semantic image side by side. The semantic head's first layer
sits at input rows 16.. so both heads read the same ``[SH | geo]`` tile.

**Backward slabs** (``B[n][k] = w[n][k0 + k]``, rows are input units), in
the order the field backward walks: heads from the top, the trunk's last
layer, the hidden layers downwards, the first layer for the encode (or
for dx: the trunk alone has no head slabs).

**Widths.** The kernels are instances of the frequency count M (the
encoding is 2M wide) and the trunk width H: M in ``M_SET``, H in
``H_SET``, heads H / 4 wide, 2 or 3 hidden layers, at most 15 geometry
features and 64 classes (``check_widths``); the trunk alone takes an
output of at most 16 and, without the encode, an input of at most 256
(``check_trunk``). A field between two instances (H = 96, say) is refused,
not padded; a trunk alone between two is zero-padded up to the next.
"""

from __future__ import annotations

import functools
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np

from .launch import MAX_SMEM

M_SET = (32, 64, 128)  # spectral frequencies: the encoding is 2 M wide
H_SET = (64, 128, 256)  # trunk widths; the heads are H / 4 wide
WIDTHS = tuple((m, h) for m in M_SET for h in H_SET)  # APNERF_TILE_WIDTHS
SHW = 16  # SH features of a direction
T_OUT = 16  # trunk output width, padded (1 + geo <= 16)
RGB_PAD = 16  # rgb head output width, padded
C_PAD = 64  # semantic head output width, padded
MAX_GEO = 15
MAX_CLASSES = 64
MAX_DIN = 2 * max(M_SET)  # the trunk alone: its input's widest instance

IMG_COLS = 64
IMG_ROW_BYTES = 128
TILE_ROWS = 64  # rows of one warpgroup's tile
PASS_ROWS = 128  # rows a block handles per pass: two consumer warpgroups
IMG_BYTES = TILE_ROWS * IMG_ROW_BYTES  # a 64-row image

ALIGN_SLACK = 1024  # the kernels align their dynamic shared memory themselves
ACT_BYTES = 4 * IMG_BYTES  # a consumer warpgroup's activation buffer
FWD_STAGES = 4
BWD_STAGES = 4
DW_STAGES = 3
DW_STAGE_BYTES = 6 * IMG_BYTES  # two X images and up to four dY images


def img_off(r, c):
    """Byte offset of element (r, c) of a tile image (``hopper::img_off``)."""
    return r * IMG_ROW_BYTES + ((((c >> 3) ^ r) & 7) << 4) + ((c & 7) << 1)


def head_width(H: int) -> int:
    return H // 4


def fwd_slot_bytes(H: int) -> int:
    """A forward ring slot (``fwd_slot``): a trunk slab ``[H, 64]`` or the
    heads' output slab ``[16 + 64, 64]``."""
    return max(H, RGB_PAD + C_PAD) * IMG_ROW_BYTES


def bwd_slot_bytes(M: int, H: int) -> int:
    """A backward ring slot (``bwd_slot``): a trunk slab ``[H, 64]``, or a
    first-layer slab ``[2M, 64]`` and a tile's saved encoding."""
    return max(H, 2 * M) * IMG_ROW_BYTES


# ---- slab schedules ------------------------------------------------------------


def fwd_slabs(M: int, H: int, n_hidden: int, heads: bool = True) -> List[Tuple[int, int]]:
    """(byte offset, bytes) of each forward slab, in consumption order."""
    trunk = H * IMG_ROW_BYTES
    slabs = [(i * trunk, trunk) for i in range(2 * M // 64 + (n_hidden - 1) * H // 64)]
    if not heads:
        return slabs
    off = len(slabs) * trunk
    hh = head_width(H) * IMG_ROW_BYTES
    for size in (H // 64 * T_OUT * IMG_ROW_BYTES,  # trunk output: H / 64 [16, 64] images
                 2 * hh,  # heads, first layer: rgb | sem
                 2 * hh,  # second layer
                 RGB_PAD * IMG_ROW_BYTES + IMG_BYTES):  # outputs: rgb [16, 64] | sem [64, 64]
        slabs.append((off, size))
        off += size
    return slabs


def bwd_slabs(M: int, H: int, n_hidden: int, heads: bool = True) -> List[Tuple[int, int]]:
    """(byte offset, bytes) of each backward weight slab, in consumption order."""
    slabs, off = [], 0
    hh = head_width(H) * IMG_ROW_BYTES
    sizes = [2 * hh,  # head outputs back: rgb | sem
             2 * hh,  # second layer back
             2 * 32 * IMG_ROW_BYTES] if heads else []  # first layer back: two [32, 64] images
    sizes.append(H * IMG_ROW_BYTES)  # trunk output back
    sizes += [H * IMG_ROW_BYTES] * ((n_hidden - 1) * H // 64)  # hidden layers n_hidden - 1 .. 1
    sizes += [2 * M * IMG_ROW_BYTES] * (H // 64)  # the first layer: [2M, 64] per 64 outputs
    for size in sizes:
        slabs.append((off, size))
        off += size
    return slabs


def n_bias(M: int, H: int, n_hidden: int) -> int:
    """Width of a row of per-tile column sums (``n_bias()`` of
    ``csrc/fused_field_volrend.cu``): the trunk's pre-activations, its
    output, the four head layers, dphase and the three rows of dW_spec."""
    return n_hidden * H + T_OUT + 4 * head_width(H) + 4 * M


def bias_offsets(H: int, n_hidden: int) -> Dict[str, int]:
    """Float offsets of each layer's bias in the kernels' bias buffer."""
    o, hh = n_hidden * H, head_width(H)
    rb0 = o + T_OUT
    return {"trunk_out": o, "rb0": rb0, "sb0": rb0 + hh, "rb1": rb0 + 2 * hh,
            "sb1": rb0 + 3 * hh, "rb2": rb0 + 4 * hh, "sb2": rb0 + 4 * hh + RGB_PAD,
            "total": rb0 + 4 * hh + RGB_PAD + C_PAD}


# ---- index tables: image = flat_source[index] ----------------------------------


class LeafLayout(NamedTuple):
    """Where each leaf starts in the flat f32 concatenation of the leaves,
    and the index of the zero appended after them."""

    offsets: Tuple[int, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    zero: int


def _layout(shapes) -> LeafLayout:
    offsets, total = [], 0
    for s in shapes:
        offsets.append(total)
        total += int(np.prod(s))
    return LeafLayout(tuple(offsets), tuple(tuple(s) for s in shapes), total)


def _mlp_shapes(widths) -> List[Tuple[int, ...]]:
    shapes: List[Tuple[int, ...]] = []
    for a, b in zip(widths[:-1], widths[1:]):
        shapes += [(a, b), (b,)]
    return shapes


@functools.lru_cache(maxsize=None)
def leaf_layout(M: int, H: int, n_hidden: int, G: int, C: int) -> LeafLayout:
    """The whole field's leaves: W, phase, the trunk's, the rgb head's and
    the semantic head's (w, b) pairs."""
    hh = head_width(H)
    shapes = [(3, M), (M,)] + _mlp_shapes([2 * M] + [H] * n_hidden + [1 + G])
    for a, b in ((SHW + G, hh), (hh, hh), (hh, 3), (G, hh), (hh, hh), (hh, C)):
        shapes += [(a, b), (b,)]
    return _layout(shapes)


@functools.lru_cache(maxsize=None)
def trunk_layout(din: int, H: int, n_hidden: int, out: int) -> LeafLayout:
    """The trunk alone: its (w, b) pairs."""
    return _layout(_mlp_shapes([din] + [H] * n_hidden + [out]))


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


def _trunk_images(lay: LeafLayout, trunk: Sequence[int], M: int, H: int, heads: bool):
    """The trunk's forward and backward images, the trunk being the leaf
    numbers of its weights (biases follow each)."""
    n_hidden = len(trunk) - 1
    fwd = []
    for l in range(n_hidden):
        for kb in range((2 * M if l == 0 else H) // 64):
            fwd.append(_fwd_image(lay, trunk[l], H, k0=64 * kb))
    if heads:
        for kb in range(H // 64):
            fwd.append(_fwd_image(lay, trunk[n_hidden], T_OUT, k0=64 * kb))
    bwd = [_bwd_image(lay, trunk[n_hidden], H)]
    for l in range(n_hidden - 1, 0, -1):
        for kb in range(H // 64):
            bwd.append(_bwd_image(lay, trunk[l], H, k0=64 * kb))
    for kb in range(H // 64):
        bwd.append(_bwd_image(lay, trunk[0], 2 * M, k0=64 * kb))
    return fwd, bwd


def _bias_index(lay: LeafLayout, H: int, trunk: Sequence[int], heads=()):
    """The bias buffer's index table: each layer's bias at its offset, zero
    elsewhere; ``heads`` holds (name, leaf) of the heads' weights."""
    n_hidden = len(trunk) - 1
    offs = bias_offsets(H, n_hidden)
    bias = np.full(offs["total"], lay.zero, dtype=np.int64)

    def put(at, leaf):
        n = lay.shapes[leaf][0]
        bias[at: at + n] = lay.offsets[leaf] + np.arange(n)

    for l in range(n_hidden):
        put(l * H, trunk[l] + 1)
    put(offs["trunk_out"], trunk[n_hidden] + 1)
    for name, leaf in heads:
        put(offs[name], leaf + 1)
    return bias


def _leaf_ids(n_hidden: int):
    """Leaf numbers of the weights: trunk (n_hidden + 1), rgb head, sem head."""
    trunk = [2 + 2 * i for i in range(n_hidden + 1)]
    first = 2 + 2 * (n_hidden + 1)
    return trunk, [first, first + 2, first + 4], [first + 6, first + 8, first + 10]


@functools.lru_cache(maxsize=None)
def index_tables(M: int, H: int, n_hidden: int, G: int, C: int):
    """→ (forward image index, backward image index, bias index) of the
    whole field: int64 arrays into the flat f32 concatenation of the
    leaves followed by one zero. ``flat.to(bf16)[fwd]`` is the forward
    weight buffer, and so on."""
    lay = leaf_layout(M, H, n_hidden, G, C)
    trunk, head, semh = _leaf_ids(n_hidden)
    hh = head_width(H)
    fwd, bwd_trunk = _trunk_images(lay, trunk, M, H, heads=True)
    fwd += [_fwd_image(lay, head[0], hh), _fwd_image(lay, semh[0], hh, k_shift=SHW),
            _fwd_image(lay, head[1], hh), _fwd_image(lay, semh[1], hh),
            _fwd_image(lay, head[2], RGB_PAD), _fwd_image(lay, semh[2], 64)]
    bwd = [_bwd_image(lay, head[2], hh), _bwd_image(lay, semh[2], hh),
           _bwd_image(lay, head[1], hh), _bwd_image(lay, semh[1], hh),
           _bwd_image(lay, head[0], 32), _bwd_image(lay, semh[0], 32, n_shift=SHW)] + bwd_trunk
    bias = _bias_index(lay, H, trunk, (("rb0", head[0]), ("sb0", semh[0]), ("rb1", head[1]),
                                       ("sb1", semh[1]), ("rb2", head[2]), ("sb2", semh[2])))
    fwd, bwd = np.concatenate(fwd), np.concatenate(bwd)
    assert fwd.size * 2 == sum(b for _, b in fwd_slabs(M, H, n_hidden))
    assert bwd.size * 2 == sum(b for _, b in bwd_slabs(M, H, n_hidden))
    return fwd, bwd, bias


@functools.lru_cache(maxsize=None)
def trunk_index_tables(din: int, M: int, H: int, n_hidden: int, out: int):
    """The same three tables for the trunk alone, its leaves ``[w0, b0, ...]``
    with an input ``din <= 2M`` wide (the encoding, or x zero-padded)."""
    lay = trunk_layout(din, H, n_hidden, out)
    trunk = [2 * i for i in range(n_hidden + 1)]
    fwd, bwd = _trunk_images(lay, trunk, M, H, heads=False)
    bias = _bias_index(lay, H, trunk)
    fwd, bwd = np.concatenate(fwd), np.concatenate(bwd)
    assert fwd.size * 2 == sum(b for _, b in fwd_slabs(M, H, n_hidden, heads=False))
    assert bwd.size * 2 == sum(b for _, b in bwd_slabs(M, H, n_hidden, heads=False))
    return fwd, bwd, bias


# ---- shared-memory budgets (mirrors of the .cuh layouts) -----------------------


def fwd_smem_bytes(H: int, n_hidden: int) -> int:
    """``fwd_smem()`` of ``csrc/field_tile.cuh``: the slab ring, one
    activation buffer per consumer warpgroup, the biases, the barriers."""
    bias = -(-bias_offsets(H, n_hidden)["total"] * 4 // 128) * 128
    u_tiles = 2 * 2 * TILE_ROWS * 3 * 4  # per warpgroup: this pass's coordinates and the next's
    return (ALIGN_SLACK + FWD_STAGES * fwd_slot_bytes(H) + 2 * ACT_BYTES + bias + u_tiles
            + 16 * FWD_STAGES)


def bwd_smem_bytes(M: int, H: int) -> int:
    """``bwd_smem()`` of ``csrc/fused_field_volrend.cu``: the slab ring, one
    cotangent buffer and one tile of coordinates per consumer warpgroup, the
    barriers."""
    return (ALIGN_SLACK + BWD_STAGES * bwd_slot_bytes(M, H) + 2 * ACT_BYTES
            + 2 * TILE_ROWS * 3 * 4 + 16 * BWD_STAGES)


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
    n: int  # 64, 128 or 256
    chunks: int


def _matrix_items(x: str, x_imgs: int, y: str, y_imgs: int, n: int) -> list:
    """A weight's items: one product per X image (its 64 input units), two
    an item; an odd one out is taken by both warpgroups, and the host reads
    the first copy."""
    return [(x, x_imgs, (2 * p, min(2 * p + 1, x_imgs - 1)), y, y_imgs, (0, 0), n)
            for p in range(-(-x_imgs // 2))]


def dw_items(M: int, H: int, n_hidden: int, n_tiles: int, n_sm: int,
             heads: bool = True) -> List[DwItem]:
    """The weight-gradient kernel's products, in the order of their outputs:
    per trunk matrix its items (128 input rows each, all H output columns),
    the trunk output's, then with the heads their three layers (rgb on
    warpgroup 0, semantics on 1). The pass is bound by device memory, so an
    item gets row chunks (blocks) in proportion to the images it reads per
    row tile, ``n_sm`` blocks in all."""
    plan = []
    for l in range(n_hidden):
        x, x_imgs = ("enc", 2 * M // 64) if l == 0 else (f"h{l - 1}", H // 64)
        plan += _matrix_items(x, x_imgs, f"gh{l}", H // 64, H)
    plan += _matrix_items(f"h{n_hidden - 1}", H // 64, "gt", 1, 64)
    if heads:
        plan += [("xs", 1, (0, 0), "g1", 2, (0, 1), 64), ("hid1", 2, (0, 1), "g2", 2, (0, 1), 64),
                 ("hid2", 2, (0, 1), "gout", 2, (0, 1), 64)]

    def images(p):  # read per row tile
        return len(set(p[2])) + (p[6] // 64 if p[5][0] == p[5][1] else 2)

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


@functools.lru_cache(maxsize=None)
def dw_plan(M: int, H: int, n_hidden: int, n_tiles: int, n_sm: int,
            heads: bool = True) -> DwPlan:
    rows, block, p_off, out_off = [], 0, 0, 0
    for it in dw_items(M, H, n_hidden, n_tiles, n_sm, heads):
        chunk_tiles = -(-n_tiles // it.chunks)
        chunks = -(-n_tiles // chunk_tiles)  # no chunk is empty
        rows.append((it, chunks, chunk_tiles, block, p_off, out_off))
        size = 2 * TILE_ROWS * it.n
        block += chunks
        p_off += chunks * size
        out_off += size
    return DwPlan(tuple(rows), block, p_off, out_off)


def matrix_grads(plan: DwPlan, out, shapes: Sequence[Tuple[int, int]]):
    """The trunk's weight gradients from the reduced sums ``out`` (the
    ``[2, 64, n]`` block of each item, end to end): the items of a matrix
    are adjacent and stack into its rows → one ``[in, out]`` view per shape,
    the trunk's matrices in order (the heads' items follow them)."""
    grads, i = [], 0
    for rows, cols in shapes:
        it, *_, off = plan.items[i]
        k = -(-rows // 128)
        grads.append(out[off: off + k * 128 * it.n].view(k * 128, it.n)[:rows, :cols])
        i += k
    return grads, i


_WIDTHS_TEXT = (f"M in {M_SET}, H in {H_SET}, heads H / 4, 2 or 3 hidden layers, "
                f"geo 1..{MAX_GEO}, classes 1..{MAX_CLASSES}")


def check_widths(who: str, shapes: Sequence[Tuple[int, ...]]):
    """Raise unless the leaves' shapes are a field these kernels take →
    (M, H, n_hidden, G, C)."""
    if len(shapes) % 2 or len(shapes) < 2 + 12:
        raise ValueError(f"{who}: W, phase, then (w, b) pairs")
    n_trunk = (len(shapes) - 2 - 12) // 2
    if n_trunk not in (3, 4):
        raise ValueError(f"{who}: the trunk needs 2 or 3 hidden layers and each head 2 "
                         f"(the kernels take {_WIDTHS_TEXT})")
    n_hidden = n_trunk - 1
    m = shapes[0][1] if len(shapes[0]) == 2 else -1
    h = shapes[2][1] if len(shapes[2]) == 2 else -1
    out_t = shapes[2 + 2 * n_hidden][1] if len(shapes[2 + 2 * n_hidden]) == 2 else -1
    first = 2 + 2 * n_trunk
    hh = shapes[first][1] if len(shapes[first]) == 2 else -1
    C = shapes[first + 10][1] if len(shapes[first + 10]) == 2 else -1
    G = out_t - 1
    if (m not in M_SET or h not in H_SET or hh != head_width(h) or not 1 <= G <= MAX_GEO
            or not 1 <= C <= MAX_CLASSES):
        raise ValueError(
            f"{who}: unsupported widths M={m} H={h} head={hh} geo={G} classes={C} (the "
            f"kernels take {_WIDTHS_TEXT})")
    want = leaf_layout(m, h, n_hidden, G, C).shapes
    for i, (got, exp) in enumerate(zip(shapes, want)):
        if tuple(got) != tuple(exp):
            raise ValueError(f"{who}: leaf {i} has shape {tuple(got)}, expected {tuple(exp)}")
    return m, h, n_hidden, G, C


def check_trunk(who: str, shapes: Sequence[Tuple[int, ...]], m: int = 0):
    """Raise unless the (w, b) pairs' shapes are a trunk the tile takes: the
    encode of ``m`` frequencies (a multiple of 8 up to ``max(M_SET)``, the
    input 2m wide) or, with ``m = 0``, an input x at most ``MAX_DIN`` wide,
    a multiple of 16; H a multiple of 16 up to ``max(H_SET)``; 2 or 3 hidden
    layers; an output of at most 16 → (din, M, H of the instance it runs on,
    n_hidden, out). The instance is the smallest (M, H) of the tile that
    covers the input and the width: a trunk between two is zero-padded up
    to it (``field_train.pad_trunk``)."""
    if len(shapes) % 2 or len(shapes) // 2 not in (3, 4):
        raise ValueError(f"{who}: the trunk needs 2 or 3 hidden layers, as (w, b) pairs")
    n_hidden = len(shapes) // 2 - 1
    din = shapes[0][0] if len(shapes[0]) == 2 else -1
    h = shapes[0][1] if len(shapes[0]) == 2 else -1
    out = shapes[-2][1] if len(shapes[-2]) == 2 else -1
    ok_in = (din == 2 * m and m % 8 == 0 and 0 < m <= max(M_SET) if m
             else 0 < din <= MAX_DIN and din % 16 == 0)
    if not ok_in or not (0 < h <= max(H_SET) and h % 16 == 0) or not 1 <= out <= T_OUT:
        raise ValueError(
            f"{who}: unsupported trunk widths in={din} H={h} out={out} (the tile takes the "
            f"encode of a multiple of 8 up to {max(M_SET)} frequencies or an input that is a "
            f"multiple of 16 up to {MAX_DIN}, H a multiple of 16 up to {max(H_SET)}, an output "
            f"of 1..{T_OUT})")
    want = trunk_layout(din, h, n_hidden, out).shapes
    for i, (got, exp) in enumerate(zip(shapes, want)):
        if tuple(got) != tuple(exp):
            raise ValueError(f"{who}: leaf {i} has shape {tuple(got)}, expected {tuple(exp)}")
    M = min(x for x in M_SET if 2 * x >= din)
    return din, M, min(x for x in H_SET if x >= h), n_hidden, out
