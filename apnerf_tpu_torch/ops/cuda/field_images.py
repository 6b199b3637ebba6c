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

**The first layer** is multiplied one 64-column k-block of its input at a
time, a run-time count ``n_kb`` of them: the encoding of m frequencies is
``[cos of m | sin of m]`` zero-padded to ``ceil(2m / 64)`` blocks, the
plain chain's own column order, so the kernels sum what it sums, 16-column
step by step (another order changes the sums' f32 rounding and with it
bf16 roundings of hidden units); an input x is ``ceil(din / 64)`` blocks.
Where the blocks do not fit a tile's buffer the forward forms them one at
a time. The backward walks
the first layer in other blocks: 32 frequencies each, two groups of 16 as
``[cos 16 | sin 16]`` (``pair_rows``), so that one thread holds a
frequency's cos and sin cotangents.

**Forward slabs** (``B[n][k] = w[k0 + k][n]``, rows are output units): a
trunk layer as one ``[H, 64]`` image per k-block of its input, then with
the heads the trunk's last layer as H / 64 ``[T_out, 64]`` images and per
head layer the rgb and the semantic images side by side (the semantic
head's first layer at input rows 16.., so both heads read the same ``[SH |
geo | 0]`` input, one image up to T_out = 48 and two at 64, its k-blocks;
the output layer's rgb images with the first 64 semantic columns, then 64
semantic columns a slab), or for the trunk alone its output layer 16
columns a slab.

**Backward slabs** (``B[n][k] = w[n][k0 + k]``, rows are input units), in
the order the field backward walks: heads from the top (the output layer's
rgb with its first 64 semantic columns, then 64 semantic columns a slab),
the trunk's last layer (64 of its columns a slab), the hidden layers
downwards, then the first layer: per group of ``back_group`` blocks (up to
four in one product) one ``[64 G, 64]`` slab per 64 of the trunk's units
(the trunk alone has no head slabs).

**Widths.** The kernels are instances of the trunk width H in ``H_SET``,
with heads H / 4 wide, and of the whole field's tier (T_out, C_pad) in
``TIERS``: the trunk output ``1 + geo`` and the classes padded. A field or
a trunk runs on the smallest instance at least as wide as it, its units
past its own width zero (zero weights and biases, which stay zero through
every ReLU, so every output and every gradient of its own entries is
exact), and a field on the smallest tier that takes both its geometry
features and its classes: the index tables here do the padding, for the
whole field (``prepare_field``) and for the trunk alone
(``field_train.TrunkCall``) alike. So a field takes any H from 4 to 1024
with heads H // 4, any number of frequencies (at most 256 past H = 512,
where the first layer's input lies in a tile's buffer at once), 1 to 63
geometry features and 1 to 1024 classes, 2 or 3 hidden layers
(``check_widths``); a trunk alone any H from 1 to 1024, the encode of any
number of frequencies or an input that is a multiple of 16 wide, and any
output width (past H = 512: an input of at most 512 columns or 256
frequencies, an output of at most 1024; ``check_trunk``).
"""

from __future__ import annotations

import functools
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from .launch import MAX_SMEM

H_SET = (64, 128, 256, 512, 1024)  # trunk widths of the instances; the heads are H / 4 wide
WIDTHS = H_SET  # APNERF_TILE_WIDTHS
# the whole field's tiers (APNERF_FIELD_TIERS): the trunk output's width
# (1 + geo) and the semantic output's (classes), padded
TIERS = ((16, 64), (32, 128), (48, 256), (64, 1024))
SHW = 16  # SH features of a direction
RGB_PAD = 16  # rgb head output width, padded
SEM_CHUNK = 64  # semantic output columns a forward slab and a backward block
OUT_CHUNK = 16  # the trunk alone's output columns a forward slab
MAX_GEO = TIERS[-1][0] - 1
MAX_CLASSES = TIERS[-1][1]
BLOCK_FREQS = 32  # frequencies of a k-block of the encoding

IMG_COLS = 64
IMG_ROW_BYTES = 128
TILE_ROWS = 64  # rows of one tile
IMG_BYTES = TILE_ROWS * IMG_ROW_BYTES  # a 64-row image

ALIGN_SLACK = 1024  # the kernels align their dynamic shared memory themselves
BUF_BYTES = 8 * IMG_BYTES  # the consumers' activation buffers, together, up to H = 512
MAX_IN_BLOCKS_1024 = 8  # the first layer's k-blocks at H = 1024, where they lie in place
U_TILE_BYTES = TILE_ROWS * 3 * 4
Y_STAGE_BYTES = TILE_ROWS * 16 * 4
DP_BYTES = TILE_ROWS * BLOCK_FREQS * 4
DW_STAGES = 3
DW_STAGE_BYTES = 6 * IMG_BYTES  # two X images and up to four dY images


def img_off(r, c):
    """Byte offset of element (r, c) of a tile image (``hopper::img_off``)."""
    return r * IMG_ROW_BYTES + ((((c >> 3) ^ r) & 7) << 4) + ((c & 7) << 1)


def instance(h: int) -> int:
    """The instance a trunk ``h`` wide runs on: the smallest in ``H_SET``
    at least as wide."""
    return min(x for x in H_SET if x >= h)


def head_width(H: int) -> int:
    return H // 4


def tier(G: int, C: int) -> Tuple[int, int]:
    """The tier (T_out, C_pad) a field of G geometry features and C classes
    runs on: the first of ``TIERS`` that takes both."""
    return next(t for t in TIERS if 1 + G <= t[0] and C <= t[1])


def split(H: int) -> int:
    """Warpgroups that share a tile's columns (``Tile::kSplit``)."""
    return 2 if H > 256 else 1


def halves(H: int) -> int:
    """Products of n <= 256 a warpgroup forms its columns in
    (``Tile::kNh``): two at H = 1024."""
    return 2 if H > 512 else 1


def per_image(H: int) -> bool:
    """Whether the heads' layers go one image a slab and the trunk output
    one k-block a slab (``Tile::kPerImage``): at H = 1024."""
    return H > 512


def buf_bytes(H: int) -> int:
    """The consumers' activation buffers, together (``buf_bytes``)."""
    return 2 * BUF_BYTES if H > 512 else BUF_BYTES


def keep_bytes(H: int) -> int:
    """Device memory a block keeps a layer's first half of results in
    (``keep_words``): 64 KB at H = 1024, else none."""
    return 64 * 256 * 4 if halves(H) > 1 else 0


def mask_cols(H: int) -> int:
    """uint2 mask words of a trunk layer per (row, lane % 4): one per
    warpgroup and product."""
    return split(H) * halves(H)


def head_mask_words(H: int) -> int:
    """uint2 words of the heads' masks per (row, lane % 4, warpgroup)
    (``Tile::kMhw``): two where a warpgroup forms more than 64 head columns."""
    return 2 if head_width(H) // split(H) > 64 else 1


def pass_rows(H: int) -> int:
    """Rows a block handles per pass (``Tile::kPassRows``): two tiles, one at
    H = 512."""
    return TILE_ROWS * 2 // split(H)


def head_imgs(H: int) -> int:
    """Images of a head's activation (``Tile::kHI``)."""
    return -(-head_width(H) // 64)


def xs_imgs(t_out: int) -> int:
    """Images of the heads' input ``[SH 16 | geo | 0]`` at the tier's
    T_out: one up to T_out = 48, two at 64."""
    return -(-(SHW + t_out) // 64)


def stages(H: int) -> int:
    """Slots of the forward and backward rings (``fwd_stages``)."""
    return 1 if H > 512 else 2 if H > 256 else 4


def trunk_slab_bytes(H: int) -> int:
    """A trunk slab (``trunk_slab``): ``[H, 64]``, or at H = 1024 ``[512,
    64]``, both warpgroups' rows of one half of a layer's columns."""
    return (H // halves(H)) * IMG_ROW_BYTES


def fwd_slot_bytes(H: int) -> int:
    """A forward ring slot (``fwd_slot``): a trunk slab, the heads' first
    or second layers (at H = 1024 one image a slab) or the first of their
    output slabs."""
    hh, hi = head_width(H), head_imgs(H)
    heads = hh if per_image(H) else 2 * hi * hh
    return max(trunk_slab_bytes(H), heads * IMG_ROW_BYTES,
               hi * (RGB_PAD + SEM_CHUNK) * IMG_ROW_BYTES)


def bwd_slot_bytes(H: int) -> int:
    """A backward ring slot (``bwd_slot``): a trunk slab, a first-layer
    slab ``[64 G, 64]``, the heads' slabs or a tile's saved encoding (up to
    four images)."""
    return max(trunk_slab_bytes(H), 4 * IMG_BYTES)


def back_group(n_back: int, n_gt: int = 1, H: int = 64) -> int:
    """The kernel instance of the backward (``back_group``, its kG) for
    ``n_back`` first-layer blocks and ``n_gt`` blocks of the trunk output's
    cotangent at the instance ``H``: all first-layer blocks in one product
    of kG blocks, up to four, with one trunk-output block; or 0: one block a
    product, any number of trunk-output blocks (the only one at H = 1024)."""
    if n_gt > 1 or H > 512:
        return 0
    return 1 if n_back == 1 else 2 if n_back == 2 else 4 if n_back <= 4 else 0


def back_blocks(n_back: int, n_gt: int = 1, H: int = 64) -> int:
    """The backward's first-layer blocks, whole products (``back_group``)."""
    g = back_group(n_back, n_gt, H) or 1
    return -(-n_back // g) * g


def enc_blocks(m: int) -> int:
    """Forward k-blocks of the encoding of m frequencies, [cos | sin]."""
    return -(-2 * m // 64)


def x_blocks(din: int) -> int:
    """k-blocks of an input x ``din`` wide."""
    return -(-din // 64)


def pair_blocks(m: int) -> int:
    """The backward's first-layer blocks of the encode: 32 frequencies each."""
    return -(-m // BLOCK_FREQS)


@functools.lru_cache(maxsize=None)
def enc_rows(m: int) -> np.ndarray:
    """Column r of the kernels' forward encoding → the row of w0 ([cos of m
    | sin of m]) it multiplies, or -1 past them."""
    r = np.arange(64 * enc_blocks(m))
    return np.where(r < 2 * m, r, -1)


@functools.lru_cache(maxsize=None)
def pair_rows(m: int) -> np.ndarray:
    """Column r of the backward's first-layer blocks → the row of w0, or -1:
    blocks of 32 frequencies, each two groups ``[cos 16 | sin 16]``."""
    r = np.arange(BLOCK_FREQS * 2 * pair_blocks(m))
    f = 16 * (r // 32) + r % 16
    return np.where(f < m, np.where(r % 32 < 16, f, m + f), -1)


def out_chunks(out: int) -> int:
    """Slabs of the trunk alone's output layer in the forward: 16 columns each."""
    return -(-out // 16)


def gt_blocks(out: int) -> int:
    """64-column k-blocks of the trunk alone's output cotangent."""
    return -(-out // 64)


# ---- slab schedules ------------------------------------------------------------


def fwd_slabs(H: int, n_hidden: int, n_kb: int, heads: bool = True, out: int = 0,
              t_out: int = TIERS[0][0], c_tile: int = TIERS[0][1]) -> List[Tuple[int, int]]:
    """(byte offset, bytes) of each forward slab, in consumption order; the
    whole field at the tier (``t_out``, ``c_tile``), or the trunk alone's
    output layer (``out`` > 0) 16 columns a slab. At H = 1024 every trunk
    layer goes in two halves, the trunk output one k-block a slab and the
    heads' layers one image a slab."""
    trunk = trunk_slab_bytes(H)
    slabs = [(i * trunk, trunk) for i in range(halves(H) * (n_kb + (n_hidden - 1) * H // 64))]
    off = len(slabs) * trunk
    hh, hi, xi = head_width(H) * IMG_ROW_BYTES, head_imgs(H), xs_imgs(t_out)
    n_out, n_l1, n_l2 = (H // 64, 2 * xi, 2 * hi) if per_image(H) else (1, 1, 1)
    sizes = ([H // 64 * t_out * IMG_ROW_BYTES // n_out] * n_out  # trunk output: [T_out, 64] each
             + [2 * xi * hh // n_l1] * n_l1  # heads, first layer: rgb's k-blocks | sem's
             + [2 * hi * hh // n_l2] * n_l2  # second layer: rgb's k-blocks | sem's
             + [hi * (RGB_PAD + SEM_CHUNK) * IMG_ROW_BYTES]  # outputs: rgb [16, 64] | sem [64, 64]
             + [hi * SEM_CHUNK * IMG_ROW_BYTES] * (c_tile // SEM_CHUNK - 1)  # sem's next 64
             if heads else [H // 64 * OUT_CHUNK * IMG_ROW_BYTES] * out_chunks(out))
    for size in sizes:
        slabs.append((off, size))
        off += size
    return slabs


def bwd_slabs(H: int, n_hidden: int, n_back: int, heads: bool = True, out: int = 0,
              t_out: int = TIERS[0][0], c_tile: int = TIERS[0][1]) -> List[Tuple[int, int]]:
    """(byte offset, bytes) of each backward weight slab, in consumption
    order; ``n_back`` first-layer blocks (``pair_blocks`` of the encode, or
    x's k-blocks); the whole field at the tier (``t_out``, ``c_tile``). At
    H = 1024 every trunk layer goes in two halves and the heads' layers
    back one image a slab."""
    slabs, off = [], 0
    hh, hi = head_width(H) * IMG_ROW_BYTES, head_imgs(H)
    n_img = 2 * hi if per_image(H) else 1
    sizes = ([2 * hh]  # head outputs back: rgb | sem's first 64 classes
             + [hh] * (c_tile // SEM_CHUNK - 1)  # sem's next 64
             + [2 * hi * hh // n_img] * n_img  # second layer back
             + [2 * hi * (SHW + t_out) * IMG_ROW_BYTES // n_img] * n_img  # first layer back
             if heads else [])
    trunk = trunk_slab_bytes(H)
    sizes += [trunk] * halves(H) * (1 if heads else gt_blocks(out))  # trunk output back
    sizes += [trunk] * halves(H) * ((n_hidden - 1) * H // 64)  # hidden layers n_hidden - 1 .. 1
    n_gt = 1 if heads else gt_blocks(out)
    g = back_group(n_back, n_gt, H) or 1  # the first layer: [64 g, 64] a product and 64 units
    sizes += [64 * g * IMG_ROW_BYTES] * (back_blocks(n_back, n_gt, H) // g * H // 64)
    for size in sizes:
        slabs.append((off, size))
        off += size
    return slabs


def t_pad(heads: bool, out: int, t_out: int = TIERS[0][0]) -> int:
    """Columns of the trunk output's cotangent in a row of tile sums: the
    tier's ``t_out`` for the whole field, the trunk alone's output padded
    to 64."""
    return t_out if heads else 64 * gt_blocks(out)


def n_bias(H: int, n_hidden: int, tpad: int, mp: int) -> int:
    """Width of a row of per-tile column sums (``n_bias()`` of
    ``csrc/fused_field_volrend.cu``): the trunk's pre-activations, its
    output, the four head layers, dphase and the three rows of dW_spec over
    ``mp`` (padded) frequencies."""
    return n_hidden * H + tpad + 4 * head_width(H) + 4 * mp


def bias_offsets(H: int, n_hidden: int, t_out: int = TIERS[0][0],
                 c_tile: int = TIERS[0][1]) -> Dict[str, int]:
    """Float offsets of each layer's bias in the kernels' bias buffer at the
    tier (``t_out``, ``c_tile``) (the trunk alone: the hidden layers', then
    its output's at ``trunk_out``)."""
    o, hh = n_hidden * H, head_width(H)
    rb0 = o + t_out
    return {"trunk_out": o, "rb0": rb0, "sb0": rb0 + hh, "rb1": rb0 + 2 * hh,
            "sb1": rb0 + 3 * hh, "rb2": rb0 + 4 * hh, "sb2": rb0 + 4 * hh + RGB_PAD,
            "total": rb0 + 4 * hh + RGB_PAD + c_tile}


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
def leaf_layout(m: int, h: int, n_hidden: int, G: int, C: int) -> LeafLayout:
    """The whole field's leaves: W, phase, the trunk's, the rgb head's and
    the semantic head's (w, b) pairs; the heads ``h // 4`` wide."""
    hh = head_width(h)
    shapes = [(3, m), (m,)] + _mlp_shapes([2 * m] + [h] * n_hidden + [1 + G])
    for a, b in ((SHW + G, hh), (hh, hh), (hh, 3), (G, hh), (hh, hh), (hh, C)):
        shapes += [(a, b), (b,)]
    return _layout(shapes)


@functools.lru_cache(maxsize=None)
def trunk_layout(din: int, h: int, n_hidden: int, out: int) -> LeafLayout:
    """The trunk alone: its (w, b) pairs."""
    return _layout(_mlp_shapes([din] + [h] * n_hidden + [out]))


def _image_index(rows: int, src_index) -> np.ndarray:
    """The flat index table of one image: ``src_index(r, c)`` gives the
    source index of element (r, c) as an int64 array."""
    r, c = np.arange(rows)[:, None], np.arange(IMG_COLS)[None, :]
    out = np.empty(rows * IMG_COLS, dtype=np.int64)
    out[img_off(r, c) // 2] = np.broadcast_to(src_index(r, c), (rows, IMG_COLS))
    return out


def _weight(lay: LeafLayout, leaf: int, rows: Optional[np.ndarray] = None):
    """→ ``at(i, j)``: the flat index of ``w[i, j]``, or of the zero where
    that element does not exist; ``rows`` maps i (the kernels' order) to the
    leaf's row first (-1: none)."""
    w_in, w_out = lay.shapes[leaf]
    base = lay.offsets[leaf]

    def at(i, j):
        i, j = np.asarray(i), np.asarray(j)
        if rows is not None:
            ok = (i >= 0) & (i < len(rows))
            i = np.where(ok, rows[np.clip(i, 0, len(rows) - 1)], -1)
        ok = (i >= 0) & (i < w_in) & (j >= 0) & (j < w_out)
        return np.where(ok, base + i * w_out + j, lay.zero)

    return at


def _fwd_image(at, rows: int, k0: int = 0, n0: int = 0):
    """B[n][k] = w[k0 + k][n0 + n]."""
    return _image_index(rows, lambda n, k: at(k0 + k, n0 + n))


def _bwd_image(at, rows: int, k0: int = 0, n0: int = 0, n_shift: int = 0):
    """B[n][k] = w[n0 + n - n_shift][k0 + k]."""
    return _image_index(rows, lambda n, k: at(n0 + n - n_shift, k0 + k))


def _unit_rows(H: int, hf: int) -> np.ndarray:
    """The units (a layer's output columns in the forward, its input rows in
    the backward) of the rows of a trunk slab of half ``hf``: all H, or at H
    = 1024 each warpgroup's 256 of that half, warpgroup 0's first."""
    r = np.arange(H // halves(H))
    if halves(H) == 1:
        return r
    w = H // split(H) // halves(H)  # the columns of one product
    return (r // w) * (H // split(H)) + hf * w + r % w


def _rows_image(at, units: np.ndarray, k0: int, forward: bool):
    """A trunk slab: B[n][k] = w[k0 + k][units[n]] (forward) or w[units[n]][k0
    + k] (backward)."""
    if forward:
        return _image_index(len(units), lambda n, k: at(k0 + k, units[n]))
    return _image_index(len(units), lambda n, k: at(units[n], k0 + k))


def _trunk_images(lay: LeafLayout, trunk: Sequence[int], rows: np.ndarray,
                  back_rows: np.ndarray, H: int, heads: bool, out: int = 0,
                  t_out: int = TIERS[0][0]):
    """The trunk's forward and backward images, the trunk being the leaf
    numbers of its weights (biases follow each), ``rows`` the first layer's
    input rows in the forward's column order (its k-blocks) and
    ``back_rows`` in the backward's; with the heads the trunk output
    ``t_out`` columns wide. A layer's slabs go half by half (two at H =
    1024), each over every k-block of its input."""
    n_hidden = len(trunk) - 1
    n_kb = len(rows) // 64
    first = _weight(lay, trunk[0], rows)
    back = _weight(lay, trunk[0], back_rows)
    ws = [first] + [_weight(lay, t) for t in trunk[1:]]
    units = [_unit_rows(H, hf) for hf in range(halves(H))]
    fwd = [_rows_image(first, u, 64 * b, True) for u in units for b in range(n_kb)]
    for l in range(1, n_hidden):
        fwd += [_rows_image(ws[l], u, 64 * kb, True) for u in units for kb in range(H // 64)]
    if heads:
        fwd += [_fwd_image(ws[n_hidden], t_out, k0=64 * kb) for kb in range(H // 64)]
    for ch in range(0 if heads else out_chunks(out)):
        fwd += [_fwd_image(ws[n_hidden], OUT_CHUNK, k0=64 * kb, n0=OUT_CHUNK * ch)
                for kb in range(H // 64)]
    n_gt = 1 if heads else gt_blocks(out)
    bwd = [_rows_image(ws[n_hidden], u, 64 * t, False) for u in units for t in range(n_gt)]
    for l in range(n_hidden - 1, 0, -1):
        bwd += [_rows_image(ws[l], u, 64 * kb, False) for u in units for kb in range(H // 64)]
    n_back = len(back_rows) // 64
    g = back_group(n_back, n_gt, H) or 1
    for grp in range(back_blocks(n_back, n_gt, H) // g):
        bwd += [_bwd_image(back, 64 * g, k0=64 * kb, n0=64 * g * grp) for kb in range(H // 64)]
    return fwd, bwd


def _bias_index(lay: LeafLayout, H: int, trunk: Sequence[int], total: int, heads=(),
                offs: Optional[Dict[str, int]] = None):
    """The bias buffer's index table: each layer's bias at its offset
    (``offs``, the first tier's by default), zero elsewhere; ``heads``
    holds (name, leaf) of the heads' weights."""
    n_hidden = len(trunk) - 1
    offs = offs or bias_offsets(H, n_hidden)
    bias = np.full(total, lay.zero, dtype=np.int64)

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
def index_tables(m: int, h: int, n_hidden: int, G: int, C: int):
    """→ (forward image index, backward image index, bias index) of the
    whole field of these widths on its instance ``instance(h)`` and its
    tier ``tier(G, C)``: int64 arrays into the flat f32 concatenation of
    the leaves followed by one zero. ``flat.to(bf16)[fwd]`` is the forward
    weight buffer, and so on."""
    H, (t_out, c_tile) = instance(h), tier(G, C)
    lay = leaf_layout(m, h, n_hidden, G, C)
    trunk, head, semh = _leaf_ids(n_hidden)
    hh, hi = head_width(H), head_imgs(H)
    fwd, bwd_trunk = _trunk_images(lay, trunk, enc_rows(m), pair_rows(m), H, heads=True,
                                   t_out=t_out)
    rgb = [_weight(lay, leaf) for leaf in head]
    sem = [_weight(lay, leaf) for leaf in semh]
    xi = xs_imgs(t_out)

    def sem0(i, j):  # the semantic head's first layer at input rows SHW..
        return sem[0](np.asarray(i) - SHW, j)

    fwd += [_fwd_image(w, hh, k0=64 * kb) for w in (rgb[0], sem0) for kb in range(xi)]
    fwd += [_fwd_image(w[1], hh, k0=64 * kb) for w in (rgb, sem) for kb in range(hi)]
    fwd += [_fwd_image(rgb[2], RGB_PAD, k0=64 * kb) for kb in range(hi)]
    fwd += [_fwd_image(sem[2], SEM_CHUNK, k0=64 * kb, n0=SEM_CHUNK * ch)
            for ch in range(c_tile // SEM_CHUNK) for kb in range(hi)]
    bwd = [_bwd_image(rgb[2], hh)]
    bwd += [_bwd_image(sem[2], hh, k0=SEM_CHUNK * ch) for ch in range(c_tile // SEM_CHUNK)]
    bwd += [_bwd_image(w[1], hh, k0=64 * kb) for w in (rgb, sem) for kb in range(hi)]
    bwd += [_bwd_image(rgb[0], SHW + t_out, k0=64 * kb) for kb in range(hi)]
    bwd += [_bwd_image(sem[0], SHW + t_out, k0=64 * kb, n_shift=SHW) for kb in range(hi)]
    bwd += bwd_trunk
    offs = bias_offsets(H, n_hidden, t_out, c_tile)
    bias = _bias_index(lay, H, trunk, offs["total"],
                       (("rb0", head[0]), ("sb0", semh[0]), ("rb1", head[1]), ("sb1", semh[1]),
                        ("rb2", head[2]), ("sb2", semh[2])), offs)
    fwd, bwd = np.concatenate(fwd), np.concatenate(bwd)
    assert fwd.size * 2 == sum(b for _, b in fwd_slabs(H, n_hidden, enc_blocks(m), True, 0,
                                                       t_out, c_tile))
    assert bwd.size * 2 == sum(b for _, b in bwd_slabs(H, n_hidden, pair_blocks(m), True, 0,
                                                       t_out, c_tile))
    return fwd, bwd, bias


@functools.lru_cache(maxsize=None)
def trunk_index_tables(din: int, m: int, h: int, n_hidden: int, out: int):
    """The same three tables for the trunk alone, its leaves ``[w0, b0, ...]``
    on the encode of ``m`` frequencies (``din = 2m``) or, with ``m = 0``, on
    an input x ``din`` wide."""
    H = instance(h)
    lay = trunk_layout(din, h, n_hidden, out)
    trunk = [2 * i for i in range(n_hidden + 1)]
    rows = enc_rows(m) if m else np.arange(64 * x_blocks(din))
    back_rows = pair_rows(m) if m else rows
    fwd, bwd = _trunk_images(lay, trunk, rows, back_rows, H, heads=False, out=out)
    bias = _bias_index(lay, H, trunk, n_hidden * H + 16 * out_chunks(out))
    fwd, bwd = np.concatenate(fwd), np.concatenate(bwd)
    assert fwd.size * 2 == sum(b for _, b in fwd_slabs(H, n_hidden, len(rows) // 64, False, out))
    assert bwd.size * 2 == sum(b for _, b in bwd_slabs(H, n_hidden, len(back_rows) // 64, False,
                                                       out))
    return fwd, bwd, bias


# ---- shared-memory budgets (mirrors of the .cuh layouts) -----------------------


def fwd_smem_bytes(H: int, n_hidden: int, t_out: int = TIERS[0][0],
                   c_tile: int = TIERS[0][1]) -> int:
    """``fwd_smem()`` of ``csrc/field_tile.cuh`` at the tier (``t_out``,
    ``c_tile``): the slab ring, the activation buffers, the biases, two
    tiles of coordinates per tile, the trunk output's staging, the
    barriers."""
    bias = -(-bias_offsets(H, n_hidden, t_out, c_tile)["total"] * 4 // 128) * 128
    return (ALIGN_SLACK + stages(H) * fwd_slot_bytes(H) + buf_bytes(H) + bias + 4 * U_TILE_BYTES
            + 2 * Y_STAGE_BYTES + 16 * stages(H))


def bwd_smem_bytes(H: int) -> int:
    """``bwd_smem()`` of ``csrc/fused_field_volrend.cu``: the slab ring, the
    cotangent buffers, a tile of coordinates and a k-block's f32 dproj per
    tile, the barriers."""
    return (ALIGN_SLACK + stages(H) * bwd_slot_bytes(H) + buf_bytes(H) + 2 * U_TILE_BYTES
            + 2 * DP_BYTES + 16 * stages(H))


def dw_smem_bytes() -> int:
    """``dw_smem()`` of ``csrc/fused_field_volrend.cu``."""
    return ALIGN_SLACK + DW_STAGES * DW_STAGE_BYTES + 16 * DW_STAGES


# ---- launch plans ----------------------------------------------------------------


def padded_rows(n_rows: int, H: int = 64) -> int:
    """Rows of the scratch buffers: whole passes of the instance H."""
    p = pass_rows(H)
    return -(-n_rows // p) * p


def field_grid(n_rows: int, n_sm: int, H: int = 64) -> int:
    """Blocks of the persistent field kernels: one per SM, each walking
    passes ``blockIdx, blockIdx + grid, ...`` of ``pass_rows(H)`` rows."""
    return max(1, min(n_sm, padded_rows(n_rows, H) // pass_rows(H)))


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


def _col_groups(y_imgs: int) -> List[Tuple[int, int]]:
    """A matrix's dY images in groups a product takes at once → (first
    image, n), n in 256, 128, 64."""
    out, y0 = [], 0
    while y0 < y_imgs:
        k = 4 if y_imgs - y0 >= 4 else 2 if y_imgs - y0 >= 2 else 1
        out.append((y0, 64 * k))
        y0 += k
    return out


def _matrix_items(x: str, x_imgs: int, y: str, y_imgs: int) -> list:
    """A weight's items: per pair of X images (128 input units: one a
    warpgroup; an odd one out is taken by both, and the host reads the first
    copy) one item per group of its dY images."""
    return [(x, x_imgs, (2 * p, min(2 * p + 1, x_imgs - 1)), y, y_imgs, (y0, y0), n)
            for p in range(-(-x_imgs // 2)) for y0, n in _col_groups(y_imgs)]


def _head_items(H: int, c_tile: int = TIERS[0][1], t_out: int = TIERS[0][0]) -> list:
    """The heads' items: first layer (X = the heads' input, one item per
    image of it), second, output (dY = ``gout``: the rgb image, then
    ``c_tile`` / 64 semantic images); one head a warpgroup, or at H / 4 =
    128 one item a head. Past 64 classes the output layer is an item for
    rgb on both warpgroups and the semantic columns in items of at most 256:
    split between the warpgroups (at H / 4 = 128: shared)."""
    k, ns, xi = head_imgs(H), c_tile // SEM_CHUNK, xs_imgs(t_out)
    ng = 1 + ns
    if k == 1:
        first = [("xs", xi, (x, x), "g1", 2, (0, 1), 64) for x in range(xi)]
        second = [("hid1", 2, (0, 1), "g2", 2, (0, 1), 64)]
        if ns == 1:
            return first + second + [("hid2", 2, (0, 1), "gout", ng, (0, 1), 64)]
        per = min(2, ns // 2)  # semantic images a warpgroup of an item
        return first + second + [("hid2", 2, (0, 0), "gout", ng, (0, 0), 64)] + [
            ("hid2", 2, (1, 1), "gout", ng, (1 + j, 1 + j + per), 64 * per)
            for j in range(0, ns, 2 * per)]
    # H / 4 = 128 or 256: per head, its X images in pairs (128 input rows on
    # both warpgroups) and its dY images in groups of at most 256 columns
    return ([("xs", xi, (x, x), "g1", 2 * k, (j, k + j), 64 * min(2, k - j))
             for x in range(xi) for j in range(0, k, 2)]
            + [("hid1", 2 * k, (hd * k + 2 * p, hd * k + 2 * p + 1), "g2", 2 * k,
                (hd * k + y, hd * k + y), 64 * min(4, k - y))
               for hd in (0, 1) for p in range(k // 2) for y in range(0, k, 4)]
            + [("hid2", 2 * k, (2 * p, 2 * p + 1), "gout", ng, (0, 0), 64) for p in range(k // 2)]
            + [("hid2", 2 * k, (k + 2 * p, k + 2 * p + 1), "gout", ng, (1 + j, 1 + j),
                64 * min(4, ns - j)) for p in range(k // 2) for j in range(0, ns, 4)])


def dw_items(H: int, n_hidden: int, n_kb: int, n_tiles: int, n_sm: int, heads: bool = True,
             out: int = 0, c_tile: int = TIERS[0][1], t_out: int = TIERS[0][0]) -> List[DwItem]:
    """The weight-gradient kernel's products, in the order of their outputs:
    per trunk matrix its items, the trunk output's, then with the heads
    theirs at the tier (``t_out``, ``c_tile``). The pass is bound by
    device memory, so an item gets row chunks (blocks) in proportion to the
    images it reads per row tile, ``n_sm`` blocks in all."""
    hi = H // 64
    plan = []
    for l in range(n_hidden):
        x, x_imgs = ("enc", n_kb) if l == 0 else (f"h{l - 1}", hi)
        plan += _matrix_items(x, x_imgs, f"gh{l}", hi)
    plan += _matrix_items(f"h{n_hidden - 1}", hi, "gt", 1 if heads else gt_blocks(out))
    if heads:
        plan += _head_items(H, c_tile, t_out)

    def images(p):  # read per row tile
        return len(set(p[2])) + p[6] // 64 * len(set(p[5]))

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
def dw_plan(H: int, n_hidden: int, n_kb: int, n_tiles: int, n_sm: int, heads: bool = True,
            out: int = 0, c_tile: int = TIERS[0][1], t_out: int = TIERS[0][0]) -> DwPlan:
    rows, block, p_off, out_off = [], 0, 0, 0
    for it in dw_items(H, n_hidden, n_kb, n_tiles, n_sm, heads, out, c_tile, t_out):
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
    ``[2, 64, n]`` block of each item, end to end): a matrix's items are
    adjacent, per 128 input rows one per group of output columns → one
    ``[in, out]`` tensor per shape (a view where the matrix is one group),
    the trunk's matrices in order (the heads' items follow them)."""
    import torch

    grads, i = [], 0
    for rows, cols in shapes:
        pairs = []
        for _ in range(-(-rows // 128)):
            blocks = []
            while True:
                it, *_, off = plan.items[i]
                blocks.append(out[off: off + 128 * it.n].view(128, it.n))
                i += 1
                if i == len(plan.items) or plan.items[i][0].x_img != it.x_img or \
                        plan.items[i][0].x != it.x:
                    break
            pairs.append(blocks)
        if all(len(b) == 1 for b in pairs):
            first = plan.items[i - len(pairs)]
            off, n = first[5], first[0].n
            g = out[off: off + len(pairs) * 128 * n].view(len(pairs) * 128, n)
        else:
            g = torch.cat([torch.cat(b, dim=1) for b in pairs], dim=0)
        grads.append(g[:rows, :cols])
    return grads, i


_WIDTHS_TEXT = (f"instances H in {H_SET}: H 4..{max(H_SET)} with heads H // 4, any number of "
                f"frequencies up to H = 512 and 1..{32 * MAX_IN_BLOCKS_1024} past it, 2 or 3 "
                f"hidden layers, geo 1..{MAX_GEO}, classes 1..{MAX_CLASSES} (tiers (T_out, C_pad) "
                f"in {TIERS})")


def check_widths(who: str, shapes: Sequence[Tuple[int, ...]]):
    """Raise unless the leaves' shapes are a field these kernels take →
    (m, h, n_hidden, G, C): the field's own widths (it runs on the instance
    ``instance(h)``, zero-padded)."""
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
    if (m < 1 or not 4 <= h <= max(H_SET) or hh != head_width(h) or not 1 <= G <= MAX_GEO
            or not 1 <= C <= MAX_CLASSES
            or (h > 512 and enc_blocks(m) > MAX_IN_BLOCKS_1024)):
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
    encode of ``m`` >= 1 frequencies (the input 2m wide) or, with ``m = 0``,
    an input x whose width is a multiple of 16; H from 1 to 1024 (past 512
    an input of at most 512 columns, 256 frequencies, and an output of at
    most 1024); 2 or 3 hidden layers; any output width up to H = 512 →
    (din, h, n_hidden, out), the trunk's own widths (it runs on the
    instance ``instance(h)``, zero-padded)."""
    if len(shapes) % 2 or len(shapes) // 2 not in (3, 4):
        raise ValueError(f"{who}: the trunk needs 2 or 3 hidden layers, as (w, b) pairs")
    n_hidden = len(shapes) // 2 - 1
    din = shapes[0][0] if len(shapes[0]) == 2 else -1
    h = shapes[0][1] if len(shapes[0]) == 2 else -1
    out = shapes[-2][1] if len(shapes[-2]) == 2 else -1
    ok_in = din == 2 * m and m >= 1 if m else din > 0 and din % 16 == 0
    n_kb = enc_blocks(m) if m else x_blocks(din)
    wide_ok = h <= 512 or (n_kb <= MAX_IN_BLOCKS_1024 and gt_blocks(out) <= 16)
    if not ok_in or not 1 <= h <= max(H_SET) or out < 1 or not wide_ok:
        raise ValueError(
            f"{who}: unsupported trunk widths in={din} H={h} out={out} (the tile takes the "
            f"encode of any number of frequencies or an input that is a multiple of 16 wide, "
            f"H 1..{max(H_SET)} on the instances H in {H_SET}, any output width; past H = 512 "
            f"an input of at most {64 * MAX_IN_BLOCKS_1024} columns and an output of at most "
            f"1024)")
    want = trunk_layout(din, h, n_hidden, out).shapes
    for i, (got, exp) in enumerate(zip(shapes, want)):
        if tuple(got) != tuple(exp):
            raise ValueError(f"{who}: leaf {i} has shape {tuple(got)}, expected {tuple(exp)}")
    return din, h, n_hidden, out
