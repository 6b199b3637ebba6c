"""What the field tile's train-side kernels share on the Python side.

The train-step kernel and the backwards of the packed field and of the
fused field-and-render kernel (``fused_field_volrend.py``,
``fused_field_heads.py``) are the same four launches around one middle
kernel: the field forward that saves its bf16 activations, a kernel that
turns the cotangents of the call's outputs into cotangents of the field's
per-sample values, the field backward, and the weight gradients dW = Xᵀ·dY
with their fixed-order reductions. ``FieldTrainCall`` owns the scratch
buffers and the argument struct of such a call and runs everything but
the middle kernel.

The trunk kernels (``fused_mlp.py``: ``fused_spectral_field`` and
``fused_mlp_apply``) run on the same tile without the heads. ``TrunkCall``
checks a trunk and repacks it, zero-padded to its instance, for both
directions: ``TrunkForwardCall`` launches the forward without saves, with
the trunk's output layer; ``TrunkTrainCall`` runs the backwards
(``fused_spectral_field_bwd``, ``fused_mlp_apply_bwd``): the forward over
the encode (or the input x) and the trunk's hidden layers with their
activations saved, the backward from the cotangent of the trunk's output
down to the encode (or to dx), and the weight gradients of the bare trunk,
without a middle kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import build, field_images
from .fused_field_heads import _FfhArgs, prepare_field, repack, sm_count
from .launch import check_tensor, launcher

_p = ctypes.c_void_p
_i, _ll = ctypes.c_int, ctypes.c_longlong
_MAX_ITEMS = 32  # the length of DwArgs::items in csrc/fused_field_volrend.cu


class _FvrArgs(ctypes.Structure):
    """Every pointer and size of one call; mirrors ``FvrArgs`` in
    ``csrc/field_train_args.cuh`` field by field."""

    _fields_ = (
        [(n, _p) for n in ("u", "sh", "dt", "tm", "pix", "dgt", "lab", "bk", "W", "phase",
                           "wfwd", "wbwd", "bias", "enc")]
        + [("h", _p * 3)]
        + [(n, _p) for n in ("xs", "hid1", "hid2")]
        + [("mask_t", _p * 3)]
        + [(n, _p) for n in (
            "mask_h", "sigma", "dsd", "rgb", "sem", "graw", "gout_rgb", "gout_sem", "ray_part",
            "gout", "g2", "g1", "gt")]
        + [("gh", _p * 3)]
        + [(n, _p) for n in ("tile_part", "w", "lossrows", "g_acc", "g_w", "g_packed", "du",
                             "x", "g_trunk", "dx", "keep")]
        + [(n, _i) for n in ("n_rows", "n_rays", "n_samples", "tile_h", "n_hidden", "geo",
                             "n_classes", "c_pad", "t_out", "c_tile", "heads", "x_f32", "din",
                             "out", "n_freq", "n_kb")]
        + [(n, ctypes.c_float) for n in ("c_rgb", "c_dep", "c_sem")]
    )


class _DwItem(ctypes.Structure):
    """Mirrors ``DwItem`` in ``csrc/fused_field_volrend.cu`` field by field."""

    _fields_ = [("x", _p), ("y", _p), ("x_imgs", _i), ("y_imgs", _i), ("x_img", _i * 2),
                ("y_img", _i * 2), ("n", _i), ("chunks", _i), ("chunk_tiles", _i),
                ("first_block", _i), ("p_off", _ll), ("out_off", _ll)]


class _DwArgs(ctypes.Structure):
    """Mirrors ``DwArgs`` in ``csrc/fused_field_volrend.cu`` field by field."""

    _fields_ = [("items", _DwItem * _MAX_ITEMS), ("n_items", _i), ("n_tiles", _i), ("P", _p),
                ("out", _p), ("out_total", _ll)]


class _TileCall:
    """The scratch buffers, the argument struct ``a`` and the launches that
    a differentiating call over ``N`` rows of the tile's instance H shares;
    the subclasses fill in what their kernels read."""

    def _setup(self, who: str, dev, N: int, H: int, n_hidden: int, heads: bool, n_kb: int,
               n_freq: int, out: int, weights: Tuple[int, int, int, int, int],
               sizes: Dict[str, int], tier: Tuple[int, int] = field_images.TIERS[0]):
        """``weights``: the W, phase, forward-slab, backward-slab and bias
        pointers; ``sizes``: the caller's own scratch buffers (bytes);
        ``tier``: the whole field's (T_out, C_pad)."""
        self.dev, self.N, self.H, self.nh, self.n_kb = dev, N, H, n_hidden, n_kb
        self.lib = build.library()
        self.run = launcher(who, dev)
        self.Np = Np = field_images.padded_rows(N, H)
        self.n_tiles = T = Np // field_images.TILE_ROWS
        self.grid = field_images.field_grid(N, sm_count(dev), H)
        self.tpad = field_images.t_pad(heads, out, tier[0])
        n_gt = 1 if heads else field_images.gt_blocks(out)
        self.mp = (field_images.BLOCK_FREQS
                   * field_images.back_blocks(field_images.pair_blocks(n_freq), n_gt, H)
                   if n_freq else 0)
        self.n_bias = field_images.n_bias(H, n_hidden, self.tpad, self.mp)
        self.a = a = _FvrArgs()
        a.W, a.phase, a.wfwd, a.wbwd, a.bias = weights
        a.n_rows, a.tile_h, a.n_hidden, a.heads = N, H, n_hidden, int(heads)
        a.n_freq, a.n_kb, a.out = n_freq, n_kb, out
        a.t_out, a.c_tile = tier
        self.ref = ctypes.addressof(a)
        # every scratch buffer of the call is a slice of one allocation (bytes)
        img = field_images.IMG_BYTES
        mask = Np * 32 * field_images.mask_cols(H)
        sizes = dict(sizes, enc=T * n_kb * img, gt=T * self.tpad // 64 * img if not heads
                     else T * img, tile_part=T * self.n_bias * 4)
        for l in range(n_hidden):
            sizes.update({f"h{l}": T * H // 64 * img, f"gh{l}": T * H // 64 * img,
                          f"mask_t{l}": mask})
        self._dw = field_images.dw_plan(H, n_hidden, n_kb, T, sm_count(dev), heads, out, tier[1],
                                        tier[0])
        sizes["dw_partials"] = self._dw.partial_floats * 4
        if field_images.keep_bytes(H):
            sizes["keep"] = self.grid * field_images.keep_bytes(H)
        self.ptr, total = {}, 0
        for name, size in sizes.items():
            self.ptr[name] = total
            total += -(-size // 256) * 256
        self.scratch = torch.empty((total,), dtype=torch.uint8, device=dev)
        base = self.scratch.data_ptr()
        self.ptr = {name: base + off for name, off in self.ptr.items()}
        for name, ptr in self.ptr.items():
            if name[-1].isdigit() and name[:-1] in ("h", "gh", "mask_t"):
                getattr(a, name[:-1])[int(name[-1])] = ptr
            elif name != "dw_partials":
                setattr(a, name, ptr)

    def buf(self, shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device=self.dev)

    def set_inputs(self, **tensors: Optional[torch.Tensor]):
        """Point the struct's members of these names at the tensors (``None``
        is the null pointer)."""
        for name, t in tensors.items():
            setattr(self.a, name, None if t is None else t.data_ptr())

    def field_forward(self):
        self.run(self.lib.apnerf_fvr_field_fwd, self.ref, self.grid)

    def _weight_grads(self, out: torch.Tensor):
        """dW = Xᵀ·dY of every weight and its fixed-order reduction into
        ``out``: one launch per ``_MAX_ITEMS`` items."""
        items = self._dw.items
        for g0 in range(0, len(items), _MAX_ITEMS):
            group = items[g0: g0 + _MAX_ITEMS]
            block0, out0 = group[0][3], group[0][5]
            d = _DwArgs()
            for e, (it, chunks, chunk_tiles, block, p_off, out_off) in zip(d.items, group):
                e.x, e.y = self.ptr[it.x], self.ptr[it.y]
                e.x_imgs, e.y_imgs, e.n = it.x_imgs, it.y_imgs, it.n
                e.x_img[0], e.x_img[1] = it.x_img
                e.y_img[0], e.y_img[1] = it.y_img
                e.chunks, e.chunk_tiles = chunks, chunk_tiles
                e.first_block, e.p_off, e.out_off = block - block0, p_off, out_off - out0
            it, chunks, _, block, _, out_off = group[-1]
            d.n_items, d.n_tiles, d.P = len(group), self.n_tiles, self.ptr["dw_partials"]
            d.out = out.data_ptr() + 4 * out0
            d.out_total = out_off + 2 * field_images.TILE_ROWS * it.n - out0
            self.run(self.lib.apnerf_dw, ctypes.addressof(d), block + chunks - block0)

    def _backward(self, extra: int):
        """The field backward, the weight gradients and the tile partials'
        sums → (the reduced dW blocks, the bias row, a further ``extra``
        floats of the same allocation)."""
        self.run(self.lib.apnerf_fvr_field_bwd, self.ref, self.grid)
        # one tensor holds every sum: the weights' blocks, then the bias rows
        n_dw = self._dw.out_floats
        res = self.buf((n_dw + self.n_bias + extra,), torch.float32)
        out, gb = res[:n_dw], res[n_dw: n_dw + self.n_bias]
        self._weight_grads(out)
        self.run(self.lib.apnerf_col_sums, self.ptr["tile_part"], self.n_tiles, self.n_bias,
                 self.n_bias, gb.data_ptr())
        return out, gb, res[n_dw + self.n_bias:]

    def _trunk_grads(self, out, gb, rows: Optional[torch.Tensor], din: int, h: int,
                     out_t: int):
        """The trunk's [dw0, db0, dw1, ...] (its own widths: input din, width
        h, output out_t) from the reduced sums; ``rows`` picks w0's rows out of
        the kernels' first-layer order (None: they are in order) → (that
        list, the index of the first item past the trunk's)."""
        H, nh = self.H, self.nh
        kin = 64 * self.n_kb
        # every matrix's items cover the instance's input rows (H past the
        # first layer), whatever the trunk's own width: read them all
        shapes = [(kin, h)] + [(H, h)] * (nh - 1) + [(H, out_t)]
        dws, n_items = field_images.matrix_grads(self._dw, out, shapes)
        dws[0] = dws[0][:din] if rows is None else dws[0].index_select(0, rows)
        dws[1:] = [dw[:h] for dw in dws[1:]]
        dbs = [gb[l * H: l * H + h] for l in range(nh)] + [gb[nh * H: nh * H + out_t]]
        grads = []
        for dw, db in zip(dws, dbs):
            grads += [dw if dw.is_contiguous() else dw.contiguous(), db]
        return grads, n_items

    def _spectrum_grads(self, gb, m: int):
        """(dW_spec [3, m], dphase [m]) from the bias row."""
        off_dph, mp = self.nh * self.H + self.tpad + self.H, self.mp
        return gb[off_dph + mp: off_dph + 4 * mp].view(3, mp)[:, :m].contiguous(), \
            gb[off_dph: off_dph + m]


@functools.lru_cache(maxsize=None)
def _enc_rows(dev: torch.device, m: int) -> torch.Tensor:
    """For each row of w0 ([cos of m | sin of m]) the kernels' encoding
    column that multiplies it (``field_images.enc_rows`` inverted)."""
    cols = field_images.enc_rows(m)
    inv = np.empty(2 * m, dtype=np.int64)
    ok = cols >= 0
    inv[cols[ok]] = np.nonzero(ok)[0]
    return torch.from_numpy(inv).to(dev)


class FieldTrainCall(_TileCall):
    """One differentiating call over ``N = R·S`` rows of the main field:
    checks the inputs, allocates the scratch buffers and fills the kernels'
    argument struct ``a`` (the caller adds what its middle kernel reads).
    ``field_forward()``, the caller's middle kernel through ``run``, then
    ``field_backward()``."""

    def __init__(self, who: str, leaves: Sequence[torch.Tensor], u: torch.Tensor,
                 sh: torch.Tensor, S: int, need_du: bool = False):
        dev = u.device
        N = u.shape[0]
        if S <= 0 or N == 0 or N % S:
            raise ValueError(f"{who}: N={N} must be a positive multiple of S={S}")
        R = N // S
        f32 = torch.float32
        check_tensor(who, u, "u", f32, (N, 3), dev)
        check_tensor(who, sh, "sh", f32, (R, 16), dev)
        self.R = R
        self.fld = fld = prepare_field(who, leaves, dev)
        C, H = fld.C, fld.H
        self.cpad = cpad = -(-C // 16) * 16
        Np = field_images.padded_rows(N, H)
        T = Np // field_images.TILE_ROWS
        img = field_images.IMG_BYTES
        hi = field_images.head_imgs(H)
        w = fld.weights
        n_gout = 1 + fld.tier[1] // field_images.SEM_CHUNK  # rgb, then the semantic blocks
        self._setup(who, dev, N, H, fld.n_hidden, True, fld.n_kb, fld.m, 0,
                    (w.W, w.phase, w.wfwd, w.wbwd, w.bias), {
                        "xs": T * field_images.xs_imgs(fld.tier[0]) * img,
                        "hid1": T * 2 * hi * img, "hid2": T * 2 * hi * img,
                        "mask_h": Np * 32 * field_images.split(H) * field_images.head_mask_words(H),
                        "sigma": N * 4,
                        "dsd": N * 4, "rgb": N * 12, "sem": N * C * 4, "graw": N * 4,
                        "gout_rgb": Np * 32, "gout_sem": Np * cpad * 2,
                        "ray_part": R * (16 + cpad) * 4, "gout": T * n_gout * img,
                        "g2": T * 2 * hi * img, "g1": T * 2 * hi * img}, fld.tier)
        self.du = torch.empty((N, 3), dtype=f32, device=dev) if need_du else None
        a = self.a
        a.u, a.sh = u.data_ptr(), sh.data_ptr()
        a.du = self.du.data_ptr() if need_du else None
        a.n_rays, a.n_samples = R, S
        a.geo, a.n_classes, a.c_pad = fld.G, C, cpad

    def field_backward(self) -> Tuple[List[torch.Tensor], Optional[torch.Tensor]]:
        """The field backward from ``graw``, ``gout_rgb``, ``gout_sem`` and
        ``ray_part`` → (one gradient per leaf, in the leaves' order; du
        [N, 3] or None)."""
        cpad = self.cpad
        out, gb, gr = self._backward(16 + cpad)
        self.run(self.lib.apnerf_col_sums, self.ptr["ray_part"], self.R, 16 + cpad, 16 + cpad,
                 gr.data_ptr())
        return self._field_grads(out, gb, gr), self.du

    def _field_grads(self, out, gb, gr) -> List[torch.Tensor]:
        """One gradient per leaf from the reduced dW blocks ``out``, the
        bias row ``gb`` and the per-ray sums ``gr`` of the output layers'
        cotangents (rgb 16 columns, then the semantics)."""
        fld = self.fld
        G, hh, C = fld.G, fld.hh, fld.C
        trunk, i = self._trunk_grads(out, gb, _enc_rows(self.dev, fld.m), 2 * fld.m, fld.h,
                                     fld.out_t)
        # the heads' items, [2, 64, n] blocks (field_images._head_items): the
        # first layer an item per image of its input, 64 input rows each; one
        # head a warpgroup, or at H / 4 = 128 one item a head, its 128 input
        # rows over both warpgroups; the output layer's semantic columns in
        # items of their own past 64 classes
        blocks = [out[row[5]: row[5] + 2 * 64 * row[0].n].view(2, 64, row[0].n)
                  for row in self._dw.items[i:]]
        xi, k = field_images.xs_imgs(fld.tier[0]), field_images.head_imgs(fld.H)
        if k == 1:
            l1, rest = blocks[:xi], blocks[xi:]
            first = [torch.cat([b[w] for b in l1], dim=0) for w in (0, 1)]
            l2, l3 = rest[0], rest[1:]
            rgb = [first[0], l2[0], l3[0][0]]
            sem = [first[1], l2[1], l3[0][1] if len(l3) == 1 else
                   torch.cat([b[w] for b in l3[1:] for w in (0, 1)], dim=1)]
        else:
            # per 128 input rows (an X pair) the items of its column groups
            it = iter(blocks)

            def rows(n_pairs, n_groups):
                return torch.cat([torch.cat([next(it).reshape(128, -1) for _ in range(n_groups)],
                                            dim=1) for _ in range(n_pairs)], dim=0)

            l1 = [[next(it) for _ in range(k // 2)] for _ in range(xi)]
            first = [torch.cat([torch.cat([b[w] for b in row], dim=1) for row in l1], dim=0)
                     for w in (0, 1)]
            n_y = -(-k // 4)
            l2r, l2s = rows(k // 2, n_y), rows(k // 2, n_y)
            l3r = rows(k // 2, 1)
            l3s = rows(k // 2, -(-fld.tier[1] // 256))
            rgb = [first[0], l2r, l3r]
            sem = [first[1], l2s, l3s]
        dws = [rgb[0][: 16 + G, :hh], rgb[1][:hh, :hh], rgb[2][:hh, :3],
               sem[0][16: 16 + G, :hh], sem[1][:hh, :hh], sem[2][:hh, :C]]
        H, hH = fld.H, field_images.head_width(fld.H)
        off_r1 = fld.n_hidden * H + fld.tier[0]
        off_s1 = off_r1 + 2 * hH
        dbs = [gb[off_r1: off_r1 + hh], gb[off_r1 + hH: off_r1 + hH + hh], gr[:3],
               gb[off_s1: off_s1 + hh], gb[off_s1 + hH: off_s1 + hH + hh], gr[16: 16 + C]]
        grads = list(self._spectrum_grads(gb, fld.m)) + trunk
        for dw, db in zip(dws, dbs):
            grads += [dw.contiguous(), db]
        return grads


class TrunkCall:
    """A trunk kernel's checked inputs on the tile: the trunk's (w, b) pairs
    ``layers`` and either the encode (``W`` [3, m], ``phase``, ``u``) or the
    input ``x`` [N, din] (bf16 or f32), over N rows, on the instance
    ``field_images.instance(h)``. Its weights are repacked into tile images
    zero-padded to that instance (``field_images.trunk_index_tables``), so
    the forward and the backward take one set of widths
    (``field_images.check_trunk``)."""

    def _check(self, who: str, layers, W, phase, u, x):
        dev = (u if x is None else x).device
        self.encode = encode = x is None
        flat = [t for pair in layers for t in pair]
        self.m = m = W.shape[1] if encode else 0
        din, h, nh, out = field_images.check_trunk(who, [tuple(t.shape) for t in flat], m)
        for i, (t, shape) in enumerate(zip(flat, field_images.trunk_layout(din, h, nh,
                                                                           out).shapes)):
            check_tensor(who, t, f"leaf {i}", torch.float32, shape, dev)
        N = (u if encode else x).shape[0]
        if encode:
            check_tensor(who, u, "u", torch.float32, (N, 3), dev)
            check_tensor(who, W, "W", torch.float32, (3, m), dev)
            check_tensor(who, phase, "phase", torch.float32, (m,), dev)
        else:
            if x.dtype not in (torch.bfloat16, torch.float32):
                raise ValueError(f"{who}: x must be bf16 or f32, got {x.dtype}")
            check_tensor(who, x, "x", x.dtype, (N, din), dev)
            if x.data_ptr() % 16:
                raise ValueError(f"{who}: x must be 16-byte aligned")
        self.dev, self.N, self.din, self.h, self.nh, self.out_t = dev, N, din, h, nh, out
        self.H = field_images.instance(h)
        self.n_kb = field_images.enc_blocks(m) if encode else field_images.x_blocks(din)
        self.images = repack(flat, dev, ("trunk", din, m, h, nh, out))
        self.W, self.phase = W, phase


class TrunkForwardCall(TrunkCall):
    """The forward of a trunk kernel (``fused_spectral_field``,
    ``fused_mlp_apply``) over N rows on the tile: ``run()`` → y [N, out] f32."""

    def __init__(self, who: str, layers, W=None, phase=None, u=None, x=None):
        self._check(who, layers, W, phase, u, x)
        self.who, self.u, self.x = who, u, x

    def run(self) -> torch.Tensor:
        y = torch.empty((self.N, self.out_t), dtype=torch.float32, device=self.dev)
        if self.N == 0:
            return y
        lib = build.library()
        a = _FfhArgs()
        p = a.p
        if self.encode:
            a.u, p.W, p.phase = self.u.data_ptr(), self.W.data_ptr(), self.phase.data_ptr()
        else:
            a.x, a.x_f32 = self.x.data_ptr(), int(self.x.dtype == torch.float32)
        p.wfwd, p.wbwd, p.bias = (t.data_ptr() for t in self.images)
        grid = field_images.field_grid(self.N, sm_count(self.dev), self.H)
        keep = (torch.empty((grid * field_images.keep_bytes(self.H),), dtype=torch.uint8,
                            device=self.dev) if field_images.keep_bytes(self.H) else None)
        p.keep = keep.data_ptr() if keep is not None else None
        p.tile_h, p.n_hidden, p.n_freq, p.n_kb, p.out = self.H, self.nh, self.m, self.n_kb, \
            self.out_t
        a.y, a.n_rows, a.n_samples, a.din = y.data_ptr(), self.N, 1, self.din
        launcher(self.who, self.dev)(lib.apnerf_trunk_fwd, ctypes.addressof(a), grid)
        return y


class TrunkTrainCall(TrunkCall, _TileCall):
    """The backward of a trunk kernel over ``N`` rows on the tile: the
    trunk's (w, b) pairs ``layers``, the cotangent ``g`` [N, out] of its
    output, and the encode or the input x as ``TrunkCall`` takes them.
    ``run_all()`` → ([dw0, db0, ...] f32, (dW_spec, dphase) or None, du or
    None, dx in x's dtype or None)."""

    def __init__(self, who: str, layers: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                 g: torch.Tensor, W: Optional[torch.Tensor] = None,
                 phase: Optional[torch.Tensor] = None, u: Optional[torch.Tensor] = None,
                 x: Optional[torch.Tensor] = None, need_du: bool = False,
                 need_dx: bool = False):
        self._check(who, layers, W, phase, u, x)
        dev, N = self.dev, self.N
        if N == 0:
            raise ValueError(f"{who}: no rows")
        check_tensor(who, g, "g", torch.float32, (N, self.out_t), dev)
        self._setup(who, dev, N, self.H, self.nh, False, self.n_kb, self.m, self.out_t,
                    (W.data_ptr() if self.encode else None,
                     phase.data_ptr() if self.encode else None,
                     *(t.data_ptr() for t in self.images)), {})
        self.du = torch.empty((N, 3), dtype=torch.float32, device=dev) if need_du else None
        self.dx = torch.empty_like(x) if need_dx and not self.encode else None
        a = self.a
        a.g_trunk, a.din = g.data_ptr(), self.din
        if self.encode:
            a.u = u.data_ptr()
            a.du = self.du.data_ptr() if need_du else None
        else:
            a.x, a.x_f32 = x.data_ptr(), int(x.dtype == torch.float32)
            a.dx = self.dx.data_ptr() if self.dx is not None else None

    def run_all(self):
        self.field_forward()
        out, gb, _ = self._backward(0)
        rows = _enc_rows(self.dev, self.m) if self.encode else None
        grads, _ = self._trunk_grads(out, gb, rows, self.din, self.h, self.out_t)
        spectrum = self._spectrum_grads(gb, self.m) if self.encode else None
        return grads, spectrum, self.du, self.dx
