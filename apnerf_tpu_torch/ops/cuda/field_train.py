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

The trunk kernels' backwards (``fused_mlp.py``: ``fused_spectral_field_bwd``
and ``fused_mlp_apply_bwd``) are the same launches without the heads and
without a middle kernel: ``TrunkTrainCall`` runs the forward over the
encode (or the input x) and the trunk's hidden layers with their
activations saved, the backward from the cotangent of the trunk's output
down to the encode (or to dx), and the weight gradients of the bare trunk.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from . import build, field_images
from .fused_field_heads import prepare_field, repack, sm_count
from .launch import check_tensor, launcher

_p = ctypes.c_void_p
_i, _ll = ctypes.c_int, ctypes.c_longlong
_MAX_ITEMS = 16  # the length of DwArgs::items in csrc/fused_field_volrend.cu


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
                             "x", "g_trunk", "dx")]
        + [(n, _i) for n in ("n_rows", "n_rays", "n_samples", "tile_m", "tile_h", "n_hidden", "geo",
                             "n_classes", "c_pad", "heads", "x_f32", "din", "out")]
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
    a differentiating call over ``N`` rows of the tile's instance (M, H)
    shares; the subclasses fill in what their kernels read."""

    def _setup(self, who: str, dev, N: int, M: int, H: int, n_hidden: int, heads: bool,
               weights: Tuple[int, int, int, int, int], sizes: Dict[str, int]):
        """``weights``: the W, phase, forward-slab, backward-slab and bias
        pointers; ``sizes``: the caller's own scratch buffers (bytes)."""
        self.dev, self.N, self.M, self.H, self.nh = dev, N, M, H, n_hidden
        self.lib = build.library()
        self.run = launcher(who, dev)
        self.Np = Np = field_images.padded_rows(N)
        self.n_tiles = T = Np // field_images.TILE_ROWS
        self.grid = field_images.field_grid(N, sm_count(dev))
        self.n_bias = field_images.n_bias(M, H, n_hidden)
        self.a = a = _FvrArgs()
        a.W, a.phase, a.wfwd, a.wbwd, a.bias = weights
        a.n_rows, a.tile_m, a.tile_h, a.n_hidden, a.heads = N, M, H, n_hidden, int(heads)
        self.ref = ctypes.addressof(a)
        # every scratch buffer of the call is a slice of one allocation (bytes)
        img = field_images.IMG_BYTES
        sizes = dict(sizes, enc=T * 2 * M // 64 * img, gt=T * img, tile_part=T * self.n_bias * 4)
        for l in range(n_hidden):
            sizes.update({f"h{l}": T * H // 64 * img, f"gh{l}": T * H // 64 * img,
                          f"mask_t{l}": Np * 32})
        self._dw = field_images.dw_plan(M, H, n_hidden, T, sm_count(dev), heads)
        sizes["dw_partials"] = self._dw.partial_floats * 4
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
        """dW = Xᵀ·dY of every weight in one launch and its fixed-order
        reduction into ``out``."""
        plan = self._dw
        d = _DwArgs()
        for e, (it, chunks, chunk_tiles, block, p_off, out_off) in zip(d.items, plan.items):
            e.x, e.y = self.ptr[it.x], self.ptr[it.y]
            e.x_imgs, e.y_imgs, e.n = it.x_imgs, it.y_imgs, it.n
            e.x_img[0], e.x_img[1] = it.x_img
            e.y_img[0], e.y_img[1] = it.y_img
            e.chunks, e.chunk_tiles = chunks, chunk_tiles
            e.first_block, e.p_off, e.out_off = block, p_off, out_off
        d.n_items, d.n_tiles, d.P, d.out, d.out_total = (
            len(plan.items), self.n_tiles, self.ptr["dw_partials"], out.data_ptr(),
            plan.out_floats)
        self.run(self.lib.apnerf_dw, ctypes.addressof(d), plan.n_blocks)

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

    def _trunk_grads(self, out, gb, din: int, out_t: int):
        """The trunk's [dw0, db0, dw1, ...] from the reduced sums → (that
        list, the index of the first item past the trunk's)."""
        H, nh = self.H, self.nh
        shapes = [(din, H)] + [(H, H)] * (nh - 1) + [(H, out_t)]
        dws, n_items = field_images.matrix_grads(self._dw, out, shapes)
        dbs = [gb[l * H: (l + 1) * H] for l in range(nh)] + [gb[nh * H: nh * H + out_t]]
        grads = []
        for dw, db in zip(dws, dbs):
            grads += [dw if dw.is_contiguous() else dw.contiguous(), db]
        return grads, n_items

    def _spectrum_grads(self, gb):
        """(dW_spec [3, M], dphase [M]) from the bias row."""
        M, H = self.M, self.H
        off_dph = self.nh * H + field_images.T_OUT + 4 * field_images.head_width(H)
        return gb[off_dph + M: off_dph + 4 * M].view(3, M), gb[off_dph: off_dph + M]


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
        C = fld.C
        self.cpad = cpad = -(-C // 16) * 16
        Np, T = field_images.padded_rows(N), field_images.padded_rows(N) // field_images.TILE_ROWS
        img = field_images.IMG_BYTES
        w = fld.weights
        self._setup(who, dev, N, fld.M, fld.H, fld.n_hidden, True,
                    (w.W, w.phase, w.wfwd, w.wbwd, w.bias), {
                        "xs": T * img, "hid1": T * 2 * img, "hid2": T * 2 * img,
                        "mask_h": Np * 32, "sigma": N * 4, "dsd": N * 4, "rgb": N * 12,
                        "sem": N * C * 4, "graw": N * 4, "gout_rgb": Np * 32,
                        "gout_sem": Np * cpad * 2, "ray_part": R * (16 + cpad) * 4,
                        "gout": T * 2 * img, "g2": T * 2 * img, "g1": T * 2 * img})
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
        fld, cpad = self.fld, self.cpad
        G, hh, C = fld.G, fld.hh, fld.C
        out, gb, gr = self._backward(16 + cpad)
        self.run(self.lib.apnerf_col_sums, self.ptr["ray_part"], self.R, 16 + cpad, 16 + cpad,
                 gr.data_ptr())
        trunk, i = self._trunk_grads(out, gb, 2 * fld.M, fld.out_t)
        # the heads' items: rgb on warpgroup 0, semantics on 1, [2, 64, 64] each
        l1, l2, l3 = (out[row[5]: row[5] + 2 * 64 * 64].view(2, 64, 64)
                      for row in self._dw.items[i:])
        dws = [l1[0, : 16 + G, :hh], l2[0, :hh, :hh], l3[0, :hh, :3],
               l1[1, 16: 16 + G, :hh], l2[1, :hh, :hh], l3[1, :hh, :C]]
        off_r1 = fld.n_hidden * fld.H + 16
        off_s1 = off_r1 + 2 * hh
        dbs = [gb[off_r1: off_r1 + hh], gb[off_r1 + hh: off_r1 + 2 * hh], gr[:3],
               gb[off_s1: off_s1 + hh], gb[off_s1 + hh: off_s1 + 2 * hh], gr[16: 16 + C]]
        grads = list(self._spectrum_grads(gb)) + trunk
        for dw, db in zip(dws, dbs):
            grads += [dw.contiguous(), db]
        return grads, self.du


def pad_trunk(flat: Sequence[torch.Tensor], W: Optional[torch.Tensor],
              phase: Optional[torch.Tensor], M: int, H: int):
    """A trunk (its w0, b0, w1, ... ``flat``, and the encode's ``W``,
    ``phase``, or None for an input x) zero-padded to the tile's instance
    (M, H): the encode's frequencies up to M (W and phase zero there, and
    with them the first layer's rows for their cos and sin), the width up
    to H (zero weights and biases: those units stay zero through every
    ReLU). The output and the gradients of the true entries are those of
    the trunk itself → (flat, W, phase)."""
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


def unpad_trunk_grads(grads: List[torch.Tensor], spectrum, m: int, M: int, h: int):
    """The gradients of a trunk padded by ``pad_trunk`` (to M frequencies
    from m, 0 for an input x, and to a width from h) → those of the trunk
    itself: (grads, (dW_spec, dphase) or None)."""
    n = len(grads) // 2
    out = []
    for l in range(n):
        dw, db = grads[2 * l], grads[2 * l + 1]
        if l == 0 and m:
            dw = torch.cat([dw[:m], dw[M: M + m]])
        dw = dw[:, :h] if l == 0 else dw[:h] if l == n - 1 else dw[:h, :h]
        out += [dw.contiguous(), db if l == n - 1 else db[:h]]
    if spectrum is not None:
        spectrum = (spectrum[0][:, :m].contiguous(), spectrum[1][:m])
    return out, spectrum


class TrunkTrainCall(_TileCall):
    """The backward of a trunk kernel over ``N`` rows on the tile: the
    trunk's (w, b) pairs ``layers`` and the cotangent ``g`` [N, out] of its
    output, and either the encode (``W`` [3, m], ``phase``, ``u``) or the
    input ``x`` [N, din] (bf16 or f32), on the tile's instance that
    ``field_images.check_trunk`` names, zero-padded up to it where the
    trunk lies between two (``pad_trunk``). ``run_all()`` → ([dw0, db0, ...] f32,
    (dW_spec, dphase) or None, du or None, dx in x's dtype or None)."""

    def __init__(self, who: str, layers: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                 g: torch.Tensor, W: Optional[torch.Tensor] = None,
                 phase: Optional[torch.Tensor] = None, u: Optional[torch.Tensor] = None,
                 x: Optional[torch.Tensor] = None, need_du: bool = False,
                 need_dx: bool = False):
        dev = g.device
        encode = x is None
        flat = [t for pair in layers for t in pair]
        m = W.shape[1] if encode else 0
        din, M, H, nh, out_t = field_images.check_trunk(who, [tuple(t.shape) for t in flat], m)
        h = flat[0].shape[1]
        for i, (t, shape) in enumerate(zip(flat, field_images.trunk_layout(din, h, nh,
                                                                           out_t).shapes)):
            check_tensor(who, t, f"leaf {i}", torch.float32, shape, dev)
        N = (u if encode else x).shape[0]
        if N == 0:
            raise ValueError(f"{who}: no rows")
        check_tensor(who, g, "g", torch.float32, (N, out_t), dev)
        if encode:
            check_tensor(who, u, "u", torch.float32, (N, 3), dev)
            check_tensor(who, W, "W", torch.float32, (3, m), dev)
            check_tensor(who, phase, "phase", torch.float32, (m,), dev)
        else:
            check_tensor(who, x, "x", x.dtype, (N, din), dev)
            if x.dtype not in (torch.bfloat16, torch.float32) or x.data_ptr() % 16:
                raise ValueError(f"{who}: x must be bf16 or f32 and 16-byte aligned")
        # a trunk between two instances runs zero-padded to the next one
        self.padded = (m, M, h) if (H, M) != (h, m or M) else None
        if self.padded:
            flat, W, phase = pad_trunk(flat, W, phase, M, H)
            self.kept = (W, phase)  # the kernels read these copies
        tile_din = 2 * M if encode else din
        self.images = repack(flat, dev, ("trunk", tile_din, M, H, nh, out_t))
        self.din, self.out_t, self.encode = tile_din, out_t, encode
        self._setup(who, dev, N, M, H, nh, False,
                    (W.data_ptr() if encode else None, phase.data_ptr() if encode else None,
                     *(t.data_ptr() for t in self.images)), {})
        self.du = torch.empty((N, 3), dtype=torch.float32, device=dev) if need_du else None
        self.dx = torch.empty_like(x) if need_dx and not encode else None
        a = self.a
        a.g_trunk, a.out, a.din = g.data_ptr(), out_t, tile_din
        if encode:
            a.u = u.data_ptr()
            a.du = self.du.data_ptr() if need_du else None
        else:
            a.x, a.x_f32 = x.data_ptr(), int(x.dtype == torch.float32)
            a.dx = self.dx.data_ptr() if self.dx is not None else None

    def run_all(self):
        self.field_forward()
        out, gb, _ = self._backward(0)
        grads, _ = self._trunk_grads(out, gb, self.din, self.out_t)
        spectrum = self._spectrum_grads(gb) if self.encode else None
        if self.padded:
            grads, spectrum = unpad_trunk_grads(grads, spectrum, *self.padded)
        return grads, spectrum, self.du, self.dx

