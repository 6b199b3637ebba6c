"""What the main field's train-side kernels share on the Python side.

The train-step kernel and the backwards of the packed field and of the
fused field-and-render kernel (``fused_field_volrend.py``,
``fused_field_heads.py``) are the same four launches around one middle
kernel: the field forward that saves its bf16 activations, a kernel that
turns the cotangents of the call's outputs into cotangents of the field's
per-sample values, the field backward, and the weight gradients dW = Xᵀ·dY
with their fixed-order reductions. ``FieldTrainCall`` owns the scratch
buffers and the argument struct of such a call and runs everything but
the middle kernel.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from . import build, field_images
from .fused_field_heads import prepare_field, sm_count
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
        + [(n, _p) for n in ("tile_part", "w", "lossrows", "g_acc", "g_w", "g_packed", "du")]
        + [(n, _i) for n in ("n_rows", "n_rays", "n_samples", "n_hidden", "geo", "n_classes",
                             "c_pad")]
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


class FieldTrainCall:
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
        self.dev, self.N, self.R = dev, N, R
        self.fld = fld = prepare_field(who, leaves, dev)
        self.lib = build.library()
        self.run = launcher(who, dev)
        C, nh = fld.C, fld.n_hidden
        cpad = -(-C // 16) * 16
        self.cpad = cpad
        self.Np = Np = field_images.padded_rows(N)
        self.n_tiles = T = Np // field_images.TILE_ROWS
        self.grid = field_images.field_grid(N, sm_count(dev))
        self.du = torch.empty((N, 3), dtype=f32, device=dev) if need_du else None
        self.a = a = _FvrArgs()
        a.u, a.sh = u.data_ptr(), sh.data_ptr()
        w = fld.weights
        a.W, a.phase, a.wfwd, a.wbwd, a.bias = w.W, w.phase, w.wfwd, w.wbwd, w.bias
        a.du = self.du.data_ptr() if need_du else None
        a.n_rows, a.n_rays, a.n_samples = N, R, S
        a.n_hidden, a.geo, a.n_classes, a.c_pad = nh, fld.G, C, cpad
        self.ref = ctypes.addressof(a)
        self.n_bias = field_images.n_bias(nh)
        # every scratch buffer of the call is a slice of one allocation (bytes)
        img = field_images.IMG_BYTES
        sizes = {"enc": T * 4 * img, "xs": T * img, "hid1": T * 2 * img, "hid2": T * 2 * img,
                 "mask_h": Np * 32, "sigma": N * 4, "dsd": N * 4, "rgb": N * 12, "sem": N * C * 4,
                 "graw": N * 4, "gout_rgb": Np * 32, "gout_sem": Np * cpad * 2,
                 "ray_part": R * (16 + cpad) * 4, "gout": T * 2 * img, "g2": T * 2 * img,
                 "g1": T * 2 * img, "gt": T * img, "tile_part": T * self.n_bias * 4}
        for l in range(nh):
            sizes.update({f"h{l}": T * 4 * img, f"gh{l}": T * 4 * img, f"mask_t{l}": Np * 32})
        self._dw = field_images.dw_plan(nh, T, sm_count(dev))
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
        reduction into ``out`` → where each item's [2, 64, n] block starts."""
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
        return [row[5] for row in plan.items]

    def field_backward(self) -> Tuple[List[torch.Tensor], Optional[torch.Tensor]]:
        """The field backward from ``graw``, ``gout_rgb``, ``gout_sem`` and
        ``ray_part`` → (one gradient per leaf, in the leaves' order; du
        [N, 3] or None)."""
        lib, run, fld = self.lib, self.run, self.fld
        M, H, out_t, G, hh, C = fld.M, fld.H, fld.out_t, fld.G, fld.hh, fld.C
        cpad, nh, n_bias = self.cpad, fld.n_hidden, self.n_bias
        run(lib.apnerf_fvr_field_bwd, self.ref, self.grid)
        # one tensor holds every sum: the weights' blocks, then the two bias rows
        n_dw = self._dw.out_floats
        res = self.buf((n_dw + n_bias + 16 + cpad,), torch.float32)
        out, gb, gr = res[:n_dw], res[n_dw: n_dw + n_bias], res[n_dw + n_bias:]
        offs = self._weight_grads(out)
        # a trunk matrix is two adjacent items: input columns 0:128 and 128:256
        dws = [out[offs[2 * l]: offs[2 * l] + H * H].view(H, H) for l in range(nh)]
        o = offs[2 * nh]
        dws.append(out[o: o + H * 64].view(H, 64)[:, :out_t].contiguous())
        l1, l2, l3 = (out[o: o + 2 * 64 * 64].view(2, 64, 64) for o in offs[2 * nh + 2:])
        dws += [l1[0, : 16 + G], l2[0], l3[0, :, :3].contiguous(),
                l1[1, 16: 16 + G], l2[1], l3[1, :, :C].contiguous()]
        run(lib.apnerf_col_sums, self.ptr["tile_part"], self.n_tiles, n_bias, n_bias,
            gb.data_ptr())
        run(lib.apnerf_col_sums, self.ptr["ray_part"], self.R, 16 + cpad, 16 + cpad,
            gr.data_ptr())
        off_gtr = nh * H
        off_r1 = off_gtr + 16
        off_s1 = off_r1 + 2 * hh
        off_dph = off_s1 + 2 * hh
        dbs = [gb[l * H: (l + 1) * H] for l in range(nh)] + [
            gb[off_gtr: off_gtr + out_t],
            gb[off_r1: off_r1 + hh], gb[off_r1 + hh: off_r1 + 2 * hh], gr[:3],
            gb[off_s1: off_s1 + hh], gb[off_s1 + hh: off_s1 + 2 * hh], gr[16: 16 + C],
        ]
        grads = [gb[off_dph + M: off_dph + 4 * M].view(3, M), gb[off_dph: off_dph + M]]
        for dw, db in zip(dws, dbs):
            grads += [dw, db]
        return grads, self.du
