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

from . import build
from .fused_field_heads import prepare_field
from .launch import MAX_SMEM, check_tensor, launcher, weight_grads

_p = ctypes.c_void_p


class _FvrArgs(ctypes.Structure):
    """Every pointer and size of one call; mirrors ``FvrArgs`` in
    ``csrc/field_train_args.cuh`` field by field."""

    _fields_ = (
        [(n, _p) for n in ("u", "sh", "dt", "tm", "pix", "dgt", "lab", "bk", "W", "phase")]
        + [("tw", _p * 4), ("tb", _p * 4), ("rw", _p * 3), ("rb", _p * 3),
           ("sw", _p * 3), ("sb", _p * 3)]
        + [("enc", _p), ("h", _p * 3)]
        + [(n, _p) for n in (
            "xr", "hr1", "hr2", "hs1", "hs2", "sigma", "dsd", "rgb", "sem", "graw",
            "gout_rgb", "gout_sem", "ray_part", "gtrb")]
        + [("gh", _p * 3)]
        + [(n, _p) for n in ("gr1", "gr2", "gs1", "gs2", "tile_part", "w", "lossrows",
                             "g_acc", "g_w", "g_packed", "du")]
        + [(n, ctypes.c_int) for n in (
            "n_rows", "n_rows_pad", "n_rays", "n_samples", "m", "hidden", "n_layers",
            "trunk_out_pad", "geo", "head_hidden", "n_classes", "c_pad")]
        + [(n, ctypes.c_float) for n in ("c_rgb", "c_dep", "c_sem")]
    )


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
        f32, bf16 = torch.float32, torch.bfloat16
        check_tensor(who, u, "u", f32, (N, 3), dev)
        check_tensor(who, sh, "sh", f32, (R, 16), dev)
        self.dev, self.N, self.R = dev, N, R
        self.fld = fld = prepare_field(who, leaves, dev)
        self.lib = build.library()
        self.run = launcher(who, dev)
        M, H, hh, C = fld.M, fld.H, fld.hh, fld.C
        tpad, cpad, nh = fld.tpad, fld.cpad, fld.n_trunk - 1
        self.Np = Np = -(-N // 64) * 64

        def buf(shape, dtype=bf16):
            return torch.empty(shape, dtype=dtype, device=dev)

        self.buf = buf
        self.s = s = {
            "enc": buf((Np, 2 * M)), "h": [buf((Np, H)) for _ in range(nh)],
            "xr": buf((Np, 32)), "hr1": buf((Np, hh)), "hr2": buf((Np, hh)),
            "hs1": buf((Np, hh)), "hs2": buf((Np, hh)),
            "sigma": buf((N,), f32), "dsd": buf((N,), f32), "rgb": buf((N, 3), f32),
            "sem": buf((N, C), f32), "graw": buf((N,), f32),
            "gout_rgb": buf((Np, 16)), "gout_sem": buf((Np, cpad)),
            "ray_part": buf((R, 16 + cpad), f32), "gtrb": buf((Np, tpad)),
            "gh": [buf((Np, H)) for _ in range(nh)],
            "gr1": buf((Np, hh)), "gr2": buf((Np, hh)), "gs1": buf((Np, hh)),
            "gs2": buf((Np, hh)),
        }
        self.du = buf((N, 3), f32) if need_du else None
        self.a = a = _FvrArgs()
        a.u, a.sh = u.data_ptr(), sh.data_ptr()
        a.W, a.phase = leaves[0].data_ptr(), leaves[1].data_ptr()
        for dst, ts in ((a.tw, fld.tws), (a.tb, fld.tbs), (a.rw, fld.rws), (a.rb, fld.rbs),
                        (a.sw, fld.sws), (a.sb, fld.sbs), (a.h, s["h"]), (a.gh, s["gh"])):
            for i, t in enumerate(ts):
                dst[i] = t.data_ptr()
        for name, t in s.items():
            if torch.is_tensor(t):
                setattr(a, name, t.data_ptr())
        a.du = self.du.data_ptr() if need_du else None
        a.n_rows, a.n_rows_pad, a.n_rays, a.n_samples = N, Np, R, S
        a.m, a.hidden, a.n_layers, a.trunk_out_pad, a.geo = M, H, fld.n_trunk, tpad, fld.G
        a.head_hidden, a.n_classes, a.c_pad = hh, C, cpad
        self.ref = ctypes.addressof(a)
        for which in (0, 1):
            if self.lib.apnerf_fvr_smem(self.ref, which) > MAX_SMEM:
                raise ValueError(f"{who}: widths too large for shared memory")
        self.n_bias = self.lib.apnerf_fvr_n_bias(self.ref)
        self.tile_part = buf((Np // 64, self.n_bias), f32)
        a.tile_part = self.tile_part.data_ptr()

    def set_inputs(self, **tensors: Optional[torch.Tensor]):
        """Point the struct's members of these names at the tensors (``None``
        is the null pointer)."""
        for name, t in tensors.items():
            setattr(self.a, name, None if t is None else t.data_ptr())

    def field_forward(self):
        self.run(self.lib.apnerf_fvr_field_fwd, self.ref)

    def field_backward(self) -> Tuple[List[torch.Tensor], Optional[torch.Tensor]]:
        """The field backward from ``graw``, ``gout_rgb``, ``gout_sem`` and
        ``ray_part`` → (one gradient per leaf, in the leaves' order; du
        [N, 3] or None)."""
        lib, run, s, fld = self.lib, self.run, self.s, self.fld
        M, H, out_t, G, hh, C = fld.M, fld.H, fld.out_t, fld.G, fld.hh, fld.C
        tpad, cpad, nh = fld.tpad, fld.cpad, fld.n_trunk - 1
        Np, n_bias = self.Np, self.n_bias
        run(lib.apnerf_fvr_field_bwd, self.ref)
        # weight gradients X^T dY, in the leaves' order
        xr_geo = s["xr"].data_ptr() + 16 * 2  # the sem head's input: xr[:, 16:]
        jobs = [(s["enc"].data_ptr(), 2 * M, 2 * M, 2 * M, s["gh"][0].data_ptr(), H, H)]
        for l in range(1, nh):
            jobs.append((s["h"][l - 1].data_ptr(), H, H, H, s["gh"][l].data_ptr(), H, H))
        jobs += [
            (s["h"][nh - 1].data_ptr(), H, H, H, s["gtrb"].data_ptr(), tpad, out_t),
            (s["xr"].data_ptr(), 32, 32, 16 + G, s["gr1"].data_ptr(), hh, hh),
            (s["hr1"].data_ptr(), hh, hh, hh, s["gr2"].data_ptr(), hh, hh),
            (s["hr2"].data_ptr(), hh, hh, hh, s["gout_rgb"].data_ptr(), 16, 3),
            (xr_geo, 32, 16, G, s["gs1"].data_ptr(), hh, hh),
            (s["hs1"].data_ptr(), hh, hh, hh, s["gs2"].data_ptr(), hh, hh),
            (s["hs2"].data_ptr(), hh, hh, hh, s["gout_sem"].data_ptr(), cpad, C),
        ]
        dws = weight_grads(lib, run, jobs, Np, self.dev)
        gb, gr = self.buf((n_bias,), torch.float32), self.buf((16 + cpad,), torch.float32)
        run(lib.apnerf_sum_rows, self.tile_part.data_ptr(), Np // 64, n_bias, n_bias,
            gb.data_ptr())
        run(lib.apnerf_sum_rows, s["ray_part"].data_ptr(), self.R, 16 + cpad, 16 + cpad,
            gr.data_ptr())
        off_gtr = nh * H
        off_r1 = off_gtr + tpad
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
