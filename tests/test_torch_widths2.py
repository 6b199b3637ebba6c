"""The field tile's widths up to H = 1024 on the CPU.

The host side of the tile (``apnerf_tpu_torch/ops/cuda/field_images.py``
and ``field_train.py``) decides everything about a width that the kernels
do not: the tile images of a field or a trunk zero-padded to its instance,
the first layer's k-blocks (the encoding's columns in the kernels' order),
the slab schedules, the shared-memory budgets, the weight-gradient plan and
the reading of the gradients back out of the kernels' sums. Here a numpy
emulation of the kernels' arithmetic, in float64, reads the repacked
images slab by slab in the schedules' order, runs the field (or the trunk)
forward and backward, and hands its weight-gradient products and column
sums to the port's own host code; the result must equal the plain field or
trunk at its own, unpadded widths (float64 autograd), to 1e-9 of each
tensor's scale: the padding is exact, so only summation order differs.
The widths: H = 96, 100, 512, 600, 700 and 1024 (two products of n = 256
a warpgroup, each layer's slabs half by half), M = 16, 48 and 256, din =
48, 256 and 512, out = 17, 64, 130 and 1024, for a whole field and for a
trunk; and the whole field's
wider tiers, its trunk output 32 and 48 wide and its semantic output 128
and 256 (geo 16 to 47, 65 to 256 classes) and the last tier's, its trunk
output 64 wide (the heads' input over two tile images) and its semantic
output 1024 (geo 48 to 63, 257 to 1024 classes), with one head's
activation a tile image (H = 64, 100, 128, 256) and two (H = 512). This
is the only CPU check of those tiers' images, slab schedules and
weight-gradient plans.

Then the plain versions of the port's K1 (``fused_spectral_field``) and K3
(``fused_mlp_apply``), which are what the wrappers run for CPU tensors and
what ``chip_smoke.py`` holds the kernels to on the card, against the JAX
package's Pallas kernels in interpret mode at H = 512, M = 256, din = 512
and out = 32, 256 rows, at the JAX kernel tests' bf16 limit (2e-2 of the
output's scale: bf16 rounding flips of hidden activations and the bias
convention).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apnerf_tpu.models import nn as j_nn
from apnerf_tpu.ops.pallas import fused_mlp as j_fm
from apnerf_tpu_torch.models.ngp import trunc_exp
from apnerf_tpu_torch.models.nn import MLP
from apnerf_tpu_torch.ops.cuda import field_images as fi
from apnerf_tpu_torch.ops.cuda import field_train as ft
from apnerf_tpu_torch.ops.cuda import fused_field_heads as t_ffh
from apnerf_tpu_torch.ops.cuda import fused_mlp as t_fm

F64 = torch.float64
TOL = 1e-9  # of each tensor's scale
N_ROWS = 40
TWO_PI = 2 * np.pi


def close(got, want, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= TOL, (name, err)


def unswizzle(flat: np.ndarray, rows: int) -> np.ndarray:
    """A tile image ``[rows, 64]`` from its flat elements."""
    r, c = np.arange(rows)[:, None], np.arange(64)[None, :]
    return flat[fi.img_off(r, c) // 2]


class Slabs:
    """Reads a repacked buffer image by image, in the schedule's order."""

    def __init__(self, buf: np.ndarray):
        self.buf, self.off = buf, 0

    def take(self, rows: int) -> np.ndarray:
        img = unswizzle(self.buf[self.off: self.off + rows * 64], rows)
        self.off += rows * 64
        return img

    def done(self):
        assert self.off == self.buf.size


def relu(x):
    return np.maximum(x, 0.0)


def pad(a, cols):
    out = np.zeros((a.shape[0], cols))
    out[:, : a.shape[1]] = a
    return out


def repacked(leaves, tables):
    """The kernels' buffers from f64 leaves, unrounded: (fwd, bwd, bias)."""
    flat = np.concatenate([np.asarray(t, np.float64).reshape(-1) for t in leaves] + [[0.0]])
    return tuple(flat[t] for t in tables)


def encoding(W, phase, u, m):
    """The encoding in the kernels' forward column order, [cos of m | sin
    of m], zero up to whole k-blocks, as the kernels form it."""
    proj = TWO_PI * (u @ W) + phase
    enc = np.zeros((u.shape[0], 64 * fi.enc_blocks(m)))
    enc[:, :m], enc[:, m: 2 * m] = np.cos(proj), np.sin(proj)
    return enc


def trunk_forward(sl: Slabs, bias, inp, H, nh, n_kb, chunks, width=16):
    """The trunk from its forward slabs → (hidden activations, output [N,
    ``width`` chunks]): the output layer ``width`` columns a slab (the trunk
    alone's 16, the whole field's T_out in one)."""
    def layer(n_blocks):  # a layer's slabs, half by half: B[n][k] = w[k0 + k][units[n]]
        W = np.zeros((64 * n_blocks, H))
        for hf in range(fi.halves(H)):
            units = fi._unit_rows(H, hf)
            for b in range(n_blocks):
                W[64 * b: 64 * b + 64, units] = sl.take(len(units)).T
        return W

    hs = [relu(inp @ layer(n_kb) + bias[:H])]
    for l in range(1, nh):
        hs.append(relu(hs[-1] @ layer(H // 64) + bias[l * H: (l + 1) * H]))
    Wt = np.zeros((H, width * chunks))
    for ch in range(chunks):
        for kb in range(H // 64):
            Wt[64 * kb: 64 * kb + 64, width * ch: width * (ch + 1)] = sl.take(width).T
    return hs, hs[-1] @ Wt + bias[nh * H: nh * H + width * chunks]


def trunk_backward(sl: Slabs, hs, g_top, H, nh, n_kb):
    """From the trunk output's cotangent (64 columns a k-block) down to the
    first layer's input in the backward's column order (``n_kb`` blocks) →
    (gh per layer, g_in)."""
    def layer(n_blocks):  # a layer's slabs, half by half: B[n][k] = w[units[n]][k0 + k]
        W = np.zeros((H, 64 * n_blocks))
        for hf in range(fi.halves(H)):
            units = fi._unit_rows(H, hf)
            for b in range(n_blocks):
                W[units, 64 * b: 64 * b + 64] = sl.take(len(units))
        return W

    n_gt = g_top.shape[1] // 64
    ghs = [None] * nh
    ghs[-1] = (g_top @ layer(n_gt).T) * (hs[-1] > 0)
    for l in range(nh - 1, 0, -1):
        ghs[l - 1] = (ghs[l] @ layer(H // 64).T) * (hs[l - 1] > 0)
    n_gt = g_top.shape[1] // 64
    n_bk, g = fi.back_blocks(n_kb, n_gt, H), fi.back_group(n_kb, n_gt, H) or 1
    W0 = np.zeros((64 * n_bk, H))
    for grp in range(n_bk // g):
        for kb in range(H // 64):
            W0[64 * g * grp: 64 * g * (grp + 1), 64 * kb: 64 * kb + 64] = sl.take(64 * g)
    return ghs, ghs[0] @ W0.T


def weight_products(plan, bufs):
    """``out`` as the weight-gradient kernel and its reduction leave it:
    per item and warpgroup w, X's image x_img[w] transposed times dY's
    images from y_img[w]."""
    out = np.zeros(plan.out_floats)
    for it, *_, off in plan.items:
        for w in range(2):
            X = bufs[it.x][:, 64 * it.x_img[w]: 64 * it.x_img[w] + 64]
            Y = bufs[it.y][:, 64 * it.y_img[w]: 64 * it.y_img[w] + it.n]
            out[off + w * 64 * it.n: off + (w + 1) * 64 * it.n] = (X.T @ Y).reshape(-1)
    return out


def spectrum_sums(enc, g_in, u, mp):
    """dproj per (padded) frequency, the saved cos and sin from the forward's
    column order and their cotangents from the backward's, and its dphase
    and dW_spec sums."""
    f = np.arange(mp)
    rc = 32 * (f // 16) + f % 16
    m = np.count_nonzero(enc.any(axis=0)) // 2  # [cos of m | sin of m | 0]
    mf = np.minimum(f, m - 1)
    dproj = np.where(f < m, enc[:, mf] * g_in[:, rc + 16] - enc[:, m + mf] * g_in[:, rc], 0.0)
    return dproj, np.concatenate([dproj.sum(0), TWO_PI * (u.T @ dproj).reshape(-1)])


class _TrunkHost(ft.TrunkTrainCall):
    """The trunk backward's host code without a device."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


class _FieldHost(ft.FieldTrainCall):
    """The field backward's host code without a device."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _autograd(fn, inputs, cot):
    xs = [torch.as_tensor(np.asarray(a, np.float64)).requires_grad_(True) for a in inputs]
    with torch.enable_grad():
        y = fn(*xs)
        return y.detach().numpy(), [g.numpy() for g in torch.autograd.grad(y, xs, cot)]


# (input width, the encode's frequencies or 0 for an input x, H, hidden
# layers, output)
TRUNKS = [(512, 256, 512, 3, 32), (32, 16, 96, 2, 17), (96, 48, 100, 3, 64),
          (512, 0, 512, 3, 17), (48, 0, 96, 2, 64), (256, 128, 256, 3, 16),
          (1472, 0, 256, 3, 16), (16, 8, 1, 2, 1), (64, 0, 64, 2, 7),
          (512, 256, 1024, 3, 64), (256, 0, 1024, 2, 17), (96, 48, 600, 2, 130),
          (512, 0, 1000, 3, 1024), (96, 48, 300, 3, 17), (64, 0, 160, 2, 5)]


@pytest.mark.parametrize("din,m,h,nh,out", TRUNKS)
def test_padded_trunk_emulation_is_the_trunk(din, m, h, nh, out):
    """The trunk alone on its instance, forward and backward, from the
    images the trunk kernels read: output, every layer's dW and db, dW_spec,
    dphase and du (or dx) equal the unpadded trunk's own."""
    shapes = fi.trunk_layout(din, h, nh, out).shapes
    assert fi.check_trunk("t", shapes, m) == (din, h, nh, out)
    H = fi.instance(h)
    n_kb = fi.enc_blocks(m) if m else fi.x_blocks(din)
    rng = np.random.default_rng(din + 7 * h + out)
    leaves = [rng.standard_normal(s) * 0.5 for s in shapes]
    W = rng.standard_normal((3, m)) if m else None
    phase = rng.uniform(size=(m,)) if m else None
    u = rng.uniform(size=(N_ROWS, 3))
    x = rng.standard_normal((N_ROWS, din))
    g = rng.standard_normal((N_ROWS, out))
    fwd, bwd, bias = repacked(leaves, fi.trunk_index_tables(din, m, h, nh, out))
    assert 2 * fwd.size == sum(b for _, b in fi.fwd_slabs(H, nh, n_kb, False, out))

    inp = encoding(W, phase, u, m) if m else pad(x, 64 * n_kb)
    sl = Slabs(fwd)
    hs, y = trunk_forward(sl, bias, inp, H, nh, n_kb, fi.out_chunks(out))
    sl.done()
    sb = Slabs(bwd)
    g_top = pad(g, 64 * fi.gt_blocks(out))
    ghs, g_in = trunk_backward(sb, hs, g_top, H, nh, fi.pair_blocks(m) if m else n_kb)
    sb.done()

    # the kernels' sums, read back by the port's host code
    plan = fi.dw_plan(H, nh, n_kb, 1, 132, False, out)
    bufs = {"enc": inp, "gt": g_top, **{f"h{l}": hs[l] for l in range(nh)},
            **{f"gh{l}": ghs[l] for l in range(nh)}}
    out_buf = weight_products(plan, bufs)
    tpad = fi.t_pad(False, out)
    mp = 32 * fi.back_blocks(fi.pair_blocks(m), fi.gt_blocks(out), H) if m else 0
    gb = np.zeros(fi.n_bias(H, nh, tpad, mp))
    for l in range(nh):
        gb[l * H: (l + 1) * H] = ghs[l].sum(0)
    gb[nh * H: nh * H + tpad] = g_top.sum(0)
    if m:
        dproj, sums = spectrum_sums(inp, g_in, u, mp)
        gb[nh * H + tpad + H:] = sums
    host = _TrunkHost(H=H, nh=nh, n_kb=n_kb, _dw=plan, tpad=tpad, mp=mp)
    rows = ft._enc_rows(torch.device("cpu"), m) if m else None
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    grads, _ = host._trunk_grads(T(out_buf), T(gb), rows, din, h, out)

    def trunk(*args):
        spec, flat = (args[:2], args[2:]) if m else ((), args)
        hh = encode64(*spec, T(u)) if m else T(x)
        for l in range(nh + 1):
            hh = hh @ flat[2 * l] + flat[2 * l + 1]
            hh = torch.relu(hh) if l < nh else hh
        return hh

    y_ref, g_ref = _autograd(trunk, ([W, phase] if m else []) + leaves, T(g))
    close(y[:, :out], y_ref, "y")
    got = list(host._spectrum_grads(T(gb), m)) + grads if m else grads
    for i, (a, b) in enumerate(zip(got, g_ref)):
        close(a, b, f"grad {i}")
    # the position gradient (K1) and dx (K3) never reach the host: the kernels write them
    if m:
        _, (du_ref,) = _autograd(lambda uu: _trunk_on_u(uu, W, phase, leaves, nh), [u], T(g))
        close(TWO_PI * dproj[:, :m] @ W.T, du_ref, "du")
    else:
        _, (dx_ref,) = _autograd(lambda xx: _trunk_on_x(xx, leaves, nh), [x], T(g))
        close(g_in[:, :din], dx_ref, "dx")  # g_in: x's columns in order


def encode64(W, phase, u):
    """[cos, sin](2π·u·W + φ) in float64 (``encode_plain`` takes the phase
    in f32)."""
    proj = TWO_PI * (u @ W) + phase
    return torch.cat([torch.cos(proj), torch.sin(proj)], -1)


def _trunk_on_u(u, W, phase, leaves, nh):
    return _apply(encode64(torch.from_numpy(W), torch.from_numpy(phase), u), leaves, nh)


def _trunk_on_x(x, leaves, nh):
    return _apply(x, leaves, nh)


def _apply(hh, leaves, nh):
    for l in range(nh + 1):
        hh = hh @ torch.from_numpy(leaves[2 * l]) + torch.from_numpy(leaves[2 * l + 1])
        hh = torch.relu(hh) if l < nh else hh
    return hh


# (frequencies, H, hidden layers, geo, classes): whole fields, the first
# tier's (T_out 16, C_pad 64), then the wider tiers'
FIELDS = [(16, 96, 3, 15, 29), (48, 100, 2, 7, 5), (256, 512, 3, 15, 29), (128, 256, 3, 15, 29),
          (40, 512, 2, 3, 64), (32, 64, 2, 1, 1), (8, 4, 3, 2, 3),
          (64, 128, 2, 31, 101), (32, 64, 3, 47, 256), (16, 100, 2, 16, 65),
          (48, 512, 2, 31, 150), (40, 512, 3, 20, 100),
          (16, 64, 3, 63, 1000), (32, 128, 2, 48, 257), (48, 512, 3, 63, 1024),
          (16, 100, 2, 50, 300), (8, 256, 3, 3, 847),
          (128, 1024, 3, 15, 29), (64, 1024, 2, 63, 1024), (32, 700, 3, 31, 101),
          (256, 1024, 2, 47, 256), (40, 300, 3, 7, 5)]


@pytest.mark.parametrize("m,h,nh,G,C", FIELDS)
def test_padded_field_emulation_is_the_field(m, h, nh, G, C):
    """The whole field on its instance (heads H // 4 padded to the
    instance's H / 4 too), forward and backward, from the images the field
    kernels read: the packed output (rgb, sigma, logits), every leaf's
    gradient and du equal the unpadded field's own."""
    shapes = fi.leaf_layout(m, h, nh, G, C).shapes
    assert fi.check_widths("t", shapes) == (m, h, nh, G, C)
    H, hH, hi = fi.instance(h), fi.head_width(fi.instance(h)), fi.head_imgs(fi.instance(h))
    n_kb = fi.enc_blocks(m)
    t_out, c_tile = fi.tier(G, C)
    n_sem, xi = c_tile // 64, fi.xs_imgs(t_out)
    rng = np.random.default_rng(m + 3 * h + C)
    # He-scaled weights, biases of 0.1: the density's raw value stays moderate
    leaves = [rng.standard_normal(s) * (np.sqrt(2 / s[0]) if len(s) == 2 and i > 1 else 0.1)
              for i, s in enumerate(shapes)]
    leaves[0] = rng.standard_normal(shapes[0])
    R, S = 10, 4
    N = R * S
    u = rng.uniform(-0.1, 1.1, size=(N, 3))
    sh = rng.standard_normal((R, 16))
    g = rng.standard_normal((N, 4 + C))
    fwd, bwd, bias = repacked(leaves, fi.index_tables(m, h, nh, G, C))
    offs = fi.bias_offsets(H, nh, t_out, c_tile)

    # forward: trunk, density, heads
    enc = encoding(leaves[0], leaves[1], u, m)
    sl = Slabs(fwd)
    hs, t = trunk_forward(sl, bias, enc, H, nh, n_kb, 1, t_out)
    raw = t[:, 0]
    inside = ((u > 0) & (u < 1)).all(-1)
    xs = np.zeros((N, 64 * xi))  # the heads' input [SH | geo | 0], xi images
    xs[:, :16] = np.repeat(sh, S, axis=0)
    xs[:, 16: 16 + G] = t[:, 1: 1 + G]
    # rgb's k-blocks, then sem's: [64 xi, H/4] each
    w1 = [np.concatenate([sl.take(hH).T for _ in range(xi)]) for _ in range(2)]
    h1 = [relu(xs @ w + bias[offs[k]: offs[k] + hH]) for w, k in zip(w1, ("rb0", "sb0"))]
    w2 = []
    for _ in range(2):
        w = np.zeros((64 * hi, hH))
        for kb in range(hi):
            w[64 * kb: 64 * kb + 64] = sl.take(hH).T
        w2.append(w)
    h2 = [relu(pad(a, 64 * hi) @ w + bias[offs[k]: offs[k] + hH])
          for a, w, k in zip(h1, w2, ("rb1", "sb1"))]
    w3 = [np.zeros((64 * hi, 16)), np.zeros((64 * hi, c_tile))]
    for kb in range(hi):
        w3[0][64 * kb: 64 * kb + 64] = sl.take(16).T
    for ch in range(n_sem):  # 64 semantic columns a slab
        for kb in range(hi):
            w3[1][64 * kb: 64 * kb + 64, 64 * ch: 64 * ch + 64] = sl.take(64).T
    sl.done()
    rgb = 1 / (1 + np.exp(-(pad(h2[0], 64 * hi) @ w3[0] + bias[offs["rb2"]: offs["rb2"] + 16])))
    sem = pad(h2[1], 64 * hi) @ w3[1] + bias[offs["sb2"]: offs["sb2"] + c_tile]
    y = np.concatenate([rgb[:, :3], (np.exp(raw - 1) * inside)[:, None], sem[:, :C]], -1)

    # backward, from the packed output's cotangent
    gout = [pad(g[:, :3] * rgb[:, :3] * (1 - rgb[:, :3]), 64), pad(g[:, 4:], c_tile)]
    graw = g[:, 3] * np.exp(np.minimum(raw - 1, 15)) * inside
    sb = Slabs(bwd)
    # [H/4, 64] a block: B[n][k] = w[n][k]; rgb's, then the semantic blocks
    w3b = [sb.take(hH), np.concatenate([sb.take(hH) for _ in range(n_sem)], axis=1)]
    g2 = [(go @ w.T) * (a > 0) for go, w, a in zip(gout, w3b, h2)]
    w2b = []
    for _ in range(2):
        w = np.zeros((hH, 64 * hi))
        for kb in range(hi):
            w[:, 64 * kb: 64 * kb + 64] = sb.take(hH)
        w2b.append(w)
    g1 = [(pad(a, 64 * hi) @ w.T) * (b > 0) for a, w, b in zip(g2, w2b, h1)]
    dxs = np.zeros((N, 16 + t_out))
    for a in g1:
        w = np.zeros((16 + t_out, 64 * hi))
        for kb in range(hi):
            w[:, 64 * kb: 64 * kb + 64] = sb.take(16 + t_out)
        dxs += pad(a, 64 * hi) @ w.T
    gt = np.zeros((N, 64))
    gt[:, 0], gt[:, 1: 1 + G] = graw, dxs[:, 16: 16 + G]
    ghs, g_in = trunk_backward(sb, hs, gt, H, nh, fi.pair_blocks(m))
    sb.done()

    plan = fi.dw_plan(H, nh, n_kb, 1, 132, True, 0, c_tile, t_out)
    both = lambda pair: np.concatenate([pad(a, 64 * hi) for a in pair], -1)
    bufs = {"enc": enc, "gt": gt, "xs": xs, "hid1": both(h1), "hid2": both(h2), "g1": both(g1),
            "g2": both(g2), "gout": np.concatenate(gout, -1),
            **{f"h{l}": hs[l] for l in range(nh)}, **{f"gh{l}": ghs[l] for l in range(nh)}}
    out_buf = weight_products(plan, bufs)
    mp = 32 * fi.back_blocks(fi.pair_blocks(m), 1, H)
    gb = np.zeros(fi.n_bias(H, nh, t_out, mp))
    for l in range(nh):
        gb[l * H: (l + 1) * H] = ghs[l].sum(0)
    o = nh * H
    gb[o: o + t_out] = gt[:, :t_out].sum(0)
    o += t_out
    for a in (g1[0], g2[0], g1[1], g2[1]):
        gb[o: o + hH] = a.sum(0)
        o += hH
    dproj, sums = spectrum_sums(enc, g_in, u, mp)
    gb[o:] = sums
    cpad = -(-C // 16) * 16
    gr = np.concatenate([gout[0][:, :16].sum(0), gout[1][:, :cpad].sum(0)])
    fld = types.SimpleNamespace(m=m, H=H, h=h, out_t=1 + G, G=G, hh=h // 4, C=C, n_hidden=nh,
                                n_kb=n_kb, tier=(t_out, c_tile))
    host = _FieldHost(H=H, nh=nh, n_kb=n_kb, _dw=plan, tpad=t_out, mp=mp, fld=fld,
                      dev=torch.device("cpu"))
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    grads = host._field_grads(T(out_buf), T(gb), T(gr))

    def field(uu, *lv):
        W, phase, *rest = lv
        hh = encode64(W, phase, uu)
        for l in range(nh + 1):
            hh = hh @ rest[2 * l] + rest[2 * l + 1]
            hh = torch.relu(hh) if l < nh else hh
        head, semh = rest[2 * nh + 2: 2 * nh + 8], rest[2 * nh + 8:]
        raw_, geo = hh[:, 0], hh[:, 1:]
        x = torch.cat([T(np.repeat(sh, S, axis=0)), geo], -1)
        for l in range(3):
            x = x @ head[2 * l] + head[2 * l + 1]
            geo = geo @ semh[2 * l] + semh[2 * l + 1]
            if l < 2:
                x, geo = torch.relu(x), torch.relu(geo)
        sigma = trunc_exp(raw_ - 1) * T(inside.astype(np.float64))
        return torch.cat([torch.sigmoid(x), sigma[:, None], geo], -1)

    y_ref, g_ref = _autograd(field, [u] + leaves, T(g))
    close(y, y_ref, "y")
    for i, (a, b) in enumerate(zip(grads, g_ref[1:])):
        close(a, b, f"leaf {i}")
    close(TWO_PI * dproj[:, :m] @ leaves[0].T, g_ref[0], "du")


def _on_scale(port, ref, rel):
    port = port.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape
    err = np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-6)
    assert err <= rel, err


def _jax_mlp(widths, seed):
    """The JAX initialiser's MLP with seeded noise on the biases, as numpy."""
    params = jax.tree.map(np.asarray, j_nn.init_mlp(jax.random.PRNGKey(seed), widths))
    rng = np.random.default_rng(seed)
    for k in params:
        if k.startswith("b"):
            params[k] = (rng.standard_normal(params[k].shape) * 0.1).astype(np.float32)
    return params


@pytest.mark.parametrize("layers", [2, 3])
def test_wide_field_kernel_plain_matches_pallas_interpret(layers):
    """K1 at the 512 instance with 256 frequencies (8 k-blocks of the
    encoding) and a 32-wide output: the port's plain version against
    ``fused_spectral_field`` in interpret mode, 256 rows."""
    rng = np.random.default_rng(layers)
    params = _jax_mlp([512] + [512] * layers + [32], layers)
    W = (rng.standard_normal((3, 256)) * 4).astype(np.float32)
    phase = rng.uniform(size=(256,)).astype(np.float32)
    u = rng.uniform(size=(256, 3)).astype(np.float32)
    ref = j_fm.fused_spectral_field(jnp.asarray(W), jnp.asarray(phase),
                                    jax.tree.map(jnp.asarray, params), jnp.asarray(u))
    t_fm.fused_spectral_field.launches = 0
    mlp = MLP.from_tree(params)
    with torch.no_grad():
        got = t_fm.fused_spectral_field(torch.from_numpy(W), torch.from_numpy(phase), mlp,
                                        torch.from_numpy(u))
    assert t_fm.fused_spectral_field.launches == 0 and got.shape == (256, 32)
    _on_scale(got, ref, 2e-2)


@pytest.mark.parametrize("x_dtype", ["bfloat16", "float32"])
def test_wide_mlp_kernel_plain_matches_pallas_interpret(x_dtype):
    """K3 at the 512 instance with a 512-wide input and a 32-wide output:
    the port's plain version against ``fused_mlp_apply`` in interpret mode,
    256 rows, x in bf16 and in f32."""
    params = _jax_mlp([512, 512, 512, 512, 32], 4)
    x = np.random.default_rng(5).standard_normal((256, 512)).astype(np.float32)
    jd, td = (jnp.bfloat16, torch.bfloat16) if x_dtype == "bfloat16" else (jnp.float32,
                                                                           torch.float32)
    ref = j_fm.fused_mlp_apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x, jd))
    t_fm.fused_mlp_apply.launches = 0
    with torch.no_grad():
        got = t_fm.fused_mlp_apply(MLP.from_tree(params), torch.from_numpy(x).to(td))
    assert t_fm.fused_mlp_apply.launches == 0 and got.shape == (256, 32)
    _on_scale(got, ref, 2e-2)
