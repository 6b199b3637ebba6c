"""Plain reference of the (ngp, occ) train step: Instant-NGP's hash grid
(Müller et al. 2022), its occupancy grid and march, NeRF's quadrature,
the semantic NeRF loss and Adam, in float32 PyTorch with autograd.

``follow`` runs the first steps of an ensemble from the weights, the
images and the draw seed the benchmark hands to both sides, and works
out again everything the program derives from them: the draws, the
bootstrap pools, the occupancy grid, the march, the gradients and the
optimizer's state. Given a state to start from (a trained ensemble's
leaves, moments, update counts, grids and draw generator), it follows
the steps after it the same way. Nothing here imports the measured
program.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .common import (TruncExp, aabb_intersect, composite, layers_of, matmul_precision, mlp,
                     rays_from_pixels, sh_deg4, visibility_from_density, weights_from_density)

_PRIMES = (1, 2654435761, 805459861)
_MASK32 = 0xFFFFFFFF


# -- the hash grid -----------------------------------------------------------------------


def resolutions(cfg: dict) -> np.ndarray:
    L = cfg["n_levels"]
    s = np.exp((np.log(cfg["max_resolution"]) - np.log(cfg["base_resolution"])) / max(L - 1, 1))
    return np.array([int(np.floor(cfg["base_resolution"] * s**l + 1e-6)) for l in range(L)])


def corners(x: torch.Tensor, cfg: dict):
    """Flat table indices [L, N, 8] and trilinear weights [L, N, 8] of unit-cube
    points x [N, 3]; corner 4i + 2j + k is the (i, j, k) offset. Coarse levels
    whose (res+1)^3 grid fits the table index densely, the rest by the
    xor-of-primes hash; an index off the table (a point outside the cube)
    wraps once by L*T and is clamped."""
    L, T = cfg["n_levels"], 1 << cfg["log2_hashmap_size"]
    res = resolutions(cfg)
    xs = x[None] * torch.as_tensor(res, dtype=x.dtype, device=x.device)[:, None, None]
    base = torch.floor(xs)
    frac = xs - base
    base = base.long()
    idx = torch.empty((L, x.shape[0], 8), dtype=torch.long, device=x.device)
    wts = torch.empty((L, x.shape[0], 8), dtype=x.dtype, device=x.device)
    for c in range(8):
        off = ((c >> 2) & 1, (c >> 1) & 1, c & 1)
        w = torch.ones_like(frac[..., 0])
        for d in range(3):
            w = w * (frac[..., d] if off[d] else 1.0 - frac[..., d])
        wts[..., c] = w
        for l in range(L):
            p = [base[l, :, d] + off[d] for d in range(3)]
            if (int(res[l]) + 1) ** 3 <= T:
                s = int(res[l]) + 1
                f = p[0] + p[1] * s + p[2] * (s * s)
            else:
                h = [((pd & _MASK32) * pr) & _MASK32 for pd, pr in zip(p, _PRIMES)]
                f = (h[0] ^ h[1] ^ h[2]) % T
            idx[l, :, c] = f + l * T
    idx = torch.where(idx < 0, idx + L * T, idx).clamp(0, L * T - 1)
    return idx, wts


def hash_encode(table: torch.Tensor, x: torch.Tensor, cfg: dict) -> torch.Tensor:
    """[N, L*F] features, level-major; the table's gradient by autograd."""
    L, T, Fe = table.shape
    idx, w = corners(x, cfg)
    vals = table.reshape(L * T, Fe)[idx]  # [L, N, 8, F]
    out = (vals * w[..., None]).sum(dim=2)
    return out.permute(1, 0, 2).reshape(x.shape[0], L * Fe)


# -- the field ---------------------------------------------------------------------------


def density(p: Dict[str, torch.Tensor], cfg: dict, x: torch.Tensor, precision: str):
    """(density [N, 1], geometry features [N, G]) at world points x [N, 3]."""
    aabb = torch.as_tensor(cfg["aabb"], dtype=torch.float32, device=x.device)
    u = (x - aabb[:3]) / (aabb[3:] - aabb[:3])
    inside = ((u > 0.0) & (u < 1.0)).all(dim=-1)
    h = mlp(layers_of(p, "mlp_base"), hash_encode(p["table"], u, cfg), precision)
    return TruncExp.apply(h[:, :1] - 1.0) * inside[:, None], h[:, 1:]


def field(p, cfg, x, d, precision):
    sigma, geo = density(p, cfg, x, precision)
    rgb = torch.sigmoid(mlp(layers_of(p, "mlp_head"), torch.cat([sh_deg4(d), geo], -1), precision))
    return rgb, sigma, mlp(layers_of(p, "mlp_sem"), geo, precision)


# -- the occupancy grid and the march ---------------------------------------------------


def grid_resolution(cfg: dict):
    a = np.asarray(cfg["aabb"])
    return tuple(((a[3:] - a[:3]) / cfg["main_grid_size"]).astype(int).tolist())


def occupancy_update(occs, binaries, res, aabb, eval_fn, step, occ_thre, draws, cfg):
    """Instant-NGP's EMA grid: every cell during warm-up, after it a quarter
    uniform and a quarter among the cells ``binaries`` (the grid's last
    binarisation) marks occupied; max of the decayed value and the fresh
    density x step size; binarised at the visible mean capped by
    ``occ_thre`` → (occs, binaries)."""
    n = occs.shape[0]
    dev = occs.device
    if step < cfg["occ_warmup_steps"]:
        ids = torch.arange(n, device=dev)
    else:
        uni = draws["uniform_idx"]
        cdf = torch.cumsum(binaries.reshape(-1).float(), dim=0)
        occ_ids = torch.searchsorted(cdf, draws["occ_u"] * cdf[-1], right=True).clamp(0, n - 1)
        ids = torch.cat([uni, torch.where(cdf[-1] > 0, occ_ids, uni)])
    r0, r1, r2 = res
    coords = torch.stack([ids // (r1 * r2), (ids // r2) % r1, ids % r2], dim=-1).float()
    u = (coords + draws["jitter"]) / torch.tensor([r0, r1, r2], dtype=torch.float32, device=dev)
    with torch.no_grad():
        fresh = eval_fn(aabb[:3] + u * (aabb[3:] - aabb[:3])).reshape(-1)
    fresh = torch.nan_to_num(fresh, nan=0.0, posinf=torch.finfo(torch.float32).max)
    old = occs[ids]
    visible = old >= 0.0
    decayed = torch.where(visible, old * cfg["occ_ema_decay"], old)
    occs = occs.index_put((ids,), decayed)
    occs = occs.scatter_reduce(0, ids, torch.where(visible, torch.maximum(decayed, fresh), old),
                               reduce="amax", include_self=True)
    return occs, (occs > _threshold(occs, occ_thre)).reshape(res)


def _threshold(occs, occ_thre):
    vis = occs >= 0.0
    mean = torch.where(vis, occs, torch.zeros_like(occs)).sum() / vis.float().sum().clamp(min=1.0)
    return torch.clamp(mean, max=occ_thre)


def lattice(cfg: dict) -> np.ndarray:
    """Candidate interval edges shared by all rays: steps of ``render_step_size``
    until t reaches step / cone_angle, then growing by (1 + cone_angle)."""
    k = np.arange(cfg["n_candidates"] + 1, dtype=np.float64)
    near, dt, cone = cfg["near_plane"], cfg["render_step_size"], cfg["cone_angle"]
    if cone <= 0.0:
        return (near + k * dt).astype(np.float32)
    k0 = max(0.0, np.ceil((dt / cone - near) / dt))
    t_geo = (near + k0 * dt) * (1.0 + cone) ** (k - k0)
    return np.where(k < k0, near + k * dt, t_geo).astype(np.float32)


def march(o, d, binaries, aabb, edges, max_samples):
    """The first ``max_samples`` candidates of each ray whose midpoint lies
    inside the aabb and in an occupied cell → (t0, t1, valid) [R, S]."""
    lo, hi = aabb_intersect(o, d, aabb)
    tm = 0.5 * (edges[:-1] + edges[1:])[None, :]
    keep = (tm >= lo[:, None]) & (tm <= hi[:, None])
    gx, gy, gz = binaries.shape
    cell = torch.zeros_like(keep, dtype=torch.long)
    for axis, (n, stride) in enumerate(((gx, gy * gz), (gy, gz), (gz, 1))):
        u = (o[:, axis:axis + 1] + tm * d[:, axis:axis + 1] - aabb[axis]) / (
            aabb[axis + 3] - aabb[axis])
        keep &= (u >= 0.0) & (u < 1.0)
        cell += (u * n).to(torch.int32).clamp(0, n - 1).long() * stride
    keep &= binaries.reshape(-1)[cell]
    count = torch.cumsum(keep, dim=1, dtype=torch.int32)
    want = torch.arange(1, max_samples + 1, dtype=torch.int32, device=o.device)
    pos = torch.searchsorted(count, want.expand(o.shape[0], max_samples).contiguous())
    valid = want[None, :] <= count[:, -1:]
    pos = torch.where(valid, pos, torch.zeros_like(pos))
    zero = torch.zeros((), device=o.device)
    return (torch.where(valid, edges[:-1][pos], zero), torch.where(valid, edges[1:][pos], zero),
            valid)


# -- the draws, the pools and the ray batch ------------------------------------------------


def draw_step(cfg, n_members, step, hw, n_cells, gen, device) -> dict:
    """One step's draws from ``gen`` in the order the step consumes them:
    the image coin and pick of every member, then member by member its
    pixels, its background and, on the grid's cadence, the grid's draws."""
    H, W = hw
    R = cfg["num_rays"]
    d = {"coin": torch.rand((n_members,), generator=gen, device=device),
         "pick": torch.rand((n_members,), generator=gen, device=device),
         "x": [], "y": [], "bkgd": [], "occ": []}
    for _ in range(n_members):
        d["x"].append(torch.randint(0, W, (R,), generator=gen, device=device))
        d["y"].append(torch.randint(0, H, (R,), generator=gen, device=device))
        d["bkgd"].append(torch.rand((3,), generator=gen, device=device))
        if step % cfg["occ_every_n"] == 0:
            n_idx = n_cells if step < cfg["occ_warmup_steps"] else 2 * (n_cells // 4)
            d["occ"].append({
                "jitter": torch.rand((n_idx, 3), generator=gen, device=device),
                "uniform_idx": torch.randint(0, n_cells, (n_cells // 4,), generator=gen,
                                             device=device),
                "occ_u": torch.rand((n_cells // 4,), generator=gen, device=device),
            })
        else:
            d["occ"].append(None)
    return d


def bootstrap_pools(n_images: int, n_members: int, max_images: int, boot_scale: float = 0.7,
                    seed: int = 9):
    """Member 0 draws from every image; member m > 0 from a bootstrap resample
    of them, drawn as the online dataset draws it when the scan is added."""
    rng = np.random.RandomState(seed)
    cap = max(max_images, int(max_images * boot_scale) + 1)
    pools = np.zeros((n_members, cap), dtype=np.int64)
    counts = np.zeros((n_members,), dtype=np.int64)
    pools[0, :n_images] = np.arange(n_images)
    counts[0] = n_images
    for m in range(1, n_members):
        ids = rng.choice(n_images, size=int(n_images * boot_scale), replace=True)
        pools[m, :len(ids)] = ids
        counts[m] = len(ids)
    return pools, counts


def pick_images(pools, counts, recent_bias, size, sample_disc, coin, pick) -> torch.Tensor:
    P = pools.shape[1]
    valid = torch.arange(P, device=pools.device)[None, :] < counts[:, None]
    recent = valid & (pools >= size - sample_disc)
    use_recent = (coin < 0.5) & recent.any(dim=1) & bool(recent_bias)
    cdf = torch.cumsum(torch.where(use_recent[:, None], recent, valid).float(), dim=1)
    pos = torch.searchsorted(cdf, (pick * cdf[:, -1])[:, None], right=True).clamp(0, P - 1)
    return pools.gather(1, pos)[:, 0]


def fetch(data, image, x, y, K):
    """The batch of pixels (x, y) of one image: rays, colours in [0, 1],
    depths and classes."""
    H, W = data["images"].shape[1:3]
    flat = image * (H * W) + y * W + x
    o, d = rays_from_pixels(x.float(), y.float(), data["c2w"][image], K)
    return {"o": o, "d": d, "rgb": data["images"].reshape(-1, 3)[flat].float() / 255.0,
            "depth": data["depths"].reshape(-1)[flat], "sem": data["sems"].reshape(-1)[flat].long()}


# -- the member step ----------------------------------------------------------------------


def cyclic_lr(count: float, base: float, peak: float, up: int) -> float:
    cycle = np.floor(1.0 + count / (2.0 * up))
    x = abs(count / up - 2.0 * cycle + 1.0)
    return base + (peak - base) * max(0.0, 1.0 - x)


def follow(cfg: dict, weights: Sequence[Dict[str, torch.Tensor]], data: dict, draw_seed: int,
           n_steps: int, precision: str = "f32", recent_bias: bool = False,
           occ_thre: float = 1e-3, half_batch: bool = False, start: Optional[dict] = None) -> dict:
    """``n_steps`` ensemble steps from ``weights`` (one dict of leaves per
    member) → ``losses`` [n_steps] (the members' mean), ``grad1`` (each
    member's first gradient by leaf), ``params`` (each member's leaves
    after the steps). ``data``: ``images`` [N, H, W, 3] uint8, ``depths``,
    ``sems``, ``c2w`` [N, 4, 4] and ``K`` on one device. Without ``start``
    the steps are the first: fresh moments and grids, the draws from
    ``draw_seed``. ``start`` continues a trained ensemble instead:
    ``step`` (steps taken), ``gen_state`` (the draw generator's state) and
    by member ``mu`` and ``nu`` (by leaf), ``count`` (updates applied),
    ``occs`` and ``binaries``. ``half_batch`` plants a fault: each step's
    loss over the first half of its rays."""
    dev = data["images"].device
    E = len(weights)
    params = [{k: v.detach().to(dev, copy=True).float().requires_grad_(True) for k, v in w.items()}
              for w in weights]
    res = grid_resolution(cfg)
    n_cells = int(np.prod(res))
    aabb = torch.as_tensor(cfg["aabb"], dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev)
    if start is None:
        mu = [{k: torch.zeros_like(v) for k, v in p.items()} for p in params]
        nu = [{k: torch.zeros_like(v) for k, v in p.items()} for p in params]
        count0 = [0] * E
        occs = [torch.zeros(n_cells, device=dev) for _ in range(E)]
        bins = [torch.zeros(res, dtype=torch.bool, device=dev) for _ in range(E)]
        step0 = 0
        gen.manual_seed(draw_seed)
    else:
        mu = [{k: v.to(dev, copy=True) for k, v in m.items()} for m in start["mu"]]
        nu = [{k: v.to(dev, copy=True) for k, v in m.items()} for m in start["nu"]]
        count0 = [int(c) for c in start["count"]]
        occs = [o.to(dev, copy=True) for o in start["occs"]]
        bins = [b.to(dev, copy=True).reshape(res) for b in start["binaries"]]
        step0 = int(start["step"])
        gen.set_state(start["gen_state"])
    edges = torch.as_tensor(lattice(cfg), device=dev)
    pools, counts = bootstrap_pools(len(data["images"]), E, cfg["max_images"])
    pools, counts = torch.as_tensor(pools, device=dev), torch.as_tensor(counts, device=dev)
    hw = tuple(data["images"].shape[1:3])
    K = data["K"]
    losses, grad1 = [], []
    b1, b2, eps = 0.9, 0.999, cfg["adam_eps"]
    up = max(cfg["training_steps"] // 4, 1)
    with matmul_precision(precision):
        for i in range(n_steps):
            step = step0 + i
            d = draw_step(cfg, E, step, hw, n_cells, gen, dev)
            images = pick_images(pools, counts, recent_bias, len(data["images"]),
                                 cfg["sample_disc"], d["coin"], d["pick"])
            step_losses = []
            for m in range(E):
                p = params[m]
                if d["occ"][m] is not None:
                    occs[m], bins[m] = occupancy_update(
                        occs[m], bins[m], res, aabb,
                        lambda x: density(p, cfg, x, precision)[0] * cfg["render_step_size"],
                        step, occ_thre, d["occ"][m], cfg)
                b = fetch(data, images[m], d["x"][m].long(), d["y"][m].long(), K)
                if half_batch:
                    b = {k: v[: v.shape[0] // 2] for k, v in b.items()}
                t0, t1, valid = march(b["o"], b["d"], bins[m], aabb, edges,
                                      cfg["max_samples_train"])
                pos = b["o"][:, None] + (0.5 * (t0 + t1))[..., None] * b["d"][:, None]
                S = pos.shape[1]
                dirs = b["d"][:, None].expand(pos.shape).reshape(-1, 3)
                rgb, sigma, sem = field(p, cfg, pos.reshape(-1, 3), dirs, precision)
                R = pos.shape[0]
                sigma = sigma.reshape(R, S) * valid
                thre = torch.clamp(occs[m].mean(), max=cfg["alpha_thre"])
                sigma = sigma * visibility_from_density(t0, t1, sigma.detach(), thre)
                w = weights_from_density(t0, t1, sigma)
                out = composite(w, t0, t1, rgb.reshape(R, S, 3), sem.reshape(R, S, -1),
                                d["bkgd"][m])
                loss = (F.huber_loss(out["rgb"], b["rgb"], delta=1.0) * 10.0
                        + F.huber_loss(out["depth"][:, 0], b["depth"], delta=1.0) / 5.0
                        + F.cross_entropy(out["sem"], b["sem"]) / 2.0)
                names = list(p)
                grads = dict(zip(names, torch.autograd.grad(loss, [p[k] for k in names])))
                if i == 0:
                    grad1.append({k: g.detach().clone() for k, g in grads.items()})
                count = count0[m] + i
                lr = cyclic_lr(float(count), cfg["lr_base"], cfg["lr"], up)
                with torch.no_grad():
                    for k in names:
                        g = grads[k]
                        mu[m][k] = b1 * mu[m][k] + (1 - b1) * g
                        nu[m][k] = b2 * nu[m][k] + (1 - b2) * g * g
                        mh = mu[m][k] / (1 - b1 ** (count + 1))
                        vh = nu[m][k] / (1 - b2 ** (count + 1))
                        p[k] -= lr * mh / (torch.sqrt(vh) + eps)
                step_losses.append(float(loss.detach()))
            losses.append(float(np.mean(step_losses)))
    return {"losses": losses, "grad1": grad1,
            "params": [{k: v.detach() for k, v in p.items()} for p in params]}
