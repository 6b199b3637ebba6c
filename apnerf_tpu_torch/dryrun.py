"""Entry points for a quick check of the port on JAX's tiny shapes.

Counterpart of ``__graft_entry__.py``:

* ``entry(device)`` → ``(fn, args)``: the flagship loss (the spectral
  semantic field rendered with proposal sampling, the 3-term loss plus
  the proposal-matching loss) on a ray batch (``:47-113``);
* ``_legacy_occ_entry(device)``: the same for the (ngp, occ) path
  (``:116-175``);
* ``dryrun_multichip(n, device)``: an ``(ens=2, data=n/2)`` mesh of ``n``
  ranks (the ens axis collapses to 1 for an odd ``n``, ``mesh_shape``)
  runs the sharded flagship phase, then one full planning step of the
  mesh-mode mapper on FakeSim (candidate renders, predictive
  information, fly, retrain), at JAX's tiny shapes, and checks that the
  losses and the evaluation rows are finite (``:178-303``).

    python -m apnerf_tpu_torch.dryrun [N] [--device cpu]

runs ``entry`` and then ``dryrun_multichip(N)`` (N = 8 by default). The
ranks run on the card unless ``--device cpu`` is given; on a host with
fewer cards than ranks they share them (``parallel/launch.py``). At these
widths the routes are ``default_route``'s, as everywhere in the port.
"""

from __future__ import annotations

import argparse
import shutil
import tempfile

import numpy as np
import torch
import torch.nn.functional as F

from .config import PipelineConfig


def _tiny_cfg(n_ensembles: int = 2) -> PipelineConfig:
    return PipelineConfig(
        aabb=(-1.0, -1.0, -1.0, 1.0, 1.0, 1.0), img_w=32, img_h=32, num_rays=128,
        max_samples_train=16, n_candidates=128, render_step_size=0.05, cone_angle=0.0,
        near_plane=0.1, main_grid_size=0.25, main_neurons=32, main_layer=2, n_levels=4,
        n_features=2, log2_hashmap_size=12, base_resolution=4, max_resolution=32,
        num_semantic_classes=8, n_ensembles=n_ensembles, max_images=4, occ_warmup_steps=4,
        occ_every_n=2,
    )


def _batch(cfg: PipelineConfig, device, seed: int = 2):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    R = cfg.num_rays
    rays_o = torch.rand((R, 3), generator=g, device=device) - 0.5
    rays_d = torch.randn((R, 3), generator=g, device=device)
    rays_d = rays_d / rays_d.norm(dim=-1, keepdim=True)
    target_rgb = torch.rand((R, 3), generator=g, device=device)
    target_dep = torch.rand((R,), generator=g, device=device) * 2
    target_sem = torch.randint(0, cfg.num_semantic_classes, (R,), generator=g, device=device)
    return rays_o, rays_d, target_rgb, target_dep, target_sem


def _loss(out, target_rgb, target_dep, target_sem) -> torch.Tensor:
    return (F.huber_loss(out["rgb"], target_rgb, delta=1.0) * 10.0
            + F.huber_loss(out["depth"][:, 0], target_dep, delta=1.0) / 5.0
            + F.cross_entropy(out["sem"], target_sem) / 2.0)


def entry(device="cuda"):
    """(fn, example_args): the flagship loss with proposal sampling on a
    ray batch; ``fn(member, rays_o, rays_d, target_rgb, target_dep,
    target_sem)`` → the loss, differentiable in the member's parameters."""
    from .models import spectral
    from .models.propnet import prop_loss
    from .render.prop_renderer import render_rays_prop
    from .train.flagship import FlagshipMember

    cfg = _tiny_cfg()
    s_cfg = spectral.SpectralConfig(
        aabb=cfg.aabb, neurons=32, layers=2, n_levels=4, freqs_per_level=2, base_freq=4.0,
        max_freq=32.0, num_semantic_classes=cfg.num_semantic_classes, geo_feat_dim=15,
    )
    p_cfg = spectral.SpectralDensityConfig(aabb=cfg.aabb, neurons=16, layers=1, base_freq=4.0,
                                           max_freq=16.0)
    device = torch.device(device)
    member = FlagshipMember(
        spectral.init_spectral(s_cfg, torch.Generator().manual_seed(0), device),
        spectral.init_spectral_density(p_cfg, torch.Generator().manual_seed(1), device),
    )
    aabb = torch.as_tensor(cfg.aabb, dtype=torch.float32, device=device)

    def fn(member, rays_o, rays_d, target_rgb, target_dep, target_sem):
        g = torch.Generator(device=rays_o.device)
        g.manual_seed(7)
        out, (levels, t0, t1, weights) = render_rays_prop(
            lambda pos, dirs: spectral.forward(member.main, s_cfg, pos, dirs),
            lambda pos: spectral.query_density_field(member.prop, p_cfg, pos),
            rays_o, rays_d, aabb, num_samples=cfg.max_samples_train,
            num_prop_samples=cfg.num_prop_samples, near_plane=cfg.near_plane,
            render_bkgd=torch.ones(3, device=rays_o.device), stratified=True, generator=g,
            return_levels=True,
        )
        return (_loss(out, target_rgb, target_dep, target_sem)
                + prop_loss(levels, t0, t1, weights))

    return fn, (member, *_batch(cfg, device))


def _legacy_occ_entry(device="cuda"):
    """The (ngp, occ) path's loss (hash grid + occupancy march, every cell
    occupied), likewise → (fn, example_args)."""
    from .models import ngp
    from .ops.occupancy import init_occ_grid
    from .render.renderer import render_train
    from .train.step import make_lattice, make_ngp_config

    cfg = _tiny_cfg()
    device = torch.device(device)
    ngp_cfg = make_ngp_config(cfg)
    lattice = make_lattice(cfg, device)
    occ = init_occ_grid(cfg.aabb, cfg.main_grid_resolution, device)
    occ = occ._replace(binaries=torch.ones_like(occ.binaries))
    field = ngp.init_ngp(ngp_cfg, torch.Generator().manual_seed(0), device)

    def fn(field, rays_o, rays_d, target_rgb, target_dep, target_sem):
        out = render_train(
            lambda pos, dirs: ngp.forward(field, ngp_cfg, pos, dirs), rays_o, rays_d, occ,
            lattice, cfg.max_samples_train, torch.ones(3, device=rays_o.device),
            alpha_thre=cfg.alpha_thre, occ_mean=torch.zeros((), device=rays_o.device),
        )
        return _loss(out, target_rgb, target_dep, target_sem)

    return fn, (field, *_batch(cfg, device, seed=1))


def _mapper_cfg() -> PipelineConfig:
    """JAX's tiny planning-step configuration (``__graft_entry__.py:266-280``)."""
    return PipelineConfig(
        aabb=(-4.0, 0.0, -4.0, 0.0, 3.0, 0.0), near_plane=0.1, main_grid_size=0.25,
        planning_step=1, num_traj=2, sample_disc=10, training_steps=4, render_step_size=0.05,
        cone_angle=0.0, n_ensembles=2, img_w=32, img_h=32, num_rays=128,
        max_samples_train=16, max_samples_test=32, n_candidates=128, num_semantic_classes=8,
        max_images=64, occ_warmup_steps=4, occ_every_n=2, spectral_neurons=32,
        spectral_layers=2, spectral_freqs_per_level=2, prop_neurons=16, prop_layers=1,
        num_prop_samples=8, test_loc=((-2.0, 1.5, -2.0),),
        global_origin=(-2.0, 1.5, -2.0, 0.0, 0.0, 0.0, 1.0),
    )


def _dryrun_rank(mesh) -> dict:
    """One rank of ``dryrun_multichip``: the sharded flagship phase, then
    one planning step of the mesh-mode mapper."""
    from .active.mapper import ActiveNeRFMapper
    from .data.dataset import RayDataset
    from .parallel.sharding import make_sharded_flagship_phase, place_training
    from .sim.fake import FakeSim
    from .train.flagship import init_flagship_ensemble
    from .train.phase import pools_from_dataset

    cfg = _tiny_cfg(n_ensembles=2)
    ds = RayDataset(training=True, num_rays=cfg.num_rays, num_models=cfg.n_ensembles,
                    width=cfg.img_w, height=cfg.img_h, max_images=cfg.max_images, device="cpu")
    rng = np.random.RandomState(0)
    ds.update_data(
        (rng.rand(3, cfg.img_h, cfg.img_w, 3) * 255).astype(np.uint8),
        rng.rand(3, cfg.img_h, cfg.img_w).astype(np.float32),
        rng.randint(0, cfg.num_semantic_classes, (3, cfg.img_h, cfg.img_w)),
        np.tile(np.eye(4, dtype=np.float32), (3, 1, 1)),
    )
    state, ds = place_training(
        init_flagship_ensemble(cfg, torch.Generator().manual_seed(0)), ds, mesh)
    pools, counts = pools_from_dataset(ds)
    gen = torch.Generator(device=mesh.device)
    gen.manual_seed(7)
    state, losses = make_sharded_flagship_phase(cfg, mesh)(
        state, ds.images, ds.depths, ds.semantics, ds.camtoworlds, ds.K,
        pools, counts, ds.size, 2, False, gen, occ_thre=1e-3,
    )
    losses = losses.cpu().numpy()
    if not np.isfinite(losses).all():
        raise RuntimeError(f"dryrun: non-finite sharded phase losses {losses}")

    mcfg = _mapper_cfg()
    tmp = mesh.agree(tempfile.mkdtemp(prefix="apnerf_dryrun_") if mesh.rank == 0 else None)
    try:
        sim = FakeSim(aabb=mcfg.aabb, img_w=mcfg.img_w, img_h=mcfg.img_h)
        m = ActiveNeRFMapper(mcfg, sim, save_path=tmp, seed=9, eval_scale=0.25,
                             unc_scale=0.15, max_samples_unc=16, checkpoint_every=10_000,
                             mesh=mesh)
        m.initialization(initial_samples=4)
        m.nerf_training(4, initial_train=True, planning_step=-1)
        done = m.planning(1, training_steps_per_step=4)
        if done != 1 or not all(np.isfinite(r[1]) for r in m.errors_hist):
            raise RuntimeError(f"dryrun: planning steps {done}, errors {m.errors_hist}")
        mesh.barrier()
    finally:
        if mesh.rank == 0:
            shutil.rmtree(tmp, ignore_errors=True)
    return {"losses": losses, "errors_hist": m.errors_hist, "shape": mesh.shape}


def dryrun_multichip(n_devices: int, device="cuda") -> list:
    """The sharded flagship phase and one planning step of the mesh-mode
    mapper on an (ens=2, data=n/2) mesh of ``n_devices`` ranks → each
    rank's report."""
    from .parallel.launch import launch
    from .parallel.mesh import mesh_shape

    n_ens, n_data = mesh_shape(n_devices, 2)
    ranks = launch(_dryrun_rank, n_ens, n_data, device=device)
    r = ranks[0]
    print(f"dryrun_multichip({n_devices}) OK: mesh {r['shape']}, per-step/member loss "
          f"{r['losses'].tolist()}; planning step errors {r['errors_hist']}", flush=True)
    return ranks


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("n", nargs="?", type=int, default=8, help="ranks of the mesh")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    fn, example = entry(args.device)
    print(f"entry loss: {float(fn(*example).detach()):.6f}", flush=True)
    fn, example = _legacy_occ_entry(args.device)
    print(f"legacy occ entry loss: {float(fn(*example).detach()):.6f}", flush=True)
    dryrun_multichip(args.n, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
