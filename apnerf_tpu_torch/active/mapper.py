"""ActiveNeRFMapper, the planning-step subset.

Port of the parts of ``apnerf_tpu/active/mapper.py`` that one planning
step runs on the device: candidate trajectories from the occupancy grids
(``_sample_candidates``, host numpy), then each candidate rendered in 40
views by every ensemble member with variance and scored by predictive
information (``dispatch_uncertainty``, ``_score_candidates``). Flagship
path (spectral field + proposal sampling) only.

Members are a Python list of modules and views a Python loop, as the JAX
renderer maps over views with ``lax.map`` (``mapper.py:331``): one view
of one member at the production size is 4096 rays x 256 samples, about
a million field rows. The candidate render is deterministic
(``stratified=False``), so it takes no generator.

The device is explicit (default ``"cuda"``): a mapper never moves itself
to the CPU.
"""

from __future__ import annotations

import datetime
import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from apnerf_tpu.planning.traj import sample_traj

from ..config import PipelineConfig
from ..interop import load_member_npz
from ..models import spectral
from ..ops.occupancy import OccGridState
from ..ops.rays import Rays, make_intrinsics, pose_matrix_from_quat, rays_from_pixels
from ..render.prop_renderer import render_rays_prop
from ..train.flagship import (
    init_flagship_params,
    make_flagship_occ_update,
    make_prop_config,
    make_spectral_config,
)
from .uncertainty import PredictiveInformation, predictive_information


def _unc_view_index(n: int) -> np.ndarray:
    """The 40 poses of an n-pose trajectory that are rendered and scored:
    20 spread over the flight, 20 over its closing spin."""
    a = np.linspace(0, n - 20, 20)
    b = np.linspace(n - 20, n - 1, 20)
    return np.hstack((a, b)).astype(int)


class ActiveNeRFMapper:
    def __init__(
        self,
        cfg: PipelineConfig,
        sim,
        save_path: Optional[str] = None,
        seed: int = 9,
        unc_scale: float = 0.1,
        max_samples_unc: int = 256,
        device="cuda",
    ):
        if (cfg.field_type, cfg.sampler_type) == ("ngp", "occ"):
            raise ValueError(
                "the (ngp, occ) oracle path is not ported yet: it is queued "
                "after the flagship train step and the mapper loop (ROADMAP.md)"
            )
        if (cfg.field_type, cfg.sampler_type) != ("spectral", "prop"):
            raise ValueError(
                "supported (field_type, sampler_type): (spectral, prop); "
                f"got ({cfg.field_type}, {cfg.sampler_type})"
            )
        self.cfg = cfg
        self.sim = sim
        self.device = torch.device(device)
        self.save_path = save_path or os.path.join(
            cfg.save_path, datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
        )
        os.makedirs(self.save_path, exist_ok=True)
        self.rng = np.random.RandomState(seed)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.unc_scale = unc_scale
        self.max_samples_unc = max_samples_unc

        self.spectral_cfg = make_spectral_config(cfg)
        self.prop_cfg = make_prop_config(cfg)
        self.members, self.occ = init_flagship_params(cfg, self.generator, self.device)
        self.step = 0  # train steps taken (the occupancy warm-up reads it)
        self._occ_update_fn = make_flagship_occ_update(cfg)

        res = cfg.main_grid_resolution
        self.cost_map = np.full((res[0], res[2]), 0.5)
        self.visiting_map = np.zeros(self.cost_map.shape)
        self.global_origin = np.asarray(cfg.global_origin, dtype=np.float64)
        self.K = torch.as_tensor(
            make_intrinsics(cfg.img_w, cfg.img_h, cfg.hfov), device=self.device
        )
        self.trajector_uncertainty_list: List[List[List[float]]] = [
            [] for _ in range(cfg.planning_step)
        ]
        self._render_unc = self._build_ensemble_renderer(max_samples_unc, with_variance=True)

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    def _build_ensemble_renderer(self, max_samples: int, with_variance: bool) -> Callable:
        """→ ``render(members, occ, origins [V,P,3], viewdirs, bkgd)`` →
        dict of [E, V, P, ...] tensors (``n_samples`` [E, V]). The
        occupancy grids are accepted for signature parity: the flagship
        sampler does not read them."""
        cfg = self.cfg
        s_cfg, p_cfg = self.spectral_cfg, self.prop_cfg
        aabb = torch.as_tensor(cfg.aabb, dtype=torch.float32, device=self.device)

        @torch.inference_mode()
        def render(members, occ, origins, viewdirs, bkgd) -> Dict[str, torch.Tensor]:
            del occ
            per_member = []
            for m in members:
                def field_fn(pos, dirs, main=m.main):
                    return spectral.forward(main, s_cfg, pos, dirs)

                def prop_fn(pos, prop=m.prop):
                    return spectral.query_density_field(prop, p_cfg, pos)

                views = []
                for v in range(origins.shape[0]):
                    outs = render_rays_prop(
                        field_fn, prop_fn, origins[v], viewdirs[v], aabb,
                        num_samples=max_samples, num_prop_samples=cfg.num_prop_samples,
                        near_plane=cfg.near_plane, render_bkgd=bkgd,
                        stratified=False, with_variance=with_variance,
                    )
                    views.append(outs)
                per_member.append({k: torch.stack([o[k] for o in views]) for k in views[0]})
            return {k: torch.stack([pm[k] for pm in per_member]) for k in per_member[0]}

        return render

    def _poses_c2w(self, poses: np.ndarray) -> torch.Tensor:
        mats = [pose_matrix_from_quat(p[:3], p[3:]) for p in np.asarray(poses)]
        return torch.as_tensor(np.stack(mats), dtype=torch.float32, device=self.device)

    def _pose7_to_rays(self, poses: np.ndarray, scale: float) -> Rays:
        """Evenly subsampled image rays [V, P, 3] for [V, 7] poses: the
        reference's flat-index ``linspace`` subsampling, computed for the
        kept pixels only."""
        cfg = self.cfg
        W, H = cfg.img_w, cfg.img_h
        out_n = int(H * scale) * int(W * scale)
        idx = np.round(np.linspace(0, H * W - 1, out_n)).astype(np.int64)
        x = torch.as_tensor(idx % W, dtype=torch.float32, device=self.device)
        y = torch.as_tensor(idx // W, dtype=torch.float32, device=self.device)
        return rays_from_pixels(x[None], y[None], self._poses_c2w(poses)[:, None], self.K)

    def _pose7_to_grid_rays(self, poses: np.ndarray, oh: int, ow: int) -> Rays:
        """Axis-aligned low-resolution image rays [V, oh*ow, 3]."""
        K_s = torch.as_tensor(make_intrinsics(ow, oh, self.cfg.hfov), device=self.device)
        yy, xx = torch.meshgrid(
            torch.arange(oh, dtype=torch.float32, device=self.device),
            torch.arange(ow, dtype=torch.float32, device=self.device),
            indexing="ij",
        )
        return rays_from_pixels(
            xx.reshape(1, -1), yy.reshape(1, -1), self._poses_c2w(poses)[:, None], K_s
        )

    # ------------------------------------------------------------------
    # uncertainty scoring
    # ------------------------------------------------------------------

    def dispatch_uncertainty(self, trajectory: np.ndarray) -> PredictiveInformation:
        """Queue one candidate's render and score; returns the PI terms as
        0-dim device tensors, not yet read back."""
        rays = self._pose7_to_rays(trajectory[_unc_view_index(len(trajectory))], self.unc_scale)
        out = self._render_unc(
            self.members, self.occ, rays.origins, rays.viewdirs,
            torch.zeros(3, device=self.device),
        )
        return predictive_information(
            rgb_var=out["rgb_var"],
            depth_var=out["depth_var"][..., 0],
            sem_logits=out["sem"],
            acc=out["opacity"][..., 0],
        )

    def probablistic_uncertainty(self, trajectory: np.ndarray, step: int) -> float:
        """Predictive information of one candidate trajectory (blocking)."""
        pi = self.dispatch_uncertainty(trajectory)
        self.trajector_uncertainty_list[step - 1].append([float(v) for v in pi])
        return float(pi.total)

    # ------------------------------------------------------------------
    # the planning step
    # ------------------------------------------------------------------

    def _sample_candidates(self, binaries_host: np.ndarray, current_state: np.ndarray):
        """Host-side candidate trajectories from a binaries snapshot
        [E, X, Y, Z] (the reference's layout swap + ``sample_traj``)."""
        cfg = self.cfg
        vg = np.swapaxes(binaries_host[0], 1, 2)
        vg1 = np.swapaxes(
            binaries_host[1] if binaries_host.shape[0] > 1 else binaries_host[0], 1, 2
        )
        return sample_traj(
            voxel_grid=np.array([vg, vg1]),
            current_state=current_state[[0, 2, 1]],
            N_traj=cfg.num_traj,
            aabb=np.asarray(cfg.aabb)[[0, 2, 1, 3, 5, 4]],
            cost_map=self.cost_map,
            visiting_map=self.visiting_map,
            save_path=self.save_path,
            N_sample_disc=cfg.sample_disc,
            voxel_grid_size=cfg.main_grid_size,
            sim=self.sim,
            rng=self.rng,
        )

    def _score_candidates(self, candidates, step: int):
        """Queue every candidate's render and score, read them back once,
        and return (the best trajectory, its 40 scored poses)."""
        pis = [self.dispatch_uncertainty(c) for c in candidates]
        comps = torch.stack([torch.stack(list(p)) for p in pis]).double().cpu().numpy()
        self.trajector_uncertainty_list[step - 1].extend(comps.tolist())
        best = int(np.argmax(comps.sum(axis=1)))
        chosen = candidates[best]
        return chosen, chosen[_unc_view_index(len(chosen))]

    def binaries_host(self) -> np.ndarray:
        """The members' binary occupancy grids [E, X, Y, Z] on the host."""
        return torch.stack([o.binaries for o in self.occ]).cpu().numpy()

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------

    def load_checkpoints(self, ckpt_dir: str):
        """Restore the members' params and occupancy grids from the
        ``model_{i}.npz`` files the JAX mapper writes."""
        aabb = torch.as_tensor(self.cfg.aabb, dtype=torch.float32, device=self.device)
        members, occ = [], []
        for i in range(self.cfg.n_ensembles):
            member, occs, binaries = load_member_npz(
                os.path.join(ckpt_dir, f"model_{i}.npz"), self.device
            )
            members.append(member)
            occ.append(OccGridState(occs=occs, binaries=binaries, aabb=aabb))
        self.members, self.occ = members, occ
