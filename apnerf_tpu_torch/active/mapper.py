"""ActiveNeRFMapper, the active-perception loop.

Port of ``apnerf_tpu/active/mapper.py`` on both of its paths: the
flagship (spectral field + proposal sampling) and the (ngp, occ) oracle
(hash-grid field + occupancy-grid march), picked by ``cfg.field_type`` and
``cfg.sampler_type``:

  * ``initialization``: the 39-pose 360° scan with ±0.2 m jitter, per-view
    cost-map fusion, the train and the test datasets;
  * ``nerf_training``: the ensemble train loop in chunks of 100 steps; on
    the flagship path each chunk is followed by the occupancy update, on
    the ngp path every member step updates its grid on its cadence;
    evaluation at the end of a call; the final refit's divergence guard;
  * ``planning``: candidate trajectories → predictive information → fly
    the best → observe → cost map and dataset update → retrain, with the
    stop criterion; overlapped (default) or strictly alternating;
  * ``pipeline``: init → train → plan → 5× final refit → artifacts, with
    the reference's on-disk layout and checkpoints either package resumes.

Members are a Python list of modules and views a Python loop, as the JAX
renderer maps over views with ``lax.map`` (``mapper.py:331``): one view
of one member at the production size is 4096 rays × 256 samples, about a
million field rows. Renders are deterministic (``stratified=False``), so
they take no generator. On the card the candidate render (with variance)
goes through the packed field kernel, the evaluation and visualisation
renders (no variance) through the fused field-and-render kernel
(``models/spectral.py::forward_packed``, ``forward_packed_volrend``),
whatever the field's configuration: a field those kernels do not take
raises there. On the CPU the plain ``spectral.forward`` renders. On the
ngp path every member renders every view with its own occupancy grid
(``render/renderer.py``), in chunks of rays where a view's samples would
pass ``RENDER_ROWS``; its weights go through the weights kernel on the
card.

Two things differ from the JAX mapper because parameters here update in
place. The divergence guard's snapshot is a deep copy of the members (the
JAX state is immutable). And the overlapped loop writes a due checkpoint
right after the settled phase, before it queues the next phase, not
among the host work deferred past it.

The reference's faults that the JAX mapper carries are carried here too,
so that the two agree: the guard's snapshot is taken before the chunk's
occupancy update, and ``learning_rate_lst`` is read at ``step0 + done``
with the ``step0`` of the call's start after a rollback as well.

The device is explicit (default ``"cuda"``): a mapper never moves itself
to the CPU. PNG dumps (``save_viz=True``) need ``imageio``.

Mesh mode (``mesh=``, ``mapper.py:83-93,130-175``): one mapper a rank of
an (ens, data) mesh (``parallel/``). The train phase is the sharded one,
the renders are sharded and gathered (``ensemble_renderer`` and
``ngp_renderer`` are the unsharded renders, module functions so that
``parallel/sharding.py`` builds on them), the occupancy grids are
gathered for the planner, and every host decision reads values that are
the same on every rank: a (2, 1) mesh flies the unsharded mapper's
trajectory and repeats its rows bit for bit.
"""

from __future__ import annotations

import copy
import datetime
import functools
import json
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..config import PipelineConfig
from ..data.dataset import RayDataset
from ..interop import load_member_npz, load_member_opt, save_member_npz
from ..models import spectral
from ..models import ngp
from ..ops.occupancy import OccGridState, mark_invisible_cells
from ..ops.rays import Rays, make_intrinsics, pose_matrix_from_quat, rays_from_pixels
from ..planning.cost_map import depth_scan_angles, update_cost_map
from ..planning.traj import sample_traj
from ..render.prop_renderer import render_rays_prop
from ..render.renderer import render_test
from ..train.flagship import (
    default_route,
    default_spectral_schedule,
    init_flagship_ensemble,
    make_flagship_occ_update,
    make_flagship_train_phase,
    make_prop_config,
    make_spectral_config,
)
from ..train.phase import make_ngp_train_phase, pools_from_dataset
from ..train.schedule import multistep_lr
from ..train.step import (
    EnsembleState,
    default_ngp_schedule,
    init_ensemble,
    make_lattice,
    make_ngp_config,
    reset_opt_state,
)
from ..utils.metrics import depth_mse, lpips_vgg, miou, psnr, semantic_ce
from .uncertainty import PredictiveInformation, predictive_information


def _euler_yzx_yaw(R_m: np.ndarray) -> float:
    """Yaw (rotation about world y) matching scipy's
    ``R.from_matrix(R).as_euler("yzx")[0]`` used by the reference."""
    return float(np.arctan2(-R_m[2, 0], R_m[0, 0]))


def _yaw_quat_deg(angle_deg: float) -> np.ndarray:
    a = np.deg2rad(angle_deg) / 2
    return np.array([0.0, np.sin(a), 0.0, np.cos(a)])


# samples of one ngp render call: a view with more rays × samples renders
# in chunks of rays (the hash encode holds ~2.2 KB of intermediates a sample)
RENDER_ROWS = 1 << 20


def _unc_view_index(n: int) -> np.ndarray:
    """The 40 poses of an n-pose trajectory that are rendered and scored:
    20 spread over the flight, 20 over its closing spin."""
    a = np.linspace(0, n - 20, 20)
    b = np.linspace(n - 20, n - 1, 20)
    return np.hstack((a, b)).astype(int)


def _snapshot(state: EnsembleState) -> EnsembleState:
    """A copy of ``state`` that further training cannot touch: the members
    update in place, so they are copied; optimizer states and grids are
    replaced, never written, by a step."""
    return state._replace(
        members=[copy.deepcopy(m) for m in state.members],
        opt=list(state.opt), occ=list(state.occ),
    )


def ensemble_renderer(cfg: PipelineConfig, max_samples: int, with_variance: bool, device,
                      lattice: Optional[torch.Tensor] = None,
                      field_cfgs: Optional[tuple] = None) -> Callable:
    """→ ``render(members, occ, origins [V,P,3], viewdirs, bkgd)`` → dict of
    [E, V, P, ...] tensors of the members given (``n_samples`` [E, V]); on
    the ngp path (``lattice`` given) see ``ngp_renderer``. The occupancy
    grids are accepted for signature parity: the flagship sampler does not
    read them. The device and the field's configuration pick the route: on
    the card a field whose member core takes the combined kernel
    (``default_route`` is ``lossgrad``) renders through the packed
    kernels, with variance the packed field, without it the fused field and
    render; any other field renders through ``spectral.forward``, as the
    JAX mapper renders every field (encode + trunk in the field kernel for
    a bf16 field with 2 or 3 hidden layers, the plain chain for the rest).
    On the CPU the plain ``spectral.forward`` renders. ``field_cfgs``: the
    (spectral, proposal) fields' configurations, when they are not the ones
    ``cfg`` gives."""
    if cfg.sampler_type != "prop":
        return ngp_renderer(cfg, lattice, max_samples, with_variance)
    s_cfg, p_cfg = field_cfgs or (make_spectral_config(cfg), make_prop_config(cfg))
    device = torch.device(device)
    aabb = torch.as_tensor(cfg.aabb, dtype=torch.float32, device=device)
    packed = device.type != "cpu" and default_route(s_cfg) == "lossgrad"

    @torch.inference_mode()
    def render(members, occ, origins, viewdirs, bkgd) -> Dict[str, torch.Tensor]:
        del occ
        per_member = []
        for m in members:
            def field_fn(pos, dirs, main=m.main):
                return spectral.forward(main, s_cfg, pos, dirs)

            def prop_fn(pos, prop=m.prop):
                return spectral.query_density_field(prop, p_cfg, pos)

            def packed_fn(pos, rays_d, main=m.main):
                return spectral.forward_packed(main, s_cfg, pos, rays_d)

            def packed_vr_fn(pos, rays_d, t0, t1, miss, main=m.main):
                return spectral.forward_packed_volrend(main, s_cfg, pos, rays_d, t0, t1, miss)

            views = []
            for v in range(origins.shape[0]):
                outs = render_rays_prop(
                    field_fn, prop_fn, origins[v], viewdirs[v], aabb,
                    num_samples=max_samples, num_prop_samples=cfg.num_prop_samples,
                    near_plane=cfg.near_plane, render_bkgd=bkgd,
                    stratified=False, with_variance=with_variance,
                    field_packed_fn=packed_fn if packed and with_variance else None,
                    field_packed_vr_fn=packed_vr_fn if packed and not with_variance else None,
                )
                views.append(outs)
            per_member.append({k: torch.stack([o[k] for o in views]) for k in views[0]})
        return {k: torch.stack([pm[k] for pm in per_member]) for k in per_member[0]}

    return render


def ngp_renderer(cfg: PipelineConfig, lattice: torch.Tensor, max_samples: int,
                 with_variance: bool) -> Callable:
    """The ngp branch (``mapper.py:340-436``): each member renders each
    view through the occupancy march of its own grid, ``alpha_thre``
    clamped by that grid's mean occupancy; a view whose rays ×
    ``max_samples`` pass ``RENDER_ROWS`` renders in chunks of rays
    (``n_samples`` sums over them). The march is deterministic, so the
    render draws nothing."""
    ngp_cfg = make_ngp_config(cfg)
    chunk = max(RENDER_ROWS // max_samples, 1)

    @torch.inference_mode()
    def render(members, occ, origins, viewdirs, bkgd) -> Dict[str, torch.Tensor]:
        per_member = []
        for m, grid in zip(members, occ):
            def field_fn(pos, dirs, m=m):
                return ngp.forward(m, ngp_cfg, pos, dirs)

            views = []
            for v in range(origins.shape[0]):
                parts = [
                    render_test(
                        field_fn, origins[v, i:i + chunk], viewdirs[v, i:i + chunk], grid,
                        lattice, max_samples, bkgd, cfg.alpha_thre, with_variance,
                    )
                    for i in range(0, origins.shape[1], chunk)
                ]
                views.append({
                    k: sum(p[k] for p in parts) if k == "n_samples"
                    else torch.cat([p[k] for p in parts])
                    for k in parts[0]
                })
            per_member.append({k: torch.stack([o[k] for o in views]) for k in views[0]})
        return {k: torch.stack([pm[k] for pm in per_member]) for k in per_member[0]}

    return render


class ActiveNeRFMapper:
    def __init__(
        self,
        cfg: PipelineConfig,
        sim,
        save_path: Optional[str] = None,
        seed: int = 9,
        eval_scale: float = 0.25,
        unc_scale: float = 0.1,
        max_samples_unc: int = 256,
        checkpoint_every: int = 1000,
        device="cuda",
        save_viz: bool = False,
        mesh=None,
    ):
        """``save_viz``: write the per-planning-step visualisation PNGs and
        the test-view prediction PNGs (the JAX mapper always does); it
        needs ``imageio`` and raises here without it.

        ``mesh``: this rank's ``parallel/mesh.Mesh`` (``make_mesh``), whose
        device the mapper takes. Every rank builds all E members from the
        seeded generator, as the unsharded mapper does, and keeps its own;
        the train phase and the renders run sharded (members over ``ens``,
        rays over ``data``), the occupancy update on the rank's members
        with every member's draws made in order, and every host decision is
        taken from values that are the same on every rank. Rank 0 alone
        writes files; its checkpoints are the unsharded ``model_{i}.npz``
        of every member."""
        if (cfg.field_type, cfg.sampler_type) not in (("spectral", "prop"), ("ngp", "occ")):
            raise ValueError(
                "supported (field_type, sampler_type): (spectral, prop) or (ngp, occ); "
                f"got ({cfg.field_type}, {cfg.sampler_type})"
            )
        self.mesh = mesh
        self.is_root = mesh is None or mesh.rank == 0
        self.device = torch.device(device if mesh is None else mesh.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "the mapper was asked for a CUDA device and none is available; pass "
                "device='cpu' to run the plain versions"
            )
        self.save_viz = save_viz
        if save_viz:
            import imageio.v2  # noqa: F401  (fail here, not at the first dump)
        self.cfg = cfg
        self.sim = sim
        self.save_path = self._agree(save_path or os.path.join(
            cfg.save_path, datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
        ))
        os.makedirs(self.save_path, exist_ok=True)
        self.rng = np.random.RandomState(seed)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.eval_scale = eval_scale
        self.unc_scale = unc_scale
        self.max_samples_unc = max_samples_unc
        self.checkpoint_every = checkpoint_every

        self.use_prop = cfg.sampler_type == "prop"
        if self.use_prop:
            self.spectral_cfg = make_spectral_config(cfg)
            self.prop_cfg = make_prop_config(cfg)
            self.state: EnsembleState = init_flagship_ensemble(cfg, self.generator, self.device)
            self._make_phase = make_flagship_train_phase
            # the occupancy EMA runs once per chunk, outside the chunk's steps
            self._occ_update_fn = make_flagship_occ_update(cfg)
            # the active LR schedule, swapped by nerf_training(final_train=True)
            self._schedule = default_spectral_schedule(cfg)
            self._lr = cfg.spectral_lr  # the final refit's base LR
        else:
            self.ngp_cfg = make_ngp_config(cfg)
            self.state = init_ensemble(cfg, self.generator, self.device)
            # the march's lattice, shared by the member core and the renders
            self.lattice = make_lattice(cfg, self.device)
            self._make_phase = functools.partial(make_ngp_train_phase, lattice=self.lattice)
            self._occ_update_fn = None  # each member step updates its own grid
            self._schedule = default_ngp_schedule(cfg)
            self._lr = cfg.lr
        # the rank's members among the E (None: all of them)
        self._local = None
        if mesh is not None:
            from ..parallel.mesh import shard_ensemble_state
            from ..parallel.sharding import make_sharded_flagship_phase, make_sharded_occ_phase

            self._local = mesh.members(cfg.n_ensembles)
            mesh.rays(cfg.num_rays)
            self.state = shard_ensemble_state(self.state, mesh)
            self._make_phase = (
                functools.partial(make_sharded_flagship_phase, mesh=mesh) if self.use_prop
                else functools.partial(make_sharded_occ_phase, mesh=mesh, lattice=self.lattice)
            )
        self.train_phase_fn = self._make_phase(cfg)
        # steps per chunk: the occupancy update, the LR bookkeeping and the
        # checkpoint cadence move with it (``mapper.py:196-206``; the JAX
        # occ path's cap of 5 steps worked around a TPU fault)
        self.steps_per_call = min(100, max(cfg.training_steps, 1))

        res = cfg.main_grid_resolution
        # cost map over (x, z)
        self.cost_map = np.full((res[0], res[2]), 0.5)
        self.visiting_map = np.zeros(self.cost_map.shape)
        self.align_angles = depth_scan_angles(cfg.img_w)
        self.global_origin = np.asarray(cfg.global_origin, dtype=np.float64)
        self.current_pose = self.global_origin.copy()
        self.K = torch.as_tensor(
            make_intrinsics(cfg.img_w, cfg.img_h, cfg.hfov), device=self.device
        )
        self.train_dataset: Optional[RayDataset] = None
        self.test_dataset: Optional[RayDataset] = None
        self.errors_hist: List[List[float]] = []
        # [planning_step, LPIPS(VGG), mIoU] per evaluation
        self.metrics_ext_hist: List[List[float]] = []
        self.learning_rate_lst: List[float] = []
        self.trajector_uncertainty_list: List[List[List[float]]] = [
            [] for _ in range(cfg.planning_step)
        ]
        # overlapped planning loop (see planning()); False restores strict
        # alternation
        self.overlap_planning = True
        self.viz_scale = eval_scale
        self.sim_step = 0
        # per-phase wall time and samples/s, written to throughput.json
        self.throughput_log: List[dict] = []
        # per train phase, its per-step ensemble-mean losses; and how often
        # the final refit's divergence guard rolled back, and the train
        # steps it threw away doing so (they ran, and are in no loss curve)
        self.loss_hist: List[List[float]] = []
        self.refit_rollbacks = 0
        self.refit_discarded_steps = 0
        self._render_unc = self._build_ensemble_renderer(max_samples_unc, with_variance=True)
        self._render_eval = self._build_ensemble_renderer(
            cfg.max_samples_test, with_variance=False
        )

    # the ensemble's parts, as the planning-step code and the tests name them
    @property
    def members(self):
        return self.state.members

    @members.setter
    def members(self, value):
        self.state = self.state._replace(members=list(value))

    @property
    def occ(self):
        return self.state.occ

    @occ.setter
    def occ(self, value):
        self.state = self.state._replace(occ=list(value))

    @property
    def step(self) -> int:
        return self.state.step

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    def _build_ensemble_renderer(self, max_samples: int, with_variance: bool) -> Callable:
        """→ ``render(members, occ, origins [V,P,3], viewdirs, bkgd)`` →
        dict of [E, V, P, ...] tensors (``ensemble_renderer``); in mesh
        mode sharded (``parallel/sharding.shard_renderer``): every rank
        gets every member's render."""
        if self.use_prop:
            render = ensemble_renderer(self.cfg, max_samples, with_variance, self.device,
                                       field_cfgs=(self.spectral_cfg, self.prop_cfg))
        else:
            render = ngp_renderer(self.cfg, self.lattice, max_samples, with_variance)
        if self.mesh is None:
            return render
        from ..parallel.sharding import shard_renderer

        return shard_renderer(render, self.mesh)

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

    def _update_cost_map_from_depth(self, c2w_mat: np.ndarray, depth_img: np.ndarray):
        """One depth scan into the shared cost map."""
        d_points = depth_img[int(depth_img.shape[0] / 2)]
        yaw = _euler_yzx_yaw(c2w_mat[:3, :3])
        d_angles = (self.align_angles + yaw) % (2 * np.pi)
        w_loc = c2w_mat[:3, 3]
        aabb = np.asarray(self.cfg.aabb)
        grid_loc = np.array((w_loc - aabb[:3]) // self.cfg.main_grid_size, dtype=int)
        self.cost_map, visiting = update_cost_map(
            self.cost_map, d_points, d_angles, grid_loc, w_loc, aabb,
            self.cfg.main_grid_size,
        )
        self.visiting_map += visiting

    # ------------------------------------------------------------------
    # phase 1: initialization
    # ------------------------------------------------------------------

    def _snap(self, poses):
        """Replay-aware pose hook: a simulator that serves recorded frames
        exposes ``snap_poses``, the true camera of the frame each request
        will receive; rendering simulators pass through unchanged."""
        snap = getattr(self.sim, "snap_poses", None)
        if snap is None:
            return [np.asarray(p, dtype=np.float64) for p in poses]
        return list(snap(poses))

    def initialization(self, initial_samples: int = 39):
        cfg = self.cfg
        poses_quat = []
        g = self.global_origin
        for i in range(initial_samples):
            ang = (9.0 * i) % 360.0
            pos = g[:3] + self.rng.uniform(-0.2, 0.2, 3)
            poses_quat.append(np.concatenate([pos, _yaw_quat_deg(ang)]))
        poses_quat = self._snap(poses_quat)
        poses_mat = [pose_matrix_from_quat(p[:3], p[3:]) for p in poses_quat]

        images, depths, sems = self.sim.sample_images_from_poses(poses_quat)
        for mat, d in zip(poses_mat, depths):
            self._update_cost_map_from_depth(mat, d)

        self.train_dataset = RayDataset(
            training=True,
            save_fp=os.path.join(self.save_path, "train") if self.is_root else None,
            num_rays=cfg.init_batch_size,
            num_models=cfg.n_ensembles,
            width=cfg.img_w, height=cfg.img_h, hfov=cfg.hfov,
            max_images=cfg.max_images, device=self.device,
        )
        self.train_dataset.update_data(images[..., :3], depths, sems, np.array(poses_mat))

        if cfg.mark_invisible:
            # cells outside every initial-scan frustum stay unoccupied; every
            # member gets member 0's marking, as the JAX mapper broadcasts it
            marked = mark_invisible_cells(
                self.state.occ[0], self.K, torch.as_tensor(np.array(poses_mat)),
                cfg.img_w, cfg.img_h, cfg.near_plane,
            )
            self.occ = [o._replace(occs=marked.occs.clone()) for o in self.state.occ]

        test_poses = [
            np.array(list(loc) + list(quat)) for loc in cfg.test_loc for quat in cfg.test_quat
        ]
        if test_poses:
            test_poses = self._snap(test_poses)
            t_imgs, t_deps, t_sems = self.sim.sample_images_from_poses(test_poses)
            t_mats = [pose_matrix_from_quat(p[:3], p[3:]) for p in test_poses]
            self.test_dataset = RayDataset(
                training=False,
                save_fp=os.path.join(self.save_path, "test") if self.is_root else None,
                num_models=cfg.n_ensembles,
                width=cfg.img_w, height=cfg.img_h, hfov=cfg.hfov,
                max_images=max(len(test_poses), 1), device=self.device,
            )
            self.test_dataset.update_data(t_imgs[..., :3], t_deps, t_sems, np.array(t_mats))
            self._test_poses = np.array(test_poses)

    # ------------------------------------------------------------------
    # phase 2: training
    # ------------------------------------------------------------------

    def _refit_schedule(self, base_lr: float, steps: int):
        """Fresh optimizer bookkeeping and train phase under the final
        refit's MultiStepLR, from ``self.state``'s members."""
        sched = multistep_lr(base_lr, [int(steps * 0.3), int(steps * 0.8)])
        self.state = reset_opt_state(self.state, self.cfg, sched)
        self.train_phase_fn = self._make_phase(self.cfg, schedule=sched)
        self._schedule = sched

    def nerf_training(
        self,
        steps: int,
        final_train: bool = False,
        initial_train: bool = False,
        planning_step: int = -1,
        evaluate: bool = True,
        pre_sync_hook=None,
        deferred: bool = False,
    ):
        """``pre_sync_hook``: host-side callable run after all train chunks
        are queued and before the losses are read back, so its work (viz
        encoding, simulator renders) can overlap device training.

        ``deferred``: queue-only mode for the overlapped planning loop:
        every chunk and its occupancy update is queued and a
        ``finalize()`` closure is returned instead of the loss list. Then
        evaluation and checkpoints are the caller's, and nothing in the
        call reads a value back from the device."""
        cfg = self.cfg
        if final_train:
            self._refit_schedule(self._lr, steps)

        occ_thre = cfg.occ_thre_for_phase(planning_step)
        ds = self.train_dataset
        recent_bias = not final_train and not initial_train and planning_step > 0
        pools, counts = pools_from_dataset(ds)

        losses = []
        done = 0
        t_phase = time.perf_counter()
        step0 = int(self.state.step)
        # Divergence guard for the final refit: the LR-restarted 5x refit
        # can collapse a healthy field. It reads one scalar per chunk, so it
        # runs in the final refit's serial mode only.
        guard_on = final_train and not deferred
        guard_best = None  # lowest chunk-mean loss seen this refit
        guard_state = None  # state snapshot at guard_best
        guard_cuts = 0
        while done < steps:
            chunk = min(self.steps_per_call, steps - done)
            self.state, chunk_losses = self.train_phase_fn(
                self.state, ds.images, ds.depths, ds.semantics, ds.camtoworlds, ds.K,
                pools, counts, ds.size, chunk, recent_bias, self.generator,
                # the ngp core updates its grids inside the steps; the
                # flagship's grids are updated after the chunk, below
                **({} if self.use_prop else {"occ_thre": occ_thre}),
            )
            if guard_on:
                m = self._agree(float(chunk_losses.mean()))
                exploded = (not np.isfinite(m)) or (
                    guard_best is not None and m > 5.0 * guard_best + 1e-3
                )
                if exploded and guard_state is not None:
                    self.refit_discarded_steps += chunk
                    if guard_cuts >= 2:
                        print(
                            f"[divergence-guard] final refit diverged again "
                            f"(chunk loss {m:.3g} vs best {guard_best:.3g}) "
                            f"after {guard_cuts} LR cuts — stopping the "
                            f"refit at the best state (step {done}/{steps})",
                            flush=True,
                        )
                        self.state = guard_state
                        break
                    guard_cuts += 1
                    self.refit_rollbacks += 1
                    base_lr = self._lr * 0.25**guard_cuts
                    print(
                        f"[divergence-guard] final refit loss exploded "
                        f"({m:.3g} vs best {guard_best:.3g}) at step "
                        f"{done}/{steps} — rolling back to the best state "
                        f"and restarting the refit schedule at lr "
                        f"{base_lr:.2e} (cut #{guard_cuts})",
                        flush=True,
                    )
                    # the snapshot stays untouched: training resumes on a copy
                    self.state = _snapshot(guard_state)
                    self._refit_schedule(base_lr, steps)
                    continue  # redo this chunk's steps at the cut LR
                if np.isfinite(m) and (guard_best is None or m < guard_best):
                    guard_best = m
                    guard_state = _snapshot(self.state)
            losses.append(chunk_losses.mean(dim=-1))  # [chunk]
            done += chunk
            if self._occ_update_fn is not None:
                self.state = self.state._replace(occ=self._occ_update_fn(
                    self.state.members, self.state.occ, self.state.step, occ_thre,
                    generator=self.generator, local=self._local,
                ))
            # lr curve bookkeeping
            self.learning_rate_lst.append(float(self._schedule(step0 + done)))
            if not deferred and done % self.checkpoint_every < chunk:
                self.save_checkpoints()

        def entry(dt):
            samples = steps * cfg.n_ensembles * cfg.num_rays * cfg.max_samples_train
            return {
                "planning_step": planning_step,
                "steps": steps,
                "seconds": dt,
                "samples_per_sec": samples / max(dt, 1e-9),
                "rays_per_sec": steps * cfg.n_ensembles * cfg.num_rays / max(dt, 1e-9),
            }

        def read_losses():
            vals = [float(v) for v in torch.cat(losses).cpu().numpy()] if losses else []
            self.loss_hist.append(vals)
            return vals

        if deferred:
            def finalize():
                vals = read_losses()
                # queue-to-finalize wall time: host planning ran inside this
                # window, so samples_per_sec is a lower bound here
                self.throughput_log.append(
                    {**entry(time.perf_counter() - t_phase), "overlapped": True}
                )
                return vals

            return finalize

        hook_s = 0.0
        if pre_sync_hook is not None:
            t_hook = time.perf_counter()
            pre_sync_hook()
            hook_s = time.perf_counter() - t_hook
        vals = read_losses()
        log = entry(time.perf_counter() - t_phase)
        if pre_sync_hook is not None:
            # wall time the hook's host work shared with device training
            log["overlapped_host_seconds"] = hook_s
        self.throughput_log.append(log)
        if evaluate and self.test_dataset is not None and (
            final_train or planning_step == 0 or (planning_step + 1) % 2 == 0
            or planning_step == -1
        ):
            self._evaluate(planning_step)
        return vals

    def _current_lr(self) -> float:
        return float(self._schedule(int(self.state.step)))

    def _evaluate(self, planning_step: int, state: Optional[EnsembleState] = None):
        return self._evaluate_start(planning_step, state)()

    def _eval_size(self, scale: float):
        cfg = self.cfg
        return max(int(cfg.img_h * scale), 1), max(int(cfg.img_w * scale), 1)

    def _evaluate_start(self, planning_step: int, state: Optional[EnsembleState] = None):
        """PSNR, depth MSE and semantic CE over the test set with member 0,
        rendered as ``eval_scale`` images so LPIPS(VGG) and mIoU are
        computed too. Queues the test-set render (white background) and
        returns a closure that reads it back and records the metrics."""
        state = state if state is not None else self.state
        oh, ow = self._eval_size(self.eval_scale)
        rays = self._pose7_to_grid_rays(self._test_poses, oh, ow)
        out = self._render_eval(
            state.members, state.occ, rays.origins, rays.viewdirs,
            torch.ones(3, device=self.device),
        )

        def finish():
            return self._evaluate_finish(out, planning_step, oh, ow)

        return finish

    def _strided_gt(self, arr, oh: int, ow: int):
        """[n, H, W, ...] → [n, oh, ow, ...] by the strided downsample of
        the prediction's pixel grid."""
        cfg = self.cfg
        ys = (np.arange(oh) * cfg.img_h) // oh
        xs = (np.arange(ow) * cfg.img_w) // ow
        return arr[:, ys][:, :, xs]

    def _evaluate_finish(self, out, planning_step: int, oh: int, ow: int):
        ds = self.test_dataset
        cfg = self.cfg
        n_img = len(self._test_poses)
        gt_rgb = self._strided_gt(ds.images[:n_img].cpu().numpy(), oh, ow) / 255.0
        gt_dep = self._strided_gt(ds.depths[:n_img].cpu().numpy(), oh, ow)
        gt_sem = self._strided_gt(ds.semantics[:n_img].cpu().numpy(), oh, ow)
        # member 0 predictions (the reference evaluates model_idx == 0)
        pd_rgb = out["rgb"][0].float().cpu().numpy().reshape(n_img, oh, ow, 3)
        pd_dep = out["depth"][0].float().cpu().numpy().reshape(n_img, oh, ow)
        pd_sem_logits = out["sem"][0].float().cpu().numpy().reshape(n_img, oh, ow, -1)
        row = [
            float(planning_step),
            float(psnr(pd_rgb, gt_rgb)),
            float(depth_mse(pd_dep, gt_dep)),
            float(semantic_ce(pd_sem_logits, gt_sem)),
        ]
        self.errors_hist.append(row)
        lp = float(np.mean([lpips_vgg(pd_rgb[i], gt_rgb[i]) for i in range(n_img)]))
        mi = miou(np.argmax(pd_sem_logits, axis=-1), gt_sem, cfg.num_semantic_classes)
        self.metrics_ext_hist.append([float(planning_step), lp, float(mi)])
        if self.save_viz and self.is_root:
            self._write_predictions(planning_step, pd_rgb, pd_dep, pd_sem_logits)
        return row

    def _write_predictions(self, planning_step, pd_rgb, pd_dep, pd_sem_logits):
        """Test-view prediction dumps under ``prediction/``."""
        import imageio.v2 as imageio

        from ..viz.render_views import colorize_depth, colorize_semantics

        pred_dir = os.path.join(self.save_path, "prediction")
        os.makedirs(pred_dir, exist_ok=True)
        tag = f"p{planning_step}"
        for i in range(len(pd_rgb)):
            imageio.imwrite(
                os.path.join(pred_dir, f"{tag}_{i}_rgb.png"),
                (np.clip(pd_rgb[i], 0, 1) * 255).astype(np.uint8),
            )
            imageio.imwrite(os.path.join(pred_dir, f"{tag}_{i}_dep.png"),
                            colorize_depth(pd_dep[i]))
            imageio.imwrite(
                os.path.join(pred_dir, f"{tag}_{i}_sem.png"),
                colorize_semantics(
                    np.argmax(pd_sem_logits[i], axis=-1), self.cfg.num_semantic_classes
                ),
            )

    # ------------------------------------------------------------------
    # phase 3: uncertainty scoring
    # ------------------------------------------------------------------

    def dispatch_uncertainty(self, trajectory: np.ndarray) -> PredictiveInformation:
        """Queue one candidate's render (black background) and score;
        returns the PI terms as 0-dim device tensors, not yet read back."""
        rays = self._pose7_to_rays(trajectory[_unc_view_index(len(trajectory))], self.unc_scale)
        out = self._render_unc(
            self.state.members, self.state.occ, rays.origins, rays.viewdirs,
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
    # per-step visualization
    # ------------------------------------------------------------------

    def render(self, traj: np.ndarray, state: Optional[EnsembleState] = None):
        self.render_start(traj, state)()

    def render_start(self, traj: np.ndarray, state: Optional[EnsembleState] = None):
        """Member 0's first-person predictions along ``traj`` at
        ``viz_scale`` (white background): the render is queued at once
        and the returned closure reads it back → dict of ``pd_rgb``
        [n, oh, ow, 3], ``pd_dep``, ``pd_sem`` (labels) and ``pd_occ``.
        With ``save_viz`` the closure also writes the reference's
        per-planning-step artifacts: chase-camera frames ``viz/<n>.png``,
        top-down ``viz/top/<n>.png`` and the ground-truth and predicted
        panels under ``viz/fpv/``."""
        state = state if state is not None else self.state
        oh, ow = self._eval_size(self.viz_scale)
        traj = np.asarray(traj)
        rays = self._pose7_to_grid_rays(traj, oh, ow)
        out = self._render_eval(
            state.members, state.occ, rays.origins, rays.viewdirs,
            torch.ones(3, device=self.device),
        )

        def finish():
            return self._render_finish(traj, out, oh, ow)

        return finish

    def _render_finish(self, traj: np.ndarray, out, oh: int, ow: int):
        n = len(traj)
        panels = {
            "pd_rgb": out["rgb"][0].float().cpu().numpy().reshape(n, oh, ow, 3),
            "pd_dep": out["depth"][0].float().cpu().numpy().reshape(n, oh, ow),
            "pd_sem": np.argmax(
                out["sem"][0].float().cpu().numpy().reshape(n, oh, ow, -1), axis=-1
            ),
            "pd_occ": out["opacity"][0].float().cpu().numpy().reshape(n, oh, ow),
        }
        if self.save_viz and self.is_root:
            self._write_viz(traj, panels, oh, ow)
        return panels

    def _write_viz(self, traj: np.ndarray, panels: dict, oh: int, ow: int):
        import imageio.v2 as imageio

        from ..viz.render_views import colorize_semantics

        viz = os.path.join(self.save_path, "viz")
        fpv = os.path.join(viz, "fpv")
        os.makedirs(os.path.join(viz, "top"), exist_ok=True)
        subs = ("gt_rgb", "gt_dep", "gt_sem", "pd_rgb", "pd_dep", "pd_sem", "pd_occ")
        for sub in subs:
            os.makedirs(os.path.join(fpv, sub), exist_ok=True)

        step = self.sim_step
        for img in np.asarray(self.sim.render_tpv(traj)):
            imageio.imwrite(os.path.join(viz, f"{self.sim_step}.png"), img[..., :3])
            self.sim_step += 1
        for s, img in enumerate(np.asarray(self.sim.render_top_tpv(traj))):
            imageio.imwrite(os.path.join(viz, "top", f"{step + s}.png"), img[..., :3])

        gt_rgb, gt_dep, gt_sem = self.sim.sample_images_from_poses(traj)
        g_rgb = self._strided_gt(np.asarray(gt_rgb)[..., :3], oh, ow)
        g_dep = self._strided_gt(np.asarray(gt_dep), oh, ow)
        g_sem = self._strided_gt(np.asarray(gt_sem), oh, ow)
        C = self.cfg.num_semantic_classes
        for st in range(len(traj)):
            images = {
                "gt_rgb": g_rgb[st].astype(np.uint8),
                "pd_rgb": (np.clip(panels["pd_rgb"][st], 0, 1) * 255).astype(np.uint8),
                # depth scaled by 25 like the reference writer
                "gt_dep": np.clip(g_dep[st] * 25, 0, 255).astype(np.uint8),
                "pd_dep": np.clip(panels["pd_dep"][st] * 25, 0, 255).astype(np.uint8),
                "gt_sem": colorize_semantics(g_sem[st], C),
                "pd_sem": colorize_semantics(panels["pd_sem"][st], C),
                "pd_occ": np.clip(panels["pd_occ"][st] * 255, 0, 255).astype(np.uint8),
            }
            for sub in subs:
                imageio.imwrite(os.path.join(fpv, sub, f"{step + st}.png"), images[sub])

    # ------------------------------------------------------------------
    # phase 4: the planning loop
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
        comps = self._agree(
            torch.stack([torch.stack(list(p)) for p in pis]).double().cpu().numpy())
        self.trajector_uncertainty_list[step - 1].extend(comps.tolist())
        best = int(np.argmax(comps.sum(axis=1)))
        chosen = candidates[best]
        return chosen, chosen[_unc_view_index(len(chosen))]

    def binaries_host(self, state: Optional[EnsembleState] = None) -> np.ndarray:
        """The members' binary occupancy grids [E, X, Y, Z] on the host
        (in mesh mode every member's, gathered)."""
        state = state if state is not None else self.state
        grids = torch.stack([o.binaries for o in state.occ])
        if self.mesh is not None:
            grids = self.mesh.gather_ens(grids)
        return grids.cpu().numpy()

    def _agree(self, value):
        """Rank 0's ``value`` on every rank in mesh mode (a host decision)."""
        return value if self.mesh is None else self.mesh.agree(value)

    def _observe_and_update(self, fly_poses):
        """Fly the chosen trajectory: render observations in the simulator,
        fuse depth scans into the cost map (last 6 views), append to the
        train dataset."""
        fly_poses = self._snap(fly_poses)
        images, depths, sems = self.sim.sample_images_from_poses(fly_poses)
        mats = [pose_matrix_from_quat(p[:3], p[3:]) for p in fly_poses]
        for mat, d in zip(mats[-6:], depths[-6:]):
            self._update_cost_map_from_depth(mat, d)
        self.train_dataset.update_data(images[..., :3], depths, sems, np.array(mats))

    def _should_stop(self, step) -> bool:
        """Stop when the max-mean uncertainty stayed above 0.05 for 5
        consecutive steps."""
        past = [
            np.mean(np.asarray(u), axis=0)
            for u in self.trajector_uncertainty_list[:step]
            if len(u) > 0
        ]
        if len(past) >= 5:
            unc = np.max(np.asarray(past), axis=1)
            if np.all(unc[-5:] > 0.05):
                return True
        return False

    def _eval_due(self, planning_step: int) -> bool:
        return self.test_dataset is not None and (
            planning_step == 0 or (planning_step + 1) % 2 == 0
        )

    def planning(self, steps: int, training_steps_per_step: int):
        """The active loop. Default (``overlap_planning=True``): each
        step's train phase is queued without a read-back and the next
        step's host planning (``sample_traj``) runs before anything waits
        for the device; candidate renders queue behind the chunks, so the
        one device sync per step is the PI read-back. Evaluation and
        visualisation renders are queued with the settled phase state
        before the next phase's chunks. Against strict alternation:
        (a) ``sample_traj`` reads the binaries from before the phase in
        flight (one train phase stale), (b) a checkpoint is written once
        per phase that crosses a ``checkpoint_every`` boundary.
        ``overlap_planning=False`` restores strict alternation."""
        if not self.overlap_planning:
            return self._planning_serial(steps, training_steps_per_step)
        cfg = self.cfg
        current_state = self.global_origin[:3].copy()
        step = 0
        flag = True
        # settled post-initial-train snapshot
        binaries_host = self.binaries_host()
        pending = None  # finalize() of the train phase in flight
        pending_step = 0
        deferred_host = []  # host work of renders queued before the phase
        steps_done = int(self.state.step)
        last_ckpt = steps_done
        while flag and step < cfg.planning_step:
            step += 1
            # ---- host planning, before anything waits for the phase in flight ----
            candidates = self._sample_candidates(binaries_host, current_state)
            chosen, fly_poses = self._score_candidates(candidates, step)
            # ^ the PI read-back inside is the step's one device sync
            if pending is not None:
                pending()
                pending = None
            state_k = self.state  # settled post-phase ensemble state
            prev_step = pending_step
            for fn in deferred_host:
                fn()
            deferred_host = []
            # ---- observe (host; the next phase needs this data) ----
            self._observe_and_update(fly_poses)
            current_state = fly_poses[-1, :3]
            self.current_pose = chosen[-1]
            binaries_host = self.binaries_host(state_k)
            # ---- queue the quick renders before the next phase's chunks ----
            if prev_step > 0 and self._eval_due(prev_step):
                deferred_host.append(self._evaluate_start(prev_step, state=state_k))
            if self.save_viz:
                deferred_host.append(self.render_start(fly_poses, state=state_k))
            if steps_done - last_ckpt >= self.checkpoint_every:
                # members update in place: write the settled state now
                self.save_checkpoints(state=state_k)
                last_ckpt = steps_done
            # ---- queue this step's train phase ----
            pending = self.nerf_training(
                training_steps_per_step, planning_step=step, deferred=True,
            )
            pending_step = step
            steps_done += training_steps_per_step
            flag = not self._should_stop(step)
        if pending is not None:
            pending()
            for fn in deferred_host:
                fn()
            deferred_host = []
            if self._eval_due(pending_step):
                self._evaluate(pending_step)
            self.save_checkpoints()
        return step

    def _planning_serial(self, steps: int, training_steps_per_step: int):
        """Strict plan → score → fly → train alternation (the reference's
        structure), with the viz dump run through ``pre_sync_hook``."""
        cfg = self.cfg
        current_state = self.global_origin[:3].copy()
        step = 0
        flag = True
        while flag and step < cfg.planning_step:
            step += 1
            candidates = self._sample_candidates(self.binaries_host(), current_state)
            chosen, fly_poses = self._score_candidates(candidates, step)
            self._observe_and_update(fly_poses)
            current_state = fly_poses[-1, :3]
            self.current_pose = chosen[-1]
            viz_hook = (lambda: self.render(fly_poses)) if self.save_viz else None
            self.nerf_training(
                training_steps_per_step, planning_step=step, pre_sync_hook=viz_hook,
            )
            flag = not self._should_stop(step)
        return step

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------

    def save_checkpoints(self, state: Optional[EnsembleState] = None):
        """Per-member ``checkpoints/model_{i}.npz`` with the JAX mapper's
        contract: occupancy grid, parameters, optimizer state and step
        (``interop.save_member_npz``). In mesh mode every rank takes part
        in gathering the members and rank 0 writes them all."""
        state = state if state is not None else self.state
        if self.mesh is not None:
            from ..parallel.mesh import gather_ensemble_state

            state = gather_ensemble_state(state, self.mesh)
            if not self.is_root:
                return
        ckpt_dir = os.path.join(self.save_path, "checkpoints")
        os.makedirs(ckpt_dir, exist_ok=True)
        for i, (member, occ, opt) in enumerate(zip(state.members, state.occ, state.opt)):
            save_member_npz(
                os.path.join(ckpt_dir, f"model_{i}.npz"), member, occ.occs, occ.binaries,
                opt, state.step,
            )

    def load_checkpoints(self, ckpt_dir: str):
        """Restore params, occupancy grids, optimizer state and step from
        ``model_{i}.npz`` files written by either package. A file without
        optimizer leaves keeps the current optimizer state."""
        aabb = torch.as_tensor(self.cfg.aabb, dtype=torch.float32, device=self.device)
        members, occ, opts = [], [], []
        step = self.state.step
        for i in range(self.cfg.n_ensembles):
            path = os.path.join(ckpt_dir, f"model_{i}.npz")
            member, occs, binaries = load_member_npz(path, self.device)
            opt, step = load_member_opt(path, member, self.device)
            members.append(member)
            occ.append(OccGridState(occs=occs, binaries=binaries, aabb=aabb))
            if opt is None:  # this rank's own state of its members
                local = self._local or range(self.cfg.n_ensembles)
                opt = self.state.opt[i - local.start] if i in local else None
            opts.append(opt)
        self.state = EnsembleState(members=members, opt=opts, occ=occ, step=step)
        if self.mesh is not None:
            from ..parallel.mesh import shard_ensemble_state

            self.state = shard_ensemble_state(self.state, self.mesh)

    def save_artifacts(self):
        """The datasets, histories and checkpoints (rank 0's files in mesh
        mode; every rank takes part in the checkpoints' gather)."""
        if not self.is_root:
            self.save_checkpoints()
            return
        self.train_dataset.save()
        if self.test_dataset is not None:
            self.test_dataset.save()
        np.save(
            os.path.join(self.save_path, "uncertainty.npy"),
            np.asarray(
                [np.asarray(u, dtype=object) for u in self.trajector_uncertainty_list],
                dtype=object,
            ),
            allow_pickle=True,
        )
        np.save(os.path.join(self.save_path, "errors.npy"), np.asarray(self.errors_hist))
        np.save(
            os.path.join(self.save_path, "metrics_ext.npy"), np.asarray(self.metrics_ext_hist)
        )
        with open(os.path.join(self.save_path, "throughput.json"), "w") as f:
            json.dump(self.throughput_log, f, indent=1)
        self.save_checkpoints()

    # ------------------------------------------------------------------

    def pipeline(self):
        """The full active-perception run."""
        cfg = self.cfg
        self.initialization()
        self.nerf_training(cfg.training_steps, initial_train=True, planning_step=-1)
        self.planning(cfg.planning_step, cfg.training_steps)
        self.nerf_training(cfg.training_steps * 5, final_train=True, planning_step=-10)
        self.save_artifacts()
