"""Configuration system.

The port's own copy of ``apnerf_tpu/config.py`` (numpy and PyYAML only):
the reference's per-scene YAML schema
(``scripts/config_102344250.yaml:1-101``) plus the static ray/sample
budgets. Every field of the JAX package's ``PipelineConfig`` is kept, with
its default, so that every ``configs/*.yaml`` loads to equal values in
both packages; ``fused_field``, ``mesh_ens`` and ``mesh_data`` are read
by nothing in the port.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import yaml


@dataclasses.dataclass
class PipelineConfig:
    # scene / paths (config_102344250.yaml:1-14)
    save_path: str = "data/habitat_collection"
    aabb: Tuple[float, ...] = (-19.1, -0.2, -19.1, 0.5, 3.2, 0.5)
    near_plane: float = 0.1
    far_plane: float = 1e10

    # grids (yaml:15-22)
    main_grid_nlvl: int = 1
    main_grid_size: float = 0.2
    main_neurons: int = 128
    main_layer: int = 2
    minor_grid_nlvl: int = 1
    minor_grid_size: float = 0.2
    minor_neurons: int = 64
    minor_layer: int = 2

    # active loop (yaml:23-26)
    planning_step: int = 25
    num_traj: int = 20
    sample_disc: int = 30
    training_steps: int = 2000

    # rendering (yaml:27-29)
    render_step_size: float = 1e-3
    alpha_thre: float = 0.01
    cone_angle: float = 0.004

    # ensemble / camera (yaml:30-33)
    n_ensembles: int = 2
    img_w: int = 640
    img_h: int = 640
    hfov: float = float(np.pi / 2)

    # batching: the reference targets 262144 samples/step via dynamic ray
    # counts capped at 2000 (pipeline.py:494-504, yaml:4). Here:
    # a static rays x samples budget with the same product.
    init_batch_size: int = 1024
    target_sample_batch_size: int = 262144
    num_rays: int = 2048
    max_samples_train: int = 128
    max_samples_test: int = 512
    n_candidates: int = 2048

    # optimizer (pipeline.py:173-198)
    lr: float = 1e-3
    lr_base: float = 1e-4
    weight_decay: float = 0.0
    adam_eps: float = 1e-15

    # field size (ngp.py:69-141 defaults; overridable for tests/small scenes)
    n_levels: int = 16
    n_features: int = 4
    log2_hashmap_size: int = 19
    base_resolution: int = 16
    max_resolution: int = 4096
    geo_feat_dim: int = 15

    # occupancy update (pipeline.py:447-470, occ_grid.py:241-278)
    occ_every_n: int = 16
    occ_ema_decay: float = 0.95
    occ_warmup_steps: int = 256
    # camera-coverage init (occ_grid.py:279-343): mark cells no initial-scan
    # camera sees as invisible (occ = -1, never occupied). The reference
    # ships this in nerfacc but its pipeline never calls it; default off
    # for behavior parity.
    mark_invisible: bool = False

    # flagship path: spectral (Fourier-feature) field + proposal-net
    # sampling, all matrix products, no per-sample random memory access
    # (models/spectral.py, render/prop_renderer.py). "ngp"/"occ" are the
    # exact-parity alternatives (models/ngp.py, render/renderer.py).
    field_type: str = "spectral"  # "spectral" | "ngp"
    sampler_type: str = "prop"  # "prop" | "occ"
    num_prop_samples: int = 64
    prop_neurons: int = 64
    prop_layers: int = 2
    spectral_neurons: int = 256
    spectral_layers: int = 3
    spectral_freqs_per_level: int = 8
    prop_loss_weight: float = 1.0
    # spectral fields train best above the hash-grid's reference lr of
    # 1e-3: FakeSim 640^2 sweep at the pipeline's 2000-step budget
    # (scripts/quality_sweep.py): PSNR 22.4 / depthMSE 0.40 / semAcc 0.971
    # at 6e-3 vs PSNR 20.0 / 0.91 / 0.964 at 3e-3
    spectral_lr: float = 6e-3
    # cyclic-LR peak decay per cycle (exp_range's gamma, applied per
    # cycle instead of per step): 1.0 = pure triangular (reference
    # semantics); <1 shrinks the late-training high-LR excursions that
    # the PSNR-vs-budget probe implicates in extrapolated-view RGB
    # degradation (scripts/psnr_probe.py)
    spectral_lr_gamma: float = 1.0
    # optional decoupled weight decay on the learnable spectrum (W,
    # phase) only — damps high-frequency speckle in unobserved regions
    # without touching the MLP heads (scripts/psnr_probe.py)
    spectral_spectrum_wd: float = 0.0
    # a routing knob of the JAX package; kept for equal fields, unread here
    fused_field: str = "auto"

    # poses (yaml:34-101)
    global_origin: Tuple[float, ...] = (
        -14.79389263, 1.5, -10.6045085, 0.0, 0.0, 0.0, 1.0
    )
    test_loc: Tuple[Tuple[float, float, float], ...] = ()
    test_quat: Tuple[Tuple[float, float, float, float], ...] = (
        (0, 0, 0, 1),
        (0, 0.707, 0, 0.707),
        (0, 1, 0, 0),
        (0, 0.707, 0, -0.707),
    )

    # semantics (CLI --sem-num, pipeline.py:68-73)
    num_semantic_classes: int = 29

    # data store capacity (static shapes; reference grows tensors
    # unboundedly, habitat_to_data.py:89-153)
    max_images: int = 512

    # multi-chip (unread here)
    mesh_ens: int = 2
    mesh_data: int = 1

    @property
    def focal(self) -> float:
        return 0.5 * self.img_w / np.tan(self.hfov / 2)

    @property
    def main_grid_resolution(self) -> Tuple[int, int, int]:
        """((aabb_max - aabb_min) / grid_size).astype(int)
        (``pipeline.py:113-121``)."""
        a = np.asarray(self.aabb)
        return tuple(((a[3:] - a[:3]) / self.main_grid_size).astype(int).tolist())

    @property
    def minor_grid_resolution(self) -> Tuple[int, int, int]:
        a = np.asarray(self.aabb)
        return tuple(((a[3:] - a[:3]) / self.minor_grid_size).astype(int).tolist())

    def occ_thre_for_phase(self, planning_step: int) -> float:
        """The reference's occ-threshold schedule (``pipeline.py:447-470``):
        initial train (-1) → 1e-3, final train (-10) → 1e-2, planning
        steps < 5 → 1e-3, later → 3e-3."""
        if planning_step == -1:
            return 1e-3
        if planning_step == -10:
            return 1e-2
        if planning_step < 5:
            return 1e-3
        return 3e-3


def load_scene_config(path: str, **overrides) -> PipelineConfig:
    """Load a reference-format scene YAML into PipelineConfig."""
    with open(path) as f:
        raw = yaml.safe_load(f)
    field_names = {f.name for f in dataclasses.fields(PipelineConfig)}
    kwargs = {}
    for k, v in raw.items():
        if k in ("cuda",):  # device strings are meaningless here
            continue
        if k in field_names:
            if isinstance(v, list):
                v = tuple(tuple(e) if isinstance(e, list) else e for e in v)
            kwargs[k] = v
    kwargs.update(overrides)
    return PipelineConfig(**kwargs)
