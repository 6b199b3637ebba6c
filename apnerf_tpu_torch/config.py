"""Pipeline configuration: the JAX package's ``PipelineConfig`` itself.

``apnerf_tpu/config.py`` imports only numpy and PyYAML (both present on
the GPU host), so the port reads the same dataclass and the same scene
YAML files instead of keeping a copy. Its TPU-only knobs (``fused_field``,
``mesh_ens``, ``mesh_data``) are ignored by the port.
"""

from apnerf_tpu.config import PipelineConfig, load_scene_config  # noqa: F401
