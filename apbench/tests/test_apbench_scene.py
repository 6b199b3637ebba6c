"""The benchmark's scene against FakeSim's ``default_room``, pixel for pixel."""

import numpy as np
import pytest

from apbench import generator
from apbench.scene.room import Room


@pytest.mark.parametrize("size", [(48, 48), (40, 56)])
def test_apbench_room_renders_as_fakesim(size):
    from apnerf_tpu_torch.sim.fake import FakeSim

    w, h = size
    aabb = (-8.0, 0.0, -8.0, 0.0, 3.0, 0.0)
    poses = generator.scan_poses((-4.0, 1.5, -4.0), 6, 5)
    poses.append(np.array([-1.0, 2.5, -7.0, 0.3, 0.2, 0.1, 0.9]))
    ours = Room(aabb, w, h, np.pi / 2, "cpu").sample_images_from_poses(poses)
    sim = FakeSim(aabb, img_w=w, img_h=h, hfov=np.pi / 2).sample_images_from_poses(poses)
    for a, b in zip(ours, sim):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
