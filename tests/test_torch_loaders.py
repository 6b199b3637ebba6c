"""The port's dataset loaders, lens models and NGP + occupancy CLI against
the JAX package's, on files each test writes in ``tmp_path`` (PNGs with
``imageio``, ``transforms_*.json``, COLMAP ``cameras.bin``/``images.bin``).

Tolerances: loaded images, poses, times and intrinsics exactly (the same
files read by the same numpy code); rays rtol 1e-6 / atol 1e-7 (the same
float32 operations); the lens models at the JAX tests' own limits
(``tests/test_cameras.py``: roundtrips to 1e-5, fisheye 1e-4) and against
the JAX functions to 1e-6 (the same Newton steps in float32).
"""

import json
import os
import struct
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apnerf_tpu.data import colmap as j_colmap
from apnerf_tpu.data import dnerf_synthetic as j_dnerf
from apnerf_tpu.data import nerf_360 as j_360
from apnerf_tpu.data import nerf_synthetic as j_ns
from apnerf_tpu.ops import cameras as j_cam
from apnerf_tpu_torch import train_ngp_occ
from apnerf_tpu_torch.data import colmap as t_colmap
from apnerf_tpu_torch.data import dnerf_synthetic as t_dnerf
from apnerf_tpu_torch.data import nerf_360 as t_360
from apnerf_tpu_torch.data import nerf_synthetic as t_ns
from apnerf_tpu_torch.ops import cameras as t_cam

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_png(path, arr):
    import imageio.v2 as imageio

    imageio.imwrite(path, arr)


def _orbit(i, n, radius=3.0):
    """A camera on a circle looking at the origin (OpenGL: -z forward)."""
    a = 2 * np.pi * i / n
    pos = np.array([radius * np.sin(a), 0.5, radius * np.cos(a)])
    fwd = -pos / np.linalg.norm(pos)
    right = np.cross(fwd, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    c2w = np.eye(4)
    c2w[:3, :3] = np.stack([right, up, -fwd], axis=1)
    c2w[:3, 3] = pos
    return c2w


def _make_blender_subject(root, subject, split, n=3, size=8, with_time=False, seed=0):
    rng = np.random.default_rng(seed)
    d = os.path.join(root, subject, split)
    os.makedirs(d, exist_ok=True)
    frames = []
    for i in range(n):
        img = rng.integers(0, 256, (size, size, 4)).astype(np.uint8)
        _write_png(os.path.join(d, f"r_{i}.png"), img)
        frame = {"file_path": f"./{split}/r_{i}", "transform_matrix": _orbit(i, n).tolist()}
        if with_time:
            frame["time"] = i / max(n - 1, 1)
        frames.append(frame)
    with open(os.path.join(root, subject, f"transforms_{split}.json"), "w") as f:
        json.dump({"camera_angle_x": 0.8, "frames": frames}, f)


def test_nerf_synthetic_loader_and_rays(tmp_path):
    _make_blender_subject(str(tmp_path), "lego", "train", n=4)
    got = t_ns.load_subject(str(tmp_path), "lego", "train", max_images=3)
    ref = j_ns.load_subject(str(tmp_path), "lego", "train", max_images=3)
    assert got.images.shape == (3, 8, 8, 4) and got.width == ref.width == 8
    np.testing.assert_array_equal(got.images, ref.images)
    np.testing.assert_array_equal(got.camtoworlds, ref.camtoworlds)
    assert got.focal == ref.focal == pytest.approx(0.5 * 8 / np.tan(0.4))
    assert t_ns.SUBJECTS == j_ns.SUBJECTS
    ids, x, y = np.array([0, 1, 2, 2]), np.array([3, 4, 0, 7]), np.array([2, 5, 7, 0])
    rt = t_ns.rays_for_pixels(got, ids, x, y)
    rj = j_ns.rays_for_pixels(ref, ids, x, y)
    for a, b in zip(rt, rj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


def test_dnerf_loader(tmp_path):
    _make_blender_subject(str(tmp_path), "jump", "train", n=4, with_time=True)
    got = t_dnerf.load_dnerf_subject(str(tmp_path), "jump", "train")
    ref = j_dnerf.load_dnerf_subject(str(tmp_path), "jump", "train")
    np.testing.assert_array_equal(got.times, ref.times)
    assert got.times[0] == 0.0 and got.times[-1] == 1.0
    np.testing.assert_array_equal(got.images, ref.images)
    np.testing.assert_array_equal(got.camtoworlds, ref.camtoworlds)
    assert (got.focal, got.width, got.height) == (ref.focal, ref.width, ref.height)
    # frames without a time read i / (n - 1)
    _make_blender_subject(str(tmp_path), "stand", "train", n=5)
    np.testing.assert_array_equal(t_dnerf.load_dnerf_subject(str(tmp_path), "stand").times,
                                  np.linspace(0, 1, 5, dtype=np.float32))


def _write_colmap_model(sparse_dir, n_images=4):
    os.makedirs(sparse_dir, exist_ok=True)
    rng = np.random.default_rng(3)
    with open(os.path.join(sparse_dir, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 1, 16, 12))  # PINHOLE 16x12
        f.write(struct.pack("<4d", 10.0, 11.0, 8.0, 6.0))
    with open(os.path.join(sparse_dir, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", n_images))
        for i in reversed(range(n_images)):  # written out of name order
            q = rng.normal(size=4)
            f.write(struct.pack("<i", i + 1))
            f.write(struct.pack("<4d", *(q / np.linalg.norm(q))))
            f.write(struct.pack("<3d", float(i), 0.5, -1.0))
            f.write(struct.pack("<i", 1))
            f.write(f"img_{i:03d}.png".encode() + b"\x00")
            f.write(struct.pack("<Q", 2))  # two 2D points, skipped
            f.write(struct.pack("<ddq", 1.0, 2.0, -1) * 2)


def test_colmap_reader(tmp_path):
    sparse = str(tmp_path / "sparse" / "0")
    _write_colmap_model(sparse)
    cams_t = t_colmap.read_cameras_bin(os.path.join(sparse, "cameras.bin"))
    cams_j = j_colmap.read_cameras_bin(os.path.join(sparse, "cameras.bin"))
    assert cams_t[1].model == cams_j[1].model == "PINHOLE"
    np.testing.assert_array_equal(cams_t[1].params, cams_j[1].params)
    imgs_t = t_colmap.read_images_bin(os.path.join(sparse, "images.bin"))
    imgs_j = j_colmap.read_images_bin(os.path.join(sparse, "images.bin"))
    assert sorted(imgs_t) == sorted(imgs_j) and imgs_t[2].name == "img_001.png"
    for k in imgs_t:
        np.testing.assert_array_equal(imgs_t[k].qvec, imgs_j[k].qvec)
        np.testing.assert_array_equal(imgs_t[k].tvec, imgs_j[k].tvec)
        R = t_colmap.qvec_to_rotmat(imgs_t[k].qvec)
        np.testing.assert_array_equal(R, j_colmap.qvec_to_rotmat(imgs_j[k].qvec))
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-12)
    got, ref = t_colmap.load_colmap_poses(sparse), j_colmap.load_colmap_poses(sparse)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    assert got[2] == ref[2] == sorted(got[2])


def test_360_loader(tmp_path):
    sparse = str(tmp_path / "sparse" / "0")
    _write_colmap_model(sparse, n_images=6)
    rng = np.random.default_rng(4)
    for sub, (h, w) in (("images", (12, 16)), ("images_2", (6, 8))):
        os.makedirs(tmp_path / sub)
        for i in range(6):
            _write_png(str(tmp_path / sub / f"img_{i:03d}.png"),
                       rng.integers(0, 256, (h, w, 3)).astype(np.uint8))
    for factor, split in ((1, "train"), (1, "test"), (2, "train"), (4, "test")):
        got = t_360.load_360_scene(str(tmp_path), factor=factor, split=split, test_every=3)
        ref = j_360.load_360_scene(str(tmp_path), factor=factor, split=split, test_every=3)
        np.testing.assert_array_equal(got.images, ref.images)
        np.testing.assert_array_equal(got.camtoworlds, ref.camtoworlds)
        np.testing.assert_array_equal(got.K, ref.K)
        assert (got.width, got.height) == (ref.width, ref.height)
    assert np.linalg.norm(got.camtoworlds[:, :3, 3], axis=1).max() <= 1 + 1e-6
    c2w = np.stack([_orbit(i, 5, 2.0 + i) for i in range(5)]).astype(np.float32)
    np.testing.assert_array_equal(t_360.normalize_poses(c2w), j_360.normalize_poses(c2w))


# -- the lens models ---------------------------------------------------------------------


def _grid_uv(n=21, lim=0.4):
    u, v = np.meshgrid(np.linspace(-lim, lim, n), np.linspace(-lim, lim, n))
    return np.stack([u, v], axis=-1).reshape(-1, 2).astype(np.float32)


@pytest.mark.parametrize("params", [
    [0.1, -0.05, 0.01, -0.01, 0.002, 0.0, 0.0, 0.0],  # radial and tangential
    [0.1, -0.05, 0.01, -0.01, 0.002, 0.01, -0.003, 0.001],  # the rational model
    [0.08],  # k1 alone, zero-padded
    [0.08, -0.02, 0.003, 0.001],
    [],  # no distortion
])
def test_opencv_lens_models(params):
    uv = _grid_uv()
    p = np.asarray(params, np.float32)
    d_t = t_cam.opencv_lens_distortion(torch.as_tensor(uv), torch.as_tensor(p))
    d_j = j_cam.opencv_lens_distortion(jnp.asarray(uv), jnp.asarray(p))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-6, atol=1e-6)
    r_t = t_cam.opencv_lens_undistortion(d_t, torch.as_tensor(p))
    r_j = j_cam.opencv_lens_undistortion(d_j, jnp.asarray(p))
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(r_t.numpy(), uv, atol=1e-5)


def test_fisheye_lens_model():
    uv = _grid_uv(n=11, lim=0.3)
    p = np.asarray([0.05, -0.01, 0.002, -0.0005], np.float32)
    d_t = t_cam.opencv_lens_distortion_fisheye(torch.as_tensor(uv), torch.as_tensor(p))
    d_j = j_cam.opencv_lens_distortion_fisheye(jnp.asarray(uv), jnp.asarray(p))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-6, atol=1e-6)
    for iters in (10, 20):
        r_t = t_cam.opencv_lens_undistortion_fisheye(d_t, torch.as_tensor(p), iters=iters)
        r_j = j_cam.opencv_lens_undistortion_fisheye(d_j, jnp.asarray(p), iters=iters)
        np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(r_t.numpy(), uv, atol=1e-4)
    with pytest.raises(ValueError, match="4 expected"):
        t_cam.opencv_lens_distortion_fisheye(torch.as_tensor(uv), torch.zeros(3))
    with pytest.raises(ValueError, match="not 0, 1, 2, 4 or 8"):
        t_cam.opencv_lens_distortion(torch.as_tensor(uv), torch.zeros(3))


# -- the CLI -------------------------------------------------------------------------------


def test_train_ngp_occ_main_on_a_written_subject(tmp_path, monkeypatch, capsys):
    """``main`` on a tiny written subject, on the CPU, a few steps at tiny
    trainer sizes; the JAX script's defaults are the module's own."""
    _make_blender_subject(str(tmp_path), "lego", "train", n=4, size=16, seed=1)
    _make_blender_subject(str(tmp_path), "lego", "test", n=2, size=16, seed=2)
    assert train_ngp_occ.TRAINER_KWARGS == dict(
        grid_resolution=(128, 128, 128), render_step_size=5e-3, max_samples=128,
        n_candidates=1024)
    monkeypatch.setattr(train_ngp_occ, "TRAINER_KWARGS", dict(
        grid_resolution=(8, 8, 8), render_step_size=0.05, max_samples=32, n_candidates=128,
        ngp_kwargs=dict(neurons=16, layers=1, n_levels=2, n_features=2, log2_hashmap_size=8,
                        base_resolution=4, max_resolution=16, geo_feat_dim=3)))
    monkeypatch.setattr(train_ngp_occ, "EVAL_CHUNK", 100)  # 256 rays a view: three chunks
    monkeypatch.setattr(train_ngp_occ, "CHUNK", 2)
    chunks = []
    real_train = train_ngp_occ.train
    monkeypatch.setattr(train_ngp_occ, "train", lambda *a, **k: real_train(
        *a, on_chunk=lambda s, t: chunks.append(s), **k))
    out = train_ngp_occ.main(["--data-root", str(tmp_path), "--steps", "4", "--num-rays", "64",
                              "--eval-every", "2", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "lego: 4 train / 2 test" in printed and printed.count("test PSNR") == 2
    assert chunks == [2, 4] and len(out["chunk_seconds"]) == 2
    assert [e[0] for e in out["evals"]] == [2, 4]
    assert all(np.isfinite(e[1]) and len(e[2]) == 2 for e in out["evals"])
    assert out["losses"].shape == (4,) and bool(torch.isfinite(out["losses"]).all())
    assert out["state"].step == 4
    rgb = train_ngp_occ.render_view(out["render_fn"], out["state"],
                                    t_ns.load_subject(str(tmp_path), "lego", "test"), 1,
                                    torch.ones(3))
    assert rgb.shape == (16, 16, 3) and bool(torch.isfinite(rgb).all())
    with pytest.raises(SystemExit):
        train_ngp_occ.main([])  # --data-root is required


def test_card_path_imports_no_imageio():
    """``imageio`` is imported inside the loaders only: the trainers and the
    CLI's module import without it (a fresh interpreter)."""
    code = ("import sys\n"
            "import apnerf_tpu_torch.train_ngp_occ, apnerf_tpu_torch.train.examples\n"
            "import apnerf_tpu_torch.data.dnerf_synthetic, apnerf_tpu_torch.data.nerf_360\n"
            "assert not [m for m in sys.modules if m.startswith('imageio')]\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]
