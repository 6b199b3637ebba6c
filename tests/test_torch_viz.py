"""The port's visualisation (``viz/``), Habitat facade, ``--profile`` and
the proposal sampler's default warp, held to the JAX package on the CPU.

- Host functions (``side_by_side``, ``voxel_slices``, ``stitch_video``,
  ``save_frames``, the colour maps, ``make_video``): the same numpy code,
  held exactly (arrays ``==``, written files byte for byte).
- Renders (``render_comparison``, ``walkthrough``, ``InteractiveViewer``):
  the port's mapper renders on the CPU. Each NeRF panel is held exactly to
  the port's ``_render_eval`` output on the same rays through
  ``colorize_*``; the JAX package's own functions, handed that same
  render through a JAX-facing view of the port's mapper, give the same
  frames exactly, so poses, panels and layout agree with JAX's; the
  viewer's pose after every key equals JAX's ``_apply`` sequence exactly.
- Habitat: the facade's numpy helpers exactly against JAX's on random
  poses, the contract cases of ``tests/test_habitat_contract.py`` on the
  port's ``HabitatSim`` with the same stub module, and ``--sim habitat``
  through the CLI.
- ``--profile DIR`` writes a Chrome trace that names the mapper's ops.
- F7: ``propnet_sampling`` without ``sampling_type`` warps as JAX's does
  ('lindisp'); t0 and t1 agree to 1e-6 relative.
"""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_habitat_contract as hc
from apnerf_tpu.models import propnet as j_prop
from apnerf_tpu.sim import habitat as j_hab
from apnerf_tpu.viz import interactive as j_int
from apnerf_tpu.viz import make_video as j_mv
from apnerf_tpu.viz import render_views as j_rv
from apnerf_tpu_torch.active import pipeline as t_cli
from apnerf_tpu_torch.models import propnet as t_prop
from apnerf_tpu_torch.sim import habitat as t_hab
from apnerf_tpu_torch.viz import interactive as t_int
from apnerf_tpu_torch.viz import make_video as t_mv
from apnerf_tpu_torch.viz import render_views as t_rv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AABB = (-4.0, 0.0, -4.0, 0.0, 3.0, 0.0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """This file's tests run PyTorch on one CPU thread, restored after: the
    suite runs several test processes at once, and many small ops on a
    pool of threads per process oversubscribe the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(n=4, size=16, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.rand(size, size, 3) * 255).astype(np.uint8) for _ in range(n)]


# -- host half ----------------------------------------------------------------------------------


def test_host_functions_equal_jax(tmp_path):
    rng = np.random.RandomState(1)
    d = np.linspace(0, 12, 64).reshape(8, 8)
    for md in (10.0, 4.0):
        assert np.array_equal(t_rv.colorize_depth(d, md), j_rv.colorize_depth(d, md))
    sem = rng.randint(0, 40, (6, 7))
    for c in (1, 5, 29):
        assert np.array_equal(t_rv.colorize_semantics(sem, c), j_rv.colorize_semantics(sem, c))
    panels = [np.zeros((8, 8, 3), np.uint8), np.ones((8, 6), np.float32),
              rng.rand(5, 4, 3).astype(np.float32) * 1.5, rng.randint(0, 255, (7, 3, 3), np.uint8)]
    for pad in (2, 0, 5):
        got = t_rv.side_by_side(panels, pad=pad)
        assert got.dtype == np.uint8 and np.array_equal(got, j_rv.side_by_side(panels, pad=pad))
    b = rng.rand(8, 5, 9) < 0.3
    for axis, ms in ((1, 4), (0, 16), (2, 3)):
        assert np.array_equal(t_rv.voxel_slices(b, axis, ms), j_rv.voxel_slices(b, axis, ms))
    frames = _frames()
    t_gif = t_rv.stitch_video(frames, str(tmp_path / "t" / "v.gif"), fps=4)
    j_gif = j_rv.stitch_video(frames, str(tmp_path / "j" / "v.gif"), fps=4)
    assert os.path.getsize(t_gif) > 0 and open(t_gif, "rb").read() == open(j_gif, "rb").read()
    tp = t_rv.save_frames(frames, str(tmp_path / "tf"), prefix="f")
    jp = j_rv.save_frames(frames, str(tmp_path / "jf"), prefix="f")
    assert [os.path.basename(p) for p in tp] == [os.path.basename(p) for p in jp]
    assert all(open(a, "rb").read() == open(b, "rb").read() for a, b in zip(tp, jp))


def _write_run(run):
    """The mapper's viz layout, as ``tests/test_viz.py`` writes it."""
    import imageio.v2 as imageio

    viz = run / "viz"
    (viz / "top").mkdir(parents=True)
    subs = ("gt_rgb", "pd_rgb", "gt_dep", "pd_dep", "gt_sem", "pd_sem")
    for sub in subs:
        (viz / "fpv" / sub).mkdir(parents=True)
    rng = np.random.RandomState(0)
    for i in range(3):
        imageio.imwrite(viz / f"{i}.png", (rng.rand(16, 16, 3) * 255).astype(np.uint8))
        imageio.imwrite(viz / "top" / f"{i}.png", (rng.rand(16, 16, 3) * 255).astype(np.uint8))
        for sub in subs[: 6 - i]:  # later frames lack some panels
            imageio.imwrite(viz / "fpv" / sub / f"{i}.png",
                            (rng.rand(8, 8 + i, 3) * 255).astype(np.uint8))


def test_make_video_equals_jax(tmp_path, capsys):
    _write_run(tmp_path)
    for stride in (1, 2):
        got = t_mv.compose_demo_frames(str(tmp_path), stride=stride)
        want = j_mv.compose_demo_frames(str(tmp_path), stride=stride)
        assert len(got) == len(want) == (3 if stride == 1 else 2)
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
    t_mv.main(["--run", str(tmp_path), "--out", str(tmp_path / "t.gif"), "--fps", "4"])
    j_mv.main(["--run", str(tmp_path), "--out", str(tmp_path / "j.gif"), "--fps", "4"])
    assert open(tmp_path / "t.gif", "rb").read() == open(tmp_path / "j.gif", "rb").read()
    assert "wrote" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="no viz frames"):
        t_mv.main(["--run", str(tmp_path / "empty")])


# -- render half ----------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mapper(tmp_path_factory):
    from apnerf_tpu_torch.active.mapper import ActiveNeRFMapper
    from apnerf_tpu_torch.config import PipelineConfig
    from apnerf_tpu_torch.sim.fake import FakeSim

    tmp = tmp_path_factory.mktemp("viz")
    cfg = PipelineConfig(
        save_path=str(tmp), aabb=AABB, near_plane=0.1, img_w=32, img_h=32, num_rays=64,
        max_samples_train=16, max_samples_test=24, num_semantic_classes=8, n_ensembles=2,
        spectral_neurons=32, spectral_freqs_per_level=2, prop_neurons=16, max_images=32,
        test_loc=((-2.0, 1.5, -2.0),), global_origin=(-2.0, 1.5, -2.0, 0.0, 0.0, 0.0, 1.0),
    )
    sim = FakeSim(aabb=AABB, img_w=cfg.img_w, img_h=cfg.img_h)
    m = ActiveNeRFMapper(cfg, sim, save_path=str(tmp / "out"), seed=0, device="cpu")
    m.initialization(initial_samples=4)
    m.nerf_training(4, initial_train=True, evaluate=False)
    return m


class JaxFacing:
    """The port's mapper seen through the interface the JAX package's viz
    functions call: ``_render_eval`` hands back the port's render as numpy."""

    def __init__(self, m):
        self.m, self.cfg, self.sim = m, m.cfg, m.sim
        self.save_path, self.global_origin = m.save_path, m.global_origin
        self.state = types.SimpleNamespace(params=m.state.members, occ=m.state.occ)
        self.asked = []

    def _pose7_to_rays(self, poses, scale):
        self.asked.append(np.array(poses))
        return self.m._pose7_to_rays(poses, scale)

    def _pose7_to_grid_rays(self, poses, oh, ow):
        self.asked.append(np.array(poses))
        return self.m._pose7_to_grid_rays(poses, oh, ow)

    def _render_eval(self, params, occ, origins, viewdirs, bkgd):
        out = self.m._render_eval(params, occ, origins, viewdirs,
                                  torch.as_tensor(np.asarray(bkgd), dtype=torch.float32))
        return {k: v.float().numpy() for k, v in out.items()}


def _nerf_panels(m, rays, i, oh, ow):
    """Member 0's rgb | depth | semantics of view i, from ``_render_eval``."""
    out = m._render_eval(m.state.members, m.state.occ, rays.origins, rays.viewdirs, torch.ones(3))
    rgb = out["rgb"][0][i].numpy().reshape(oh, ow, 3)
    dep = out["depth"][0][i].numpy().reshape(oh, ow)
    sem = np.argmax(out["sem"][0][i].numpy(), -1).reshape(oh, ow)
    C = m.cfg.num_semantic_classes
    return (rgb * 255).astype(np.uint8), t_rv.colorize_depth(dep), t_rv.colorize_semantics(sem, C)


def test_render_comparison_and_walkthrough_equal_jax(mapper):
    m = mapper
    poses = np.array([[-2.0, 1.5, -2.0, 0, 0, 0, 1.0], [-1.5, 1.4, -2.5, 0, 0.6, 0, 0.8]])
    frames = t_rv.render_comparison(m, poses, scale=0.25)
    assert len(frames) == 2
    oh = ow = 8
    rays = m._pose7_to_rays(poses, 0.25)
    rgbs, deps, sems = m.sim.sample_images_from_poses(poses)
    C = m.cfg.num_semantic_classes
    for i, f in enumerate(frames):
        p_rgb, p_dep, p_sem = _nerf_panels(m, rays, i, oh, ow)
        want = t_rv.side_by_side([rgbs[i][..., :3], p_rgb, t_rv.colorize_depth(deps[i]), p_dep,
                                  t_rv.colorize_semantics(sems[i], C), p_sem])
        assert f.dtype == np.uint8 and np.array_equal(f, want)
    jf = JaxFacing(m)
    assert all(np.array_equal(a, b)
               for a, b in zip(frames, j_rv.render_comparison(jf, poses, scale=0.25)))
    # walkthrough: JAX's poses and frames
    start = np.array([-2.2, 1.5, -1.8, 0, 0, 0, 1.0])
    seen = []
    real = t_rv.render_comparison
    try:
        t_rv.render_comparison = lambda mm, p, scale: seen.append(np.array(p)) or real(mm, p, scale)
        walk = t_rv.walkthrough(m, start, n_frames=3, scale=0.25)
    finally:
        t_rv.render_comparison = real
    jf.asked.clear()
    jwalk = j_rv.walkthrough(jf, start, n_frames=3, scale=0.25)
    assert len(seen) == 1 and np.array_equal(seen[0], jf.asked[0])
    assert len(walk) == 3 and all(np.array_equal(a, b) for a, b in zip(walk, jwalk))


def test_interactive_viewer_equals_jax(mapper, tmp_path):
    m = mapper
    viewer = t_int.InteractiveViewer(m, out_dir=str(tmp_path / "t"), scale=0.25)
    jview = j_int.InteractiveViewer(JaxFacing(m), out_dir=str(tmp_path / "j"), scale=0.25)
    keys = "wqasdrfe"
    for k in keys:
        assert viewer._apply(k) and jview._apply(k)
        assert np.array_equal(viewer.pos, jview.pos) and viewer.yaw == jview.yaw
        assert np.array_equal(viewer.pose7, jview.pose7)
    assert not viewer._apply("x") and not viewer._apply("\x1b")
    frames = viewer.run_scripted("wdx")
    jframes = jview.run_scripted("wdx")
    assert len(frames) == 2 and len(os.listdir(tmp_path / "t")) == 2
    assert all(np.array_equal(a, b) for a, b in zip(frames, jframes))
    # the frame: GT strided | member 0's panels, from _render_eval on the grid rays
    rays = m._pose7_to_grid_rays(viewer.pose7[None], 8, 8)
    gt, _, _ = m.sim.sample_images_from_poses(viewer.pose7[None])
    ys = xs = (np.arange(8) * 32) // 8
    p_rgb, p_dep, p_sem = _nerf_panels(m, rays, 0, 8, 8)
    p_rgb = (np.clip(m._render_eval(m.state.members, m.state.occ, rays.origins, rays.viewdirs,
                                    torch.ones(3))["rgb"][0][0].numpy().reshape(8, 8, 3), 0, 1)
             * 255).astype(np.uint8)
    want = t_rv.side_by_side([gt[0][..., :3][np.ix_(ys, xs)].astype(np.uint8), p_rgb, p_dep,
                              p_sem])
    assert np.array_equal(frames[-1], want)


def faketiny_yaml(tmp_path, **over):
    """``configs/config_faketiny.yaml`` with its runs under ``tmp_path`` and
    ``over`` applied → the copy's path."""
    import yaml

    with open(os.path.join(REPO, "configs", "config_faketiny.yaml")) as f:
        raw = yaml.safe_load(f)
    raw.update(save_path=str(tmp_path / "runs"), **over)
    cfg = tmp_path / "faketiny.yaml"
    cfg.write_text(yaml.safe_dump(raw))
    return str(cfg)


def test_interactive_main_builds_through_the_cli(tmp_path):
    """``main`` builds its mapper with the port's CLI, loads a checkpoint
    and runs the scripted keys."""
    args = ["--sim", "fake", "--device", "cpu", "--config", faketiny_yaml(tmp_path)]
    m = t_cli.build_mapper(t_cli.parse_args(args))
    m.save_checkpoints()
    out = tmp_path / "frames"
    t_int.main(["--ckpt", os.path.join(m.save_path, "checkpoints"), "--keys", "wq",
                "--out", str(out), *args])
    assert sorted(os.listdir(out)) == ["frame_0000.png", "frame_0001.png"]


# -- Habitat facade ---------------------------------------------------------------------------------


def test_habitat_helpers_equal_jax():
    rng = np.random.RandomState(3)
    for _ in range(20):
        pose = np.concatenate([rng.randn(3), rng.randn(4)])
        a, b = t_hab.pose7_to_state_quat(pose), j_hab.pose7_to_state_quat(pose)
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
        eye, target = rng.randn(3) * 2, rng.randn(3) * 2
        assert np.array_equal(t_hab.look_at_quaternion(eye, target),
                              j_hab.look_at_quaternion(eye, target))
    eye = np.array([0.0, 2.0, 0.0])  # straight down: the degenerate up vector
    assert np.array_equal(t_hab.look_at_quaternion(eye, eye - [0, 1, 0]),
                          j_hab.look_at_quaternion(eye, eye - [0, 1, 0]))
    assert np.array_equal(t_hab.TOP_DOWN_CAMERA_QUAT, j_hab.TOP_DOWN_CAMERA_QUAT)
    with pytest.raises(ValueError):
        t_hab.pose7_to_state_quat(np.zeros(7))


@pytest.mark.parametrize("case", [hc.test_constructor_contract,
                                  hc.test_sample_images_from_poses_contract,
                                  hc.test_navmesh_contract, hc.test_agent_state_roundtrip],
                         ids=lambda f: f.__name__[5:])
def test_habitat_contract_on_the_port(monkeypatch, case):
    hc._install_fake_habitat(monkeypatch)
    case(t_hab.HabitatSim("102344250", "cfg.json", 64, 48))


def test_habitat_facade_answers_as_jax(monkeypatch):
    hc._install_fake_habitat(monkeypatch)
    sims = [mod.HabitatSim("102344250", "cfg.json", 64, 48) for mod in (t_hab, j_hab)]
    poses = [np.array([1.0, 1.5, 2.0, 0, 0, 0, 1.0]), np.array([0.0, 1.5, 0.0, 0, 0.6, 0, 0.8])]
    obs = [s.sample_images_from_poses(poses) for s in sims]
    assert all(np.array_equal(a, b) for a, b in zip(*obs))
    for s in sims:
        s.set_quad_state(np.array([1.0, 2.0, 3.0, 0, 0.6, 0, 0.8]))
    assert np.array_equal(sims[0].get_quad_state(), sims[1].get_quad_state())
    def calls(s):
        return [[(np.asarray(st.position).tolist(),
                  (st.rotation.w, st.rotation.x, st.rotation.y, st.rotation.z), flag)
                 for st, flag in agent.set_state_calls] for agent in s._sim.agents]

    assert calls(sims[0]) == calls(sims[1])
    paths = [s.sample_path(np.array([0.0, 1.5, 0.0])) for s in sims]
    assert np.array_equal(*paths)


def test_cli_sim_habitat_reaches_the_facade(monkeypatch, tmp_path):
    args = t_cli.parse_args(["--sim", "habitat", "--device", "cpu",
                             "--config", faketiny_yaml(tmp_path),
                             "--sem-num", "8"])
    monkeypatch.setitem(__import__("sys").modules, "habitat_sim", None)
    with pytest.raises(ImportError) as port_err:
        t_cli.build_mapper(args)
    with pytest.raises(ImportError) as jax_err:
        j_hab._require_habitat()
    assert str(port_err.value) == str(jax_err.value).replace(
        "apnerf_tpu.sim.fake", "apnerf_tpu_torch.sim.fake")
    hc._install_fake_habitat(monkeypatch)
    m = t_cli.build_mapper(args)
    assert isinstance(m.sim, t_hab.HabitatSim) and m.cfg.num_semantic_classes == 8
    assert m.sim._sim.configuration.sim_cfg.scene_id == "102344250"


# -- --profile ------------------------------------------------------------------------------------


def test_cli_profile_writes_a_trace(tmp_path):
    """The faketiny loop, cut to 2 train steps a phase, under ``--profile``."""
    cfg = faketiny_yaml(tmp_path, training_steps=2, img_w=24, img_h=24,
                        test_loc=[[-2.0, 1.5, -2.0]], test_quat=[[0, 0, 0, 1]])
    prof = tmp_path / "prof"
    mapper = t_cli.main(["--sim", "fake", "--device", "cpu", "--config", cfg,
                         "--profile", str(prof)])
    assert mapper.errors_hist and os.listdir(prof) == ["trace.json"]
    with open(prof / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    # the proposal sampler's bin search and the train loss's rgb term
    assert "aten::searchsorted" in names and "aten::huber_loss" in names
    assert t_cli.parse_args([]).profile is None


# -- F7: the proposal sampler's default warp --------------------------------------------------------


def test_propnet_sampling_default_warp_is_jax_s():
    from apnerf_tpu.models import spectral as j_sp
    from apnerf_tpu_torch.models import spectral as t_sp
    from test_torch_fields import configs, jax_ensemble, small_cfg
    from apnerf_tpu_torch.interop import params_from_jax

    cfg = small_cfg()
    tree = jax_ensemble(cfg)
    _, jp, _, tp = configs(cfg, "float32")
    j_prop_params = jax.tree.map(lambda a: a[0], tree)["prop"]
    t_prop_params = params_from_jax(tree)[0].prop
    rng = np.random.default_rng(11)
    R = 16
    o = rng.uniform(-3.5, -0.5, (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    near = rng.uniform(0.1, 0.3, R).astype(np.float32)
    far = near + 3.0

    def j_sig(t0, t1):
        pos = o[:, None] + (0.5 * (t0 + t1))[..., None] * d[:, None]
        return j_sp.query_density_field(j_prop_params, jp, pos)[..., 0]

    to, td = torch.as_tensor(o), torch.as_tensor(d)

    def t_sig(t0, t1):
        pos = to[:, None] + (0.5 * (t0 + t1))[..., None] * td[:, None]
        return t_sp.query_density_field(t_prop_params, tp, pos)[..., 0]

    t0j, t1j, _ = j_prop.propnet_sampling(jax.random.PRNGKey(0), [j_sig], [24], 32, o, d,
                                          near, far, stratified=False)
    args = ([t_sig], [24], 32, to, td, torch.as_tensor(near), torch.as_tensor(far))
    t0t, t1t, _ = t_prop.propnet_sampling(*args, stratified=False)
    # relative 1e-6: the warp is linear in 1/t, so its roundings are relative (read 8.3e-7)
    np.testing.assert_allclose(t0t.detach().numpy(), np.asarray(t0j), rtol=1e-6, atol=0)
    np.testing.assert_allclose(t1t.detach().numpy(), np.asarray(t1j), rtol=1e-6, atol=0)
    # the warp matters here: the uniform one lands elsewhere
    t0u, _, _ = t_prop.propnet_sampling(*args, stratified=False, sampling_type="uniform")
    assert np.abs(t0u.detach().numpy() - np.asarray(t0j)).max() > 1e-2
