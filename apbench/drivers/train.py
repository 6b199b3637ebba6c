"""Traffic of kind ``train``: the mapper's train loop, one call a request.

Set-up builds the mapper with the benchmark's weights, scans the room
(``initialization``), and drives the train loop through the window's own
call: one step, then two, each read back, keeping the optimizer's state
after the first and the parameters after the third for the comparison;
then the rest of ``warm_steps``. The window makes calls of
``steps_per_call`` steps; each ends in its losses' read-back.

``correct`` compares two sets of three steps with the plain reference
(``reference/ngp_train.py``), each by the loss of every step, each
leaf's first gradient (from Adam's first moment after the first step)
and each leaf's change over the three steps:
  * set-up's first three steps (``loss_rel``, ``grad1_rel``,
    ``change3_rel``), the reference run from the same weights, scan and
    draw seed: the start, whose grid update evaluates every cell;
  * three steps the window's state takes after it closes (``*_late``):
    the calls go on to the grid's next update, past its warm-up, where it
    evaluates a quarter of the cells drawn uniformly and a quarter among
    the occupied; the program's leaves, moments, update counts, grids and
    draw generator are kept there, and the reference follows the three
    steps from that state. The reference cannot redo the window's
    hundreds of steps in a run's time, so it follows the program from
    the program's state here, and the start is checked on its own above.
"""

from __future__ import annotations

import math
import shutil
import tempfile

import numpy as np
import torch

from ..reference import ngp_train
from ..reference.common import intrinsics, pose_matrix
from .program import build_mapper, log, sync, to_host

ADAM_B1 = 0.9


def _call(run, steps: int):
    return run.mapper.nerf_training(steps, planning_step=run.traffic["planning_step"],
                                    evaluate=False)


def setup(run) -> None:
    run.tmp = tempfile.mkdtemp(prefix="apbench-")
    mapper, room, weights = build_mapper(run, run.tmp)
    log("mapper")
    run.mapper, run.room, run.weights = mapper, room, weights
    n_views = run.traffic["initial_views"]
    mapper.initialization(n_views)
    log("scan")
    run.scan_poses = list(room.poses[:n_views])
    losses = list(_call(run, 1))
    log("first step")
    # the first gradient as Adam got it: its first moment after one step is (1 - b1) g
    grad1 = [{n: mu / (1 - ADAM_B1) for n, mu in _by_leaf(m, o.mu).items()}
             for m, o in zip(mapper.members, mapper.state.opt)]
    losses += _call(run, 2)
    run.readings = {"losses": losses, "grad1": grad1,
                    "params": [to_host(dict(m.named_parameters())) for m in mapper.members]}
    log("three steps")
    left = run.traffic["warm_steps"] - 3
    while left > 0:
        n = min(run.traffic["steps_per_call"], left)
        _call(run, n)
        left -= n
    sync(run.device)
    log("warm steps")


def _by_leaf(member, flat) -> dict:
    """A member's flat optimizer vector (in ``named_parameters`` order) by
    leaf, in float64 on the host."""
    named = list(member.named_parameters())
    parts = torch.split(flat.detach().to("cpu", torch.float64), [p.numel() for _, p in named])
    return {n: v.view(p.shape) for (n, p), v in zip(named, parts)}


def late_steps(run) -> None:
    """The window's state on to the grid's next update, kept there
    (``run.late_start``), then three steps through the window's call
    (``run.late_readings``)."""
    mapper = run.mapper
    ahead = -int(mapper.state.step) % run.cfg["occ_every_n"]
    if ahead:
        _call(run, ahead)
    st = mapper.state
    run.late_start = {
        "step": int(st.step), "gen_state": mapper.generator.get_state(),
        "params": [to_host(dict(m.named_parameters())) for m in st.members],
        "mu": [_by_leaf(m, o.mu) for m, o in zip(st.members, st.opt)],
        "nu": [_by_leaf(m, o.nu) for m, o in zip(st.members, st.opt)],
        "count": [int(o.count) for o in st.opt],
        "occs": [o.occs.detach().cpu() for o in st.occ],
        "binaries": [o.binaries.detach().cpu() for o in st.occ],
    }
    losses = list(_call(run, 1))
    grad1 = []
    for m, o, mu0 in zip(mapper.members, mapper.state.opt, run.late_start["mu"]):
        grad1.append({n: (mu - ADAM_B1 * mu0[n]) / (1 - ADAM_B1)
                      for n, mu in _by_leaf(m, o.mu).items()})
    losses += _call(run, 2)
    run.late_readings = {"losses": losses, "grad1": grad1,
                         "params": [to_host(dict(m.named_parameters())) for m in mapper.members]}


def request(run) -> dict:
    vals = _call(run, run.traffic["steps_per_call"])
    return {"failed": not all(math.isfinite(v) for v in vals)}


def work(run, n_requests: int) -> dict:
    steps = n_requests * run.traffic["steps_per_call"]
    E, R = run.cfg["n_ensembles"], run.cfg["num_rays"]
    return {"steps": steps, "member_steps": steps * E, "rays": steps * E * R}


def _scan(run):
    """The initial scan as the reference reads it, rendered again from the
    recorded poses (the scene is deterministic), on the run's device."""
    imgs, deps, sems = run.room.sample_images_from_poses(run.scan_poses)
    dev = run.device
    c2w = np.stack([pose_matrix(p[:3], p[3:]) for p in run.scan_poses])
    cfg = run.cfg
    return {"images": torch.as_tensor(imgs[..., :3], device=dev),
            "depths": torch.as_tensor(deps, device=dev),
            "sems": torch.as_tensor(sems.astype(np.int32), device=dev),
            "c2w": torch.as_tensor(c2w, dtype=torch.float32, device=dev),
            "K": torch.as_tensor(intrinsics(cfg["img_w"], cfg["img_h"], cfg["hfov"]), device=dev)}


KEPT_BATCHES = 8


def kept_samples_per_member_step(run) -> float:
    """Samples the march keeps for a ray batch, averaged over
    ``KEPT_BATCHES`` batches a member of the scan's pixels drawn by the
    benchmark, marched by the benchmark's own plain march through each
    member's grid at the window's end."""
    cfg, dev = run.cfg, run.device
    data = run.scan if getattr(run, "scan", None) is not None else _scan(run)
    g = torch.Generator(device=dev)
    g.manual_seed(run.seeds["check"])
    aabb = torch.as_tensor(cfg["aabb"], dtype=torch.float32, device=dev)
    edges = torch.as_tensor(ngp_train.lattice(cfg), device=dev)
    N, H, W = data["images"].shape[:3]
    R, kept = cfg["num_rays"], []
    for occ in run.mapper.state.occ:
        for _ in range(KEPT_BATCHES):
            img = int(torch.randint(0, N, (1,), generator=g, device=dev))
            x = torch.randint(0, W, (R,), generator=g, device=dev)
            y = torch.randint(0, H, (R,), generator=g, device=dev)
            b = ngp_train.fetch(data, img, x, y, data["K"])
            _, _, valid = ngp_train.march(b["o"], b["d"], occ.binaries, aabb, edges,
                                          cfg["max_samples_train"])
            kept.append(float(valid.sum()))
    return float(np.mean(kept))


def after_window(run) -> None:
    """What the readers and the comparison need from the program, then
    the program's state freed."""
    run.scan = _scan(run)
    if run.trace_on:
        run.work["kept_samples"] = (kept_samples_per_member_step(run)
                                    * run.work["member_steps"])
        run.work["kept_per_member_step"] = run.work["kept_samples"] / max(
            run.work["member_steps"], 1)
    late_steps(run)
    del run.mapper
    shutil.rmtree(run.tmp, ignore_errors=True)


def _norm(t) -> float:
    return float(torch.linalg.vector_norm(t.detach().double()))


def _rel(gap: float, scale: float) -> float:
    """``gap`` over ``scale``; where the reference reads nought, any gap is infinite."""
    if scale > 0:
        return gap / scale
    return 0.0 if gap == 0 else float("inf")


def gaps(readings: dict, params0, ref: dict, suffix: str = "") -> dict:
    """Three numbers ``correct`` compares (see the module's doc), each
    the worst over steps, members and leaves, of ``readings`` (``losses``
    of the three steps, each member's ``grad1`` and ``params`` after them,
    by leaf) against the reference's, from the leaves ``params0``."""
    loss = max(_rel(abs(p - r), abs(r)) for p, r in zip(readings["losses"], ref["losses"]))
    grad, change = 0.0, 0.0
    for m, g_prog in enumerate(readings["grad1"]):
        names = list(params0[m])
        p0 = {n: params0[m][n].detach().cpu().double() for n in names}
        rg = {n: _norm(ref["grad1"][m][n]) for n in names}
        med = float(np.median(list(rg.values())))
        for n in names:
            grad = max(grad, _rel(abs(_norm(g_prog[n]) - rg[n]), max(rg[n], med)))
        # leaves whose reference gradient is nought to rounding move by round-off alone
        moved = [n for n in names if rg[n] >= 1e-3 * med]
        dr = {n: _norm(ref["params"][m][n].cpu().double() - p0[n]) for n in moved}
        dmed = float(np.median(list(dr.values()))) if dr else 0.0
        for n in moved:
            dp = _norm(readings["params"][m][n].cpu().double() - p0[n])
            change = max(change, _rel(abs(dp - dr[n]), max(dr[n], dmed)))
    return {"loss_rel" + suffix: loss, "grad1_rel" + suffix: grad,
            "change3_rel" + suffix: change}


def follow_reference(run, precision: str = "f32", half_batch: bool = False,
                     late: bool = False) -> dict:
    """The reference's three steps on the run's scan: the first, from the
    run's weights and draw seed, or with ``late`` those from the window's
    kept state."""
    start = run.late_start if late else None
    return ngp_train.follow(
        run.cfg, start["params"] if late else run.weights, run.scan, run.seeds["draws"], 3,
        precision=precision, recent_bias=run.traffic["planning_step"] > 0,
        occ_thre=occ_thre_for_phase(run.traffic["planning_step"]), half_batch=half_batch,
        start=start)


def occ_thre_for_phase(planning_step: int) -> float:
    """The grid's threshold by phase (the reference's schedule): the initial
    training and the first planning steps 1e-3, the final one 1e-2, later
    planning steps 3e-3."""
    if planning_step == -10:
        return 1e-2
    return 1e-3 if planning_step < 5 else 3e-3


def compare(run) -> dict:
    return {**gaps(run.readings, run.weights, follow_reference(run)),
            **gaps(run.late_readings, run.late_start["params"], follow_reference(run, late=True),
                   "_late")}
