"""Traffic of kind ``plan``: the mapper's candidate scoring, one call a
request.

Set-up builds the mapper with the benchmark's weights (no training: the
candidate render's work does not depend on the weights), gives it the
initial scan of ``initial_views`` views that a planning mapper holds in
its store, and scores one warm-up candidate. Each request scores
``candidates_per_call`` candidates from the generator with
``_score_candidates``, which reads them back.

``correct`` judges ``checked`` candidates drawn from the seed among the
window's first ``check_span`` requests, in two stages:
  * the renders the scores read (per pixel: the members' rgb and depth
    variances, semantic logits, opacity), which the window's candidate
    render produced, against the plain reference's float32 renders of the
    same weights and trajectory, by each element's gap over the
    quantity's mean size: ``render_median_rel``, the median over all the
    candidate's pixels, and ``render_view_q99_rel``, the worst over the
    members' views of the 99th percentile within one view. A sample the
    proposal round places a rounding away can land on the other side of a
    step of the main encoding's rounded position (the encoding rounds
    positions to bfloat16, 1/256 of the room), which changes its high
    bands outright; the median passes over those few pixels, and the
    percentile over all but a hundredth of a view's, while a render wrong
    on one view in 80, or on a few per cent of every view's rays, moves
    the percentile;
  * ``score_rel``: the four terms the program read back against the
    reference's scoring of the program's own renders, over the largest
    term. The reference follows the program's renders here because its
    own renders differ by those crossings.
"""

from __future__ import annotations

import math
import shutil
import tempfile

import numpy as np
import torch

from .. import generator
from ..reference import spectral_plan
from .program import build_mapper, log, sync


VIEW_QUANTILE = 0.99


def setup(run) -> None:
    run.tmp = tempfile.mkdtemp(prefix="apbench-")
    run.mapper, _, run.weights = build_mapper(run, run.tmp)
    log("mapper")
    run.mapper.initialization(run.traffic["initial_views"])
    log("scan")
    run.scored = []  # (trajectory, the program's four terms, its renders or None)
    rng = np.random.RandomState(run.seeds["check"])
    run.checked = set(rng.choice(run.traffic["check_span"], size=run.traffic["checked"],
                                 replace=False).tolist())
    render = run.mapper._render_unc
    run.keep, run.kept = False, []

    def keeping(*args, **kw):
        out = render(*args, **kw)
        if run.keep:
            run.kept.append({k: out[k] for k in spectral_plan.RENDERED})
        return out

    run.mapper._render_unc = keeping
    warm = generator.candidate(run.traffic, run.cfg["aabb"], run.seeds["warm"], 0)
    run.mapper._score_candidates([warm], run.traffic["call_step"])
    sync(run.device)
    log("warm candidate")
    run.calls = 0


def request(run) -> dict:
    cands = generator.candidates(run.traffic, run.cfg["aabb"], run.seeds["traffic"], run.calls)
    step = run.traffic["call_step"]
    run.keep, run.kept = run.calls in run.checked, []
    run.mapper._score_candidates(cands, step)
    run.keep = False
    terms = run.mapper.trajector_uncertainty_list[step - 1][-len(cands):]
    kept = run.kept if run.kept else [None] * len(cands)
    run.scored += list(zip(cands, terms, kept))
    run.calls += 1
    return {"failed": not all(math.isfinite(v) for t in terms for v in t)}


def work(run, n_requests: int) -> dict:
    cfg, traffic = run.cfg, run.traffic
    n_views = len(spectral_plan.scored_views(traffic["flight_poses"] + traffic["spin_poses"]))
    rays = int(cfg["img_h"] * cfg["unc_scale"]) * int(cfg["img_w"] * cfg["unc_scale"])
    return {"candidates": n_requests * traffic["candidates_per_call"], "views": n_views,
            "rays_per_view": rays}


def after_window(run) -> None:
    run.scored = [(t, terms, None if r is None else {k: v.cpu() for k, v in r.items()})
                  for t, terms, r in run.scored]
    del run.mapper, run.kept
    shutil.rmtree(run.tmp, ignore_errors=True)


def element_gaps(got: dict, ref: dict):
    """Each rendered quantity's elements' gaps |got - ref| over the
    quantity's mean size in ``ref``, [E x V, elements of a view] in
    float64, or None where a render has another shape."""
    out = {}
    for k in spectral_plan.RENDERED:
        a, b = got[k].double().cpu(), ref[k].double().cpu()
        if a.shape != b.shape:
            return None
        g = (a - b).abs() / b.abs().mean()
        out[k] = g.reshape(g.shape[0] * g.shape[1], -1)
    return out


def view_quantile(g: torch.Tensor, q: float) -> torch.Tensor:
    """The ``q`` quantile of each row of ``g`` by nearest rank."""
    k = max(1, math.ceil(q * g.shape[1]))
    return torch.kthvalue(g, k, dim=1).values


def render_gaps(got: dict, ref: dict, q: float = VIEW_QUANTILE) -> tuple:
    """(the worst quantity's median gap over all pixels, the worst over
    quantities and views of a view's ``q`` quantile gap); infinite where
    a render has another shape."""
    gaps = element_gaps(got, ref)
    if gaps is None:
        return float("inf"), float("inf")
    return (max(float(g.median()) for g in gaps.values()),
            max(float(view_quantile(g, q).max()) for g in gaps.values()))


def score_gap(terms, ref_terms) -> float:
    """The worst gap of the four terms over the largest reference term."""
    p, r = np.asarray(terms, np.float64), np.asarray(ref_terms, np.float64)
    return float(np.abs(p - r).max() / np.abs(r).max())


def compare(run) -> dict:
    checked = [(t, terms, r) for t, terms, r in run.scored if r is not None]
    out = {"render_median_rel": 0.0, "render_view_q99_rel": 0.0, "score_rel": 0.0}
    if not checked:
        return {k: float("inf") for k in out}
    for traj, terms, got in checked:
        ref = spectral_plan.render_candidate(run.cfg, run.weights, traj)
        med, top = render_gaps(got, ref)
        out["render_median_rel"] = max(out["render_median_rel"], med)
        out["render_view_q99_rel"] = max(out["render_view_q99_rel"], top)
        out["score_rel"] = max(out["score_rel"],
                               score_gap(terms, spectral_plan.predictive_information(got)))
    return out
