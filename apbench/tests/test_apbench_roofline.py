"""The yardstick's arithmetic against the bounds the port's records print
(``PERF.md``'s table of kernels: K4 fwd 0.4544 ms at 1,048,576 rows, H bwd
0.140 ms at 33.5M terms)."""

import json

import pytest

from apbench import roofline
from apbench.run import HERE


def _cfg(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def test_apbench_field_heads_fwd_bound_at_a_view():
    ms, which = roofline.field_heads_fwd_bound(_cfg("flagship_spectral_prop"), 4096, 256)
    assert which == "operations"
    assert ms == pytest.approx(0.4544, abs=5e-5)


def test_apbench_hash_table_bwd_bound_at_the_train_step():
    cfg = _cfg("ngp_occ")
    n = cfg["num_rays"] * cfg["max_samples_train"]
    assert 16 * 8 * n == 33554432
    ms, which = roofline.hash_table_bwd_bound(cfg, n)
    assert which == "bytes"
    assert ms == pytest.approx(0.140, abs=5e-4)


def test_apbench_work_counts():
    cfg = _cfg("ngp_occ")
    # base 64-128-128-16, rgb head 31-64-64-3, semantic head 15-64-64-29
    assert roofline.ngp_mlp_macs(cfg) == 26624 + 6272 + 6912
    assert roofline.ngp_train_flops(cfg, 10) == 6 * 39808 * 10
    fl = _cfg("flagship_spectral_prop")
    assert roofline.spectral_macs(fl) == 214272
    assert roofline.prop_macs(fl) == 96 + 64 * 64 + 64 * 64 + 64
    per_ray = 214272 * 256 + roofline.prop_macs(fl) * 64
    assert roofline.plan_flops(fl, 1, 40, 4096) == 2 * per_ray * 4096 * 40 * 2
