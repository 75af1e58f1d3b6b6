"""Port vs reference: cross-sweep aggregation and stable-region statistics.

``analysis/aggregate.py`` and ``analysis/stable_region.py`` are host numpy in
both packages: the arrays and the ``stable_region_stats.json`` dict must
equal the JAX package's exactly, NaN for NaN.  Inputs: one sweep tree made by
the JAX runner, and a synthetic root of summaries written from a seed
(legacy rows without slope fields, rows with f1A 0 or NaN, non-finite rows).
"""

import os

import numpy as np
import pytest

from _torch_parity import (  # noqa: F401
    assert_identical,
    make_synthetic_root,
    no_jax_compile_cache,
    sweep_copies,
)
from quantumsimulations_tpu.analysis import aggregate as jagg
from quantumsimulations_tpu.analysis import stable_region as jsr
from quantumsimulations_tpu_torch.analysis import aggregate as tagg
from quantumsimulations_tpu_torch.analysis import stable_region as tsr

KEYS = ("eta", "contrast", "delta_Hz", "f1A_Hz", "abs_delta_slope")


@pytest.fixture(scope="module")
def synthetic_root(tmp_path_factory):
    return make_synthetic_root(str(tmp_path_factory.mktemp("synthetic")), seed=42)


@pytest.fixture(scope="module")
def sweep_root(tmp_path_factory):
    jdir, _ = sweep_copies(tmp_path_factory.mktemp("agg_sweep"))
    return os.path.dirname(jdir)


def test_find_sweep_summaries_equal_reference(synthetic_root):
    got = tagg.find_sweep_summaries(synthetic_root)
    assert got == jagg.find_sweep_summaries(synthetic_root)
    assert len(got) == 7


@pytest.mark.parametrize("root_name", ["synthetic_root", "sweep_root"])
def test_aggregate_points_equal_reference(root_name, request):
    root = request.getfixturevalue(root_name)
    got, want = tagg.aggregate_points(root), jagg.aggregate_points(root)
    assert tuple(got) == KEYS
    assert_identical(got, want, root_name)


def test_synthetic_rows_kept_and_dropped(synthetic_root):
    pts = tagg.aggregate_points(synthetic_root)
    # 3 x 13 rows less the NaN eta and the missing contrast, plus 13 legacy
    # rows; the f1A 0 / NaN / missing summaries add none
    assert len(pts["eta"]) == 3 * 13 - 2 + 13
    assert set(np.unique(pts["f1A_Hz"])) == {10e3, 20e3, 30e3, 50e3}
    legacy = pts["f1A_Hz"] == 30e3
    assert np.isnan(pts["abs_delta_slope"][legacy]).all()
    assert np.isfinite(pts["abs_delta_slope"][~legacy]).sum() == 3 * 13 - 2 - 2


def test_load_points_counts_equal_reference(synthetic_root):
    for path in tagg.find_sweep_summaries(synthetic_root):
        tp, jp = tagg.SweepPoints(), jagg.SweepPoints()
        assert tagg.load_points_from_summary(path, tp) == jagg.load_points_from_summary(path, jp)
        assert_identical(tp.arrays(), jp.arrays(), path)


@pytest.mark.parametrize(
    "c_min,p_min,decimals",
    [(0.2, 0.8, 3), (0.1, 0.5, 2), (0.3, 0.6, 1), (0.2, 1.01, 3), (0.0, 0.0, 3)],
)
def test_stable_region_stats_equal_reference(synthetic_root, c_min, p_min, decimals):
    pts = tagg.aggregate_points(synthetic_root)
    x = pts["delta_Hz"] / pts["f1A_Hz"]
    kw = dict(c_min=c_min, p_min=p_min, bin_decimals=decimals)
    got = tsr.stable_region_stats(x, pts["contrast"], **kw)
    assert_identical(got, jsr.stable_region_stats(x, pts["contrast"], **kw))
    assert sum(b["n"] for b in got["per_bin"]) == len(x)
    if p_min > 1.0:
        assert got["best_region"] is None and got["all_regions"] == []


def test_stable_regions_found_on_synthetic_root(synthetic_root):
    pts = tagg.aggregate_points(synthetic_root)
    stats = tsr.stable_region_stats(pts["delta_Hz"] / pts["f1A_Hz"], pts["contrast"],
                                    c_min=0.2, p_min=0.5)
    assert stats["best_region"] is not None
    assert stats["best_region"] == stats["all_regions"][0]


def test_stable_region_stats_on_sweep_tree(sweep_root):
    pts = tagg.aggregate_points(sweep_root)
    x = pts["delta_Hz"] / pts["f1A_Hz"]
    got = tsr.stable_region_stats(x, pts["contrast"])
    assert_identical(got, jsr.stable_region_stats(x, pts["contrast"]))
    assert sum(b["n"] for b in got["per_bin"]) == len(x) == 3


def test_bin_stats_and_regions_edge_cases():
    rng = np.random.default_rng(5)
    x = np.round(rng.uniform(0, 2, 60), 1)
    c = rng.normal(-0.3, 0.3, 60)
    x[[1, 9]] = np.nan
    c[[4]] = np.inf
    for args in ((x, c), (np.zeros(0), np.zeros(0)), ([0.5, 0.5], [-0.5, np.nan])):
        for kw in (dict(), dict(c_min=0.4, bin_decimals=0)):
            got = [b.__dict__ for b in tsr.compute_bin_stats(*args, **kw)]
            want = [b.__dict__ for b in jsr.compute_bin_stats(*args, **kw)]
            assert_identical(got, want)
    # ties on length and points rank by the most negative median contrast
    bins = [tsr.BinStats(x=float(i), n=2, pass_fraction=p, median_contrast=m, mad_contrast=0.0)
            for i, (p, m) in enumerate([(0.9, -0.2), (0.1, 0.0), (0.9, -0.5), (np.nan, 0.0),
                                        (1.0, -0.1), (0.95, -0.3)])]
    jbins = [jsr.BinStats(**b.__dict__) for b in bins]
    got = [r.__dict__ for r in tsr.find_stable_regions(bins, p_min=0.8)]
    assert_identical(got, [r.__dict__ for r in jsr.find_stable_regions(jbins, p_min=0.8)])
    assert [(r["x_lo"], r["x_hi"]) for r in got] == [(4.0, 5.0), (2.0, 2.0), (0.0, 0.0)]
