"""Port vs reference: re-analysis of a saved sweep (sweep/reprocess*.py).

One sweep tree made by the JAX runner is copied once per package; each
package's reprocessors write into their own copy.  Both are host numpy on the
same saved traces, so the JSON they write must be the same text, byte for
byte (the exponential summary names its own sweep directory, which differs by
the copy's root).  With plots on, both write the same set of PDF and PNG
files.
"""

import json
import os
import re
import shutil

import numpy as np
import pytest

from _torch_parity import POST_SWEEP_NAME, no_jax_compile_cache, sweep_copies  # noqa: F401
from quantumsimulations_tpu.sweep import reprocess as jrep
from quantumsimulations_tpu.sweep import reprocess_exponential as jexp
from quantumsimulations_tpu_torch.sweep import reprocess as trep
from quantumsimulations_tpu_torch.sweep import reprocess_exponential as texp

N_DET = 3


@pytest.fixture(scope="module")
def copies(tmp_path_factory):
    return sweep_copies(tmp_path_factory.mktemp("reprocess"))


def _text(path):
    with open(path, encoding="utf-8") as f:
        return f.read()


def _files(base):
    return {
        os.path.relpath(os.path.join(root, f), base)
        for root, _, files in os.walk(base)
        for f in files
    }


@pytest.mark.parametrize("window", [0, 35])
def test_reprocess_sweep_json_equals_reference(copies, window):
    jdir, tdir = copies
    want = jrep.reprocess_sweep(jdir, window)
    got = trep.reprocess_sweep(tdir, window)
    name = "summary_reprocessed.json" if window == 0 else f"summary_reprocessed_win{window}.json"
    assert os.path.basename(got) == os.path.basename(want) == name
    assert os.path.dirname(got) == tdir
    assert _text(got) == _text(want)
    rows = json.loads(_text(got))["sweep_results"]
    assert len(rows) == N_DET


def test_reprocess_at_the_original_window_reproduces_the_summary(copies):
    """Every metric of the sweep's own summary.json, NaN for NaN."""
    _, tdir = copies
    with open(trep.reprocess_sweep(tdir, 0), encoding="utf-8") as f:
        rp = json.load(f)
    with open(os.path.join(tdir, "summary.json"), encoding="utf-8") as f:
        orig = json.load(f)
    assert rp["global_params"]["coarse_window_reprocessed"] == orig["global_params"]["coarse_window"]
    assert len(rp["sweep_results"]) == len(orig["sweep_results"]) == N_DET
    for new, old in zip(rp["sweep_results"], orig["sweep_results"]):
        assert set(new) - set(old) == {"delta_I_z_slope_center", "abs_delta_I_z_slope_center"}
        for key, val in old.items():
            assert new[key] == val or (np.isnan(new[key]) and np.isnan(val)), key


def test_reprocess_exponential_json_equals_reference(copies):
    jdir, tdir = copies
    want = jexp.reprocess_exponential(jdir, make_plots=False)
    got = texp.reprocess_exponential(tdir, make_plots=False)
    assert os.path.relpath(got, tdir) == os.path.relpath(want, jdir)
    assert _text(got).replace(tdir, "<sweep>") == _text(want).replace(jdir, "<sweep>")
    out = json.loads(_text(got))
    assert out["coarse_window"] == 20 and out["sweep_dir"] == os.path.abspath(tdir)
    assert len(out["rows"]) == N_DET
    statuses = {r[f"status_{s}"] for r in out["rows"] for s in ("off", "on")}
    assert statuses == {"OK", "FLAT", "TOO_FEW", "BAD_FIT"}


def test_reprocess_exponential_other_window_and_missing_trace(copies, tmp_path):
    jdir, tdir = copies
    outs = []
    for src in (jdir, tdir):
        dst = tmp_path / os.path.basename(os.path.dirname(src))
        shutil.copytree(src, dst)
        os.remove(dst / "delta_p25000.0Hz" / "time_and_obs_center_on.npz")
        outs.append(str(dst))
    want = jexp.reprocess_exponential(outs[0], coarse_window=10, make_plots=False)
    got = texp.reprocess_exponential(outs[1], coarse_window=10, make_plots=False)
    assert _text(got).replace(outs[1], "<sweep>") == _text(want).replace(outs[0], "<sweep>")
    rows = json.loads(_text(got))["rows"]
    assert [r["status_on"] for r in rows].count("MISSING") == 1


def _pdf_pages(path):
    with open(path, "rb") as f:
        return len(re.findall(rb"/Type\s*/Page[^s]", f.read()))


def test_plotted_reprocessing_writes_the_same_files(copies):
    jdir, tdir = copies
    for pkg_dir, rep, exp in ((jdir, jrep, jexp), (tdir, trep, texp)):
        rep.reprocess_sweep(pkg_dir, 35, make_plots=True)
        exp.reprocess_exponential(pkg_dir, make_plots=True)
    files = _files(tdir)
    assert files == _files(jdir)
    for name in ("reprocessed_win35_report.pdf", "exponential_metrics_report.pdf",
                 "graphs_exponential/exp_fit_on_p0.0Hz.png",
                 "graphs_exponential/tau_s_vs_eta_on.png"):
        assert name in files, name
        assert os.path.getsize(os.path.join(tdir, name)) > 0, name
    # the parameter page, four pages per point, then the reprocessor's four
    # tail pages (two tables, two scatters)
    pdfs = [os.path.join(d, "reprocessed_win35_report.pdf") for d in (tdir, jdir)]
    assert _pdf_pages(pdfs[0]) == _pdf_pages(pdfs[1]) == 1 + 4 * N_DET + 4


def test_find_sweep_and_detuning_dirs_equal_reference(copies):
    jdir, tdir = copies
    jroot, troot = os.path.dirname(jdir), os.path.dirname(tdir)
    got = [os.path.relpath(d, troot) for d in trep.find_sweep_dirs(troot)]
    assert got == [os.path.relpath(d, jroot) for d in jrep.find_sweep_dirs(jroot)]
    assert got == [POST_SWEEP_NAME]
    got = [os.path.relpath(d, tdir) for d in texp.discover_detuning_dirs(tdir)]
    assert got == [os.path.relpath(d, jdir) for d in jexp.discover_detuning_dirs(jdir)]
    assert got == ["delta_p0.0Hz", "delta_p25000.0Hz", "delta_p50000.0Hz"]
