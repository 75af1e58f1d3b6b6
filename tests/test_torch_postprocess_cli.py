"""Port vs reference: the post-processing CLIs and their interactive fallbacks.

``cli.reprocess``, ``cli.reprocess_exponential`` and ``cli.report2d`` of
both packages run on two copies of one sweep tree (made by the JAX runner)
or of a synthetic root; they must write the same files, the same JSON text
and print the same lines (paths aside).  ``cli._interactive`` is compared
with stdin not a terminal and with ``input`` patched.
"""

import io
import json
import os
import shutil
import sys

import matplotlib
import numpy as np
import pytest

from _torch_parity import (  # noqa: F401
    make_synthetic_root,
    no_jax_compile_cache,
    sweep_copies,
)
from quantumsimulations_tpu.cli import _interactive as jint
from quantumsimulations_tpu.cli import report2d as jr2d
from quantumsimulations_tpu.cli import reprocess as jrep
from quantumsimulations_tpu.cli import reprocess_exponential as jexp
from quantumsimulations_tpu_torch.cli import _interactive as tint
from quantumsimulations_tpu_torch.cli import report2d as tr2d
from quantumsimulations_tpu_torch.cli import reprocess as trep
from quantumsimulations_tpu_torch.cli import reprocess_exponential as texp

matplotlib.use("Agg")


@pytest.fixture(scope="module")
def copies(tmp_path_factory):
    return sweep_copies(tmp_path_factory.mktemp("cli"))


def _files(base):
    return {
        os.path.relpath(os.path.join(root, f), base)
        for root, _, files in os.walk(base)
        for f in files
    }


def _text(path):
    with open(path, encoding="utf-8") as f:
        return f.read()


def _run(main, argv, capsys, root):
    """Run a CLI main; returns its printed lines with ``root`` replaced."""
    capsys.readouterr()
    main(argv)
    return capsys.readouterr().out.replace(root, "<root>")


def test_reprocess_cli_equals_reference(copies, capsys):
    jdir, tdir = copies
    jroot, troot = os.path.dirname(jdir), os.path.dirname(tdir)
    want = _run(jrep.main, [jroot, "--window", "40"], capsys, jroot)
    got = _run(trep.main, [troot, "--window", "40"], capsys, troot)
    assert got == want
    assert "[ok]" in got and "Found 1 sweep dir(s)" in got
    name = "summary_reprocessed_win40.json"
    assert _text(os.path.join(tdir, name)) == _text(os.path.join(jdir, name))
    # no --window: each sweep's own window
    assert _run(trep.main, [troot], capsys, troot) == _run(jrep.main, [jroot], capsys, jroot)
    assert _text(os.path.join(tdir, "summary_reprocessed.json")) == _text(
        os.path.join(jdir, "summary_reprocessed.json"))


def test_reprocess_cli_fences_each_sweep(copies, tmp_path, capsys):
    outs = []
    for pkg, src in zip(("jax", "port"), copies):
        root = tmp_path / pkg
        shutil.copytree(os.path.dirname(src), root)
        (root / "broken").mkdir()
        (root / "broken" / "summary.json").write_text("{not json")
        outs.append(str(root))
    want = _run(jrep.main, [outs[0], "--window", "30"], capsys, outs[0])
    got = _run(trep.main, [outs[1], "--window", "30"], capsys, outs[1])
    assert got == want
    assert "[fail] <root>/broken: JSONDecodeError" in got and "[ok]" in got
    assert _files(outs[1]) == _files(outs[0])


def test_reprocess_cli_without_sweeps_or_root(tmp_path, capsys, monkeypatch):
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    monkeypatch.setattr(sys, "stdin", io.StringIO(""))
    for argv in ([str(tmp_path)], []):
        outs = []
        for main in (jrep.main, trep.main):
            with pytest.raises(SystemExit) as exc:
                main(argv)
            outs.append((exc.value.code, capsys.readouterr().out))
        assert outs[0] == outs[1]
        assert outs[1][0] == 1


def test_reprocess_exponential_cli_equals_reference(copies, capsys):
    jdir, tdir = copies
    want = _run(jexp.main, ["--root", jdir, "--no-plots", "--window", "25"], capsys, jdir)
    got = _run(texp.main, ["--root", tdir, "--no-plots", "--window", "25"], capsys, tdir)
    assert got == want == "Wrote <root>/summary_exponential_metrics.json\n"
    name = "summary_exponential_metrics.json"
    assert _text(os.path.join(tdir, name)).replace(tdir, "<root>") == _text(
        os.path.join(jdir, name)).replace(jdir, "<root>")
    assert json.loads(_text(os.path.join(tdir, name)))["coarse_window"] == 25


def test_report2d_stable_equals_reference(copies, capsys):
    jdir, tdir = copies
    jroot, troot = os.path.dirname(jdir), os.path.dirname(tdir)
    want = _run(jr2d.main, [jroot, "--stable"], capsys, jroot)
    got = _run(tr2d.main, [troot, "--stable"], capsys, troot)
    assert got == want
    assert "Aggregated 3 points" in got and "Best stable region: x in [0.5, 0.5]" in got
    assert _text(os.path.join(troot, "stable_region_stats.json")) == _text(
        os.path.join(jroot, "stable_region_stats.json"))
    files = _files(troot)
    assert files == _files(jroot)
    for name in ("contrast_vs_coupling_summary.pdf", "graphs/01_contrast_vs_eta.png",
                 "graphs/04_abs_slope_diff_vs_scaled_detuning_zoom.png",
                 "graphs/05_pass_fraction_vs_scaled_detuning.png"):
        assert name in files, name


def test_report2d_options_and_legacy_summaries(tmp_path, capsys):
    """A synthetic root with custom thresholds, then one of legacy summaries
    only: the slope pages (03, 04) are skipped, in both packages."""
    for legacy in (False, True):
        outs = []
        for pkg, main in (("jax", jr2d.main), ("port", tr2d.main)):
            root = make_synthetic_root(str(tmp_path / f"{pkg}_{legacy}"), seed=7,
                                       legacy_only=legacy)
            pdf = os.path.join(root, "out", "report.pdf")
            stats = os.path.join(root, "stats.json")
            out = _run(main, [root, "-o", pdf, "--stable", "--c-min", "0.15", "--p-min", "0.6",
                              "--bin-decimals", "2", "--stable-json", stats], capsys, root)
            outs.append((out, _text(stats), _files(root)))
        assert outs[1] == outs[0]
        graphs = {f for f in outs[1][2] if f.startswith("out/graphs/")}
        pages = {"01_contrast_vs_eta", "02_contrast_vs_scaled_detuning",
                 "05_pass_fraction_vs_scaled_detuning"}
        if not legacy:
            pages |= {"03_abs_slope_diff_vs_eta_zoom", "04_abs_slope_diff_vs_scaled_detuning_zoom"}
        assert graphs == {f"out/graphs/{p}.png" for p in pages}


def test_report2d_without_points_exits(tmp_path, capsys):
    outs = []
    for main in (jr2d.main, tr2d.main):
        with pytest.raises(SystemExit) as exc:
            main([str(tmp_path)])
        outs.append((exc.value.code, capsys.readouterr().out))
    assert outs[0] == outs[1] and outs[1][0] == 2


@pytest.mark.parametrize("n_gray", [0, 3])
def test_scatter_points_counts_gray_points(n_gray):
    import matplotlib.pyplot as plt

    rng = np.random.default_rng(n_gray)
    x, y = rng.normal(size=12), rng.normal(size=12)
    color = rng.uniform(1.0, 80.0, 12)
    color[rng.choice(12, n_gray, replace=False)] = np.nan
    got = []
    for mod in (jr2d, tr2d):
        fig, ax = plt.subplots()
        got.append(mod._scatter_points(ax, x, y, color))
        got.append(ax.get_legend() is not None)
        plt.close(fig)
    assert got[:2] == got[2:] == [n_gray, n_gray > 0]


class _Tty(io.StringIO):
    def isatty(self):
        return True


@pytest.fixture
def headless(monkeypatch):
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    monkeypatch.setattr(sys, "platform", "linux")
    return monkeypatch


def _both(monkeypatch, stdin, answers, call):
    """call(module) in each package, with stdin and input() patched."""
    out = []
    for mod in (jint, tint):
        monkeypatch.setattr(sys, "stdin", stdin)
        feed = iter(answers)

        def fake_input(prompt="", feed=feed):
            ans = next(feed)
            if isinstance(ans, BaseException):
                raise ans
            return ans

        monkeypatch.setattr("builtins.input", fake_input)
        out.append(call(mod))
    return out


def test_interactive_without_a_terminal(headless):
    got = _both(headless, io.StringIO(""), [], lambda m: (
        m._display_available(), m.pick_root_dir("pick", "."), m.prompt_int("window", 50)))
    assert got[0] == got[1] == (False, None, 50)


@pytest.mark.parametrize(
    "answers,want",
    [(["  /data/run  "], "/data/run"), ([""], None), ([EOFError()], None),
     ([KeyboardInterrupt()], None)],
)
def test_pick_root_dir_prompts_on_a_terminal(headless, answers, want):
    got = _both(headless, _Tty(), answers, lambda m: m.pick_root_dir("pick"))
    assert got == [want, want]


def test_pick_root_dir_without_tkinter_falls_back_to_the_prompt(headless):
    headless.setenv("DISPLAY", ":99")
    headless.setitem(sys.modules, "tkinter", None)
    got = _both(headless, _Tty(), ["/x"], lambda m: (m._display_available(),
                                                      m.pick_root_dir("pick")))
    assert got == [(True, "/x"), (True, "/x")]


@pytest.mark.parametrize(
    "answers,want",
    [(["7"], 7), ([""], 50), (["abc"], 50), ([EOFError()], 50), ([KeyboardInterrupt()], 50)],
)
def test_prompt_int_on_a_terminal(headless, capsys, answers, want):
    got = _both(headless, _Tty(), answers, lambda m: (m.prompt_int("window", 50),
                                                      capsys.readouterr().out))
    assert got[0] == got[1]
    assert got[1][0] == want
