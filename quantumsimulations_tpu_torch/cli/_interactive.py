"""Interactive fallbacks for the reference's zero-argument CLI workflow.

The reference's post-processing scripts double-click from a file manager:
a tkinter folder picker selects the sweep root and ``input()`` asks for the
coarse window (reprocess_sweep_results.py:807-860, 2D_sweep_report.py:54-77).
Compute hosts are headless, so our CLIs are argparse-first — but when a
positional root is omitted these helpers recreate the reference behavior:
a tkinter picker if a display is available, a terminal prompt otherwise.

Port of ``quantumsimulations_tpu/cli/_interactive.py`` (the same behaviour).
"""

from __future__ import annotations

import os
import sys


def _display_available() -> bool:
    if sys.platform.startswith("win") or sys.platform == "darwin":
        return True
    return bool(os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY"))


def pick_root_dir(title: str, initial_dir: str = ".") -> str | None:
    """Choose a root directory interactively.

    Mirrors the reference's `_choose_root_dir` / `pick_root_dir_via_ui`:
    a tkinter folder picker when a display exists, otherwise a terminal
    prompt.  Returns None when the user cancels / enters nothing.
    """
    if _display_available():
        try:
            import tkinter as tk
            from tkinter import filedialog

            ui = tk.Tk()
            ui.withdraw()
            try:
                ui.attributes("-topmost", True)
            except Exception:
                pass
            selected = filedialog.askdirectory(
                title=title, initialdir=os.path.abspath(initial_dir),
                mustexist=True,
            )
            try:
                ui.destroy()
            except Exception:
                pass
            if selected:
                return selected
            return None
        except Exception:
            pass  # no usable tkinter: fall through to the terminal prompt
    if not sys.stdin.isatty():
        return None
    try:
        entered = input(f"{title}\npath: ").strip()
    except (EOFError, KeyboardInterrupt):
        return None
    return entered or None


def prompt_int(prompt: str, default: int) -> int:
    """`input()` an integer with a default, like the reference's window
    prompt (reprocess_sweep_results.py:842-849)."""
    if not sys.stdin.isatty():
        return default
    try:
        raw = input(f"{prompt} (integer, default {default}): ").strip()
        return int(raw) if raw else default
    except (EOFError, KeyboardInterrupt):
        return default
    except ValueError:
        print(f"Invalid value, using default {default}.")
        return default
