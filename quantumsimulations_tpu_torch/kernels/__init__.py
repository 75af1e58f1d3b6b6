"""Hand-written CUDA kernels of the port: build, load, and launch counts.

``launch_counts`` holds one plain integer per kernel wrapper.  A wrapper adds
one where it launches its kernel and nowhere else, so a run can show that its
main path really went through the kernel (``chip_smoke.py`` zeroes the counts
before the path and reads them after).
"""

from __future__ import annotations

launch_counts: dict[str, int] = {"cmatmul_f32": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0
