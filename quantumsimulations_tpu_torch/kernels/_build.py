"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exports a plain ``extern "C"`` interface and is
compiled on first use into ``build/torch_kernels/lib<name>.so`` beside the
package (the ``build/`` directory is git-ignored):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/torch_kernels/lib<name>.so csrc/<name>.cu

A library that is newer than its source is reused.  Nothing here runs at
import time: the CPU-only test environment has no nvcc and imports every
module.  nvcc is taken from ``$CUDA_HOME/bin``, then ``PATH``, then
``/usr/local/cuda/bin``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

#: every kernel source under csrc/ (one nvcc process each in build_all)
SOURCES = ("cmatmul_f32", "limb_matmul_canon", "ext_obs_diagonals", "z_expectations_f32",
           "int8_gemm", "ext_carry")

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        candidates.append(which)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def build(name: str, extra_flags: tuple[str, ...] = (), timeout: float = 600.0) -> str:
    """Compile ``csrc/<name>.cu`` if its library is missing or stale.

    Returns nvcc's combined output ("" when the library was reused).  The
    library is written under a temporary name and renamed into place, so a
    concurrent or interrupted build never leaves a half-written file.
    """
    src = CSRC_DIR / f"{name}.cu"
    out = library_path(name)
    if out.exists() and out.stat().st_mtime >= src.stat().st_mtime and not extra_flags:
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f".lib{name}.", suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, *extra_flags, "-o", tmp, str(src)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {src.name} (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return proc.stdout + proc.stderr


def build_all(
    names: tuple[str, ...] = SOURCES, extra_flags: tuple[str, ...] = (), timeout: float = 600.0
) -> dict[str, tuple[str, float]]:
    """Build several sources at once, one nvcc process each, all started
    together.  Returns {name: (nvcc output, seconds)}; raises after every
    build has ended if any failed."""
    def one(name: str) -> tuple[str, float]:
        t0 = time.perf_counter()
        out = build(name, extra_flags=extra_flags, timeout=timeout)
        return out, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        futures = {name: pool.submit(one, name) for name in names}
        return {name: f.result() for name, f in futures.items()}


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``lib<name>.so``; cached per process."""
    lib = _loaded.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
