"""Persistent compile cache: a named no-op in this port.

The JAX package points JAX's persistent XLA compilation cache at a
directory here (its remote TPU compiles cost minutes), and every entry point
calls :func:`enable_persistent_compile_cache` before the first dispatch.
PyTorch runs eager and has no XLA cache; the hand-written kernels are built
once per machine by nvcc into ``build/torch_kernels/`` (kernels/_build.py),
which is their cache.  The function keeps the call sites (``cli/simulate.py``)
the same as the JAX package's.
"""

from __future__ import annotations


def enable_persistent_compile_cache(path: str | None = None) -> str | None:
    """No-op; returns None (no compile cache is switched on)."""
    return None
