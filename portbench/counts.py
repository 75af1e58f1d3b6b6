"""The yardstick's frozen counts: int8 operations of the port's limb
products, bytes of its observables kernel, and the peaks of the card.

These are the least work a call needs, computed from shapes alone, so a
roofline share (least time over measured time) cannot pass 100%: a share
above 100% means the count here is too high or the measured time leaves out
part of the work.  Never clip it.

The counts restate the port's algorithms as they stand (the exact-limb
``ext`` chain and the Ozaki ``expm`` chain of
``dynamics/expm_propagator.py``, their products in ``ops/extprec.py``, and
the observables kernel ``csrc/ext_obs_diagonals.cu``).  A change to those
algorithms needs a new metric with its own counts, not an edit here.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

#: ext limbs and the guard diagonals kept below them (ops/extprec.py)
EXT_LIMBS = 15
EXT_GUARD = 2
#: Karatsuba: three int8 GEMMs per limb pair of a complex ext product
EXT_GEMMS_PER_PAIR = 3
#: Ozaki limbs of one float64 operand; a real product keeps every limb pair
#: of diagonal s <= OZAKI_LIMBS - 1
OZAKI_LIMBS = 11
#: product diagonals the observables kernel sums (q)
EXT_OBS_DIAG = 11
#: the ext route's output block and advance chunk (blocks per kernel call)
EXT_BLOCK = 512
EXT_ADV_CHUNK = 64
#: the Ozaki route's output block (four real products per block advance)
OZAKI_BLOCK = 128

_PEAKS = Path(__file__).resolve().parent / "peaks.json"


def ext_pairs() -> int:
    """Limb pairs (j, i) of a kept ext diagonal: j + i < L + G, both < L."""
    L, G = EXT_LIMBS, EXT_GUARD
    return sum(1 for j in range(L) for i in range(L) if j + i < L + G)


def ozaki_pairs() -> int:
    """Limb pairs of an Ozaki real product: j + i < N."""
    n = OZAKI_LIMBS
    return n * (n + 1) // 2


def ext_product_ops(m: int, k: int, n: int) -> float:
    """int8 operations (a multiply-add is two) of one complex ext product
    (m, k) @ (k, n): every kept limb pair, three Karatsuba GEMMs each."""
    return 2.0 * EXT_GEMMS_PER_PAIR * ext_pairs() * m * k * n


def ozaki_real_product_ops(m: int, k: int, n: int) -> float:
    """int8 operations of one float64-accurate real product (m, k) @ (k, n)."""
    return 2.0 * ozaki_pairs() * m * k * n


def chain_ops(route: str, dim: int, calls: dict[str, int], n_evolutions: int) -> float | None:
    """int8 operations of the step-operator chains of ``n_evolutions``
    evolutions, from the chain stages' call counts: one (dim)^3 complex
    product per ``horner`` and ``squarings`` call (ext), four real ones per
    call (Ozaki: a Horner step is four real products, a squaring one complex
    product); the k-th ``doubling`` call of an evolution multiplies the step
    operator's power into the 2^k seed states and squares it.  None where a
    stage is missing or its calls are not whole per evolution."""
    if n_evolutions <= 0 or any(s not in calls for s in ("horner", "squarings", "doubling")):
        return None
    if calls["doubling"] % n_evolutions:
        return None
    if route == "ext":
        def cprod(n): return ext_product_ops(dim, dim, n)
    elif route == "ozaki":
        def cprod(n): return 4.0 * ozaki_real_product_ops(dim, dim, n)
    else:
        return None
    square = cprod(dim)
    total = (calls["horner"] + calls["squarings"]) * square
    per_evo = sum(cprod(1 << k) + square for k in range(calls["doubling"] // n_evolutions))
    return total + n_evolutions * per_evo


def advance_ops(route: str, dim: int, steps: int) -> float | None:
    """int8 operations of one evolution's block advances: ext advances every
    block of every whole chunk (S <- B @ S, one complex product of a block);
    Ozaki every block but the last (four real products)."""
    if route == "ext":
        n_blocks = math.ceil(steps / EXT_BLOCK)
        chunk = min(EXT_ADV_CHUNK, n_blocks)
        return math.ceil(n_blocks / chunk) * chunk * ext_product_ops(dim, dim, EXT_BLOCK)
    if route == "ozaki":
        n_blocks = math.ceil(steps / OZAKI_BLOCK)
        return (n_blocks - 1) * 4.0 * ozaki_real_product_ops(dim, dim, OZAKI_BLOCK)
    return None


def ext_obs_columns(steps: int) -> int:
    """State columns the observables kernel reads in one evolution: every
    block of every whole advance chunk."""
    n_blocks = math.ceil(steps / EXT_BLOCK)
    chunk = min(EXT_ADV_CHUNK, n_blocks)
    return math.ceil(n_blocks / chunk) * chunk * EXT_BLOCK


def ext_obs_bytes(dim: int, columns: int) -> float:
    """HBM bytes the observables kernel must move for ``columns`` state
    columns at ``dim``: the q limbs of both planes read once, the (q, R)
    int32 sums written once, R = 3 n_sites + 1 rounded up to 8."""
    n_sites = dim.bit_length() - 1
    rows = -(-(3 * n_sites + 1) // 8) * 8
    return 2.0 * EXT_OBS_DIAG * dim * columns + 4.0 * EXT_OBS_DIAG * rows * columns


def card_peaks(name: str) -> dict | None:
    """The data-sheet peaks of the card called ``name`` (dense int8 OP/s,
    HBM bytes/s), or None for a card not in ``peaks.json``."""
    table = json.loads(_PEAKS.read_text())
    for entry in table["cards"]:
        if all(word in name for word in entry["match"]) and not any(
                word in name for word in entry.get("exclude", ())):
            return entry
    return None
