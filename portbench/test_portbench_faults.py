"""A run whose timed path is broken underneath comes out not correct.

Each case drives the rest of a run (``harness.run_cell`` on the CPU, the
look for a card skipped) on a small cell of each route, with one fault
planted in the port: a block advance that returns its state unchanged,
half of a block's states left out and filled from the other half, and one
answer altered where it is produced.  One card holds the whole cell, so
there is no exchange between cards to leave out.  On the CPU
``solver="expm"`` takes the dense complex128 chain (the Ozaki chain needs
the card): its faults are planted there."""

import time

import numpy as np
import pytest
import torch

import harness
from smallcells import limit_of, make_root, small_config, traffic_of

import quantumsimulations_tpu_torch.dynamics.evolve as evolve
import quantumsimulations_tpu_torch.dynamics.expm_propagator as expm
import quantumsimulations_tpu_torch.ops.extprec as extprec

BLOCK = 512  # the ext route's output block at 20,000 steps


def _ext_block_products(monkeypatch, fn):
    """Route every ext product of a (dim, BLOCK) block of states (the
    advance) through ``fn(bre, bim, product)``."""
    real = extprec.ext_cmatmul

    def patched(are, aim, bre, bim, panel=1024):
        if bre.shape[2] == BLOCK:
            return fn(bre, bim, lambda r, i: real(are, aim, r, i, panel=panel))
        return real(are, aim, bre, bim, panel=panel)

    monkeypatch.setattr(extprec, "ext_cmatmul", patched)


def state_unchanged_ext(monkeypatch):
    _ext_block_products(monkeypatch, lambda r, i, product: (r.clone(), i.clone()))


def half_left_out_ext(monkeypatch):
    def half(r, i, product):
        h = BLOCK // 2
        o_r, o_i = product(r[:, :, :h].contiguous(), i[:, :, :h].contiguous())
        return torch.cat([o_r, o_r], dim=2), torch.cat([o_i, o_i], dim=2)

    _ext_block_products(monkeypatch, half)


def answer_altered_ext(monkeypatch):
    real = expm._rows_host

    def patched(*args):
        rows = real(*args)
        rows[2, 17] += 0.5  # one Iz_sea value
        return rows

    monkeypatch.setattr(expm, "_rows_host", patched)


def state_unchanged_dense(monkeypatch):
    monkeypatch.setattr(expm, "_matrix_power", lambda U, p: torch.eye(U.shape[0], dtype=U.dtype))


def half_left_out_dense(monkeypatch):
    real = expm._propagate_blocks

    def patched(U, psi0, n_blocks, block, dims):
        xyz, nrm = real(U, psi0, n_blocks, block, dims)
        h = block // 2
        xyz[..., h:], nrm[..., h:] = xyz[..., :h], nrm[..., :h]
        return xyz, nrm

    monkeypatch.setattr(expm, "_propagate_blocks", patched)


def answer_altered_dense(monkeypatch):
    real = evolve.assemble_traces

    def patched(*args):
        out = real(*args)
        out["Iz_sea"] = np.array(out["Iz_sea"])
        out["Iz_sea"][17] += 0.5
        return out

    monkeypatch.setattr(evolve, "assemble_traces", patched)


CASES = [
    ("ext", 3, False, state_unchanged_ext),
    ("ext", 3, False, half_left_out_ext),
    ("ext", 3, False, answer_altered_ext),
    ("ext", 3, True, state_unchanged_ext),
    ("ext", 3, True, half_left_out_ext),
    ("ext", 3, True, answer_altered_ext),
    ("expm", 3, False, state_unchanged_dense),
    ("expm", 3, False, half_left_out_dense),
    ("expm", 3, False, answer_altered_dense),
]


def _run(tmp_path, solver: str, n_sea: int, s32: bool) -> dict:
    root = make_root(tmp_path, {"tiny": (small_config("bath-n12", n_sea, s32),
                                         traffic_of("ext", solver), limit_of())})
    return harness.run_cell(harness.load_cell(root, "tiny.tiny"), 2**40 + 3, 0.0, False, "cpu",
                            time.perf_counter())


@pytest.mark.parametrize("solver,n_sea,s32", sorted({c[:3] for c in CASES}))
def test_sound_run_is_correct(tmp_path, solver, n_sea, s32):
    result = _run(tmp_path, solver, n_sea, s32)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] == 1


@pytest.mark.parametrize("solver,n_sea,s32,fault", CASES,
                         ids=[f"{c[0]}-s{'32' if c[2] else '12'}-{c[3].__name__}" for c in CASES])
def test_fault_comes_out_not_correct(tmp_path, monkeypatch, solver, n_sea, s32, fault):
    fault(monkeypatch)
    result = _run(tmp_path, solver, n_sea, s32)
    assert not result["correct"] and result["failed"] == 1
    gap = result["compared"]["trace_gap.0"]["value"]
    assert gap is None or gap > limit_of()
