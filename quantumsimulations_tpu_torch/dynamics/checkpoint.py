"""Advance-state checkpoints for long stepping runs.

Port of the ext-advance part of ``quantumsimulations_tpu/dynamics/checkpoint.py``
(``_ext_advance_path``, ``save_ext_advance``, ``load_ext_advance``,
``clear_ext_advance``), with the same NPZ/JSON scheme, so that a snapshot
written by the port loads in the JAX package and the other way round.

A snapshot holds the advance state only: the state planes, the step cursor,
and the observable rows computed so far, tagged with a JSON fingerprint of
the run.  On resume the operator is rebuilt (deterministically) and stepping
continues bit-identically.  Not ported yet: the Krylov snapshot helpers
(``save_snapshot``, ``krylov_propagate_traces_checkpointed``), ROADMAP.md
queue 1 item 3.
"""

from __future__ import annotations

import json
import os

import numpy as np


def _ext_advance_path(ckpt_dir: str) -> str:
    return os.path.join(ckpt_dir, "ext_advance.npz")


def save_ext_advance(
    ckpt_dir: str,
    fingerprint: dict,
    done_blocks: int,
    rows_flats: list[np.ndarray],
    s_re_flat: np.ndarray,
    s_im_flat: np.ndarray,
) -> str:
    """Atomically persist the advance state after ``done_blocks``.

    The tmp name is unique per save (pid + block cursor), so two overlapping
    saves can never write into one file, and the rename installs a complete
    snapshot or none.
    """
    os.makedirs(ckpt_dir, exist_ok=True)
    path = _ext_advance_path(ckpt_dir)
    tmp = path + f".tmp.{os.getpid()}.{done_blocks}.npz"
    np.savez(
        tmp,
        fingerprint=json.dumps(fingerprint, sort_keys=True),
        done_blocks=done_blocks,
        rows_flat=np.concatenate(rows_flats) if rows_flats else np.empty(0),
        n_flats=len(rows_flats),
        s_re=s_re_flat,
        s_im=s_im_flat,
    )
    os.replace(tmp, path)
    return path


def load_ext_advance(ckpt_dir: str, fingerprint: dict):
    """(done_blocks, rows_flats, s_re_flat, s_im_flat) or None.

    A snapshot with a mismatched fingerprint (a different workload) is
    ignored, loudly, printing the differing keys: a silent None would
    restart a long trace from step 0 unnoticed.  A corrupt file restarts
    from scratch rather than resuming wrong.
    """
    path = _ext_advance_path(ckpt_dir)
    if not os.path.isfile(path):
        return None
    try:
        data = np.load(path)
        saved = json.loads(str(data["fingerprint"]))
        want = json.loads(json.dumps(fingerprint, sort_keys=True))
        if saved != want:
            diff = {
                k: (saved.get(k), want.get(k))
                for k in sorted(set(saved) | set(want))
                if saved.get(k) != want.get(k)
            }
            print(
                f"[checkpoint] WARNING: snapshot at {path} does not match "
                f"this run (saved vs requested: {diff}); restarting from "
                "step 0 — pass matching arguments (e.g. the original "
                "arithmetic tier) to resume it",
                flush=True,
            )
            return None
        done = int(data["done_blocks"])
        n_flats = int(data["n_flats"])
        rows_flat = data["rows_flat"]
        flats = [np.asarray(a) for a in np.split(rows_flat, n_flats)] if n_flats else []
        return done, flats, data["s_re"], data["s_im"]
    except Exception:
        return None


def clear_ext_advance(ckpt_dir: str) -> None:
    """Remove the snapshot and any orphaned per-save tmp files."""
    base = os.path.basename(_ext_advance_path(ckpt_dir))
    try:
        names = os.listdir(ckpt_dir)
    except OSError:
        return
    for name in names:
        if name == base or name.startswith(base + ".tmp."):
            try:
                os.remove(os.path.join(ckpt_dir, name))
            except OSError:
                pass
