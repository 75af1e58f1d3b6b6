"""Statevector checkpointing for long stepping runs.

Port of ``quantumsimulations_tpu/dynamics/checkpoint.py``, with the same
NPZ/JSON formats, so that a snapshot written by the port resumes in the JAX
package and the other way round.  Two halves:

  * Krylov snapshots (``snapshot_path``, ``save_snapshot``,
    ``latest_snapshot``, ``krylov_propagate_traces_checkpointed``): one
    ``state_NNNNNNNN.npz`` per snapshot with the flat statevector planes and
    the output-grid cursor, a ``traces_partial.npz`` stash of the rows so
    far, and the run's ``params.json``.
  * Ext-advance snapshots (``save_ext_advance``, ``load_ext_advance``,
    ``clear_ext_advance``): the advance state only (state planes, step
    cursor, observable rows so far), tagged with a JSON fingerprint of the
    run.  On resume the operator is rebuilt (deterministically) and stepping
    continues bit-identically.
"""

from __future__ import annotations

import json
import os
import zipfile
from dataclasses import asdict

import numpy as np
import torch

from ..models.params import DipolarRareParams


def snapshot_path(ckpt_dir: str, step_index: int) -> str:
    return os.path.join(ckpt_dir, f"state_{step_index:08d}.npz")


def save_snapshot(
    ckpt_dir: str,
    step_index: int,
    psi: np.ndarray,
    params: DipolarRareParams | None = None,
    keep_last: int = 2,
) -> str:
    """Persist psi at output-step ``step_index``; prunes older snapshots."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = snapshot_path(ckpt_dir, step_index)
    tmp = path + ".tmp.npz"
    np.savez(tmp, re=np.real(psi), im=np.imag(psi), step_index=step_index)
    os.replace(tmp, path)
    if params is not None:
        with open(os.path.join(ckpt_dir, "params.json"), "w", encoding="utf-8") as f:
            json.dump(asdict(params), f, indent=2, default=float)
    snaps = sorted(
        f for f in os.listdir(ckpt_dir) if f.startswith("state_") and f.endswith(".npz")
    )
    for old in snaps[:-keep_last]:
        os.remove(os.path.join(ckpt_dir, old))
    return path


def latest_snapshot(ckpt_dir: str) -> tuple[int, np.ndarray] | None:
    """(step_index, psi) of the newest snapshot, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    snaps = sorted(
        f for f in os.listdir(ckpt_dir) if f.startswith("state_") and f.endswith(".npz")
    )
    if not snaps:
        return None
    data = np.load(os.path.join(ckpt_dir, snaps[-1]))
    return int(data["step_index"]), data["re"] + 1j * data["im"]


def krylov_propagate_traces_checkpointed(
    H,
    psi0: np.ndarray,
    times: np.ndarray,
    dims: tuple[int, ...],
    ckpt_dir: str,
    ckpt_every: int = 500,
    params: DipolarRareParams | None = None,
    m: int | None = None,
    theta: float | None = None,
    device: str | torch.device = "cuda",
) -> dict[str, np.ndarray]:
    """Krylov trace propagation with periodic snapshots and resume:
    {"site_xyz": (n, 3, T), "norm": (T,)}.

    On restart with the same ckpt_dir, stepping resumes from the newest
    snapshot; earlier rows come from the checkpoint's trace stash, which is
    written (atomically) before each snapshot.  ``device`` defaults to
    "cuda" (raises without CUDA)."""
    from ..utils.device import resolve_device
    from .krylov import KRYLOV_M, KRYLOV_THETA, make_krylov_step
    from .observables import site_xyz_expectations, state_norms

    dev = resolve_device(device)
    m = KRYLOV_M if m is None else m
    theta = KRYLOV_THETA if theta is None else theta
    times = np.asarray(times)
    T = len(times)
    dt = float(times[1] - times[0]) if T > 1 else 0.0
    step, _ = make_krylov_step(H, dt, m=m, theta=theta, device=dev)

    xyz = np.zeros((len(dims), 3, T))
    norms = np.zeros(T)
    os.makedirs(ckpt_dir, exist_ok=True)
    start = 0
    psi = psi0.astype(np.complex128)
    resume = latest_snapshot(ckpt_dir)
    trace_stash = os.path.join(ckpt_dir, "traces_partial.npz")
    if resume is not None and os.path.isfile(trace_stash):
        try:
            stash = np.load(trace_stash)
            start, psi = resume
            upto = min(start, T)
            xyz[..., :upto] = stash["xyz"][..., :upto]
            norms[:upto] = stash["norm"][:upto]
        except (OSError, KeyError, ValueError, EOFError, zipfile.BadZipFile):
            # a corrupt stash restarts from scratch rather than resuming
            # with a silently zeroed window
            start, psi = 0, psi0.astype(np.complex128)

    cur = torch.as_tensor(psi, dtype=torch.complex128, device=dev)
    for k in range(start, T):
        st = cur.reshape(-1, 1)
        xyz[..., k] = site_xyz_expectations(st, dims)[..., 0].cpu().numpy()
        norms[k] = float(state_norms(st)[0])
        if k + 1 < T:
            cur = step(cur)
        if ckpt_every and (k + 1) % ckpt_every == 0:
            # stash FIRST (atomically): the resume invariant is "the stash
            # covers at least up to the newest snapshot's step"
            tmp = trace_stash + ".tmp.npz"
            np.savez(tmp, xyz=xyz, norm=norms)
            os.replace(tmp, trace_stash)
            save_snapshot(ckpt_dir, k + 1, cur.cpu().numpy(), params=params)
    return {"site_xyz": xyz, "norm": norms}


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
