"""Launcher of the port's multi-rank CPU runs (not collected by pytest).

``RankRun(world, case, out_dir)`` starts ``world`` fresh interpreters of
``tests/_torch_mp_worker.py``, one per rank, joined into one gloo process
group through a ``file://`` rendezvous under ``out_dir`` (so that test files
running side by side never share a port).  Each worker runs one named case
and rank 0 writes its results to ``out_dir/<case>.npz``.  The ranks run in
the background while the caller computes its references; ``result()`` waits
for them.  Every rank is killed at the deadline (or at ``close()``), and a
rank that fails or times out fails the caller with every rank's output, so
that no run can hang the suite.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "_torch_mp_worker.py")


class RankRun:
    def __init__(self, world: int, case: str, out_dir: str, timeout: float = 240.0):
        os.makedirs(out_dir, exist_ok=True)
        self.world, self.case, self.out_dir, self.timeout = world, case, out_dir, timeout
        env = {k: v for k, v in os.environ.items()
               if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
        env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")
        rdv = os.path.join(out_dir, f"rdv_{case}")
        self.logs = [os.path.join(out_dir, f"{case}_rank{r}.log") for r in range(world)]
        self.procs = []
        for r in range(world):
            with open(self.logs[r], "w", encoding="utf-8") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, WORKER, case, str(r), str(world), rdv, out_dir],
                    stdout=log, stderr=subprocess.STDOUT, env=env, cwd=os.path.dirname(HERE),
                ))
        self.deadline = time.monotonic() + timeout
        self._result = None

    def close(self) -> list[int]:
        """Kill every rank still running; returns their ranks."""
        alive = [r for r, p in enumerate(self.procs) if p.poll() is None]
        for r in alive:
            self.procs[r].kill()
        for p in self.procs:
            p.wait()
        return alive

    def result(self) -> dict:
        """Rank 0's results as a dict of numpy arrays (waits for the ranks,
        at most until the deadline)."""
        if self._result is not None:
            return self._result
        try:
            for p in self.procs:
                p.wait(timeout=max(0.1, self.deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
        timed_out = self.close()
        failed = [r for r, p in enumerate(self.procs) if p.returncode != 0]
        if failed:
            text = []
            for r in range(self.world):
                with open(self.logs[r], encoding="utf-8", errors="replace") as f:
                    text.append(f"--- rank {r} (rc {self.procs[r].returncode}) ---\n"
                                f"{f.read()[-4000:]}")
            what = (f"timed out after {self.timeout:.0f} s: ranks {timed_out}" if timed_out
                    else f"ranks {failed} failed")
            raise AssertionError(f"{self.case} on {self.world} ranks {what}\n" + "\n".join(text))
        with np.load(os.path.join(self.out_dir, f"{self.case}.npz"), allow_pickle=False) as z:
            self._result = {k: z[k] for k in z.files}
        return self._result


def rank_run_fixture(world: int, case: str, timeout: float = 240.0):
    """A module-scoped pytest fixture body: start the ranks, hand the run to
    the tests, kill whatever is left at the module's end."""
    def fixture(tmp_path_factory):
        run = RankRun(world, case, str(tmp_path_factory.mktemp(case)), timeout)
        yield run
        run.close()

    return fixture
