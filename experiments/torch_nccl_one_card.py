"""Two NCCL ranks on one CUDA device: what NCCL says.

    python3 experiments/torch_nccl_one_card.py

Starts two processes, both on ``cuda:0``, joins them into one NCCL process
group (a TCP rendezvous on 127.0.0.1) and runs one ``all_reduce`` of a small
float64 tensor.  NCCL is expected to refuse two ranks on one device
("Duplicate GPU detected"); this records whether it does and with what
message.  Each rank gets 90 s and is killed after that.  Prints the card's
name and power limit, each rank's outcome and a JSON summary line.  Imports
no JAX.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import socket
import subprocess
import sys
import traceback


def _rank(rank: int, port: int, conn) -> None:
    import datetime

    import torch
    import torch.distributed as dist

    try:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                                rank=rank, timeout=datetime.timedelta(seconds=60))
        try:
            x = torch.full((4,), float(rank + 1), dtype=torch.float64, device="cuda:0")
            dist.all_reduce(x)
            torch.cuda.synchronize()
            conn.send({"rank": rank, "ok": True, "result": x.tolist()})
        finally:
            dist.destroy_process_group()
    except Exception as e:  # the outcome is the measurement: report it
        conn.send({"rank": rank, "ok": False, "error": f"{type(e).__name__}: {e}"[-2000:],
                   "traceback": traceback.format_exc()[-3000:]})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_nccl_one_card: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(smi, flush=True)
    print(f"torch {torch.__version__}, NCCL {'.'.join(map(str, torch.cuda.nccl.version()))}, "
          f"{torch.cuda.device_count()} device(s)", flush=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    os.environ.setdefault("NCCL_DEBUG", "WARN")
    ctx = multiprocessing.get_context("spawn")
    pipes, procs = [], []
    for r in range(2):
        rx, tx = ctx.Pipe(duplex=False)
        p = ctx.Process(target=_rank, args=(r, port, tx), daemon=True)
        p.start()
        tx.close()
        pipes.append(rx)
        procs.append(p)
    outcomes = []
    for r, (p, rx) in enumerate(zip(procs, pipes)):
        got = rx.recv() if rx.poll(90) else {"rank": r, "ok": False,
                                               "error": "no answer in 90 s (killed)"}
        p.join(timeout=10)
        if p.is_alive():
            p.kill()
            p.join()
        got["exitcode"] = p.exitcode
        outcomes.append(got)
        print(f"rank {r}: {got}", flush=True)
    print(json.dumps({"card": smi, "two_ranks_one_card": [
        {k: v for k, v in o.items() if k != "traceback"} for o in outcomes]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
