"""Device selection shared by the port's entry points.

Entry points take an explicit ``device=`` argument that defaults to
``"cuda"``.  Asking for CUDA on a machine without it raises: the port never
falls back to the CPU on its own.  Callers that want the host (the tests)
pass ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the host"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device: {device!r}")
    return dev
