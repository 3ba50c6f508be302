"""Device selection shared by the port's entry points.

The default is the card. A run on the CPU happens only when the caller
asks for it by name: nothing here slides to the CPU on its own.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """-> ``torch.device``; raises when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: repro_torch runs on the GPU by default; "
            "pass device='cpu' (--device cpu) to run on the CPU")
    return dev
