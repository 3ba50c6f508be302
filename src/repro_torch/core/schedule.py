"""Loss-driven learning-rate schedule (paper §4.2 end / §5.2).

Port of ``repro.core.schedule``. Because ISGD iterations are inconsistent,
the LR is keyed on the running average loss ψ̄ (Alg.1 line 19) instead of
the iteration count. Each ``lr_fn`` maps ψ̄ (a 0-d f32 tensor) to a 0-d f32
tensor on the same device, so reading the LR never syncs the host.
"""
from __future__ import annotations

from typing import Sequence

import torch


def loss_driven_lr(thresholds: Sequence[float], lrs: Sequence[float]):
    """thresholds descending: lr = lrs[i] for psi_bar >= thresholds[i],
    else lrs[-1].  len(lrs) == len(thresholds) + 1."""
    if len(lrs) != len(thresholds) + 1:
        raise ValueError("loss_driven_lr needs len(lrs) == len(thresholds)+1")
    th = tuple(float(t) for t in thresholds)
    vals = tuple(float(v) for v in lrs)

    def lr_fn(psi_bar):
        psi_bar = torch.as_tensor(psi_bar, dtype=torch.float32)
        dev = psi_bar.device
        idx = torch.sum(psi_bar < torch.tensor(th, dtype=torch.float32,
                                               device=dev))
        return torch.tensor(vals, dtype=torch.float32, device=dev)[idx]

    return lr_fn


def constant_lr(lr: float):
    def lr_fn(psi_bar):
        dev = psi_bar.device if torch.is_tensor(psi_bar) else None
        return torch.tensor(lr, dtype=torch.float32, device=dev)
    return lr_fn


ALEXNET_SCHEDULE = loss_driven_lr([2.0, 1.2], [0.015, 0.0015, 0.00015])
