"""Loss-driven learning-rate schedule (paper §4.2 end / §5.2).

Port of ``repro.core.schedule``. Because ISGD iterations are inconsistent,
the LR is keyed on the running average loss ψ̄ (Alg.1 line 19) instead of
the iteration count. Each ``lr_fn`` maps ψ̄ (a 0-d f32 tensor) to a 0-d f32
tensor on the same device, so reading the LR never syncs the host.

The constants are put on a device once, at the first call that meets that
device, and indexed there afterwards: a call makes no host-to-device copy,
so an ``lr_fn`` can run inside a CUDA-graph capture (the chunked engine,
``repro_torch.train.chunked``) once it has run outside one.
"""
from __future__ import annotations

from typing import Sequence

import torch


def loss_driven_lr(thresholds: Sequence[float], lrs: Sequence[float]):
    """thresholds descending: lr = lrs[i] for psi_bar >= thresholds[i],
    else lrs[-1].  len(lrs) == len(thresholds) + 1."""
    if len(lrs) != len(thresholds) + 1:
        raise ValueError("loss_driven_lr needs len(lrs) == len(thresholds)+1")
    consts = _on_device((tuple(float(t) for t in thresholds),
                         tuple(float(v) for v in lrs)))

    def lr_fn(psi_bar):
        psi_bar = torch.as_tensor(psi_bar, dtype=torch.float32)
        th, vals = consts(psi_bar.device)
        idx = torch.sum(psi_bar < th).reshape(1)
        return torch.index_select(vals, 0, idx).reshape(())

    return lr_fn


def constant_lr(lr: float):
    consts = _on_device((float(lr),))

    def lr_fn(psi_bar):
        dev = psi_bar.device if torch.is_tensor(psi_bar) else torch.device("cpu")
        return consts(dev)[0]
    return lr_fn


def _on_device(values: tuple):
    """-> ``get(device)``: ``values`` as f32 tensors on ``device``, made at
    the first request for that device and the same tensors afterwards.
    Callers only read them."""
    made = {}

    def get(device):
        hit = made.get(device)
        if hit is None:
            hit = made[device] = tuple(
                torch.tensor(v, dtype=torch.float32, device=device)
                for v in values)
        return hit
    return get


ALEXNET_SCHEDULE = loss_driven_lr([2.0, 1.2], [0.015, 0.0015, 0.00015])
