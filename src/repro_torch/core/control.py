"""Statistical-process-control loss tracking (paper §4.1, Alg.1 lines 13–20).

Port of ``repro.core.control``. A fixed-length FIFO of the last ``n_b``
batch losses (one epoch under FCPR sampling) with O(1) running Σ and Σ².
The upper control limit is ψ̄ + kσ (Eq. 15), and +inf until ``n_b`` losses
have been seen, so the subproblem never fires before one full epoch.

The queue is a tuple of tensors on the training device, updated
functionally (each push returns a new queue): nothing here reads a value
back to the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


def _sq(x):
    """x² via an exact 12/12-bit split, immune to fma contraction.

    Masking the low 12 mantissa bits splits x = hi + lo with at most 12
    significant bits each, so hi², 2·hi·lo and lo² are exact in f32 and
    only the adds (in this fixed association) round. The result is the same
    on every device and compiler, and equal bit for bit to the JAX
    package's ``control._sq``."""
    hi = (x.view(torch.int32) & -4096).view(torch.float32)
    lo = x - hi
    return (hi * hi + 2.0 * (hi * lo)) + lo * lo


class LossQueue(NamedTuple):
    buf: torch.Tensor        # (n_b,) f32 ring buffer
    total: torch.Tensor      # Σ losses in window
    total_sq: torch.Tensor   # Σ losses² in window
    count: torch.Tensor      # observed so far (saturates at n_b), int32
    idx: torch.Tensor        # ring position, int32


def init_queue(n_b: int, device="cuda") -> LossQueue:
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return LossQueue(buf=torch.zeros((n_b,), **f32),
                     total=torch.zeros((), **f32),
                     total_sq=torch.zeros((), **f32),
                     count=torch.zeros((), **i32),
                     idx=torch.zeros((), **i32))


def _write(q: LossQueue, slot, loss, drop_old):
    """Shared body of ``push``/``push_at``: replace ``buf[slot]`` by
    ``loss``, removing the old entry from Σ/Σ² where ``drop_old``."""
    sl = slot.long().reshape(1)
    old = q.buf.index_select(0, sl).reshape(())
    zero = torch.zeros_like(old)
    total = q.total + loss - torch.where(drop_old, old, zero)
    total_sq = q.total_sq + _sq(loss) - torch.where(drop_old, _sq(old), zero)
    buf = q.buf.index_put((sl,), loss.reshape(1))
    return buf, total, total_sq


def push(q: LossQueue, loss) -> LossQueue:
    """O(1) ring-buffer update: dequeue the stale loss, enqueue the new one."""
    loss = torch.as_tensor(loss, dtype=torch.float32, device=q.buf.device)
    n_b = q.buf.shape[0]
    buf, total, total_sq = _write(q, q.idx, loss, q.count >= n_b)
    return LossQueue(buf=buf, total=total, total_sq=total_sq,
                     count=torch.clamp(q.count + 1, max=n_b),
                     idx=(q.idx + 1) % n_b)


def push_at(q: LossQueue, slot, loss) -> LossQueue:
    """O(1) per-batch table write: replace the loss at position ``slot``
    (the batch index) instead of dequeuing FIFO. ``mean``/``std`` mask to
    slots ``< count``, so callers fill slots ``0..n_b-1`` in order first."""
    dev = q.buf.device
    loss = torch.as_tensor(loss, dtype=torch.float32, device=dev)
    slot = torch.as_tensor(slot, dtype=torch.int32, device=dev)
    n_b = q.buf.shape[0]
    buf, total, total_sq = _write(q, slot, loss, slot < q.count)
    return LossQueue(buf=buf, total=total, total_sq=total_sq,
                     count=torch.clamp(torch.maximum(q.count, slot + 1),
                                       max=n_b),
                     idx=(slot + 1) % n_b)


def mean(q: LossQueue):
    return q.total / torch.clamp(q.count, min=1).to(torch.float32)


def std(q: LossQueue):
    """From the masked buffer, not from Σ² − mean²: f32 cancellation makes
    the latter unusable once the losses are small against their size."""
    n_b = q.buf.shape[0]
    m = mean(q)
    valid = (torch.arange(n_b, device=q.buf.device) < q.count).to(torch.float32)
    var = torch.sum(valid * (q.buf - m) ** 2) / torch.clamp(q.count, min=1)
    return torch.sqrt(torch.clamp(var, min=0.0))


def control_limit(q: LossQueue, k: float = 3.0):
    """Upper control limit ψ̄ + kσ (Eq. 15); +inf until one full epoch."""
    warm = q.count >= q.buf.shape[0]
    return torch.where(warm, mean(q) + k * std(q),
                       torch.full_like(q.total, float("inf")))
