"""Device-resident scheduled step and chunk bodies.

Port of ``repro.sched.engine``. ``make_scheduled_body`` turns a step
function (``make_step_core``'s, or the device form's ``make_device_step``)
into a body that *selects* its batch on the device: draw ``t`` from the
policy at ``key = policies.fold_in(seed, j)``, gather batch ``t`` from the
epoch ring arrays at that device index, run the step, feed the batch loss
back to the policy. Nothing is read back to the host, so the fused engine
(``chunk_over_schedule``, a ``train.chunked.ChunkFn``) captures selection,
table update and gather into its CUDA graph with the step, and the capture
itself shows that selection adds no host sync: a capture fails on one.

The policy state is a dict of tensors updated in place, like the params
and the ISGD state, so the graph's static tensors stay valid and a
checkpoint restore (``train.checkpoints``) can copy into them.

SPC coupling: for ``uses_table`` policies the step writes the loss queue at
slot ``t`` (``control.push_at``) instead of FIFO, so ψ̄/σ/limit read the
per-batch loss table (``repro_torch.sched`` package doc). FCPR keeps the
FIFO push: bit for bit the unscheduled step.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.core.isgd import assign_
from repro_torch.sched.policies import fold_in
from repro_torch.train.chunked import METRICS, ChunkFn, gather_batch


def selection_counts(batch_idx, n_batches: int) -> np.ndarray:
    """Visit histogram over batches from a realized ``batch_idx`` sequence
    (a chunk's stacked metrics, or a whole run's)."""
    return np.bincount(np.asarray(batch_idx).ravel().astype(np.int64),
                       minlength=n_batches)


def make_scheduled_body(step_fn: Callable, schedule, n_batches: int,
                        seed: int = 0):
    """Wrap ``step_fn(state, params, batch, slot=None)`` into
    ``body(state, params, sched_state, ring_arrays, j, batch=None) ->
    (state, params, sched_state, metrics)`` with on-device selection.

    ``ring_arrays``: a ``DeviceRing``'s ``.arrays`` (``n_batches *
    batch_size`` leading rows); ``j``: the global step, an int or a 0-d
    int64 tensor on the device. ``batch``: tensors to gather into (the
    fused engine's static batch), else new ones. ``sched_state`` is
    updated in place. Metrics gain ``batch_idx``, the selected batch."""

    def body(state, params, sched_state, ring_arrays, j, batch=None):
        dev = next(iter(ring_arrays.values())).device
        key = fold_in(seed, j, device=dev)
        t, _ = schedule.select(sched_state, j, key)
        batch = gather_batch(ring_arrays, t, n_batches, out=batch)
        slot = t if schedule.uses_table else None
        state, params, metrics = step_fn(state, params, batch, slot=slot)
        assign_(sched_state, schedule.update(sched_state, t, metrics["loss"]))
        return state, params, sched_state, dict(metrics, batch_idx=t)

    return body


def chunk_over_schedule(step_fn: Callable, schedule, n_batches: int,
                        chunk_steps: int, seed: int = 0) -> ChunkFn:
    """Scheduled twin of ``train.chunked.chunk_over_ring``: K
    policy-selected ISGD steps per host dispatch. ``step_fn`` is the device
    form's. Returns ``chunk_fn(state, params, sched_state, ring_arrays,
    j0) -> (state, params, sched_state, stacked)``: the policy state is
    updated in place inside the chunk (on the card, inside its graph), so
    the table update of step j steers the selection of step j+1."""
    body = make_scheduled_body(step_fn, schedule, n_batches, seed)

    def chunk_body(carry, ring_arrays, j, batch):
        return body(*carry, ring_arrays, j, batch=batch)[3]

    return ChunkFn(chunk_body, n_batches, chunk_steps,
                   metrics=dict(METRICS, batch_idx=torch.int32))
