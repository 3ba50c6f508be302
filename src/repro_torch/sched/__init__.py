"""Pluggable device-resident batch scheduling.

Port of ``repro.sched``. ISGD's premise is that batches deserve
*inconsistent* treatment: the paper varies per-batch **effort** (Alg. 2),
the related work varies per-batch **selection** (loss-proportional
sampling, Katharopoulos & Fleuret 2017; rank-based online batch selection,
Loshchilov & Hutter 2015). This package makes batch identity a policy
instead of the hard-wired FCPR ``t = j mod n_b``, and keeps the
device-resident fast path: selection runs on the device, inside the fused
engine's CUDA graph, and a batch fetch is a gather from the
``DeviceRing`` epoch at a device index.

The ``BatchSchedule`` protocol (policies are frozen dataclasses of static
hyper-parameters; state is a dict of tensors):

  * ``init(n_batches, device) -> state`` — loss table, visit counters, ...;
  * ``select(state, step, key) -> (batch_idx, state)`` — ``key`` is
    ``policies.fold_in(seed, step)``, a pure function of the step index;
  * ``update(state, batch_idx, loss) -> state`` — feed back the batch's ψ.

FCPR bit-exactness contract: :class:`FCPRSchedule` threaded through a
scheduled engine reproduces the unscheduled engines bit for bit (its
``select`` is the same integer remainder, its ``update`` the identity, and
it keeps the FIFO queue push); ``repro_torch.sched.parity`` pins it.

ψ-window caveat: under loss-prop or rank selection the last n_b losses
oversample hot batches, so table policies set ``uses_table=True`` and the
step writes the loss queue per batch (``control.push_at`` at slot
``batch_idx``): ψ̄ and kσ are taken over one entry per batch, and the
warm-up sweep fills the table in slot order.

The draws cannot match the reference's ``jax.random.categorical`` draw for
draw; they are a pure function of ``(seed, step, table)``
(``policies.fold_in``), so a resumed run and the fused engine draw what an
uninterrupted per-step run draws.
"""
from __future__ import annotations

import importlib

# lazy, as the reference: the engine module imports the training package,
# which imports this one's policies only when a schedule is given
_EXPORTS = {
    "FCPRSchedule": "repro_torch.sched.policies",
    "LossPropSchedule": "repro_torch.sched.policies",
    "RankSchedule": "repro_torch.sched.policies",
    "schedule_from_spec": "repro_torch.sched.policies",
    "make_scheduled_body": "repro_torch.sched.engine",
    "chunk_over_schedule": "repro_torch.sched.engine",
    "run_sched_parity": "repro_torch.sched.parity",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(mod), name)


def __dir__():
    return sorted(_EXPORTS)
