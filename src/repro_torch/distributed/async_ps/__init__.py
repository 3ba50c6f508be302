"""Async parameter-server ISGD engine (paper §6.2): staleness-bounded
workers against a server-side SPC controller.

Port of ``repro.distributed.async_ps``. The paper's second scaling mode
runs ISGD on a heterogeneous system: workers compute gradients and ψ on
their own batches and push to a parameter server asynchronously. This
package maps that onto one process, the workers being threads (as in the
reference):

  * :class:`~repro_torch.distributed.async_ps.server.ParamServer`:
    canonical ``(params, base-rule state)`` plus the ψ control queue. The
    SPC limit/accelerate logic runs **server-side** (``observe``), so
    undertrained-batch detection uses globally consistent, globally ordered
    loss statistics even when workers race; pushed deltas are folded in
    staleness-weighted: ``new = old + w(τ)·(final − snapshot)``. The port's
    tensors are mutable, so the server copies at its boundary and never
    writes a tensor it handed out (its module doc);
  * :class:`~repro_torch.distributed.async_ps.worker.Worker` /
    ``make_worker_fns``: the synchronous step body split at its two server
    round trips, reusing ``make_loss_and_grad``, the base ``rule.apply``
    and ``solve_subproblem`` under a
    :class:`~repro_torch.core.reduce.StalenessReduce` context (loss and
    gradients stay local, so Alg. 2 is per-worker deterministic). Each
    worker trains a replica of its own;
  * :class:`~repro_torch.distributed.async_ps.coordinator.AsyncPSCoordinator`:
    N threads over per-worker FCPR shards behind a bounded-staleness (SSP)
    gate, every thread on the device's default stream.

Staleness semantics (pinned by ``tests/test_torch_async_ps.py``):

  * ``w(τ)`` is configurable via ``StalenessReduce``: ``1/(1+ατ)``
    (default), ``exp(-ατ)``, or ``1`` — always ``w(0) = 1``;
  * τ is the number of pushes applied between a worker's pull and its own
    push; the gate bounds it by ``(2·max_staleness + 1)·(workers − 1)``;
  * ``max_staleness=0`` forces lockstep rounds — the synchronous schedule.
    With one worker every τ is 0, pushes are exact replacements, and the
    engine is **bit-exact** with the synchronous per-step engine (losses,
    limits, accelerate decisions, final params), including under a
    ψ̄-dependent LR: workers read ψ̄ from the pulled queue *before* their
    loss reaches the server, the one-step lag of the other engines.

Elasticity (eviction, re-striping, durability):

  * **Eviction vs the SSP bound.** With ``elastic=True`` a worker that
    misses the heartbeat deadline while blocking the SSP clock — or whose
    own step raises — is *evicted*: removed from the gate's ``min()`` (so
    survivors advance), fenced at the server (late pushes rejected via
    :class:`~repro_torch.distributed.async_ps.errors.WorkerEvicted`). The
    clock's ``min()`` ranges over a *shrinking* set, so no surviving worker
    observes more staleness than the pre-eviction bound allowed.
  * **Re-striping vs "one ψ window = one epoch".** The evicted worker's
    FCPR shard is re-striped across the M survivors
    (:meth:`~repro_torch.distributed.async_ps.coordinator.ShardedFeed.restripe`);
    for up to one epoch after the change the ψ window means "≈ one epoch's
    worth of pushes" rather than exactly one pass.
  * **Checkpoints commit at pushes.** ``ParamServer.engine_snapshot`` /
    ``load_snapshot`` (and the ``checkpoint_fn`` hook, called under the
    server lock) capture params, base, ψ queue, version and the per-worker
    push clocks together, so a resumed run replays exactly the steps whose
    pushes never landed — with one worker this resume is **bit-exact**
    (``repro_torch.train.resume_parity``).
  * Failures that cannot be absorbed (non-elastic stall, last survivor
    crashing, retry exhaustion) surface as
    :class:`~repro_torch.distributed.async_ps.errors.WorkerFailure`
    carrying the worker thread's formatted traceback, with the original
    exception chained as ``__cause__``.
"""
from __future__ import annotations

import importlib

# Lazy exports, like the parent package: ``python -m …async_ps.parity`` must
# be runnable without this __init__ eagerly importing the submodule first.
_EXPORTS = {
    "StalenessReduce": "repro_torch.core.reduce",
    "staleness_reduce_from_spec": "repro_torch.core.reduce",
    "AsyncPSCoordinator": "repro_torch.distributed.async_ps.coordinator",
    "StalenessGate": "repro_torch.distributed.async_ps.coordinator",
    "ShardedFeed": "repro_torch.distributed.async_ps.coordinator",
    "records_to_trainlog": "repro_torch.distributed.async_ps.coordinator",
    "snapshot_engine_kwargs": "repro_torch.distributed.async_ps.coordinator",
    "snapshot_from_checkpoint": "repro_torch.distributed.async_ps.coordinator",
    "run_async_parity": "repro_torch.distributed.async_ps.parity",
    "ParamServer": "repro_torch.distributed.async_ps.server",
    "Snapshot": "repro_torch.distributed.async_ps.server",
    "Decision": "repro_torch.distributed.async_ps.server",
    "Worker": "repro_torch.distributed.async_ps.worker",
    "make_worker_fns": "repro_torch.distributed.async_ps.worker",
    "WorkerStalled": "repro_torch.distributed.async_ps.errors",
    "WorkerEvicted": "repro_torch.distributed.async_ps.errors",
    "PushRejected": "repro_torch.distributed.async_ps.errors",
    "WorkerFailure": "repro_torch.distributed.async_ps.errors",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(mod), name)


def __dir__():
    return sorted(_EXPORTS)
