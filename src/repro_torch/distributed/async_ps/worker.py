"""Worker: the synchronous step body, split at its two server round trips.

Port of ``repro.distributed.async_ps.worker``. ``make_worker_fns`` builds
the SAME primitives ``core.isgd.isgd_step`` composes —
``make_loss_and_grad``, the base ``rule.apply``, Alg. 2's
``solve_subproblem`` — into two pieces:

  * ``propose(params, base, queue, batch)``: loss and gradients on the
    worker's replica, loaded with the pulled (possibly stale) snapshot,
    then the vanilla base update (Alg.1 line 21). The loss-driven LR is
    read from the snapshot's queue *before* this step's loss reaches the
    server, the one-step lag the per-step and fused engines keep (Alg.1
    line 19);
  * ``accelerate(params1, batch, limit, loss, lr)``: the conservative
    subproblem (Eq. 17) from the post-update weights, driven by the
    *server's* control limit.

The three run in ``isgd_step``'s order (LR, ``loss_and_grad``,
``rule.apply``; the server's push and limit; Alg. 2), so one worker at
staleness 0 is the per-step engine bit for bit.

**A replica per worker.** The reference jits one ``(propose,
accelerate)`` pair over pure functions of the params and shares it across
threads. The port's ``loss_fn(batch)`` reads a module's own leaves
(``train.trainer.make_loss_and_grad``), and the base rule and Alg. 2 write
them in place, so each worker owns a replica (its own module, params and
base state): at each step it copies the pulled snapshot into the replica,
trains the replica, and keeps the snapshot for the server's τ > 0 fold.

Robustness: the loop carries the fault-injection hooks
(``FaultPlan.before_step`` / ``slow_factor`` / ``on_transit``, no-ops by
default), heartbeats the gate between its server round trips so that long
healthy steps never trip the stall deadline, retries rejected/transient
pushes with exponential backoff, and, on a real failure, keeps the
formatted traceback before the thread dies so that the coordinator can
raise it with the original frames.
"""
from __future__ import annotations

import time
import traceback
from typing import Callable, Optional

import torch

from repro_torch.core import control
from repro_torch.core.isgd import ISGDConfig, assign_, solve_subproblem
from repro_torch.core.reduce import ReduceCtx, StalenessReduce
from repro_torch.distributed.async_ps.errors import PushRejected, WorkerEvicted
from repro_torch.fault.plan import NO_FAULTS, FaultPlan, TransientPushError
from repro_torch.optim.base import UpdateRule
from repro_torch.train.trainer import make_loss_and_grad


def make_worker_fns(loss_fn: Callable, rule: UpdateRule,
                    isgd_cfg: ISGDConfig, *, lr_fn: Callable,
                    reduce_ctx: ReduceCtx = StalenessReduce(),
                    micro_batches: int = 1):
    """``(propose, accelerate)`` of one replica: ``loss_fn(batch)`` reads
    the replica's params, and both functions update them in place."""
    lg = reduce_ctx.wrap_loss_and_grad(
        make_loss_and_grad(loss_fn, micro_batches))

    def propose(params, base, queue, batch):
        lr = lr_fn(control.mean(queue))      # pre-push queue: one-step lag
        (loss, aux), grads = lg(params, batch)
        base1 = rule.apply(base, params, grads, lr)
        return params, base1, loss, aux, lr

    def accelerate(params1, batch, limit, loss, lr):
        def lg1(w):
            (l, _), g = lg(w, batch)
            return l, g
        return solve_subproblem(lg1, params1, limit, loss, lr, isgd_cfg,
                                reduce_ctx.param_count(params1))

    return propose, accelerate


class Worker:
    """One worker thread's loop over its FCPR shard.

    Per local step k: wait at the bounded-staleness gate, pull a snapshot,
    copy it into the replica (``params``, ``base``), ``propose``,
    ``observe`` (server-side SPC verdict), optionally solve the subproblem
    against the server's limit, ``push`` (with bounded retry when the server
    verifies checksums). A failing step keeps its traceback and either
    self-evicts (elastic gate, peers survive) or aborts the gate so sibling
    workers unblock instead of deadlocking.

    ``start_step`` is the resume point: a worker restored from a checkpoint
    continues at its own SSP push clock (pushes are the commit point — a
    step whose push never landed is replayed in full).

    ``snapshot_hook(event, wid, k, snap)``, if given, is called with
    ``"pull"`` right after the pull and ``"push"`` right after the push
    landed (a check that nobody wrote the snapshot in between).
    """

    def __init__(self, wid: int, server, feed, fns, gate,
                 steps: int, *, params, base, start_step: int = 0,
                 faults: FaultPlan = NO_FAULTS, push_retries: int = 3,
                 backoff_s: float = 0.05, verify_pushes: bool = False,
                 snapshot_hook: Optional[Callable] = None):
        self.wid = wid
        self.server = server
        # feed.take(k) -> (global step, device batch): a ShardedFeed; the
        # push records carry the global step as ``batch``
        self.feed = feed
        self.propose, self.accelerate = fns
        self.gate = gate
        self.steps = steps
        self.params, self.base = params, base  # the replica
        self.start_step = start_step
        self.faults = faults
        self.push_retries = push_retries
        self.backoff_s = backoff_s
        self.verify_pushes = verify_pushes
        self.snapshot_hook = snapshot_hook
        self.error = None
        self.error_tb = None                  # formatted worker-thread frames
        self.evicted = False

    def run(self) -> None:
        try:
            for k in range(self.start_step, self.steps):
                self.gate.start(self.wid, k)
                self.faults.before_step(self.wid, k)
                t0 = time.perf_counter()
                self._step(k)
                slow = self.faults.slow_factor(self.wid, k)
                if slow > 1.0:
                    time.sleep((time.perf_counter() - t0) * (slow - 1.0))
                self.gate.finish(self.wid)
        except WorkerEvicted:
            # benign unwind: the coordinator already recorded the eviction,
            # re-striped the shard, and fenced this worker's pushes
            self.evicted = True
        except BaseException as e:            # noqa: BLE001 — must unblock peers
            self.error = e
            self.error_tb = traceback.format_exc()
            self.evicted = self.gate.leave(self.wid, e)

    def _step(self, k: int) -> None:
        g, batch = self.feed.take(k)
        snap = self.server.pull()
        if self.snapshot_hook is not None:
            self.snapshot_hook("pull", self.wid, k, snap)
        with torch.no_grad():                 # the params are autograd leaves
            assign_(self.params, snap.params)
            assign_(self.base, snap.base)
        params1, base1, loss, aux, lr = self.propose(
            self.params, self.base, snap.queue, batch)
        self.base = base1                     # a rule may return new tensors
        self.gate.heartbeat(self.wid)         # device work done; still alive
        d = self.server.observe(loss)
        if d.accelerated:
            params2, used = self.accelerate(params1, batch, d.limit, loss, lr)
            used = int(used)
            self.gate.heartbeat(self.wid)
        else:
            params2, used = params1, 0
        try:
            aux_val = float(aux)              # scalar aux by repo convention
        except (TypeError, ValueError, RuntimeError):
            aux_val = None
        self._push(k, snap, params2, base1, metrics={
            "loss": float(loss),
            "aux": aux_val,
            "psi_bar": float(d.psi_bar),
            "psi_std": float(d.psi_std),
            "limit": float(d.limit),
            "accelerated": bool(d.accelerated),
            "sub_iters": used,
            "lr": float(lr),
            "batch": g,                       # the global step fed
        })
        if self.snapshot_hook is not None:
            self.snapshot_hook("push", self.wid, k, snap)

    def _push(self, k: int, snap, params2, base1, *, metrics: dict) -> None:
        """Push with integrity checksum + bounded retry.

        The checksum is computed over the worker's *pristine* trees;
        ``faults.on_transit`` may then corrupt/fail the payload (simulating
        the transport, into new tensors). A verifying server rejects a
        corrupted arrival (:class:`PushRejected`) and the retry resends the
        clean original, so a transient corruption costs one round trip,
        never model quality.
        """
        checksum = None
        if self.verify_pushes:
            from repro_torch.train.checkpoints import tree_checksum
            checksum = tree_checksum((params2, base1))
        last = None
        for attempt in range(self.push_retries + 1):
            if attempt:
                time.sleep(self.backoff_s * 2 ** (attempt - 1))
            try:
                send_p, send_b = self.faults.on_transit(
                    self.wid, k, (params2, base1))
                self.server.push(snap, send_p, send_b, worker=self.wid,
                                 metrics=metrics, checksum=checksum)
                return
            except (PushRejected, TransientPushError) as e:
                last = e
        raise RuntimeError(
            f"worker {self.wid}: push for local step {k} failed after "
            f"{self.push_retries + 1} attempts") from last
