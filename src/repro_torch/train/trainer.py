"""Training loop: model loss, base rule, ISGD controller, LR schedule and
the FCPR data pipeline wired together.

Port of the per-step half of ``repro.train.trainer``. PyTorch runs eagerly,
so there is no jit: ``make_train_step`` returns the same step function as
``make_step_core``. Parameters are a list of tensors updated in place.

Metrics reach the host only at boundaries, each in ONE transfer
(``host_metrics``): a fused chunk's (K,) metrics in ``TrainLog.extend``,
the per-step loop's deferred steps at its log and eval boundaries
(``train``). An observer (``repro_torch.obs.TrainObserver``) takes the
host values of that same transfer.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core import control
from repro_torch.core.isgd import (ISGDConfig, consistent_step, isgd_init,
                                   isgd_step)
from repro_torch.core.reduce import LOCAL, ReduceCtx
from repro_torch.core.schedule import constant_lr
from repro_torch.optim.base import UpdateRule


def make_loss_and_grad(loss_fn: Callable, micro_batches: int = 1):
    """loss_fn(batch) -> (total_loss, data_loss) over the leaves ``params``
    ⇒ ``lg(params, batch) -> ((loss, aux), grads)`` with grads of
    total_loss.

    ``micro_batches`` = m > 1 splits the batch on dim 0 into m equal parts
    and sums their gradients in f32 (grads are then f32), scaled by 1/m;
    loss and aux are the f32 means, as ``repro.train.trainer`` does it.
    Activation memory scales with the micro-batch; the f32 sums add one
    f32 copy of the gradients.

    The loss and aux scalars are upcast to f32 here, before anything reads
    them: ψ feeds the SPC queue, the control limit and the loss-driven LR,
    all f32 by contract."""
    if micro_batches <= 1:
        def lg(params, batch):
            total, aux = loss_fn(batch)
            grads = torch.autograd.grad(total, params)
            return ((total.detach().to(torch.float32),
                     aux.detach().to(torch.float32)), grads)
        return lg

    m = micro_batches

    def lg(params, batch):
        rows = next(iter(batch.values())).shape[0]
        if any(v.shape[0] != rows for v in batch.values()) or rows % m:
            raise ValueError(f"micro_batches={m} must divide the batch's "
                             f"leading dim, {[v.shape[0] for v in batch.values()]}")
        mb = rows // m
        f32 = dict(dtype=torch.float32, device=params[0].device)
        loss = torch.zeros((), **f32)
        aux = torch.zeros((), **f32)
        acc = [torch.zeros(w.shape, dtype=torch.float32, device=w.device)
               for w in params]
        for i in range(m):
            total, a = loss_fn({k: v[i * mb:(i + 1) * mb]
                                for k, v in batch.items()})
            grads = torch.autograd.grad(total, params)
            with torch.no_grad():
                for g_acc, g in zip(acc, grads):
                    g_acc.add_(g.to(torch.float32))
            loss = loss + total.detach().to(torch.float32)
            aux = aux + a.detach().to(torch.float32)
        inv = 1.0 / m
        with torch.no_grad():
            for g_acc in acc:
                g_acc.mul_(inv)
        return (loss * inv, aux * inv), acc
    return lg


def make_step_core(loss_fn: Callable, rule: UpdateRule, isgd_cfg: ISGDConfig,
                   *, inconsistent: bool = True, lr_fn: Callable = None,
                   reduce_ctx: ReduceCtx = LOCAL, micro_batches: int = 1):
    """``(init_fn, step_fn)``. When ``lr`` is not passed, ``lr_fn`` reads ψ̄
    from the queue BEFORE this step's loss is pushed: the LR is driven by
    the previous step's statistics (Alg.1 line 19). ``micro_batches`` as in
    ``make_loss_and_grad`` (under data parallelism each rank splits its own
    rows). ``reduce_ctx`` (``core.reduce``) reduces every evaluation: the
    data-parallel engine (``repro_torch.distributed``) passes its
    ``AxisReduce`` here.

    ``step_fn(state, params, batch, lr=None, slot=None)`` ->
    ``(state, params, metrics)``."""
    lg = make_loss_and_grad(loss_fn, micro_batches)

    def init_fn(params):
        return isgd_init(rule, isgd_cfg, params)

    def step_fn(state, params, batch, lr=None, slot=None):
        if lr is None:
            lr = lr_fn(control.mean(state.queue))
        if inconsistent:
            return isgd_step(rule, isgd_cfg, lg, state, params, batch, lr,
                             slot=slot, reduce_ctx=reduce_ctx)
        return consistent_step(rule, lg, state, params, batch, lr, slot=slot,
                               reduce_ctx=reduce_ctx)

    return init_fn, step_fn


def make_train_step(loss_fn: Callable, rule: UpdateRule, isgd_cfg: ISGDConfig,
                    *, inconsistent: bool = True, lr_fn: Callable = None,
                    reduce_ctx: ReduceCtx = LOCAL):
    """Returns (init_fn, step_fn), as ``make_step_core`` (eager: no jit)."""
    return make_step_core(loss_fn, rule, isgd_cfg, inconsistent=inconsistent,
                          lr_fn=lr_fn, reduce_ctx=reduce_ctx)


def make_scheduled_train_step(loss_fn: Callable, rule: UpdateRule,
                              isgd_cfg: ISGDConfig, schedule, *,
                              inconsistent: bool = True,
                              lr_fn: Callable = None,
                              reduce_ctx: ReduceCtx = LOCAL,
                              micro_batches: int = 1, sched_seed: int = 0):
    """Per-step engine with on-device batch *selection*
    (``repro_torch.sched``). Returns ``(init_fn, step_fn)`` with
    ``step_fn(state, params, sched_state, ring_arrays, j) -> (state,
    params, sched_state, metrics)``: the batch of step ``j`` is drawn by
    ``schedule`` with tensor operations on the device and gathered from
    the ring arrays (a ``DeviceRing``'s ``.arrays``) at that index, so the
    loss table never travels to the host. ``sched_state`` starts as
    ``schedule.init(isgd_cfg.n_batches, device)`` and is updated in place.
    ``lr_fn`` is required: the LR is derived on the device, as selection
    is. With ``FCPRSchedule`` it is bit-exact with ``make_train_step`` fed
    by the host sampler, and with any policy bit-exact with the fused
    engine's ``make_chunked_train_step(..., schedule=)``."""
    if lr_fn is None:
        raise ValueError("the scheduled engine needs lr_fn (device-side LR)")
    from repro_torch.sched.engine import make_scheduled_body
    init_fn, step_fn = make_step_core(
        loss_fn, rule, isgd_cfg, inconsistent=inconsistent, lr_fn=lr_fn,
        reduce_ctx=reduce_ctx, micro_batches=micro_batches)
    return init_fn, make_scheduled_body(step_fn, schedule,
                                        isgd_cfg.n_batches, sched_seed)


def host_metrics(stacked: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """``{key: numpy array}`` of one boundary's metrics, ``aux`` left out.
    The tensors of ``stacked`` (all of one shape) come to the host in ONE
    transfer, as f64 (which holds each f32, bool and int32 value exactly);
    other values (the per-step engine's Python accelerate flag and trip
    count) are taken as they are."""
    keys = [k for k in stacked if k != "aux"]
    dev = [k for k in keys if torch.is_tensor(stacked[k])]
    out = {k: np.asarray(stacked[k], dtype=np.float64) for k in keys
           if k not in dev}
    if dev:
        host = torch.stack([stacked[k].to(torch.float64)
                            for k in dev]).cpu().numpy()
        out.update(zip(dev, host))
    return {k: out[k] for k in keys}


@dataclass
class TrainLog:
    """Per-step training record. ``wall[i]`` is seconds since the run's t0;
    its deltas are per-step durations only where ``wall_est[i]`` is False.
    Entries marked True are estimates: the chunk's end for every step of a
    fused chunk (``extend``), or the time the host got back from a
    per-step step without ``step_sync`` (the device may still be running
    it: the step's last kernels are enqueued after its last host read)."""

    losses: list = field(default_factory=list)
    limits: list = field(default_factory=list)
    psi_bar: list = field(default_factory=list)
    psi_std: list = field(default_factory=list)
    accelerated: list = field(default_factory=list)
    sub_iters: list = field(default_factory=list)
    wall: list = field(default_factory=list)
    wall_est: list = field(default_factory=list)   # True = estimated wall

    def append(self, metrics: Dict[str, Any], wall: float, *,
               wall_estimated: bool = False):
        self.losses.append(float(metrics["loss"]))
        self.limits.append(float(metrics["limit"]))
        self.psi_bar.append(float(metrics["psi_bar"]))
        self.psi_std.append(float(metrics["psi_std"]))
        self.accelerated.append(bool(metrics["accelerated"]))
        self.sub_iters.append(int(metrics["sub_iters"]))
        self.wall.append(wall)
        self.wall_est.append(bool(wall_estimated))

    def extend(self, stacked: Dict[str, Any], wall: float) -> Dict[str, np.ndarray]:
        """Take one chunk of the fused engine: ``stacked`` holds (K,)
        metric tensors, fetched here in the chunk's ONE host transfer, or
        the host arrays ``host_metrics`` already made of them. Every step
        gets the chunk's end ``wall`` and ``wall_est`` True. Returns the
        host arrays (for an observer's ``chunk``)."""
        host = host_metrics(stacked)
        for i in range(len(host["loss"])):
            self.append({k: v[i] for k, v in host.items()}, wall,
                        wall_estimated=True)
        return host


class Deferred:
    """A per-step loop's metrics, kept on the device until a boundary:
    ``flush`` brings every deferred step to the host in ONE transfer
    (``host_metrics``), appends each to ``log`` (its ``wall`` marked
    estimated where ``wall_estimated``) and hands it to ``observer``
    (``defer``, then ``flush``) if given. Returns the flushed host rows."""

    def __init__(self, log: TrainLog, observer=None,
                 wall_estimated: bool = True):
        self.log, self.observer = log, observer
        self.wall_estimated = wall_estimated
        self.pending = []                    # (step, device metrics, wall)

    def add(self, step: int, metrics: Dict[str, Any], wall: float) -> None:
        self.pending.append((step, metrics, wall))

    def flush(self) -> list:
        rows = []
        if self.pending:
            ms = [m for _, m, _ in self.pending]
            host = host_metrics({k: (torch.stack([m[k] for m in ms])
                                     if torch.is_tensor(ms[0][k])
                                     else [m[k] for m in ms])
                                 for k in ms[0] if k != "aux"})
            for i, (j, _, w) in enumerate(self.pending):
                row = {k: v[i] for k, v in host.items()}
                self.log.append(row, w, wall_estimated=self.wall_estimated)
                if self.observer is not None:
                    self.observer.defer(j, row)
                rows.append(row)
            self.pending.clear()
        if self.observer is not None:
            self.observer.flush()
        return rows


def train(params, loss_fn, rule, sampler, *, steps: int, lr=0.01,
          inconsistent: bool = True, isgd_cfg: Optional[ISGDConfig] = None,
          lr_fn: Callable = None, log_every: int = 0,
          eval_fn: Callable = None, eval_every: int = 0,
          step_sync: bool = False, observer=None):
    """Host loop over FCPR batches: each batch (numpy arrays, or tensors
    from a ``DeviceRing`` or ``PrefetchSampler``) is moved to the params'
    device.

    The steps' metrics stay on the device until a boundary: step 1 and
    every ``log_every``-th step (which are printed), every
    ``eval_every``-th step (then ``eval_fn(params)`` runs), and the end.
    There the deferred steps come to the host in one transfer and go to the
    log and, if given, the ``observer`` (``defer`` then ``flush``). A
    step's ``wall`` is taken when the host gets back from it; without
    ``step_sync`` the device may still be running the step, so the log
    marks it estimated (``wall_est = not step_sync``). ``step_sync=True``
    synchronises the device at the end of each step, so its walls are
    measured completion times (what an Eq. 21 fit needs).

    Returns ``(params, state, log, evals)``, ``evals`` a list of
    ``(step, wall, eval_fn(params))``."""
    if isgd_cfg is None:
        isgd_cfg = ISGDConfig(n_batches=sampler.n_batches)
    if lr_fn is None:
        lr_fn = constant_lr(lr)
    dev = params[0].device
    init_fn, step_fn = make_train_step(loss_fn, rule, isgd_cfg,
                                       inconsistent=inconsistent, lr_fn=lr_fn)
    state = init_fn(params)
    log = TrainLog()
    evals = []
    deferred = Deferred(log, observer, wall_estimated=not step_sync)
    flush = deferred.flush
    t0 = time.perf_counter()

    for j in range(steps):
        batch = {k: torch.as_tensor(v).to(dev) for k, v in sampler(j).items()}
        state, params, metrics = step_fn(state, params, batch)
        if step_sync and dev.type == "cuda":
            torch.cuda.synchronize(dev)
        deferred.add(j, metrics, time.perf_counter() - t0)
        if log_every and (j == 0 or (j + 1) % log_every == 0):
            flush()
            print(f"step {j+1:4d} loss={log.losses[-1]:.4f} "
                  f"psi_bar={log.psi_bar[-1]:.4f} limit={log.limits[-1]:.4f} "
                  f"accel={log.accelerated[-1]}", flush=True)
        if eval_fn and eval_every and (j + 1) % eval_every == 0:
            flush()
            evals.append((j + 1, time.perf_counter() - t0, eval_fn(params)))
    flush()
    return params, state, log, evals
