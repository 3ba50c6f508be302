"""Training loop: model loss, base rule, ISGD controller, LR schedule and
the FCPR data pipeline wired together.

Port of the per-step half of ``repro.train.trainer``. PyTorch runs eagerly,
so there is no jit: ``make_train_step`` returns the same step function as
``make_step_core``. Parameters are a list of tensors updated in place.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.core import control
from repro_torch.core.isgd import (ISGDConfig, consistent_step, isgd_init,
                                   isgd_step)
from repro_torch.core.schedule import constant_lr
from repro_torch.optim.base import UpdateRule


def make_loss_and_grad(loss_fn: Callable):
    """loss_fn(batch) -> (total_loss, data_loss) over the leaves ``params``
    ⇒ ``lg(params, batch) -> ((loss, aux), grads)`` with grads of
    total_loss.

    The loss and aux scalars are upcast to f32 here, before anything reads
    them: ψ feeds the SPC queue, the control limit and the loss-driven LR,
    all f32 by contract."""
    def lg(params, batch):
        total, aux = loss_fn(batch)
        grads = torch.autograd.grad(total, params)
        return ((total.detach().to(torch.float32),
                 aux.detach().to(torch.float32)), grads)
    return lg


def make_step_core(loss_fn: Callable, rule: UpdateRule, isgd_cfg: ISGDConfig,
                   *, inconsistent: bool = True, lr_fn: Callable = None):
    """``(init_fn, step_fn)``. When ``lr`` is not passed, ``lr_fn`` reads ψ̄
    from the queue BEFORE this step's loss is pushed: the LR is driven by
    the previous step's statistics (Alg.1 line 19).

    ``step_fn(state, params, batch, lr=None, slot=None)`` ->
    ``(state, params, metrics)``."""
    lg = make_loss_and_grad(loss_fn)

    def init_fn(params):
        return isgd_init(rule, isgd_cfg, params)

    def step_fn(state, params, batch, lr=None, slot=None):
        if lr is None:
            lr = lr_fn(control.mean(state.queue))
        if inconsistent:
            return isgd_step(rule, isgd_cfg, lg, state, params, batch, lr,
                             slot=slot)
        return consistent_step(rule, lg, state, params, batch, lr, slot=slot)

    return init_fn, step_fn


def make_train_step(loss_fn: Callable, rule: UpdateRule, isgd_cfg: ISGDConfig,
                    *, inconsistent: bool = True, lr_fn: Callable = None):
    """Returns (init_fn, step_fn), as ``make_step_core`` (eager: no jit)."""
    return make_step_core(loss_fn, rule, isgd_cfg, inconsistent=inconsistent,
                          lr_fn=lr_fn)


@dataclass
class TrainLog:
    """Per-step training record. ``wall[i]`` is seconds since the run's t0
    at the step's end. A per-step run syncs once a step on the accelerate
    predicate, so its walls are completion times (``wall_est`` False); the
    steps of one fused chunk (``extend``) all get the chunk's end and are
    marked ``wall_est`` True: estimates, not per-step times."""

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

    def extend(self, stacked: Dict[str, Any], wall: float):
        """Take one chunk of the fused engine: ``stacked`` holds (K,)
        metric tensors, fetched here in ONE host transfer (f64 holds each
        f32, bool and int32 value exactly). Every step gets the chunk's
        end ``wall`` and ``wall_est`` True."""
        keys = [k for k in stacked if k != "aux"]
        host = torch.stack([stacked[k].to(torch.float64)
                            for k in keys]).cpu().numpy()
        for i in range(host.shape[1]):
            self.append({k: host[r, i] for r, k in enumerate(keys)}, wall,
                        wall_estimated=True)


def train(params, loss_fn, rule, sampler, *, steps: int, lr=0.01,
          inconsistent: bool = True, isgd_cfg: Optional[ISGDConfig] = None,
          lr_fn: Callable = None, log_every: int = 0):
    """Host loop over FCPR batches: each batch (numpy arrays, or tensors
    from a ``DeviceRing`` or ``PrefetchSampler``) is moved to the params'
    device. Prints step 1 and every ``log_every``-th step.
    Returns (params, state, log)."""
    if isgd_cfg is None:
        isgd_cfg = ISGDConfig(n_batches=sampler.n_batches)
    if lr_fn is None:
        lr_fn = constant_lr(lr)
    dev = params[0].device
    init_fn, step_fn = make_train_step(loss_fn, rule, isgd_cfg,
                                       inconsistent=inconsistent, lr_fn=lr_fn)
    state = init_fn(params)
    log = TrainLog()
    t0 = time.perf_counter()
    for j in range(steps):
        batch = {k: torch.as_tensor(v).to(dev) for k, v in sampler(j).items()}
        state, params, metrics = step_fn(state, params, batch)
        log.append(metrics, time.perf_counter() - t0)
        if log_every and (j == 0 or (j + 1) % log_every == 0):
            print(f"step {j+1:4d} loss={log.losses[-1]:.4f} "
                  f"psi_bar={log.psi_bar[-1]:.4f} limit={log.limits[-1]:.4f} "
                  f"accel={log.accelerated[-1]}", flush=True)
    return params, state, log
