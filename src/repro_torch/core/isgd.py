"""Inconsistent Stochastic Gradient Descent (the paper's contribution).

Port of ``repro.core.isgd`` for one device (the JAX package's ``LOCAL``
reduction is the identity, so it has no counterpart here). Each iteration:

  1. runs the normal base update (Alg.1 line 21), BEFORE the push;
  2. pushes the batch loss into the epoch-window queue and recomputes the
     upper control limit ψ̄ + kσ (lines 13–20);
  3. if the loss exceeds the limit computed after that push, solves the
     conservative subproblem (Eq. 17) on the same batch with early
     stopping (Alg.2): extra gradient steps proximal to the
     post-base-update weights via ε/(2 n_w)·‖w − w0‖².

The JAX package branches on the device (``lax.cond`` around a
``lax.while_loop``). This per-step port reads the predicate on the host:
one ``.item()`` per step, and one more per subproblem trip, since each trip
tests the ψ of the previous evaluation. Parameters are updated in place.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch

from repro_torch.core import control
from repro_torch.optim.base import UpdateRule


class ISGDState(NamedTuple):
    base: tuple
    queue: control.LossQueue
    iter: int                    # global iteration counter
    accel_count: int             # how many batches were accelerated
    sub_iters: int               # total subproblem iterations spent


@dataclass(frozen=True)
class ISGDConfig:
    n_batches: int               # n_b: batches per epoch = queue length
    k_sigma: float = 3.0         # control-limit multiplier (2–3 recommended)
    stop: int = 5                # early-stopping bound for Alg.2
    epsilon: float = 0.1         # conservative-constraint weight (paper: 1e-1)
    zeta: float | None = None    # Alg.2 constant step; default = current lr


def _param_count(params) -> float:
    return float(sum(w.numel() for w in params))


@torch.no_grad()
def _proximal_update(params, grads, w0, scale, zeta, epsilon, n_w):
    for w, g, w0i in zip(params, grads, w0):
        d = (scale * g.to(torch.float32)
             + epsilon * (w.to(torch.float32) - w0i.to(torch.float32)) / n_w)
        w.copy_((w.to(torch.float32) - zeta * d).to(w.dtype))


def solve_subproblem(loss_and_grad, params, limit, entry_loss, lr,
                     cfg: ISGDConfig):
    """Alg.2: minimize ½‖ψ(w)−limit‖² + ε/(2n_w)‖w−w0‖² by early-stopped
    constant-step descent, with w0 the weights on entry (after this step's
    base update). ``loss_and_grad(params) -> (psi, grads)``.

    The loop tests ``psi > limit`` on the ψ of the PREVIOUS evaluation,
    starting from ``entry_loss``, exactly as the JAX ``while_loop`` does.
    Returns (params, iterations_used); params are updated in place."""
    n_w = _param_count(params)
    zeta = cfg.zeta if cfg.zeta is not None else lr
    w0 = [w.detach().clone() for w in params]
    psi, used = entry_loss, 0
    while used < cfg.stop and bool(psi > limit):
        psi, grads = loss_and_grad(params)
        _proximal_update(params, grads, w0, psi - limit, zeta, cfg.epsilon,
                         n_w)
        used += 1
    return params, used


def isgd_init(rule: UpdateRule, cfg: ISGDConfig, params) -> ISGDState:
    dev = params[0].device
    return ISGDState(base=rule.init(params),
                     queue=control.init_queue(cfg.n_batches, device=dev),
                     iter=0, accel_count=0, sub_iters=0)


def isgd_step(rule: UpdateRule, cfg: ISGDConfig, loss_and_grad: Callable,
              state: ISGDState, params, batch, lr, slot=None):
    """One inconsistent-training iteration (Alg.1 body).

    ``loss_and_grad(params, batch) -> ((loss, aux), grads)``. ``slot``:
    ``None`` = FIFO push; a batch index = per-batch table write
    (``control.push_at``). Returns (state, params, metrics)."""
    (loss, aux), grads = loss_and_grad(params, batch)

    # line 21: vanilla base update
    base_state = rule.apply(state.base, params, grads, lr)
    del grads

    # lines 13-20: queue + control limit (after the push)
    queue = (control.push(state.queue, loss) if slot is None
             else control.push_at(state.queue, slot, loss))
    limit = control.control_limit(queue, cfg.k_sigma)
    accelerate = bool(loss > limit)      # the one host sync of the step

    used = 0
    if accelerate:
        def lg(w):
            (l, _), g = loss_and_grad(w, batch)
            return l, g
        params, used = solve_subproblem(lg, params, limit, loss, lr, cfg)

    new_state = ISGDState(base=base_state, queue=queue,
                          iter=state.iter + 1,
                          accel_count=state.accel_count + int(accelerate),
                          sub_iters=state.sub_iters + used)
    metrics = {"loss": loss, "aux": aux,
               "psi_bar": control.mean(queue), "psi_std": control.std(queue),
               "limit": limit, "accelerated": accelerate, "sub_iters": used}
    return new_state, params, metrics


def consistent_step(rule: UpdateRule, loss_and_grad: Callable, state, params,
                    batch, lr, slot=None):
    """Baseline SGD/Momentum/Nesterov step (no inconsistent training) with
    the same metrics surface (paper §5.2)."""
    (loss, aux), grads = loss_and_grad(params, batch)
    base_state = rule.apply(state.base, params, grads, lr)
    queue = (control.push(state.queue, loss) if slot is None
             else control.push_at(state.queue, slot, loss))
    metrics = {"loss": loss, "aux": aux,
               "psi_bar": control.mean(queue), "psi_std": control.std(queue),
               "limit": control.control_limit(queue),
               "accelerated": False, "sub_iters": 0}
    new_state = ISGDState(base=base_state, queue=queue, iter=state.iter + 1,
                          accel_count=state.accel_count,
                          sub_iters=state.sub_iters)
    return new_state, params, metrics
