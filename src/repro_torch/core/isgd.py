"""Inconsistent Stochastic Gradient Descent (the paper's contribution).

Port of ``repro.core.isgd``. Each iteration:

  1. runs the normal base update (Alg.1 line 21), BEFORE the push;
  2. pushes the batch loss into the epoch-window queue and recomputes the
     upper control limit ψ̄ + kσ (lines 13–20);
  3. if the loss exceeds the limit computed after that push, solves the
     conservative subproblem (Eq. 17) on the same batch with early
     stopping (Alg.2): extra gradient steps proximal to the
     post-base-update weights via ε/(2 n_w)·‖w − w0‖².

The JAX package branches on the device (``lax.cond`` around a
``lax.while_loop``). The per-step form here (``isgd_step``, the eager
engine) reads the predicate on the host: one ``.item()`` per step, and one
more per subproblem trip, since each trip tests the ψ of the previous
evaluation. Parameters are updated in place.

The device form (``isgd_step_device``, the chunked engine's step) reads
nothing back: its counters are 0-d int32 tensors, its queue and Alg. 2
buffers are updated in place, and Alg. 2 is ``stop`` unrolled trips, trip
i running where ``live_i = live_{i-1} & (ψ_{i-1} > limit)`` with
``live_0 = accelerate``. Each conditional part goes through ``run_if``:
while the chunked engine builds its CUDA graph, an IF node of the graph,
elsewhere a host ``if``, so the CPU runs the same logic. Under
``analysis.analysis_mode()`` every body runs, the accelerate branch and all
``stop`` trips (the reference's convergence-masked loop, its cost upper
bound), and each trip's writes are masked by its ``live`` flag, so the
numbers stay the normal step's bit for bit; this is also the form that runs
on the meta device, where no predicate has a value to branch on.

Every ``loss_and_grad`` evaluation, the base step's and each Alg. 2
trip's, goes through ``reduce_ctx.wrap_loss_and_grad`` (``core.reduce``):
``LOCAL`` on one device, ``AxisReduce`` under data parallelism, so ψ, the
predicate and every trip are the same on every rank.

Both forms mark the queue push and limit (``obs/psi_push``) and the
accelerate branch (``obs/accelerate``) with profiler spans, as the JAX
package's named scopes do; a span is host-only and adds nothing to a
captured graph.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch

from repro_torch.analysis.mode import in_analysis_mode
from repro_torch.core import control
from repro_torch.core.reduce import LOCAL, ReduceCtx
from repro_torch.obs.timing import named_scope
from repro_torch.optim.base import UpdateRule


class ISGDState(NamedTuple):
    base: tuple
    queue: control.LossQueue
    iter: int                    # global iteration counter
    accel_count: int             # how many batches were accelerated
    sub_iters: int               # total subproblem iterations spent


class TripBuffers(NamedTuple):
    """The device form's Alg. 2 buffers, allocated once: all that a trip
    reads besides the params and the batch (an IF body may read only
    tensors that outlive the step)."""
    w0: list                     # weights on entry (after the base update)
    psi: torch.Tensor            # ψ of the latest evaluation, f32
    live: torch.Tensor           # bool: the current trip runs
    limit: torch.Tensor          # this step's control limit, f32
    zeta: torch.Tensor           # this step's Alg. 2 step (the LR), f32


class DeviceISGDState(NamedTuple):
    """``ISGDState`` of the device form: the counters are 0-d int32 tensors
    and every tensor is updated in place, so a CUDA graph captured over it
    stays valid; ``trips`` is None for the consistent step."""
    base: tuple
    queue: control.LossQueue
    iter: torch.Tensor
    accel_count: torch.Tensor
    sub_iters: torch.Tensor
    trips: TripBuffers | None


@dataclass(frozen=True)
class ISGDConfig:
    n_batches: int               # n_b: batches per epoch = queue length
    k_sigma: float = 3.0         # control-limit multiplier (2–3 recommended)
    stop: int = 5                # early-stopping bound for Alg.2
    epsilon: float = 0.1         # conservative-constraint weight (paper: 1e-1)
    zeta: float | None = None    # Alg.2 constant step; default = current lr


@torch.no_grad()
def _proximal_update(params, grads, w0, scale, zeta, epsilon, n_w,
                     live=None):
    """One Alg. 2 descent step, in place; where ``live`` (a 0-d bool
    tensor) is given, a weight takes its new value only where it holds."""
    for w, g, w0i in zip(params, grads, w0):
        d = (scale * g.to(torch.float32)
             + epsilon * (w.to(torch.float32) - w0i.to(torch.float32)) / n_w)
        new = (w.to(torch.float32) - zeta * d).to(w.dtype)
        w.copy_(new if live is None else torch.where(live, new, w))


def solve_subproblem(loss_and_grad, params, limit, entry_loss, lr,
                     cfg: ISGDConfig, n_w: float | None = None):
    """Alg.2: minimize ½‖ψ(w)−limit‖² + ε/(2n_w)‖w−w0‖² by early-stopped
    constant-step descent, with w0 the weights on entry (after this step's
    base update). ``loss_and_grad(params) -> (psi, grads)``.

    The loop tests ``psi > limit`` on the ψ of the PREVIOUS evaluation,
    starting from ``entry_loss``, exactly as the JAX ``while_loop`` does.
    ``n_w`` is the model's parameter count (default: that of ``params``).
    Returns (params, iterations_used); params are updated in place."""
    if n_w is None:
        n_w = LOCAL.param_count(params)
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


def _push(queue, loss, slot):
    """FIFO push where ``slot`` is None, else the per-batch table write at
    ``slot`` (a 0-d int tensor, never read back)."""
    if slot is None:
        return control.push(queue, loss)
    return control.push_at(queue, slot, loss)


def isgd_step(rule: UpdateRule, cfg: ISGDConfig, loss_and_grad: Callable,
              state: ISGDState, params, batch, lr, slot=None,
              reduce_ctx: ReduceCtx = LOCAL):
    """One inconsistent-training iteration (Alg.1 body).

    ``loss_and_grad(params, batch) -> ((loss, aux), grads)``, each
    evaluation reduced by ``reduce_ctx``. ``slot``: ``None`` = FIFO push; a
    batch index = per-batch table write (``control.push_at``). Returns
    (state, params, metrics)."""
    loss_and_grad = reduce_ctx.wrap_loss_and_grad(loss_and_grad)
    (loss, aux), grads = loss_and_grad(params, batch)

    # line 21: vanilla base update
    base_state = rule.apply(state.base, params, grads, lr)
    del grads

    # lines 13-20: queue + control limit (after the push)
    with named_scope("obs/psi_push"):
        queue = _push(state.queue, loss, slot)
        limit = control.control_limit(queue, cfg.k_sigma)

    # the branch: its predicate's host read (the step's one sync), then
    # Alg. 2 where it holds
    with named_scope("obs/accelerate"):
        accelerate = bool(loss > limit)
        used = 0
        if accelerate:
            def lg(w):
                (l, _), g = loss_and_grad(w, batch)
                return l, g
            params, used = solve_subproblem(lg, params, limit, loss, lr, cfg,
                                            reduce_ctx.param_count(params))

    new_state = ISGDState(base=base_state, queue=queue,
                          iter=state.iter + 1,
                          accel_count=state.accel_count + int(accelerate),
                          sub_iters=state.sub_iters + used)
    metrics = {"loss": loss, "aux": aux,
               "psi_bar": control.mean(queue), "psi_std": control.std(queue),
               "limit": limit, "accelerated": accelerate, "sub_iters": used}
    return new_state, params, metrics


def consistent_step(rule: UpdateRule, loss_and_grad: Callable, state, params,
                    batch, lr, slot=None, reduce_ctx: ReduceCtx = LOCAL):
    """Baseline SGD/Momentum/Nesterov step (no inconsistent training) with
    the same metrics surface (paper §5.2)."""
    loss_and_grad = reduce_ctx.wrap_loss_and_grad(loss_and_grad)
    (loss, aux), grads = loss_and_grad(params, batch)
    base_state = rule.apply(state.base, params, grads, lr)
    queue = _push(state.queue, loss, slot)
    metrics = {"loss": loss, "aux": aux,
               "psi_bar": control.mean(queue), "psi_std": control.std(queue),
               "limit": control.control_limit(queue),
               "accelerated": False, "sub_iters": 0}
    new_state = ISGDState(base=base_state, queue=queue, iter=state.iter + 1,
                          accel_count=state.accel_count,
                          sub_iters=state.sub_iters)
    return new_state, params, metrics


# ---------------------------------------------------------------------------
# device form (the chunked engine)
# ---------------------------------------------------------------------------
def run_if(pred, body: Callable):
    """Run ``body()`` where the 0-d bool tensor ``pred`` is true.

    While the chunked engine builds its CUDA graph (a
    ``kernels.graph_if.IfBodies`` pass), ``body`` becomes an IF node of the
    graph: the device tests ``pred`` at each replay and the host reads
    nothing. Elsewhere (the CPU, an eager run on the card) it is ``if
    bool(pred)``. In analysis mode ``body()`` runs whatever ``pred`` holds
    (module doc)."""
    if in_analysis_mode():
        body()
        return
    if pred.is_cuda:
        from repro_torch.kernels import graph_if
        bodies = graph_if.active()
        if bodies is not None:
            bodies.guard(pred, body)
            return
    if bool(pred):
        body()


def assign_(dst, src):
    """Copy the tensors of ``src`` into those of ``dst`` (same structure of
    tuples, lists and dicts), skipping a tensor that already is its
    destination."""
    if torch.is_tensor(dst):
        if dst is not src:
            dst.copy_(src)
        return
    if isinstance(dst, dict):
        for k, d in dst.items():
            assign_(d, src[k])
        return
    for d, s in zip(dst, src):
        assign_(d, s)


def isgd_device_init(rule: UpdateRule, cfg: ISGDConfig, params, *,
                     inconsistent: bool = True) -> DeviceISGDState:
    dev = params[0].device
    i32 = dict(dtype=torch.int32, device=dev)
    trips = None
    if inconsistent:
        f32 = dict(dtype=torch.float32, device=dev)
        trips = TripBuffers(w0=[torch.empty_like(w) for w in params],
                            psi=torch.zeros((), **f32),
                            live=torch.zeros((), dtype=torch.bool, device=dev),
                            limit=torch.zeros((), **f32),
                            zeta=torch.zeros((), **f32))
    return DeviceISGDState(base=rule.init(params),
                           queue=control.init_queue(cfg.n_batches, device=dev),
                           iter=torch.zeros((), **i32),
                           accel_count=torch.zeros((), **i32),
                           sub_iters=torch.zeros((), **i32), trips=trips)


def isgd_step_device(rule: UpdateRule, cfg: ISGDConfig,
                     loss_and_grad: Callable, state: DeviceISGDState, params,
                     batch, lr, slot=None, reduce_ctx: ReduceCtx = LOCAL):
    """``isgd_step`` with the accelerate branch and Alg. 2 on the device:
    the same arithmetic in the same order, so its trajectory is the per-step
    engine's bit for bit. Updates ``state`` and ``params`` in place and
    returns them with the step's metrics (0-d tensors). The guarded parts
    read ``state.trips``, the params and ``batch`` only, so ``batch`` must
    outlive the step where it is captured. ``slot`` as in ``isgd_step``:
    a 0-d int tensor on the device, which the push takes without a host
    read, so a capture holds it. ``reduce_ctx`` as in ``isgd_step``."""
    loss_and_grad = reduce_ctx.wrap_loss_and_grad(loss_and_grad)
    (loss, aux), grads = loss_and_grad(params, batch)
    assign_(state.base, rule.apply(state.base, params, grads, lr))
    del grads
    with named_scope("obs/psi_push"):
        assign_(state.queue, _push(state.queue, loss, slot))
        limit = control.control_limit(state.queue, cfg.k_sigma)
    accelerate = loss > limit

    trips = state.trips
    n_w = reduce_ctx.param_count(params)
    trips.psi.copy_(loss)
    trips.live.copy_(accelerate)
    trips.limit.copy_(limit)
    zeta = cfg.zeta
    if zeta is None:
        zeta = trips.zeta
        zeta.copy_(lr)

    @torch.no_grad()
    def enter():
        for w0i, w in zip(trips.w0, params):
            w0i.copy_(w)

    def trip():
        (psi, _), g = loss_and_grad(params, batch)
        # in analysis mode every trip runs: mask its writes by ``live``
        live = trips.live if in_analysis_mode() else None
        _proximal_update(params, g, trips.w0, psi - trips.limit, zeta,
                         cfg.epsilon, n_w, live)
        trips.psi.copy_(psi if live is None
                        else torch.where(live, psi, trips.psi))

    # host-only span: in a capture it adds no node to the graph
    with named_scope("obs/accelerate"):
        run_if(accelerate, enter)
        used = torch.zeros((), dtype=torch.int32, device=loss.device)
        for _ in range(cfg.stop):
            trips.live.logical_and_(trips.psi > limit)
            used += trips.live
            run_if(trips.live, trip)

    state.iter.add_(1)
    state.accel_count.add_(accelerate)
    state.sub_iters.add_(used)
    metrics = {"loss": loss, "aux": aux,
               "psi_bar": control.mean(state.queue),
               "psi_std": control.std(state.queue),
               "limit": limit, "accelerated": accelerate, "sub_iters": used}
    return state, params, metrics


def consistent_step_device(rule: UpdateRule, loss_and_grad: Callable,
                           state: DeviceISGDState, params, batch, lr,
                           slot=None, reduce_ctx: ReduceCtx = LOCAL):
    """``consistent_step`` in the device form (in place, tensor metrics)."""
    loss_and_grad = reduce_ctx.wrap_loss_and_grad(loss_and_grad)
    (loss, aux), grads = loss_and_grad(params, batch)
    assign_(state.base, rule.apply(state.base, params, grads, lr))
    del grads
    assign_(state.queue, _push(state.queue, loss, slot))
    state.iter.add_(1)
    metrics = {"loss": loss, "aux": aux,
               "psi_bar": control.mean(state.queue),
               "psi_std": control.std(state.queue),
               "limit": control.control_limit(state.queue),
               "accelerated": torch.zeros((), dtype=torch.bool,
                                          device=loss.device),
               "sub_iters": torch.zeros((), dtype=torch.int32,
                                        device=loss.device)}
    return state, params, metrics
