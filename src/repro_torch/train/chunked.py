"""Fused multi-step training engine: K ISGD steps per host dispatch.

Port of ``repro.train.chunked``. The per-step engine pays, every
iteration, Python dispatch of the model, autograd and optimizer, a host
batch copy, and one host read of the accelerate predicate (plus one per
Alg. 2 trip). Here batches come from a device-resident FCPR ring
(``repro_torch.data.DeviceRing``: batch identity is ``j mod n_b``, so
selection is a gather by an index that lives on the device) and the step is
the device form of Alg. 1 (``core.isgd.isgd_step_device``): queue push,
control limit, accelerate branch, ``stop`` guarded Alg. 2 trips and the
loss-driven LR, with nothing read back.

On a CUDA device the engine runs one step eagerly on a side stream (the
warm-up: every kernel, cuBLAS/cuDNN handle and lazily built table is
reached), recording each guarded part (the Alg. 2 trips) as a graph of its
own instead of running it (``kernels.graph_if.IfBodies``), restores the
state, and captures one step into a ``torch.cuda.CUDAGraph``: the batch
gather, the loss and gradient, the base update, the push and the limit,
the trips as IF nodes holding the recorded graphs, the metrics row written
at a device counter and the counters' increments. A chunk is K replays
(the ``obs/chunk_scan`` profiler span) and one host read of the (K,)
metrics (``trainer.host_metrics``). The graph holds raw device addresses,
so params, optimizer state, queue, ring and batch buffer are static
tensors updated in place; intermediates live in the graph's private pool.
Without CUDA-graph conditional nodes the engine raises: it never falls
back to host reads. On a CPU device the same body runs in a plain loop.

A ``repro_torch.sched`` policy may pick the batch instead of the ring
walk (``make_chunked_train_step(..., schedule=)``): its draw, table update
and the gather at the drawn index are tensor operations inside the same
captured step, so selection adds no host read either.

Semantics are bit-exact with the per-step engine: the body does the
per-step arithmetic in the same order, and ``lr_fn`` reads ψ̄ from the
queue BEFORE the step pushes its own loss, as ``make_step_core`` does.
"""
from __future__ import annotations

import time
from typing import Callable

import torch

from repro_torch.core import control
from repro_torch.core.isgd import (ISGDConfig, consistent_step_device,
                                   isgd_device_init, isgd_step_device)
from repro_torch.core.reduce import LOCAL, ReduceCtx
from repro_torch.kernels import graph_if
from repro_torch.obs.timing import named_scope
from repro_torch.optim.base import UpdateRule
from repro_torch.train.trainer import make_loss_and_grad

# the stacked metrics of a chunk, with their dtypes
METRICS = {"loss": torch.float32, "aux": torch.float32,
           "psi_bar": torch.float32, "psi_std": torch.float32,
           "limit": torch.float32, "accelerated": torch.bool,
           "sub_iters": torch.int32}


def _tensors(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def make_device_step(loss_fn: Callable, rule: UpdateRule, isgd_cfg: ISGDConfig,
                     *, inconsistent: bool = True, lr_fn: Callable,
                     reduce_ctx: ReduceCtx = LOCAL, micro_batches: int = 1):
    """``(init_fn, step_fn)`` of the device form. ``init_fn(params)`` ->
    ``DeviceISGDState``; ``step_fn(state, params, batch, slot=None)`` ->
    ``(state, params, metrics)``, updating in place, with the LR read from
    ψ̄ before the push; ``slot`` as in ``core.isgd.isgd_step_device``.
    ``micro_batches`` as in ``make_loss_and_grad``: the loop over
    micro-batches is static, so a capture records it like the rest of the
    step (its f32 gradient sums live in the graph's pool). ``reduce_ctx``
    as in ``trainer.make_step_core``; an ``AxisReduce`` writes its static
    buffers in place, so a capture holds its collective."""
    lg = make_loss_and_grad(loss_fn, micro_batches)

    def init_fn(params):
        return isgd_device_init(rule, isgd_cfg, params,
                                inconsistent=inconsistent)

    def step_fn(state, params, batch, slot=None):
        lr = lr_fn(control.mean(state.queue))
        if inconsistent:
            return isgd_step_device(rule, isgd_cfg, lg, state, params, batch,
                                    lr, slot=slot, reduce_ctx=reduce_ctx)
        return consistent_step_device(rule, lg, state, params, batch, lr,
                                      slot=slot, reduce_ctx=reduce_ctx)

    return init_fn, step_fn


def gather_batch(ring_arrays, t, n_batches: int, out=None):
    """Batch ``t`` (a 0-d int tensor on the device) of the ring: rows
    ``[t*bs, (t+1)*bs)`` of each array, gathered at a device index, into
    ``out`` where given (the fused engine's static batch)."""
    rows = next(iter(ring_arrays.values()))
    bs = rows.shape[0] // n_batches
    idx = t * bs + torch.arange(bs, device=rows.device)
    if out is None:
        return {k: v.index_select(0, idx) for k, v in ring_arrays.items()}
    for k, v in ring_arrays.items():
        torch.index_select(v, 0, idx, out=out[k])
    return out


class ChunkFn:
    """``chunk_fn(*carry, ring_arrays, j0) -> (*carry, stacked)``:
    ``chunk_steps`` steps from global step ``j0``; ``carry`` is ``(state,
    params)``, or ``(state, params, sched_state)`` for a scheduled body;
    ``stacked`` holds (K,) tensors on the device, one per key of
    ``metrics``. ``body(carry, ring_arrays, j, batch) -> metrics`` is one
    step at the device step counter ``j``: it picks its batch (the FCPR
    ring walk of ``chunk_over_ring``, or a policy's draw,
    ``sched.engine.chunk_over_schedule``), gathers it into the static
    ``batch`` and updates ``carry`` in place. ``prepare`` does the warm-up
    and the capture (on CUDA) ahead of the first chunk; it is redone only
    for other tensors. ``capture_seconds`` is the time it took.

    ``j0`` is a free cursor: any step, on or off the K grid, so a run
    resumed from a checkpoint at step 6 runs its chunks of 4 from step 6."""

    def __init__(self, body: Callable, n_batches: int, chunk_steps: int,
                 metrics: dict = METRICS):
        if chunk_steps < 1:
            raise ValueError("chunk_steps must be >= 1")
        self.body = body
        self.n_batches = n_batches
        self.chunk_steps = chunk_steps
        self.metrics = metrics
        self.graph = None
        self.capture_seconds = 0.0
        self._key = None
        self._refs = None

    def _allocate(self, ring_arrays, device):
        rows = next(iter(ring_arrays.values())).shape[0]
        bs = rows // self.n_batches
        self.batch = {k: torch.empty((bs, *v.shape[1:]), dtype=v.dtype,
                                     device=device)
                      for k, v in ring_arrays.items()}
        self.j = torch.zeros((), dtype=torch.int64, device=device)
        self.row = torch.zeros((), dtype=torch.int64, device=device)
        self.out = {k: torch.zeros((self.chunk_steps,), dtype=dt,
                                   device=device)
                    for k, dt in self.metrics.items()}

    def _step(self, carry, ring_arrays):
        """One step: the body at step ``j``, its metrics written at row
        ``row``, both counters advanced. Nothing is read back."""
        metrics = self.body(carry, ring_arrays, self.j, self.batch)
        r = self.row.reshape(1)
        for k, buf in self.out.items():
            buf.index_put_((r,), metrics[k].reshape(1).to(buf.dtype))
        self.j.add_(1)
        self.row.add_(1)

    def prepare(self, *args):
        """``prepare(*carry, ring_arrays)``."""
        carry, ring_arrays = args[:-1], args[-1]
        live = list(_tensors(carry))
        static = live + list(_tensors(ring_arrays))
        key = tuple((t.data_ptr(), tuple(t.shape), t.dtype) for t in static)
        if key == self._key:
            return
        device = carry[1][0].device
        self._allocate(ring_arrays, device)
        self.graph = None
        if device.type == "cuda":
            graph_if.require()
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            with torch.no_grad():    # no autograd graph may outlive this
                saved = [t.clone() for t in live]
            bodies = graph_if.IfBodies(device)
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with bodies.recording(), torch.cuda.stream(side):
                self._step(carry, ring_arrays)
            torch.cuda.current_stream(device).wait_stream(side)
            with torch.no_grad():
                for t, s in zip(live, saved):
                    t.copy_(s)
            del saved
            graph = torch.cuda.CUDAGraph()
            with bodies.splicing(), torch.cuda.graph(graph):
                self._step(carry, ring_arrays)
            torch.cuda.synchronize(device)
            self.graph = graph
            self.capture_seconds = time.perf_counter() - t0
        self._key, self._refs = key, static

    def __call__(self, *args):
        """``chunk_fn(*carry, ring_arrays, j0)``."""
        carry, (ring_arrays, j0) = args[:-2], args[-2:]
        j0 = int(j0)
        # the ring index t·bs + row is int64 on the device
        if not 0 <= j0 <= torch.iinfo(torch.int64).max - self.chunk_steps:
            raise ValueError(f"j0={j0} is outside the int64 step range")
        self.prepare(*carry, ring_arrays)
        self.j.fill_(j0)
        self.row.zero_()
        with named_scope("obs/chunk_scan"):
            for _ in range(self.chunk_steps):
                if self.graph is not None:
                    self.graph.replay()
                else:
                    self._step(carry, ring_arrays)
        return (*carry, {k: v.clone() for k, v in self.out.items()})


def chunk_over_ring(step_fn: Callable, n_batches: int,
                    chunk_steps: int) -> ChunkFn:
    """Wrap a device-form ``step_fn(state, params, batch) -> (state,
    params, metrics)`` into ``chunk_fn(state, params,
    ring_arrays, j0) -> (state, params, stacked)`` over the FCPR ring
    (``ring_arrays``: a ``DeviceRing``'s ``.arrays``): batch ``j mod
    n_b`` at step j."""
    def body(carry, ring_arrays, j, batch):
        t = torch.remainder(j, n_batches)
        gather_batch(ring_arrays, t, n_batches, out=batch)
        return step_fn(*carry, batch)[2]

    return ChunkFn(body, n_batches, chunk_steps)


def make_chunked_train_step(loss_fn: Callable, rule: UpdateRule,
                            isgd_cfg: ISGDConfig, *, chunk_steps: int,
                            inconsistent: bool = True,
                            lr_fn: Callable = None,
                            reduce_ctx: ReduceCtx = LOCAL,
                            micro_batches: int = 1,
                            schedule=None, sched_seed: int = 0):
    """``(init_fn, chunk_fn)`` of the single-device fused engine.
    ``lr_fn`` is required: inside a chunk the LR is derived on the device
    from the previous step's queue; there is no host between steps to pass
    one. ``micro_batches`` as in ``make_loss_and_grad``. ``init_fn`` raises
    on CUDA params where conditional nodes are missing.

    ``schedule`` (a ``repro_torch.sched`` policy) swaps the FCPR ring walk
    for on-device policy selection: ``chunk_fn(state, params, sched_state,
    ring_arrays, j0) -> (state, params, sched_state, stacked)``, with
    ``sched_state = schedule.init(isgd_cfg.n_batches, device)`` updated in
    place and a ``batch_idx`` row in ``stacked``; ``FCPRSchedule`` is
    bit-exact with ``schedule=None``."""
    if lr_fn is None:
        raise ValueError("the chunked engine needs lr_fn (no per-step host)")
    init_dev, step_fn = make_device_step(loss_fn, rule, isgd_cfg,
                                         inconsistent=inconsistent,
                                         lr_fn=lr_fn, reduce_ctx=reduce_ctx,
                                         micro_batches=micro_batches)

    def init_fn(params):
        if params[0].device.type == "cuda":
            graph_if.require()
        return init_dev(params)

    if schedule is not None:
        from repro_torch.sched.engine import chunk_over_schedule
        return init_fn, chunk_over_schedule(step_fn, schedule,
                                            isgd_cfg.n_batches, chunk_steps,
                                            sched_seed)
    return init_fn, chunk_over_ring(step_fn, isgd_cfg.n_batches, chunk_steps)
