"""Data-parallel ISGD engine over ``torch.distributed`` (paper §6, Fig. 8).

Port of the pure data-parallel half of ``repro.distributed.data_parallel``
(its manual ``shard_map`` strategy). One process a rank, one rank a data
shard: params and ISGD state are replicated, each rank takes its rows of
the global batch (rank r: rows ``[r·b/n, (r+1)·b/n)``, the flat shard order
``P("data")`` gives in the reference), and every ``loss_and_grad``
evaluation is reduced by ``AxisReduce(axis, deterministic=True)`` over the
mesh's group (``core.reduce``: one flat f32 bucket gathered in rank order
and averaged locally). So the accelerate predicate and every Alg. 2 trip
see the same ψ on every rank, and every rank computes the same new params.

One engine, one step path: ``make_hybrid_step`` runs the body every other
synchronous engine runs, ``train.trainer.make_step_core`` (the fused twin:
``train.chunked.make_chunked_train_step``), with the strategy's reduction
context. ``lr_fn`` reads ψ̄ of the incoming queue outside the step, the
one-step lag of Alg. 1 line 19. ``make_data_parallel_step`` and
``make_chunked_data_parallel_step`` are the reference's aliases.

The reference's second strategy, GSPMD for a mesh with a tensor-parallel
axis of size > 1, waits for the hybrid tensor-parallel slice:
``MeshStrategy`` raises ``MeshError`` naming it.

Batches: ``step_fn`` takes this rank's rows. ``batch_sharding(mesh)`` cuts
them from a global host batch, ``prefetched(sampler, mesh)``
(``distributed.prefetch``) stages them, and a ``DeviceRing(mesh=)``
(``data.device_ring``) holds this rank's stripe of the relaid-out epoch;
the fused and scheduled engines take its ``.arrays`` and gather rows
``[t·b_local, (t+1)·b_local)`` of it on the device.

The fused engine on CUDA captures the collectives into its graph (the
step's and each Alg. 2 trip's, the trips inside IF nodes). That needs a
backend whose collective is device work: NCCL. A gloo collective is host
work and cannot sit in a CUDA graph, so ``make_chunked_hybrid_step`` on a
CUDA mesh over gloo raises at construction; it never runs per-step instead.
The reduction's buffers and NCCL's communicator are made before any
capture (``init_fn`` gathers once).
"""
from __future__ import annotations

from typing import Callable, Optional

from repro_torch.core import ISGDConfig
from repro_torch.core import control
from repro_torch.core.reduce import AxisReduce, tree_leaves
from repro_torch.launch.mesh import (HYBRID_TP, MeshError, data_axes,
                                     mesh_group)
from repro_torch.optim.base import UpdateRule


def _norm_axes(mesh, axis) -> tuple:
    axes = data_axes(mesh)
    if not axes:
        raise MeshError(f"mesh {mesh} has no data axis")
    if axis is not None:
        want = (axis,) if isinstance(axis, str) else tuple(axis)
        if want != axes:
            raise MeshError(f"axis {axis!r} is not the mesh's data axes "
                            f"{axes}")
    return axes


def data_axis_size(mesh, axis=None) -> int:
    """Total data-parallel degree: the ranks of the data axis."""
    _norm_axes(mesh, axis)
    return mesh_group(mesh).size()


def tensor_axes(mesh, axis=None) -> tuple:
    """Non-data mesh axes of size > 1, the tensor-parallel part. Empty for
    every mesh this slice builds."""
    data = set(_norm_axes(mesh, axis))
    names = mesh.mesh_dim_names or ()
    return tuple(a for i, a in enumerate(names)
                 if a not in data and mesh.shape[i] > 1)


class BatchShard:
    """This rank's rows of a global batch: rank r of n takes rows
    ``[r·b/n, (r+1)·b/n)`` of every leaf (``__call__``, on a dict of
    numpy arrays or tensors); ``rows(b)`` is that slice."""

    def __init__(self, rank: int, world: int):
        self.rank, self.world = rank, world

    def rows(self, b: int) -> slice:
        if b % self.world:
            raise ValueError(f"batch {b} is not divisible by the "
                             f"{self.world} data-parallel ranks")
        n = b // self.world
        return slice(self.rank * n, (self.rank + 1) * n)

    def __call__(self, batch: dict) -> dict:
        return {k: v[self.rows(v.shape[0])] for k, v in batch.items()}


def batch_sharding(mesh, axis=None) -> BatchShard:
    """The batch layout of the engine: this rank's rows (``BatchShard``)."""
    _norm_axes(mesh, axis)
    group = mesh_group(mesh)
    return BatchShard(group.rank(), group.size())


def replicate_to_mesh(tree, mesh):
    """Replicate a tree of tensors over the mesh: every rank's copy becomes
    rank 0's, in place, one broadcast a tensor (the multi-process
    ``device_put`` of the reference); returns the tree. Ranks that built
    the same params from the same seed hold the same bits already; this
    makes it so whatever they built."""
    import torch
    import torch.distributed as dist
    group = mesh_group(mesh)
    src = dist.get_global_rank(group, 0)
    with torch.no_grad():
        for t in tree_leaves(tree):
            dist.broadcast(t, src=src, group=group)
    return tree


def replicated(mesh) -> Callable:
    """The replicated placement of ``mesh``: ``put(tree)`` is
    ``replicate_to_mesh(tree, mesh)``."""
    return lambda tree: replicate_to_mesh(tree, mesh)


class MeshStrategy:
    """The strategy dispatch point, resolved once: ``reduce_ctx`` (what
    ``make_step_core`` reduces ψ and the gradients with), ``axis`` and
    ``tensor_axes``. Only the reference's manual strategy exists here; a
    mesh with a tensor-parallel axis raises (``MeshError``)."""

    def __init__(self, mesh, axis=None):
        axes = _norm_axes(mesh, axis)
        self.mesh = mesh
        self.axis = axes[0] if len(axes) == 1 else axes
        self.tensor_axes = tensor_axes(mesh, axes)
        if self.tensor_axes:
            raise MeshError(f"mesh axes {self.tensor_axes} are tensor-"
                            f"parallel: {HYBRID_TP}")
        self.group = mesh_group(mesh)
        self.reduce_ctx = AxisReduce(self.axis, deterministic=True,
                                     group=self.group)

    def backend(self) -> str:
        import torch.distributed as dist
        return dist.get_backend(self.group)

    def prime(self, params) -> None:
        """Make the reduction's buffers and the communicator now, before a
        capture (``AxisReduce.prime``)."""
        self.reduce_ctx.prime(params, params[0].device)


def mesh_strategy(mesh, axis=None) -> MeshStrategy:
    return MeshStrategy(mesh, axis)


def make_hybrid_step(loss_fn: Callable, rule: UpdateRule,
                     isgd_cfg: ISGDConfig, mesh, *, axis=None,
                     inconsistent: bool = True,
                     lr_fn: Optional[Callable] = None,
                     micro_batches: int = 1, schedule=None,
                     sched_seed: int = 0):
    """``(init_fn, step_fn)`` with the ``make_train_step`` contract.

    ``step_fn(state, params, batch, lr=None) -> (state, params, metrics)``
    where ``batch`` holds this rank's rows of the global batch (module
    doc). Params and state are replicated (start them equal on every rank,
    ``replicate_to_mesh``); the gradients are reduced before the base
    update and ψ before the queue push, so every rank computes the same new
    params. When ``lr`` is not passed, ``lr_fn`` reads ψ̄ from the queue of
    the incoming state. ``init_fn(params)`` also makes the reduction's
    buffers (one gather); ``init_fn.reduce_ctx`` is the strategy's
    ``AxisReduce`` (its ``buffer_bytes``: what those buffers hold).

    ``schedule`` (a ``repro_torch.sched`` policy; needs ``lr_fn``) gives
    the scheduled contract, ``step_fn(state, params, sched_state,
    ring_arrays, j) -> (state, params, sched_state, metrics)``, with
    ``ring_arrays`` a ``DeviceRing(mesh=)``'s ``.arrays``. The draw is a
    pure function of (seed, step, table), and the table takes the reduced
    ψ, so every rank draws the same batch."""
    from repro_torch.train.trainer import (make_scheduled_train_step,
                                           make_step_core)
    strat = mesh_strategy(mesh, axis)
    common = dict(inconsistent=inconsistent, lr_fn=lr_fn,
                  reduce_ctx=strat.reduce_ctx, micro_batches=micro_batches)
    if schedule is not None:
        init_core, step_fn = make_scheduled_train_step(
            loss_fn, rule, isgd_cfg, schedule, sched_seed=sched_seed,
            **common)
    else:
        init_core, core_step = make_step_core(loss_fn, rule, isgd_cfg,
                                              **common)

        def step_fn(state, params, batch, lr=None):
            if lr is None:
                lr = lr_fn(control.mean(state.queue))
            return core_step(state, params, batch, lr)

    def init_fn(params):
        state = init_core(params)
        strat.prime(params)
        return state

    init_fn.reduce_ctx = strat.reduce_ctx
    return init_fn, step_fn


def make_chunked_hybrid_step(loss_fn: Callable, rule: UpdateRule,
                             isgd_cfg: ISGDConfig, mesh, *,
                             chunk_steps: int, axis=None,
                             inconsistent: bool = True,
                             lr_fn: Optional[Callable] = None,
                             micro_batches: int = 1, schedule=None,
                             sched_seed: int = 0):
    """Fused K-steps-per-dispatch twin of ``make_hybrid_step``:
    ``(init_fn, chunk_fn)`` with ``chunk_fn(state, params, ring_arrays,
    j0) -> (state, params, stacked)`` (``train.chunked``), ``ring_arrays``
    a ``DeviceRing(mesh=)``'s ``.arrays``, this rank's stripe; with
    ``schedule``, ``chunk_fn(state, params, sched_state, ring_arrays,
    j0)``. On the card each step is one CUDA graph holding its collectives
    (NCCL); over gloo on the card this raises here (module doc)."""
    from repro_torch.train.chunked import make_chunked_train_step
    if lr_fn is None:
        raise ValueError("the chunked engine needs lr_fn (no per-step host)")
    strat = mesh_strategy(mesh, axis)
    if mesh.device_type == "cuda" and strat.backend() != "nccl":
        raise RuntimeError(
            f"the fused data-parallel engine captures its collectives into "
            f"a CUDA graph, and a {strat.backend()} collective is host work "
            f"that a graph cannot hold: use the nccl backend, or the "
            f"per-step engine (it does not fall back)")
    init_core, chunk_fn = make_chunked_train_step(
        loss_fn, rule, isgd_cfg, chunk_steps=chunk_steps,
        inconsistent=inconsistent, lr_fn=lr_fn, reduce_ctx=strat.reduce_ctx,
        micro_batches=micro_batches, schedule=schedule,
        sched_seed=sched_seed)

    def init_fn(params):
        state = init_core(params)
        strat.prime(params)
        return state

    init_fn.reduce_ctx = strat.reduce_ctx
    return init_fn, chunk_fn


# the pure data-parallel engine IS the hybrid engine on a pure-data mesh;
# the reference's names stay as aliases
make_data_parallel_step = make_hybrid_step
make_chunked_data_parallel_step = make_chunked_hybrid_step
