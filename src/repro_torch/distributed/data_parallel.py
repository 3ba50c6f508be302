"""Hybrid DP × TP ISGD engine over ``torch.distributed`` (paper §6, Fig. 8).

Port of ``repro.distributed.data_parallel``. One process a rank, one rank a
device. The engine picks its strategy from the mesh at ONE point,
:class:`MeshStrategy`:

  * **data parallel** (every non-data axis of size 1: a ``("data",)``,
    ``(data, model=1)`` or ``(pod, data, model=1)`` mesh; the reference's
    manual ``shard_map`` strategy). Params and ISGD state are replicated,
    each rank takes its rows of the global batch (flat data rank r: rows
    ``[r·b/n, (r+1)·b/n)``, the flat pod-major shard order ``P(("pod",
    "data"))`` gives in the reference), and every ``loss_and_grad``
    evaluation is reduced by ``AxisReduce(axis, deterministic=True)`` over
    the mesh's data group (``core.reduce``: one flat f32 bucket, reduced in
    rank order by a reduce-scatter, the means gathered back). So the
    accelerate predicate and every Alg. 2 trip see the same ψ on every
    rank, every rank computes the same new params, and a ``(pod=2,
    data=2)`` mesh gives a ``(data=4)`` mesh's bits.
  * **tensor parallel** (a ``model`` axis of size M > 1; the reference's
    GSPMD strategy). The same ``make_step_core`` body runs on parameters
    placed by ``launch.shardings.hybrid_params_placement``: each rank
    updates its shards (the velocity is built from them, so it shards
    alike), and an evaluation (``TensorParallelReduce``) gathers the
    shards it needs (FSDP slices over ``data``; the parameters the model
    does not split over ``model``), cuts the rank's rows of the global
    batch, runs the loss under ``sharding.tensor_parallel`` (attention by
    heads, the MLP by its ``d_ff``; ``TensorParallel``) and takes the data
    mean of the gradients with the data strategy's ``AxisReduce``, as a
    reduce-scatter that hands each rank only its slices
    (``Placement.parts``). Alg. 2's n_w counts the whole tensors.

The model-axis collectives are the port's own: list-form ``all_gather`` in
rank order (``core.reduce.gather_list``), partial sums added in f32 in rank
order (``core.reduce.axis_sum``) and cast back, inside autograd functions
that pair each forward collective with its backward (``copy_in``: identity
forward, sum backward, at a column-parallel input; ``reduce_out``: sum
forward, identity backward, at a row-parallel output). Never
``all_reduce``: every replicated value is the same bits on every rank.
The kernels run unchanged on local tensors: ``flash_attention`` on the
rank's query and KV heads (H/M and K/M, or under the head plan's KV groups
its 1–⌈rep/m⌉ query heads against one KV head), ``fused_xent`` on the
gathered head.

Where the head plan has KV groups (``launch.shardings``), the group's
exchanges run over a process group of its own m ranks
(``launch.mesh.kv_group``: one a group, made with ``dist.new_group``, so
a collective moves the group's bytes, 1/K of the model row's; the fake
256/512-rank group of the dry-run takes them alike). The forward's is the
gather of the storage slices (``Placement.gather_``); the backward's acts
on the finished gradients of the compute slices, once an evaluation
after the backward (``Placement.kv_grads``: ``kv_concat`` of ``wq`` and
``wo``, ``sum`` over the group of ``wk`` and ``wv``), so the module
holds only the
rank's heads and a recomputed layer exchanges nothing. Both count their
bytes (``moved``, ``Placement.gather_bytes``) and, in analysis mode,
record themselves through ``gather_list``.

One engine, one step path: ``make_hybrid_step`` runs the body every other
synchronous engine runs, ``train.trainer.make_step_core`` (the fused twin:
``train.chunked.make_chunked_train_step``), with the strategy's reduction
context. ``lr_fn`` reads ψ̄ of the incoming queue outside the step, the
one-step lag of Alg. 1 line 19. ``make_data_parallel_step`` and
``make_chunked_data_parallel_step`` are the reference's aliases.

Batches: on the data-parallel strategy ``step_fn`` takes this rank's rows;
on the tensor-parallel strategy it takes the global batch (the reference's
GSPMD step does) and cuts the rank's rows itself, and its ring is a
``DeviceRing(mesh=, relayout=False)`` in global row order. On the first,
``batch_sharding(mesh)`` cuts the rows from a global host batch,
``prefetched(sampler, mesh)`` (``distributed.prefetch``) stages them, and
a ``DeviceRing(mesh=)`` (``data.device_ring``) holds this rank's stripe of
the relaid-out epoch; the fused and scheduled engines take its ``.arrays``
and gather rows ``[t·b_local, (t+1)·b_local)`` of it on the device.

The fused engine on CUDA captures the collectives into its graph (the
step's and each Alg. 2 trip's, the trips inside IF nodes; on the
tensor-parallel strategy the parameter gathers and model-axis sums too).
That needs a backend whose collective is device work: NCCL. A gloo
collective is host work and cannot sit in a CUDA graph, so ``make_chunked_hybrid_step`` on a
CUDA mesh over gloo raises at construction; it never runs per-step instead.
The reduction's buffers and NCCL's communicator are made before any
capture (``init_fn`` gathers once).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch

from repro_torch.core import ISGDConfig
from repro_torch.core import control
from repro_torch.core.reduce import (AxisReduce, ReduceCtx, axis_sum,
                                     tree_leaves)
from repro_torch.launch.mesh import (MeshError, data_axes, mesh_group,
                                     model_group)
from repro_torch.optim.base import UpdateRule
from repro_torch.sharding.ctx import tensor_parallel


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
    """Non-data mesh axes of size > 1, the tensor-parallel part. Empty ⇒
    the data-parallel strategy; non-empty ⇒ the tensor-parallel one."""
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
    the mesh's first rank's, in place, one broadcast a tensor over all the
    mesh's ranks (the multi-process ``device_put`` of the reference);
    returns the tree. Ranks that built the same params from the same seed
    hold the same bits already; this makes it so whatever they built.
    Replicate whole tensors, before ``hybrid_params_placement`` shards
    them."""
    import torch.distributed as dist
    src = int(mesh.mesh.flatten()[0])
    with torch.no_grad():
        for t in tree_leaves(tree):
            dist.broadcast(t, src=src)
    return tree


def replicated(mesh) -> Callable:
    """The replicated placement of ``mesh``: ``put(tree)`` is
    ``replicate_to_mesh(tree, mesh)``."""
    return lambda tree: replicate_to_mesh(tree, mesh)


class _CopyToModel(torch.autograd.Function):
    """Column-parallel input: identity forward, sum over the model ranks
    backward."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.sum(g), None


class _ReduceFromModel(torch.autograd.Function):
    """Row-parallel output: sum over the model ranks forward, identity
    backward."""

    @staticmethod
    def forward(ctx, x, tp):
        return tp.sum(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ShardHidden(torch.autograd.Function):
    """The rank's 1/M of the hidden stream's last dim (a copy): narrow
    forward, the ranks' gradient slices gathered backward."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return tp.slice_last(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.gather_last(g), None


class _UnshardHidden(torch.autograd.Function):
    """The hidden stream whole from the ranks' slices: gather forward,
    the rank's slice of the (replicated) gradient backward."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return tp.gather_last(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.slice_last(g), None


class TensorParallel:
    """The model axis of an evaluation: its group and size, the two
    autograd collectives the model calls (``copy_in``, ``reduce_out``),
    the KV-group exchanges of the gradients (``sum`` over a KV group,
    ``kv_concat``),
    and ``moved``, the bytes this rank has received in model-axis sums and
    KV-group exchanges; ``shard``/``unshard`` hold the hidden stream as
    the rank's slice of its last dim between the layers of a checkpointed
    stack (``models.transformer.forward``)."""

    def __init__(self, group):
        import torch.distributed as dist
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.moved = 0

    def slice_last(self, x):
        """The rank's 1/size of ``x``'s last dim, contiguous (so a saved
        slice holds no reference to the whole); the last dim must divide
        over the ranks."""
        if x.shape[-1] % self.size:
            raise ValueError(f"a last dim of {x.shape[-1]} does not divide "
                             f"over {self.size} model ranks")
        n = x.shape[-1] // self.size
        return x.narrow(-1, self.rank * n, n).contiguous()

    def gather_last(self, x):
        """The ranks' slices ``x`` concatenated along the last dim in rank
        order (exact)."""
        from repro_torch.core.reduce import gather_list
        self.moved += (self.size - 1) * x.numel() * x.element_size()
        return torch.cat(gather_list(x, self.group), dim=-1)

    def shard(self, x):
        return _ShardHidden.apply(x, self)

    def unshard(self, x):
        return _UnshardHidden.apply(x, self)

    def sum(self, x, group=None):
        """``core.reduce.axis_sum`` over the model ranks, or over ``group``
        (a KV group: the gradient of the KV head its ranks share); no
        autograd. A rank receives 2(W−1)/W of ``x``."""
        import torch.distributed as dist
        group = self.group if group is None else group
        w = dist.get_world_size(group)
        self.moved += 2 * (w - 1) * x.numel() * x.element_size() // w
        return axis_sum(x, group)

    def kv_concat(self, x, dim: int, lengths: list, group):
        """The KV group's ranks' ``x`` (rank j's ``lengths[j]`` wide along
        ``dim``), gathered in rank order and concatenated along ``dim``;
        each padded with zeros to the widest first, as a gather takes
        equal shapes."""
        from repro_torch.core.reduce import gather_list
        w = max(lengths)
        if x.shape[dim] < w:
            pad = list(x.shape)
            pad[dim] = w - x.shape[dim]
            x = torch.cat([x, x.new_zeros(pad)], dim=dim)
        self.moved += (len(lengths) - 1) * x.numel() * x.element_size()
        parts = gather_list(x, group)
        return torch.cat([p.narrow(dim, 0, n) for p, n in zip(parts, lengths)],
                         dim=dim)

    def copy_in(self, x):
        return _CopyToModel.apply(x, self)

    def reduce_out(self, x):
        return _ReduceFromModel.apply(x, self)


@dataclass(frozen=True)
class TensorParallelReduce(ReduceCtx):
    """The tensor-parallel strategy's evaluation (module doc): gather the
    placed parameters (``launch.shardings.Placement``), cut the rank's
    rows of the global batch, run the loss under the model split, take the
    data mean with ``data`` (an ``AxisReduce``) into the rank's slices.
    ``bound`` holds the placement ``MeshStrategy.bind`` found."""

    axis: Any = "data"
    data: Any = None
    tp: Any = None
    rows: Any = None
    bound: dict = field(default_factory=dict, compare=False, repr=False)

    @property
    def placement(self):
        pl = self.bound.get("placement")
        if pl is None:
            raise RuntimeError("the tensor-parallel engine's init_fn was "
                               "not called with placed params")
        return pl

    def param_count(self, params) -> float:
        return self.placement.global_numel

    def parts(self):
        """What this rank keeps of each gradient's data mean: its slices
        (``Placement.parts``, made once)."""
        parts = self.bound.get("parts")
        if parts is None:
            parts = self.bound["parts"] = self.placement.parts()
        return parts

    def prime(self, tensors, device) -> None:
        self.placement.gather_()
        # the data mean takes each gradient in its gathered shape
        # (``Placement.kv_grads``)
        self.data.prime([torch.empty(lf.gathered, device="meta")
                         for lf in self.placement.leaves],
                        device, self.parts())
        self.tp.sum(torch.zeros(1, device=device))

    @property
    def buffer_bytes(self) -> dict:
        return self.data.buffer_bytes

    def wrap_loss_and_grad(self, loss_and_grad: Callable) -> Callable:
        def local(params, batch):
            with tensor_parallel(self.tp):
                out, grads = loss_and_grad(self.placement.compute,
                                           self.rows(batch))
            grads = list(grads)
            return out, self.placement.kv_grads(grads, self.tp)

        mean = self.data.wrap_loss_and_grad(local, parts=self.parts)

        def lg(params, batch):
            self.placement.gather_()
            return mean(params, batch)

        return lg


class MeshStrategy:
    """The strategy dispatch point, resolved once (module doc):
    ``reduce_ctx`` (what ``make_step_core`` reduces ψ and the gradients
    with: the data strategy's ``AxisReduce``, or the tensor-parallel
    ``TensorParallelReduce`` around it), ``axis``, ``tensor_axes`` and
    ``tensor_parallel`` (True on the second strategy)."""

    def __init__(self, mesh, axis=None):
        axes = _norm_axes(mesh, axis)
        self.mesh = mesh
        self.axis = axes[0] if len(axes) == 1 else axes
        self.tensor_axes = tensor_axes(mesh, axes)
        self.tensor_parallel = bool(self.tensor_axes)
        self.group = mesh_group(mesh)
        data = AxisReduce(self.axis, deterministic=True, group=self.group)
        self.tp = None
        if self.tensor_parallel:
            if self.tensor_axes != ("model",):
                raise MeshError(f"tensor-parallel axes {self.tensor_axes}: "
                                f"only a 'model' axis is supported")
            self.tp = TensorParallel(model_group(mesh))
            self.reduce_ctx = TensorParallelReduce(
                axis=self.axis, data=data, tp=self.tp,
                rows=BatchShard(self.group.rank(), self.group.size()))
        else:
            self.reduce_ctx = data

    def backend(self) -> str:
        import torch.distributed as dist
        return dist.get_backend(self.group)

    def bind(self, params) -> None:
        """The tensor-parallel strategy reads the placement of ``params``
        (``launch.shardings.hybrid_params_placement``'s local shards); a
        mesh with a model axis never runs unplaced params replicated."""
        if not self.tensor_parallel:
            return
        pl = getattr(params[0], "_repro_placement", None)
        if pl is None or pl.mesh is not self.mesh \
                or [id(t) for t in pl.local] != [id(t) for t in params]:
            raise ValueError(
                f"mesh axes {self.tensor_axes} are tensor-parallel: pass "
                f"the local shards that launch.shardings."
                f"hybrid_params_placement(mesh, params) returns for this "
                f"mesh")
        self.reduce_ctx.bound["placement"] = pl

    def prime(self, params) -> None:
        """Make the reduction's buffers and the communicators now, before
        a capture (``AxisReduce.prime``)."""
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
    where ``batch`` holds this rank's rows of the global batch, or on the
    tensor-parallel strategy the global batch (module doc). Params are
    replicated (start them equal on every rank, ``replicate_to_mesh``), or
    on the tensor-parallel strategy the local shards of
    ``launch.shardings.hybrid_params_placement``; the gradients are
    reduced before the base update and ψ before the queue push, so every rank computes the same new
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
        strat.bind(params)
        state = init_core(params)
        strat.prime(params)
        return state

    init_fn.reduce_ctx = strat.reduce_ctx
    init_fn.strategy = strat
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
        strat.bind(params)
        state = init_core(params)
        strat.prime(params)
        return state

    init_fn.reduce_ctx = strat.reduce_ctx
    init_fn.strategy = strat
    return init_fn, chunk_fn


# the pure data-parallel engine IS the hybrid engine on a pure-data mesh;
# the reference's names stay as aliases
make_data_parallel_step = make_hybrid_step
make_chunked_data_parallel_step = make_chunked_hybrid_step
