"""Pluggable gradient/ψ reduction context.

Port of ``repro.core.reduce``. The ISGD controller's correctness under
data parallelism hinges on one invariant (paper §6): the monitored loss ψ
and the subproblem gradients must be *globally reduced*, so that the
accelerate predicate and every Alg. 2 trip take the same branch on every
rank. ``core.isgd``'s step forms therefore take a ``ReduceCtx`` and route
every ``loss_and_grad`` evaluation through ``wrap_loss_and_grad``:

  * ``LocalReduce``: the identity, single-device semantics (the default);
  * ``AxisReduce``: the mean over the ranks of a ``torch.distributed``
    group (the data-parallel engine, ``repro_torch.distributed``); on a
    ``(pod, data, model)`` mesh the group is the flattened ``(pod, data)``
    ranks in pod-major order (``launch.mesh.mesh_group``);
  * ``StalenessReduce``: the async parameter-server regime (paper §6.2);
    loss and gradients stay local during the step and the server folds
    each worker's delta in with the staleness weight ``w(τ)`` defined
    here (``weight``).

``AxisReduce`` is the reference's deterministic mode and nothing else:
every value is gathered from every rank in rank order and reduced
*locally*, as ``((x_0 + x_1) + … + x_{n-1}) / n`` (``shard_mean``), so the
result is a pure function of the shard values, the same bits on every rank
and on any backend. It never calls ``all_reduce``, whose association is the
backend's. The gradient tree, ψ and the aux scalar of one evaluation travel
in ONE flat f32 bucket (one collective, not one per leaf); each leaf's mean
is cast back to its dtype, which is the reference's per-leaf ``jnp.mean``
(f32 accumulation for a bf16 leaf) element for element. A one-rank group
still gathers; its mean is the value itself, bit for bit.

The bucket and the gathered ``(world, n)`` buffer are allocated once per
size and device and written in place afterwards (the mean goes back into
the bucket), so a CUDA graph that captured a reduction (the fused engine)
holds valid addresses at every replay. The gradients an evaluation returns
are views of (or, for a bf16 leaf, casts from) the bucket: they are valid
until the next reduction, which is all a step needs.

In analysis mode (``repro_torch.analysis``) every gather records itself,
an all-gather with its result and operand bytes over its group's ranks
(``analysis.count.collective``); ``axis_sum`` gathers through
``gather_list`` and so records once.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch

from repro_torch.analysis.mode import in_analysis_mode


def _record_gather(x: torch.Tensor, world: int, group) -> None:
    if in_analysis_mode():
        from repro_torch.analysis import count
        n = x.numel() * x.element_size()
        count.collective("all-gather", world * n, n, count.group_ranks(group))


def shard_sum(stacked: torch.Tensor, out: Optional[torch.Tensor] = None):
    """Sum over the leading (shard) axis of ``stacked``, in shard order:
    ``(s_0 + s_1) + … + s_{n-1}``, into ``out`` where given."""
    out = stacked[0].clone() if out is None else out.copy_(stacked[0])
    for r in range(1, stacked.shape[0]):
        out.add_(stacked[r])
    return out


def gather_list(x: torch.Tensor, group) -> list:
    """``x`` of every rank of ``group``, in rank order: the list form of
    ``all_gather``, the one form gloo takes for CUDA tensors."""
    import torch.distributed as dist
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    _record_gather(x, len(parts), group)
    dist.all_gather(parts, x.contiguous(), group=group)
    return parts


def axis_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group`` (the model axis'
    partial sums): gathered in rank order, added in f32 as ``shard_sum``
    adds, cast back to ``x.dtype``; the same bits on every rank. Never an
    ``all_reduce``. A one-rank group returns ``x``."""
    import torch.distributed as dist
    if dist.get_world_size(group) == 1:
        return x
    parts = gather_list(x, group)
    out = parts[0].to(torch.float32, copy=True)
    for p in parts[1:]:
        out.add_(p.to(torch.float32))
    return out.to(x.dtype)


def shard_mean(stacked: torch.Tensor, out: Optional[torch.Tensor] = None):
    """``shard_sum`` divided once by the shard count. Equal to
    ``stacked.mean(0)`` on the CPU for up to four shards; for more, torch's
    own reduction associates otherwise, this stays fixed."""
    return shard_sum(stacked, out).div_(stacked.shape[0])


def tree_leaves(tree) -> list:
    """The tensors of a tree of tuples, lists and dicts, in order."""
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    raise TypeError(f"a reduced tree holds tensors, not {type(tree).__name__}")


def _rebuild(tree, it):
    if torch.is_tensor(tree):
        return next(it)
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(v, it) for v in tree))
    return type(tree)(_rebuild(v, it) for v in tree)


@dataclass(frozen=True)
class ReduceCtx:
    """Base: identity (local) reduction."""

    #: mesh axis the context reduces over; ``None`` = purely local.
    axis: Optional[str] = None

    def scalar(self, x):
        """Reduce a per-shard scalar (mean over participating ranks)."""
        return x

    def tree(self, t):
        """Reduce a tree of per-shard tensors (mean over ranks)."""
        return t

    def sum_scalar(self, x):
        """Reduce a per-shard scalar by summation."""
        return x

    def param_count(self, params) -> float:
        """n_w of Alg. 2's proximal term: the parameter count of the model
        (a sharded engine counts the whole tensors, not its shards)."""
        return float(sum(w.numel() for w in params))

    def wrap_loss_and_grad(self, loss_and_grad: Callable) -> Callable:
        """``((loss, aux), grads)``-returning fn -> globally reduced variant.

        The single choke point of the ψ invariant: every consumer of the
        wrapped fn (base update, control queue, accelerate predicate,
        subproblem solver) sees identical values on all ranks. The local
        contexts return it as it is."""
        return loss_and_grad


@dataclass(frozen=True)
class LocalReduce(ReduceCtx):
    """Single-device / per-shard semantics (identity)."""


class _Buffers:
    """The static f32 buffers of one reduction size on one device: the
    bucket (n,), packed and then overwritten with the mean, and the
    gathered (world, n)."""

    def __init__(self, n: int, world: int, device):
        f32 = dict(dtype=torch.float32, device=device)
        self.flat = torch.empty(n, **f32)
        self.gathered = torch.empty(world, n, **f32)


@dataclass(frozen=True)
class AxisReduce(ReduceCtx):
    """Mean over the ranks of ``group`` (None: the default group), the
    data sub-axis ``axis`` of the mesh, by gather and local reduction in
    rank order (module doc). Ranks are the flat shard order: rank r holds
    rows ``[r·b/n, (r+1)·b/n)`` of the global batch, as ``P("data")`` lays
    them out in the reference.

    ``deterministic`` is the reference's switch between this mode and a
    backend all-reduce; the port has only this mode, and ``False`` raises.
    """

    axis: Any = "data"
    deterministic: bool = True
    group: Any = None
    _cache: dict = field(default_factory=dict, compare=False, repr=False)

    def __post_init__(self):
        if not self.deterministic:
            raise ValueError(
                "AxisReduce(deterministic=False) would reduce with the "
                "backend's all-reduce, whose association is the backend's; "
                "the port reduces only by gather and rank-order mean")

    # -- the collective -------------------------------------------------
    def world(self) -> int:
        import torch.distributed as dist
        return dist.get_world_size(self.group)

    def _buffers(self, n: int, device) -> _Buffers:
        key = (n, str(device))
        buf = self._cache.get(key)
        if buf is None:
            if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    "AxisReduce: a reduction of a new size inside a CUDA-graph "
                    "capture; run it once eagerly first so that its buffers "
                    "exist outside the capture")
            buf = self._cache[key] = _Buffers(n, self.world(), device)
        return buf

    @property
    def buffer_bytes(self) -> dict:
        """The bytes of the buffers this context holds, over every size it
        has reduced: {"bucket": the (n,) buckets, "gathered": the
        (world, n) buffers}."""
        bufs = self._cache.values()
        return {"bucket": sum(b.flat.nbytes for b in bufs),
                "gathered": sum(b.gathered.nbytes for b in bufs)}

    def gather(self, x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
        """``out`` (world, *x.shape) <- x of every rank, in rank order. A
        failed collective raises."""
        import torch.distributed as dist
        _record_gather(x, out.shape[0], self.group)
        if dist.get_backend(self.group) == "nccl":
            dist.all_gather_into_tensor(out, x, group=self.group)
        else:                       # gloo: the list form takes CUDA tensors
            dist.all_gather(list(out.unbind(0)), x, group=self.group)
        return out

    def prime(self, tensors, device) -> None:
        """Allocate the buffers for a tree of ``tensors``' size (plus the
        two loss scalars of ``wrap_loss_and_grad``) and run one gather, so
        that a lazily made communicator (NCCL's) and the buffers exist
        before a CUDA graph captures the reduction."""
        n = sum(t.numel() for t in tree_leaves(tensors)) + 2
        buf = self._buffers(n, device)
        buf.flat.zero_()
        self.gather(buf.flat, buf.gathered)

    def _reduce(self, tree, copy: bool = True):
        """The tree's mean over the ranks, through the bucket; ``copy=False``
        leaves f32 leaves as views of the bucket (valid until the next
        reduction)."""
        leaves = tree_leaves(tree)
        n = sum(t.numel() for t in leaves)
        buf = self._buffers(n, leaves[0].device)
        with torch.no_grad():
            o = 0
            for t in leaves:
                buf.flat[o:o + t.numel()].copy_(t.reshape(-1))
                o += t.numel()
            self.gather(buf.flat, buf.gathered)
            shard_mean(buf.gathered, out=buf.flat)
            out, o = [], 0
            for t in leaves:
                v = buf.flat[o:o + t.numel()].view(t.shape)
                if v.dtype != t.dtype:
                    v = v.to(t.dtype)
                elif copy:
                    v = v.clone()
                out.append(v)
                o += t.numel()
        return _rebuild(tree, iter(out))

    # -- the reference's surface ------------------------------------------
    def scalar(self, x):
        return self._reduce(x)

    def tree(self, t):
        return self._reduce(t)

    def wrap_loss_and_grad(self, loss_and_grad: Callable) -> Callable:
        """One bucket an evaluation: ψ, aux and the gradients. ψ and aux
        come back as tensors of their own (the metrics keep them); the
        gradients as views of the bucket, consumed before the next
        evaluation."""

        def lg(params, batch):
            (loss, aux), grads = loss_and_grad(params, batch)
            (loss, aux), grads = self._reduce(((loss, aux), grads),
                                              copy=False)
            return (loss.clone(), aux.clone()), grads

        return lg

    def sum_scalar(self, x):
        import torch.distributed as dist
        with torch.no_grad():
            out = torch.empty((dist.get_world_size(self.group), *x.shape),
                              dtype=x.dtype, device=x.device)
            return shard_sum(self.gather(x.contiguous(), out))


@dataclass(frozen=True)
class StalenessReduce(ReduceCtx):
    """Async parameter-server reduction (paper §6.2).

    ``axis`` stays ``None``: during the step every ``loss_and_grad``
    evaluation is the worker's own, so Alg. 2 trips on per-worker values
    and needs no collective. The server owns the canonical loss queue and
    folds each pushed delta in with the staleness weight ``w(τ)`` defined
    here, τ being the server versions applied between a worker's pull and
    its push. ``w(0) == 1`` for every family:

      * ``"inverse"``: ``w(τ) = 1 / (1 + alpha·τ)`` (the default);
      * ``"exp"``: ``w(τ) = exp(-alpha·τ)``;
      * ``"none"``: ``w(τ) = 1``.
    """

    decay: str = "inverse"
    alpha: float = 1.0

    def weight(self, tau):
        """Staleness weight ``w(τ)``, f32; takes Python ints or tensors."""
        tau = torch.as_tensor(tau, dtype=torch.float32)
        if self.decay == "inverse":
            return 1.0 / (1.0 + self.alpha * tau)
        if self.decay == "exp":
            return torch.exp(-self.alpha * tau)
        if self.decay == "none":
            return torch.ones_like(tau)
        raise ValueError(f"unknown staleness decay {self.decay!r}")


def staleness_reduce_from_spec(spec: str) -> StalenessReduce:
    """Parse a ``--staleness-decay`` spec: ``"inverse"``, ``"exp:0.5"``,
    ``"none"``, i.e. ``family[:alpha]``."""
    family, _, alpha = spec.partition(":")
    ctx = StalenessReduce(decay=family, alpha=float(alpha) if alpha else 1.0)
    ctx.weight(0)                      # validate the family eagerly
    return ctx


LOCAL = LocalReduce()
