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
each element's mean is ``((x_0 + x_1) + … + x_{W-1}) / W``, the ranks'
values added in rank order and divided once (``shard_mean``), so the
result is a pure function of the shard values, the same bits on every rank
and on any backend. It never calls ``all_reduce``, whose association is the
backend's. The gradient tree, ψ and the aux scalar of one evaluation travel
in ONE flat f32 bucket; each leaf's mean is cast back to its dtype, which
is the reference's per-leaf ``jnp.mean`` (f32 accumulation for a bf16 leaf)
element for element.

The mean is a reduce-scatter in that form (``_Plan``):

  1. each rank packs its bucket by destination: segment r holds exactly
     the elements rank r reduces;
  2. segment r goes to rank r (``exchange``: over NCCL ``exchange_p2p``,
     a copy of the rank's own segment and one batch of sends and
     receives, which a CUDA graph can capture; over gloo ``exchange_a2a``,
     one ``all_to_all_single``, which gloo takes for CUDA tensors);
  3. rank r takes ``shard_mean`` over the W segments it received, in rank
     order.

Every element is summed by exactly one rank, in the order a gather of every
rank's bucket would sum it, so the bits are the gather form's. What a rank
keeps of the means is stated by ``Parts`` (the hybrid engine's FSDP slices,
``launch.shardings.Placement.parts``): a leaf sliced over ``data`` is
reduced on the ranks that keep its slices and never leaves them; every
other leaf (ψ, aux, replicated leaves, every leaf of the pure data-parallel
engine) is split evenly over the ranks and its means are gathered back in
rank order (``gather``): a reduce-scatter then an all-gather, the standard
form of an all-reduce, with the association fixed. On a pod mesh a data
slice is kept by P ranks, one a pod: each reduces 1/P of it and the P means
are gathered over the pod group. Where a split does not divide, the last
segments are shorter and the means are padded with zeros to the gather's
width. A one-rank group still exchanges and gathers; its mean is the value
itself, bit for bit.

The buffers are the bucket (n,) and one receive buffer of about
``W·⌈n/W⌉``: at most 2n + W f32 elements where no pod splits a slice
(``buffer_bytes``). The receive buffer takes the W received segments, then
the gathered means. Both are allocated once per layout and device,
outside any capture, and written in place afterwards, so a CUDA graph that
captured a reduction (the fused engine) holds valid addresses at every
replay. The gradients an evaluation returns are views of (or, for a bf16
leaf, casts from) these buffers: they are valid until the next reduction,
which is all a step needs.

In analysis mode (``repro_torch.analysis``) every collective records
itself (``analysis.count.collective``): the exchange as the reduce-scatter
it is, with its operand (the bucket) and result (the rank's segment)
bytes, and each gather of means as an all-gather; ``axis_sum`` records
its exchange as a reduce-scatter and gathers its sums through
``gather_list``. A count is made over a gloo
or fake group, so it models ``exchange_a2a``: the collective's record
and no device op. Over NCCL ``exchange_p2p`` also copies the rank's own
segment on the device (n/W f32 read and written), work the count does
not have.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch

from repro_torch.analysis.mode import in_analysis_mode


def _record(kind: str, result_bytes: int, operand_bytes: int, group) -> None:
    if in_analysis_mode():
        from repro_torch.analysis import count
        count.collective(kind, result_bytes, operand_bytes,
                         count.group_ranks(group))


def _record_gather(x: torch.Tensor, world: int, group) -> None:
    n = x.numel() * x.element_size()
    _record("all-gather", world * n, n, group)


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
    """The sum of ``x`` over the ranks of ``group`` (the model axis' partial
    sums), as a reduce-scatter then a gather: each rank adds its ⌈n/W⌉
    elements of every rank's ``x`` in f32 in rank order, as ``shard_sum``
    adds, casts them back to ``x.dtype`` and the W sums are gathered in
    rank order. So each element is the gather form's ``((x_0 + x_1) + …)``
    in f32, cast once, the same bits on every rank, and a rank receives
    2(W−1)/W of ``x`` where gathering every rank's ``x`` took W − 1 copies
    of it. Never an ``all_reduce``. A one-rank group returns ``x``."""
    import torch.distributed as dist
    world = dist.get_world_size(group)
    if world == 1:
        return x
    n = x.numel()
    m = _ceil(n, world)
    flat = x.reshape(-1)
    if world * m != n:
        flat = torch.cat([flat, flat.new_zeros(world * m - n)])
    got = flat.new_empty(world, m)
    _record("reduce-scatter", m * x.element_size(),
            flat.numel() * x.element_size(), group)
    exchange = exchange_p2p if dist.get_backend(group) == "nccl" \
        else exchange_a2a
    exchange(flat, got, [m] * world, group)
    mine = got[0].to(torch.float32, copy=True)
    for r in range(1, world):
        mine.add_(got[r].to(torch.float32))
    sums = gather_list(mine.to(x.dtype), group)
    return torch.cat(sums)[:n].view(x.shape)


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


@dataclass(frozen=True)
class Parts:
    """What each rank of a reduction keeps of each leaf's mean.

    ``leaves`` has one entry a leaf: ``None``, the whole leaf on every
    rank; or ``(ddim, box)``, ``box`` this rank's part as one ``(start,
    stop)`` a dim. With ``ddim`` None every rank of the group keeps that
    same part (a slice over another axis, e.g. ``model``). Otherwise dim
    ``ddim`` of the part is this data rank's slice, ``shape[ddim] / data``
    wide, and data rank c keeps ``box`` with that dim at ``[c·w,
    (c+1)·w)``. The group's W ranks are ``P × data`` in pod-major order
    (flat rank ``p·data + c``); ``pod_group`` is this rank's group of the P
    ranks that keep the same slices (None where P is 1)."""

    leaves: tuple
    data: int = 1
    pod_group: Any = field(default=None, compare=False, hash=False)

    def with_whole(self, k: int) -> "Parts":
        """These parts behind ``k`` leaves kept whole (ψ and aux)."""
        return Parts((None,) * k + self.leaves, self.data, self.pod_group)


def _copy_flat(dst: torch.Tensor, src: torch.Tensor, lo: int,
               hi: int) -> None:
    """``dst`` (hi - lo,) <- elements ``[lo, hi)`` of ``src`` flattened in
    row-major order, through views of ``src``: a partial first row, the
    whole rows between, a partial last row (each partial row the same way
    one dim down), so a strided part is never copied whole to be cut."""
    if lo >= hi:
        return
    if src.dim() <= 1 or src.is_contiguous():
        dst.copy_(src.reshape(-1)[lo:hi])
        return
    inner = src[0].numel()
    r, a = divmod(lo, inner)
    o = 0
    if a:
        b = min(hi - r * inner, inner)
        _copy_flat(dst[:b - a], src[r], a, b)
        o, r = b - a, r + 1
    rows = (hi - r * inner) // inner
    if rows > 0:
        dst[o:o + rows * inner].view(rows, *src.shape[1:]).copy_(
            src[r:r + rows])
        o, r = o + rows * inner, r + rows
    _copy_flat(dst[o:], src[r] if r < src.shape[0] else src[:0], 0,
               hi - r * inner)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _clip(x: int, hi: int) -> int:
    return max(0, min(hi, x))


class _Plan:
    """The layout of one reduction on one rank (module doc), for leaves of
    ``shapes`` kept as ``parts`` says (None: all whole).

    The *whole region* is the whole-kept leaves' parts, flat, in leaf
    order: n_w elements, rank q reducing ``[q·m_w, (q+1)·m_w)`` (m_w =
    ⌈n_w/W⌉; the last ranks' ranges are shorter or empty). The *slice
    region* E_c of data rank c is the sliced leaves' data-c slices, flat,
    in leaf order: n_s elements, pod p's rank reducing ``[p·m_s,
    (p+1)·m_s)`` of it (m_s = ⌈n_s/P⌉). Segment q of the bucket, for rank
    q = p·D + c, is its part of E_c then its part of the whole region.
    ``ops`` packs the bucket: ``(leaf, index, lo, hi, dst)`` copies
    elements ``[lo, hi)`` of ``leaf[index]`` (flattened) to ``bucket[dst:]``.
    After the exchange and the mean, the whole means are gathered into
    ``recv[:W·m_w]`` and, on a pod mesh, the slice means into
    ``recv[W·m_w:]``; ``outs`` reads each leaf's part from there:
    ``(buffer name, offset, shape)``."""

    def __init__(self, shapes, parts: Optional[Parts], world: int,
                 rank: int, device):
        D = parts.data if parts is not None else 1
        if world % D:
            raise ValueError(f"a reduction over {world} ranks cannot keep "
                             f"slices over {D} data ranks")
        W, P = world, world // D
        if parts is not None and P > 1 and parts.pod_group is None and any(
                e is not None and e[0] is not None for e in parts.leaves):
            raise ValueError(f"slices over {D} of {world} ranks are kept "
                             f"by {P} ranks each: Parts needs their "
                             f"pod_group")
        pod, c = divmod(rank, D)
        entries = parts.leaves if parts is not None else (None,) * len(shapes)
        if len(entries) != len(shapes):
            raise ValueError(f"{len(entries)} parts for {len(shapes)} leaves")

        def numel(shape) -> int:
            return int(torch.Size(shape).numel())

        # each leaf: (kind, index for data rank c -> tuple or None, part shape)
        whole, sliced = [], []
        for i, (shape, e) in enumerate(zip(shapes, entries)):
            if e is None:
                whole.append((i, lambda _c: None, tuple(shape)))
                continue
            ddim, box = e
            part = tuple(b - a for a, b in box)
            if ddim is None:
                idx = tuple(slice(a, b) for a, b in box)
                whole.append((i, lambda _c, idx=idx: idx, part))
                continue
            w = shape[ddim] // D

            def index(cc, box=box, ddim=ddim, w=w):
                return tuple(slice(cc * w, (cc + 1) * w) if d == ddim
                             else slice(a, b) for d, (a, b) in enumerate(box))
            sliced.append((i, index, part))
        n_w = sum(numel(s) for _, _, s in whole)
        n_s = sum(numel(s) for _, _, s in sliced)
        m_w, m_s = _ceil(n_w, W), _ceil(n_s, P)

        def slice_len(p):
            return _clip(n_s - p * m_s, m_s)

        def whole_len(q):
            return _clip(n_w - q * m_w, m_w)

        self.sizes = [slice_len(q // D) + whole_len(q) for q in range(W)]
        seg = [0]
        for s in self.sizes[:-1]:
            seg.append(seg[-1] + s)
        ops = []
        o = 0
        for i, index, shape in whole:
            k = numel(shape)
            for q in range(o // m_w, _ceil(o + k, m_w)) if k else ():
                a, b = max(o, q * m_w), min(o + k, (q + 1) * m_w)
                ops.append((i, index(0), a - o, b - o,
                            seg[q] + slice_len(q // D) + a - q * m_w))
            o += k
        for cc in range(D):
            o = 0
            for i, index, shape in sliced:
                k = numel(shape)
                for p in range(o // m_s, _ceil(o + k, m_s)) if k else ():
                    a, b = max(o, p * m_s), min(o + k, (p + 1) * m_s)
                    ops.append((i, index(cc), a - o, b - o,
                                seg[p * D + cc] + a - p * m_s))
                o += k
        self.ops = ops
        outs = [None] * len(shapes)
        o = 0
        for i, _, shape in whole:
            outs[i] = ("recv", o, shape)
            o += numel(shape)
        o = W * m_w if P > 1 else 0
        for i, _, shape in sliced:
            outs[i] = ("recv" if P > 1 else "flat", o, shape)
            o += numel(shape)
        self.outs = outs
        self.world, self.pods = W, P
        self.pod_group = parts.pod_group if parts is not None else None
        self.m_w, self.m_s = m_w, m_s
        self.mine = self.sizes[rank]            # the segment this rank reduces
        self.t = slice_len(pod)                 # its slice part comes first
        n = sum(self.sizes)
        f32 = dict(dtype=torch.float32, device=device)
        self.flat = torch.empty(n, **f32)
        self.recv = torch.empty(max(W * self.mine,
                                    W * m_w + (P * m_s if P > 1 else 0)),
                                **f32)

    def received(self) -> torch.Tensor:
        """The (W, mine) view the exchange fills."""
        return self.recv[:self.world * self.mine].view(self.world, self.mine)


def exchange_a2a(bucket: torch.Tensor, out: torch.Tensor, sizes: list,
                 group=None) -> torch.Tensor:
    """``AxisReduce.exchange`` as one ``all_to_all_single``: the form gloo
    takes for CUDA tensors (it stages them through the host)."""
    import torch.distributed as dist
    world, s = out.shape
    dist.all_to_all_single(out.view(-1), bucket,
                           output_split_sizes=[s] * world,
                           input_split_sizes=sizes, group=group)
    return out


def exchange_p2p(bucket: torch.Tensor, out: torch.Tensor, sizes: list,
                 group=None) -> torch.Tensor:
    """``AxisReduce.exchange`` as a device copy of the rank's own segment
    and one batch of point-to-point sends and receives for the others: the
    form taken over NCCL. For ``paper-transformer`` base's 1.275 GB bucket
    on H100s over NVLink, one rank a card, it took 0.90, 3.28 and 5.99 ms
    at W = 1, 2 and 4, against 1.02, 3.89 and 5.92 ms for ``exchange_a2a``
    (``launch/exchange_time.py``). Inside the engine a one-rank step
    through ``exchange_a2a`` took 1.47 s against 0.29 s, and its fused run
    did not finish; that cause was not found."""
    import torch.distributed as dist
    world, s = out.shape
    me = dist.get_rank(group)
    starts = [0]
    for n in sizes[:-1]:
        starts.append(starts[-1] + n)
    out[me].copy_(bucket[starts[me]:starts[me] + sizes[me]])
    ops = []
    for q in range(world):
        if q == me:
            continue
        peer = q if group is None else dist.get_global_rank(group, q)
        if sizes[q]:
            ops.append(dist.P2POp(dist.isend, bucket[
                starts[q]:starts[q] + sizes[q]], peer, group))
        if s:
            ops.append(dist.P2POp(dist.irecv, out[q], peer, group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out


@dataclass(frozen=True)
class AxisReduce(ReduceCtx):
    """Mean over the ranks of ``group`` (None: the default group), the
    data sub-axis ``axis`` of the mesh, as a reduce-scatter in rank order
    (module doc). Ranks are the flat shard order: rank r holds rows
    ``[r·b/n, (r+1)·b/n)`` of the global batch, as ``P("data")`` lays them
    out in the reference.

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
                "the port reduces only in rank order, by a reduce-scatter "
                "of its own and a gather of the means")

    # -- the collectives --------------------------------------------------
    def world(self) -> int:
        import torch.distributed as dist
        return dist.get_world_size(self.group)

    def _plan(self, shapes, parts: Optional[Parts], device) -> _Plan:
        key = (tuple(tuple(s) for s in shapes), parts, str(device))
        plan = self._cache.get(key)
        if plan is None:
            if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    "AxisReduce: a reduction of a new layout inside a "
                    "CUDA-graph capture; run it once eagerly first so that "
                    "its buffers exist outside the capture")
            import torch.distributed as dist
            plan = self._cache[key] = _Plan(
                shapes, parts, self.world(), dist.get_rank(self.group), device)
        return plan

    @property
    def buffer_bytes(self) -> dict:
        """The bytes of the buffers this context holds, over every layout
        it has reduced: {"bucket": the buckets, packed by destination and
        then holding this rank's means, "received": the receive buffers,
        the W segments received and then the gathered means}."""
        plans = self._cache.values()
        return {"bucket": sum(p.flat.nbytes for p in plans),
                "received": sum(p.recv.nbytes for p in plans)}

    def gather(self, x: torch.Tensor, out: torch.Tensor,
               group: Any = None) -> torch.Tensor:
        """``out`` (world, *x.shape) <- x of every rank of ``group`` (None:
        this context's), in rank order. A failed collective raises."""
        import torch.distributed as dist
        group = self.group if group is None else group
        _record_gather(x, out.shape[0], group)
        if dist.get_backend(group) == "nccl":
            dist.all_gather_into_tensor(out, x, group=group)
        else:                       # gloo: the list form takes CUDA tensors
            dist.all_gather(list(out.unbind(0)), x, group=group)
        return out

    def exchange(self, bucket: torch.Tensor, out: torch.Tensor,
                 sizes: list) -> torch.Tensor:
        """``out`` (world, s) <- segment ``rank`` of every rank's ``bucket``
        (segments of ``sizes``, in rank order), in rank order: over NCCL
        ``exchange_p2p``, over gloo (and the dry-run's fake group)
        ``exchange_a2a``. A failed collective raises."""
        import torch.distributed as dist
        if dist.get_backend(self.group) == "nccl":
            return exchange_p2p(bucket, out, sizes, self.group)
        return exchange_a2a(bucket, out, sizes, self.group)

    def _run(self, plan: _Plan) -> None:
        """Exchange the packed bucket, take this rank's means and gather
        them where other ranks keep them (module doc)."""
        flat, got, t, m_s, m_w = (plan.flat, plan.received(), plan.t,
                                  plan.m_s, plan.m_w)
        # the reduce-scatter: operand the bucket, result this rank's segment
        _record("reduce-scatter", got.shape[1] * 4, flat.numel() * 4,
                self.group)
        self.exchange(flat, got, plan.sizes)
        shard_mean(got[:, :t], out=flat[:t])
        flat[t:m_s].zero_()
        w = got.shape[1] - t
        shard_mean(got[:, t:], out=flat[m_s:m_s + w])
        flat[m_s + w:m_s + m_w].zero_()
        if m_w:
            self.gather(flat[m_s:m_s + m_w],
                        plan.recv[:plan.world * m_w].view(plan.world, m_w))
        if plan.pods > 1 and m_s:
            o = plan.world * m_w
            self.gather(flat[:m_s], plan.recv[o:o + plan.pods * m_s].view(
                plan.pods, m_s), group=plan.pod_group)

    def prime(self, tensors, device, parts: Optional[Parts] = None) -> None:
        """Allocate the buffers for a tree of ``tensors``' shapes behind the
        two loss scalars of ``wrap_loss_and_grad`` (``parts`` as it is
        passed there) and run one reduction of zeros, so that a lazily made
        communicator (NCCL's) and the buffers exist before a CUDA graph
        captures the reduction."""
        shapes = [(), ()] + [tuple(t.shape) for t in tree_leaves(tensors)]
        plan = self._plan(shapes, None if parts is None
                          else parts.with_whole(2), device)
        with torch.no_grad():
            plan.flat.zero_()
            self._run(plan)

    def _reduce(self, tree, copy: bool = True,
                parts: Optional[Parts] = None):
        """The tree's mean over the ranks, each leaf's part as ``parts``
        keeps it (None: whole), through the bucket; ``copy=False`` leaves
        f32 leaves as views of the buffers (valid until the next
        reduction)."""
        leaves = tree_leaves(tree)
        plan = self._plan([t.shape for t in leaves], parts, leaves[0].device)
        with torch.no_grad():
            flat = plan.flat
            for i, idx, lo, hi, dst in plan.ops:
                src = leaves[i] if idx is None else leaves[i][idx]
                if lo == 0 and hi == src.numel():
                    flat[dst:dst + hi].view(src.shape).copy_(src)
                else:
                    _copy_flat(flat[dst:dst + hi - lo], src, lo, hi)
            self._run(plan)
            out = []
            for t, (buf, o, shape) in zip(leaves, plan.outs):
                n = int(torch.Size(shape).numel())
                v = getattr(plan, buf)[o:o + n].view(shape)
                if v.dtype != t.dtype:
                    v = v.to(t.dtype)
                elif copy:
                    v = v.clone()
                out.append(v)
        return _rebuild(tree, iter(out))

    # -- the reference's surface ------------------------------------------
    def scalar(self, x):
        return self._reduce(x)

    def tree(self, t):
        return self._reduce(t)

    def wrap_loss_and_grad(self, loss_and_grad: Callable,
                           parts: Optional[Callable] = None) -> Callable:
        """One bucket an evaluation: ψ, aux and the gradients. ψ and aux
        come back as tensors of their own (the metrics keep them); the
        gradients as views of the buffers, consumed before the next
        evaluation. ``parts``, where given, returns the gradients'
        ``Parts`` at each evaluation: each gradient comes back as the part
        this rank keeps."""

        def lg(params, batch):
            (loss, aux), grads = loss_and_grad(params, batch)
            p = None if parts is None else parts().with_whole(2)
            (loss, aux), grads = self._reduce(((loss, aux), grads),
                                              copy=False, parts=p)
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
