"""Cost count of eager PyTorch on the meta device: the port's counterpart
of the reference's ``compiled.cost_analysis()`` and ``memory_analysis()``.

The reference compiles a step with XLA and reads the compiled artifact.
The port has no compiler between the step and the device: what runs is
the sequence of aten ops PyTorch dispatches, each a kernel of its own, plus
the hand-written kernels. ``CostCount`` is a ``TorchDispatchMode`` that
watches that sequence while the step runs on meta tensors (shapes and
dtypes, no data, no device), and counts:

  * **FLOPs**: every aten op that ``torch.utils.flop_counter`` has a
    formula for, by the same rule as its ``FlopCounterMode`` (an op
    without a formula is first decomposed where it can be), split by the
    dtype of its first tensor input; plus each hand-written kernel's
    ``cost()``, which its wrapper's meta branch records (``kernel``);
  * **elementwise FLOPs**, apart (``elementwise_flops``), by the rule of
    XLA's cost analysis: a pointwise op one per output element (a
    transcendental none: XLA counts those apart), a reduction one per
    input element it folds away, a cumulative sum one per element; copies
    none. They are not in ``flops``, the roofline's compute (products on
    the tensor cores) and what ``FlopCounterMode`` counts; added to it,
    they hold the count against XLA's;
  * **bytes**: the input and output bytes of every aten op that is not a
    view or a bare allocation, plus each kernel's ``cost()`` bytes. This
    is what eager PyTorch moves unfused, with no cache between ops: the
    port's own count, not XLA's fused one;
  * **kernel launches**, by kernel name;
  * **collectives**: what ``core.reduce`` records in analysis mode
    (``collective``), with the reference's byte model: an all-reduce moves
    2× its result, an all-gather its result, the others their operand;
  * **a live-bytes peak** (``temp_peak``): the most bytes that storages
    made inside the count held at once, and ``out_bytes``, those still
    held when it ends. A temporary an op makes inside its kernel is no
    storage of the dispatch; the one that counts is modelled
    (``_CONTIGUOUS_INPUTS``): given a non-contiguous gradient, the CUDA
    softmax backward works on a contiguous copy of it and a contiguous
    result, then copies the result into its output, two temporaries of
    the output's size (1 GiB beside the live bytes in the plain attention
    backward of ``paper-transformer`` base, measured on the H100 with
    ``torch.cuda.max_memory_allocated`` around each op). Storages that existed before are the caller's to
    count: ``arg_bytes`` (``launch.dryrun``: the rank's local shards of
    params and state, and its batch) and ``buffer_bytes`` (what the engine
    holds beside them).

The recorders are process-wide, not a thread's: an autograd backward may
run on another thread than its forward.
"""
from __future__ import annotations

import collections
import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.analysis.mode import in_analysis_mode

aten = torch.ops.aten

# the ops FlopCounterMode hands back untouched (metadata queries)
_METADATA = {aten.sym_is_contiguous.default, aten.is_contiguous.default,
             aten.is_contiguous.memory_format,
             aten.is_strides_like_format.default,
             aten.is_non_overlapping_and_dense.default, aten.size.default,
             aten.sym_size.default, aten.stride.default,
             aten.sym_stride.default, aten.storage_offset.default,
             aten.sym_storage_offset.default, aten.numel.default,
             aten.sym_numel.default, aten.dim.default,
             torch.ops.prim.layout.default}
# allocations that move no bytes
_ALLOC = {aten.empty.memory_format, aten.empty_strided.default,
          aten.empty_like.default, aten.new_empty.default,
          aten.new_empty_strided.default}
# ops whose CUDA kernels, given a non-contiguous input, copy it to a
# contiguous temporary and compute into a contiguous temporary result
# (both held while the op runs)
_CONTIGUOUS_INPUTS = {aten._softmax_backward_data.default,
                      aten._log_softmax_backward_data.default}
# pointwise ops XLA counts as transcendentals, not FLOPs
_TRANSCENDENTAL = {aten.exp, aten.exp2, aten.expm1, aten.log, aten.log1p,
                   aten.log2, aten.tanh, aten.sigmoid, aten.sqrt,
                   aten.rsqrt, aten.pow, aten.sin, aten.cos, aten.erf}
_NO_FLOPS = {aten.clone, aten.copy, aten.copy_, aten._to_copy,
             aten.fill, aten.fill_, aten.zero_, aten.zeros_like,
             aten.ones_like, aten.full_like}
COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")

_ACTIVE: list = []


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def collective_traffic(kind: str, result_bytes: int,
                       operand_bytes: int) -> int:
    """The reference's byte model of one collective
    (``repro.analysis.roofline.collective_stats``): an all-reduce 2× its
    result (reduce-scatter then all-gather), an all-gather its result,
    the others their operand (or the result where there is none)."""
    if kind == "all-reduce":
        return 2 * result_bytes
    if kind == "all-gather":
        return result_bytes
    return operand_bytes or result_bytes


def elementwise_flops(func, ins: list, outs: list) -> int:
    """XLA's count of an op that ``flop_registry`` has no formula for
    (module doc)."""
    packet = func._overloadpacket
    if packet in _NO_FLOPS or packet in _TRANSCENDENTAL:
        return 0
    if torch.Tag.pointwise in func.tags and outs:
        return outs[0].numel()
    if torch.Tag.reduction in func.tags and ins:
        return ins[0].numel() - (outs[0].numel() if outs else 0)
    if packet is aten.cumsum and ins:
        return ins[0].numel()
    return 0


def kernel(name: str, ops: float, nbytes: float, dtype) -> None:
    """A hand-written kernel's launch on meta tensors: its wrapper's meta
    branch calls this with the kernel's ``cost()``."""
    for c in _ACTIVE:
        c._kernel(name, ops, nbytes, dtype)


def collective(kind: str, result_bytes: int, operand_bytes: int,
               ranks) -> None:
    """A collective of ``core.reduce`` over the global ``ranks`` of its
    group; recorded in analysis mode, where it spans more than one rank."""
    if not in_analysis_mode() or len(ranks) < 2:
        return
    for c in _ACTIVE:
        c._collective(kind, result_bytes, operand_bytes, tuple(ranks))


def group_ranks(group) -> tuple:
    """The global ranks of a process group (None: the default group)."""
    import torch.distributed as dist
    if group is None:
        return tuple(range(dist.get_world_size()))
    return tuple(dist.get_process_group_ranks(group))


@dataclass
class Collective:
    kind: str
    bytes: int            # traffic by the byte model
    ranks: tuple          # the group's global ranks
    n: int = 1            # collectives it stands for (an extrapolated count)


@dataclass
class Count:
    """What a ``CostCount`` saw (module doc). FLOPs and bytes are per
    device: a step on the meta device is one rank's program."""
    aten_flops: int = 0
    aten_bytes: int = 0
    kernel_flops: float = 0.0
    elementwise_flops: int = 0
    kernel_bytes: float = 0.0
    flops_by_dtype: dict = field(default_factory=collections.Counter)
    launches: dict = field(default_factory=collections.Counter)
    kernels: dict = field(default_factory=dict)   # name -> {ops, bytes}
    collectives: list = field(default_factory=list)
    arg_bytes: int = 0
    buffer_bytes: int = 0
    temp_peak: int = 0
    out_bytes: int = 0

    @property
    def flops(self) -> float:
        return self.aten_flops + self.kernel_flops

    @property
    def bytes(self) -> float:
        return self.aten_bytes + self.kernel_bytes

    @property
    def collective_bytes(self) -> int:
        return sum(c.bytes for c in self.collectives)

    def collective_stats(self) -> dict:
        """{kind: {"count", "bytes"}} over the five kinds, as the
        reference's ``collective_stats`` returns."""
        out = {k: {"count": 0, "bytes": 0} for k in COLLECTIVE_KINDS}
        for c in self.collectives:
            out[c.kind]["count"] += c.n
            out[c.kind]["bytes"] += c.bytes
        return out

    def by_group(self) -> dict:
        """{group ranks: traffic bytes} of the collectives."""
        out = collections.Counter()
        for c in self.collectives:
            out[c.ranks] += c.bytes
        return dict(out)


class CostCount(TorchDispatchMode):
    """``with CostCount() as c:`` ... then ``c.count`` (a ``Count``).
    Meant for meta tensors; on any device it counts the same ops."""

    def __init__(self):
        super().__init__()
        self.count = Count()
        self._live = 0
        self._seen: set = set()

    # -- recorders ------------------------------------------------------
    def _kernel(self, name, ops, nbytes, dtype):
        c = self.count
        c.kernel_flops += ops
        c.kernel_bytes += nbytes
        c.flops_by_dtype[str(dtype).removeprefix("torch.")] += ops
        c.launches[name] += 1
        k = c.kernels.setdefault(name, {"ops": 0.0, "bytes": 0.0})
        k["ops"] += ops
        k["bytes"] += nbytes

    def _collective(self, kind, result_bytes, operand_bytes, ranks):
        self.count.collectives.append(Collective(
            kind, collective_traffic(kind, result_bytes, operand_bytes),
            ranks))

    def _free(self, key, nbytes):
        self._seen.discard(key)
        self._live -= nbytes

    def _track(self, outs, transient=0):
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._seen:
                continue
            n = st.nbytes()
            self._seen.add(key)
            self._live += n
            weakref.finalize(st, self._free, key, n)
        self.count.temp_peak = max(self.count.temp_peak,
                                   self._live + transient)

    # -- the mode -------------------------------------------------------
    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        self.count.out_bytes = self._live
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _METADATA:
            return NotImplemented
        if func is not torch.ops.prim.device.default:
            # FlopCounterMode's rule: decompose what decomposes, so that
            # the formulas see the ops that carry the FLOPs
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        if func.namespace != "aten":
            return out
        packet = func._overloadpacket
        ins = _tensors((args, kwargs))
        if packet in flop_registry:
            n = flop_registry[packet](*args, **kwargs, out_val=out)
            self.count.aten_flops += n
            dt = ins[0].dtype if ins else torch.float32
            self.count.flops_by_dtype[str(dt).removeprefix("torch.")] += n
        outs = _tensors(out)
        if packet not in flop_registry and not func.is_view:
            self.count.elementwise_flops += elementwise_flops(func, ins, outs)
        if func.is_view or func in _ALLOC:
            if func in _ALLOC:
                self._track(outs)
            return out
        self.count.aten_bytes += sum(_nbytes(t) for t in ins + outs)
        if not func._schema.is_mutable:
            transient = 0
            if func in _CONTIGUOUS_INPUTS:
                copies = [t for t in ins if not t.is_contiguous()]
                if copies:             # the copies and a contiguous result
                    transient = sum(_nbytes(t) for t in copies + outs)
            self._track(outs, transient)
        return out
