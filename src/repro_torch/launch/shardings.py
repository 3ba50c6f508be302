"""Placement of the hybrid engine's parameters and ISGD state.

Port of ``hybrid_params_placement`` and ``state_shardings`` of
``repro.launch.shardings``. ``hybrid_params_placement(mesh, params)``
gives every parameter its spec (``sharding.rules.param_spec``, FSDP on by
default) where the mesh has a tensor-parallel axis, and replicates it on a
pure-data mesh (whose engine needs replicated params). It returns ``(local,
placement)``: ``local`` is the list of this rank's shards, what the engine
updates; ``placement`` (a :class:`Placement`) knows how to rebuild what the
loss reads from them.

The reference places global arrays and lets its partitioner gather. Here a
rank holds, for every parameter, the tensor its loss reads (the
*compute* tensor) and updates only its own part of it, the *storage*
slice the spec gives it (``local``):

  * **data** in a spec (FSDP): the rank's slice of that dim; the
    evaluation gathers the slices in rank order first, an exact
    concatenation (``Placement.gather_``), and the data mean's
    reduce-scatter hands it only its slice of the gradient
    (``Placement.parts``);
  * **model** in a spec: where the model splits that layer itself, the
    compute tensor is the rank's compute slice, installed in the module in
    place of the full parameter. The layers it splits are an attention
    layer by its heads (``head_plan``; ``wq``, ``wk``, ``wv`` by columns,
    ``wo`` by rows; the decoder's self and cross attention and a whisper
    encoder's), a SwiGLU or GELU MLP by its ``d_ff`` (``wg``, ``wi`` by
    columns, ``wo`` by rows) and an MoE layer's experts and shared
    experts (below). Every other parameter with ``model`` in its spec
    (the embedding and head over the vocab, an MoE router, SSM and MLA
    weights, an attention layer the plan keeps whole) is gathered over
    the model ranks like a data slice, and the loss runs it whole on
    every model rank (their gradients agree bit for bit, the rank keeps
    its slice).

What each layer kind computes on model rank c of M:

  ============  ========================================================
  attention     its heads by the head plan (below)
  dense MLP     ``d_ff``/M columns of ``wg``/``wi``, rows of ``wo``
  MoE experts   expert parallel where the spec puts ``model`` on the
                expert dim (M divides E): experts ``[c·E/M, (c+1)·E/M)``
                of ``wg``, ``wi``, ``wo`` (dim 0); otherwise, where it
                puts it on ``moe_d_ff`` (M divides it), every expert's
                ``moe_d_ff``/M slice (``wg``/``wi`` dim 2, ``wo`` dim 1)
  shared        ``swg``/``swi`` columns and ``swo`` rows, width/M, as a
  experts       dense SwiGLU
  MoE router    whole (its softmax and top-k read every expert's logit)
  ============  ========================================================

Under either MoE mode the compute slice is the storage slice along
``model`` (the reference's 4-D rule, ``rules.param_spec``); the model
reads the mode off the shapes (``models.moe``).

**The head plan** of an attention layer with H query and K KV heads over
M model ranks (``head_plan``):

  * ``heads``, where M divides H and K: rank c computes query heads
    ``[c·H/M, (c+1)·H/M)`` and KV heads ``[c·K/M, (c+1)·K/M)``, exactly
    its storage slice;
  * ``kv``, where K < M, M % K == 0 and H ≥ M: the m = M/K consecutive
    ranks ``g·m … g·m+m−1`` form the *KV group* of KV head g, and each
    reads only that head. The group's rep = H/K query heads are dealt out
    to its ranks in order, the first ``rep mod m`` taking one more
    (``query_heads``);
  * ``whole`` otherwise (H < M, or K and M dividing neither the other):
    every rank runs the layer, gathered, as the reference's numbers on
    one rank.

Storage stays the reference's even column split (``rules.param_spec``),
so under ``kv`` a rank's compute slice can differ from its storage slice
(deepseek-coder-33b at M = 16 stores 3.5 heads of ``wq`` a rank and
computes 4 or 3). The group's storage slices cover exactly its compute
columns, so every exchange stays inside the group's m ranks (its process
group, ``launch.mesh.kv_group``; the ``kv`` axis of a leaf's gathers):
``gather_`` gathers the group's storage slices in rank order and narrows
them to the rank's compute slice (``Leaf.narrow``); the gradient of a
compute slice is made the group's by ``Placement.kv_grads`` (the
compute-slice gradients of ``wq`` and ``wo`` gathered in rank order and
concatenated, those of ``wk`` and ``wv``, which the m ranks share, summed
in f32 in rank order), and the rank keeps its storage slice of it.

``state_shardings`` gives the ISGD state's layout: the velocity shards
like its parameter (it is built from the local shards), the ψ queue and
the counters are replicated.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.sharding import rules

# the groups of leaves the model splits over ``model`` itself: kind ->
# the candidate {leaf: dim that holds the model slice}, the first whose
# leaves all carry ``model`` there taken (an MoE layer's experts: expert
# parallel, else within each expert)
_GROUPS = {"attn": ({"wq": 1, "wk": 1, "wv": 1, "wo": 0},),
           "swiglu": ({"wg": 1, "wi": 1, "wo": 0},),
           "gelu2": ({"wi": 1, "wo": 0},),
           "moe": ({"wg": 0, "wi": 0, "wo": 0}, {"wg": 2, "wi": 2, "wo": 1}),
           "shared": ({"swg": 1, "swi": 1, "swo": 0},)}


@dataclass(frozen=True)
class HeadPlan:
    """How an attention layer's heads split over the model ranks (module
    doc): ``kind`` is ``heads``, ``kv`` or ``whole``; under ``kv``, ``m``
    ranks a KV group and ``rep`` query heads a KV head."""
    kind: str
    m: int = 1
    rep: int = 1


def head_plan(H: int, K: int, M: int) -> HeadPlan:
    """The split of H query and K KV heads over M model ranks."""
    if M > 1 and H % M == 0 and K % M == 0:
        return HeadPlan("heads")
    if M > 1 and K < M and M % K == 0 and H >= M and H % K == 0:
        return HeadPlan("kv", M // K, H // K)
    return HeadPlan("whole")


def query_heads(rep: int, m: int, j: int) -> tuple:
    """``(start, count)`` of the query heads rank j of a KV group of m
    ranks computes among the group's rep: dealt out in order, the first
    ``rep mod m`` ranks taking one more."""
    q, r = divmod(rep, m)
    return j * q + min(j, r), q + (j < r)


@dataclass(frozen=True)
class LeafSplit:
    """How the model splits one parameter: the dim, and where a head plan
    is ``kv`` (``m`` > 1) its KV group: the ranks' ``(start, length)``
    along that dim within the group's columns (``narrows``, None for
    ``wk``/``wv``, which every rank of the group computes whole)."""
    dim: int
    m: int = 1
    narrows: Optional[tuple] = None


def _stacks(module):
    """``(prefix, layers)`` of every stack the plan walks: the decoder's
    ``layers`` and a whisper model's ``encoder``."""
    for prefix in ("layers", "encoder"):
        layers = getattr(module, prefix, None)
        if layers is not None:
            yield prefix, layers


def _group_dims(owner: str, kind: str, specs: dict) -> dict:
    """{name: split dim} of the first candidate of ``_GROUPS[kind]`` for
    the leaves of ``owner`` whose specs all carry ``model`` on their
    dims, or {} (the group runs whole)."""
    for cand in _GROUPS[kind]:
        dims = {f"{owner}.{leaf}": k for leaf, k in cand.items()}
        if all(len(specs[n]) > k and specs[n][k] == "model"
               for n, k in dims.items()):
            return dims
    return {}


def _split_plan(module, M: int, specs: dict) -> dict:
    """{parameter name: ``LeafSplit``} of the layers the model splits over
    M ranks (module doc): an attention layer (self or cross) by its head
    plan, a dense MLP by ``d_ff``, an MoE layer's experts (expert
    parallel, else within each expert) and its shared experts; a layer's
    group of weights is split only where every one of them has ``model``
    on its split dim (so only where M divides that dim). Empty for a
    module without layer stacks."""
    out = {}
    stacks = list(_stacks(module))
    if M == 1 or not stacks:
        return out
    cfg = module.cfg
    plan = head_plan(cfg.num_heads, cfg.num_kv_heads, M)
    hd = cfg.head_dim
    for prefix, layers in stacks:
        for i, layer in enumerate(layers):
            groups = []
            if plan.kind != "whole":
                slots = ["mixer"] if layer.spec.mixer == "attn" else []
                if layer.spec.cross:
                    slots.append("cross")
                groups += [(slot, "attn") for slot in slots]
            if layer.spec.mlp in ("swiglu", "gelu2", "moe"):
                groups.append(("mlp", layer.spec.mlp))
            if layer.spec.mlp == "moe" and cfg.num_shared_experts:
                groups.append(("mlp", "shared"))
            for slot, kind in groups:
                for n, k in _group_dims(f"{prefix}.{i}.{slot}", kind,
                                        specs).items():
                    if kind != "attn" or plan.kind == "heads":
                        out[n] = LeafSplit(k)
                    elif n.endswith((".wq", ".wo")):
                        out[n] = LeafSplit(k, plan.m, tuple(
                            (s * hd, c * hd) for s, c in (
                                query_heads(plan.rep, plan.m, j)
                                for j in range(plan.m))))
                    else:
                        out[n] = LeafSplit(k, plan.m)
    return out


@dataclass
class Leaf:
    """One parameter's placement: its name, global shape and spec, the
    compute tensor the loss reads, the rank's storage slice that the engine
    updates (``local``: a view of ``compute`` unless ``narrow`` is set),
    the (dim, axis) pairs the evaluation gathers (axis ``kv``: the KV
    group), the shape they gather (``gathered``: the compute tensor's, or
    under ``narrow`` the KV group's columns), and where the model splits
    the parameter itself: the dim (``tp_dim``), the index along it in the
    global tensor at which the gathered tensor starts (``tp_start``), and
    ``narrow``, the ``(start, length)`` of the compute slice in the
    gathered tensor with ``narrows`` every KV-group rank's in rank order
    (None: the compute tensor is the gathered tensor)."""
    name: str
    shape: tuple
    spec: tuple
    compute: torch.Tensor
    local: torch.Tensor
    gathers: tuple                   # ((dim, axis), ...)
    tp_dim: Optional[int]            # dim the model splits itself, or None
    gathered: tuple
    tp_start: int
    narrow: Optional[tuple]
    narrows: Optional[tuple]


def _coords(mesh) -> dict:
    names = mesh.mesh_dim_names
    return dict(zip(names, mesh.get_coordinate()))


def _install(module, name: str, tensor: torch.Tensor) -> None:
    """Put ``tensor`` (a new Parameter) in place of parameter ``name``."""
    owner_name, _, leaf = name.rpartition(".")
    owner = module.get_submodule(owner_name) if owner_name else module
    owner.register_parameter(leaf, tensor)


class Placement:
    """The placed parameters of one rank (module doc): ``leaves`` in
    parameter order, the mesh's groups and this rank's coordinates, with
    the KV group as the axis ``kv`` where the head plan has one (``kv``:
    its size m and process group)."""

    def __init__(self, mesh, leaves: list, kv: Optional[tuple] = None):
        self.mesh = mesh
        self.leaves = leaves
        self.sizes = dict(rules.axis_sizes(mesh))
        self.coords = _coords(mesh)
        self.groups = {a: mesh.get_group(a) for a in ("data", "model")
                       if self.sizes.get(a, 1) > 1}
        if kv is not None:
            m, group = kv
            self.sizes["kv"] = m
            self.coords["kv"] = self.coords["model"] % m
            self.groups["kv"] = group
        self.global_numel = float(sum(
            torch.Size(lf.shape).numel() for lf in leaves))

    @property
    def local(self) -> list:
        return [lf.local for lf in self.leaves]

    @property
    def compute(self) -> list:
        return [lf.compute for lf in self.leaves]

    @property
    def specs(self) -> dict:
        return {lf.name: lf.spec for lf in self.leaves}

    def gather_bytes(self) -> int:
        """Bytes a rank receives gathering the parameters once (what
        ``gather_`` moves an evaluation)."""
        total = 0
        for lf in self.leaves:
            n = lf.local.numel() * lf.local.element_size()
            for _, axis in lf.gathers:
                total += n * (self.sizes[axis] - 1)
                n *= self.sizes[axis]
        return total

    def held_bytes(self) -> int:
        """Bytes of the compute tensors past the local shards: what the
        gathers fill (a local shard that is a view of its compute tensor
        is not counted twice)."""
        return sum(lf.compute.numel() * lf.compute.element_size()
                   - (0 if lf.narrow is not None else
                      lf.local.numel() * lf.local.element_size())
                   for lf in self.leaves if lf.gathers)

    @torch.no_grad()
    def gather_(self) -> None:
        """Fill every compute tensor from the ranks' shards: list-form
        ``all_gather`` in rank order over each gathered axis, concatenated
        along its dim (exact), narrowed to the compute slice."""
        from repro_torch.core.reduce import gather_list
        for lf in self.leaves:
            if not lf.gathers:
                continue
            x = lf.local.contiguous()
            for dim, axis in lf.gathers:
                x = torch.cat(gather_list(x, self.groups[axis]), dim=dim)
            if lf.narrow is not None:
                x = x.narrow(lf.tp_dim, *lf.narrow)
            lf.compute.copy_(x)

    def kv_grads(self, grads: list, tp) -> list:
        """Make each KV leaf's gradient in ``grads`` (the compute tensors',
        replaced in place, so each is freed as its exchange ends) its KV
        group's (module doc), in the shape the gathers give
        (``Leaf.gathered``) and the same bits on the group's ranks:
        ``tp.kv_concat`` for a narrowed leaf, ``tp.sum`` over the group
        for one the group shares. -> ``grads``."""
        group = self.groups.get("kv")
        for i, lf in enumerate(self.leaves if group is not None else ()):
            if not any(a == "kv" for _, a in lf.gathers):
                continue
            if lf.narrow is None:
                grads[i] = tp.sum(grads[i], group)
            else:
                grads[i] = tp.kv_concat(grads[i], lf.tp_dim,
                                        [n for _, n in lf.narrows], group)
        return grads

    def _slices(self, lf: Leaf) -> tuple:
        """The storage slice within the gathered tensor."""
        idx = [slice(None)] * len(lf.gathered)
        for dim, axis in lf.gathers:
            n = lf.gathered[dim] // self.sizes[axis]
            c = self.coords[axis]
            idx[dim] = slice(c * n, (c + 1) * n)
        return tuple(idx)

    def _global_slices(self, lf: Leaf) -> tuple:
        """The storage slice within the global tensor."""
        idx = list(self._slices(lf))
        if lf.tp_dim is not None:
            s = idx[lf.tp_dim]
            a = s.start or 0
            b = lf.gathered[lf.tp_dim] if s.stop is None else s.stop
            idx[lf.tp_dim] = slice(lf.tp_start + a, lf.tp_start + b)
        return tuple(idx)

    @torch.no_grad()
    def load_full(self, fulls, tensors=None) -> None:
        """Copy this rank's part of each global tensor of ``fulls`` into
        ``tensors`` (default: the local shards), the inverse of ``full``."""
        tensors = self.local if tensors is None else tensors
        for t, f, lf in zip(tensors, fulls, self.leaves):
            t.copy_(f[self._global_slices(lf)])

    def full_tree(self, tree):
        """``tree`` (an ISGD state's ``base``: lists shaped like the local
        shards, nested in tuples) with each such list made global
        (``full``); other leaves as they are."""
        n = len(self.leaves)
        if isinstance(tree, (list, tuple)) and len(tree) == n and all(
                torch.is_tensor(t) and t.shape == lf.local.shape
                for t, lf in zip(tree, self.leaves)):
            return self.full(tree)
        if isinstance(tree, (list, tuple)):
            return type(tree)(self.full_tree(t) for t in tree)
        return tree

    def load_full_tree(self, fulls, tree) -> None:
        """Inverse of ``full_tree``: copy the rank's parts back in place."""
        n = len(self.leaves)
        if isinstance(tree, (list, tuple)) and len(tree) == n and all(
                torch.is_tensor(t) and t.shape == lf.local.shape
                for t, lf in zip(tree, self.leaves)):
            self.load_full(fulls, tree)
        elif isinstance(tree, (list, tuple)):
            for f, t in zip(fulls, tree):
                self.load_full_tree(f, t)
        elif torch.is_tensor(tree) and tree is not fulls:
            tree.copy_(fulls)

    def parts(self):
        """What this rank keeps of each gradient the data mean takes (the
        gathered shape, ``kv_grads``), its storage slice, as the data
        mean's reduce-scatter takes it (``core.reduce.Parts``): a leaf
        gathered over ``data`` is kept by the data rank of its slice (on a
        pod mesh by one rank a pod), a leaf gathered over ``model`` or
        ``kv`` only by every rank of the data group alike, any other leaf
        whole."""
        from repro_torch.core.reduce import Parts
        entries = []
        for lf in self.leaves:
            if not lf.gathers:
                entries.append(None)
                continue
            box = tuple((s.start or 0, n if s.stop is None else s.stop)
                        for s, n in zip(self._slices(lf), lf.gathered))
            ddim = next((d for d, a in lf.gathers if a == "data"), None)
            entries.append((ddim, box))
        pods = self.sizes.get("pod", 1)
        return Parts(tuple(entries), self.sizes.get("data", 1),
                     self.mesh.get_group("pod") if pods > 1 else None)

    @torch.no_grad()
    def full(self, tensors=None) -> list:
        """The global value of every parameter (or of ``tensors``, shaped
        like the local shards, e.g. the velocity): gathered over every
        sharded axis of its spec, the model split included (the storage
        slices, in model rank order); the same on every rank."""
        from repro_torch.core.reduce import gather_list
        tensors = self.local if tensors is None else tensors
        out = []
        for t, lf in zip(tensors, self.leaves):
            x = t.contiguous()
            axes = [(d, a) for d, a in lf.gathers if a != "kv"]
            if lf.tp_dim is not None and "model" in self.groups:
                axes.append((lf.tp_dim, "model"))
            for dim, axis in axes:
                x = torch.cat(gather_list(x, self.groups[axis]), dim=dim)
            out.append(x)
        return out


def hybrid_params_placement(mesh, params, *, names=None, fsdp: bool = True):
    """Place ``params`` for the hybrid engine on ``mesh`` -> ``(local,
    placement)`` (module doc). ``params``: an ``nn.Module`` (its named
    parameters; a ``models.transformer.Transformer`` gets the model split
    of its attention, dense MLP and MoE layers) or a list of tensors (``names``
    default ``p0, p1, …``; never split by the model, only gathered). Every
    rank must pass the same values (the same seed). With no
    tensor-parallel axis every spec is ``()``: replicated. A head plan
    with KV groups makes their process groups (``launch.mesh.kv_group``),
    on every rank alike."""
    from repro_torch.distributed.data_parallel import tensor_axes
    from repro_torch.launch.mesh import kv_group
    module = params if isinstance(params, torch.nn.Module) else None
    if module is not None:
        named = list(module.named_parameters())
    else:
        params = list(params)
        names = names or [f"p{i}" for i in range(len(params))]
        named = list(zip(names, params))
    sizes = rules.axis_sizes(mesh)
    M = sizes.get("model", 1)
    tp = bool(tensor_axes(mesh))
    specs = rules.params_shardings(sizes, named, fsdp=fsdp) if tp \
        else {name: () for name, _ in named}
    plan = _split_plan(module, M, specs) if module is not None else {}
    coords = _coords(mesh)
    ms = {sp.m for sp in plan.values() if sp.m > 1}
    kv = None
    if ms:
        (m,) = ms
        kv = (m, kv_group(mesh, m))
    leaves, wholes = [], []
    for name, p in named:
        shape = tuple(p.shape)
        spec = specs[name] + (None,) * (len(shape) - len(specs[name]))
        sp = plan.get(name)
        tp_dim = None if sp is None else sp.dim
        compute, gathered, start, narrow = p, shape, 0, None
        kv_axis = ()
        if sp is not None:
            # the gathered tensor: the rank's model slice, or its KV group's
            width = shape[tp_dim] // (M // sp.m)
            start = coords["model"] // sp.m * width
            gathered = shape[:tp_dim] + (width,) + shape[tp_dim + 1:]
            a, n = 0, width
            if sp.m > 1:
                kv_axis = ((tp_dim, "kv"),)
                if sp.narrows is not None:
                    narrow = sp.narrows[coords["model"] % sp.m]
                    a, n = narrow
            part = p.detach().narrow(tp_dim, start + a, n)
            compute = torch.nn.Parameter(part.clone(),
                                         requires_grad=p.requires_grad)
            _install(module, name, compute)
        gathers = tuple(sorted(
            tuple((k, a) for k, a in enumerate(spec)
                  if a is not None and k != tp_dim and sizes.get(a, 1) > 1)
            + kv_axis))
        leaves.append(Leaf(name, shape, tuple(spec), compute, compute,
                           gathers, tp_dim, gathered, start, narrow,
                           sp.narrows if narrow is not None else None))
        wholes.append(p)
    placement = Placement(mesh, leaves, kv)
    for lf, p in zip(leaves, wholes):
        if lf.narrow is not None:     # the storage slice is not in compute
            lf.local = p.detach()[placement._global_slices(lf)].clone()
        else:
            lf.local = lf.compute.detach()[placement._slices(lf)] \
                if lf.gathers else lf.compute.detach()
        lf.local._repro_placement = placement
    return placement.local, placement


def state_shardings(mesh, state, placement: Placement):
    """The ISGD state's specs, shaped like ``state``: ``base`` (the
    velocity, or a rule's moment lists) like its parameters, the queue and
    the counters replicated (``()``)."""
    specs = [lf.spec for lf in placement.leaves]
    n = len(specs)

    def base(tree):
        if isinstance(tree, (list, tuple)) and len(tree) == n \
                and all(torch.is_tensor(t) for t in tree):
            return list(specs)
        if isinstance(tree, (list, tuple)):
            return type(tree)(base(t) for t in tree)
        return ()

    out = {"base": base(state.base), "queue": (), "iter": (),
           "accel_count": (), "sub_iters": ()}
    if getattr(state, "trips", None) is not None:
        out["trips"] = {"w0": list(specs), "psi": (), "live": (),
                        "limit": (), "zeta": ()}
    return out
