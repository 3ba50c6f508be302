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
*compute* tensor) and updates only its own part of it, a view (``local``):

  * **data** in a spec (FSDP): the rank's slice of that dim; the
    evaluation gathers the slices in rank order first, an exact
    concatenation (``Placement.gather_``), and the data mean's
    reduce-scatter hands it only its slice of the gradient
    (``Placement.parts``);
  * **model** in a spec: where the model splits that layer itself (a dense
    attention layer with H and K divisible by M, by heads: ``wq``, ``wk``,
    ``wv`` by columns and ``wo`` by rows; a SwiGLU or GELU MLP: ``wg``,
    ``wi`` by columns and ``wo`` by rows), the compute tensor is the
    rank's model slice, installed in the module in place of the full
    parameter; every other parameter with ``model`` in its spec (the
    embedding and head over the vocab, MoE, SSM, MLA and cross-attention
    weights) is gathered over the model ranks like a data slice, and the
    loss runs it whole on every model rank (their gradients agree bit for
    bit, the rank keeps its slice).

``state_shardings`` gives the ISGD state's layout: the velocity shards
like its parameter (it is built from the local shards), the ψ queue and
the counters are replicated.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.sharding import rules

# parameters the model splits over ``model`` itself: (mixer or mlp kind,
# leaf) -> the dim that holds the model slice
_TP_DIM = {("attn", "wq"): 1, ("attn", "wk"): 1, ("attn", "wv"): 1,
           ("attn", "wo"): 0, ("swiglu", "wg"): 1, ("swiglu", "wi"): 1,
           ("swiglu", "wo"): 0, ("gelu2", "wi"): 1, ("gelu2", "wo"): 0}


@dataclass
class Leaf:
    """One parameter's placement: its name, global shape and spec, the
    compute tensor the loss reads, the rank's view of it that the engine
    updates, and the (dim, axis) pairs the evaluation gathers."""
    name: str
    shape: tuple
    spec: tuple
    compute: torch.Tensor
    local: torch.Tensor
    gathers: tuple                   # ((dim, axis), ...)
    tp_dim: Optional[int]            # dim the model splits itself, or None


def _coords(mesh) -> dict:
    names = mesh.mesh_dim_names
    return dict(zip(names, mesh.get_coordinate()))


def _tp_dims(module, M: int, specs: dict) -> dict:
    """{parameter name: model dim} of the layers the model splits over M
    ranks (module doc): a layer's group of weights is split only where
    every one of them has ``model`` on its split dim; empty for a plain
    list of parameters."""
    out = {}
    layers = getattr(module, "layers", None)
    if layers is None or M == 1:
        return out
    cfg = module.cfg
    for i, layer in enumerate(layers):
        groups = []
        if layer.spec.mixer == "attn" and cfg.num_heads % M == 0 \
                and cfg.num_kv_heads % M == 0:
            groups.append(("mixer", "attn", ("wq", "wk", "wv", "wo")))
        if layer.spec.mlp in ("swiglu", "gelu2") and cfg.d_ff % M == 0:
            groups.append(("mlp", layer.spec.mlp,
                           ("wg", "wi", "wo") if layer.spec.mlp == "swiglu"
                           else ("wi", "wo")))
        for slot, kind, leaves in groups:
            dims = {f"layers.{i}.{slot}.{leaf}": _TP_DIM[(kind, leaf)]
                    for leaf in leaves}
            if all(len(specs[n]) > k and specs[n][k] == "model"
                   for n, k in dims.items()):
                out.update(dims)
    return out


def _install(module, name: str, tensor: torch.Tensor) -> None:
    """Put ``tensor`` (a new Parameter) in place of parameter ``name``."""
    owner_name, _, leaf = name.rpartition(".")
    owner = module.get_submodule(owner_name) if owner_name else module
    owner.register_parameter(leaf, tensor)


class Placement:
    """The placed parameters of one rank (module doc): ``leaves`` in
    parameter order, the mesh's groups and this rank's coordinates."""

    def __init__(self, mesh, leaves: list):
        self.mesh = mesh
        self.leaves = leaves
        self.sizes = rules.axis_sizes(mesh)
        self.coords = _coords(mesh)
        self.groups = {a: mesh.get_group(a) for a in ("data", "model")
                       if self.sizes.get(a, 1) > 1}
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

    @torch.no_grad()
    def gather_(self) -> None:
        """Fill every compute tensor from the ranks' shards: list-form
        ``all_gather`` in rank order over each gathered axis, concatenated
        along its dim (exact)."""
        from repro_torch.core.reduce import gather_list
        for lf in self.leaves:
            if not lf.gathers:
                continue
            x = lf.local.contiguous()
            for dim, axis in lf.gathers:
                x = torch.cat(gather_list(x, self.groups[axis]), dim=dim)
            lf.compute.copy_(x)

    def _slices(self, lf: Leaf) -> tuple:
        idx = [slice(None)] * len(lf.compute.shape)
        for dim, axis in lf.gathers:
            n = lf.compute.shape[dim] // self.sizes[axis]
            c = self.coords[axis]
            idx[dim] = slice(c * n, (c + 1) * n)
        return tuple(idx)

    def _global_slices(self, lf: Leaf) -> tuple:
        idx = list(self._slices(lf))
        if lf.tp_dim is not None:
            n = lf.compute.shape[lf.tp_dim]
            c = self.coords["model"]
            idx[lf.tp_dim] = slice(c * n, (c + 1) * n)
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
        """What this rank keeps of each compute tensor's gradient, its
        local slice, as the data mean's reduce-scatter takes it
        (``core.reduce.Parts``): a leaf gathered over ``data`` is kept by
        the data rank of its slice (on a pod mesh by one rank a pod), a
        leaf gathered over ``model`` only by every rank of the data group
        alike, any other leaf whole."""
        from repro_torch.core.reduce import Parts
        entries = []
        for lf in self.leaves:
            if not lf.gathers:
                entries.append(None)
                continue
            box = tuple((s.start or 0, n if s.stop is None else s.stop)
                        for s, n in zip(self._slices(lf), lf.compute.shape))
            ddim = next((d for d, a in lf.gathers if a == "data"), None)
            entries.append((ddim, box))
        pods = self.sizes.get("pod", 1)
        return Parts(tuple(entries), self.sizes.get("data", 1),
                     self.mesh.get_group("pod") if pods > 1 else None)

    @torch.no_grad()
    def full(self, tensors=None) -> list:
        """The global value of every parameter (or of ``tensors``, shaped
        like the local shards, e.g. the velocity): gathered over every
        sharded axis, the model split included; the same on every rank."""
        from repro_torch.core.reduce import gather_list
        tensors = self.local if tensors is None else tensors
        out = []
        for t, lf in zip(tensors, self.leaves):
            x = t.contiguous()
            axes = list(lf.gathers)
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
    of its dense layers) or a list of tensors (``names`` default
    ``p0, p1, …``; never split by the model, only gathered). Every rank
    must pass the same values (the same seed). With no tensor-parallel
    axis every spec is ``()``: replicated."""
    from repro_torch.distributed.data_parallel import tensor_axes
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
    tp_dims = _tp_dims(module, M, specs) if module is not None else {}
    coords = _coords(mesh)
    leaves = []
    for name, p in named:
        shape = tuple(p.shape)
        spec = specs[name] + (None,) * (len(shape) - len(specs[name]))
        tp_dim = tp_dims.get(name)
        compute = p
        if tp_dim is not None:
            n = shape[tp_dim] // M
            part = p.detach().narrow(tp_dim, coords["model"] * n, n)
            compute = torch.nn.Parameter(part.clone(),
                                         requires_grad=p.requires_grad)
            _install(module, name, compute)
        gathers = tuple((k, a) for k, a in enumerate(spec)
                        if a is not None and k != tp_dim
                        and sizes.get(a, 1) > 1)
        lf = Leaf(name, shape, tuple(spec), compute, compute, gathers, tp_dim)
        leaves.append(lf)
    placement = Placement(mesh, leaves)
    for lf in leaves:
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
