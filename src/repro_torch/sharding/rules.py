"""Logical -> physical placement rules with divisibility fallbacks.

Port of ``repro.sharding.rules`` as pure functions over a mesh's axis
sizes. ``mesh`` is anything that names them: a ``DeviceMesh`` (its
``mesh_dim_names`` and ``shape``), a dict ``{axis: size}``, or an object
whose ``.shape`` is that dict (the reference's ``Mesh``). A spec is a tuple
with one entry a dimension, each an axis name, a tuple of axis names or
None; ``()`` is replicated (the reference's ``P()``).

``param_spec(mesh, path, shape)`` maps every parameter to a spec by the
reference's rule: try the preferred layouts in order, keep the first whose
sharded dims all divide, else replicate. Projections that consume a
model-sharded activation (``wo``, ``out_proj``, ``swo``) are row-parallel
(contraction dim on ``model``), everything else column-parallel (output
features on ``model``); ``data`` goes on the other dim (FSDP, on by
default); the embedding and head split the vocab over ``model``.

**Where the layouts differ.** The reference stacks a block's layers,
``(n_blocks, in, out)``, and its MoE experts, ``(n_blocks, E, in, out)``;
the port keeps one leaf a layer (``models.transformer``). So a port leaf of
two dims takes the reference's 3-D rule without its leading (block) entry,
which is the reference's 2-D rule, and a port leaf of three dims (the
experts, ``(E, in, out)``) takes the 4-D rule without its leading entry.
A per-layer vector (norm scales, biases, the SSM's ``A_log``, ``D``,
``dt_bias``, ``gnorm``, ``conv_b``) is replicated here, as the reference
replicates a 1-D leaf; the reference's stacked ``(n_blocks, d)`` copy of
it may instead take the 2-D rule and shard the block axis over ``data``
and ``d`` over ``model`` where ``d >= 128``. A per-layer layout has no
block axis to shard, and the hybrid engine applies a norm to the whole
hidden stream on every model rank, so the port keeps vectors whole.
"""
from __future__ import annotations

from typing import Sequence

_ROW_PARALLEL = ("wo", "out_proj", "swo")


def axis_sizes(mesh) -> dict:
    """{axis name: size} of ``mesh`` (module doc)."""
    if isinstance(mesh, dict):
        return mesh
    shape = getattr(mesh, "shape", None)
    if isinstance(shape, dict):
        return shape
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _axis_size(sizes: dict, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        out = 1
        for a in axis:
            out *= sizes[a]
        return out
    return sizes[axis]


def pick_spec(mesh, shape: Sequence[int], candidates) -> tuple:
    """First candidate spec whose sharded dims all divide evenly, else
    ``()``."""
    sizes = axis_sizes(mesh)
    for spec in candidates:
        if all(axis is None or dim % _axis_size(sizes, axis) == 0
               for dim, axis in zip(shape, spec)):
            return tuple(spec)
    return ()


def _is_row(path: str) -> bool:
    leaf = path.replace("/", ".").rsplit(".", 1)[-1].strip("[]'\"")
    return leaf in _ROW_PARALLEL


def param_spec(mesh, path: str, shape, *, fsdp: bool = True) -> tuple:
    """The spec of the parameter at ``path`` (the port's ``state_dict``
    name) of ``shape``; the per-layer rules as the module doc maps them."""
    nd = len(shape)
    d = "data" if fsdp else None
    if nd == 0 or max(shape) < 128:
        return ()
    if "embed" in path or "head" in path:
        # (V, d) or (d, V): vocab over model, the other dim over data
        if nd != 2:
            return pick_spec(mesh, shape, [])
        if shape[0] >= shape[-1]:
            cands = [("model", d), ("model", None), (None, d), (None, None)]
        else:
            cands = [(d, "model"), (None, "model"), (d, None), (None, None)]
        return pick_spec(mesh, shape, cands)
    if "pos_embed" in path or "enc_pos" in path:
        return pick_spec(mesh, shape, [(None, "model"), (None, None)])
    if nd == 1:
        return ()
    row = _is_row(path)
    if nd == 2:
        # the reference's 2-D rule, and its 3-D rule without the block axis
        if row:
            return pick_spec(mesh, shape, [
                ("model", d), ("model", None), (None, d), (None, None)])
        return pick_spec(mesh, shape, [
            (d, "model"), (None, "model"), (d, None), (None, None)])
    if nd == 3:
        # (E, in, out): the reference's 4-D rule without the block axis;
        # expert-parallel over model where E divides
        if row:
            return pick_spec(mesh, shape, [
                ("model", d, None), (None, "model", d),
                (None, "model", None), (None, None, None)])
        return pick_spec(mesh, shape, [
            ("model", d, None), (None, d, "model"),
            (None, None, "model"), (None, None, None)])
    return ()


def params_shardings(mesh, named_shapes, *, fsdp: bool = True) -> dict:
    """{name: shape} (or ``(name, tensor)`` pairs) -> {name: spec}."""
    items = named_shapes.items() if isinstance(named_shapes, dict) \
        else named_shapes
    return {name: param_spec(mesh, name, tuple(getattr(s, "shape", s)),
                             fsdp=fsdp)
            for name, s in items}


# ---------------------------------------------------------------------------
# activation / input rules
# ---------------------------------------------------------------------------
def batch_axes(mesh) -> tuple:
    sizes = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in sizes)


def _dp_entry(mesh):
    """The spec entry of the batch axes: one name alone, several as a
    tuple (a one-name tuple is its name, as ``PartitionSpec`` holds it)."""
    dp = batch_axes(mesh)
    return dp[0] if len(dp) == 1 else dp


def _dp_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    out = 1
    for a in batch_axes(mesh):
        out *= sizes[a]
    return out


def data_specs(mesh, global_batch: int, *, seq_shard: bool = False):
    """Specs of the model inputs ``(tokens, per-example)``: the batch dim
    over the data axes; where the batch does not divide them, the sequence
    dim over ``data`` (context parallelism)."""
    dp = _dp_entry(mesh)
    if global_batch % _dp_size(mesh) == 0 and not seq_shard:
        return (dp, None), (dp,)
    return (None, "data"), (None,)


def activation_rule_table(mesh, global_batch: int, *, seq_shard=False) -> dict:
    batch_ok = global_batch % _dp_size(mesh) == 0 and not seq_shard
    b = _dp_entry(mesh) if batch_ok else None
    s = None if batch_ok else "data"
    return {"hidden": (b, s, "model"),
            "decode_hidden": (b, None, "model"),
            "logits": (b, s, "model")}


def make_constrain(mesh, table: dict):
    """``fn(x, kind)`` for ``ctx.activation_sharding``: the spec of
    ``table[kind]`` with each axis that does not divide its dim dropped, as
    the reference resolves it.

    The reference hands the spec to the partitioner of one global program.
    The port runs one program a rank: the batch axes are the rows the rank
    already holds, and the hidden stream is whole on every model rank (the
    row-parallel sums of ``distributed.data_parallel`` make it so). So the
    function moves nothing: it returns ``x`` and records the resolved spec
    in ``fn.seen[kind]``, what the launcher reports."""
    sizes = axis_sizes(mesh)

    def fn(x, kind):
        spec = table.get(kind)
        if spec is None:
            return x
        fixed = []
        for dim, axis in zip(x.shape,
                             tuple(spec) + (None,) * (x.dim() - len(spec))):
            ok = axis is not None and dim % _axis_size(sizes, axis) == 0
            fixed.append(axis if ok else None)
        fn.seen[kind] = tuple(fixed)
        return x

    fn.seen = {}
    return fn
