"""Training meshes over the ``torch.distributed`` process group.

Port of ``repro.launch.mesh``. A mesh is a
``torch.distributed.device_mesh.DeviceMesh``: one rank a process, one
process a device, ranks laid out in rank order (``arange(world)``
reshaped to the mesh's shape). :func:`make_training_mesh` is the factory:

  * ``(data, model)`` when the pod axis is trivial;
  * ``(pod, data, model)`` when ``pod > 1``: by default one pod a node,
    ``pod = world_size // LOCAL_WORLD_SIZE`` where ``torchrun`` sets it
    (else 1), so pod row p holds consecutive ranks, the ranks of node p.

The flat data order is pod-major, ``p·D + d``: the FCPR stripes
(``data.device_ring``) and the deterministic reduction (``core.reduce``)
key on it, so a ``(pod=2, data=2)`` mesh reproduces a ``(data=4)`` mesh
bit for bit. ``mesh_group`` is the reduction's group over those ranks in
that order: a mesh dimension's group where there is one data axis, a
group made with ``dist.new_group`` over the flattened ``(pod, data)``
ranks otherwise (every rank makes every model column's group, in the same
order). ``model_group`` is the group of the tensor-parallel axis;
``kv_group(mesh, m)`` the group of this rank's m consecutive model ranks
(the KV group of the attention's head plan, ``launch.shardings``), made
with ``dist.new_group`` for every such run of every model row, by every
rank in the same order.

:func:`make_data_mesh` is the 1-D ``("data",)`` mesh of the pure
data-parallel engine. :func:`make_production_mesh` is the dry-run's
``(data=16, model=16)`` or ``(pod=2, data=16, model=16)`` mesh over a fake
process group of 256 or 512 ranks in this one process, seen from rank 0
(``launch.dryrun``). Building a mesh needs a process group; a single
process that has none gets a one-rank group (``launch.env.ensure_group``).
Library code raises :class:`MeshError` (a ``ValueError``); the launcher
turns it into an exit code.
"""
from __future__ import annotations

import os
from typing import Optional

import torch


class MeshError(ValueError):
    """A requested mesh cannot be built from the process group."""


def data_axes(mesh) -> tuple:
    """The data sub-axes of a training mesh, in reduction (pod-major flat)
    order: ``("pod", "data")`` on a 3-D mesh, ``("data",)`` otherwise."""
    names = mesh.mesh_dim_names or ()
    return tuple(a for a in ("pod", "data") if a in names)


def node_count(world: int) -> int:
    """Nodes of the run: ``world // LOCAL_WORLD_SIZE`` where ``torchrun``
    set it (and it divides), else 1."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", "0") or 0)
    if local <= 0 or world % local:
        return 1
    return world // local


def _device_mesh(device, shape: tuple, names: tuple):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(torch.device(device).type, shape,
                            mesh_dim_names=names)


def make_data_mesh(device="cuda", backend: Optional[str] = None):
    """1-D ``("data",)`` mesh over every rank of the process group, made
    as a one-rank group where none exists. ``device`` is this rank's
    device type (``cuda`` or ``cpu``); ``backend`` as in
    ``launch.env.ensure_group``."""
    import torch.distributed as dist

    from repro_torch.launch import env
    env.ensure_group(device, backend)
    return _device_mesh(device, (dist.get_world_size(),), ("data",))


def _check_pod_rows(mesh) -> None:
    """Pod row p must hold consecutive ranks (one node's), or the FCPR
    stripes would interleave rows across nodes."""
    rows = mesh.mesh.reshape(mesh.shape[0], -1).tolist()
    for p, row in enumerate(rows):
        if row != list(range(row[0], row[0] + len(row))):
            raise MeshError(
                f"mesh ranks are not contiguous along the flattened (pod, "
                f"data) order (pod row {p}: ranks {row}); the FCPR striping "
                f"contract needs each pod's ranks in one contiguous block — "
                f"build the mesh through make_training_mesh")


def _flat_data_group(mesh):
    """The group over the flattened (pod, data) ranks of this rank's model
    column, in pod-major order; every rank makes every column's group."""
    import torch.distributed as dist
    grid = mesh.mesh.reshape(-1, mesh.shape[-1])          # (P·D, M)
    mine = None
    for m in range(grid.shape[1]):
        ranks = grid[:, m].tolist()
        group = dist.new_group(ranks)
        if dist.get_rank() in ranks:
            mine = group
    return mine


def make_training_mesh(model: int = 1, *, pod: Optional[int] = None,
                       device="cuda", backend: Optional[str] = None):
    """The mesh factory: ``model`` ranks a tensor-parallel group, ``pod``
    (default: the node count; an explicit value must equal it) splits the
    rest's outer dim, what is left is ``data``. ``pod == 1`` gives the 2-D
    ``(data, model)`` mesh. Raises :class:`MeshError` on shapes that do not
    divide."""
    import torch.distributed as dist

    from repro_torch.launch import env
    env.ensure_group(device, backend)
    n = dist.get_world_size()
    if model < 1 or n % model:
        raise MeshError(
            f"model-parallel degree must divide the device count: "
            f"n={n} devices, M={model} (choose M from the divisors of {n})")
    nodes = node_count(n)
    if pod is None:
        pod = nodes
    elif pod != nodes:
        raise MeshError(
            f"pod={pod} must equal the node count {nodes} (one pod a node: "
            f"world_size // LOCAL_WORLD_SIZE, or 1 without torchrun); a "
            f"single node cannot fake a pod")
    if pod < 1 or n % (pod * model):
        raise MeshError(
            f"pod axis must divide the non-model device count: n={n} "
            f"devices, pod={pod}, M={model} (n must be a multiple of "
            f"pod*M={pod * model})")
    if pod == 1:
        return _device_mesh(device, (n // model, model), ("data", "model"))
    mesh = _device_mesh(device, (pod, n // (pod * model), model),
                        ("pod", "data", "model"))
    _check_pod_rows(mesh)
    mesh._repro_data_group = _flat_data_group(mesh)
    return mesh


def make_host_mesh(model: int = 1, device="cuda",
                   backend: Optional[str] = None):
    """``make_training_mesh(model, pod=1)``: the 2-D ``(data, model)``
    mesh of a single node."""
    return make_training_mesh(model, pod=1, device=device, backend=backend)


def mesh_group(mesh):
    """The process group of the mesh's data axes, ranks in flat pod-major
    order."""
    group = getattr(mesh, "_repro_data_group", None)
    if group is not None:
        return group
    return mesh.get_group(data_axes(mesh)[-1])


def model_group(mesh):
    """The process group of the tensor-parallel axis (None where the mesh
    has no ``model`` axis)."""
    if "model" not in (mesh.mesh_dim_names or ()):
        return None
    return mesh.get_group("model")


def kv_group(mesh, m: int):
    """The process group of this rank's KV group (module doc): model
    ranks ``g·m … g·m+m−1`` of its model row, g its model coordinate over
    m; made once a mesh and m (every rank makes every row's groups, in the
    same order, so it must be called on every rank) and kept on the
    mesh."""
    import torch.distributed as dist
    cache = getattr(mesh, "_repro_kv_groups", None)
    if cache is None:
        cache = mesh._repro_kv_groups = {}
    if m not in cache:
        grid = mesh.mesh.reshape(-1, mesh.shape[-1])       # (rows, M)
        if grid.shape[1] % m:
            raise MeshError(f"KV groups of {m} ranks do not divide the "
                            f"{grid.shape[1]} model ranks")
        me = dist.get_rank()
        for row in grid.tolist():
            for g in range(0, len(row), m):
                ranks = row[g:g + m]
                group = dist.new_group(ranks)
                if me in ranks:
                    cache[m] = group
    return cache[m]


def local_data_block(mesh, axis=None) -> tuple:
    """This process's block ``(lo, hi, total)`` of flat data-shard
    positions: ``(r, r + 1, total)`` for flat position r (pod-major) of
    this rank. ``axis`` must be the mesh's data axes (or None)."""
    axes = data_axes(mesh)
    if axis is not None and ((axis,) if isinstance(axis, str)
                             else tuple(axis)) != axes:
        raise MeshError(f"axis {axis!r} is not the mesh's data axes {axes}")
    import torch.distributed as dist
    group = mesh_group(mesh)
    r = dist.get_rank(group)
    return r, r + 1, dist.get_world_size(group)


PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(multi_pod: bool = False):
    """The production mesh of the dry-run, ``(data=16, model=16)`` (256
    ranks) or with ``multi_pod`` ``(pod=2, data=16, model=16)`` (512), as
    rank 0 of a fake process group (``torch.distributed``'s ``fake``
    backend: every collective returns at once and moves nothing) made in
    this process. The engine then runs rank 0's program, on meta tensors,
    as every rank would (SPMD). A mesh of the other size replaces the fake
    group; a process that holds a real group is refused. The pod geometry
    is built here, pod-major as ``make_training_mesh`` lays it out; its
    node-count check stays in force for real runs."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    shape, names = PRODUCTION[bool(multi_pod)]
    world = 1
    for n in shape:
        world *= n
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise MeshError(
                f"make_production_mesh makes a fake {world}-rank group for "
                f"a dry-run; this process already holds a real "
                f"{dist.get_backend()} group of {dist.get_world_size()} "
                f"ranks")
        if dist.get_world_size() != world:
            dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    mesh = _device_mesh("cpu", shape, names)
    if multi_pod:
        _check_pod_rows(mesh)
        mesh._repro_data_group = _flat_data_group(mesh)
    return mesh
