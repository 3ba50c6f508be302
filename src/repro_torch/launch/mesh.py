"""Training meshes over the ``torch.distributed`` process group.

Port of the data part of ``repro.launch.mesh``. A mesh is a
``torch.distributed.device_mesh.DeviceMesh``: one rank a process, one
process a device. The data-parallel meshes are 1-D, ``("data",)``, over
every rank of the group in rank order, which is the flat shard order the
FCPR stripes and the deterministic reduction key on (rank r holds data
shard r; ``local_data_block`` is ``(r, r + 1, world)``).

The model-parallel meshes (``model > 1``: the ``(data, model)`` and
``(pod, data, model)`` grids of the hybrid DP × TP engine) wait for the
hybrid tensor-parallel slice and raise :class:`MeshError` naming it. With
``model=1`` the reference's ``make_host_mesh``/``make_training_mesh`` have
a trivial model axis; here they return the 1-D data mesh, whose data axes
are the same.

Building a mesh needs a process group; :func:`make_data_mesh` makes a
one-rank group for a single process that has none
(``launch.env.ensure_group``). Library code raises :class:`MeshError` (a
``ValueError``); the launcher turns it into an exit code.
"""
from __future__ import annotations

from typing import Optional

import torch

HYBRID_TP = ("the hybrid tensor-parallel slice (model > 1: a (data, model) "
             "mesh and the GSPMD-style strategy of "
             "repro.distributed.data_parallel) is not ported yet")


class MeshError(ValueError):
    """A requested mesh cannot be built from the process group."""


def data_axes(mesh) -> tuple:
    """The data sub-axes of a training mesh, in reduction order:
    ``("data",)`` here (``("pod", "data")`` once a pod axis exists)."""
    names = mesh.mesh_dim_names or ()
    return tuple(a for a in ("pod", "data") if a in names)


def make_data_mesh(device="cuda", backend: Optional[str] = None):
    """1-D ``("data",)`` mesh over every rank of the process group, made
    as a one-rank group where none exists. ``device`` is this rank's
    device type (``cuda`` or ``cpu``); ``backend`` as in
    ``launch.env.ensure_group``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch import env
    env.ensure_group(device, backend)
    return init_device_mesh(torch.device(device).type,
                            (dist.get_world_size(),),
                            mesh_dim_names=("data",))


def make_training_mesh(model: int = 1, *, pod: Optional[int] = None,
                       device="cuda", backend: Optional[str] = None):
    """The reference's mesh factory, its data part: ``model`` must be 1
    (else :class:`MeshError`, naming the hybrid-TP slice) and ``pod`` 1 or
    None; the mesh is ``make_data_mesh``'s."""
    if model != 1:
        raise MeshError(f"--model-parallel {model}: {HYBRID_TP}")
    if pod not in (None, 1):
        raise MeshError(f"pod={pod}: a pod axis comes with the multi-host "
                        f"mesh of the hybrid tensor-parallel slice")
    return make_data_mesh(device, backend)


def make_host_mesh(model: int = 1, device="cuda",
                   backend: Optional[str] = None):
    """``make_training_mesh(model, pod=1)``."""
    return make_training_mesh(model, pod=1, device=device, backend=backend)


def mesh_group(mesh):
    """The process group of the mesh's data axis."""
    return mesh.get_group(data_axes(mesh)[-1])


def local_data_block(mesh, axis=None) -> tuple:
    """This process's block ``(lo, hi, total)`` of flat data-shard
    positions: ``(r, r + 1, world)`` for rank r of the data axis. ``axis``
    must be the mesh's data axis (or None)."""
    axes = data_axes(mesh)
    if axis is not None and ((axis,) if isinstance(axis, str)
                             else tuple(axis)) != axes:
        raise MeshError(f"axis {axis!r} is not the mesh's data axes {axes}")
    import torch.distributed as dist
    group = mesh_group(mesh)
    r = dist.get_rank(group)
    return r, r + 1, dist.get_world_size(group)
