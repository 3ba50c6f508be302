"""Port vs JAX: the pod axis of the training mesh and the multi-host
parity harness (``repro_torch.launch.mesh``,
``repro_torch.distributed.multihost_parity``).

The counterparts of ``tests/test_multihost.py``: the single-process mesh
is 2-D ``(data, model)`` with ``("data",)`` its data axes, as the
reference's; a model degree that does not divide the ranks raises
``MeshError`` (a ``ValueError``) with the reference's wording; a single
process's data block spans all; an explicit pod that does not match the
node count raises. Four gloo ranks as two nodes (``LOCAL_WORLD_SIZE`` 2)
build ``(pod=2, data=2, model=1)`` with contiguous pod rows and the
pod-major flat data order. The acceptance check: the harness runs four
ranks on ``(pod=2, data=2)`` against four on ``(data=4)``, bit for bit on
the per-step, fused (K=32) and ``sched`` legs, the stripes' union equal to
the single-node epoch. Eight ranks as two nodes on ``(pod=2, data=2,
model=2)``: the data mean hands each rank its FSDP slices, bit for bit
those of the rank-order mean. Every rank is joined with a timeout.
"""
import pytest

import _torch_dist_workers as W
from repro.launch.mesh import data_axes as j_data_axes
from repro.launch.mesh import make_training_mesh as j_make_training_mesh
from repro_torch.distributed.multihost_parity import (LEGS,
                                                      run_multihost_parity)
from repro_torch.launch import env
from repro_torch.launch.env import spawn_ranks
from repro_torch.launch.mesh import (MeshError, data_axes, local_data_block,
                                     make_training_mesh)

TIMEOUT = 120


def test_training_mesh_single_process_is_2d():
    with env.local_group("cpu"):
        mesh = make_training_mesh(device="cpu")
        assert mesh.mesh_dim_names == tuple(j_make_training_mesh().axis_names)
        assert data_axes(mesh) == j_data_axes(j_make_training_mesh()) \
            == ("data",)


def test_training_mesh_rejects_non_divisible():
    with env.local_group("cpu"):
        with pytest.raises(MeshError, match="n=1 devices, M=7"):
            make_training_mesh(model=7, device="cpu")
    assert issubclass(MeshError, ValueError)     # library raises, CLI exits


def test_local_data_block_single_process_spans_all():
    with env.local_group("cpu"):
        mesh = make_training_mesh(device="cpu")
        lo, hi, total = local_data_block(mesh)
        assert (lo, hi) == (0, total) and total == mesh.shape[0]


def test_explicit_pod_must_match_process_count():
    with env.local_group("cpu"):
        with pytest.raises(MeshError, match="pod"):
            make_training_mesh(pod=2, device="cpu")   # one node, no pod


def test_pod_mesh_over_two_nodes_is_pod_major():
    out = spawn_ranks(W.pod_mesh_rank, 4, device="cpu", timeout=TIMEOUT)
    for r, (names, shape, axes, block, grank, gsize, grid) in enumerate(out):
        assert names == ("pod", "data", "model") and shape == (2, 2, 1)
        assert axes == ("pod", "data")
        assert block == (r, r + 1, 4) and (grank, gsize) == (r, 4)
        assert grid == [[[0], [1]], [[2], [3]]]   # pod rows: one node each


def test_pod_mesh_data_mean_hands_each_rank_its_slices():
    # eight ranks as two nodes: (pod=2, data=2, model=2); each FSDP slice
    # is kept by one rank a pod, reduced half on each and gathered over
    # the pod ranks, and equals that slice of the rank-order mean of the
    # four ranks of its data group, bit for bit
    ranks = spawn_ranks(W.tp_slices_rank, 8, 2, 2, device="cpu",
                        timeout=TIMEOUT)
    assert {r["mesh"] for r in ranks} == {(2, 2, 2)}
    assert all(len(r["group"]) == 4 for r in ranks)
    assert W.check_local_grads_are_slices(ranks) > 0


def test_multihost_parity_4ranks_pods_vs_single_node():
    r = run_multihost_parity(procs=4, pods=2, steps=32, chunk_steps=32,
                             device="cpu", timeout=TIMEOUT)
    assert r["ok"], r
    assert r["mesh"] == [2, 2, 1] and r["ref_mesh"] == [1, 4, 1]
    assert set(r["legs"]) == set(LEGS) and r["accelerations"] > 0
    assert r["striping"]["union_equals_singlehost"]
