"""Device-resident FCPR ring, and the double-buffered prefetcher it falls
back to.

Port of ``repro.data.device_ring``; the prefetcher is
``repro_torch.distributed.prefetch.PrefetchSampler`` (re-exported here).

FCPR sampling (paper §3.4) makes batch identity a pure function of the step
index, ``t = j mod n_b``, so the whole permuted epoch is uploaded to the
device once and batch t is rows ``[t*bs, (t+1)*bs)`` of it. The ring keeps
the sampler protocol (``__call__(j)``, ``n_batches``, ``batch_size``,
``batch_index``), so the per-step engine takes it unchanged; the chunked
engine (``repro_torch.train.chunked``) takes ``ring.arrays`` and selects
the rows with an index that lives on the device.

Two layouts:

  * **unsharded** (``mesh=None``): the epoch on ``device``; batch t is rows
    ``[t*bs, (t+1)*bs)``.
  * **sharded** (``mesh``, a data-parallel ``DeviceMesh``): the epoch is
    relaid out shard-major, ``v.reshape(n_b, n, bs/n, ...)`` with the shard
    axis moved first, so block d holds shard d of every batch in cycle
    order, and each rank uploads **only its stripe**, block r
    (``launch.mesh.local_data_block``). No rank holds or uploads the whole
    epoch; every rank permutes the same global epoch from the same seed, so
    the union of the stripes is the single-process epoch, row for row. A
    rank's rows ``[t·bs_local, (t+1)·bs_local)`` of its stripe are exactly
    its rows of the global batch t (``data_parallel.batch_sharding``), so
    ring and host feeds give the same bits.
  * **global** (``mesh``, ``relayout=False``): the hybrid engine's
    tensor-parallel strategy, whose step takes the global batch and cuts
    its rows itself (as the reference's GSPMD step slices the global row
    order). Every rank holds the whole epoch in global row order on the
    mesh's device type; batch t is rows ``[t*bs, (t+1)*bs)``.

``ring_or_prefetch`` is the byte-budget front door: an epoch whose share a
replica (1/n of it on a sharded ring) fits ``byte_budget`` becomes a
``DeviceRing``; one that does not falls back to ``PrefetchSampler``, which
stages each batch (this rank's rows of it) through pinned host memory and
copies it to the device on a side stream one step ahead. Both give the
sampler's batches, bit for bit. On a multi-process mesh the fallback turns
the feed into a copy a step, and it warns once (on process 0).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.prefetch import PrefetchSampler, prefetched

DEFAULT_BYTE_BUDGET = 256 * 1024 * 1024     # 256 MiB of epoch per replica


def _shard_layout(v, n_batches: int, n_dev: int,
                  block: Optional[tuple] = None):
    """(n_b*bs, ...) -> rows regrouped so shard d's contiguous block is
    [batch 0 shard d, batch 1 shard d, ...]; with ``block=(lo, hi)`` only
    the blocks of shards [lo, hi) (this rank's stripe). Takes and returns a
    numpy array or a tensor."""
    bs = v.shape[0] // n_batches
    bsl = bs // n_dev
    lo, hi = block if block is not None else (0, n_dev)
    r = v.reshape(n_batches, n_dev, bsl, *v.shape[1:])[:, lo:hi]
    flat = (n_batches * bsl * (hi - lo), *v.shape[1:])
    if torch.is_tensor(r):
        return r.transpose(0, 1).reshape(flat).contiguous()
    return np.ascontiguousarray(r.swapaxes(0, 1).reshape(flat))


class DeviceRing:
    """``epoch_arrays``: the permuted epoch, numpy arrays or tensors with
    one row per sample, uploaded to ``device`` once; with ``mesh``, this
    rank's stripe of it, on the mesh's device type (module doc).
    ``local_batch_size`` is the rows a batch has here, ``local_block`` the
    shards ``(lo, hi)`` this rank holds."""

    def __init__(self, epoch_arrays: Dict[str, np.ndarray], batch_size: int,
                 *, device="cuda", mesh=None, axis="data",
                 relayout: bool = True):
        n = next(iter(epoch_arrays.values())).shape[0]
        for v in epoch_arrays.values():
            if v.shape[0] != n:
                raise ValueError("epoch arrays must share the leading dim")
        if n % batch_size:
            raise ValueError(f"{n} epoch rows are not whole batches of "
                             f"{batch_size}")
        self.batch_size = batch_size
        self.n_batches = n // batch_size
        self.mesh = mesh
        self.n_devices, self.local_block = 1, (0, 1)
        layout = dict(epoch_arrays)
        if mesh is not None and not relayout:
            device = mesh.device_type
        elif mesh is not None:
            from repro_torch.launch.mesh import local_data_block
            lo, hi, n_dev = local_data_block(mesh, axis)
            if batch_size % n_dev:
                raise ValueError(f"batch {batch_size} is not divisible by "
                                 f"the {n_dev} data-parallel ranks")
            self.n_devices, self.local_block = n_dev, (lo, hi)
            device = mesh.device_type
            layout = {k: _shard_layout(v, self.n_batches, n_dev, (lo, hi))
                      for k, v in layout.items()}
        self.device = resolve_device(device)
        self.local_batch_size = batch_size // self.n_devices
        self.arrays = {k: (v if torch.is_tensor(v) else
                           torch.from_numpy(np.ascontiguousarray(v)))
                       .to(self.device)
                       for k, v in layout.items()}

    def batch_index(self, j: int) -> int:
        return j % self.n_batches

    def __call__(self, j: int) -> Dict[str, torch.Tensor]:
        """Batch ``t = j mod n_b`` (this rank's rows of it on a sharded
        ring) as views of the ring (no copy)."""
        t = self.batch_index(j)
        bs = self.local_batch_size
        return {k: v.narrow(0, t * bs, bs) for k, v in self.arrays.items()}

    @property
    def nbytes(self) -> int:
        """This rank's bytes (its stripe on a sharded ring)."""
        return sum(v.numel() * v.element_size() for v in self.arrays.values())


def ring_or_prefetch(sampler, *, device="cuda", mesh=None, axis="data",
                     byte_budget: Optional[int] = DEFAULT_BYTE_BUDGET,
                     prefetch_depth: int = 2, relayout: bool = True):
    """A ``DeviceRing`` of ``sampler``'s epoch (this rank's stripe with
    ``mesh``; the whole epoch with ``relayout=False``) when a replica's
    share fits ``byte_budget`` bytes (``None``: always), else a
    ``PrefetchSampler`` over ``sampler`` (this rank's rows with ``mesh``,
    the global batches with ``relayout=False``). The size check uses
    ``sampler.epoch_nbytes()``, so an epoch over budget is never
    materialised on the device."""
    n_dev = 1
    if mesh is not None and not relayout:
        device, mesh = mesh.device_type, None
        if byte_budget is not None and sampler.epoch_nbytes() > byte_budget:
            return PrefetchSampler(sampler, device=device,
                                   depth=prefetch_depth)
        return DeviceRing(sampler.epoch_arrays(), sampler.batch_size,
                          device=device)
    if mesh is not None:
        from repro_torch.launch.mesh import local_data_block
        n_dev = local_data_block(mesh, axis)[2]
    if byte_budget is not None and \
            sampler.epoch_nbytes() > byte_budget * n_dev:
        if n_dev > 1:
            from repro_torch.obs.console import CONSOLE
            CONSOLE.warn_once(
                "device_ring.prefetch_fallback",
                f"epoch ({sampler.epoch_nbytes()} B) exceeds the device-ring "
                f"byte budget ({byte_budget} B/replica x {n_dev}); falling "
                f"back to per-step prefetch on a multi-process mesh (a copy "
                f"a step instead of one resident stripe). Raise byte_budget "
                f"(or pass None) to keep the ring.")
        if mesh is not None:
            return prefetched(sampler, mesh, axis=axis, depth=prefetch_depth)
        return PrefetchSampler(sampler, device=device, depth=prefetch_depth)
    return DeviceRing(sampler.epoch_arrays(), sampler.batch_size,
                      device=device, mesh=mesh, axis=axis, relayout=relayout)
