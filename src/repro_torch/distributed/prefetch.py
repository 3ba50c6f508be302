"""Double-buffered host->device prefetching sampler.

Port of ``repro.distributed.prefetch``. ``PrefetchSampler`` wraps an
FCPR-style sampler and stages batch j+1 (up to ``depth - 1`` ahead) while
step j runs: on a CUDA device each batch is copied from pinned memory on a
side stream, and the consuming stream waits for that copy only. Batch j is
bit-identical to ``sampler(j)`` (cut by ``sharding`` when given), merely
staged early; random access still works (a miss stages j at once). It keeps
the sampler protocol (``__call__(j)``, ``n_batches``, ``batch_size``,
``batch_index``).

``prefetched(sampler, mesh)`` is the data-parallel feed: ``sharding`` is
the engine's ``batch_sharding(mesh)``, so each rank stages only its own
rows of every batch on its device.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device


class PrefetchSampler:
    """``sampler`` staged ``depth`` >= 1 batches ahead (2 = double
    buffering) on ``device``; ``sharding`` (a callable on a host batch,
    such as ``data_parallel.BatchShard``) picks the rows to stage. On the
    CPU a batch is the host arrays as tensors."""

    def __init__(self, sampler, device="cuda", depth: int = 2,
                 sharding: Optional[Callable] = None):
        if depth < 1:
            raise ValueError("prefetch depth must be >= 1")
        self.sampler = sampler
        self.device = resolve_device(device)
        self.n_batches = sampler.n_batches
        self.batch_size = sampler.batch_size
        self._sharding = sharding
        self._depth = depth
        self._staged: dict = {}
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)

    def batch_index(self, j: int) -> int:
        return self.sampler.batch_index(j)

    def _put(self, j: int) -> None:
        host = self.sampler(j)
        if self._sharding is not None:
            host = self._sharding(host)
        host = {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in host.items()}
        if self._stream is None:
            self._staged[j] = (host, None)
            return
        with torch.cuda.stream(self._stream):
            dev = {k: v.pin_memory().to(self.device, non_blocking=True)
                   for k, v in host.items()}
            done = torch.cuda.Event()
            done.record(self._stream)
        self._staged[j] = (dev, done)

    def __call__(self, j: int) -> dict:
        if j not in self._staged:          # cold start or random access
            self._put(j)
        for ahead in range(j + 1, j + self._depth):
            if ahead not in self._staged:
                self._put(ahead)
        batch, done = self._staged.pop(j)
        if done is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(done)
            for v in batch.values():      # freed only after the consumer
                v.record_stream(cur)
        for k in [k for k in self._staged if k <= j]:
            del self._staged[k]
        return batch


def prefetched(sampler, mesh=None, *, axis="data", depth: int = 2,
               sharding: Optional[Callable] = None,
               device=None) -> PrefetchSampler:
    """``sampler`` prefetched with the data-parallel batch layout of
    ``mesh`` (this rank's rows) or an explicit ``sharding``, onto
    ``device`` (default: the mesh's device type, else the card)."""
    if sharding is None and mesh is not None:
        from repro_torch.distributed.data_parallel import batch_sharding
        sharding = batch_sharding(mesh, axis)
    if device is None:
        device = mesh.device_type if mesh is not None else "cuda"
    return PrefetchSampler(sampler, device=device, depth=depth,
                           sharding=sharding)
