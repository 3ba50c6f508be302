"""Device-resident FCPR ring, and the double-buffered prefetcher it falls
back to.

Port of the unsharded half of ``repro.data.device_ring`` and of the
single-device ``repro.distributed.prefetch.PrefetchSampler``; the sharded
and multi-process layouts are not ported yet.

FCPR sampling (paper §3.4) makes batch identity a pure function of the step
index, ``t = j mod n_b``, so the whole permuted epoch is uploaded to the
device once and batch t is rows ``[t*bs, (t+1)*bs)`` of it. The ring keeps
the sampler protocol (``__call__(j)``, ``n_batches``, ``batch_size``,
``batch_index``), so the per-step engine takes it unchanged; the chunked
engine (``repro_torch.train.chunked``) takes ``ring.arrays`` and selects
the rows with an index that lives on the device.

``ring_or_prefetch`` is the byte-budget front door: an epoch that fits
``byte_budget`` becomes a ``DeviceRing``; one that does not falls back to
``PrefetchSampler``, which stages each batch through pinned host memory
and copies it to the device on a side stream one step ahead. Both give the
sampler's batches, bit for bit.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device

DEFAULT_BYTE_BUDGET = 256 * 1024 * 1024     # 256 MiB of epoch per replica


class DeviceRing:
    """``epoch_arrays``: the permuted epoch, numpy arrays or tensors with
    one row per sample, uploaded to ``device`` once."""

    def __init__(self, epoch_arrays: Dict[str, np.ndarray], batch_size: int,
                 *, device="cuda"):
        n = next(iter(epoch_arrays.values())).shape[0]
        for v in epoch_arrays.values():
            if v.shape[0] != n:
                raise ValueError("epoch arrays must share the leading dim")
        if n % batch_size:
            raise ValueError(f"{n} epoch rows are not whole batches of "
                             f"{batch_size}")
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.n_batches = n // batch_size
        self.arrays = {k: (v if torch.is_tensor(v) else
                           torch.from_numpy(np.ascontiguousarray(v)))
                       .to(self.device)
                       for k, v in epoch_arrays.items()}

    def batch_index(self, j: int) -> int:
        return j % self.n_batches

    def __call__(self, j: int) -> Dict[str, torch.Tensor]:
        """Batch ``t = j mod n_b`` as views of the ring (no copy)."""
        t = self.batch_index(j)
        return {k: v.narrow(0, t * self.batch_size, self.batch_size)
                for k, v in self.arrays.items()}

    @property
    def nbytes(self) -> int:
        return sum(v.numel() * v.element_size() for v in self.arrays.values())


class PrefetchSampler:
    """Wraps a host sampler; batch j is bit-identical to ``sampler(j)``,
    staged early. On a CUDA device each batch is copied from pinned memory
    on a side stream while the previous step runs, and the consuming stream
    waits for that copy only; ``depth`` >= 1 batches may be in flight (2 =
    double buffering). Random access still works: a miss stages j at once.
    On the CPU a batch is the host arrays as tensors."""

    def __init__(self, sampler, device="cuda", depth: int = 2):
        if depth < 1:
            raise ValueError("prefetch depth must be >= 1")
        self.sampler = sampler
        self.device = resolve_device(device)
        self.n_batches = sampler.n_batches
        self.batch_size = sampler.batch_size
        self._depth = depth
        self._staged: dict = {}
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)

    def batch_index(self, j: int) -> int:
        return self.sampler.batch_index(j)

    def _put(self, j: int) -> None:
        host = {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in self.sampler(j).items()}
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


def ring_or_prefetch(sampler, *, device="cuda",
                     byte_budget: Optional[int] = DEFAULT_BYTE_BUDGET,
                     prefetch_depth: int = 2):
    """A ``DeviceRing`` of ``sampler``'s epoch when it fits ``byte_budget``
    bytes (``None``: always), else a ``PrefetchSampler`` over ``sampler``.
    The size check uses ``sampler.epoch_nbytes()``, so an epoch over budget
    is never materialised on the device."""
    if byte_budget is not None and sampler.epoch_nbytes() > byte_budget:
        return PrefetchSampler(sampler, device=device, depth=prefetch_depth)
    return DeviceRing(sampler.epoch_arrays(), sampler.batch_size,
                      device=device)
