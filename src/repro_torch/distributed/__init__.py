"""Distributed ISGD (paper §6): the hybrid DP × TP engine over
``torch.distributed`` (``make_hybrid_step``: data parallel on a pure-data
mesh, tensor parallel over a ``model`` axis; ``make_data_parallel_step``
is its alias), the reduction contexts, the data-parallel prefetcher and
the parity harnesses (``parity``, ``hybrid_parity``, ``multihost_parity``),
and the asynchronous parameter-server engine (§6.2) in
``repro_torch.distributed.async_ps`` (staleness-bounded worker threads,
server-side SPC, elastic eviction).

Port of ``repro.distributed``.

The reduction contexts live in ``repro_torch.core.reduce`` (so ``core``
never imports this package) and are re-exported here. Exports resolve
lazily, as in the reference.
"""
from __future__ import annotations

import importlib

_EXPORTS = {
    "ReduceCtx": "repro_torch.core.reduce",
    "LocalReduce": "repro_torch.core.reduce",
    "AxisReduce": "repro_torch.core.reduce",
    "StalenessReduce": "repro_torch.core.reduce",
    "staleness_reduce_from_spec": "repro_torch.core.reduce",
    "LOCAL": "repro_torch.core.reduce",
    "make_hybrid_step": "repro_torch.distributed.data_parallel",
    "make_chunked_hybrid_step": "repro_torch.distributed.data_parallel",
    "make_data_parallel_step": "repro_torch.distributed.data_parallel",
    "make_chunked_data_parallel_step": "repro_torch.distributed.data_parallel",
    "batch_sharding": "repro_torch.distributed.data_parallel",
    "replicated": "repro_torch.distributed.data_parallel",
    "replicate_to_mesh": "repro_torch.distributed.data_parallel",
    "MeshStrategy": "repro_torch.distributed.data_parallel",
    "mesh_strategy": "repro_torch.distributed.data_parallel",
    "data_axis_size": "repro_torch.distributed.data_parallel",
    "tensor_axes": "repro_torch.distributed.data_parallel",
    "PrefetchSampler": "repro_torch.distributed.prefetch",
    "prefetched": "repro_torch.distributed.prefetch",
    "TensorParallel": "repro_torch.distributed.data_parallel",
    "run_parity": "repro_torch.distributed.parity",
    "run_hybrid_parity": "repro_torch.distributed.hybrid_parity",
    "run_hybrid_parity_ranks": "repro_torch.distributed.hybrid_parity",
    "run_multihost_parity": "repro_torch.distributed.multihost_parity",
    "AsyncPSCoordinator": "repro_torch.distributed.async_ps",
    "ParamServer": "repro_torch.distributed.async_ps",
    "records_to_trainlog": "repro_torch.distributed.async_ps",
    "run_async_parity": "repro_torch.distributed.async_ps",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(mod), name)


def __dir__():
    return sorted(_EXPORTS)
