"""Serving: one-shot generation, continuous batching over preallocated
slots with a CUDA-graph decode step, and hot snapshot swap from a training
run's publish directory.

Port of ``repro.serve``, with the same ``__all__``. See the modules'
docstrings for the slot lifecycle, the decode graph and the publish
protocol.
"""
from repro_torch.serve.engine import ServeEngine, merge_prefill_cache
from repro_torch.serve.scheduler import (Completion, ContinuousScheduler,
                                         Request, SwapEvent)
from repro_torch.serve.slots import SlotKV, admit_cache
from repro_torch.serve.snapshot import (Snapshot, SnapshotWatcher,
                                        publish_pointer, read_pointer)

__all__ = [
    "ServeEngine", "merge_prefill_cache",
    "SlotKV", "admit_cache",
    "Request", "Completion", "SwapEvent", "ContinuousScheduler",
    "Snapshot", "SnapshotWatcher", "publish_pointer", "read_pointer",
]
