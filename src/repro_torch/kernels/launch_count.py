"""Kernel launch counts kept on the device, so that CUDA-graph replays count.

A wrapper's ``launches`` attribute counts on the host where the wrapper
launches its kernel, so a kernel captured into a graph counts once, at
capture, however often the graph is replayed. After ``enable(device,
names)``, each wrapper also calls ``bump(name)`` where it launches its
kernel: an add of one to a 0-d int64 tensor of its own on the device, on the
kernel's stream. Captured beside the kernel, the add runs whenever the
kernel does: at every replay, and inside an IF node only where the node's
body runs. Enable before the graph is captured (the counters are static
tensors the graph points at); ``reset()`` zeroes them, ``read()`` returns
them. Until ``enable``, ``bump`` does nothing, so the timed paths launch no
extra kernel.

``count(wrapper, name)`` does both where a wrapper launches: the host
count under a lock (the async parameter server's worker threads launch
the same kernels at once, and ``+=`` on an attribute is no atomic
operation), then ``bump``.
"""
from __future__ import annotations

import threading

import torch

_COUNTS: dict = {}               # kernel name -> 0-d int64 tensor
_HOST = threading.Lock()         # guards the wrappers' host counts


def enable(device, names) -> None:
    """Count the launches of the kernels ``names`` on ``device`` from now on,
    starting from 0."""
    _COUNTS.clear()
    for name in names:
        _COUNTS[name] = torch.zeros((), dtype=torch.int64,
                                    device=torch.device(device))


def disable() -> None:
    _COUNTS.clear()


def bump(name: str) -> None:
    """Add one to ``name``'s count, on the current stream; called by the
    wrapper where it launches its kernel, and nowhere else."""
    count = _COUNTS.get(name)
    if count is not None:
        count.add_(1)


def count(wrapper, name: str) -> None:
    """One launch of ``wrapper``'s kernel: ``wrapper.launches`` plus one,
    under a lock, then ``bump(name)``."""
    with _HOST:
        wrapper.launches += 1
    bump(name)


def reset() -> None:
    for count in _COUNTS.values():
        count.zero_()


def read() -> dict:
    """{name: launches since ``enable`` or the last ``reset``} (a host read)."""
    return {name: int(count) for name, count in _COUNTS.items()}
