"""Exceptions shared by the async-PS server, gate and workers.

Port of ``repro.distributed.async_ps.errors`` (the same classes and
messages), kept in their own module so ``server.py`` and
``coordinator.py`` can both raise them without importing each other.
"""
from __future__ import annotations


class WorkerStalled(RuntimeError):
    """A worker missed its heartbeat deadline and the gate is not elastic:
    the run fails fast with a diagnostic naming the stalled worker and its
    last completed step, instead of peers spinning forever."""


class WorkerEvicted(RuntimeError):
    """Raised inside an *evicted* worker's gate/server calls so its thread
    unwinds cleanly without touching canonical state (its pushes are
    rejected, its ``finish`` is ignored)."""


class PushRejected(RuntimeError):
    """The server rejected a delta whose content checksum failed — the
    payload was corrupted between the worker computing it and the push
    landing.  Retryable: the worker resends the uncorrupted original."""


class WorkerFailure(RuntimeError):
    """A worker thread died and the run cannot continue.  Carries the
    worker's formatted traceback (the live frames died with the thread) and
    chains the original exception as ``__cause__``."""

    def __init__(self, wid: int, err: BaseException, tb: str):
        self.wid = wid
        self.original = err
        super().__init__(
            f"async-PS worker {wid} failed: {err!r}\n"
            f"--- worker thread traceback ---\n{tb}")
