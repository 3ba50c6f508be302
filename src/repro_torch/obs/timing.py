"""Step timing, throughput accounting, the measured-vs-estimated wall
contract, and ``torch.profiler`` trace capture.

Port of ``repro.obs.timing``. ``StepTimer``, ``EstimatedWallError`` and
``require_measured_walls`` are copies (``tests/test_torch_obs.py`` holds
them to the originals). ``StepTimer`` keeps named spans of wall seconds,
carries the ``TrainLog``-style *estimated* flag (fused-chunk stacking,
un-synced per-step walls) and derives steps/s, examples/s and dispatch
counts. :func:`require_measured_walls` is the shared refuse-to-fit guard:
an Eq. 21 timing fit must never consume ``wall_est`` entries.

Profiler hooks, the PyTorch counterparts of the reference's ``jax.profiler``
ones:

* :func:`maybe_profile` — a ``torch.profiler.profile`` (CPU and, with a
  card, CUDA activity) that writes a Chrome trace into ``profile_dir`` when
  it stops; a no-op context when ``profile_dir`` is empty.
* :func:`annotate` / :func:`named_scope` — a ``record_function`` span (chunk
  replays, ψ push, accelerate branch). It is host-only: inside a CUDA-graph
  capture it adds no node to the graph, and with no profiler running it
  costs one dispatcher call.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional, Sequence

import torch


class EstimatedWallError(RuntimeError):
    """A timing fit was about to consume estimated (non-measured) walls."""


def require_measured_walls(wall_est: Sequence[bool], context: str = "") -> None:
    """Refuse to proceed when any wall-clock entry is flagged estimated.

    ``wall_est`` is a sequence of flags, True = estimated (``TrainLog``
    semantics: step_sync=False per-step timing, fused-chunk stacking, or
    overlapping async pushes).  Raises :class:`EstimatedWallError` naming
    the offending fraction — estimated walls silently feeding an Eq.21
    C1/C2 fit is exactly the failure mode this guards."""
    flags = [bool(x) for x in wall_est]
    n_bad = sum(flags)
    if n_bad:
        where = context or "timing fit"
        raise EstimatedWallError(
            f"{where}: refusing to fit on estimated walls — {n_bad}/{len(flags)} "
            "entries have wall_est=True (per-step timing without step_sync, "
            "fused-chunk dispatch estimates, or overlapping async pushes). "
            "Re-measure with synced per-step walls.")


class StepTimer:
    """Named accumulating wall-clock spans + throughput derivation.

    >>> timer = StepTimer()
    >>> with timer.span("train"):
    ...     run()
    >>> timer.throughput("train", steps=n)  # {'wall_s': ..., 'steps_per_s': ...}

    Spans re-entered accumulate (the serve drain loop times many small
    spans under one name).  ``estimated=True`` marks a span's wall as
    non-measured; :meth:`throughput` propagates the flag so downstream
    fits can refuse it via :func:`require_measured_walls`."""

    def __init__(self, recorder=None, clock=time.perf_counter):
        self.recorder = recorder
        self._clock = clock
        self._acc: Dict[str, float] = {}
        self._est: set = set()

    @contextlib.contextmanager
    def span(self, name: str, *, estimated: bool = False):
        t0 = self._clock()
        try:
            yield self
        finally:
            self._acc[name] = self._acc.get(name, 0.0) + (self._clock() - t0)
            if estimated:
                self._est.add(name)

    def add(self, name: str, seconds: float, *, estimated: bool = False) -> None:
        """Fold an externally measured duration into a span."""
        self._acc[name] = self._acc.get(name, 0.0) + float(seconds)
        if estimated:
            self._est.add(name)

    def seconds(self, name: str) -> float:
        return self._acc.get(name, 0.0)

    def estimated(self, name: str) -> bool:
        return name in self._est

    def throughput(self, name: str, *, steps: int = 0, examples: int = 0,
                   dispatches: int = 0) -> dict:
        """Derive rates for a span; emits gauges + one event when a
        recorder is attached."""
        dt = self.seconds(name)
        out = {"wall_s": dt, "wall_est": self.estimated(name)}
        if dispatches:
            out["dispatches"] = int(dispatches)
        if dt > 0.0:
            if steps:
                out["steps_per_s"] = steps / dt
            if examples:
                out["examples_per_s"] = examples / dt
            if dispatches:
                out["dispatches_per_s"] = dispatches / dt
        if self.recorder is not None:
            for key in ("steps_per_s", "examples_per_s"):
                if key in out:
                    self.recorder.gauge(f"time/{name}/{key}", out[key])
            self.recorder.event(f"time/{name}", **out)
        return out


# ------------------------------------------------------------- profiler

def maybe_profile(profile_dir: Optional[str]):
    """A ``torch.profiler.profile`` that writes one Chrome trace
    (``*.pt.trace.json``) into ``profile_dir`` when it stops
    (``--profile-dir``), with CUDA activity where a card is present; a
    no-op context when ``profile_dir`` is empty. Its ``step()`` marks a
    fused chunk."""
    if not profile_dir:
        return contextlib.nullcontext()
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    os.makedirs(profile_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(profile_dir))


def annotate(name: str):
    """A host-side span on the profiler's timeline
    (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)


#: the reference's name for spans around traced code; in PyTorch both are
#: ``record_function`` spans
named_scope = annotate
