"""``TrainObserver``: the one object a launch driver threads through a run.

Port of ``repro.obs.observer``. It bundles a
:class:`~repro_torch.obs.recorder.MetricsRecorder`, an
:class:`~repro_torch.obs.spc.SPCExporter` and a
:class:`~repro_torch.obs.timing.StepTimer`, and keeps the boundary rule:
it takes **host** values only, the ones the driver already fetched, and
never reads the device itself.

* the per-step engine (``train.train``) fetches its deferred metrics in
  one transfer at each log/eval boundary, then ``defer()``s each step's
  host row and ``flush()``es;
* the fused engine calls ``chunk()`` with the (K,) host arrays that
  ``TrainLog.extend`` fetched, the chunk's one transfer, so observing adds
  none;
* ``finalize(state)`` emits the Fig. 3 ``spc.final`` snapshot with the
  bit-exact reconcile verdict against the engine state and closes the
  recorder.

A torch tensor handed to ``defer``/``chunk`` raises: turning it into a
host value would be a second transfer that the boundary rule forbids.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.obs.recorder import MetricsRecorder
from repro_torch.obs.spc import SPCExporter, engine_snapshot
from repro_torch.obs.timing import StepTimer

_SKIP_KEYS = ("aux",)  # not chartable scalars


def _host_metrics(metrics: dict) -> dict:
    out = {}
    for k, v in metrics.items():
        if k in _SKIP_KEYS:
            continue
        if torch.is_tensor(v):
            raise TypeError(
                f"obs takes the metrics the driver already fetched, not "
                f"tensors: {k!r} is a tensor on {v.device} (fetch it once "
                f"with TrainLog.extend / train's flush)")
        out[k] = np.asarray(v)
    return out


class TrainObserver:
    def __init__(self, recorder: MetricsRecorder, *, n_batches: int,
                 k_sigma: float = 3.0, table: bool = False,
                 examples_per_step: int = 0, replay_exact: bool = True,
                 emit_steps: bool = True):
        self.recorder = recorder
        self.spc = SPCExporter(n_batches, k_sigma,
                               mode="table" if table else "fifo",
                               recorder=recorder, emit_steps=emit_steps)
        self.timer = StepTimer(recorder)
        self.examples_per_step = int(examples_per_step)
        self.replay_exact = replay_exact
        self._pending: List[Tuple[int, dict]] = []
        self._visits: Optional[np.ndarray] = None
        self._n_batches = int(n_batches)
        self._finalized = None

    # ------------------------------------------------------ per-step path
    def defer(self, step: int, metrics: dict) -> None:
        """Buffer a step's host metrics until flush()."""
        self._pending.append((int(step), _host_metrics(metrics)))

    def flush(self) -> None:
        """Ingest the deferred metrics (at a log/eval boundary)."""
        for step, m in self._pending:
            self._ingest_step(step, m)
        self._pending.clear()
        self.recorder.flush()

    # ------------------------------------------------------- chunked path
    def chunk(self, first_step: int, stacked_metrics: dict) -> None:
        """Ingest one fused chunk's (K,) host metrics, fetched by the driver
        at the chunk boundary."""
        host = _host_metrics(stacked_metrics)
        n = int(host["loss"].shape[0])
        for i in range(n):
            self._ingest_step(first_step + i, {k: v[i] for k, v in host.items()})
        self.recorder.counter("train/dispatches")
        self.recorder.flush()

    # ----------------------------------------------------------- internals
    def _ingest_step(self, step: int, host: dict) -> None:
        batch = host.get("batch_idx")
        batch = None if batch is None else int(batch)
        self.spc.ingest(step, host, batch=batch)
        if batch is not None:
            if self._visits is None:
                self._visits = np.zeros(self._n_batches, dtype=np.int64)
            self._visits[batch] += 1
        self.recorder.counter("train/steps")
        if self.examples_per_step:
            self.recorder.counter("train/examples", self.examples_per_step)

    # ------------------------------------------------------------ wrap-up
    def async_run(self, records, events=()) -> None:
        """Ingest an async-PS run: the server's per-push host records (in
        commit order) and the coordinator's eviction/crash events."""
        for i, r in enumerate(records):
            self._ingest_step(i, _host_metrics(
                {k: v for k, v in r.items()
                 if k in ("loss", "psi_bar", "psi_std", "limit",
                          "accelerated", "sub_iters")}))
            self.recorder.observe("async_ps/tau", r["tau"])
            self.recorder.counter("async_ps/pushes")
        for ev in events:
            name = ev.get("event", "event")
            self.recorder.event(f"async_ps.{name}",
                                **{k: v for k, v in ev.items() if k != "event"})
        self.recorder.flush()

    def finalize(self, state=None, *, steps: int = 0, wall: float = 0.0,
                 dispatches: int = 0, close: bool = True) -> dict:
        """Flush everything, emit the ``spc.final`` chart snapshot (with the
        reconcile verdict when the final engine state is given; its queue
        and counters come to the host in one transfer) and the run
        throughput; returns the final payload."""
        if self._finalized is not None:
            return self._finalized
        self.flush()
        if self._visits is not None:
            self.recorder.event("sched.visits", counts=self._visits.tolist())
        payload = self.spc.chart_payload()
        if state is not None:
            snap = engine_snapshot(state)
            verdict = self.spc.reconcile(snap, replay_exact=self.replay_exact)
            payload.update(verdict)
            payload["engine_counters"] = {"iter": snap.iter,
                                          "accel_count": snap.accel_count,
                                          "sub_iters": snap.sub_iters}
        if wall:
            self.timer.add("run", wall)
            payload["throughput"] = self.timer.throughput(
                "run", steps=steps,
                examples=steps * self.examples_per_step,
                dispatches=dispatches or int(self.recorder.total("train/dispatches")))
        self.recorder.event("spc.final", **payload)
        self.recorder.flush()
        if close:
            self.recorder.close()
        self._finalized = payload
        return payload
