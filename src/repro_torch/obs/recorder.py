"""Process-aware structured metrics: counters, gauges, histograms, events.

A copy of ``repro.obs.recorder`` (the port imports nothing of ``repro``),
with the same record schema: files either package writes pass the other's
``validate_record`` (``tests/test_torch_obs.py``). The recorder is
numpy/stdlib only and reads no device value: records are taken at the
existing host-sync boundaries (a fused chunk's one metrics fetch, the
per-step engine's log/eval flushes), so observing adds no device
round-trip.

Record schema (one JSON object per JSONL line)::

    {"v": 1, "kind": "counter|gauge|histogram|event", "name": str,
     "wall": float-seconds-since-recorder-start, "seq": int,
     "tags": {"process_id": int, ...}, ...kind payload}

    counter   -> {"value": increment, "total": running-total}
    gauge     -> {"value": number}
    histogram -> {"stats": {"count", "mean", "min", "max", "p50", "p95"}}
    event     -> {"data": {...}}

Counters and histogram observations accumulate in memory and are emitted
as records on :meth:`MetricsRecorder.flush` (one record per name covering
the interval since the previous flush). Gauges and events emit
immediately. Each process writes its own JSONL
(``metrics.p{process_id}.jsonl``); the coordinator folds them into
``summary.json`` via :func:`write_merged_summary`.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional, Sequence

from repro_torch.obs.console import CONSOLE
from repro_torch.obs.stats import summarize

SCHEMA_VERSION = 1
KINDS = ("counter", "gauge", "histogram", "event")


def _jsonable(v):
    """Best-effort conversion to a JSON-serializable value (numpy scalars
    and 0-d arrays become python scalars; arrays become lists)."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    item = getattr(v, "item", None)
    if item is not None and getattr(v, "ndim", None) in (None, 0):
        return item()
    tolist = getattr(v, "tolist", None)
    if tolist is not None:
        return tolist()
    return repr(v)


# ---------------------------------------------------------------- sinks

class Sink:
    def emit(self, record: dict) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def close(self) -> None:
        pass


class MemorySink(Sink):
    """Keeps records in a list — the test harness sink."""

    def __init__(self):
        self.records: List[dict] = []

    def emit(self, record: dict) -> None:
        self.records.append(record)

    def by_name(self, name: str) -> List[dict]:
        return [r for r in self.records if r["name"] == name]


class JsonlSink(Sink):
    """One JSON object per line; flushed per record so a crashed run still
    leaves a readable chart."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._fh = open(path, "w")

    def emit(self, record: dict) -> None:
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.close()


class ConsoleSink(Sink):
    """Periodic one-line counter summary through the process-0 console.

    Prints whenever the ``train/steps`` running total crosses a multiple of
    ``every`` (counter records arrive at flush boundaries, so cadence is
    boundary-quantized, never mid-hot-path)."""

    def __init__(self, every: int = 0, step_counter: str = "train/steps"):
        self.every = int(every)
        self.step_counter = step_counter
        self._totals: Dict[str, float] = {}
        self._last_bucket = 0

    def emit(self, record: dict) -> None:
        if record["kind"] != "counter":
            return
        self._totals[record["name"]] = record["total"]
        if self.every <= 0 or record["name"] != self.step_counter:
            return
        bucket = int(record["total"]) // self.every
        if bucket > self._last_bucket:
            self._last_bucket = bucket
            parts = " ".join(f"{k}={self._totals[k]:g}" for k in sorted(self._totals))
            CONSOLE.print(f"[obs] {parts}")


# ------------------------------------------------------------- recorder

class MetricsRecorder:
    """Counters / gauges / histograms / typed events over pluggable sinks.

    ``tags`` ride on every record (``process_id`` is required — multi-host
    charts are useless without it; engine/model identify the run)."""

    def __init__(self, sinks: Sequence[Sink], tags: Optional[dict] = None,
                 clock=time.perf_counter):
        self.sinks = list(sinks)
        self.tags = dict(tags or {})
        self.tags.setdefault("process_id", 0)
        self._clock = clock
        self._t0 = clock()
        self._seq = 0
        self._totals: Dict[str, float] = {}
        self._pending_counters: Dict[str, float] = {}
        self._observations: Dict[str, List[float]] = {}
        self._closed = False
        # async-PS worker threads observe() concurrently with the
        # coordinator's event()/flush(); all mutation goes under one lock
        self._lock = threading.Lock()

    # -- emission core (callers hold self._lock)
    def _emit_locked(self, kind: str, name: str, payload: dict) -> None:
        rec = {
            "v": SCHEMA_VERSION,
            "kind": kind,
            "name": name,
            "wall": self._clock() - self._t0,
            "seq": self._seq,
            "tags": self.tags,
        }
        rec.update(payload)
        self._seq += 1
        for s in self.sinks:
            s.emit(rec)

    # -- public surface
    def counter(self, name: str, inc: float = 1) -> None:
        """Accumulate; the record (value=interval delta, total=running) is
        emitted at the next flush()."""
        inc = float(inc)
        with self._lock:
            self._totals[name] = self._totals.get(name, 0.0) + inc
            self._pending_counters[name] = \
                self._pending_counters.get(name, 0.0) + inc

    def gauge(self, name: str, value) -> None:
        with self._lock:
            self._emit_locked("gauge", name, {"value": float(value)})

    def observe(self, name: str, value) -> None:
        """Add one observation to a histogram; stats emit at flush()."""
        with self._lock:
            self._observations.setdefault(name, []).append(float(value))

    def event(self, name: str, **data) -> None:
        payload = {"data": {k: _jsonable(v) for k, v in data.items()}}
        with self._lock:
            self._emit_locked("event", name, payload)

    def total(self, name: str) -> float:
        with self._lock:
            return self._totals.get(name, 0.0)

    def flush(self) -> None:
        """Materialize accumulated counters/histograms as records."""
        with self._lock:
            for name in sorted(self._pending_counters):
                self._emit_locked("counter", name, {
                    "value": self._pending_counters[name],
                    "total": self._totals[name],
                })
            self._pending_counters.clear()
            for name in sorted(self._observations):
                xs = self._observations[name]
                if xs:
                    self._emit_locked("histogram", name,
                                      {"stats": summarize(xs)})
            self._observations.clear()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.flush()
        for s in self.sinks:
            s.close()


# ------------------------------------------------------------ validation

def validate_record(rec) -> List[str]:
    """Return a list of schema violations (empty = valid)."""
    errs: List[str] = []
    if not isinstance(rec, dict):
        return ["record is not an object"]
    if rec.get("v") != SCHEMA_VERSION:
        errs.append(f"v != {SCHEMA_VERSION}")
    kind = rec.get("kind")
    if kind not in KINDS:
        errs.append(f"bad kind {kind!r}")
    if not isinstance(rec.get("name"), str) or not rec.get("name"):
        errs.append("missing name")
    if not isinstance(rec.get("wall"), (int, float)) or rec.get("wall", -1) < 0:
        errs.append("bad wall")
    if not isinstance(rec.get("seq"), int) or rec.get("seq", -1) < 0:
        errs.append("bad seq")
    tags = rec.get("tags")
    if not isinstance(tags, dict) or not isinstance(tags.get("process_id"), int):
        errs.append("tags.process_id missing")
    if kind == "counter":
        if not isinstance(rec.get("total"), (int, float)):
            errs.append("counter missing total")
    elif kind == "gauge":
        if not isinstance(rec.get("value"), (int, float)):
            errs.append("gauge missing value")
    elif kind == "histogram":
        stats = rec.get("stats")
        if not isinstance(stats, dict) or not isinstance(stats.get("count"), int):
            errs.append("histogram missing stats.count")
    elif kind == "event":
        if not isinstance(rec.get("data"), dict):
            errs.append("event missing data")
    return errs


def jsonl_path(obs_dir: str, process_id: int) -> str:
    return os.path.join(obs_dir, f"metrics.p{process_id}.jsonl")


def read_jsonl(path: str) -> List[dict]:
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def write_merged_summary(obs_dir: str, out_name: str = "summary.json") -> dict:
    """Fold per-process JSONL files into one summary (coordinator-only call
    in multi-process runs; assumes the shared FS the checkpoint layer
    already requires).  Counters sum across processes (final totals),
    events count per name."""
    counters: Dict[str, float] = {}
    events: Dict[str, int] = {}
    per_process: Dict[str, dict] = {}
    n_records = 0
    for fname in sorted(os.listdir(obs_dir)):
        if not fname.endswith(".jsonl"):
            continue
        finals: Dict[str, float] = {}
        pid = None
        nrec = 0
        for rec in read_jsonl(os.path.join(obs_dir, fname)):
            nrec += 1
            pid = rec.get("tags", {}).get("process_id", pid)
            if rec.get("kind") == "counter":
                finals[rec["name"]] = rec["total"]  # last total wins
            elif rec.get("kind") == "event":
                events[rec["name"]] = events.get(rec["name"], 0) + 1
        n_records += nrec
        per_process[fname] = {"process_id": pid, "records": nrec, "counters": finals}
        for name, total in finals.items():
            counters[name] = counters.get(name, 0.0) + total
    out = {
        "v": SCHEMA_VERSION,
        "records": n_records,
        "counters": counters,
        "events": events,
        "processes": per_process,
    }
    with open(os.path.join(obs_dir, out_name), "w") as fh:
        json.dump(out, fh, indent=2, sort_keys=True)
    return out
