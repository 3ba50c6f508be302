"""Deterministic fault injection for the async-PS engine.

Port of ``repro.fault.plan``: the same events, spec grammar, seeded
generator and one-shot semantics (a test holds the two equal); only the
in-transit corruption works on the port's trees of tensors.

A :class:`FaultPlan` is a list of :class:`FaultEvent`s targeting specific
``(worker, local step)`` coordinates, threaded into
``repro_torch.distributed.async_ps`` behind a no-op default (``NO_FAULTS``).
Because every event is pinned to a worker/step pair — and the seeded
:meth:`FaultPlan.random` generator derives those pairs from a
``numpy.random.RandomState`` — a CI run injects exactly the same faults
every time, so recovery behavior (eviction, re-striping, retry) is testable
rather than anecdotal.

Event kinds:

  * ``crash``   — the worker raises :class:`InjectedCrash` before running
    the step (after it passed the SSP gate, so the crash holds a gate slot
    exactly like a real mid-protocol death);
  * ``hang``    — the worker sleeps ``seconds`` before the step while
    holding its gate slot; if that exceeds the coordinator's heartbeat
    deadline the worker is evicted while it sleeps;
  * ``slow``    — the worker's steps in ``[step, until]`` (``until=None`` =
    forever) take ``factor``× their measured wall time (the paper's §6.2
    heterogeneous/straggler worker);
  * ``corrupt`` — the push payload is corrupted *after* the worker computed
    its integrity checksum (a bit flip in transit): a verifying server
    rejects the delta and the worker's bounded retry resends it clean;
  * ``transient`` — the push transport raises :class:`TransientPushError`
    once; the worker's retry-with-backoff absorbs it.

One-shot semantics: each event fires at most once per plan instance (a
retried push must not re-trip the same corruption).  Plans are therefore
stateful across a run; call :meth:`reset` (the coordinator does) before
reusing one.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Iterable, Optional

import numpy as np


class InjectedCrash(RuntimeError):
    """A crash injected by a FaultPlan (stands in for a real worker death)."""


class TransientPushError(RuntimeError):
    """A transient, retryable push-transport failure injected by a FaultPlan."""


@dataclass(frozen=True)
class FaultEvent:
    kind: str                      # crash | hang | slow | corrupt | transient
    worker: int                    # target worker id
    step: int                      # local step at which the event fires
    seconds: float = 0.5           # hang duration
    factor: float = 2.0            # slow multiplier (>= 1)
    until: Optional[int] = None    # slow: last affected step (None = forever)

    KINDS = ("crash", "hang", "slow", "corrupt", "transient")

    def __post_init__(self):
        if self.kind not in self.KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {self.KINDS}")


def _corrupt_tree(tree):
    """Flip the first element of the first leaf by a large offset: a
    detectable in-transit corruption that keeps shapes and dtypes valid.

    The port's trees are lists, tuples, NamedTuples and dicts of tensors
    (the first leaf in ``jax.tree_util``'s order: dict keys sorted). The
    corrupted leaf is a new tensor and every other leaf is passed through,
    so the sender's own tensors stay as they were (the retry resends
    them)."""
    import torch

    hit = [False]

    def go(node):
        if torch.is_tensor(node):
            if hit[0]:
                return node
            hit[0] = True
            flat = node.detach().reshape(-1).clone()
            flat[0] += torch.tensor(1e3, dtype=flat.dtype)
            return flat.reshape(node.shape)
        if isinstance(node, dict):
            out = {k: go(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(go(c) for c in node))
        if isinstance(node, (list, tuple)):
            return type(node)(go(c) for c in node)
        return node

    return go(tree)


class FaultPlan:
    """An injectable, per-worker-targeted, reproducible fault schedule.

    The async-PS :class:`~repro_torch.distributed.async_ps.worker.Worker` calls
    ``before_step``/``slow_factor`` around each step and ``on_transit`` on
    each push attempt; with the default empty plan every hook is a cheap
    no-op, so the fault machinery costs nothing when unused.
    """

    def __init__(self, events: Iterable[FaultEvent] = ()):
        self.events = tuple(events)
        self._fired: set[int] = set()
        self._lock = threading.Lock()

    def __bool__(self) -> bool:
        return bool(self.events)

    def __repr__(self) -> str:
        return f"FaultPlan({list(self.events)!r})"

    def reset(self) -> None:
        """Forget which one-shot events fired (start of a fresh run)."""
        with self._lock:
            self._fired.clear()

    def _take(self, i: int) -> bool:
        """Atomically claim one-shot event ``i``; False if already fired."""
        with self._lock:
            if i in self._fired:
                return False
            self._fired.add(i)
            return True

    # -- worker hooks -------------------------------------------------------
    def before_step(self, wid: int, k: int) -> None:
        """Crash/hang injection, called after the worker passed the SSP gate
        for local step ``k`` (so the fault holds a gate slot, exactly like a
        real mid-protocol failure)."""
        for i, e in enumerate(self.events):
            if e.worker != wid or e.step != k:
                continue
            if e.kind == "crash" and self._take(i):
                raise InjectedCrash(
                    f"injected crash: worker {wid} at local step {k}")
            if e.kind == "hang" and self._take(i):
                time.sleep(e.seconds)

    def slow_factor(self, wid: int, k: int) -> float:
        """Product of the slow multipliers active for (wid, k); 1.0 = full
        speed.  Slow events are windows, not one-shots."""
        f = 1.0
        for e in self.events:
            if (e.kind == "slow" and e.worker == wid and e.step <= k
                    and (e.until is None or k <= e.until)):
                f *= e.factor
        return f

    def on_transit(self, wid: int, k: int, tree):
        """The push-transport hook: may corrupt the payload (after checksum
        computation — i.e. in transit) or raise a one-shot transient
        failure.  Returns the (possibly corrupted) payload tree."""
        for i, e in enumerate(self.events):
            if e.worker != wid or e.step != k:
                continue
            if e.kind == "transient" and self._take(i):
                raise TransientPushError(
                    f"injected transient push failure: worker {wid} at "
                    f"local step {k}")
            if e.kind == "corrupt" and self._take(i):
                return _corrupt_tree(tree)
        return tree

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_spec(cls, spec: str) -> "FaultPlan":
        """Parse ``kind@worker:step[:key=value,...]`` events joined by
        ``;`` — e.g. ``"crash@2:5;hang@1:8:seconds=1.0;slow@0:0:factor=3"``.
        """
        events = []
        for part in filter(None, (p.strip() for p in spec.split(";"))):
            try:
                head, rest = part.split("@", 1)
                fields = rest.split(":")
                worker, step = int(fields[0]), int(fields[1])
                kw = {}
                for opt in fields[2:]:
                    key, val = opt.split("=", 1)
                    if key not in ("seconds", "factor", "until"):
                        raise ValueError(f"unknown option {key!r}")
                    kw[key] = int(val) if key == "until" else float(val)
                events.append(FaultEvent(kind=head.strip(), worker=worker,
                                         step=step, **kw))
            except (ValueError, IndexError) as e:
                raise ValueError(
                    f"bad fault spec {part!r} (want "
                    f"kind@worker:step[:key=value,...] with kind in "
                    f"{FaultEvent.KINDS}): {e}") from e
        return cls(events)

    @classmethod
    def random(cls, n_workers: int, steps_per_worker: int, *, seed: int,
               crashes: int = 1, hangs: int = 1, hang_seconds: float = 0.5,
               lo_frac: float = 0.2, hi_frac: float = 0.8) -> "FaultPlan":
        """Seeded random plan: ``crashes + hangs`` distinct workers fail at
        steps drawn from the middle ``[lo_frac, hi_frac)`` of the run (so
        warm-up and the final epoch stay fault-free).  Deterministic in
        ``seed`` — the reproducibility contract CI relies on."""
        assert crashes + hangs < n_workers, (
            "at least one worker must survive the plan")
        rng = np.random.RandomState(seed)
        workers = rng.choice(n_workers, size=crashes + hangs, replace=False)
        lo = max(1, int(steps_per_worker * lo_frac))
        hi = max(lo + 1, int(steps_per_worker * hi_frac))
        events = []
        for i, w in enumerate(workers):
            kind = "crash" if i < crashes else "hang"
            events.append(FaultEvent(kind=kind, worker=int(w),
                                     step=int(rng.randint(lo, hi)),
                                     seconds=hang_seconds))
        return cls(events)


NO_FAULTS = FaultPlan()
