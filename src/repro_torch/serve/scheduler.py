"""Request queue + continuous-batching decode loop.

Port of ``repro.serve.scheduler``. The serving mirror of the paper's
batch-size study: the decode loop's *admission control* decides how many
requests co-batch per step (``max_decode_batch`` — AdaBatch motivates
treating it as a knob, not a constant), while the slot cache
(``serve/slots.py``) makes joins/leaves free of recapture.  One scheduler
iteration:

  1. **retire** slots whose request hit EOS / its token budget / max_seq;
  2. **admit** queued requests into free slots (per-request B=1 prefill)
     up to ``max_decode_batch`` concurrently active;
  3. **swap** — every ``swap_poll_every`` steps, poll the snapshot watcher
     and hot-swap params (in-flight requests keep their KV; their
     completions record both the admitting and finishing generation);
  4. **decode** — one step over all slots (on a CUDA device a replay of
     the slot engine's decode graph); per-request latency accounting on
     the emitted tokens.

``submit`` is bounded-queue admission control: it returns False (request
rejected) when ``max_queue`` requests are already waiting — the caller
sheds load instead of growing an unbounded backlog.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.obs.stats import summarize
from repro_torch.obs.timing import annotate
from repro_torch.serve.slots import SlotKV


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (Sp,) int32
    max_new_tokens: int
    eos_id: Optional[int] = None
    t_submit: float = 0.0


@dataclass
class Completion:
    """One finished request and its accounting."""
    rid: int
    prompt: np.ndarray
    tokens: list[int]                  # generated continuation (<= max_new)
    gen_admitted: int                  # snapshot generation at admit
    gen_finished: int                  # snapshot generation at completion
    t_submit: float
    t_admit: float = 0.0
    t_first: float = 0.0               # first token (prefill) done
    t_done: float = 0.0
    token_times: list[float] = field(default_factory=list)  # per-token gaps
    truncated: bool = False            # hit max_seq before max_new_tokens

    @property
    def text(self) -> np.ndarray:
        return np.concatenate([self.prompt, np.asarray(self.tokens,
                                                       np.int32)])


@dataclass
class SwapEvent:
    step: int                          # scheduler step index of the swap
    generation: int
    trainer_step: int
    load_seconds: float                # restore+validate+swap stall


class _Slot:
    __slots__ = ("req", "comp", "last_emit")

    def __init__(self, req: Request, comp: Completion, now: float):
        self.req = req
        self.comp = comp
        self.last_emit = now


class ContinuousScheduler:
    def __init__(self, model, params=None, *, max_batch: int, max_seq: int,
                 max_decode_batch: Optional[int] = None, max_queue: int = 256,
                 watcher=None, swap_poll_every: int = 8,
                 eos_id: Optional[int] = None, recorder=None):
        # obs: admit/retire/swap are host boundaries already — events and
        # per-token gap observations ride them; None = zero obs cost
        self.recorder = recorder
        self.kv = SlotKV(model, params, max_batch=max_batch, max_seq=max_seq)
        self.max_seq = max_seq
        self.max_decode_batch = min(max_decode_batch or max_batch, max_batch)
        self.max_queue = max_queue
        self.watcher = watcher
        self.swap_poll_every = max(1, swap_poll_every)
        self.eos_id = eos_id
        self.queue: deque[Request] = deque()
        self.slots: dict[int, _Slot] = {}            # slot idx -> occupancy
        self.free: list[int] = list(range(max_batch))[::-1]
        self.generation = watcher.generation if watcher else 0
        self.swap_events: list[SwapEvent] = []
        self.completions: list[Completion] = []
        self.rejected = 0
        self.step_count = 0

    # -- admission control ---------------------------------------------------
    def submit(self, req: Request) -> bool:
        """Enqueue; False = queue full, request shed (bounded backlog)."""
        if len(self.queue) >= self.max_queue:
            self.rejected += 1
            if self.recorder is not None:
                self.recorder.counter("serve/rejected")
            return False
        if not req.t_submit:
            req.t_submit = time.perf_counter()
        self.queue.append(req)
        return True

    @property
    def n_active(self) -> int:
        return len(self.slots)

    @property
    def pending(self) -> int:
        return len(self.queue) + len(self.slots)

    def _admit_ready(self) -> None:
        while (self.queue and self.free
               and self.n_active < self.max_decode_batch):
            req = self.queue.popleft()
            now = time.perf_counter()
            comp = Completion(rid=req.rid, prompt=req.prompt, tokens=[],
                              gen_admitted=self.generation,
                              gen_finished=self.generation,
                              t_submit=req.t_submit, t_admit=now)
            budget = self.max_seq - len(req.prompt)
            if req.max_new_tokens > budget:
                comp.truncated = True
                req.max_new_tokens = budget
            if req.max_new_tokens <= 0:
                # steps=0 contract: the prompt comes back unchanged —
                # no prefill, no slot, no token (also the degenerate
                # prompt-fills-max_seq truncation case)
                comp.t_first = comp.t_done = now
                self.completions.append(comp)
                continue
            slot = self.free.pop()
            tok = self.kv.admit(slot, req.prompt)
            now = time.perf_counter()
            comp.t_first = now
            comp.tokens.append(tok)
            comp.token_times.append(now - comp.t_admit)
            self.slots[slot] = _Slot(req, comp, now)
            if self.recorder is not None:
                self.recorder.counter("serve/admitted")
                self.recorder.observe("serve/queue_wait_s",
                                      comp.t_admit - comp.t_submit)
                self.recorder.event("serve.admit", rid=req.rid, slot=slot,
                                    queue_depth=len(self.queue),
                                    active=self.n_active)
            if self._finished(req, comp):
                self._retire(slot)

    def _finished(self, req: Request, comp: Completion) -> bool:
        if len(comp.tokens) >= req.max_new_tokens:
            return True
        if req.eos_id is not None and comp.tokens[-1] == req.eos_id:
            return True
        if self.eos_id is not None and comp.tokens[-1] == self.eos_id:
            return True
        return False

    def _retire(self, slot: int) -> None:
        occ = self.slots.pop(slot)
        occ.comp.t_done = time.perf_counter()
        occ.comp.gen_finished = self.generation
        self.completions.append(occ.comp)
        self.kv.retire(slot)
        self.free.append(slot)
        if self.recorder is not None:
            c = occ.comp
            self.recorder.counter("serve/retired")
            self.recorder.counter("serve/tokens", len(c.tokens))
            for gap in c.token_times[1:]:      # [0] is prefill, not a gap
                self.recorder.observe("serve/token_gap_s", gap)
            self.recorder.event("serve.retire", rid=c.rid, slot=slot,
                                tokens=len(c.tokens), truncated=c.truncated,
                                queue_depth=len(self.queue),
                                active=self.n_active)

    # -- snapshot swap ---------------------------------------------------------
    def poll_snapshot(self) -> Optional[SwapEvent]:
        """Poll the watcher; on a new snapshot, hot-swap between steps."""
        if self.watcher is None:
            return None
        t0 = time.perf_counter()
        snap = self.watcher.poll()
        if snap is None:
            return None
        self.kv.swap_params(snap.params)
        self.generation = snap.generation
        ev = SwapEvent(step=self.step_count, generation=snap.generation,
                       trainer_step=snap.step,
                       load_seconds=time.perf_counter() - t0)
        self.swap_events.append(ev)
        if self.recorder is not None:
            self.recorder.counter("serve/swaps")
            self.recorder.event("serve.swap", step=ev.step,
                                generation=ev.generation,
                                trainer_step=ev.trainer_step,
                                load_seconds=ev.load_seconds,
                                active=self.n_active)
        return ev

    # -- the loop ----------------------------------------------------------------
    def step(self) -> list[Completion]:
        """One scheduler iteration; returns requests finished this step."""
        n_done = len(self.completions)
        self._admit_ready()
        if self.step_count % self.swap_poll_every == 0:
            self.poll_snapshot()
        self.step_count += 1
        if not self.slots:
            return self.completions[n_done:]
        with annotate("obs/decode_step"):
            toks = self.kv.decode()
        now = time.perf_counter()
        for slot, occ in list(self.slots.items()):
            tok = int(toks[slot])
            occ.comp.tokens.append(tok)
            occ.comp.token_times.append(now - occ.last_emit)
            occ.last_emit = now
            if self._finished(occ.req, occ.comp):
                self._retire(slot)
        return self.completions[n_done:]

    def warmup(self, requests) -> None:
        """Run and discard — captures this scheduler's decode graph (on a
        CUDA device) and runs a prefill of each prompt length, so a
        subsequent timed ``run`` pays no capture and no first-call costs.
        The graph lives on the underlying ``SlotKV``, so warming a
        *different* scheduler instance does not help.  Resets
        completion/latency/step accounting (the obs recorder is detached
        for the duration so warmup traffic never reaches the metrics
        stream)."""
        rec, self.recorder = self.recorder, None
        try:
            self.run(list(requests))
        finally:
            self.recorder = rec
        self.completions.clear()
        self.swap_events.clear()
        self.rejected = 0
        self.step_count = 0

    def run(self, requests=None, *, until=None) -> list[Completion]:
        """Drive until the queue and all slots drain (and ``until()`` — if
        given — returns True).  Returns all completions, submit order."""
        for req in requests or []:
            if not self.submit(req):
                raise RuntimeError(f"queue full at rid={req.rid} "
                                   f"(max_queue={self.max_queue})")
        while self.pending or (until is not None and not until()):
            self.step()
            if not self.pending and until is not None and not until():
                time.sleep(0.01)     # idle: wait for more work / condition
        self.completions.sort(key=lambda c: c.rid)
        return self.completions

    def latency_summary(self) -> dict:
        """Per-token latency stats over every completion so far: prefill
        (first token after admit) and inter-token decode gaps, each as a
        count/mean/min/max/p50/p95 dict (``repro_torch.obs.stats
        .summarize``)."""
        prefill = [c.token_times[0] for c in self.completions
                   if c.token_times]
        gaps = [g for c in self.completions for g in c.token_times[1:]]
        return {"prefill_s": summarize(prefill),
                "token_gap_s": summarize(gaps),
                "completions": len(self.completions),
                "rejected": self.rejected,
                "swaps": len(self.swap_events)}
