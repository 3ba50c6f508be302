"""Coordinator: N worker threads over per-worker FCPR shards + SSP gate.

Port of ``repro.distributed.async_ps.coordinator``. It drives the async
parameter-server engine in one process: the dataset's FCPR cycle is
striped across workers (worker w's k-th batch is global batch ``k·N + w``,
so one async "round" covers the same batches as N consecutive synchronous
steps and the server's ψ window still means one epoch), worker threads
run the split step of ``worker.py`` against the shared
:class:`~repro_torch.distributed.async_ps.server.ParamServer`, and the
:class:`StalenessGate` bounds how far workers may drift apart.

Staleness semantics (the contract the tests pin down):

  * ``max_staleness`` bounds the SSP *step clock*: a worker may start local
    step k only once every worker has finished step ``k − max_staleness``.
    At ``max_staleness=0`` the rounds are lockstep — the synchronous
    data-parallel schedule — and with a single worker the engine is
    **bit-exact** with the synchronous per-step engine (the parity anchor:
    every pull sees τ = 0, so pushes are exact replacements).
  * The *version* staleness τ recorded per push (and fed to ``w(τ)``) is
    the number of pushes that raced this worker between pull and push;
    under the gate it is bounded by ``(2·max_staleness + 1)·(N − 1)``:
    while a worker sits at step k, each of the N−1 peers can push steps
    k−s through k+s (starting k+s+1 would need the sitter's clock to
    advance), i.e. 2s+1 pushes apiece. At s=0 this is the within-round
    racing bound N−1.

Elasticity (heartbeat, eviction, re-striping):

  * every gate interaction stamps a per-worker heartbeat; a *waiting*
    worker re-stamps on every poll tick, so only a worker that is genuinely
    stuck (hung call, dead thread, injected hang) goes stale. A worker
    that blocks the SSP clock past ``deadline_s`` is detected by whoever it
    blocks;
  * non-elastic gates (the default) fail fast: the waiter raises
    :class:`WorkerStalled` naming the stalled worker and its last
    completed step, and aborts peers;
  * ``elastic=True`` gates *evict* instead: the stalled worker leaves the
    SSP ``min()`` (survivors advance), the server fences its late pushes
    (:meth:`ParamServer.mark_evicted`), and the coordinator re-stripes the
    evicted worker's FCPR shard across survivors
    (:meth:`ShardedFeed.restripe`). A worker whose own step raises (a real
    exception or an injected crash) self-evicts via :meth:`StalenessGate
    .leave` as long as a peer survives; the last survivor's failure aborts
    the run.
  * Re-striping and the ψ window: after an eviction the surviving workers'
    stride changes from N to M < N mid-cycle, so for up to one epoch the
    aggregate push stream visits some batches twice and others late — the
    "one ψ window = one epoch" invariant degrades to "one window ≈ one
    epoch's worth of pushes" until the new striding completes a cycle.
    The SSP staleness bound itself is preserved (the clock only ever
    shrinks its membership).

**Threads on the card.** Every worker is a thread of this process with a
replica of its own (``replica_fn``), and every thread issues its work on
the device's default stream (a new thread starts there, and nothing here
enters another stream): the server's copies and folds are then ordered
after the workers' writes without events, and the device launch counters
of ``kernels/launch_count.py`` stay exact. PyTorch releases the GIL inside
its operators, so the threads' host work overlaps; their device work
shares the one stream. ``warmup`` runs in the calling thread before any
worker thread starts: it loads the kernels (so no two threads race into
``kernels.build.load``) and makes the cuBLAS state, so no first step runs
into the heartbeat deadline. With one worker the run stays in the calling
thread.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.core.isgd import ISGDConfig, ISGDState, assign_
from repro_torch.core.reduce import StalenessReduce
from repro_torch.distributed.async_ps.errors import (WorkerEvicted,
                                                     WorkerFailure,
                                                     WorkerStalled)
from repro_torch.distributed.async_ps.server import ParamServer, copy_tree
from repro_torch.distributed.async_ps.worker import Worker, make_worker_fns
from repro_torch.fault.plan import NO_FAULTS, FaultPlan
from repro_torch.optim.base import UpdateRule
from repro_torch.train.trainer import TrainLog


class StalenessGate:
    """SSP bounded-staleness gate over per-worker step counts, with
    heartbeat-deadline stall detection and (optionally) eviction.

    ``deadline_s`` is the stall contract: a worker that blocks the SSP
    clock without a heartbeat for longer than this is considered dead.  It
    must comfortably exceed the longest healthy step (compile time
    included) — waiting at the gate does NOT age a worker's heartbeat, only
    genuine unresponsiveness does.  ``on_evict(wid, last_step, survivors,
    reason)`` is invoked under the gate lock, so membership changes are
    atomic with respect to workers passing the gate; the callback must not
    call back into the gate.
    """

    def __init__(self, n_workers: int, max_staleness: int, *,
                 deadline_s: float = 120.0, elastic: bool = False,
                 on_evict: Optional[Callable] = None,
                 poll_s: Optional[float] = None):
        assert n_workers >= 1 and max_staleness >= 0
        self.max_staleness = max_staleness
        self.deadline_s = deadline_s
        self.elastic = elastic
        self._on_evict = on_evict
        self._poll = poll_s if poll_s is not None else min(deadline_s / 4, 1.0)
        self._done = [0] * n_workers
        self._active = [True] * n_workers
        self._beat = [time.monotonic()] * n_workers
        self._evicted: Dict[int, str] = {}
        self._cv = threading.Condition()
        self._error = None

    # -- pure predicates ----------------------------------------------------
    def permits(self, k: int, min_done: int) -> bool:
        """Pure predicate: may a worker start step k when the slowest worker
        has completed ``min_done`` steps?"""
        return min_done >= k - self.max_staleness

    def _min_done_locked(self) -> int:
        return min(self._done[w] for w in range(len(self._done))
                   if self._active[w])

    def active_workers(self) -> List[int]:
        with self._cv:
            return [w for w in range(len(self._active)) if self._active[w]]

    def evictions(self) -> Dict[int, str]:
        with self._cv:
            return dict(self._evicted)

    # -- worker protocol ----------------------------------------------------
    def heartbeat(self, wid: int) -> None:
        """Stamp liveness mid-step (workers call this between their server
        round-trips, so long healthy steps never look like stalls).  Doubles
        as the mid-step eviction fence: a worker evicted while computing
        unwinds here, *before* its next ``observe`` would push a loss into
        the canonical ψ queue."""
        with self._cv:
            if not self._active[wid]:
                raise WorkerEvicted(
                    f"worker {wid} evicted: {self._evicted[wid]}")
            self._beat[wid] = time.monotonic()

    def start(self, wid: int, k: int) -> None:
        with self._cv:
            self._beat[wid] = time.monotonic()
            while True:
                if self._error is not None:
                    raise RuntimeError(
                        f"worker {wid} aborted: peer failed") from self._error
                if not self._active[wid]:
                    raise WorkerEvicted(
                        f"worker {wid} evicted: {self._evicted[wid]}")
                if self.permits(k, self._min_done_locked()):
                    return
                self._cv.wait(timeout=self._poll)
                now = time.monotonic()
                self._beat[wid] = now          # a waiting worker is alive
                stalled = [w for w in range(len(self._done))
                           if self._active[w] and w != wid
                           and self._done[w] < k - self.max_staleness
                           and now - self._beat[w] > self.deadline_s]
                for w in stalled:
                    if self.elastic and len([a for a in self._active
                                             if a]) > 1:
                        self._evict_locked(
                            w, f"missed heartbeat deadline "
                               f"({self.deadline_s:.2f}s) blocking the SSP "
                               f"clock at step {self._done[w]}")
                    else:
                        err = WorkerStalled(
                            f"worker {w} stalled: no heartbeat for "
                            f"{now - self._beat[w]:.2f}s (deadline "
                            f"{self.deadline_s:.2f}s); last completed step "
                            f"{self._done[w]} while worker {wid} waits to "
                            f"start step {k}.  A worker that dies without "
                            f"abort() no longer deadlocks its peers.")
                        self._error = err
                        self._cv.notify_all()
                        raise err

    def finish(self, wid: int) -> None:
        with self._cv:
            if not self._active[wid]:
                return                         # late finish from an evictee
            self._done[wid] += 1
            self._beat[wid] = time.monotonic()
            self._cv.notify_all()

    # -- membership ---------------------------------------------------------
    def _evict_locked(self, wid: int, reason: str) -> None:
        self._active[wid] = False
        self._evicted[wid] = reason
        survivors = [w for w in range(len(self._active)) if self._active[w]]
        self._cv.notify_all()
        if self._on_evict is not None:
            self._on_evict(wid, self._done[wid], survivors, reason)

    def evict(self, wid: int, reason: str) -> None:
        with self._cv:
            if self._active[wid]:
                self._evict_locked(wid, reason)

    def leave(self, wid: int, err: BaseException) -> bool:
        """A worker's own step failed.  Elastic + surviving peers ⇒ the
        worker self-evicts (returns True); otherwise the failure aborts the
        whole gate exactly like the pre-elastic engine (returns False)."""
        with self._cv:
            if not self._active[wid]:
                return True                    # already evicted: just unwind
            if self.elastic and sum(self._active) > 1:
                self._evict_locked(wid, f"worker failed: {err!r}")
                return True
            if self._error is None:
                self._error = err
            self._cv.notify_all()
            return False

    def abort(self, err: BaseException) -> None:
        with self._cv:
            if self._error is None:
                self._error = err
            self._cv.notify_all()


class ShardedFeed:
    """Worker w's FCPR shard: local step k ⇒ global batch ``k·N + w``, as
    tensors on ``device``.

    Striding (rather than contiguous blocks) keeps each async round aligned
    with N consecutive synchronous steps of the same global cycle; with
    N == 1 this is the unmodified global sampler, which is what the
    bit-exact parity anchor relies on.

    ``n_batches % n_workers == 0`` is not required: the strided indices
    ``k·N + w`` enumerate every global step exactly once across workers,
    so collectively each FCPR cycle is still covered once per
    round-of-rounds — only *fixed per-worker batch ownership* is lost when
    N does not divide the cycle (a worker's shard rotates through the
    cycle instead). That generality is what re-striping needs: after an
    eviction the coordinator calls :meth:`restripe` and the M survivors
    carry on with stride M over the same global cycle.
    """

    def __init__(self, sampler, wid: int, n_workers: int, device="cuda"):
        assert 1 <= n_workers and 0 <= wid < n_workers
        self.sampler = sampler
        self.device = torch.device(device)
        self._stripe = (wid, n_workers)        # swapped atomically on restripe

    @property
    def wid(self) -> int:
        return self._stripe[0]

    @property
    def n_workers(self) -> int:
        return self._stripe[1]

    @property
    def n_batches(self) -> int:
        """Batches per local cycle (ceil: the last stripe may be short)."""
        w, n = self._stripe
        return -(-self.sampler.n_batches // n)

    def restripe(self, wid: int, n_workers: int) -> None:
        """Re-assign this feed to stripe ``wid`` of ``n_workers`` (eviction
        re-striping). A single tuple swap so a racing ``__call__`` sees
        either the old assignment or the new, never a torn pair."""
        self._stripe = (wid, n_workers)

    def take(self, k: int) -> tuple:
        """-> ``(global step, batch)`` of local step ``k``, both under one
        read of the stripe."""
        w, n = self._stripe
        g = k * n + w
        return g, {key: torch.as_tensor(v).to(self.device)
                   for key, v in self.sampler(g).items()}

    def __call__(self, k: int) -> dict:
        return self.take(k)[1]


class AsyncPSCoordinator:
    """Builds the server + workers and runs the async engine end to end.

    Mirrors the reference's ``(init, run)`` ergonomics: construct with the
    replicas, the rule and the config, then ``run(params0, sampler, steps)``
    → ``(params, state, records)`` where ``state`` is a per-step-layout
    ``ISGDState`` and ``records`` is the per-push metrics list in server
    apply order (each with ``worker``/``tau``/``version``/``wall``).

    ``replica_fn(wid) -> (params, loss_fn)`` makes worker ``wid``'s replica:
    a param list of its own and ``loss_fn(batch)`` over those params (the
    reference takes one pure ``loss_fn(params, batch)`` instead; module
    doc of ``worker.py``). Its values do not matter: each step loads the
    pulled snapshot into it. ``run`` never writes ``params0``.

    Robustness knobs (all default to the strict behaviour):

      * ``elastic`` — evict unresponsive/crashed workers and re-stripe
        their FCPR shard across survivors instead of failing the run;
      * ``deadline_s`` — the heartbeat deadline feeding stall detection;
      * ``faults`` — a :class:`repro_torch.fault.FaultPlan` injected into
        every worker (no-op by default);
      * ``verify_pushes`` — workers checksum their deltas and the server
        rejects corrupt arrivals; rejected/transient pushes are retried
        with exponential backoff (``push_retries``);
      * ``snapshot_hook`` — handed to every worker (``Worker``).

    After ``run``, ``self.events`` lists evictions/crashes in order and
    ``self.server`` is the run's server.
    """

    def __init__(self, replica_fn: Callable, rule: UpdateRule,
                 isgd_cfg: ISGDConfig, *, workers: int = 1,
                 max_staleness: int = 0, lr_fn: Callable,
                 reduce_ctx: Optional[StalenessReduce] = None,
                 inconsistent: bool = True, micro_batches: int = 1,
                 elastic: bool = False, deadline_s: float = 120.0,
                 faults: FaultPlan = NO_FAULTS, verify_pushes: bool = False,
                 push_retries: int = 3, recorder=None,
                 snapshot_hook: Optional[Callable] = None):
        self.recorder = recorder          # obs: push/fold latency + events
        self.rule = rule
        self.isgd_cfg = isgd_cfg
        self.workers = workers
        self.max_staleness = max_staleness
        self.reduce_ctx = (reduce_ctx if reduce_ctx is not None
                           else StalenessReduce())
        self.inconsistent = inconsistent
        self.elastic = elastic
        self.deadline_s = deadline_s
        self.faults = faults
        self.verify_pushes = verify_pushes
        self.push_retries = push_retries
        self.snapshot_hook = snapshot_hook
        self.events: List[dict] = []
        self.server = None
        made = [replica_fn(w) for w in range(workers)]
        self.replicas = [list(params) for params, _ in made]
        self.fns = [make_worker_fns(
            loss_fn, rule, isgd_cfg, lr_fn=lr_fn, reduce_ctx=self.reduce_ctx,
            micro_batches=micro_batches) for _, loss_fn in made]

    def warmup(self, params0, sampler) -> None:
        """Run every piece a timed run will hit, once, in the calling
        thread: ``propose``, the ``accelerate`` subproblem (which a short
        run can never reach: the ψ queue needs a full epoch before the
        limit is finite), and the server's observe and both push paths.
        On the card that loads the kernels and makes the cuBLAS state
        before any worker thread starts. It runs on worker 0's replica and
        puts the replica's values back; ``params0`` is not written."""
        propose, accelerate = self.fns[0]
        params = self.replicas[0]
        dev = params[0].device
        saved = copy_tree(params)
        batch = ShardedFeed(sampler, 0, 1, dev)(0)
        base = self.rule.init(params)
        srv = ParamServer(params0, base, self.isgd_cfg,
                          reduce_ctx=self.reduce_ctx,
                          inconsistent=self.inconsistent)
        s1, s2 = srv.pull(), srv.pull()
        with torch.no_grad():
            assign_(params, s1.params)
        p1, b1, loss, aux, lr = propose(params, base, s1.queue, batch)
        srv.observe(loss)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        accelerate(p1, batch, zero, loss, lr)
        srv.push(s1, p1, b1, worker=0, metrics={})      # τ=0 replacement
        srv.push(s2, p1, b1, worker=0, metrics={})      # τ=1 ⇒ fold path
        with torch.no_grad():
            assign_(params, saved)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def run(self, params0, sampler, steps: int, *,
            resume: Optional[dict] = None,
            checkpoint_fn: Optional[Callable[[dict], None]] = None,
            checkpoint_every: int = 0):
        """Run to ``steps`` total pushes (rounded up to whole rounds).

        ``resume`` is a server snapshot dict (``ParamServer
        .engine_snapshot`` / ``snapshot_from_checkpoint``): the server state
        is restored and each worker continues from its own SSP push clock —
        with one worker this resumption is bit-exact with the uninterrupted
        run (``repro_torch.train.resume_parity``). ``checkpoint_fn`` is
        called with a crash-consistent snapshot every ``checkpoint_every``
        applied pushes.
        """
        n = self.workers
        if steps % n:
            steps = -(-steps // n) * n        # whole rounds
        self.faults.reset()
        self.events = []
        dev = params0[0].device
        server = ParamServer(params0, self.rule.init(list(params0)),
                             self.isgd_cfg, reduce_ctx=self.reduce_ctx,
                             inconsistent=self.inconsistent,
                             verify_pushes=self.verify_pushes,
                             checkpoint_fn=checkpoint_fn,
                             checkpoint_every=checkpoint_every,
                             recorder=self.recorder)
        self.server = server
        if resume is not None:
            server.load_snapshot(resume)
        clocks = server.pushed_clocks()
        feeds = [ShardedFeed(sampler, w, n, dev) for w in range(n)]

        def on_evict(wid, last_step, survivors, reason):
            server.mark_evicted(wid)
            for rank, w in enumerate(survivors):
                feeds[w].restripe(rank, len(survivors))
            self.events.append(dict(
                event="evict", worker=wid, last_step=last_step,
                reason=reason, survivors=list(survivors),
                at_version=len(server.records)))

        gate = StalenessGate(n, self.max_staleness,
                             deadline_s=self.deadline_s, elastic=self.elastic,
                             on_evict=on_evict if self.elastic else None)
        if resume is not None:
            # push clocks are the SSP resume point: a step whose push never
            # landed is replayed (pushes are the commit point)
            with gate._cv:
                for w in range(n):
                    gate._done[w] = clocks.get(w, 0)
        crew = [Worker(w, server, feeds[w], self.fns[w], gate, steps // n,
                       params=self.replicas[w],
                       base=self.rule.init(self.replicas[w]),
                       start_step=clocks.get(w, 0), faults=self.faults,
                       push_retries=self.push_retries,
                       verify_pushes=self.verify_pushes,
                       snapshot_hook=self.snapshot_hook)
                for w in range(n)]
        if n == 1:
            crew[0].run()                     # in-thread: easier to debug
        else:
            threads = [threading.Thread(target=w.run, name=f"async-ps-{w.wid}")
                       for w in crew]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        for w in crew:
            if w.evicted and w.error is not None:
                self.events.append(dict(
                    event="crash", worker=w.wid, error=repr(w.error),
                    traceback=w.error_tb))
        failures = [w for w in crew if w.error is not None and not w.evicted]
        if failures:
            # surface the root cause, not a bystander's gate-abort error
            def secondary(w):
                return (isinstance(w.error, RuntimeError)
                        and "peer failed" in str(w.error))
            prim = next((w for w in failures if not secondary(w)), failures[0])
            raise WorkerFailure(prim.wid, prim.error,
                                prim.error_tb or "<no traceback captured>") \
                from prim.error
        return server.params, server.isgd_state(), server.records


# -- engine-checkpoint plumbing (launch/train.py, resume_parity) -------------
def snapshot_engine_kwargs(snap: dict) -> dict:
    """Server snapshot → ``checkpoints.save_engine`` kwargs (less the
    ``layout``): the canonical state in the per-step ``ISGDState`` layout
    plus the async extras (version counter, per-worker SSP push clocks)."""
    state = ISGDState(base=snap["base"], queue=snap["queue"],
                      iter=int(snap["iter"]),
                      accel_count=int(snap["accel_count"]),
                      sub_iters=int(snap["sub_iters"]))
    return dict(params=snap["params"], state=state, step=int(snap["version"]),
                server={"version": int(snap["version"]),
                        "pushed": dict(snap["pushed"])})


def snapshot_from_checkpoint(ck) -> dict:
    """``checkpoints.EngineCheckpoint`` → ``ParamServer.load_snapshot``
    input (inverse of :func:`snapshot_engine_kwargs`)."""
    if ck.server is None:
        raise ValueError("checkpoint has no async-PS server metadata; was "
                         "it written by a synchronous engine?")
    return dict(params=ck.params, base=ck.state.base, queue=ck.state.queue,
                version=int(ck.server["version"]), iter=int(ck.state.iter),
                accel_count=int(ck.state.accel_count),
                sub_iters=int(ck.state.sub_iters),
                pushed=dict(ck.server["pushed"]))


def records_to_trainlog(records) -> TrainLog:
    """Server push records → the host ``TrainLog`` schema.

    Walls are real per-push host timestamps, but with more than one worker
    the pushes *overlap*: consecutive-push deltas are ~cost/N, not the cost
    of an update, so multi-worker walls are marked ``wall_est=True`` and
    timing fits must refuse them (single-worker runs are sequential and
    keep true walls)."""
    overlapping = len({r["worker"] for r in records}) > 1
    log = TrainLog()
    for r in records:
        log.append(r, r["wall"], wall_estimated=overlapping)
    return log
