"""Parameter server: canonical ``(params, state)`` + server-side SPC.

Port of ``repro.distributed.async_ps.server``. The server owns three things
the async engine must keep globally consistent however the workers race
(paper §6.2):

  1. **the canonical weights and base-rule state**, changed only under the
     server lock, one version per applied push;
  2. **the ψ control queue**: every worker loss is pushed into THIS queue
     (``observe``), so the control limit ψ̄ + kσ and the accelerate
     decision come from the same globally ordered statistics a synchronous
     run would see, not from any worker's stale snapshot;
  3. **the staleness weighting**: a push that raced ``τ`` other pushes is
     folded in as ``new = old + w(τ)·(final − snapshot)`` with ``w`` from
     the :class:`~repro_torch.core.reduce.StalenessReduce` context.

τ == 0 (no push in between: always so with one worker at
``max_staleness=0``) is applied as an exact replacement, a bitwise copy of
the worker's final tensors: the same value as ``old + 1·delta`` (``old``
*is* the snapshot when τ == 0) without the f32 round trip
``snap + (final − snap)``. That is what makes the engine **bit-exact** with
the synchronous per-step engine at the parity anchor.

**Tensors are not immutable.** The reference hands out references to its
canonical arrays because JAX arrays never change. The port's base rules
and Alg. 2 write their tensors in place, so this server keeps one
invariant instead: no tensor it keeps, hands out in a :class:`Snapshot` or
passes to ``checkpoint_fn`` is written by anyone afterwards. It copies at
the boundary where tensors come in (construction, a τ == 0 push,
``load_snapshot``) and replaces its canonical tensors (a τ > 0 fold makes
new ones) instead of writing into them; workers copy a snapshot into their
own replica before they train on it. The ψ queue is already functional
(``control.push`` builds new tensors), so it is shared as it is. Every
copy and fold is enqueued on the caller's current stream, which for every
worker thread is the device's default stream: a copy is ordered after the
worker's writes without events.

The two worker round trips per step (``observe`` then ``push``) mirror the
two places the synchronous ``isgd_step`` touches control state: the queue
push and limit *before* the conservative subproblem, and the commit after
it.

Robustness: the server is also the engine's durability and integrity
point —

  * ``engine_snapshot``/``load_snapshot`` capture/restore the whole server
    state (params, base, ψ queue, version/iteration counters AND the
    per-worker push clocks) under the lock, so a checkpoint taken between
    pushes is *crash-consistent*: pushes are the commit point, and a
    resumed run replays exactly the steps whose pushes never landed. A
    ``checkpoint_fn`` given at construction is called (still under the
    lock) every ``checkpoint_every`` versions;
  * ``verify_pushes=True`` makes ``push`` recompute the worker's content
    checksum over the received trees (``train.checkpoints.tree_checksum``,
    a host crc32 of every byte) and reject a mismatch with
    :class:`~repro_torch.distributed.async_ps.errors.PushRejected`;
  * ``mark_evicted(wid)`` fences a worker the coordinator evicted: its late
    pushes raise
    :class:`~repro_torch.distributed.async_ps.errors.WorkerEvicted`
    instead of folding stale state into the model.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import torch

from repro_torch.core import control
from repro_torch.core.isgd import ISGDConfig, ISGDState
from repro_torch.core.reduce import StalenessReduce
from repro_torch.distributed.async_ps.errors import PushRejected, WorkerEvicted
from repro_torch.obs.timing import annotate


@torch.no_grad()
def copy_tree(tree):
    """A copy of a tree of tuples, NamedTuples, lists and dicts of tensors:
    every tensor cloned (its bits as they are), every other leaf kept."""
    if torch.is_tensor(tree):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: copy_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(copy_tree(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(copy_tree(v) for v in tree)
    return tree


@torch.no_grad()
def fold_tree(old, final, snap, w: float):
    """Staleness-weighted fold for τ > 0: ``old + w·(final − snap)`` in f32,
    cast back to each leaf's dtype (the reference's ``_fold_fn``), into new
    tensors. Leaves that are not tensors are taken from ``old``."""
    if torch.is_tensor(old):
        f32 = torch.float32
        return (old.to(f32) + w * (final.to(f32) - snap.to(f32))).to(old.dtype)
    if isinstance(old, dict):
        return {k: fold_tree(old[k], final[k], snap[k], w) for k in old}
    if isinstance(old, tuple) and hasattr(old, "_fields"):
        return type(old)(*(fold_tree(o, f, s, w)
                           for o, f, s in zip(old, final, snap)))
    if isinstance(old, (list, tuple)):
        return type(old)(fold_tree(o, f, s, w)
                         for o, f, s in zip(old, final, snap))
    return old


def observe_queue(queue, loss, k_sigma: float):
    """Push ``loss`` into ``queue`` -> ``(queue, limit, ψ̄, σ)`` of the
    post-push queue: the ops of ``isgd_step``'s push and limit, in its
    order."""
    q2 = control.push(queue, loss)
    return (q2, control.control_limit(q2, k_sigma), control.mean(q2),
            control.std(q2))


class Snapshot(NamedTuple):
    """What a worker pulls: possibly-stale canonical state + its version.
    Its tensors are never written (module doc): a worker copies them."""
    params: list              # weight tensors
    base: object              # base-rule state (e.g. momentum velocity)
    queue: control.LossQueue  # ψ queue — drives the loss-driven LR (lagged)
    version: int              # server version at pull time


class Decision(NamedTuple):
    """What ``observe`` returns: the server-side SPC verdict for one loss."""
    limit: torch.Tensor       # ψ̄ + kσ from the canonical post-push queue
    psi_bar: torch.Tensor
    psi_std: torch.Tensor
    accelerated: bool         # loss > limit (False during warm-up / SGD mode)


class ParamServer:
    """Thread-safe canonical state holder with server-side SPC control.
    ``params`` and ``base`` are copied: the caller keeps its own tensors."""

    def __init__(self, params, base, isgd_cfg: ISGDConfig, *,
                 reduce_ctx: Optional[StalenessReduce] = None,
                 inconsistent: bool = True, verify_pushes: bool = False,
                 checkpoint_fn: Optional[Callable[[dict], None]] = None,
                 checkpoint_every: int = 0, recorder=None):
        self._lock = threading.Lock()
        # obs ingestion rides the push commit, already a host sync point
        self._recorder = recorder
        self._params = copy_tree(list(params))
        self._base = copy_tree(base)
        dev = self._params[0].device if self._params else torch.device("cpu")
        self._queue = control.init_queue(isgd_cfg.n_batches, device=dev)
        self._cfg = isgd_cfg
        self._ctx = reduce_ctx if reduce_ctx is not None else StalenessReduce()
        self._inconsistent = inconsistent
        self._verify = verify_pushes
        self._ckpt_fn = checkpoint_fn
        self._ckpt_every = checkpoint_every
        self._version = 0
        self._iter = 0
        self._accel_count = 0
        self._sub_iters = 0
        self._pushed: Dict[int, int] = {}      # per-worker SSP push clocks
        self._evicted: set[int] = set()
        self._t0 = time.perf_counter()
        self.records: List[dict] = []

    # -- worker protocol ----------------------------------------------------
    @property
    def version(self) -> int:
        return self._version

    def pull(self) -> Snapshot:
        """The current canonical state. Its tensors are the server's own,
        which nobody writes (module doc), so handing them out under the
        lock is race-free."""
        with self._lock:
            return Snapshot(self._params, self._base, self._queue,
                            self._version)

    def observe(self, loss) -> Decision:
        """Push one batch loss into the canonical ψ queue and return the
        SPC verdict of the *post-push* queue: the order of Alg.1 lines
        13–22 in the synchronous step, on globally consistent statistics."""
        with self._lock:
            q2, limit, psi_bar, psi_std = observe_queue(
                self._queue, loss, self._cfg.k_sigma)
            self._queue = q2
        # a host compare of the exact f32 values: the synchronous step's
        # ``bool(loss > limit)`` (warm-up: limit = inf)
        accelerated = self._inconsistent and float(loss) > float(limit)
        return Decision(limit, psi_bar, psi_std, accelerated)

    def push(self, snap: Snapshot, final_params, final_base, *,
             worker: int, metrics: dict, checksum: Optional[str] = None) -> int:
        """Fold a worker's finished step into the canonical state.

        Returns the staleness τ = versions applied between the worker's pull
        and this push. τ == 0 takes a bitwise copy of the worker's trees
        (exact, see module doc); τ > 0 makes ``old + w(τ)·(final − snap)``
        of params and base state alike. The worker's tensors are only read.

        ``checksum`` (when the server verifies pushes) is the worker's
        content checksum of ``(final_params, final_base)`` computed *before*
        transit; a mismatch on arrival raises :class:`PushRejected` and
        nothing is applied. Pushes from evicted workers raise
        :class:`WorkerEvicted` (also applying nothing).
        """
        if self._verify and checksum is not None:
            # recompute OUTSIDE the lock: checksumming the whole delta is
            # the expensive part and must not serialize healthy pushes
            from repro_torch.train.checkpoints import tree_checksum
            got = tree_checksum((final_params, final_base))
            if got != checksum:
                raise PushRejected(
                    f"worker {worker}: delta checksum mismatch on arrival "
                    f"(sent {checksum}, received {got}) — payload corrupted "
                    f"in transit; rejecting the push")
        t_enter = time.perf_counter()
        with self._lock:
            if worker in self._evicted:
                raise WorkerEvicted(
                    f"worker {worker} push rejected: worker was evicted")
            tau = self._version - snap.version
            assert tau >= 0, (tau, self._version, snap.version)
            t_fold = time.perf_counter()
            if tau == 0:
                self._params = copy_tree(list(final_params))
                self._base = copy_tree(final_base)
            else:
                with annotate("obs/ps_fold"):
                    w = float(self._ctx.weight(tau))
                    self._params = fold_tree(self._params, list(final_params),
                                             snap.params, w)
                    self._base = fold_tree(self._base, final_base, snap.base,
                                           w)
            fold_s = time.perf_counter() - t_fold
            self._version += 1
            self._iter += 1
            self._accel_count += int(metrics.get("accelerated", False))
            self._sub_iters += int(metrics.get("sub_iters", 0))
            self._pushed[worker] = self._pushed.get(worker, 0) + 1
            self.records.append(dict(
                metrics, worker=worker, tau=tau, version=self._version,
                wall=time.perf_counter() - self._t0))
            if (self._ckpt_fn is not None and self._ckpt_every
                    and self._version % self._ckpt_every == 0):
                # under the lock on purpose: the snapshot must pair the
                # just-applied push with its clock (crash consistency)
                self._ckpt_fn(self._snapshot_locked())
        if self._recorder is not None:
            # outside the lock: recording must not serialize healthy pushes
            self._recorder.observe("async_ps/push_commit_s",
                                   time.perf_counter() - t_enter)
            if tau > 0:
                self._recorder.observe("async_ps/fold_s", fold_s)
        return tau

    # -- elasticity / durability -------------------------------------------
    def mark_evicted(self, worker: int) -> None:
        """Fence an evicted worker: its in-flight push (pulled before the
        eviction) must not fold stale state into the canonical params."""
        with self._lock:
            self._evicted.add(worker)

    def _snapshot_locked(self) -> dict:
        return dict(params=self._params, base=self._base, queue=self._queue,
                    version=self._version, iter=self._iter,
                    accel_count=self._accel_count, sub_iters=self._sub_iters,
                    pushed=dict(self._pushed))

    def engine_snapshot(self) -> dict:
        """Crash-consistent view of everything a resumed run needs: params,
        base, ψ queue, counters, and the per-worker push clocks (the
        server's own tensors, which nobody writes)."""
        with self._lock:
            return self._snapshot_locked()

    def load_snapshot(self, snap: dict) -> None:
        """Restore a checkpointed server (inverse of ``engine_snapshot``),
        copying the tensors in. Worker clocks resume from
        ``snap['pushed']``: a step whose push never landed is replayed in
        full — pushes are the commit point."""
        with self._lock:
            self._params = copy_tree(list(snap["params"]))
            self._base = copy_tree(snap["base"])
            self._queue = copy_tree(snap["queue"])
            self._version = int(snap["version"])
            self._iter = int(snap["iter"])
            self._accel_count = int(snap["accel_count"])
            self._sub_iters = int(snap["sub_iters"])
            self._pushed = {int(w): int(n)
                            for w, n in snap.get("pushed", {}).items()}

    def pushed_clocks(self) -> Dict[int, int]:
        with self._lock:
            return dict(self._pushed)

    # -- results ------------------------------------------------------------
    @property
    def params(self) -> list:
        with self._lock:
            return self._params

    def isgd_state(self) -> ISGDState:
        """Canonical state in the per-step engine's ``ISGDState`` layout
        (counters as Python ints), so callers compare/checkpoint
        uniformly."""
        with self._lock:
            return ISGDState(base=self._base, queue=self._queue,
                             iter=self._iter, accel_count=self._accel_count,
                             sub_iters=self._sub_iters)
