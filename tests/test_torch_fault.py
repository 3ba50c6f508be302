"""Fault injection and elastic recovery of the port's async-PS engine
(``repro_torch.fault``, ``repro_torch.distributed.async_ps``), on the CPU.

Mirrors ``tests/test_fault.py``:

  * ``FaultPlan`` — the copy held equal to the reference's: the same
    events from ``from_spec`` and from the seeded ``random``, the same
    corruption of the same tree (tolerance 0: equal arrays); one-shot
    firing and ``reset``; the slow windows; corruption out of place;
  * the gate's stall diagnostic, a waiting worker that is not stalled,
    elastic eviction;
  * the server's fence for an evicted worker and its snapshot round trip;
  * elastic crash and hang runs that complete and re-stripe, a non-elastic
    stall that raises ``WorkerStalled``, a last survivor's crash that
    raises ``WorkerFailure`` with its traceback; corrupt and transient
    pushes retried bit for bit; retry exhaustion;
  * ``run_resume_parity``'s per-step and async-PS legs, bit for bit.

Every threaded test joins its threads with a timeout and uses deadlines of
a second or less.
"""
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fault import FaultPlan as JPlan
from repro.fault.plan import _corrupt_tree as j_corrupt
from repro_torch.core import ISGDConfig
from repro_torch.data import FCPRSampler
from repro_torch.distributed.async_ps import (AsyncPSCoordinator, ParamServer,
                                              StalenessGate, WorkerEvicted,
                                              WorkerFailure, WorkerStalled)
from repro_torch.fault import FaultEvent, FaultPlan, InjectedCrash
from repro_torch.fault.plan import _corrupt_tree
from repro_torch.optim import momentum

torch.set_num_threads(2)
JOIN_S = 60


def in_thread(fn, timeout=JOIN_S):
    """``fn()`` in a thread joined with a timeout -> its result (its
    exception re-raised here)."""
    out = {}

    def body():
        try:
            out["value"] = fn()
        except BaseException as e:               # noqa: BLE001
            out["error"] = e

    t = threading.Thread(target=body, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), f"{fn} did not finish in {timeout} s"
    if "error" in out:
        raise out["error"]
    return out["value"]


def _fields(plan):
    return [(e.kind, e.worker, e.step, e.seconds, e.factor, e.until)
            for e in plan.events]


# ---------------------------------------------------------------------------
# FaultPlan: spec grammar, seeded reproducibility, one-shot semantics
# ---------------------------------------------------------------------------
SPEC = "crash@2:5; hang@1:8:seconds=1.5; slow@0:0:factor=3:until=9"


def test_fault_plan_from_spec():
    plan = FaultPlan.from_spec(SPEC)
    kinds = [(e.kind, e.worker, e.step) for e in plan.events]
    assert kinds == [("crash", 2, 5), ("hang", 1, 8), ("slow", 0, 0)]
    assert plan.events[1].seconds == 1.5
    assert plan.events[2].factor == 3.0 and plan.events[2].until == 9
    assert _fields(plan) == _fields(JPlan.from_spec(SPEC))
    assert not FaultPlan.from_spec("")          # empty spec = no faults
    for bad in ("explode@0:1", "crash@0:1:wat=2"):
        with pytest.raises(ValueError, match="bad fault spec"):
            FaultPlan.from_spec(bad)
        with pytest.raises(ValueError, match="bad fault spec"):
            JPlan.from_spec(bad)


@pytest.mark.parametrize("seed", [7, 8, 11])
def test_fault_plan_random_equals_reference(seed):
    a = FaultPlan.random(4, 20, seed=seed, crashes=1, hangs=1)
    b = FaultPlan.random(4, 20, seed=seed, crashes=1, hangs=1)
    assert a.events == b.events                 # reproducible in the seed
    assert _fields(a) == _fields(JPlan.random(4, 20, seed=seed, crashes=1,
                                              hangs=1))
    assert len({e.worker for e in a.events}) == 2   # distinct workers
    assert all(4 <= e.step < 16 for e in a.events)  # middle [0.2, 0.8)
    with pytest.raises(AssertionError, match="survive"):
        FaultPlan.random(2, 20, seed=seed, crashes=1, hangs=1)


def test_fault_plan_one_shot_and_reset():
    plan = FaultPlan([FaultEvent(kind="corrupt", worker=0, step=1)])
    tree = {"w": torch.zeros(3)}
    out1 = plan.on_transit(0, 1, tree)
    assert float(out1["w"][0]) == 1e3           # corrupted once
    assert float(tree["w"][0]) == 0.0           # out of place
    out2 = plan.on_transit(0, 1, tree)
    assert float(out2["w"][0]) == 0.0           # one-shot: retry sees clean
    plan.reset()
    out3 = plan.on_transit(0, 1, tree)
    assert float(out3["w"][0]) == 1e3


def test_corrupt_tree_equals_reference():
    """The first leaf in ``jax.tree_util``'s order (dict keys sorted) gets
    +1e3 at its first element, in its own dtype; the rest pass through."""
    rng = np.random.RandomState(0)
    b = rng.randn(2, 3).astype(np.float32)
    a = rng.randn(4).astype(np.float32)
    h = rng.randn(2).astype(np.float32)
    tree = ({"b": torch.from_numpy(b), "a": [torch.from_numpy(a)]},
            torch.from_numpy(h).to(torch.bfloat16))
    got = _corrupt_tree(tree)
    want = j_corrupt(({"b": jnp.asarray(b), "a": [jnp.asarray(a)]},
                      jnp.asarray(h, jnp.bfloat16)))
    np.testing.assert_array_equal(got[0]["a"][0].numpy(),
                                  np.asarray(want[0]["a"][0]))
    np.testing.assert_array_equal(got[0]["b"].numpy(),
                                  np.asarray(want[0]["b"]))
    np.testing.assert_array_equal(got[1].float().numpy(),
                                  np.asarray(want[1], np.float32))
    assert float(got[0]["a"][0][0]) != float(a[0])
    assert torch.equal(tree[0]["a"][0], torch.from_numpy(a))    # untouched
    # a bf16 first leaf: the add rounds in bf16, as in the reference
    (gb,) = _corrupt_tree([torch.from_numpy(h).to(torch.bfloat16)])
    (wb,) = j_corrupt([jnp.asarray(h, jnp.bfloat16)])
    np.testing.assert_array_equal(gb.float().numpy(),
                                  np.asarray(wb, np.float32))


def test_slow_factor_windows():
    events = [dict(kind="slow", worker=1, step=2, factor=2.0, until=4),
              dict(kind="slow", worker=1, step=3, factor=3.0)]
    plan = FaultPlan([FaultEvent(**e) for e in events])
    jplan = JPlan([__import__("repro.fault", fromlist=["FaultEvent"])
                   .FaultEvent(**e) for e in events])
    assert plan.slow_factor(1, 1) == 1.0
    assert plan.slow_factor(1, 2) == 2.0
    assert plan.slow_factor(1, 3) == 6.0        # windows compose
    assert plan.slow_factor(1, 5) == 3.0        # first window closed
    assert plan.slow_factor(0, 3) == 1.0        # per-worker targeting
    assert all(plan.slow_factor(w, k) == jplan.slow_factor(w, k)
               for w in (0, 1) for k in range(8))


# ---------------------------------------------------------------------------
# gate: stall diagnostics (non-elastic) and eviction (elastic)
# ---------------------------------------------------------------------------
def test_gate_stall_raises_diagnostic_not_spin():
    gate = StalenessGate(2, max_staleness=0, deadline_s=0.2)
    gate.finish(1)                              # worker 1 completed step 0
    err = []
    t = threading.Thread(target=lambda: err.append(
        pytest.raises(WorkerStalled, gate.start, 1, 1)), daemon=True)
    t.start()
    t.join(timeout=JOIN_S)
    assert not t.is_alive() and len(err) == 1
    msg = str(err[0].value)
    assert "worker 0 stalled" in msg and "last completed step 0" in msg


def test_gate_waiting_worker_is_not_stalled():
    gate = StalenessGate(2, max_staleness=0, deadline_s=0.2, elastic=True)
    done = []

    def worker(wid):
        for k in range(6):
            gate.start(wid, k)
            time.sleep(0.08)                    # step > poll interval
            gate.finish(wid)
        done.append(wid)

    ts = [threading.Thread(target=worker, args=(w,), daemon=True)
          for w in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=JOIN_S)
    assert sorted(done) == [0, 1] and gate.evictions() == {}


def test_gate_elastic_evicts_and_unblocks():
    gate = StalenessGate(2, max_staleness=0, deadline_s=0.2, elastic=True)
    evicted = []
    gate._on_evict = lambda wid, last, survivors, reason: \
        evicted.append((wid, last, survivors))
    gate.finish(1)
    in_thread(lambda: gate.start(1, 1))         # blocks, then evicts 0
    assert evicted == [(0, 0, [1])]
    assert 0 in gate.evictions() and gate.active_workers() == [1]
    gate.finish(0)                              # late finish: ignored
    assert gate._done[0] == 0
    with pytest.raises(WorkerEvicted):
        gate.start(0, 1)                        # evictee unwinds at the gate
    with pytest.raises(WorkerEvicted):
        gate.heartbeat(0)                       # ... or at its next heartbeat


# ---------------------------------------------------------------------------
# server: eviction fence, snapshot round trip
# ---------------------------------------------------------------------------
def _tiny_server(**kw):
    params = [torch.zeros(3)]
    return params, ParamServer(params, momentum(0.9).init(params),
                               ISGDConfig(n_batches=4), **kw)


def test_server_fences_evicted_worker():
    params, srv = _tiny_server()
    snap = srv.pull()
    srv.push(snap, [torch.ones(3)], snap.base, worker=0, metrics={})
    srv.mark_evicted(1)
    stale = srv.pull()
    with pytest.raises(WorkerEvicted):
        srv.push(stale, [torch.full((3,), 9.0)], stale.base, worker=1,
                 metrics={})
    assert torch.equal(srv.params[0], torch.ones(3))
    assert srv.pushed_clocks() == {0: 1}        # the fenced push never landed


def test_server_snapshot_roundtrip():
    params, srv = _tiny_server()
    for i in range(3):
        snap = srv.pull()
        srv.observe(torch.tensor(float(i)))
        srv.push(snap, [torch.full((3,), float(i))], snap.base,
                 worker=i % 2, metrics={"accelerated": True, "sub_iters": 2})
    snap = srv.engine_snapshot()
    assert snap["version"] == 3 and snap["pushed"] == {0: 2, 1: 1}
    _, srv2 = _tiny_server()
    srv2.load_snapshot(snap)
    assert srv2.version == 3 and srv2.pushed_clocks() == {0: 2, 1: 1}
    assert torch.equal(srv2.params[0], srv.params[0])
    assert srv2.params[0] is not srv.params[0]  # loaded as a copy
    s1, s2 = srv.isgd_state(), srv2.isgd_state()
    assert s2.accel_count == s1.accel_count == 3
    assert s2.sub_iters == s1.sub_iters == 6
    assert torch.equal(s1.queue.buf, s2.queue.buf)


# ---------------------------------------------------------------------------
# coordinator end to end: crash/hang recovery, retry, tracebacks
# ---------------------------------------------------------------------------
def _coord_problem(n_batches=4, batch=16):
    """The reference's coordinator problem (dim 5 least squares); ->
    ``(make, sampler, icfg)``, ``make()`` -> fresh ``(params, loss_fn)``."""
    rng = np.random.RandomState(0)
    dim = 5
    xs = rng.randn(batch * n_batches, dim).astype(np.float32)
    ys = ((xs @ rng.randn(dim, 1).astype(np.float32)).ravel()
          / np.sqrt(dim)).astype(np.float32)
    sampler = FCPRSampler({"x": xs, "y": ys}, batch_size=batch, seed=1)

    def make():
        params = [torch.zeros(dim, requires_grad=True),
                  torch.zeros((), requires_grad=True)]

        def loss_fn(b):
            pred = b["x"] @ params[0] + params[1]
            loss = torch.mean((pred - b["y"]) ** 2)
            return loss, loss
        return params, loss_fn

    icfg = ISGDConfig(n_batches=sampler.n_batches, k_sigma=1.5, stop=3)
    return make, sampler, icfg


def _coord(make, icfg, **kw):
    kw.setdefault("deadline_s", 2.0)
    return AsyncPSCoordinator(lambda w: make(), momentum(0.9), icfg,
                              lr_fn=lambda pb: 0.01, **kw)


def _run(coord, make, sampler, steps):
    return in_thread(lambda: coord.run(make()[0], sampler, steps))


def test_elastic_crash_self_evicts_and_run_completes():
    make, sampler, icfg = _coord_problem()
    coord = _coord(make, icfg, workers=2, max_staleness=1, elastic=True,
                   faults=FaultPlan.from_spec("crash@1:2"))
    params, state, records = _run(coord, make, sampler, 16)
    assert [e["event"] for e in coord.events] == ["evict", "crash"]
    assert coord.events[0]["worker"] == 1
    assert coord.events[0]["survivors"] == [0]
    assert "InjectedCrash" in coord.events[1]["error"]
    assert "before_step" in coord.events[1]["traceback"]
    # worker 1 landed 2 of its 8 pushes; worker 0 all 8
    assert len(records) == 10 and state.iter == 10


def test_elastic_hang_past_deadline_evicted_and_restriped():
    make, sampler, icfg = _coord_problem()
    coord = _coord(make, icfg, workers=2, max_staleness=0, elastic=True,
                   deadline_s=0.25,
                   faults=FaultPlan.from_spec("hang@0:2:seconds=1.0"))
    t0 = time.perf_counter()
    params, state, records = _run(coord, make, sampler, 16)
    dt = time.perf_counter() - t0
    evicts = [e for e in coord.events if e["event"] == "evict"]
    assert len(evicts) == 1 and evicts[0]["worker"] == 0
    assert "deadline" in evicts[0]["reason"]
    assert dt < 5.0                             # survivor did not wait 120 s
    assert len(records) == 10                   # 2 from w0 + 8 from w1
    # re-striped to stride 1: after the eviction worker 1 serves both
    # parities of the global index, consecutively
    after = [r["batch"] for r in records
             if r["version"] > evicts[0]["at_version"]]
    assert after == list(range(after[0], after[0] + len(after)))
    assert {b % 2 for b in after} == {0, 1}


def test_non_elastic_stall_surfaces_worker_stalled():
    make, sampler, icfg = _coord_problem()
    coord = _coord(make, icfg, workers=2, max_staleness=0, elastic=False,
                   deadline_s=0.25,
                   faults=FaultPlan.from_spec("hang@0:2:seconds=1.2"))
    with pytest.raises(WorkerFailure) as ei:
        _run(coord, make, sampler, 16)
    assert isinstance(ei.value.original, WorkerStalled)
    assert "worker 0 stalled" in str(ei.value)


def test_last_survivor_crash_fails_run_with_traceback():
    make, sampler, icfg = _coord_problem()
    coord = _coord(make, icfg, workers=1, elastic=True,
                   faults=FaultPlan.from_spec("crash@0:3"))
    with pytest.raises(WorkerFailure) as ei:
        _run(coord, make, sampler, 8)
    assert ei.value.wid == 0
    assert isinstance(ei.value.original, InjectedCrash)
    assert isinstance(ei.value.__cause__, InjectedCrash)   # chained
    assert "worker thread traceback" in str(ei.value)
    assert "before_step" in str(ei.value)       # the dead thread's frames


def test_corrupt_and_transient_pushes_retry_bit_exact():
    """A corrupted delta is rejected by checksum and resent clean; a
    transient failure is retried — neither changes a single bit."""
    make, sampler, icfg = _coord_problem()
    clean = _coord(make, icfg, workers=1, verify_pushes=True)
    p_ref, s_ref, r_ref = _run(clean, make, sampler, 8)
    plan = FaultPlan.from_spec("corrupt@0:1;transient@0:3")
    faulty = _coord(make, icfg, workers=1, verify_pushes=True, faults=plan)
    p, s, r = _run(faulty, make, sampler, 8)
    assert len(r) == len(r_ref) == 8
    for a, b in zip(list(p_ref) + list(s_ref.base), list(p) + list(s.base)):
        assert torch.equal(a, b)
    assert [x["loss"] for x in r] == [x["loss"] for x in r_ref]


def test_retry_exhaustion_surfaces_as_failure():
    make, sampler, icfg = _coord_problem()
    # corrupt every attempt: 1 + push_retries transits all fire
    plan = FaultPlan([FaultEvent(kind="corrupt", worker=0, step=1)
                      for _ in range(4)])
    coord = _coord(make, icfg, workers=1, verify_pushes=True, faults=plan,
                   push_retries=2)
    with pytest.raises(WorkerFailure, match="failed after 3 attempts"):
        _run(coord, make, sampler, 4)


# ---------------------------------------------------------------------------
# kill/resume parity
# ---------------------------------------------------------------------------
def test_resume_parity_per_step_and_async():
    from repro_torch.train.resume_parity import run_resume_parity
    results = run_resume_parity(18, 6, legs=("per-step", "async-ps"),
                                device="cpu")
    assert all(r["ok"] and r["max_dev"] == 0.0 for r in results), results
    assert sum(r["accelerations"] for r in results) > 0
    assert results[1]["resumed_pushes"] == 12   # only the replayed tail
