"""The port's async parameter-server engine
(``repro_torch.distributed.async_ps``) against the JAX package's, on the
CPU.

Inputs are drawn with numpy from a seed and go through both packages:

  * the bit-exact anchor: one worker at staleness 0 is the port's per-step
    engine bit for bit, on the rigged least-squares problem of the parity
    harness and on ``paper-transformer`` tiny through the launcher with
    ``--kernels reference`` (tolerance 0: equality);
  * the port's one-worker run against the JAX coordinator's on the parity
    problem: decisions and ``sub_iters`` equal, params, ψ̄ and limits within
    ``atol 1e-5``, losses within ``rtol 1e-5`` (the tolerances of
    ``test_torch_distributed.py``'s parity tests);
  * ``ParamServer.observe`` against the JAX server's on one loss stream
    (same verdict, limit, ψ̄ and σ within 1e-6) and the τ > 0 fold against
    the JAX ``_fold_fn`` for each ``w(τ)`` family (within 1e-6);
  * the SSP gate's predicate, blocking and abort; lockstep rounds at
    staleness 0; ``ShardedFeed``'s strides and ``restripe`` equal to the
    reference's batches; ``records_to_trainlog``'s walls; the two-worker
    lockstep and convergence smoke; the snapshot invariant (no thread
    writes a pulled snapshot before its push lands).

``test_async_multiworker_convergence_lenet8x8`` of the reference is not
mirrored: it fails in the reference. Every threaded test joins its
threads with a timeout and uses deadlines of a second or two.
"""
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ISGDConfig as JConfig
from repro.core.reduce import StalenessReduce as JStaleness
from repro.data import FCPRSampler as JSampler
from repro.distributed.async_ps import AsyncPSCoordinator as JCoordinator
from repro.distributed.async_ps import ParamServer as JServer
from repro.distributed.async_ps import ShardedFeed as JFeed
from repro.distributed.async_ps import parity as JPARITY
from repro.distributed.async_ps.server import _fold_fn as j_fold
from repro.optim import momentum as j_momentum
from repro_torch.core import ISGDConfig
from repro_torch.core.reduce import StalenessReduce
from repro_torch.data import FCPRSampler
from repro_torch.distributed.async_ps import (AsyncPSCoordinator, ParamServer,
                                              ShardedFeed, StalenessGate,
                                              records_to_trainlog,
                                              run_async_parity)
from repro_torch.distributed.async_ps import parity as TPARITY
from repro_torch.distributed.async_ps.server import fold_tree
from repro_torch.optim import momentum
from repro_torch.train.checkpoints import tree_checksum

torch.set_num_threads(2)
JOIN_S = 60                      # every thread joins within this, or fails


def in_thread(fn, timeout=JOIN_S):
    """``fn()`` in a thread joined with a timeout -> its result (its
    exception re-raised here); a hang fails instead of blocking."""
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


# ---------------------------------------------------------------------------
# the bit-exact anchor
# ---------------------------------------------------------------------------
def test_async_1worker_staleness0_bit_exact_with_per_step():
    """32 steps over 4 batches (8 FCPR epochs), the ψ̄-driven LR, the
    subproblem firing, and zero deviation anywhere."""
    r = run_async_parity(steps=32, workers=1, max_staleness=0,
                         device="cpu")
    assert r["mode"] == "bitexact" and r["ok"], r
    assert r["accelerations"] > 0
    assert r["metric_mismatches"] == 0 and r["max_param_dev"] == 0.0
    assert r["max_tau"] == 0 and r["counters_ok"]


TINY = ["--device", "cpu", "--model", "transformer", "--tier", "tiny",
        "--batch", "4", "--seq", "32", "--n-seqs", "16", "--precision",
        "f32", "--k-sigma", "-3", "--kernels", "reference", "--steps", "8"]
LOG_KEYS = ("losses", "psi_bar", "psi_std", "limits", "accelerated",
            "sub_iters")


def test_async_1worker_bit_exact_on_tiny_transformer_through_launcher():
    """``--engine async-ps --workers 1`` against the per-step engine on
    ``paper-transformer`` tiny (``--kernels reference``): every logged value
    and the final params and velocity equal."""
    from repro_torch.launch import train as launcher
    ref = launcher.main(TINY)
    got = launcher.main(TINY + ["--engine", "async-ps", "--workers", "1"])
    for key in LOG_KEYS:
        assert getattr(got["log"], key) == getattr(ref["log"], key), key
    assert any(got["log"].accelerated), "the branch never fired"
    for a, b in zip(ref["model"].params(), got["model"].params()):
        assert torch.equal(a, b)
    for a, b in zip(ref["state"].base, got["state"].base):
        assert torch.equal(a, b)
    assert (got["state"].accel_count, got["state"].sub_iters) == (
        ref["state"].accel_count, ref["state"].sub_iters)


def test_async_1worker_against_jax_on_the_parity_problem():
    """The port's coordinator against the JAX one, one worker at staleness
    0, 32 pushes of the parity problem (same data, same FCPR cycle)."""
    steps = 32
    loss_fn, params0, sampler, icfg = JPARITY._problem(8, 4)
    coord = JCoordinator(loss_fn, j_momentum(0.9), icfg, workers=1,
                         max_staleness=0, lr_fn=JPARITY._lr_fn)
    j_params, _, j_recs = coord.run(params0, sampler, steps)
    make, t_sampler, t_icfg = TPARITY._problem(8, 4, device="cpu")
    t_coord = AsyncPSCoordinator(lambda w: make(), momentum(0.9), t_icfg,
                                 workers=1, max_staleness=0,
                                 lr_fn=TPARITY._lr_fn)
    (w, b), _, recs = t_coord.run(make()[0], t_sampler, steps)
    assert len(recs) == len(j_recs) == steps
    for key in ("accelerated", "sub_iters", "tau"):
        assert [r[key] for r in recs] == [r[key] for r in j_recs], key
    assert sum(r["accelerated"] for r in recs) > 0
    for key in ("psi_bar", "limit"):
        np.testing.assert_allclose([r[key] for r in recs],
                                   [r[key] for r in j_recs], atol=1e-5,
                                   rtol=0)
    np.testing.assert_allclose([r["loss"] for r in recs],
                               [r["loss"] for r in j_recs], rtol=1e-5)
    np.testing.assert_allclose(w.numpy(), np.asarray(j_params["w"]),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(b), float(j_params["b"]), atol=1e-5,
                               rtol=0)


# ---------------------------------------------------------------------------
# the server against the JAX server: observe and the fold
# ---------------------------------------------------------------------------
def test_server_observe_against_jax():
    """One loss stream through both servers (two epochs of warm-up and
    chart, an outlier that trips the limit): the same verdict each time,
    limit, ψ̄ and σ within 1e-6."""
    rng = np.random.RandomState(3)
    losses = (2.0 + 0.2 * rng.randn(11)).astype(np.float32)
    losses[9] = 9.0                                # the outlier
    jsrv = JServer({"w": jnp.zeros(2)}, (), JConfig(n_batches=4,
                                                    k_sigma=1.5))
    tsrv = ParamServer([torch.zeros(2)], (), ISGDConfig(n_batches=4,
                                                        k_sigma=1.5))
    verdicts = []
    for loss in losses:
        j = jsrv.observe(jnp.asarray(loss))
        t = tsrv.observe(torch.tensor(loss))
        assert t.accelerated == j.accelerated
        verdicts.append(t.accelerated)
        for a, b in ((t.limit, j.limit), (t.psi_bar, j.psi_bar),
                     (t.psi_std, j.psi_std)):
            np.testing.assert_allclose(float(a), float(b), atol=1e-6,
                                       rtol=1e-6)
    assert verdicts[:3] == [False] * 3 and verdicts[9]


@pytest.mark.parametrize("spec", [("inverse", 1.0), ("exp", 0.5),
                                  ("none", 1.0)],
                         ids=["inverse", "exp", "none"])
def test_fold_against_jax_fold_fn(spec):
    """``old + w(τ)·(final − snap)`` for τ = 1..3: the weights equal the
    JAX weights, the folded leaves JAX's ``_fold_fn``'s within 1e-6; a
    stale push to the port's server folds the same way."""
    decay, alpha = spec
    rng = np.random.RandomState(5)
    old, final, snap = (rng.randn(3, 4).astype(np.float32) for _ in range(3))
    tctx = StalenessReduce(decay=decay, alpha=alpha)
    jctx = JStaleness(decay=decay, alpha=alpha)
    for tau in (1, 2, 3):
        w = float(tctx.weight(tau))
        np.testing.assert_allclose(w, float(jctx.weight(tau)), rtol=1e-7)
        want = np.asarray(j_fold({"a": jnp.asarray(old)},
                                 {"a": jnp.asarray(final)},
                                 {"a": jnp.asarray(snap)},
                                 jctx.weight(tau))["a"])
        got = fold_tree([torch.from_numpy(old)], [torch.from_numpy(final)],
                        [torch.from_numpy(snap)], w)[0]
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    # through the server: one push lands between B's pull and its push
    srv = ParamServer([torch.from_numpy(snap)], (), ISGDConfig(n_batches=4),
                      reduce_ctx=tctx)
    s_a, s_b = srv.pull(), srv.pull()
    assert srv.push(s_a, [torch.from_numpy(old)], (), worker=0,
                    metrics={}) == 0
    assert torch.equal(srv.params[0], torch.from_numpy(old))
    assert srv.push(s_b, [torch.from_numpy(final)], (), worker=1,
                    metrics={}) == 1
    want = np.asarray(j_fold({"a": jnp.asarray(old)},
                             {"a": jnp.asarray(final)},
                             {"a": jnp.asarray(snap)}, jctx.weight(1))["a"])
    np.testing.assert_allclose(srv.params[0].numpy(), want, atol=1e-6,
                               rtol=1e-6)
    assert srv.isgd_state().iter == 2


def test_server_copies_at_its_boundary():
    """The server never shares a tensor with a caller that may write it:
    the construction and a τ = 0 push copy, and the snapshot it handed out
    keeps its values after the next push."""
    p = [torch.zeros(3)]
    srv = ParamServer(p, [torch.zeros(3)], ISGDConfig(n_batches=4))
    p[0] += 1.0
    assert torch.equal(srv.params[0], torch.zeros(3))
    snap = srv.pull()
    mine = [torch.full((3,), 2.0)]
    srv.push(snap, mine, [torch.zeros(3)], worker=0, metrics={})
    mine[0] += 5.0
    assert torch.equal(srv.params[0], torch.full((3,), 2.0))
    assert torch.equal(snap.params[0], torch.zeros(3))


# ---------------------------------------------------------------------------
# the bounded-staleness gate
# ---------------------------------------------------------------------------
def test_gate_permits_predicate():
    g0 = StalenessGate(2, max_staleness=0)
    assert g0.permits(0, 0) and not g0.permits(1, 0) and g0.permits(1, 1)
    g3 = StalenessGate(2, max_staleness=3)
    assert g3.permits(3, 0) and not g3.permits(4, 0) and g3.permits(4, 1)


def test_gate_blocks_leader_until_straggler_finishes():
    gate = StalenessGate(2, max_staleness=0, deadline_s=2.0)
    order = []

    def leader():
        gate.start(0, 0)
        gate.finish(0)
        gate.start(0, 1)           # must block until worker 1 finishes step 0
        order.append("leader@1")
        gate.finish(0)

    t = threading.Thread(target=leader, daemon=True)
    t.start()
    time.sleep(0.1)
    assert order == []             # still parked at the gate
    gate.start(1, 0)
    order.append("straggler@0")
    gate.finish(1)
    t.join(timeout=JOIN_S)
    assert not t.is_alive()
    assert order == ["straggler@0", "leader@1"]


def test_gate_abort_unblocks_waiters():
    gate = StalenessGate(2, max_staleness=0, deadline_s=2.0)
    err = []

    def blocked():
        try:
            gate.start(0, 1)       # can never proceed: peer is at step 0
        except RuntimeError as e:
            err.append(e)

    t = threading.Thread(target=blocked, daemon=True)
    t.start()
    time.sleep(0.05)
    gate.abort(ValueError("peer died"))
    t.join(timeout=JOIN_S)
    assert not t.is_alive() and len(err) == 1
    assert isinstance(err[0].__cause__, ValueError)


def _ls_problem(n=24, dim=4, batch=4):
    """The reference's lockstep problem: sum regression, 6 batches of 4."""
    rng = np.random.RandomState(0)
    xs = rng.randn(n, dim).astype(np.float32)
    ys = xs.sum(axis=1).astype(np.float32)
    sampler = FCPRSampler({"x": xs, "y": ys}, batch_size=batch, seed=1)

    def make():
        w = torch.zeros(dim, requires_grad=True)

        def loss_fn(b):
            loss = torch.mean((b["x"] @ w - b["y"]) ** 2)
            return loss, loss
        return [w], loss_fn
    return make, sampler


def test_lockstep_rounds_at_staleness_zero():
    """With max_staleness=0, every worker pushes round r before any worker
    pushes round r+1 — the synchronous data-parallel schedule."""
    make, sampler = _ls_problem()
    icfg = ISGDConfig(n_batches=sampler.n_batches, k_sigma=1.0, stop=2,
                      zeta=0.01)
    coord = AsyncPSCoordinator(lambda w: make(), momentum(0.9), icfg,
                               workers=3, max_staleness=0,
                               lr_fn=lambda _: 0.01, deadline_s=2.0)
    _, _, records = in_thread(
        lambda: coord.run(make()[0], sampler, 24))
    counts = [0, 0, 0]
    for r in records:
        counts[r["worker"]] += 1
        # at any prefix no worker is a whole round ahead of another
        assert max(counts) - min(counts) <= 1, counts
        assert r["tau"] <= 2       # within-round racing only (≤ N−1)
    assert counts == [8, 8, 8]
    # each worker fed its stripe of the global cycle: k·3 + w
    for w in range(3):
        assert [r["batch"] for r in records if r["worker"] == w] == [
            k * 3 + w for k in range(8)]


# ---------------------------------------------------------------------------
# per-worker FCPR shards
# ---------------------------------------------------------------------------
def _feed_data():
    rng = np.random.RandomState(0)
    return {"x": rng.randn(48, 3).astype(np.float32)}   # 12 batches of 4


@pytest.mark.parametrize("n", [3, 5], ids=["divides", "rotates"])
def test_sharded_feed_strides_equal_reference(n):
    data = _feed_data()
    t_s, j_s = FCPRSampler(data, 4, seed=1), JSampler(data, 4, seed=1)
    feeds = [ShardedFeed(t_s, w, n, "cpu") for w in range(n)]
    jfeeds = [JFeed(j_s, w, n) for w in range(n)]
    assert [f.n_batches for f in feeds] == [f.n_batches for f in jfeeds]
    for k in range(8):                                    # wraps the shard
        for f, jf in zip(feeds, jfeeds):
            g, batch = f.take(k)
            assert g == k * n + f.wid
            np.testing.assert_array_equal(batch["x"].numpy(),
                                          np.asarray(jf(k)["x"]))


def test_sharded_feed_restripe_equal_reference():
    data = _feed_data()
    f = ShardedFeed(FCPRSampler(data, 4, seed=1), 3, 4, "cpu")
    jf = JFeed(JSampler(data, 4, seed=1), 3, 4)
    np.testing.assert_array_equal(f(2)["x"].numpy(), np.asarray(jf(2)["x"]))
    f.restripe(1, 3)
    jf.restripe(1, 3)                                     # worker 3 → 1 of 3
    assert (f.wid, f.n_workers) == (jf.wid, jf.n_workers) == (1, 3)
    assert f.take(2)[0] == 7
    np.testing.assert_array_equal(f(2)["x"].numpy(), np.asarray(jf(2)["x"]))


def test_records_to_trainlog_wall_semantics():
    rec = {"loss": 1.0, "limit": float("inf"), "psi_bar": 1.0, "psi_std": 0.0,
           "accelerated": False, "sub_iters": 0, "wall": 0.25}
    one = records_to_trainlog([dict(rec, worker=0), dict(rec, worker=0)])
    assert one.wall == [0.25, 0.25]
    assert one.wall_est == [False, False]   # sequential pushes: true walls
    two = records_to_trainlog([dict(rec, worker=0), dict(rec, worker=1)])
    assert two.wall_est == [True, True]     # overlapping workers


# ---------------------------------------------------------------------------
# two workers
# ---------------------------------------------------------------------------
def test_async_multiworker_lockstep_and_convergence_smoke():
    """max_staleness=0 with racing workers: lockstep rounds, τ ≤ N−1, and
    the final-epoch ψ̄ within 0.3 of the per-step run on the rigged
    problem."""
    r = in_thread(lambda: run_async_parity(steps=64, workers=2,
                                           max_staleness=0, tol=0.3,
                                           device="cpu"))
    assert r["mode"] == "convergence" and r["ok"], r
    assert r["max_tau"] <= 1


def test_pulled_snapshots_are_never_written_two_workers():
    """Two workers at staleness 1 on the parity problem: each pulled
    snapshot's content checksum (params and base) at its pull equals the
    one after its push landed, and every τ is within (2·1+1)·(2−1)."""
    make, sampler, icfg = TPARITY._problem(8, 8, device="cpu")
    sums, lock = {}, threading.Lock()

    def hook(event, wid, k, snap):
        with lock:
            sums.setdefault((wid, k), {})[event] = tree_checksum(
                (snap.params, snap.base))

    coord = AsyncPSCoordinator(lambda w: make(), momentum(0.9), icfg,
                               workers=2, max_staleness=1,
                               lr_fn=TPARITY._lr_fn, deadline_s=2.0,
                               snapshot_hook=hook)
    _, _, records = in_thread(lambda: coord.run(make()[0], sampler, 32))
    assert len(sums) == len(records) == 32
    assert all(v["pull"] == v["push"] for v in sums.values())
    assert max(r["tau"] for r in records) <= 3
    assert any(r["tau"] > 0 for r in records), "no push raced another"
