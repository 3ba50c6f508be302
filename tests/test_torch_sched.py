"""Port vs JAX: on-device batch schedules (``repro_torch.sched``), on the
CPU.

Mirrors the single-device half of ``tests/test_sched.py``:

  * the policies' ``_scores`` agree with ``repro.sched.policies`` on the
    same tables within 1e-6 (f32), and ``update`` is bit-exact on the same
    ``(batch_idx, loss)`` sequences; ``schedule_from_spec`` parses and
    refuses what the reference does;
  * ``isgd_step`` and ``isgd_step_device`` with an explicit ``slot``
    sequence follow the JAX ``isgd_step(..., slot=)``: the same queue
    contents and limits (1e-5 relative, the trajectory tolerance of
    ``tests/test_torch_isgd.py``) and the same decisions;
  * **fcpr bit-exactness** — ``FCPRSchedule`` through the scheduled
    per-step engine and the fused engine (K ∈ {1, 4, 32}) equals the
    unscheduled port engines exactly, under a ψ̄-dependent ``lr_fn``;
  * the loss-prop properties the reference tests: the warm-up sweep, no
    starvation at ε/n_b, Rank preferring high-loss batches, the SPC queue
    holding one loss per batch, one chunk call per K steps; and, since the
    port's draws cannot match ``jax.random.categorical``, the same draws on
    a rerun and per-step against fused (a pure function of seed, step and
    table);
  * the data-parallel legs of ``repro.sched.parity`` over two spawned gloo
    ranks (``repro_torch.sched.parity --procs 2``).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except Exception:                                  # pragma: no cover
    from _hypothesis_fallback import given, settings, st   # noqa: F401

from repro.core import ISGDConfig as J_ISGDConfig
from repro.optim import momentum as j_momentum
from repro.sched import policies as JP
from repro.train.trainer import make_step_core as j_make_step_core
from repro_torch.core import ISGDConfig, control
from repro_torch.data import DeviceRing, FCPRSampler
from repro_torch.optim import momentum
from repro_torch.sched import parity
from repro_torch.sched import policies as TP
from repro_torch.sched.engine import selection_counts
from repro_torch.train import (TrainLog, make_chunked_train_step,
                               make_device_step, make_scheduled_train_step,
                               make_step_core, make_train_step)

torch.set_num_threads(2)
STEPS = 32                      # n_batches = 4 -> 8 FCPR epochs


def _problem(batch_size=8, n_batches=4, dim=6, seed=0):
    rng = np.random.RandomState(seed)
    xs = rng.randn(batch_size * n_batches, dim).astype(np.float32)
    ys = ((xs @ rng.randn(dim, 1).astype(np.float32)).ravel()
          / np.sqrt(dim)).astype(np.float32)
    ys[:batch_size] += 3.0      # outlier batch: the subproblem must fire
    sampler = FCPRSampler({"x": xs, "y": ys}, batch_size=batch_size, seed=1)
    icfg = ISGDConfig(n_batches=sampler.n_batches, k_sigma=1.0, stop=3,
                      zeta=0.01)

    def make():
        params = [torch.zeros(dim, requires_grad=True),
                  torch.zeros((), requires_grad=True)]

        def loss_fn(batch):
            pred = batch["x"] @ params[0] + params[1]
            loss = torch.mean((pred - batch["y"]) ** 2)
            return loss, loss
        return params, loss_fn
    return make, sampler, icfg


def _lr_fn(psi_bar):
    # ψ̄-dependent on purpose: schedule drift moves the LR trajectory
    return 0.01 + 0.001 * torch.clamp(psi_bar, max=1.0)


def _ring(sampler):
    return DeviceRing(sampler.epoch_arrays(), sampler.batch_size,
                      device="cpu")


def _run_sched(fn, init_fn, schedule, params, ring, steps=STEPS, K=None):
    state = init_fn(params)
    ss = schedule.init(ring.n_batches, device="cpu")
    log, picks = TrainLog(), []
    if K is None:
        for j in range(steps):
            state, params, ss, m = fn(state, params, ss, ring.arrays, j)
            log.append(m, 0.0)
            picks.append(int(m["batch_idx"]))
    else:
        for c in range(steps // K):
            state, params, ss, ms = fn(state, params, ss, ring.arrays, c * K)
            log.extend(ms, 0.0)
            picks += ms["batch_idx"].tolist()
    return state, params, ss, log, picks


def _assert_bit_exact(ref, got, ref_p, got_p):
    for key in ("losses", "limits", "psi_bar", "accelerated", "sub_iters"):
        assert getattr(ref, key) == getattr(got, key), key
    for a, b in zip(ref_p, got_p):
        assert torch.equal(a.detach(), b.detach())
    assert sum(ref.accelerated) > 0, "subproblem never fired"


# ---------------------------------------------------------------------------
# the policies against the reference's
# ---------------------------------------------------------------------------
POLICIES = [("LossPropSchedule", {}), ("LossPropSchedule", {"eps": 0.3}),
            ("RankSchedule", {}), ("RankSchedule", {"pressure": 7.0,
                                                    "eps": 0.05})]


def _tables(n_b, seed):
    rng = np.random.RandomState(seed)
    ties = rng.randint(0, 3, n_b).astype(np.float32)     # rank ties: stable
    return [rng.rand(n_b).astype(np.float32) * 5.0, ties,
            np.zeros(n_b, np.float32), rng.randn(n_b).astype(np.float32)]


@pytest.mark.parametrize("name,kw", POLICIES)
@pytest.mark.parametrize("n_b", [1, 4, 13])
def test_scores_match_jax(name, kw, n_b):
    j, t = getattr(JP, name)(**kw), getattr(TP, name)(**kw)
    for table in _tables(n_b, seed=n_b):
        want = np.asarray(j._scores(jnp.asarray(table)))
        got = t._scores(torch.from_numpy(table)).numpy()
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name,kw", POLICIES[:2] + [("RankSchedule",
                                                     {"beta": 0.3})])
def test_update_bit_exact_with_jax(name, kw):
    n_b = 5
    j, t = getattr(JP, name)(**kw), getattr(TP, name)(**kw)
    js, ts = j.init(n_b), t.init(n_b, device="cpu")
    rng = np.random.RandomState(3)
    for idx, loss in zip(rng.randint(0, n_b, 40),
                         rng.rand(40).astype(np.float32) * 4):
        js = j.update(js, jnp.asarray(idx, jnp.int32), jnp.asarray(loss))
        ts = t.update(ts, torch.tensor(int(idx)), torch.tensor(loss))
        for k in ("table", "visits"):
            np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))


def test_fcpr_select_and_update_match_jax():
    j, t = JP.FCPRSchedule(), TP.FCPRSchedule()
    js, ts = j.init(4), t.init(4, device="cpu")
    for step in range(11):
        want, _ = j.select(js, step, None)
        got, ts2 = t.select(ts, step, None)
        assert int(got) == int(want) and ts2 is ts
    assert t.update(ts, got, 1.0) is ts
    assert (TP.FCPRSchedule.uses_table, TP.LossPropSchedule.uses_table,
            TP.RankSchedule.uses_table) == (False, True, True)


def test_schedule_from_spec():
    f = TP.schedule_from_spec
    assert f("fcpr") == TP.FCPRSchedule()
    lp = f("loss-prop:eps=0.25,beta=0.75")
    assert (lp.eps, lp.beta) == (0.25, 0.75)
    assert (TP.LossPropSchedule().beta, TP.LossPropSchedule().eps) == (0.5, 0.1)
    rk = f("rank:pressure=42")
    assert isinstance(rk, TP.RankSchedule) and rk.pressure == 42.0
    assert (TP.RankSchedule().pressure, TP.RankSchedule().eps) == (100.0, 0.0)
    for spec in ("fcpr", "loss-prop:eps=0.25,beta=0.75", "rank:pressure=42"):
        assert f(spec) == getattr(TP, type(JP.schedule_from_spec(spec))
                                  .__name__)(**vars(JP.schedule_from_spec(spec)))
    for bad, exc, match in (("lifo", ValueError, "unknown schedule"),
                            ("rank:pressure", ValueError, "malformed"),
                            ("fcpr:eps=0.1", TypeError, None)):
        with pytest.raises(exc, match=match):
            JP.schedule_from_spec(bad)
        with pytest.raises(exc, match=match):
            f(bad)


# ---------------------------------------------------------------------------
# the draw: a pure function of (seed, step, table)
# ---------------------------------------------------------------------------
def test_fold_in_is_pure_and_spreads():
    keys = [int(TP.fold_in(0, j, device="cpu")) for j in range(2000)]
    again = [int(TP.fold_in(0, torch.tensor(j), device="cpu"))
             for j in range(2000)]
    assert keys == again
    assert len(set(keys)) == 2000 and all(0 <= k < 2 ** 32 for k in keys)
    assert keys != [int(TP.fold_in(1, j, device="cpu")) for j in range(2000)]
    u = np.array([float(TP.uniform(torch.tensor(k))) for k in keys])
    assert (u >= 0).all() and (u < 1).all()
    # roughly uniform: each tenth holds 10 % ± 3 %
    hist = np.bincount((u * 10).astype(int), minlength=10) / len(u)
    assert np.abs(hist - 0.1).max() < 0.03, hist


def test_categorical_follows_p_and_skips_zeros():
    p = torch.tensor([0.0, 0.5, 0.0, 0.25, 0.25])
    draws = [int(TP.categorical(TP.fold_in(3, j, device="cpu"), p))
             for j in range(4000)]
    counts = np.bincount(draws, minlength=5) / 4000
    assert counts[0] == counts[2] == 0.0
    np.testing.assert_allclose(counts, p.numpy(), atol=0.03)


# ---------------------------------------------------------------------------
# explicit slots: the per-batch queue write against JAX
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("engine", ["per-step", "device"])
def test_explicit_slots_match_jax(engine):
    make, sampler, icfg = _problem()
    rng = np.random.RandomState(5)
    slots = list(range(4)) + list(rng.randint(0, 4, 20))
    jcfg = J_ISGDConfig(n_batches=4, k_sigma=1.0, stop=3, zeta=0.01)

    def jloss(p, b):
        loss = jnp.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2)
        return loss, loss
    jinit, jstep = j_make_step_core(
        jloss, j_momentum(0.9), jcfg,
        lr_fn=lambda pb: 0.01 + 0.001 * jnp.minimum(pb, 1.0))
    jp = {"w": jnp.zeros(6), "b": jnp.zeros(())}
    jstate = jinit(jp)
    jstep = jax.jit(jstep)
    params, loss_fn = make()
    if engine == "per-step":
        init, step = make_step_core(loss_fn, momentum(0.9), icfg,
                                    lr_fn=_lr_fn)
    else:
        init, step = make_device_step(loss_fn, momentum(0.9), icfg,
                                      lr_fn=_lr_fn)
    state = init(params)
    fired = 0
    for j, slot in enumerate(slots):
        batch = sampler(slot)            # batch t, written at slot t
        jstate, jp, jm = jstep(jstate, jp, {k: jnp.asarray(v)
                                            for k, v in batch.items()},
                               slot=jnp.asarray(slot, jnp.int32))
        state, params, m = step(state, params,
                                {k: torch.from_numpy(v)
                                 for k, v in batch.items()},
                                slot=torch.tensor(slot))
        assert bool(m["accelerated"]) == bool(jm["accelerated"]), j
        assert int(m["sub_iters"]) == int(jm["sub_iters"]), j
        np.testing.assert_allclose(state.queue.buf.numpy(),
                                   np.asarray(jstate.queue.buf), rtol=1e-5)
        assert int(state.queue.count) == int(jstate.queue.count)
        assert int(state.queue.idx) == int(jstate.queue.idx)
        np.testing.assert_allclose(float(m["limit"]), float(jm["limit"]),
                                   rtol=1e-5)
        fired += bool(m["accelerated"])
    assert fired > 0


# ---------------------------------------------------------------------------
# fcpr policy: bit-exact with the unscheduled engines
# ---------------------------------------------------------------------------
def _unscheduled_per_step(make, sampler, icfg, steps=STEPS):
    params, loss_fn = make()
    init_fn, step = make_train_step(loss_fn, momentum(0.9), icfg,
                                    lr_fn=_lr_fn)
    state = init_fn(params)
    log = TrainLog()
    for j in range(steps):
        batch = {k: torch.from_numpy(v) for k, v in sampler(j).items()}
        state, params, m = step(state, params, batch)
        log.append(m, 0.0)
    return params, log


@pytest.mark.parametrize("K", [None, 1, 4, 32])
def test_sched_fcpr_bit_exact_vs_unscheduled(K):
    make, sampler, icfg = _problem()
    ref_p, ref = _unscheduled_per_step(make, sampler, icfg)
    fcpr = TP.FCPRSchedule()
    params, loss_fn = make()
    if K is None:
        init, fn = make_scheduled_train_step(loss_fn, momentum(0.9), icfg,
                                             fcpr, lr_fn=_lr_fn)
    else:
        init, fn = make_chunked_train_step(loss_fn, momentum(0.9), icfg,
                                           chunk_steps=K, lr_fn=_lr_fn,
                                           schedule=fcpr)
    _, p, _, got, picks = _run_sched(fn, init, fcpr, params, _ring(sampler),
                                     K=K)
    _assert_bit_exact(ref, got, ref_p, p)
    assert picks == [j % 4 for j in range(STEPS)]


def test_unscheduled_chunked_matches_fcpr_scheduled_chunked():
    make, sampler, icfg = _problem()
    ring = _ring(sampler)
    params, loss_fn = make()
    init, chunk = make_chunked_train_step(loss_fn, momentum(0.9), icfg,
                                          chunk_steps=8, lr_fn=_lr_fn)
    state, ref = init(params), TrainLog()
    for c in range(STEPS // 8):
        state, params, ms = chunk(state, params, ring.arrays, c * 8)
        ref.extend(ms, 0.0)
    p2, loss_fn = make()
    fcpr = TP.FCPRSchedule()
    init, chunk = make_chunked_train_step(loss_fn, momentum(0.9), icfg,
                                          chunk_steps=8, lr_fn=_lr_fn,
                                          schedule=fcpr)
    _, p2, _, got, _ = _run_sched(chunk, init, fcpr, p2, ring, K=8)
    _assert_bit_exact(ref, got, params, p2)


def test_sched_parity_inprocess():
    r = parity.run_sched_parity(steps=STEPS, device="cpu")
    assert r["ok"], r
    assert r["accelerations"] > 0


def test_sched_parity_cli(capsys):
    assert parity.main(["--device", "cpu"]) == 0
    assert "-> OK" in capsys.readouterr().out


def test_sched_parity_dp_legs_over_two_ranks(capsys):
    """The data-parallel legs over two spawned gloo ranks: the scheduled
    data-parallel engine (per-step and fused K = 4) bit for bit with the
    data-parallel engine on host rows, the ranks' loss-prop draws equal,
    the two-rank fused run selecting the one-device run's batches."""
    assert parity.main(["--device", "cpu", "--procs", "2"]) == 0
    out = capsys.readouterr().out
    assert "sched-parity devices=2 " in out and "legs=10 failed=none" in out
    r = parity.run_sched_parity(steps=STEPS, device="cpu")
    assert [n for n in r["legs"] if " dp " in n or "shard" in n
            or "1-vs-n" in n] == [
        "sched-fcpr dp per-step", "sched-fcpr dp chunked K4",
        "loss-prop shard-draw agreement",
        "loss-prop 1-vs-n-device selection"]


# ---------------------------------------------------------------------------
# loss-prop: no starvation (property), warm-up, residency, determinism
# ---------------------------------------------------------------------------
STARVE_EPS_MIN, STARVE_NB = 0.05, 8
STARVE_FALSE_FAIL = 1e-9          # chance that a correct schedule fails


def _starvation_bound(eps, n_b, false_fail):
    """The least T with (n_b − 1)·(1 − ε/n_b)^T ≤ ``false_fail``: the draws
    after which a cold batch's miss, P(miss) = (1 − ε/n_b)^T, is that
    unlikely for any of the n_b − 1 cold batches (a union bound)."""
    return math.ceil(math.log(false_fail / (n_b - 1))
                     / math.log(1.0 - eps / n_b))


def _cold_state(n_b, hot_loss):
    table = torch.full((n_b,), 1e-6)
    table[0] = hot_loss
    return {"table": table, "visits": torch.ones(n_b, dtype=torch.int32)}


def _visited(lp, state, seed, n_b, draws):
    return {int(lp.select(state, n_b + j,
                          TP.fold_in(seed, n_b + j, device="cpu"))[0])
            for j in range(draws)}


@settings(max_examples=10, deadline=None, database=None, derandomize=True)
@given(st.floats(min_value=STARVE_EPS_MIN, max_value=0.9),
       st.integers(min_value=0, max_value=10_000),
       st.floats(min_value=1.0, max_value=1e4))
def test_loss_prop_no_starvation(eps, seed, hot_loss):
    """For any ε>0: even with one batch dominating the table, every batch
    is selected within a bounded number of draws (P(miss) ≤ (1-ε/n_b)^T).
    T is taken at the worst ε so that a false failure has chance ≤ 1e-9;
    ``test_loss_prop_miss_rate_matches_mixing`` checks the miss rate at a
    T where misses are common."""
    n_b = STARVE_NB
    bound = _starvation_bound(STARVE_EPS_MIN, n_b, STARVE_FALSE_FAIL)
    lp = TP.LossPropSchedule(eps=eps)
    visited = _visited(lp, _cold_state(n_b, hot_loss), seed, n_b, bound)
    assert visited == set(range(n_b)), f"starved batches (eps={eps})"


def _binomial_band(n, p, tail):
    """[lo, hi] with P(X < lo) ≤ tail and P(X > hi) ≤ tail, X ~ B(n, p)."""
    pmf = [math.comb(n, k) * p ** k * (1.0 - p) ** (n - k)
           for k in range(n + 1)]
    cdf = np.cumsum(pmf)
    lo = int(np.searchsorted(cdf, tail, side="right"))
    hi = int(np.searchsorted(cdf, 1.0 - tail, side="left"))
    return lo, hi


def test_loss_prop_miss_rate_matches_mixing():
    """The ε-mixing itself: at ε = 0.05 and T = 600 draws, a cold batch
    (table entry at the minimum, score 0) is drawn with probability ε/n_b
    each draw, so it is missed in all T with probability (1 − ε/n_b)^T
    (≈ 0.0233). Over 100 fixed seeds × 7 cold batches the number of misses
    must lie in the binomial band whose tails hold 1e-6 each."""
    n_b, eps, draws, seeds = STARVE_NB, STARVE_EPS_MIN, 600, range(100)
    lp = TP.LossPropSchedule(eps=eps)
    state = _cold_state(n_b, 1.0)
    misses = sum(n_b - len(_visited(lp, state, seed, n_b, draws))
                 for seed in seeds)
    trials = len(seeds) * (n_b - 1)
    p_miss = (1.0 - eps / n_b) ** draws
    lo, hi = _binomial_band(trials, p_miss, 1e-6)
    assert lo <= misses <= hi, (misses, trials, p_miss, (lo, hi))


def test_rank_prefers_high_loss_batches():
    n_b = 8
    rk = TP.RankSchedule(pressure=100.0)
    state = {"table": torch.arange(n_b, dtype=torch.float32),   # 7 hottest
             "visits": torch.ones(n_b, dtype=torch.int32)}
    draws = [int(rk.select(state, n_b + j, TP.fold_in(0, j, device="cpu"))[0])
             for j in range(400)]
    counts = np.bincount(draws, minlength=n_b)
    assert counts[n_b - 1] > counts[0] * 3              # pressure visible
    assert (counts > 0).all()                           # exp decay: no zeros


@pytest.mark.parametrize("schedule", [TP.LossPropSchedule(eps=0.2),
                                      TP.RankSchedule()],
                         ids=["loss-prop", "rank"])
def test_table_policy_per_step_equals_fused_and_reruns(schedule):
    """The draws are a pure function of (seed, step, table): a rerun and
    the fused engine (two chunks of 16, one call each) pick the same
    batches as the per-step engine, whose run they equal bit for bit; the
    first n_b steps sweep 0..n_b-1 and every batch is visited."""
    make, sampler, icfg = _problem()
    ring = _ring(sampler)
    runs = []
    for K in (None, None, 16):
        params, loss_fn = make()
        if K is None:
            init, fn = make_scheduled_train_step(loss_fn, momentum(0.9), icfg,
                                                 schedule, lr_fn=_lr_fn)
        else:
            init, fn = make_chunked_train_step(loss_fn, momentum(0.9), icfg,
                                               chunk_steps=K, lr_fn=_lr_fn,
                                               schedule=schedule)
        calls = [0]

        def counting(*a, fn=fn):
            calls[0] += 1
            return fn(*a)
        _, p, ss, log, picks = _run_sched(counting, init, schedule, params,
                                          ring, K=K)
        runs.append((p, ss, log, picks, calls[0]))
    (p0, ss0, ref, want, _), (_, _, _, rerun, _), (p2, ss2, fused, got,
                                                    calls) = runs
    assert rerun == want
    _assert_bit_exact(ref, fused, p0, p2)
    assert got == want and calls == STEPS // 16
    for k in ss0:
        assert torch.equal(ss0[k], ss2[k])
    assert want[:4] == [0, 1, 2, 3]
    assert want[4:] != [j % 4 for j in range(4, STEPS)]
    assert (selection_counts(want, 4) > 0).all()
    assert int(ss0["visits"].sum()) == STEPS


def test_uses_table_spc_reads_per_batch_losses():
    """ψ-window caveat: under a table policy the control queue holds the
    latest loss per *batch* (not the last n_b visits)."""
    make, sampler, icfg = _problem()
    lp = TP.LossPropSchedule(eps=0.3)
    params, loss_fn = make()
    init, step = make_scheduled_train_step(loss_fn, momentum(0.9), icfg, lp,
                                           lr_fn=_lr_fn)
    s, _, _, log, picks = _run_sched(step, init, lp, params, _ring(sampler))
    last = {}
    for t, loss in zip(picks, log.losses):
        last[t] = loss
    want = np.array([last[t] for t in range(4)], np.float32)
    np.testing.assert_array_equal(s.queue.buf.numpy(), want)
    assert float(s.queue.total) == pytest.approx(want.sum(), rel=1e-5)


def test_scheduled_engines_need_lr_fn():
    make, _, icfg = _problem()
    _, loss_fn = make()
    with pytest.raises(ValueError, match="lr_fn"):
        make_scheduled_train_step(loss_fn, momentum(0.9), icfg,
                                  TP.FCPRSchedule())
    with pytest.raises(ValueError, match="lr_fn"):
        make_chunked_train_step(loss_fn, momentum(0.9), icfg, chunk_steps=2,
                                schedule=TP.FCPRSchedule())


@pytest.mark.parametrize("j0", [-1, 2 ** 63 - 2])
def test_chunk_cursor_outside_int64_range_raises(j0):
    make, sampler, icfg = _problem()
    params, loss_fn = make()
    init, chunk = make_chunked_train_step(loss_fn, momentum(0.9), icfg,
                                          chunk_steps=4, lr_fn=_lr_fn)
    with pytest.raises(ValueError, match="int64"):
        chunk(init(params), params, _ring(sampler).arrays, j0)


def test_push_at_matches_jax():
    from repro.core import control as JC
    jq, tq = JC.init_queue(3), control.init_queue(3, device="cpu")
    for slot, loss in ((0, 2.0), (1, 4.0), (2, 6.0), (1, 1.0), (0, 3.5)):
        jq = JC.push_at(jq, slot, loss)
        tq = control.push_at(tq, torch.tensor(slot), loss)
        for a, b in zip(tq, jq):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert float(control.control_limit(tq)) == \
            float(JC.control_limit(jq))
