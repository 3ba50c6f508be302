"""Port vs JAX: ``repro_torch.obs``, the telemetry package.

  * the copies equal the originals: ``percentile``/``summarize`` (exact),
    ``spc._sq`` on 10⁴ random f32 values (bitwise, and bitwise equal to
    the engine's ``control._sq``), ``validate_record`` (the same verdict on
    good and malformed records), ``StepTimer``/``require_measured_walls``,
    ``write_merged_summary``;
  * JSONL written by the port passes ``repro.obs.validate``, and JSONL
    written by the JAX package passes ``repro_torch.obs.validate``;
  * ``SPCExporter.reconcile`` is True, bit for bit, after tiny port runs
    of the transformer and lenet-8x8, per-step and fused (K ∈ {1, 4}),
    each run firing the accelerate branch;
  * the port's ``spc.final`` decisions (accelerate steps, sub_iters) equal
    the JAX run's on the lenet-8x8 setup of ``tests/test_torch_cnn.py``;
  * the observer takes host values only (a tensor raises), and observing
    a fused run adds no device-to-host transfer: one a chunk, as without
    it, plus one for the final reconcile;
  * ``async_run`` on records made by hand gives the JAX observer's records;
  * the launcher with ``--device cpu --obs-dir`` prints
    ``spc_reconciled=True`` (transformer, ``--chunk-steps 4``, ssm), both
    validators accept the directory, and ``--profile-dir`` writes a trace
    holding the ``obs/*`` spans.
"""
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as J_OBS
from repro.configs import paper_cnns as J_CNNS
from repro.core import ISGDConfig as J_ISGDConfig
from repro.data.fcpr import FCPRSampler as JFCPR
from repro.models import cnn as JC
from repro.obs import spc as J_SPC
from repro.obs import validate as J_VALIDATE
from repro.optim import momentum as j_momentum
from repro.train import make_train_step as j_make_train_step
from repro_torch import obs as T_OBS
from repro_torch.configs import paper_cnns as T_CNNS
from repro_torch.configs import zoo_config
from repro_torch.convert import cnn_from_jax
from repro_torch.core import ISGDConfig, control
from repro_torch.data import DeviceRing, FCPRSampler, make_lm_tokens
from repro_torch.data import synthetic as T_SYN
from repro_torch.launch import train as launcher
from repro_torch.models import build_model
from repro_torch.models.cnn import CNN, cnn_loss_fn
from repro_torch.obs import spc as T_SPC
from repro_torch.obs import validate as T_VALIDATE
from repro_torch.optim import momentum
from repro_torch.train import make_chunked_train_step, train

torch.set_num_threads(2)


def _observer(n_batches, k_sigma, package=T_OBS, **kw):
    sink = package.MemorySink()
    rec = package.MetricsRecorder([sink], tags={"process_id": 0,
                                                "engine": "test"})
    return package.TrainObserver(rec, n_batches=n_batches, k_sigma=k_sigma,
                                 **kw), sink


# ---------------------------------------------------------------------------
# copies held to the originals
# ---------------------------------------------------------------------------
def test_stats_equal_jax():
    rng = np.random.RandomState(0)
    for n in (0, 1, 2, 5, 100):
        xs = (rng.randn(n) * 10 ** rng.randint(-3, 4)).tolist()
        for q in (0, 5, 25, 50, 95, 99.9, 100):
            got, want = T_OBS.percentile(xs, q), J_OBS.percentile(xs, q)
            assert got == want or (np.isnan(got) and np.isnan(want))
        assert T_OBS.summarize(xs) == J_OBS.summarize(xs)


def test_sq_bitwise_equals_jax_and_the_engine():
    rng = np.random.RandomState(0)
    xs = (rng.randn(10_000) * 10.0 ** rng.randint(-6, 7, size=10_000)
          ).astype(np.float32)
    got = np.array([T_SPC._sq(x) for x in xs], dtype=np.float32)
    want = np.array([J_SPC._sq(x) for x in xs], dtype=np.float32)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    engine = control._sq(torch.from_numpy(xs)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), engine.view(np.uint32))


GOOD = {"v": 1, "kind": "counter", "name": "x", "wall": 0.0, "seq": 0,
        "tags": {"process_id": 0}, "value": 1, "total": 1}
RECORDS = [
    GOOD, "nope", {"v": 1}, dict(GOOD, v=2), dict(GOOD, kind="bogus"),
    dict(GOOD, name=""), dict(GOOD, wall=-1.0), dict(GOOD, seq="0"),
    dict(GOOD, tags={}), {k: v for k, v in GOOD.items() if k != "total"},
    dict(GOOD, kind="gauge", value=0.5), dict(GOOD, kind="gauge", value="x"),
    dict(GOOD, kind="histogram", stats={"count": 2}),
    dict(GOOD, kind="histogram", stats={}),
    dict(GOOD, kind="event", data={"a": 1}), dict(GOOD, kind="event", data=[]),
]


@pytest.mark.parametrize("rec", RECORDS, ids=[str(i) for i in range(len(RECORDS))])
def test_validate_record_same_verdict_as_jax(rec):
    assert T_OBS.validate_record(rec) == J_OBS.validate_record(rec)


def test_timing_copies_match_jax():
    for pkg in (T_OBS, J_OBS):
        t = [0.0]
        timer = pkg.StepTimer(clock=lambda: t[0])
        with timer.span("train"):
            t[0] += 2.0
        timer.add("train", 2.0)
        out = timer.throughput("train", steps=16, examples=128, dispatches=4)
        assert out == {"wall_s": 4.0, "wall_est": False, "dispatches": 4,
                       "steps_per_s": 4.0, "examples_per_s": 32.0,
                       "dispatches_per_s": 1.0}
        pkg.require_measured_walls([False, False])
    msgs = []
    for pkg in (T_OBS, J_OBS):
        with pytest.raises(pkg.EstimatedWallError) as e:
            pkg.require_measured_walls([True, False, True], context="fit")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "2/3" in msgs[0]


def test_console_is_the_coordinator_without_a_process_group():
    from repro_torch.obs.console import is_coordinator, process_index
    assert process_index() == 0 and is_coordinator()
    quiet = T_OBS.Console(active_fn=lambda: False)
    assert quiet.warn_once("k", "silent") is True
    assert quiet.warn_once("k", "again") is False


def _write_records(pkg, path, pid):
    rec = pkg.MetricsRecorder([pkg.JsonlSink(path)],
                              tags={"process_id": pid, "engine": "e"})
    rec.counter("train/steps", 5)
    rec.gauge("lr", 0.05)
    rec.observe("lat", 0.1)
    rec.observe("lat", 0.3)
    rec.event("spc.accelerate", step=4, batch=np.int32(2),
              psi_before=np.float32(1.5))
    rec.flush()
    rec.counter("train/steps", 3)
    rec.close()


def test_jsonl_cross_validates_and_merges(tmp_path):
    d = str(tmp_path)
    _write_records(T_OBS, T_OBS.jsonl_path(d, 0), 0)
    _write_records(J_OBS, J_OBS.jsonl_path(d, 1), 1)
    assert J_VALIDATE.main([d]) == 0        # the port's file, JAX's checker
    assert T_VALIDATE.main([d]) == 0        # and the reverse
    port = T_OBS.read_jsonl(T_OBS.jsonl_path(d, 0))
    ref = J_OBS.read_jsonl(J_OBS.jsonl_path(d, 1))
    strip = [{k: v for k, v in r.items() if k not in ("wall", "tags")}
             for r in port]
    assert strip == [{k: v for k, v in r.items() if k not in ("wall", "tags")}
                     for r in ref]
    assert T_OBS.write_merged_summary(d) == J_OBS.write_merged_summary(d)
    with open(os.path.join(d, "bad.jsonl"), "w") as fh:
        fh.write(json.dumps(dict(GOOD, v=2)) + "\n{not json\n")
    assert T_VALIDATE.main([d]) == J_VALIDATE.main([d]) == 1


# ---------------------------------------------------------------------------
# the SPC chart reconciled with the port's engines
# ---------------------------------------------------------------------------
LENET_8X8 = dict(name="lenet-8x8", image_size=8, channels=1, num_classes=10,
                 hidden=(24,))


def _lenet8x8():
    """``tests/test_torch_cnn.py``'s momentum setup: init seed 1, k_sigma 1,
    stop 3, ζ 0.02, LR 0.03, 8 batches of 8; the JAX init's weights."""
    jcfg = J_CNNS.CNNConfig(convs=(J_CNNS.ConvSpec(4, 3, pool=2),
                                   J_CNNS.ConvSpec(8, 3, pool=2)), **LENET_8X8)
    tcfg = T_CNNS.CNNConfig(convs=(T_CNNS.ConvSpec(4, 3, pool=2),
                                   T_CNNS.ConvSpec(8, 3, pool=2)), **LENET_8X8)
    data = T_SYN.make_classification(0, 64, 8, 1, 10, noise=0.2,
                                     class_spread=3.0)
    kw = dict(n_batches=8, k_sigma=1.0, stop=3, zeta=0.02)
    jp = JC.init_cnn(jax.random.PRNGKey(1), jcfg)

    def make():
        module = CNN(tcfg, device="cpu")
        module.load_state_dict(cnn_from_jax(jax.tree.map(np.asarray, jp)))
        return list(module.parameters()), lambda b: cnn_loss_fn(module, b)
    return (make, FCPRSampler(data, batch_size=8, seed=1), ISGDConfig(**kw),
            lambda _: torch.tensor(0.03), 24, (jcfg, jp, data, kw))


def _tiny_transformer():
    cfg = zoo_config("transformer", "tiny")
    data = make_lm_tokens(0, 8, 32, cfg.vocab_size)

    def make():
        m = build_model(cfg, kernels="cuda", param_dtype=torch.float32,
                        device="cpu")
        m.init(0)
        return m.params(), m.loss_fn
    return (make, FCPRSampler(data, batch_size=2, seed=1),
            ISGDConfig(n_batches=4, k_sigma=-3.0, stop=2),
            lambda _: torch.tensor(0.005), 8, None)


PROBLEMS = {"transformer": _tiny_transformer, "lenet-8x8": _lenet8x8}


def _run(problem, engine):
    """-> (observer, memory sink, final state) of one tiny port run with
    the observer at the engine's own boundaries."""
    make, sampler, icfg, lr_fn, steps, _ = PROBLEMS[problem]()
    params, loss_fn = make()
    obs, sink = _observer(icfg.n_batches, icfg.k_sigma)
    if engine == "per-step":
        _, state, log, _ = train(params, loss_fn, momentum(0.9), sampler,
                                 steps=steps, isgd_cfg=icfg, lr_fn=lr_fn,
                                 log_every=5, observer=obs)
    else:
        K = int(engine[1:])
        ring = DeviceRing(sampler.epoch_arrays(), sampler.batch_size,
                          device="cpu")
        init_fn, chunk = make_chunked_train_step(loss_fn, momentum(0.9), icfg,
                                                 chunk_steps=K, lr_fn=lr_fn)
        state = init_fn(params)
        from repro_torch.train import TrainLog
        log = TrainLog()
        for c in range(steps // K):
            state, params, ms = chunk(state, params, ring.arrays, c * K)
            obs.chunk(c * K, log.extend(ms, 0.0))
    return obs, sink, state, log


@pytest.mark.parametrize("engine", ["per-step", "K1", "K4"])
@pytest.mark.parametrize("problem", list(PROBLEMS))
def test_spc_reconciles_bitwise(problem, engine):
    obs, sink, state, log = _run(problem, engine)
    payload = obs.finalize(state, steps=len(log.losses), wall=1.0)
    assert payload["reconciled"], payload["mismatches"]
    snap = T_SPC.engine_snapshot(state)
    np.testing.assert_array_equal(obs.spc.buf.view(np.uint32),
                                  snap.buf.view(np.uint32))
    assert obs.spc.accel_count == snap.accel_count == sum(log.accelerated) > 0
    assert obs.spc.sub_iters == snap.sub_iters == sum(log.sub_iters)
    assert len(sink.by_name("spc.accelerate")) == obs.spc.accel_count
    assert len(sink.by_name("spc.step")) == snap.iter == len(log.losses)
    assert payload["engine_counters"] == {"iter": snap.iter,
                                          "accel_count": snap.accel_count,
                                          "sub_iters": snap.sub_iters}
    dispatches = obs.recorder.total("train/dispatches")
    assert dispatches == (0 if engine == "per-step"
                          else len(log.losses) // int(engine[1:]))
    for r in sink.records:
        assert T_OBS.validate_record(r) == [] == J_OBS.validate_record(r)


def test_reconcile_reports_a_mismatch():
    obs, _, state, _ = _run("lenet-8x8", "K4")
    snap = T_SPC.engine_snapshot(state)
    buf = snap.buf.copy()
    buf[3] = np.nextafter(buf[3], np.float32(np.inf))
    verdict = obs.spc.reconcile(snap._replace(buf=buf, sub_iters=snap.sub_iters + 1))
    assert not verdict["reconciled"]
    assert any("psi_table: 1/8" in m for m in verdict["mismatches"])
    assert any(m.startswith("sub_iters") for m in verdict["mismatches"])


def test_spc_final_decisions_match_jax_lenet8x8():
    make, sampler, icfg, lr_fn, steps, (jcfg, jp, data, kw) = _lenet8x8()
    jinit, jstep = j_make_train_step(lambda p, b: JC.cnn_loss_fn(p, jcfg, b),
                                     j_momentum(0.9), J_ISGDConfig(**kw),
                                     lr_fn=lambda _: jnp.asarray(0.03),
                                     donate=False)
    jobs, jsink = _observer(icfg.n_batches, icfg.k_sigma, package=J_OBS)
    jstate, jparams = jinit(jp), jp
    jsamp = JFCPR(data, batch_size=8, seed=1)
    for j in range(steps):
        jstate, jparams, m = jstep(jstate, jparams,
                                   {k: jnp.asarray(v) for k, v in jsamp(j).items()})
        jobs.defer(j, m)
    jfinal = jobs.finalize(jstate, steps=steps, wall=1.0)

    obs, sink, state, _ = _run("lenet-8x8", "per-step")
    final = obs.finalize(state, steps=steps, wall=1.0)
    assert final["reconciled"] and jfinal["reconciled"]

    def decisions(events):
        return [(e["step"], e["batch"], e["sub_iters"]) for e in events]
    assert decisions(obs.spc.events) == decisions(jobs.spc.events)
    assert len(obs.spc.events) >= 2
    for key in ("accel_count", "sub_iters", "accel_events", "steps", "count",
                "idx", "engine_counters"):
        assert final[key] == jfinal[key], key
    np.testing.assert_allclose(final["psi_table"], jfinal["psi_table"], rtol=1e-5)
    assert [r["data"]["step"] for r in sink.by_name("spc.accelerate")] == \
        [r["data"]["step"] for r in jsink.by_name("spc.accelerate")]


# ---------------------------------------------------------------------------
# the host-boundary rule
# ---------------------------------------------------------------------------
def test_observer_refuses_tensors():
    obs, _ = _observer(4, 1.0)
    host = {"loss": np.ones(4), "psi_bar": np.ones(4), "limit": np.ones(4),
            "accelerated": np.zeros(4), "sub_iters": np.zeros(4)}
    with pytest.raises(TypeError, match="'loss' is a tensor"):
        obs.chunk(0, dict(host, loss=torch.ones(4)))
    with pytest.raises(TypeError, match="'limit' is a tensor"):
        obs.defer(0, {k: v[0] for k, v in dict(host, limit=torch.ones(4)).items()})
    obs.chunk(0, host)                  # host arrays: ingested
    assert obs.spc.steps == 4


def test_observing_adds_no_transfer(monkeypatch):
    """Every device-to-host fetch of the fused path goes through
    ``Tensor.cpu`` (``host_metrics``, ``engine_snapshot``): count them over
    three chunks with and without an observer."""
    counts = []
    real = torch.Tensor.cpu

    def counting(self, *a, **kw):
        counts[-1] += 1
        return real(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "cpu", counting)
    for observed in (False, True):
        counts.append(0)
        make, sampler, icfg, lr_fn, _, _ = _lenet8x8()
        params, loss_fn = make()
        ring = DeviceRing(sampler.epoch_arrays(), sampler.batch_size,
                          device="cpu")
        init_fn, chunk = make_chunked_train_step(loss_fn, momentum(0.9), icfg,
                                                 chunk_steps=8, lr_fn=lr_fn)
        state = init_fn(params)
        obs = _observer(icfg.n_batches, icfg.k_sigma)[0] if observed else None
        from repro_torch.train import TrainLog
        log = TrainLog()
        for c in range(3):
            state, params, ms = chunk(state, params, ring.arrays, c * 8)
            host = log.extend(ms, 0.0)
            if obs is not None:
                obs.chunk(c * 8, host)
        if obs is not None:
            assert obs.finalize(state)["reconciled"]
    assert counts == [3, 3 + 1]


def test_async_run_matches_jax_on_records_made_by_hand():
    rng = np.random.RandomState(0)
    losses = (2.0 + rng.rand(12)).astype(np.float32)
    records = [{"loss": np.float32(l), "psi_bar": np.float32(2.5),
                "psi_std": np.float32(0.3), "limit": np.float32(2.8),
                "accelerated": bool(l > 2.8), "sub_iters": 2 * int(l > 2.8),
                "tau": int(rng.randint(0, 3)), "worker": i % 2}
               for i, l in enumerate(losses)]
    events = [{"event": "evict", "worker": 1, "at_push": 7}]
    got, gsink = _observer(4, 1.0, replay_exact=False)
    want, wsink = _observer(4, 1.0, package=J_OBS, replay_exact=False)
    got.async_run(records, events)
    want.async_run(records, events)

    def strip(sink):
        return [{k: v for k, v in r.items() if k != "wall"} for r in sink.records]
    assert strip(gsink) == strip(wsink)
    n_acc = sum(r["accelerated"] for r in records)
    assert n_acc > 0 and got.spc.accel_count == n_acc
    assert got.recorder.total("async_ps/pushes") == 12
    snap = T_SPC.EngineSnapshot(buf=np.zeros(4, np.float32),
                                total=np.float32(0), total_sq=np.float32(0),
                                count=0, idx=0, iter=12, accel_count=n_acc,
                                sub_iters=2 * n_acc)
    assert got.spc.reconcile(snap, replay_exact=False)["reconciled"]


# ---------------------------------------------------------------------------
# the launcher end to end
# ---------------------------------------------------------------------------
def _launch(capsys, *extra):
    """The launcher's CLI in this process: -> (result, stdout lines)."""
    launcher.main(["--device", "cpu", "--tier", "tiny", "--steps", "8",
                   "--seq", "32", "--n-seqs", "16", "--precision", "f32",
                   *extra])
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("extra", [("--model", "transformer"),
                                   ("--model", "transformer",
                                    "--chunk-steps", "4"),
                                   ("--model", "ssm")],
                         ids=["transformer", "chunked", "ssm"])
def test_launcher_obs_dir_reconciles(tmp_path, capsys, extra):
    d = str(tmp_path / "obs")
    lines = _launch(capsys, "--obs-dir", d, "--obs-console-every", "4", *extra)
    obs_line = [l for l in lines if l.startswith("obs: ")]
    assert obs_line and "spc_reconciled=True" in obs_line[0], lines
    assert lines.index(obs_line[0]) == len(lines) - 2
    assert lines[-1].startswith("done: 8 steps")
    assert any(l.startswith("[obs] ") for l in lines)
    assert T_VALIDATE.main([d]) == 0 and J_VALIDATE.main([d]) == 0
    records = T_OBS.read_jsonl(T_OBS.jsonl_path(d, 0))
    engine = "chunked" if "--chunk-steps" in extra else "per-step"
    assert {r["tags"]["engine"] for r in records} == {engine}
    final = [r["data"] for r in records if r["name"] == "spc.final"]
    assert len(final) == 1 and final[0]["reconciled"]
    assert final[0]["steps"] == 8
    with open(os.path.join(d, "summary.json")) as fh:
        assert json.load(fh)["counters"]["train/steps"] == 8


@pytest.mark.parametrize("extra,spans", [
    (("--model", "transformer"), ("obs/psi_push", "obs/accelerate")),
    (("--model", "transformer", "--chunk-steps", "4"),
     ("obs/chunk_scan", "obs/psi_push", "obs/accelerate")),
], ids=["per-step", "chunked"])
def test_launcher_profile_dir_writes_the_spans(tmp_path, capsys, extra, spans):
    d = str(tmp_path / "prof")
    lines = _launch(capsys, "--profile-dir", d, *extra)
    assert lines[-1].startswith("done: 8 steps"), lines
    traces = glob.glob(os.path.join(d, "*.json"))
    assert len(traces) == 1, os.listdir(d)
    with open(traces[0]) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    for span in spans:
        assert span in names, span
