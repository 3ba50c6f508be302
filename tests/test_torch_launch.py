"""The port's import boundary and its launcher."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
ENV = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
torch.set_num_threads(2)


def _run(code_or_args, timeout=120):
    return subprocess.run([sys.executable, *code_or_args], cwd=ROOT, env=ENV,
                          capture_output=True, text=True, timeout=timeout)


def test_port_imports_no_jax_and_no_repro():
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "       or n == 'repro' or n.startswith('repro.')]\n"
        "n = len([n for n in sys.modules if n.startswith('repro_torch')])\n"
        "from repro_torch.configs import ARCH_IDS\n"
        "need = ['repro_torch.models.moe', 'repro_torch.sched.parity',\n"
        "        'repro_torch.train.checkpoints',\n"
        "        'repro_torch.train.resume_parity',\n"
        "        'repro_torch.distributed', 'repro_torch.core.reduce',\n"
        "        'repro_torch.distributed.data_parallel',\n"
        "        'repro_torch.distributed.prefetch',\n"
        "        'repro_torch.distributed.parity',\n"
        "        'repro_torch.launch.env', 'repro_torch.launch.mesh',\n"
        "        'repro_torch.launch.shardings', 'repro_torch.sharding',\n"
        "        'repro_torch.sharding.rules', 'repro_torch.sharding.ctx',\n"
        "        'repro_torch.distributed.hybrid_parity',\n"
        "        'repro_torch.distributed.multihost_parity',\n"
        "        'repro_torch.train.zoo_parity', 'repro_torch.fault',\n"
        "        'repro_torch.fault.plan',\n"
        "        'repro_torch.distributed.async_ps',\n"
        "        'repro_torch.distributed.async_ps.errors',\n"
        "        'repro_torch.distributed.async_ps.server',\n"
        "        'repro_torch.distributed.async_ps.worker',\n"
        "        'repro_torch.distributed.async_ps.coordinator',\n"
        "        'repro_torch.distributed.async_ps.parity',\n"
        "        'repro_torch.analysis', 'repro_torch.analysis.mode',\n"
        "        'repro_torch.analysis.count',\n"
        "        'repro_torch.analysis.roofline',\n"
        "        'repro_torch.launch.dryrun'] + [\n"
        "    'repro_torch.configs.' + a for a in ARCH_IDS]\n"
        "print('MISSING', [m for m in need if m not in sys.modules])\n"
        "print('BAD', bad, 'N', n)\n")
    r = _run(["-c", code])
    assert r.returncode == 0, r.stderr
    assert "BAD [] " in r.stdout, r.stdout
    assert "MISSING []" in r.stdout, r.stdout
    assert int(r.stdout.split("N")[-1]) >= 60


def test_launcher_runs_on_cpu():
    r = _run(["-m", "repro_torch.launch.train", "--device", "cpu",
              "--model", "transformer", "--tier", "tiny", "--steps", "6",
              "--seq", "32", "--n-seqs", "16", "--precision", "f32"])
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    assert any(l.startswith("step    1 loss=") for l in lines), r.stdout
    done = [l for l in lines if l.startswith("done: 6 steps")]
    assert done and "accelerated=" in done[0] and "sub_iters=" in done[0]


def test_launcher_runs_ssm_on_cpu():
    r = _run(["-m", "repro_torch.launch.train", "--device", "cpu",
              "--model", "ssm", "--tier", "tiny", "--steps", "4",
              "--seq", "32", "--n-seqs", "16", "--precision", "f32"])
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    assert lines[0].startswith("arch=paper-ssm-tiny "), r.stdout
    assert any(l.startswith("step    1 loss=") for l in lines), r.stdout
    done = [l for l in lines if l.startswith("done: 4 steps")]
    assert done and "accelerated=" in done[0] and "sub_iters=" in done[0]


def test_launcher_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the no-CUDA refusal; this machine has a card")
    r = _run(["-m", "repro_torch.launch.train", "--tier", "tiny",
              "--steps", "1"])
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr and "--device cpu" in r.stderr
    assert "done:" not in r.stdout


# four batches of 4 × 32 tokens: the branch fires from step 5 on
TINY = ["--device", "cpu", "--model", "transformer", "--tier", "tiny",
        "--batch", "4", "--seq", "32", "--n-seqs", "16", "--precision",
        "f32", "--k-sigma", "-3"]


def _engine_args(schedule, k):
    return ((["--schedule", schedule] if schedule else [])
            + ["--chunk-steps", str(k)])


@pytest.mark.parametrize("schedule,k", [("loss-prop", 2), ("loss-prop", 1),
                                        (None, 2), (None, 1)],
                         ids=["loss-prop-fused", "loss-prop-per-step",
                              "fcpr-fused", "fcpr-per-step"])
def test_launcher_checkpoint_resume_equals_uninterrupted(tmp_path, schedule,
                                                         k, capsys):
    """Kill after step 4 (``--steps 4`` with ``--checkpoint-every 4``), then
    ``--resume`` to step 8: the resumed steps' log (losses, decisions,
    batch picks) and the final params, ISGD state and policy table equal
    the uninterrupted run's, exactly."""
    from repro_torch.launch import train as launcher
    from repro_torch.train import checkpoints
    base = TINY + _engine_args(schedule, k)
    ck = ["--checkpoint-dir", str(tmp_path), "--checkpoint-every", "4"]
    ref = launcher.main(base + ["--steps", "8"])
    launcher.main(base + ["--steps", "4"] + ck)
    got = launcher.main(base + ["--steps", "8", "--resume"] + ck)
    assert "resume: restored" in capsys.readouterr().out
    assert (got["start"], got["steps"]) == (4, 8)
    for key in ("losses", "accelerated", "sub_iters"):
        assert getattr(got["log"], key) == getattr(ref["log"], key)[4:], key
    assert got["batch_idx"] == ref["batch_idx"][4:]
    assert len(got["batch_idx"]) == (4 if schedule else 0)
    assert any(got["log"].accelerated), "the branch never fired after the kill"
    trees = [checkpoints.tree_arrays(checkpoints.pack_engine_state(
        params=r["model"].params(), state=r["state"], step=8,
        sched_state=r["sched_state"],
        layout=checkpoints.layout_for(r["model"].module))[0])
        for r in (ref, got)]
    assert trees[0].keys() == trees[1].keys()
    for key in trees[0]:
        assert np.array_equal(trees[0][key], trees[1][key]), key


def test_launcher_schedule_obs_reconciles_table(tmp_path):
    """A table policy's SPC chart replays the per-batch queue writes
    (``--obs-dir`` with ``table=True``) and reconciles with the engine."""
    from repro_torch.launch import train as launcher
    res = launcher.main(TINY + ["--steps", "6", "--schedule", "loss-prop",
                                "--obs-dir", str(tmp_path)])
    assert res["obs"]["reconciled"] is True, res["obs"]
    assert sorted(set(res["batch_idx"])) == [0, 1, 2, 3]


def test_launcher_resume_needs_checkpoint_dir():
    r = _run(["-m", "repro_torch.launch.train", "--device", "cpu",
              "--model", "transformer", "--tier", "tiny", "--resume"])
    assert r.returncode != 0
    assert "--resume needs --checkpoint-dir" in r.stderr
    assert "done:" not in r.stdout


# ---------------------------------------------------------------------------
# --engine async-ps
# ---------------------------------------------------------------------------
ASYNC = TINY + ["--engine", "async-ps"]


def test_async_flags_parse_with_the_references_defaults():
    """The seven async-PS flags, with ``repro.launch.train``'s defaults."""
    from repro_torch.launch import train as launcher
    a = launcher.parse_args(["--model", "transformer"])
    assert (a.workers, a.max_staleness, a.staleness_decay, a.elastic,
            a.deadline, a.fault_plan, a.verify_pushes) == (
        2, 0, "inverse", False, 120.0, None, False)
    b = launcher.parse_args(
        ["--model", "transformer", "--engine", "async-ps", "--workers", "3",
         "--max-staleness", "1", "--staleness-decay", "exp:0.5",
         "--elastic", "--deadline", "2.5", "--fault-plan", "crash@2:5",
         "--verify-pushes"])
    assert launcher.engine_of(b) == "async-ps"
    assert (b.workers, b.max_staleness, b.staleness_decay, b.elastic,
            b.deadline, b.fault_plan, b.verify_pushes) == (
        3, 1, "exp:0.5", True, 2.5, "crash@2:5", True)


def test_async_launcher_trains_on_cpu():
    r = _run(["-m", "repro_torch.launch.train", *ASYNC, "--steps", "8",
              "--workers", "2", "--max-staleness", "1"])
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    assert lines[0].startswith("arch=paper-transformer-tiny engine=async-ps "
                               "workers=2 max_staleness=1"), r.stdout
    assert any(l.startswith("push    1 w") for l in lines), r.stdout
    stale = [l for l in lines if l.startswith("staleness: mean_tau=")]
    assert stale and stale[0].endswith("bound=3"), r.stdout
    assert any(l.startswith("done: 8 steps") for l in lines), r.stdout


@pytest.mark.parametrize("extra,match", [
    (["--chunk-steps", "2"], "do not compose with --engine async-ps"),
    (["--device-ring"], "do not compose with --engine async-ps"),
    (["--schedule", "loss-prop"], "--schedule does not compose"),
    (["--model-parallel", "2"], "--model-parallel composes with --engine "
                                "hybrid"),
], ids=["chunk-steps", "device-ring", "schedule", "model-parallel"])
def test_async_launcher_refuses_what_the_reference_refuses(extra, match):
    from repro_torch.launch import train as launcher
    with pytest.raises(SystemExit, match=match):
        launcher.main(ASYNC + ["--steps", "2"] + extra)


def test_async_launcher_refuses_an_encdec_config():
    from repro_torch.launch import train as launcher
    with pytest.raises(SystemExit, match="supports decoder-only/cnn"):
        launcher.main(["--device", "cpu", "--arch", "whisper_medium",
                       "--reduced", "--engine", "async-ps", "--steps", "2"])


def test_async_obs_dir_writes_counters_and_events(tmp_path):
    """``--obs-dir``: the push records as SPC steps, ``async_ps/pushes``,
    the τ and push-commit histograms, and the eviction and crash events
    of an elastic run; the JSONL is valid."""
    from repro_torch.launch import train as launcher
    from repro_torch.obs import read_jsonl, validate_record
    res = launcher.main(ASYNC + ["--steps", "8", "--workers", "2",
                                 "--max-staleness", "1", "--elastic",
                                 "--deadline", "2", "--fault-plan",
                                 "crash@1:2", "--obs-dir", str(tmp_path)])
    recs = read_jsonl(str(tmp_path / "metrics.p0.jsonl"))
    assert not [e for r in recs for e in validate_record(r)]
    names = {(r["kind"], r["name"]) for r in recs}
    assert ("counter", "async_ps/pushes") in names
    assert ("histogram", "async_ps/tau") in names
    assert ("histogram", "async_ps/push_commit_s") in names
    assert ("event", "async_ps.evict") in names
    assert ("event", "async_ps.crash") in names
    pushes = [r for r in recs if r["kind"] == "counter"
              and r["name"] == "async_ps/pushes"]
    assert pushes[-1]["total"] == len(res["records"]) == 6
    assert res["obs"]["reconciled"] is True, res["obs"]


def test_spawn_ranks_defaults_to_the_card():
    """``launch.env.spawn_ranks`` runs its ranks on the card unless
    ``device="cpu"`` is passed; without a card the default raises before
    any rank starts."""
    if torch.cuda.is_available():
        pytest.skip("checks the no-CUDA refusal; this machine has a card")
    from repro_torch.launch.env import spawn_ranks
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        spawn_ranks(print, 1)
