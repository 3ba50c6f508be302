"""The launcher's data-parallel engine (``--engine data-parallel``) on the
CPU: two ranks through ``--coordinator`` print the single-device run's
step lines (the tiny transformer in f32: the two half-batch means average
to the full-batch mean up to f32 rounding, which the printed 4 decimals do
not show), per-step and fused; one rank (no process arguments, each
spelling of the engine, in this process) equals the single-device run bit
for bit, log and params, and leaves no process group behind; rank 1
prints nothing; rank 0
writes the checkpoints, rank 1 validates them, and both resume from them;
a ``--batch`` the ranks do not divide exits 1; ``--model-parallel 2`` on
one rank exits with the mesh's ``MeshError`` (the reference's wording),
with ``--engine data-parallel`` with the reference's refusal, and
``--engine async-ps --chunk-steps 2`` exits with the reference's
refusal. Every process is joined with a timeout."""
import os
import socket
import subprocess
import sys

import pytest
import torch

from repro_torch.launch import train as launcher

torch.set_num_threads(2)
ROOT = os.path.join(os.path.dirname(__file__), "..")
ENV = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
           OMP_NUM_THREADS="1")
TIMEOUT = 180
BASE = ["-m", "repro_torch.launch.train", "--device", "cpu", "--model",
        "transformer", "--tier", "tiny", "--seq", "32", "--n-seqs", "16",
        "--precision", "f32", "--batch", "4"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _one(args, capsys) -> tuple:
    """The launcher in this process -> (its result, its stdout)."""
    capsys.readouterr()
    res = launcher.main(BASE[2:] + args)
    return res, capsys.readouterr().out


def _ranks(args, n=2):
    """``n`` launcher processes joined through ``--coordinator`` ->
    their ``CompletedProcess``-like (returncode, stdout, stderr)."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, *BASE, *args, "--coordinator", f"127.0.0.1:{port}",
         "--num-processes", str(n), "--process-id", str(r)],
        cwd=ROOT, env=ENV, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(n)]
    out = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=TIMEOUT)
            out.append((p.returncode, o, e))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    return out


def _steps(stdout: str) -> list:
    return [l for l in stdout.splitlines() if l.startswith("step ")]


@pytest.mark.parametrize("extra", [[], ["--chunk-steps", "3"]],
                         ids=["per-step", "fused"])
def test_two_ranks_print_the_single_device_lines(extra, capsys):
    args = ["--steps", "6", *extra]
    _, ref = _one(args, capsys)
    (rc0, out0, err0), (rc1, out1, err1) = _ranks(["--engine",
                                                   "data-parallel", *args])
    assert rc0 == 0 and rc1 == 0, err0[-3000:] + err1[-3000:]
    assert "mesh={'data': 2} processes=2 backend=gloo per_device_batch=2" \
        in out0
    assert _steps(out0) == _steps(ref) and _steps(out0)
    assert out1 == ""


@pytest.mark.parametrize("spelling", [["--engine", "data-parallel"],
                                      ["--data-parallel"],
                                      ["--engine", "hybrid"],
                                      ["--engine", "pjit", "--model-parallel",
                                       "1"]],
                         ids=["engine", "alias", "hybrid", "pjit"])
def test_one_rank_equals_the_single_device_run(spelling, capsys):
    import torch.distributed as dist
    args = ["--steps", "6", "--k-sigma", "-3"]       # the branch fires
    (ref, ref_out), (dp, dp_out) = _one(args, capsys), _one(args + spelling,
                                                            capsys)
    assert "mesh={'data': 1} processes=1 backend=gloo" in dp_out
    assert _steps(dp_out) == _steps(ref_out)
    for k in ("losses", "limits", "psi_bar", "accelerated", "sub_iters"):
        assert getattr(dp["log"], k) == getattr(ref["log"], k), k
    assert sum(ref["log"].sub_iters) > 0 and dp["ranks"] == 1
    for a, b in zip(ref["model"].params(), dp["model"].params()):
        assert torch.equal(a, b)
    assert not dist.is_initialized()         # the run's group is gone


def test_two_ranks_checkpoint_validate_and_resume(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    args = ["--engine", "data-parallel", "--checkpoint-dir", ck,
            "--checkpoint-every", "3"]
    first = _ranks(args + ["--steps", "6"])
    assert all(rc == 0 for rc, _, _ in first), first[0][2][-3000:]
    assert sorted(os.listdir(ck)) == ["ckpt_00000003.npz",
                                      "ckpt_00000006.npz"]
    resumed = _ranks(args + ["--steps", "10", "--resume"])
    assert all(rc == 0 for rc, _, _ in resumed), resumed[1][2][-3000:]
    out0 = resumed[0][1]
    assert "resume: restored" in out0 and "at step 6" in out0
    _, ref = _one(["--steps", "10"], capsys)
    want = [l for l in _steps(ref) if l.startswith("step   10 ")]
    assert want and want[0] in _steps(out0)
    assert resumed[1][1] == ""


def test_batch_not_divisible_by_the_ranks_exits_1():
    res = _ranks(["--engine", "data-parallel", "--batch", "5", "--n-seqs",
                  "20", "--steps", "2"])
    for rc, _, err in res:
        assert rc == 1
        assert "--batch 5 must be a multiple of the 2 data-parallel ranks" \
            in err


@pytest.mark.parametrize("args,match", [
    (["--engine", "hybrid", "--model-parallel", "2"],
     "model-parallel degree must divide the device count: n=1 devices, "
     "M=2"),
    (["--engine", "data-parallel", "--model-parallel", "2"],
     "--model-parallel composes with --engine hybrid, not --engine "
     "data-parallel"),
    (["--engine", "async-ps", "--chunk-steps", "2"],
     "do not compose with --engine async-ps")],
    ids=["hybrid-tp", "data-parallel-tp", "async-ps"])
def test_engines_not_ported_name_their_slice(args, match, capsys):
    with pytest.raises(SystemExit, match=match):
        _one(args + ["--steps", "2"], capsys)
