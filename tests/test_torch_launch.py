"""The port's import boundary and its launcher."""
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
ENV = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))


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
        "need = ['repro_torch.models.moe'] + ['repro_torch.configs.' + a\n"
        "                                     for a in ARCH_IDS]\n"
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
