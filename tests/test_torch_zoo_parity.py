"""Port vs JAX: the zoo parity matrix (``repro_torch.train.zoo_parity``).

``run_zoo_parity`` at the tiny tier gives the reference's leg names and
verdicts: both packages' matrices on the transformer body at 8 steps, K=4
(the reference on one CPU device, the port's hybrid leg over two gloo
ranks) name the same legs and reach the same verdicts. The reference runs
in a subprocess, started before the port's runs of this file so that it
overlaps them. A port-only run over all three bodies at 16 steps, K=8,
fires the subproblem on each and passes every leg. Every rank is joined
with a timeout.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.train.zoo_parity import run_zoo_parity

torch.set_num_threads(2)

ROOT = os.path.join(os.path.dirname(__file__), "..")
TIMEOUT = 300
REFERENCE = (
    "import json, sys\n"
    "from repro.train.zoo_parity import run_zoo_parity\n"
    "r = run_zoo_parity(steps=8, K=4, models=('transformer',))\n"
    "print(json.dumps({k: bool(v['ok']) for k, v in r['legs'].items()}))\n")


@pytest.fixture(scope="module")
def reference():
    """The reference's ``run_zoo_parity`` in a subprocess, one CPU device;
    -> its process (the legs' verdicts as JSON on its last line)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, "-c", REFERENCE], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.wait(timeout=10)


def test_every_body_fires_and_passes(reference):
    r = run_zoo_parity(steps=16, K=8, device="cpu", procs=2, timeout=TIMEOUT)
    assert r["ok"], {k: v for k, v in r["legs"].items() if not v["ok"]}
    assert all(n > 0 for n in r["accelerations"].values()), r["accelerations"]
    assert len(r["legs"]) == 10


def test_leg_names_and_verdicts_equal_the_reference(reference):
    got = run_zoo_parity(steps=8, K=4, models=("transformer",),
                         device="cpu", procs=2, timeout=TIMEOUT)
    out, err = reference.communicate(timeout=TIMEOUT)
    assert reference.returncode == 0, err[-3000:]
    want = json.loads(out.strip().splitlines()[-1])
    assert {k: v["ok"] for k, v in got["legs"].items()} == want
    assert list(got["legs"]) == list(want)
    assert all(want.values())
