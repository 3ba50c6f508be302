"""Port vs JAX: the serving engines, the scheduler, snapshot publishing and
hot swap, and the serve launcher, on the CPU.

  * ``ServeEngine.generate`` and ``ContinuousScheduler.run`` (staggered:
    4 requests of mixed lengths and budgets on 2 slots) emit the JAX
    engine's and scheduler's tokens exactly, on tiny transformer, ssm and
    moe in f32; the port's ``compile_counts`` equal the reference's (one
    decode program in bf16; a prefill per distinct prompt length);
  * scheduler behaviour as ``tests/test_serve.py`` holds it: bounded
    queue, ``max_decode_batch``, EOS, truncation at ``max_seq``;
  * the publish protocol: ``Checkpointer(pointer=True)`` keeps ``LATEST``
    on the newest file and never prunes it; a ``LATEST`` published by the
    JAX package's checkpointer is served by the port's watcher and a
    port-published one by the JAX watcher, with equal ``params_checksum``;
    the watcher skips a pruned or corrupt target; ``swap_params`` copies
    in place and refuses a mismatched tree;
  * train-and-serve end to end: a ``repro_torch.launch.train`` subprocess
    publishing every 3 steps while the port's scheduler serves;
  * the serve launcher runs both engines on the CPU, and refuses without
    a card unless given ``--device cpu``.
"""
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ISGDConfig as J_ISGDConfig
from repro.optim import RULES as J_RULES
from repro.serve import ContinuousScheduler as JScheduler
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.serve import SnapshotWatcher as JWatcher
from repro.train import checkpoints as JCK
from repro.train import make_train_step as j_make_train_step
from repro_torch.configs import zoo_config
from repro_torch.core import ISGDConfig, isgd_init
from repro_torch.launch import serve as launcher
from repro_torch.models import build_model
from repro_torch.optim import momentum
from repro_torch.serve import (ContinuousScheduler, Request, ServeEngine,
                               SnapshotWatcher, publish_pointer, read_pointer)
from repro_torch.serve.snapshot import params_checksum
from repro_torch.train.checkpoints import Checkpointer, layout_for
from test_torch_serve import zoo_pair

torch.set_num_threads(2)
ROOT = os.path.join(os.path.dirname(__file__), "..")


def _port(family="transformer", dtype=torch.bfloat16, max_seq=48, seed=0):
    cfg = zoo_config(family, "tiny")
    m = build_model(cfg, kernels="reference", param_dtype=dtype, device="cpu")
    m.init(seed, max_seq=max_seq)
    return cfg, m


STAGGER = [(6, 8), (10, 3), (6, 5), (14, 8)]      # (prompt length, budget)


def _requests(cfg, cls):
    rng = np.random.RandomState(1)
    return [cls(rid=i, prompt=rng.randint(0, cfg.vocab_size,
                                          size=(n,)).astype(np.int32),
                max_new_tokens=k) for i, (n, k) in enumerate(STAGGER)]


@pytest.mark.parametrize("family", ["transformer", "ssm", "moe"])
def test_engines_emit_jax_tokens(family):
    """f32, the same params: the one-shot engine's continuation of each
    request and the scheduler's (4 requests on 2 slots, admitted and
    retired between steps) equal the JAX engine's and scheduler's token
    for token, and its ``compile_counts`` the JAX scheduler's."""
    cfg, jm, jp, m = zoo_pair(family)
    max_seq = 48
    jeng = JServeEngine(jm, jp, max_seq=max_seq)
    eng = ServeEngine(m, max_seq=max_seq)
    for r in _requests(cfg, Request):
        np.testing.assert_array_equal(
            eng.generate(r.prompt[None], steps=r.max_new_tokens),
            jeng.generate(r.prompt[None], steps=r.max_new_tokens))
    jsched = JScheduler(jm, jp, max_batch=2, max_seq=max_seq)
    want = jsched.run(_requests(cfg, JRequest))
    sched = ContinuousScheduler(m, max_batch=2, max_seq=max_seq)
    comps = sched.run(_requests(cfg, Request))
    assert [c.rid for c in comps] == [0, 1, 2, 3]
    for c, w in zip(comps, want):
        assert c.tokens == [int(t) for t in w.tokens], c.rid
    counts = sched.kv.compile_counts()
    # the f32 SSM's first decode promotes its bf16 conv state to f32, as
    # the reference's functional cache does: one more step signature,
    # and one more jit entry in the reference
    assert counts == jsched.kv.compile_counts(), counts
    assert counts["decode"] == (2 if family == "ssm" else 1), counts
    assert counts["prefill"] == len({6, 10, 14}), counts


def test_scheduler_decode_program_is_one_in_bf16():
    """bf16 (the serving precision): one decode program across admits,
    retires and three prompt lengths; the SSM's admit is length-free."""
    for family in ("transformer", "ssm", "moe"):
        cfg, m = _port(family)
        sched = ContinuousScheduler(m, max_batch=2, max_seq=48)
        sched.run(_requests(cfg, Request))
        counts = sched.kv.compile_counts()
        assert counts["decode"] == 1, (family, counts)
        assert counts["prefill"] == 3, (family, counts)
        assert counts["admit"] == (1 if family == "ssm" else 3), counts


def test_scheduler_admission_control():
    cfg, m = _port()
    prompt = np.arange(4, dtype=np.int32)
    # bounded queue: submits beyond max_queue are shed
    sched = ContinuousScheduler(m, max_batch=2, max_seq=16,
                                max_decode_batch=1, max_queue=2)
    assert sched.submit(Request(rid=0, prompt=prompt, max_new_tokens=3))
    assert sched.submit(Request(rid=1, prompt=prompt, max_new_tokens=3))
    assert not sched.submit(Request(rid=2, prompt=prompt, max_new_tokens=3))
    assert sched.rejected == 1
    # max_decode_batch caps concurrency below the slot count
    sched.step()
    assert sched.n_active <= 1
    comps = sched.run()
    assert [c.rid for c in comps] == [0, 1]
    # the token budget truncates at max_seq; a prompt filling max_seq
    # yields the steps=0 contract (no slot, no tokens)
    sched2 = ContinuousScheduler(m, max_batch=2, max_seq=16)
    comps = sched2.run([Request(rid=0, prompt=np.zeros(14, np.int32),
                                max_new_tokens=8),
                        Request(rid=1, prompt=np.zeros(16, np.int32),
                                max_new_tokens=4)])
    assert comps[0].truncated and len(comps[0].tokens) == 2
    assert comps[1].truncated and comps[1].tokens == []
    assert max(sched2.kv.cache["t"].tolist()) < 16     # cursors in range
    with pytest.raises(ValueError, match="max_seq"):
        sched2.kv.admit(0, np.zeros(16, np.int32))


def test_scheduler_eos_stop():
    cfg, m = _port()
    prompt = np.random.RandomState(3).randint(
        0, cfg.vocab_size, size=(6,)).astype(np.int32)
    free = ContinuousScheduler(m, max_batch=1, max_seq=32)
    toks = free.run([Request(rid=0, prompt=prompt, max_new_tokens=6)])[0].tokens
    eos = toks[2]                       # greedy is deterministic
    cut = toks.index(eos) + 1           # the first occurrence stops it
    sched = ContinuousScheduler(m, max_batch=1, max_seq=32)
    comp = sched.run([Request(rid=0, prompt=prompt, max_new_tokens=6,
                              eos_id=int(eos))])[0]
    assert comp.tokens == toks[:cut] and not comp.truncated


def test_scheduler_records_serve_events():
    from repro_torch.obs import MemorySink, MetricsRecorder
    cfg, m = _port()
    sink = MemorySink()
    rec = MetricsRecorder([sink])
    sched = ContinuousScheduler(m, max_batch=2, max_seq=48, recorder=rec)
    sched.run(_requests(cfg, Request))
    rec.flush()
    assert rec.total("serve/admitted") == rec.total("serve/retired") == 4
    assert rec.total("serve/tokens") == sum(k for _, k in STAGGER)
    assert len(sink.by_name("serve.admit")) == 4
    assert len(sink.by_name("serve.retire")) == 4
    summary = sched.latency_summary()
    assert summary["completions"] == 4
    assert summary["token_gap_s"]["count"] == sum(k - 1 for _, k in STAGGER)


# ---------------------------------------------------------------------------
# publishing and snapshots
# ---------------------------------------------------------------------------
def _port_state(m):
    params = m.params()
    return params, isgd_init(momentum(0.9), ISGDConfig(n_batches=4), params)


def test_publish_pointer_is_atomic_and_survives_pruning(tmp_path):
    cfg, m = _port()
    params, state = _port_state(m)
    pub = str(tmp_path / "pub")
    ck = Checkpointer(pub, every=3, keep=2, pointer=True,
                      layout=layout_for(m.module))
    assert read_pointer(pub) is None
    for step in range(1, 13):
        ck.maybe_save(step, params=params, state=state)
        latest = read_pointer(pub)
        if step >= 3:
            assert os.path.basename(latest) == f"ckpt_{step // 3 * 3:08d}.npz"
            assert os.path.exists(latest)          # never pruned
    assert ck.steps() == [9, 12]
    assert sorted(os.listdir(pub)) == ["LATEST", "ckpt_00000009.npz",
                                       "ckpt_00000012.npz"]  # no temp files
    publish_pointer(pub, ck.path(9))
    assert read_pointer(pub) == ck.path(9)


def _jax_state(jm, jp):
    init, _ = j_make_train_step(jm.loss_fn, J_RULES["momentum"](),
                                J_ISGDConfig(n_batches=4),
                                lr_fn=lambda _: jnp.asarray(0.1))
    return init(jp)


def test_jax_published_snapshot_is_served_by_port(tmp_path):
    """The JAX package's publishing checkpointer writes LATEST; the port's
    watcher restores it (f32 on disk, bf16 served), its checksum is the
    JAX tree_checksum of the same params, and the port's scheduler serves
    the JAX engine's tokens with it."""
    cfg, jm, jp, m = zoo_pair("transformer", dtype="bf16")
    jp2 = JT_init(jm, seed=5)
    pub = str(tmp_path / "pub")
    path = JCK.Checkpointer(pub, every=1, pointer=True, role="write").save(
        7, params=jp2, state=_jax_state(jm, jp2))
    assert read_pointer(pub) == path
    watcher = SnapshotWatcher(pub, m.params(), layout=layout_for(m.module))
    snap = watcher.poll()
    assert snap.generation == 1 and snap.step == 7 and snap.path == path
    disk = JCK.restore(path, {"params": jp2})["params"]
    assert snap.params_checksum == JCK.tree_checksum({"params": disk})
    assert watcher.poll() is None                   # pointer did not move
    sched = ContinuousScheduler(m, max_batch=2, max_seq=48)
    sched.kv.swap_params(snap.params)
    assert params_checksum(m.params(), layout_for(m.module)) == \
        snap.params_checksum
    comps = sched.run(_requests(cfg, Request))
    want = JScheduler(jm, disk, max_batch=2, max_seq=48).run(
        _requests(cfg, JRequest))
    assert [c.tokens for c in comps] == [[int(t) for t in w.tokens]
                                         for w in want]


def JT_init(jm, seed):
    from repro.models import transformer as JT
    return JT.init_params(jax.random.PRNGKey(seed), jm.cfg, max_seq=48,
                          dtype=jnp.bfloat16)


def test_port_published_snapshot_restores_in_jax(tmp_path):
    cfg, jm, jp, m = zoo_pair("transformer", dtype="bf16")
    m.init(9, max_seq=48)                          # params the JAX side lacks
    params, state = _port_state(m)
    pub = str(tmp_path / "pub")
    Checkpointer(pub, every=2, pointer=True,
                 layout=layout_for(m.module)).maybe_save(
        2, params=params, state=state)
    jsnap = JWatcher(pub, params_like=jp).poll()
    assert jsnap.step == 2
    assert jsnap.params_checksum == params_checksum(params,
                                                    layout_for(m.module))
    psnap = SnapshotWatcher(pub, params, layout=layout_for(m.module)).poll()
    assert psnap.params_checksum == jsnap.params_checksum


def test_watcher_skips_pruned_and_corrupt_targets(tmp_path):
    from repro_torch.obs import MemorySink, MetricsRecorder
    cfg, m = _port()
    params, state = _port_state(m)
    pub = str(tmp_path / "pub")
    os.makedirs(pub)
    sink = MemorySink()
    watcher = SnapshotWatcher(pub, params, layout=layout_for(m.module),
                              recorder=MetricsRecorder([sink]))
    assert watcher.poll() is None                   # no pointer yet
    publish_pointer(pub, os.path.join(pub, "ckpt_00000003.npz"))
    assert watcher.poll() is None                   # pointed-to file pruned
    bad = os.path.join(pub, "ckpt_00000004.npz")
    with open(bad, "wb") as f:
        f.write(b"PK\x03\x04 torn write")
    publish_pointer(pub, bad)
    assert watcher.poll() is None                   # corrupt: skipped
    ck = Checkpointer(pub, every=5, pointer=True, layout=layout_for(m.module))
    good = ck.save(5, params=params, state=state)
    snap = watcher.poll()
    assert snap is not None and snap.path == good and snap.generation == 1
    watcher.recorder.flush()
    assert [e["data"]["generation"] for e in sink.by_name(
        "serve.snapshot_load")] == [1]


def test_swap_params_copies_in_place_and_refuses_mismatch():
    cfg, m = _port()
    _, other = _port(seed=4)
    sched = ContinuousScheduler(m, max_batch=2, max_seq=48)
    ptrs = [p.data_ptr() for p in m.params()]
    sched.kv.swap_params(other.params())
    assert [p.data_ptr() for p in m.params()] == ptrs
    assert all(torch.equal(a, b) for a, b in zip(m.params(), other.params()))
    _, f32 = _port(dtype=torch.float32)
    with pytest.raises(ValueError, match="shapes/dtypes"):
        sched.kv.swap_params(f32.params())
    with pytest.raises(ValueError, match="shapes/dtypes"):
        sched.kv.swap_params(other.params()[:-1])


# ---------------------------------------------------------------------------
# train and serve, end to end
# ---------------------------------------------------------------------------
def test_train_and_serve_end_to_end(tmp_path):
    """A port trainer subprocess publishes every 3 of 9 steps while the
    port's scheduler serves through the swaps: at least 2 generations
    served, no request dropped, a request admitted under one generation
    and finished under another, and the served params equal the file
    LATEST points to, by checksum."""
    pub = str(tmp_path / "pub")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cfg, m = _port()
    layout = layout_for(m.module)
    watcher = SnapshotWatcher(pub, m.params(), layout=layout)
    sched = ContinuousScheduler(m, max_batch=2, max_seq=48, watcher=watcher,
                                swap_poll_every=1)
    rng = np.random.RandomState(0)
    rid = 0

    def feed_and_step():
        nonlocal rid
        while sched.pending < 2:
            p = rng.randint(0, cfg.vocab_size, size=(6,)).astype(np.int32)
            assert sched.submit(Request(rid=rid, prompt=p, max_new_tokens=6))
            rid += 1
        sched.step()

    while len(sched.completions) < 4:    # generation-0 traffic first
        feed_and_step()
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--model", "transformer", "--tier", "tiny", "--steps", "9",
         "--batch", "2", "--seq", "32", "--n-seqs", "8",
         "--publish-dir", pub, "--publish-every", "3"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.time() + 120
        while proc.poll() is None and time.time() < deadline:
            feed_and_step()
        out = proc.communicate(timeout=60)[0]
        sched.poll_snapshot()            # pick up the final snapshot
        while sched.pending:
            sched.step()
    finally:
        proc.kill()
    assert proc.returncode == 0, out
    assert len(sched.swap_events) >= 1
    comps = sched.completions
    gens = {c.gen_finished for c in comps}
    assert len(gens) >= 2, gens
    assert sorted(c.rid for c in comps) == list(range(rid))
    assert all(len(c.tokens) == 6 for c in comps)
    assert any(c.gen_admitted != c.gen_finished for c in comps)
    disk = SnapshotWatcher(pub, m.params(), layout=layout).poll()
    assert disk.path == read_pointer(pub)
    assert disk.params_checksum == params_checksum(m.params(), layout)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("engine", ["oneshot", "continuous"])
def test_serve_launcher_runs_on_cpu(engine, capsys):
    res = launcher.main(["--device", "cpu", "--model", "transformer",
                         "--engine", engine, "--requests", "6",
                         "--mixed-lengths", "--prompt-len", "8",
                         "--decode-steps", "8", "--max-seq", "64"])
    out = capsys.readouterr().out
    assert out.splitlines()[0].startswith("serving runs the model's plain "
                                          "paths under either --kernels")
    assert res["tokens"] > 0 and "tok/s" in out
    if engine == "continuous":
        assert res["scheduler"].kv.compile_counts()["decode"] == 1


def test_serve_launcher_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                        "--model", "transformer"],
                       env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
                       capture_output=True, text=True)
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr + r.stdout
