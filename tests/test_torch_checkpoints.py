"""Port vs JAX: crash-consistent checkpoints and bit-exact resume, on the
CPU.

  * every case of ``tests/test_checkpoints.py``, mirrored on the port's
    ``repro_torch.train.checkpoints`` (round-trips, suffix normalization,
    the atomic publish, each restore failure mode, lossless bf16, engine
    pack/unpack, the periodic ``Checkpointer``);
  * the format is the reference's, both ways: a JAX-written engine
    checkpoint (``lenet`` with momentum and with adam, and
    ``paper-transformer`` tiny with momentum) restores into the port, which
    then continues on the JAX run's trajectory (the same accelerate and
    sub_iters sequences, losses within 1e-5 relative, the tolerance of
    ``tests/test_torch_isgd.py``); a port-written one restores through
    ``repro.train.checkpoints.restore_engine`` with JAX templates, with the
    same ``tree_checksum`` for the same content, and JAX continues from it
    on the port's trajectory;
  * the restore copies into the run's own tensors (the fused engine's
    graph holds their addresses);
  * ``repro_torch.train.resume_parity``'s five legs are bit-exact (max
    deviation 0.0) with accelerations across the kill, the ``hybrid`` leg
    also across two spawned gloo ranks;
  * the async parameter server's checkpoints (``--engine async-ps``):
    ``--checkpoint-every`` counts pushes and ``--resume`` continues bit for
    bit; the server's version and push clocks restore in the JAX package;
  * ``Checkpointer(role="validate")``: a validator whose replica equals the
    written file passes, one perturbed raises ``CheckpointError`` (in one
    process, and on rank 1 of two spawned ranks, rank 0 writing).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_cnns as J_CNNS
from repro.configs import zoo_config as j_zoo_config
from repro.core import ISGDConfig as J_ISGDConfig
from repro.models import build_model as j_build_model
from repro.models import cnn as JC
from repro.models import transformer as JT
from repro.optim import RULES as J_RULES
from repro.train import checkpoints as JCK
from repro.train import make_train_step as j_make_train_step
from repro_torch.configs import paper_cnns as T_CNNS
from repro_torch.configs import zoo_config
from repro_torch.convert import cnn_from_jax, params_from_jax
from repro_torch.core import ISGDConfig, control, isgd_init
from repro_torch.data import DeviceRing, FCPRSampler, make_lm_tokens
from repro_torch.data import synthetic as T_SYN
from repro_torch.models import build_model
from repro_torch.models.cnn import CNN, cnn_loss_fn
from repro_torch.optim import RULES, momentum
from repro_torch.sched.policies import LossPropSchedule
from repro_torch.train import (make_chunked_train_step, make_train_step,
                               resume_parity)
from repro_torch.train import checkpoints
from repro_torch.train.checkpoints import (CheckpointError, Checkpointer,
                                           named_layout)

torch.set_num_threads(2)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def test_roundtrip(tmp_path):
    params = {"a": torch.arange(6.0).reshape(2, 3),
              "nested": {"b": torch.ones((4,), dtype=torch.bfloat16)},
              "list": [torch.zeros((2,)), torch.full((3,), 7.0)]}
    path = str(tmp_path / "ckpt.npz")
    checkpoints.save(path, params, extra={"step": 7})
    like = {"a": torch.zeros(2, 3),
            "nested": {"b": torch.zeros(4, dtype=torch.bfloat16)},
            "list": [torch.zeros(2), torch.zeros(3)]}
    restored = checkpoints.restore(path, like)
    for a, b, t in zip(_leaves(params), _leaves(restored), _leaves(like)):
        assert b.dtype == t.dtype
        np.testing.assert_array_equal(a.float().numpy(), b.float().numpy())
    assert checkpoints.load_extra(path)["step"] == 7


def test_isgd_state_roundtrip(tmp_path):
    """The control queue must survive a restart (resume with limit intact)."""
    params = [torch.ones(3)]
    state = isgd_init(momentum(0.9), ISGDConfig(n_batches=4), params)
    for x in (1.0, 2.0, 3.0, 4.0):
        state = state._replace(queue=control.push(state.queue, x))
    path = str(tmp_path / "state.npz")
    checkpoints.save(path, state.queue)
    like = control.init_queue(4, device="cpu")
    restored = checkpoints.restore(path, like)
    assert type(restored) is type(like)
    assert float(control.mean(restored)) == float(control.mean(state.queue))
    assert float(control.control_limit(restored)) == \
        float(control.control_limit(state.queue))


def test_suffix_normalized_both_directions(tmp_path):
    tree = {"w": torch.ones(2)}
    out = checkpoints.save(str(tmp_path / "bare"), tree)   # no .npz suffix
    assert out.endswith("bare.npz") and os.path.exists(out)
    for spec in ("bare", "bare.npz"):                      # restore either way
        r = checkpoints.restore(str(tmp_path / spec), {"w": torch.zeros(2)})
        np.testing.assert_array_equal(r["w"].numpy(), 1.0)
    assert checkpoints.save(str(tmp_path / "full.npz"), tree) == \
        str(tmp_path / "full.npz")


def test_save_is_atomic_no_tmp_residue(tmp_path):
    checkpoints.save(str(tmp_path / "a"), {"w": torch.ones(3)})
    assert os.listdir(tmp_path) == ["a.npz"]               # no *.tmp-* left


def _save_simple(tmp_path, name="c"):
    return checkpoints.save(str(tmp_path / name),
                            {"w": torch.arange(4.0), "b": torch.ones(())})


def test_restore_missing_file(tmp_path):
    with pytest.raises(CheckpointError, match="no checkpoint at"):
        checkpoints.restore(str(tmp_path / "nope"), {"w": torch.zeros(4)})


def test_restore_missing_key(tmp_path):
    path = _save_simple(tmp_path)
    with pytest.raises(CheckpointError, match="no entry for .*extra_key"):
        checkpoints.restore(path, {"w": torch.zeros(4), "b": torch.zeros(()),
                                   "extra_key": torch.zeros(2)})
    # the other direction — file keys absent from the template — is ignored
    assert set(checkpoints.restore(path, {"w": torch.zeros(4)})) == {"w"}


def test_restore_shape_mismatch(tmp_path):
    path = _save_simple(tmp_path)
    with pytest.raises(CheckpointError, match="shape"):
        checkpoints.restore(path, {"w": torch.zeros(2, 2),
                                   "b": torch.zeros(())})


def test_restore_dtype_mismatch(tmp_path):
    path = _save_simple(tmp_path)
    with pytest.raises(CheckpointError, match="dtype"):
        checkpoints.restore(path, {"w": torch.zeros(4, dtype=torch.int32),
                                   "b": torch.zeros(())})


def test_restore_truncated_file(tmp_path):
    path = _save_simple(tmp_path)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)
    with pytest.raises(CheckpointError, match="truncated or corrupt"):
        checkpoints.restore(path, {"w": torch.zeros(4), "b": torch.zeros(())})


def test_restore_corrupt_payload_fails_checksum(tmp_path):
    path = _save_simple(tmp_path)
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 3)
        f.write(b"\xff\xff\xff\xff")
    with pytest.raises(CheckpointError,
                       match="checksum|truncated or corrupt"):
        checkpoints.restore(path, {"w": torch.zeros(4), "b": torch.zeros(())})


def test_bf16_roundtrip_lossless(tmp_path):
    """bf16 leaves are stored as their exact f32 image (npz has no bf16)."""
    vals = torch.tensor([1.0, 3.140625, -2.5e4, 6.1e-5], dtype=torch.bfloat16)
    path = checkpoints.save(str(tmp_path / "bf16"), {"w": vals})
    r = checkpoints.restore(path, {"w": torch.zeros(4, dtype=torch.bfloat16)})
    assert r["w"].dtype == torch.bfloat16
    assert torch.equal(r["w"], vals)
    # a bf16 template refuses a file whose leaf was not stored as f32
    checkpoints.save(str(tmp_path / "f64"), {"w": np.zeros(4, np.float64)})
    with pytest.raises(CheckpointError, match="bf16 leaves are stored"):
        checkpoints.restore(str(tmp_path / "f64"),
                            {"w": torch.zeros(4, dtype=torch.bfloat16)})


# ---------------------------------------------------------------------------
# full-engine pack/unpack + the periodic Checkpointer
# ---------------------------------------------------------------------------
W = named_layout(["w"])


def test_engine_checkpoint_roundtrip(tmp_path):
    params = [torch.full((3,), 2.0)]
    state = isgd_init(momentum(0.9), ISGDConfig(n_batches=4), params)
    state = state._replace(iter=5)
    sched = {"table": torch.arange(4.0)}
    path = checkpoints.save_engine(
        str(tmp_path / "eng"), params=params, state=state, step=17,
        sched_state=sched, layout=W,
        server={"version": 17, "pushed": {0: 9, 1: 8}})
    live = [torch.zeros(3)]
    st = isgd_init(momentum(0.9), ISGDConfig(n_batches=4), live)
    table = {"table": torch.zeros(4)}
    ck = checkpoints.restore_engine(path, params_like=live, state_like=st,
                                    sched_like=table, layout=W)
    assert ck.step == 17
    assert ck.server == {"version": 17, "pushed": {0: 9, 1: 8}}
    assert ck.params is live and ck.sched_state is table    # in place
    np.testing.assert_array_equal(live[0].numpy(), 2.0)
    np.testing.assert_array_equal(table["table"].numpy(), np.arange(4.0))
    assert ck.state.iter == 5


def test_restore_engine_rejects_plain_checkpoint(tmp_path):
    path = checkpoints.save(str(tmp_path / "plain"), {"w": torch.ones(2)})
    params = [torch.zeros(2)]
    with pytest.raises(CheckpointError, match="not a full-engine"):
        checkpoints.restore_engine(
            path, params_like=params, layout=W,
            state_like=isgd_init(momentum(0.9), ISGDConfig(n_batches=4),
                                 params))


def test_checkpointer_cadence_latest_prune(tmp_path):
    params = [torch.ones(2)]
    state = isgd_init(momentum(0.9), ISGDConfig(n_batches=4), params)
    ck = Checkpointer(str(tmp_path), every=5, keep=2, layout=W)
    for step in range(1, 23):
        ck.maybe_save(step, params=params, state=state)
    # boundary crossings at 5, 10, 15, 20; keep=2 prunes to the last two
    assert ck.steps() == [15, 20]
    assert ck.latest().endswith("ckpt_00000020.npz")
    # chunked cadence: chunk boundaries cross marks even when every does
    # not divide the chunk size
    ck2 = Checkpointer(str(tmp_path / "chunky"), every=6, keep=0, layout=W)
    for step in (4, 8, 12, 16):
        ck2.maybe_save(step, params=params, state=state)
    assert ck2.steps() == [8, 12]           # marks 6 and 12, first boundary past
    # mark() anchors a resumed run so the next boundary is measured from it
    ck3 = Checkpointer(str(tmp_path / "resumed"), every=5, layout=W)
    ck3.mark(16)
    assert ck3.maybe_save(17, params=params, state=state) is None
    assert ck3.maybe_save(21, params=params, state=state) is not None


@pytest.mark.parametrize("kw,match", [(dict(pointer=True), None),
                                      (dict(role="validate"), "multi-process")])
def test_checkpointer_parts_not_ported_raise(tmp_path, kw, match):
    """``role="validate"`` checks its replica against the writer's file: it
    writes nothing, passes on an equal replica and raises on one that
    diverged. ``pointer=True`` (serving's publish directory): each save
    moves ``LATEST`` to the file it wrote, and pruning never removes that
    file."""
    if match is not None:
        params = [torch.ones(2)]
        state = isgd_init(momentum(0.9), ISGDConfig(n_batches=4), params)
        writer = Checkpointer(str(tmp_path), layout=W)
        validator = Checkpointer(str(tmp_path / "v"), layout=W, **kw)
        validator.directory = str(tmp_path)
        assert (writer.role, validator.role) == ("write", "validate")
        out = writer.save(2, params=params, state=state)
        assert validator.save(2, params=params, state=state) == out
        writer.save(4, params=params, state=state)
        params[0][1] += 1e-6
        with pytest.raises(CheckpointError, match=match):
            validator.save(4, params=params, state=state)
        assert not os.path.exists(tmp_path / "v")   # a validator never writes
        return
    from repro_torch.serve import read_pointer
    params = [torch.ones(2)]
    state = isgd_init(momentum(0.9), ISGDConfig(n_batches=4), params)
    ck = Checkpointer(str(tmp_path), every=2, keep=1, layout=W, **kw)
    assert read_pointer(str(tmp_path)) is None
    for step in (2, 4, 6):
        out = ck.maybe_save(step, params=params, state=state)
        assert read_pointer(str(tmp_path)) == out and os.path.exists(out)
    assert ck.steps() == [6]
    assert sorted(os.listdir(tmp_path)) == ["LATEST", "ckpt_00000006.npz"]


def test_checkpointer_records_save_and_restore_events(tmp_path):
    from repro_torch.obs import MetricsRecorder, read_jsonl
    from repro_torch.obs.recorder import JsonlSink
    path = str(tmp_path / "m.jsonl")
    rec = MetricsRecorder([JsonlSink(path)])
    params = [torch.ones(2)]
    state = isgd_init(momentum(0.9), ISGDConfig(n_batches=4), params)
    ck = Checkpointer(str(tmp_path / "d"), every=2, layout=W, recorder=rec)
    ck.maybe_save(2, params=params, state=state)
    checkpoints.restore_engine(ck.latest(), params_like=params,
                               state_like=state, layout=W, recorder=rec)
    rec.flush()
    rows = read_jsonl(path)
    events = {r["name"]: r["data"] for r in rows if r["kind"] == "event"}
    assert events["checkpoint.save"]["step"] == 2
    assert events["checkpoint.save"]["bytes"] == os.path.getsize(ck.latest())
    assert events["checkpoint.restore"]["step"] == 2
    assert any(r["name"] == "checkpoint/saves" for r in rows)


# ---------------------------------------------------------------------------
# the format is the reference's, both ways
# ---------------------------------------------------------------------------
LENET_8X8 = dict(name="lenet-8x8", image_size=8, channels=1, num_classes=10,
                 hidden=(24,))


def _lenet(rule, seed, k_sigma):
    """(JAX params, JAX loss, port (module, loss), data, ISGD kwargs, S, k)
    on the lenet-8x8 setup of ``tests/test_torch_cnn.py``."""
    convs = dict(convs=(J_CNNS.ConvSpec(4, 3, pool=2),
                        J_CNNS.ConvSpec(8, 3, pool=2)))
    jcfg = J_CNNS.CNNConfig(**convs, **LENET_8X8)
    tcfg = T_CNNS.CNNConfig(convs=(T_CNNS.ConvSpec(4, 3, pool=2),
                                   T_CNNS.ConvSpec(8, 3, pool=2)),
                            **LENET_8X8)
    data = T_SYN.make_classification(0, 64, 8, 1, 10, noise=0.2,
                                     class_spread=3.0)
    jp = JC.init_cnn(jax.random.PRNGKey(seed), jcfg)

    def port(tree):
        module = CNN(tcfg, device="cpu")
        module.load_state_dict(cnn_from_jax(tree))
        return module, lambda b: cnn_loss_fn(module, b)
    kw = dict(n_batches=8, k_sigma=k_sigma, stop=3, zeta=0.02)
    return (jp, lambda p, b: JC.cnn_loss_fn(p, jcfg, b), port, data, kw,
            24, 12, 8, 0.03)


def _transformer(rule, seed, k_sigma):
    cfg, jcfg = zoo_config("transformer", "tiny"), j_zoo_config(
        "transformer", "tiny")
    data = make_lm_tokens(0, 8, 64, cfg.vocab_size)
    jp = JT.init_params(jax.random.PRNGKey(seed), jcfg, dtype=jnp.float32)
    jm = j_build_model(jcfg, kernels="reference", param_dtype=jnp.float32)

    def port(tree):
        m = build_model(cfg, kernels="reference", param_dtype=torch.float32,
                        device="cpu")
        m.module.load_state_dict(params_from_jax(tree, cfg))
        return m.module, m.loss_fn
    kw = dict(n_batches=4, k_sigma=k_sigma, stop=3, zeta=1.0)
    return jp, jm.loss_fn, port, data, kw, 12, 6, 2, 0.005


# (setup, rule, init seed, k_sigma): each fires the subproblem after the
# kill with every port decision clear of its limit by 1e-3 relative
CROSS = [(_lenet, "momentum", 1, 1.0), (_lenet, "adam", 1, 1.0),
         (_transformer, "momentum", 2, 1.0)]
CROSS_IDS = ["lenet-momentum", "lenet-adam", "transformer-tiny-momentum"]


def _jax_leg(jp, jloss, rule, kw, sampler, lr, j0, j1, state=None):
    init, step = j_make_train_step(jloss, J_RULES[rule](),
                                   J_ISGDConfig(**kw),
                                   lr_fn=lambda _: jnp.asarray(lr),
                                   donate=False)
    state = init(jp) if state is None else state
    out = []
    for j in range(j0, j1):
        state, jp, m = step(state, jp, {k: jnp.asarray(v)
                                        for k, v in sampler(j).items()})
        out.append((float(m["loss"]), bool(m["accelerated"]),
                    int(m["sub_iters"])))
    return jp, state, out


def _port_leg(loss_fn, params, rule, kw, sampler, lr, j0, j1, state=None):
    seen = []

    def lf(batch):
        total, aux = loss_fn(batch)
        seen.append(float(total.detach()))
        return total, aux
    init, step = make_train_step(lf, RULES[rule](), ISGDConfig(**kw),
                                 lr_fn=lambda _: torch.tensor(lr))
    state = init(params) if state is None else state
    out, margins = [], []
    for j in range(j0, j1):
        seen.clear()
        batch = {k: torch.from_numpy(v) for k, v in sampler(j).items()}
        state, params, m = step(state, params, batch)
        out.append((float(m["loss"]), m["accelerated"], m["sub_iters"]))
        limit = float(m["limit"])
        if np.isfinite(limit):
            tested = seen if m["sub_iters"] < kw["stop"] else seen[:-1]
            margins += [abs(p - limit) / abs(limit) for p in tested]
    return params, state, out, margins


def _assert_same_trajectory(ref, got):
    assert [r[1:] for r in got] == [r[1:] for r in ref]
    np.testing.assert_allclose([r[0] for r in got], [r[0] for r in ref],
                               rtol=1e-5)
    assert any(r[1] for r in ref), "the subproblem never fired after the kill"


def _jax_like(jp):
    """The JAX side's params as its tests feed them (``blocks`` a list:
    the reference's adam treats every tuple as a leaf)."""
    return dict(jp, blocks=list(jp["blocks"])) if "blocks" in jp else jp


@pytest.mark.parametrize("setup,rule,seed,k_sigma", CROSS, ids=CROSS_IDS)
def test_jax_checkpoint_restores_into_port_on_jax_trajectory(
        tmp_path, setup, rule, seed, k_sigma):
    jp, jloss, port, data, kw, S, k, bs, lr = setup(rule, seed, k_sigma)
    jp = _jax_like(jp)
    sampler = FCPRSampler(data, batch_size=bs, seed=1)
    jp_k, jstate, _ = _jax_leg(jp, jloss, rule, kw, sampler, lr, 0, k)
    path = JCK.save_engine(str(tmp_path / "jax"), params=jp_k, state=jstate,
                           step=k)
    _, _, ref = _jax_leg(jp_k, jloss, rule, kw, sampler, lr, k, S,
                         state=jstate)

    # a fresh port run, another init, restored from the JAX file
    module, loss_fn = port(jax.tree.map(np.asarray, setup(rule, seed + 7,
                                                          k_sigma)[0]))
    params = list(module.parameters())
    state = isgd_init(RULES[rule](), ISGDConfig(**kw), params)
    ck = checkpoints.restore_engine(path, params_like=params,
                                    state_like=state,
                                    layout=checkpoints.layout_for(module))
    assert ck.step == k and ck.state.iter == k
    _, _, got, margins = _port_leg(loss_fn, params, rule, kw, sampler, lr,
                                   ck.step, S, state=ck.state)
    _assert_same_trajectory(ref, got)
    assert min(margins) > 1e-3, min(margins)


@pytest.mark.parametrize("setup,rule,seed,k_sigma", CROSS, ids=CROSS_IDS)
def test_port_checkpoint_restores_into_jax(tmp_path, setup, rule, seed,
                                           k_sigma):
    jp, jloss, port, data, kw, S, k, bs, lr = setup(rule, seed, k_sigma)
    jp = _jax_like(jp)
    sampler = FCPRSampler(data, batch_size=bs, seed=1)
    module, loss_fn = port(jax.tree.map(np.asarray, jp))
    layout = checkpoints.layout_for(module)
    params = list(module.parameters())
    params, state, _, _ = _port_leg(loss_fn, params, rule, kw, sampler, lr,
                                    0, k)
    sched = LossPropSchedule().init(kw["n_batches"], device="cpu")
    sched["table"].copy_(torch.arange(kw["n_batches"], dtype=torch.float32))
    path = checkpoints.save_engine(str(tmp_path / "port"), params=params,
                                   state=state, step=k, layout=layout,
                                   sched_state=sched)
    jinit, _ = j_make_train_step(jloss, J_RULES[rule](), J_ISGDConfig(**kw),
                                 lr_fn=lambda _: jnp.asarray(lr))
    fresh = _jax_like(setup(rule, seed + 7, k_sigma)[0])
    from repro.sched import LossPropSchedule as JLossProp
    ck = JCK.restore_engine(path, params_like=fresh,
                            state_like=jinit(fresh),
                            sched_like=JLossProp().init(kw["n_batches"]))
    assert ck.step == k and int(ck.state.iter) == k
    tree, _ = checkpoints.pack_engine_state(params=params, state=state,
                                            step=k, layout=layout,
                                            sched_state=sched)
    assert JCK.tree_checksum({"params": ck.params, "state": ck.state,
                              "sched_state": ck.sched_state}) == \
        checkpoints.tree_checksum(tree)
    # both continue from the checkpoint: JAX on the port's trajectory
    _, _, ref, margins = _port_leg(loss_fn, params, rule, kw, sampler, lr,
                                   k, S, state=state)
    _, _, got = _jax_leg(ck.params, jloss, rule, kw, sampler, lr, k, S,
                         state=ck.state)
    _assert_same_trajectory(ref, got)
    assert min(margins) > 1e-3, min(margins)


def test_restore_is_in_place_and_keeps_a_prepared_chunk_fn(tmp_path):
    """The fused engine keys its capture on the tensors' addresses: a
    restore must copy into them, so a prepared chunk fn is not rebuilt and
    trains the restored values."""
    make, sampler, icfg, rule, lr_fn = resume_parity._problem("cpu")
    ring = DeviceRing(sampler.epoch_arrays(), sampler.batch_size,
                      device="cpu")
    params, loss_fn = make()
    init, chunk = make_chunked_train_step(loss_fn, rule, icfg, chunk_steps=2,
                                          lr_fn=lr_fn)
    state = init(params)
    state, params, _ = chunk(state, params, ring.arrays, 0)
    path = checkpoints.save_engine(str(tmp_path / "c"), params=params,
                                   state=state, step=2,
                                   layout=resume_parity.LAYOUT)
    state, params, _ = chunk(state, params, ring.arrays, 2)
    key, ptrs = chunk._key, [t.data_ptr() for t in params]
    ck = checkpoints.restore_engine(path, params_like=params,
                                    state_like=state,
                                    layout=resume_parity.LAYOUT)
    assert ck.state is state and [t.data_ptr() for t in params] == ptrs
    assert int(state.iter) == 2
    chunk.prepare(state, params, ring.arrays)
    assert chunk._key == key                  # no new warm-up or capture


@pytest.mark.parametrize("leg", resume_parity.LEGS)
def test_resume_parity_bit_exact(leg):
    (r,) = resume_parity.run_resume_parity(legs=(leg,), device="cpu")
    assert r["ok"] and r["max_dev"] == 0.0, r
    assert r["accelerations"] > 0


def test_resume_parity_cli(capsys):
    assert resume_parity.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("BIT-EXACT") == len(resume_parity.LEGS)


def test_resume_parity_hybrid_leg_over_two_ranks(capsys):
    assert resume_parity.main(["--device", "cpu", "--procs", "2"]) == 0
    out = capsys.readouterr().out
    assert "resume-parity   hybrid: max_dev=0.000e+00" in out
    assert out.count("BIT-EXACT") == 1


def test_validator_rank_catches_a_diverged_replica(tmp_path):
    import _torch_dist_workers as WK
    from repro_torch.launch.env import spawn_ranks
    same = spawn_ranks(WK.validate_rank, 2, str(tmp_path / "same"), False,
                       device="cpu", timeout=240)
    assert [r[0] for r in same] == ["write", "validate"]
    assert same[0][1] == same[1][1] and same[1][2] is None
    off = spawn_ranks(WK.validate_rank, 2, str(tmp_path / "off"), True,
                      device="cpu", timeout=240)
    assert off[0][2] is None
    assert "diverged at step 8" in off[1][2]
    assert sorted(os.listdir(tmp_path / "off")) == ["ckpt_00000004.npz",
                                                    "ckpt_00000008.npz"]


def test_layout_keys_are_the_references():
    """The port's engine tree for lenet has the JAX package's keys, shapes
    and stored dtypes, key for key."""
    jp = JC.init_cnn(jax.random.PRNGKey(0), J_CNNS.LENET)
    from repro.core import isgd_init as j_isgd_init
    jstate = j_isgd_init(J_RULES["momentum"](), J_ISGDConfig(n_batches=4), jp)
    want = JCK._flatten({"params": jp, "state": jstate})[0]
    module = CNN(dataclasses.replace(T_CNNS.LENET), device="cpu")
    params = list(module.parameters())
    tree, _ = checkpoints.pack_engine_state(
        params=params, state=isgd_init(momentum(0.9), ISGDConfig(n_batches=4),
                                       params),
        step=0, layout=checkpoints.layout_for(module))
    got = checkpoints.tree_arrays(tree)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k


# ---------------------------------------------------------------------------
# the async parameter server's checkpoints (--engine async-ps)
# ---------------------------------------------------------------------------
ASYNC_TINY = ["--device", "cpu", "--model", "transformer", "--tier", "tiny",
              "--batch", "4", "--seq", "32", "--n-seqs", "16", "--precision",
              "f32", "--k-sigma", "-3", "--engine", "async-ps", "--workers",
              "1"]


def test_async_launcher_checkpoint_resume_equals_uninterrupted(tmp_path,
                                                               capsys):
    """``--checkpoint-every 4`` counts applied pushes: kill after push 4,
    ``--resume`` to 8 in a fresh run. The resumed pushes equal the
    uninterrupted run's, and the checkpoint written at push 8 holds its
    final params and ISGD state bit for bit, with the server's version
    and push clocks."""
    from repro_torch.launch import train as launcher
    ck = ["--checkpoint-dir", str(tmp_path), "--checkpoint-every", "4"]
    ref = launcher.main(ASYNC_TINY + ["--steps", "8"])
    launcher.main(ASYNC_TINY + ["--steps", "4"] + ck)
    capsys.readouterr()
    got = launcher.main(ASYNC_TINY + ["--steps", "8", "--resume"] + ck)
    out = capsys.readouterr().out
    assert "resume: restored" in out and "at server version 4" in out
    assert (got["start"], got["steps"]) == (4, 8)
    for key in ("losses", "psi_bar", "psi_std", "limits", "accelerated",
                "sub_iters"):
        assert getattr(got["log"], key) == getattr(ref["log"], key)[4:], key
    assert any(got["log"].accelerated), "the branch never fired after the kill"
    path = str(tmp_path / "ckpt_00000008.npz")
    assert checkpoints.load_extra(path)["server"] == {"version": 8,
                                                      "pushed": {"0": 8}}
    with np.load(path) as f:
        stored = {k: f[k] for k in f.files if k != "__meta__"}
    want = checkpoints.tree_arrays(checkpoints.pack_engine_state(
        params=ref["model"].params(), state=ref["state"], step=8,
        layout=checkpoints.layout_for(ref["model"].module))[0])
    assert stored.keys() == want.keys()
    for key in want:
        assert np.array_equal(stored[key], want[key]), key


def test_async_checkpoint_restores_in_jax_with_its_server_clocks(tmp_path):
    """A checkpoint the port's server writes (the resume-parity problem,
    one worker, snapshot at version 6) restores through the JAX package's
    ``restore_engine``, and the JAX ``snapshot_from_checkpoint`` reads the
    same version and push clocks and the same values."""
    from repro.core import isgd_init as j_isgd_init
    from repro.distributed.async_ps.coordinator import (
        snapshot_from_checkpoint as j_snapshot_from_checkpoint)
    from repro_torch.distributed.async_ps.coordinator import (
        AsyncPSCoordinator, snapshot_engine_kwargs)
    make, sampler, icfg, rule, lr_fn = resume_parity._problem("cpu")
    snaps = []
    coord = AsyncPSCoordinator(lambda w: make(), rule, icfg, workers=1,
                               lr_fn=lr_fn)
    coord.run(make()[0], sampler, 8, checkpoint_fn=snaps.append,
              checkpoint_every=6)
    (snap,) = snaps
    path = checkpoints.save_engine(str(tmp_path / "a"),
                                   layout=resume_parity.LAYOUT,
                                   **snapshot_engine_kwargs(snap))
    j_params = {"w": jnp.zeros(6, jnp.float32),
                "b": jnp.zeros((), jnp.float32)}
    j_icfg = J_ISGDConfig(n_batches=icfg.n_batches, k_sigma=icfg.k_sigma,
                          stop=icfg.stop, zeta=icfg.zeta)
    ck = JCK.restore_engine(path, params_like=j_params,
                            state_like=j_isgd_init(J_RULES["momentum"](),
                                                   j_icfg, j_params))
    js = j_snapshot_from_checkpoint(ck)
    assert (js["version"], js["pushed"], js["iter"]) == (6, {0: 6}, 6)
    np.testing.assert_array_equal(np.asarray(js["params"]["w"]),
                                  snap["params"][0].detach().numpy())
    np.testing.assert_array_equal(np.asarray(js["queue"].buf),
                                  snap["queue"].buf.numpy())
