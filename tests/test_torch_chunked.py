"""Port vs port and port vs JAX: the fused K-step engine and the
device-resident FCPR ring, on the CPU.

Mirrors the single-device half of ``tests/test_chunked.py``:

  * **bit-exact parity**: the chunked engine (``make_chunked_train_step``,
    the device form of Alg. 1 in a plain loop on the CPU, the same body the
    card captures into a CUDA graph) reproduces the port's per-step engine's
    losses, limits, ψ̄, accelerate decisions, sub-iteration counts and final
    params exactly (``assert_array_equal``) for K ∈ {1, 4, 32} over 8 FCPR
    epochs, on the regression problem and on the tiny transformer and
    MoE (``paper-moe-tiny``: routing, dispatch and the aux term in ψ);
  * **JAX parity**: it matches JAX ``make_chunked_train_step`` on the same
    inputs with the same decisions and losses within 1e-5 relative, the
    trajectory tolerance of ``tests/test_torch_isgd.py``;
  * **ring equivalence**: ``DeviceRing`` and ``PrefetchSampler`` serve the
    sampler's batches across epoch wraps, and ``ring_or_prefetch`` promotes
    and falls back at the same budgets as JAX's.

The ψ̄-dependent ``lr_fn`` makes the LR read the previous step's queue, so
an off-by-one in where the engine reads it breaks parity loudly.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import zoo_config as j_zoo_config
from repro.core import ISGDConfig as J_ISGDConfig
from repro.core.schedule import constant_lr as j_constant_lr
from repro.data import DeviceRing as JDeviceRing
from repro.data import FCPRSampler as JFCPR
from repro.data import ring_or_prefetch as j_ring_or_prefetch
from repro.models import build_model as j_build_model
from repro.models import transformer as JT
from repro.optim import momentum as j_momentum
from repro.train import TrainLog as JTrainLog
from repro.train import make_chunked_train_step as j_make_chunked
from repro_torch.configs import zoo_config
from repro_torch.convert import params_from_jax
from repro_torch.core import ISGDConfig, constant_lr
from repro_torch.data import (DeviceRing, ExplicitBatches, FCPRSampler,
                              PrefetchSampler, make_lm_tokens,
                              ring_or_prefetch)
from repro_torch.models import build_model
from repro_torch.optim import momentum
from repro_torch.train import (TrainLog, make_chunked_train_step,
                               make_train_step)
from repro_torch.kernels import graph_if

torch.set_num_threads(2)
STEPS = 32                      # n_batches = 4 -> 8 FCPR epochs
ROOT = os.path.join(os.path.dirname(__file__), "..")


def _regression(batch_size=8, n_batches=4, dim=6, seed=0):
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


def _tiny_transformer(model="transformer"):
    cfg = zoo_config(model, "tiny")
    data = make_lm_tokens(0, 8, 64, cfg.vocab_size)
    sampler = FCPRSampler(data, batch_size=2, seed=1)
    icfg = ISGDConfig(n_batches=4, k_sigma=-3.0, stop=3)

    def make():
        m = build_model(cfg, kernels="reference", param_dtype=torch.float32,
                        device="cpu")
        m.init(0)
        return m.params(), m.loss_fn
    return make, sampler, icfg


PROBLEMS = {"regression": _regression, "tiny-transformer": _tiny_transformer,
            "tiny-moe": lambda: _tiny_transformer("moe")}


def _lr_fn(psi_bar):
    # ψ̄-dependent on purpose: catches queue-lag regressions (module doc)
    return 0.01 + 0.001 * torch.clamp(psi_bar, max=1.0)


def _run_per_step(make, sampler, icfg, steps):
    params, loss_fn = make()
    init_fn, step = make_train_step(loss_fn, momentum(0.9), icfg,
                                    lr_fn=_lr_fn)
    state = init_fn(params)
    log = TrainLog()
    for j in range(steps):
        batch = {k: torch.from_numpy(v) for k, v in sampler(j).items()}
        state, params, m = step(state, params, batch)
        log.append(m, 0.0)
    return state, params, log


def _run_chunked(make, sampler, icfg, steps, K, inconsistent=True):
    params, loss_fn = make()
    ring = DeviceRing(sampler.epoch_arrays(), sampler.batch_size,
                      device="cpu")
    init_fn, chunk = make_chunked_train_step(
        loss_fn, momentum(0.9), icfg, chunk_steps=K,
        inconsistent=inconsistent, lr_fn=_lr_fn)
    state = init_fn(params)
    log = TrainLog()
    for c in range(steps // K):
        state, params, ms = chunk(state, params, ring.arrays, c * K)
        log.extend(ms, 0.0)
    return state, params, log


_REF = {}


def _reference(name):
    """The per-step run of a problem, made once per test process."""
    if name not in _REF:
        make, sampler, icfg = PROBLEMS[name]()
        _REF[name] = _run_per_step(make, sampler, icfg, STEPS)
    return _REF[name]


@pytest.mark.parametrize("K", [1, 4, 32])
@pytest.mark.parametrize("problem", list(PROBLEMS))
def test_chunked_bit_exact_vs_per_step(problem, K):
    ref_s, ref_p, ref = _reference(problem)
    make, sampler, icfg = PROBLEMS[problem]()
    got_s, got_p, got = _run_chunked(make, sampler, icfg, STEPS, K)
    for key in ("losses", "limits", "psi_bar", "psi_std", "accelerated",
                "sub_iters"):
        np.testing.assert_array_equal(getattr(got, key), getattr(ref, key),
                                      err_msg=key)
    for a, b in zip(ref_p, got_p):
        np.testing.assert_array_equal(a.detach().numpy(), b.detach().numpy())
    assert int(got_s.accel_count) == ref_s.accel_count
    assert int(got_s.sub_iters) == ref_s.sub_iters
    assert int(got_s.iter) == STEPS
    assert sum(ref.accelerated) > 0, "subproblem never fired"


def _jax_chunked(loss_fn, params, sampler, icfg, steps, K, lr_fn):
    ring = JDeviceRing(sampler.epoch_arrays(), sampler.batch_size)
    init_fn, chunk = j_make_chunked(loss_fn, j_momentum(0.9), icfg,
                                    chunk_steps=K, lr_fn=lr_fn, donate=False)
    state = init_fn(params)
    log = JTrainLog()
    for c in range(steps // K):
        state, params, ms = chunk(state, params, ring.arrays, c * K)
        log.extend(ms, 0.0)
    return state, log


def _assert_matches_jax(jlog, jstate, log, state):
    assert log.accelerated == jlog.accelerated
    assert log.sub_iters == jlog.sub_iters
    np.testing.assert_allclose(log.losses, jlog.losses, rtol=1e-5)
    assert int(state.accel_count) == int(jstate.accel_count)
    assert sum(log.accelerated) > 0, "subproblem never fired"


def test_chunked_regression_matches_jax():
    make, sampler, icfg = _regression()
    jsampler = JFCPR(dict(sampler.epoch_arrays()), batch_size=8, seed=0,
                     shuffle_quality=0.0)        # already permuted: keep it
    jicfg = J_ISGDConfig(n_batches=4, k_sigma=1.0, stop=3, zeta=0.01)

    def j_loss(p, b):
        loss = jnp.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2)
        return loss, loss

    jstate, jlog = _jax_chunked(
        j_loss, {"w": jnp.zeros((6,), jnp.float32),
                 "b": jnp.zeros((), jnp.float32)},
        jsampler, jicfg, STEPS, 4,
        lambda pb: jnp.asarray(0.01) + 0.001 * jnp.minimum(pb, 1.0))
    state, _, log = _run_chunked(make, sampler, icfg, STEPS, 4)
    _assert_matches_jax(jlog, jstate, log, state)


def test_chunked_tiny_transformer_matches_jax():
    """The setup of ``test_torch_isgd.py::test_trajectory_k1_matches_jax``
    (JAX init, seed 2, k_sigma 1, ζ = 1, momentum), where no decision lies
    within 1e-3 relative of its limit, through both chunked engines (K=4,
    12 steps, constant LR)."""
    cfg, jcfg = zoo_config("transformer", "tiny"), j_zoo_config("transformer",
                                                                "tiny")
    data = make_lm_tokens(0, 8, 64, cfg.vocab_size)
    jp = JT.init_params(jax.random.PRNGKey(2), jcfg, dtype=jnp.float32)
    jm = j_build_model(jcfg, kernels="reference", param_dtype=jnp.float32)
    kw = dict(n_batches=4, k_sigma=1.0, stop=3, zeta=1.0)
    jstate, jlog = _jax_chunked(jm.loss_fn, dict(jp, blocks=list(jp["blocks"])),
                                JFCPR(data, batch_size=2, seed=1),
                                J_ISGDConfig(**kw), 12, 4,
                                j_constant_lr(0.005))

    tm = build_model(cfg, kernels="reference", param_dtype=torch.float32,
                     device="cpu")
    tm.module.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp),
                                              cfg))
    sampler = FCPRSampler(data, batch_size=2, seed=1)
    ring = DeviceRing(sampler.epoch_arrays(), 2, device="cpu")
    init_fn, chunk = make_chunked_train_step(
        tm.loss_fn, momentum(0.9), ISGDConfig(**kw), chunk_steps=4,
        lr_fn=constant_lr(0.005))
    params = tm.params()
    state = init_fn(params)
    log = TrainLog()
    for c in range(3):
        state, params, ms = chunk(state, params, ring.arrays, c * 4)
        log.extend(ms, 0.0)
    _assert_matches_jax(jlog, jstate, log, state)


def test_chunked_consistent_step_runs():
    make, sampler, icfg = _regression()
    state, _, log = _run_chunked(make, sampler, icfg, 8, 4,
                                 inconsistent=False)
    assert not any(log.accelerated) and set(log.sub_iters) == {0}
    assert np.isfinite(log.losses).all() and int(state.iter) == 8
    _, _, ref = _run_chunked(make, sampler, icfg, 8, 4)
    assert log.losses[:4] == ref.losses[:4]      # the same base steps


def test_trainlog_extend_equals_append():
    stacked = {"loss": torch.tensor([1.5, 2.25], dtype=torch.float32),
               "aux": torch.tensor([1.0, 2.0]),
               "limit": torch.tensor([float("inf"), 3.0]),
               "psi_bar": torch.tensor([1.5, 1.875]),
               "psi_std": torch.tensor([0.0, 0.375]),
               "accelerated": torch.tensor([False, True]),
               "sub_iters": torch.tensor([0, 3], dtype=torch.int32)}
    a, b = TrainLog(), TrainLog()
    a.extend(stacked, 7.0)
    for i in range(2):
        b.append({k: v[i] for k, v in stacked.items()}, 7.0,
                 wall_estimated=True)
    assert a == b and a.wall_est == [True, True]
    j = JTrainLog()
    j.extend({k: jnp.asarray(v.numpy()) for k, v in stacked.items()}, 7.0)
    assert vars(a) == vars(j)


@pytest.mark.parametrize("sampler_kind", ["fcpr", "explicit"])
def test_ring_and_prefetch_serve_sampler_batches(sampler_kind):
    rng = np.random.RandomState(0)
    arrays = {"x": rng.randn(40, 3).astype(np.float32),
              "y": rng.randint(0, 9, size=40).astype(np.int32)}
    if sampler_kind == "fcpr":
        sampler = FCPRSampler(arrays, batch_size=8, seed=3)
    else:
        sampler = ExplicitBatches([{k: v[i:i + 8] for k, v in arrays.items()}
                                   for i in range(0, 40, 8)])
    ring = DeviceRing(sampler.epoch_arrays(), sampler.batch_size,
                      device="cpu")
    pre = PrefetchSampler(sampler, device="cpu", depth=2)
    assert ring.n_batches == pre.n_batches == sampler.n_batches == 5
    assert ring.nbytes == sampler.epoch_nbytes()
    for j in list(range(13)) + [3, 17, 0]:       # wraps, then random access
        want = sampler(j)
        for feed in (ring, pre):
            got = feed(j)
            assert feed.batch_index(j) == j % 5
            for k in want:
                np.testing.assert_array_equal(got[k].numpy(), want[k])


def test_ring_or_prefetch_promotes_like_jax():
    rng = np.random.RandomState(0)
    arrays = {"x": rng.randn(32, 6).astype(np.float32)}
    ts = FCPRSampler(arrays, batch_size=8, seed=1)
    js = JFCPR(arrays, batch_size=8, seed=1)
    n = ts.epoch_nbytes()
    assert n == js.epoch_nbytes() == 32 * 6 * 4
    for budget in (None, 10 * n, n, n - 1, 1):
        t = ring_or_prefetch(ts, device="cpu", byte_budget=budget)
        j = j_ring_or_prefetch(js, byte_budget=budget)
        assert type(t).__name__ == type(j).__name__, budget
        for step in (0, 5):
            np.testing.assert_array_equal(np.asarray(t(step)["x"]),
                                          np.asarray(j(step)["x"]))


def test_conditional_nodes_required(monkeypatch):
    """Where this torch cannot capture IF nodes the engine refuses (the
    CUDA path); the CPU path does not need them."""
    monkeypatch.setattr(torch.version, "cuda", "12.2")
    with pytest.raises(RuntimeError, match="conditional nodes"):
        graph_if.require()
    make, sampler, icfg = _regression()
    _run_chunked(make, sampler, icfg, 4, 4)        # CPU: runs all the same


def test_launcher_chunk_steps_on_cpu():
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--model", "transformer", "--tier", "tiny", "--steps", "6", "--seq", "32", "--n-seqs", "16",
         "--precision", "f32", "--chunk-steps", "4"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    assert "engine=chunked chunk_steps=4" in lines[0], r.stdout
    steps = [l.split()[1] for l in lines if l.startswith("step ")]
    assert steps == ["4", "8"], r.stdout          # 6 rounds up to 2 chunks
    done = [l for l in lines if l.startswith("done: 8 steps")]
    assert done and "accelerated=" in done[0] and "sub_iters=" in done[0]
