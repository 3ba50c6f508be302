"""Port vs JAX: the hybrid DP × TP engine (``repro_torch.distributed``).

The counterparts of the reference's passing tests in
``tests/test_hybrid.py``, on gloo ranks (``spawn_ranks``, each joined with
a timeout; rank functions in ``tests/_torch_dist_workers.py``):

  * ``hybrid(1,1)`` equals ``make_train_step`` bit for bit under a
    ψ̄-dependent ``lr_fn``, and a run frozen at ``lr_fn(0.0)`` differs;
  * on ``(2, 1)`` the hybrid engine is the data-parallel engine, bit for
    bit; on ``(1, 2)`` (the tensor-parallel strategy, the toy params
    replicated) it is the single-device program, bit for bit; the fused
    K=4 engine on ``(2, 1)`` equals the per-step one, and on ``(2, 2)``
    with a transformer split over ``model`` too;
  * ``make_host_mesh`` rejects a model degree that does not divide the
    ranks (``MeshError``, the reference's wording); both ring layouts on
    the 2-D mesh give the sampler's batches (the rank's rows, or the
    global batch in global row order);
  * the harness ``run_hybrid_parity`` passes over 2 ranks.

Against the JAX package: ``sharded-tp(model=2)`` (a (128, 8) weight split
over ``model``) within 1e-5 of the JAX ``make_train_step`` trajectory on
the same numpy inputs, accelerations equal and above 0; and
``paper-transformer`` tiny (f32, plain paths) over gloo on ``(1, 2)`` and
``(2, 2)`` (and a wide variant on ``(2, 2)``, d 128 with four heads of
32, whose attention splits by heads too) against the JAX per-step engine for 3
steps: losses within 2e-5 relative, limits alike, decisions equal, every
parameter within 2e-4·max|p| of its leaf (the model-axis partial sums
reassociate f32).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_workers as W
from repro.configs import zoo_config as j_zoo_config
from repro.core import ISGDConfig as JISGDConfig
from repro.data import FCPRSampler as JFCPRSampler
from repro.data import make_lm_tokens as j_make_lm_tokens
from repro.models import build_model as j_build_model
from repro.models import transformer as JT
from repro.optim import momentum as j_momentum
from repro.train import make_train_step as j_make_train_step
from repro_torch.convert import params_from_jax
from repro_torch.distributed import make_hybrid_step, tensor_axes
from repro_torch.distributed.hybrid_parity import run_hybrid_parity_ranks
from repro_torch.launch import env
from repro_torch.launch.env import spawn_ranks
from repro_torch.launch.mesh import MeshError, make_host_mesh
from repro_torch.optim import momentum
from repro_torch.train import make_train_step

torch.set_num_threads(2)
TIMEOUT = 120
KEYS = ("loss", "limit", "psi_bar", "accelerated", "sub_iters")


def _exact(ref, got):
    for k in KEYS:
        np.testing.assert_array_equal(ref[0][k], got[0][k], err_msg=k)
    for a, b in zip(ref[1], got[1]):
        np.testing.assert_array_equal(a, b)
    assert ref[2] == got[2] and ref[0]["accelerated"].sum() > 0


def _single(world=1, lr_fn=None):
    sampler, make, icfg, lr = W._hybrid_regression(8 * world)
    params, loss_fn = make()
    init, step = make_train_step(loss_fn, momentum(0.9), icfg,
                                 lr_fn=lr_fn or lr)
    return W._run_steps(step, init, params, sampler)


def test_hybrid_psi_lr_bit_exact_vs_per_step_and_catches_freeze():
    ref = _single()
    sampler, make, icfg, lr_fn = W._hybrid_regression(8)
    with env.local_group("cpu"):
        mesh = make_host_mesh(model=1, device="cpu")
        assert tensor_axes(mesh) == ()
        params, loss_fn = make()
        init, step = make_hybrid_step(loss_fn, momentum(0.9), icfg, mesh,
                                      lr_fn=lr_fn)
        _exact(ref, W._run_steps(step, init, params, sampler))
    frozen = _single(lr_fn=lambda p: lr_fn(torch.zeros_like(p)))
    assert any(not np.array_equal(a, b) for a, b in zip(ref[1], frozen[1]))


@functools.lru_cache(maxsize=None)
def _jax_tiny(wide: bool, steps: int, lr: float):
    jcfg = j_zoo_config("transformer", "tiny")
    if wide:
        jcfg = dataclasses.replace(jcfg, d_model=128, head_dim=32, d_ff=256)
    model = j_build_model(jcfg, kernels="reference", param_dtype=jnp.float32)
    tp = JT.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    sd = params_from_jax(jax.tree.map(np.asarray, tp), W.tiny_tp_config(wide))
    sampler = JFCPRSampler(j_make_lm_tokens(0, 16, 32, jcfg.vocab_size),
                           batch_size=4, seed=1)
    init, step = j_make_train_step(
        model.loss_fn, j_momentum(0.9), JISGDConfig(n_batches=4, k_sigma=1.0,
                                                    stop=2),
        lr_fn=lambda _: jnp.asarray(lr), donate=False)
    state = init(tp)
    losses, limits, accel = [], [], []
    for j in range(steps):
        state, tp, m = step(state, tp, {k: jnp.asarray(v)
                                        for k, v in sampler(j).items()})
        losses.append(float(m["loss"]))
        limits.append(float(m["limit"]))
        accel.append(bool(m["accelerated"]))
    final = params_from_jax(jax.tree.map(np.asarray, tp),
                            W.tiny_tp_config(wide))
    return sd, losses, limits, accel, final


@pytest.fixture(scope="module")
def start_dicts(tmp_path_factory):
    """The JAX init of the tiny and the wide transformer, as state-dict
    npz files the ranks load."""
    out = {}
    for wide in (False, True):
        path = str(tmp_path_factory.mktemp("sd") / f"wide{int(wide)}.npz")
        sd = _jax_tiny(wide, 3, 0.05)[0]
        np.savez(path, **{k: v.numpy() for k, v in sd.items()})
        out[wide] = path
    return out


@pytest.fixture(scope="module")
def two_ranks(start_dicts):
    """Every two-rank leg of this file, one spawn (each rank a process)."""
    return spawn_ranks(W.hybrid_suite_rank, 2, start_dicts[False],
                       start_dicts[True], device="cpu", timeout=TIMEOUT)


@pytest.fixture(scope="module")
def four_ranks(start_dicts):
    """Every four-rank leg of this file, one spawn."""
    return spawn_ranks(W.hybrid_suite_rank, 4, start_dicts[False],
                       start_dicts[True], device="cpu", timeout=TIMEOUT)


def test_hybrid_model1_bit_exact_vs_data_parallel(two_ranks):
    for r in two_ranks:
        (dp, hy), axes = r["model1"]
        assert axes == ()
        _exact(dp, hy)


def test_hybrid_pure_tp_bit_exact_vs_per_step(two_ranks):
    ref = _single(world=2)
    for r in two_ranks:
        got, axes = r["pure_tp"]
        assert axes == ("model",)
        _exact(ref, got)


def test_chunked_hybrid_bit_exact_vs_per_step_hybrid(two_ranks):
    for r in two_ranks:
        _exact(*r["chunked"])


def test_fused_tensor_parallel_equals_per_step(four_ranks):
    # the wide tiny transformer split over model=2 and FSDP over data=2:
    # the fused engine (its CPU loop) against the per-step one, bit for bit
    for (ref, ref_p), (got, got_p) in (r["fused"] for r in four_ranks):
        for k in KEYS:
            np.testing.assert_array_equal(ref[k], got[k], err_msg=k)
        assert ref["accelerated"].sum() > 0
        for a, b in zip(ref_p, got_p):
            np.testing.assert_array_equal(a, b)


def test_data_mean_hands_each_rank_its_slices(four_ranks):
    # the wide tiny transformer on (data=2, model=2): the reduce-scatter
    # gives each rank exactly its FSDP slice (and model part) of the
    # rank-order mean of its data group's gradients, bit for bit
    ranks = [r["slices"] for r in four_ranks]
    assert {r["mesh"] for r in ranks} == {(2, 2)}
    assert W.check_local_grads_are_slices(ranks) > 0


def test_make_host_mesh_rejects_non_divisible_model_parallel():
    with env.local_group("cpu"):
        with pytest.raises(MeshError, match="n=1 devices, M=2"):
            make_host_mesh(model=2, device="cpu")
        with pytest.raises(MeshError, match="M=0"):
            make_host_mesh(model=0, device="cpu")
        mesh = make_host_mesh(model=1, device="cpu")
        assert dict(zip(mesh.mesh_dim_names, mesh.shape)) == \
            {"data": 1, "model": 1}
    assert issubclass(MeshError, ValueError)


def test_device_ring_on_2d_mesh_serves_rows_and_global_batches(two_ranks):
    sampler, _, _, _ = W._hybrid_regression(16)
    for r, (out, rows) in enumerate(x["ring"] for x in two_ranks):
        assert rows == slice(8 * r, 8 * (r + 1))
        assert out[True][:2] == (2, 8) and out[False][:2] == (1, 16)
        for j in range(7):                  # wraps the cycle twice
            want = sampler(j)
            for k in want:
                np.testing.assert_array_equal(out[True][2][j][k],
                                              want[k][rows])
                np.testing.assert_array_equal(out[False][2][j][k], want[k])


def test_hybrid_parity_over_two_ranks():
    r = run_hybrid_parity_ranks(2, steps=32, K=4, device="cpu",
                                timeout=TIMEOUT)
    assert r["ok"], r
    assert r["accelerations"] > 0 and not r["omitted"]
    assert set(r["legs"]) == {
        "hybrid(1,1)", "frozen-lr-differs", "data-parallel",
        "hybrid(n,1)=dp", "hybrid(1,n)", "chunked(n,1)K4",
        "chunked(1,n)K4", "sched-fcpr(n,1)K4", "sched-fcpr(1,n)K4",
        "sharded-tp(model=2)"}


def test_sharded_tp_within_1e5_of_jax_trajectory(two_ranks):
    steps = 32
    xs, ys, bs = W.sharded_tp_problem(2)
    smp = JFCPRSampler({"x": xs, "y": ys}, batch_size=bs, seed=1)

    def loss_fn(params, batch):
        loss = jnp.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)
        return loss, loss
    icfg = JISGDConfig(n_batches=4, k_sigma=1.0, stop=3, zeta=0.01)
    init, step = j_make_train_step(
        loss_fn, j_momentum(0.9), icfg,
        lr_fn=lambda p: jnp.asarray(0.01) + 0.001 * jnp.minimum(p, 1.0),
        donate=False)
    p = {"w": jnp.zeros((128, 8), jnp.float32)}
    s, accel = init(p), 0
    for j in range(steps):
        s, p, m = step(s, p, {k: jnp.asarray(v) for k, v in smp(j).items()})
        accel += int(np.asarray(m["accelerated"]))
    for spec, w, got_accel, local in (r["sharded_tp"] for r in two_ranks):
        assert spec == (None, "model") and local == (128, 4)
        assert float(np.max(np.abs(w - np.asarray(p["w"])))) <= 1e-5
        assert got_accel == accel > 0


@pytest.mark.parametrize("data,model,wide", [(1, 2, False), (2, 2, False),
                                             (2, 2, True)],
                         ids=["tiny-1x2", "tiny-2x2", "wide-2x2"])
def test_tiny_transformer_tp_matches_jax_per_step(data, model, wide,
                                                  request):
    _, losses, limits, accel, final = _jax_tiny(wide, 3, 0.05)
    ranks = request.getfixturevalue("two_ranks" if data == 1
                                    else "four_ranks")
    res = [r["wide" if wide else "tiny"] for r in ranks]
    for got_l, got_lim, got_acc, full, split, specs in res:
        np.testing.assert_allclose(got_l, losses, rtol=2e-5)
        np.testing.assert_allclose(got_lim[1:], limits[1:], rtol=2e-5)
        assert got_acc == accel
        for k, v in final.items():
            want = v.numpy()
            tol = 2e-4 * max(float(np.max(np.abs(want))), 1e-6)
            assert float(np.max(np.abs(full[k] - want))) <= tol, k
        # the model's split: the MLPs always, the attention where wide
        assert "layers.0.mlp.wg" in split
        assert ("layers.0.mixer.wq" in split) == wide
        assert specs["embed"] == ("model", "data")
    for a, b in zip(res[0][3].values(), res[-1][3].values()):
        np.testing.assert_array_equal(a, b)      # every rank: the same bits
