"""Port vs JAX: the data-parallel engine over ``torch.distributed``.

  * ``core.reduce.AxisReduce`` over 2 and 4 gloo ranks equals an
    in-process ``torch.stack(shards).mean(0)`` bit for bit, for a scalar, a
    tree (a bf16 leaf: the f32 mean cast back, as ``jnp.mean`` does it) and
    the flat bucket of ``wrap_loss_and_grad``; ``sum_scalar`` equals the
    stacked sum; its reduce-scatter, over 2, 3 and 4 ranks with
    ``all_reduce`` refused, gives every rank exactly its part (whole,
    a data slice, a pod's half of one) of the ``shard_mean`` of every
    rank's leaf in rank order, bit for bit, in at most 4·(2n + W) bytes
    of buffers (2n + 2W floats where a pod splits a slice); a one-rank
    group is the identity, bit for bit; the
    ``StalenessReduce`` weights equal the reference's bit for bit at
    staleness 0–20 (at τ = 100 ``exp`` is subnormal in f32, which XLA:CPU
    flushes to zero and torch keeps);
  * the parity problem (``repro_torch.distributed.parity``) over 2 and 4
    gloo ranks against ``repro.distributed.make_data_parallel_step`` on as
    many forced host devices (a subprocess that sets the device count before
    importing jax): params, ψ̄ and the limit within 1e-5 over 20 steps,
    equal decisions, accelerations > 0;
  * ``paper-transformer`` tiny (f32, plain paths) over 2 ranks against the
    JAX hybrid engine on 2 devices for 3 steps: losses within 1e-5
    relative, params within 1e-4·max|p| of each leaf;
  * within the port: the fused engine (the CPU loop) equals the per-step
    engine bit for bit over 2 ranks, with micro_batches 1 and 2; a world-1
    engine equals the single-device engine bit for bit (least squares and
    the tiny transformer); the union of the ranks' ring stripes is the
    single-process relaid-out epoch row for row, and each rank's ring and
    prefetcher rows of batch j are its slice of ``sampler(j)``.

Every spawned rank is joined with a timeout (``spawn_ranks``).
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_workers as W
from repro.configs import zoo_config as j_zoo_config
from repro.core import reduce as J_REDUCE
from repro.models import transformer as JT
from repro_torch.configs import zoo_config
from repro_torch.convert import params_from_jax
from repro_torch.core import ISGDConfig, constant_lr
from repro_torch.core.reduce import (AxisReduce, StalenessReduce, shard_mean,
                                     staleness_reduce_from_spec)
from repro_torch.data import FCPRSampler, make_lm_tokens
from repro_torch.data.device_ring import _shard_layout
from repro_torch.distributed import (batch_sharding, make_data_parallel_step,
                                     parity)
from repro_torch.distributed.data_parallel import BatchShard
from repro_torch.launch import env
from repro_torch.launch.env import spawn_ranks
from repro_torch.launch.mesh import MeshError, make_data_mesh, make_host_mesh
from repro_torch.models import build_model
from repro_torch.optim import momentum
from repro_torch.train import make_train_step

torch.set_num_threads(2)
ROOT = os.path.join(os.path.dirname(__file__), "..")
TIMEOUT = 240
SEED = 7
STEPS = 20


# ---------------------------------------------------------------------------
# the reduction context
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=[2, 4], ids=["2-ranks", "4-ranks"])
def reduced(request):
    world = request.param
    return world, spawn_ranks(W.reduce_rank, world, SEED, device="cpu",
                              timeout=TIMEOUT)


def _stacked_mean(x: np.ndarray, dtype=torch.float32) -> np.ndarray:
    """The in-process mean over the shard axis, in the leaf's dtype: a bf16
    leaf is averaged in f32 and cast back."""
    t = torch.from_numpy(x).to(dtype).float()
    return torch.stack(list(t)).mean(0).to(dtype).float().numpy()


def test_axis_reduce_equals_the_stacked_mean(reduced):
    world, ranks = reduced
    s = W._shards(world, SEED)
    bf16 = torch.bfloat16
    want = {"scalar": _stacked_mean(s["scalar"]), "a": _stacked_mean(s["a"]),
            "b": _stacked_mean(s["b"], bf16),
            "loss": _stacked_mean(s["loss"]), "aux": _stacked_mean(s["aux"]),
            "g0": _stacked_mean(s["g0"]), "g1": _stacked_mean(s["g1"], bf16)}
    for r, got in enumerate(ranks):
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=f"rank {r} {k}")
        assert got["b_dtype"] == got["g1_dtype"] == "torch.bfloat16"
        np.testing.assert_array_equal(
            got["sum"], torch.from_numpy(s["scalar"]).sum().numpy())


def test_axis_reduce_reports_its_buffer_bytes(reduced):
    # for each layout reduced, the scalar (1), the tree (5·3 + 7) and the
    # loss bucket (2 + 4·6 + 9): one f32 bucket of n and one receive buffer
    # of world·⌈n/world⌉ (the segments received, then the gathered means),
    # at most 4·(2n + world) bytes together; no (world, n) buffer
    world, ranks = reduced
    sizes = (1, 15 + 7, 2 + 24 + 9)
    for got in ranks:
        assert got["buffer_bytes"] == {
            "bucket": 4 * sum(sizes),
            "received": 4 * sum(world * -(-n // world) for n in sizes)}
        assert sum(got["buffer_bytes"].values()) \
            <= sum(4 * (2 * n + world) for n in sizes)


@pytest.fixture(scope="module", params=[2, 3, 4],
                ids=["2-ranks", "3-ranks", "4-ranks"])
def scattered(request):
    world = request.param
    return world, spawn_ranks(W.scatter_rank, world, SEED, device="cpu",
                              timeout=TIMEOUT)


def _rank_order_mean(rows: np.ndarray, dtype=torch.float32) -> np.ndarray:
    """Every rank's leaf, as its dtype sends it, stacked in rank order and
    averaged by ``shard_mean`` in f32, cast back: the gather form's mean."""
    t = torch.from_numpy(rows).to(dtype).float()
    return shard_mean(t).to(dtype).float().numpy()


def _box(entry, shape) -> tuple:
    if entry is None:
        return tuple(slice(0, n) for n in shape)
    return tuple(slice(a, b) for a, b in entry[1])


def test_reduce_scatter_whole_leaves_equal_the_gathered_mean(scattered):
    # n = 23 divides none of 2, 3, 4: the last segments are shorter
    world, ranks = scattered
    s = W._scatter_shards(world, SEED)
    bf16 = torch.bfloat16
    want = [_rank_order_mean(s["x"]), _rank_order_mean(s["y"], bf16),
            _rank_order_mean(s["z"])]
    for r, got in enumerate(ranks):
        means, dtypes, nbytes = got["whole"]
        assert dtypes == ["torch.float32", "torch.bfloat16", "torch.float32"]
        for name, a, b in zip("xyz", means, want):
            np.testing.assert_array_equal(a, b, err_msg=f"rank {r} {name}")
        n = 23
        assert nbytes == {"bucket": 4 * n,
                          "received": 4 * world * -(-n // world)}
        assert sum(nbytes.values()) <= 4 * (2 * n + world)


def test_reduce_scatter_keeps_each_ranks_part_of_the_gathered_mean(
        scattered):
    # each rank gets exactly its part of the rank-order mean of every
    # rank's leaf, bit for bit; sliced: every rank a data rank; pods (at
    # 4 ranks): 2 pods of 2 data ranks, each slice reduced half on each pod
    world, ranks = scattered
    layouts = ["sliced"] + (["pods"] if world == 4 else [])
    assert sorted(k for k in ranks[0] if k != "whole") == sorted(layouts)
    s = W._scatter_shards(world, SEED)
    bf16 = torch.bfloat16
    full = [_rank_order_mean(s["u"]), _rank_order_mean(s["v"], bf16),
            _rank_order_mean(s["y"]), _rank_order_mean(s["w"])]
    n = sum(x[0].size for x in (s["u"], s["v"], s["y"], s["w"]))
    for layout in layouts:
        for r, got in enumerate(ranks):
            means, dtypes, nbytes, parts = got[layout]
            assert parts[0][0] == 0 and parts[1][0] == 1   # sliced over data
            assert dtypes[1] == "torch.bfloat16"
            for i, (a, f) in enumerate(zip(means, full)):
                want = f[_box(parts[i], f.shape)]
                assert a.shape == want.shape
                np.testing.assert_array_equal(
                    a, want, err_msg=f"{layout} rank {r} leaf {i}")
            pods = 2 if layout == "pods" else 1
            assert sum(nbytes.values()) <= 4 * (2 * n + pods * world)


def test_pod_slices_need_their_pod_group():
    # slices kept by two ranks each (4 ranks, 2 data ranks) are gathered
    # over the pod ranks: without their group the layout is refused
    from repro_torch.core.reduce import Parts, _Plan
    parts = Parts(((0, ((0, 4), (0, 3))),), data=2)
    with pytest.raises(ValueError, match="pod_group"):
        _Plan([(8, 3)], parts, 4, 0, "meta")
    plan = _Plan([(8, 3)], Parts(parts.leaves, 2, object()), 4, 0, "meta")
    assert plan.pods == 2 and plan.sizes == [6, 6, 6, 6]


def test_plan_without_parts_splits_evenly_over_the_ranks():
    # the pure data-parallel layout (no Parts) over one and more ranks
    from repro_torch.core.reduce import _Plan
    for world, sizes in ((1, [26]), (2, [13, 13]), (3, [9, 9, 8])):
        assert _Plan([(), (), (8, 3)], None, world, 0, "meta").sizes == sizes


@pytest.mark.parametrize("world", [2, 3])
def test_exchange_forms_receive_the_rank_order_segments(world):
    # both forms of AxisReduce.exchange (point-to-point, all_to_all_single)
    # through the script that times them on the cards, at an n the ranks
    # do not divide: each rank receives every rank's segment, in rank order
    from repro_torch.launch.exchange_time import time_world
    line = time_world(world, 1001, 1, "cpu")
    assert line["same_bits"] and line["ranks"] == world
    assert set(line) >= {"p2p", "a2a", "reduction"}


def test_shard_mean_is_the_rank_order_sum_divided_once():
    rng = np.random.RandomState(0)
    for n in (1, 2, 3, 4):
        x = torch.from_numpy(rng.randn(n, 1000).astype(np.float32) * 100)
        want = x[0].clone()
        for r in range(1, n):
            want = want + x[r]
        assert torch.equal(shard_mean(x), want / n)
        assert torch.equal(shard_mean(x), x.mean(0))


def test_one_rank_group_is_the_identity():
    rng = np.random.RandomState(1)
    g = (torch.from_numpy(rng.randn(4, 6).astype(np.float32)),
         torch.from_numpy(rng.randn(9).astype(np.float32)).to(torch.bfloat16))
    loss, aux = torch.tensor(3.25), torch.tensor(0.5)
    with env.local_group("cpu"):
        ctx = AxisReduce("data")
        (l2, a2), g2 = ctx.wrap_loss_and_grad(
            lambda p, b: ((loss, aux), g))(None, None)
        s2 = ctx.scalar(torch.tensor(1.0 / 3))
    assert torch.equal(l2, loss) and torch.equal(a2, aux)
    assert torch.equal(s2, torch.tensor(1.0 / 3))
    for x, y in zip(g, g2):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_axis_reduce_has_only_the_deterministic_mode():
    with pytest.raises(ValueError, match="all-reduce"):
        AxisReduce("data", deterministic=False)


@pytest.mark.parametrize("spec", ["inverse", "inverse:0.5", "exp", "exp:0.3",
                                  "none"])
def test_staleness_weights_equal_the_reference(spec):
    taus = [0, 1, 2, 3, 7, 20]
    port = staleness_reduce_from_spec(spec)
    ref = J_REDUCE.staleness_reduce_from_spec(spec)
    got = np.array([float(port.weight(t)) for t in taus], np.float32)
    want = np.array([float(ref.weight(t)) for t in taus], np.float32)
    np.testing.assert_array_equal(got, want)
    assert float(port.weight(0)) == 1.0
    with pytest.raises(ValueError, match="unknown staleness decay"):
        StalenessReduce(decay="linear").weight(1)


# ---------------------------------------------------------------------------
# against JAX: the parity problem and the tiny transformer
# ---------------------------------------------------------------------------
JAX_SIDE = r'''
import os, sys
n, out, sd = int(sys.argv[1]), sys.argv[2], sys.argv[3]
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + f" --xla_force_host_platform_device_count={n}")
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.core import ISGDConfig
from repro.data import FCPRSampler
from repro.distributed.data_parallel import (batch_sharding,
    make_data_parallel_step, make_hybrid_step)
from repro.distributed.prefetch import PrefetchSampler
from repro.launch.mesh import make_data_mesh, make_host_mesh
from repro.optim import momentum
assert len(jax.devices()) == n

# the parity problem of repro.distributed.parity, its DP trajectory
dim, bs, nb = 8, 32, 4
rng = np.random.RandomState(0)
xs = rng.randn(bs * nb, dim).astype(np.float32)
ys = ((xs @ rng.randn(dim, 1).astype(np.float32)).ravel()
      / np.sqrt(dim)).astype(np.float32)
ys[:bs] += 3.0
sampler = FCPRSampler({"x": xs, "y": ys}, batch_size=bs, seed=1)
def loss_fn(params, batch):
    loss = jnp.mean((batch["x"] @ params["w"] + params["b"] - batch["y"]) ** 2)
    return loss, loss
icfg = ISGDConfig(n_batches=nb, k_sigma=1.0, stop=3, zeta=0.01)
mesh = make_data_mesh()
init_fn, step = make_data_parallel_step(loss_fn, momentum(0.9), icfg, mesh,
                                        lr_fn=lambda _: jnp.asarray(0.01))
params = jax.device_put({"w": jnp.zeros((dim,), jnp.float32),
                         "b": jnp.zeros((), jnp.float32)},
                        NamedSharding(mesh, P()))
state = init_fn(params)
feed = PrefetchSampler(sampler, sharding=batch_sharding(mesh))
rows = {k: [] for k in ("params", "loss", "psi_bar", "limit", "accelerated")}
for j in range(int(sys.argv[4])):
    state, params, m = step(state, params, feed(j))
    rows["params"].append(np.concatenate([np.asarray(params["w"]),
                                          np.asarray(params["b"])[None]]))
    for k in ("loss", "psi_bar", "limit"):
        rows[k].append(float(m[k]))
    rows["accelerated"].append(bool(m["accelerated"]))
res = {k: np.asarray(v) for k, v in rows.items()}

if sd != "-":       # paper-transformer tiny through the hybrid engine
    from repro.configs import zoo_config
    from repro.data import make_lm_tokens
    from repro.models import build_model
    from repro.models import transformer as JT
    cfg = zoo_config("transformer", "tiny")
    model = build_model(cfg, kernels="reference", param_dtype=jnp.float32)
    tp = JT.init_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    hmesh = make_host_mesh(model=1)
    sampler = FCPRSampler(make_lm_tokens(0, 16, 32, cfg.vocab_size),
                          batch_size=4, seed=1)
    init_fn, step = make_hybrid_step(
        model.loss_fn, momentum(0.9), ISGDConfig(n_batches=4, k_sigma=1.0,
                                                 stop=2),
        hmesh, lr_fn=lambda _: jnp.asarray(float(sys.argv[5])))
    tp = jax.device_put(tp, NamedSharding(hmesh, P()))
    state = init_fn(tp)
    b_sh = batch_sharding(hmesh)
    losses, limits, accel = [], [], []
    with hmesh:
        for j in range(3):
            state, tp, m = step(state, tp, jax.device_put(sampler(j), b_sh))
            losses.append(float(m["loss"]))
            limits.append(float(m["limit"]))
            accel.append(bool(m["accelerated"]))
    res["t_losses"] = np.asarray(losses)
    res["t_limits"] = np.asarray(limits)
    res["t_accel"] = np.asarray(accel)
    for i, leaf in enumerate(jax.tree.leaves(tp)):
        res[f"t_leaf_{i}"] = np.asarray(leaf)
np.savez(out, **res)
'''
TLR = 0.05


def _jax_side(n: int, out: str, sd: str = "-") -> dict:
    env_ = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", JAX_SIDE, str(n), out, sd,
                        str(STEPS), str(TLR)], env=env_, capture_output=True,
                       text=True, timeout=TIMEOUT)
    assert r.returncode == 0, r.stderr[-4000:]
    with np.load(out) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def tiny_params(tmp_path_factory):
    """``paper-transformer-tiny``'s JAX init (seed 0) as the port's state
    dict in an npz, and the JAX tree's structure."""
    jcfg = j_zoo_config("transformer", "tiny")
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    sd = params_from_jax(jax.tree.map(np.asarray, jp), zoo_config(
        "transformer", "tiny"))
    path = str(tmp_path_factory.mktemp("tiny") / "sd.npz")
    np.savez(path, **{k: v.numpy() for k, v in sd.items()})
    return path, jax.tree.structure(jp)


@pytest.mark.parametrize("world", [2, 4], ids=["2-ranks", "4-ranks"])
def test_parity_problem_matches_jax_data_parallel(world, tmp_path,
                                                  tiny_params):
    sd = tiny_params[0] if world == 2 else "-"
    jx = _jax_side(world, str(tmp_path / "jax.npz"), sd)
    ranks = parity.run_parity_ranks(world, STEPS, device="cpu", trace=True,
                                    timeout=TIMEOUT)
    for r in ranks:
        assert r["ok"] and r["replicas_identical"], r
        assert r["devices"] == world and r["accelerations"] > 0
    tr = ranks[0]["trace"]
    np.testing.assert_allclose(tr["params"], jx["params"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(tr["psi_bar"], jx["psi_bar"], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(tr["limit"], jx["limit"], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tr["accelerated"], jx["accelerated"])
    assert jx["accelerated"].sum() > 0
    if world == 2:                     # the tiny transformer, same call
        losses, limits, accel, sd_out = spawn_ranks(
            W.transformer_rank, 2, tiny_params[0], 3, TLR, device="cpu",
            timeout=TIMEOUT)[0]
        np.testing.assert_allclose(losses, jx["t_losses"], rtol=1e-5)
        np.testing.assert_array_equal(accel, jx["t_accel"])
        leaves = [jx[f"t_leaf_{i}"] for i in range(tiny_params[1].num_leaves)]
        want = params_from_jax(
            jax.tree.unflatten(tiny_params[1], leaves),
            zoo_config("transformer", "tiny"))
        for k, w in want.items():
            w = w.numpy()
            np.testing.assert_allclose(sd_out[k], w, rtol=0,
                                       atol=1e-4 * np.abs(w).max(),
                                       err_msg=k)


# ---------------------------------------------------------------------------
# within the port
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def fed():
    return spawn_ranks(W.feeds_rank, 2, 32, device="cpu", timeout=TIMEOUT)


@pytest.mark.parametrize("mb", [1, 2], ids=["micro-1", "micro-2"])
def test_fused_data_parallel_equals_per_step(fed, mb):
    for r in fed:
        got = r[f"mb{mb}"]
        for k, v in got["per_step"].items():
            np.testing.assert_array_equal(got["fused"][k], v, err_msg=k)
        assert got["per_step"]["accelerated"].sum() > 0
        for p, q in zip(got["params"], got["fused_params"]):
            np.testing.assert_array_equal(p, q)
    for a, b in zip(fed[0][f"mb{mb}"]["params"], fed[1][f"mb{mb}"]["params"]):
        np.testing.assert_array_equal(a, b)        # replicas identical


def test_ring_stripes_and_prefetch_rows(fed):
    make, sampler, icfg = W._regression()
    world = len(fed)
    epoch = sampler.epoch_arrays()
    for k, v in epoch.items():
        whole = _shard_layout(v, sampler.n_batches, world)
        union = np.concatenate([r["stripe"][k] for r in fed])
        np.testing.assert_array_equal(union, whole)
    for rank, r in enumerate(fed):
        assert tuple(r["local_block"]) == (rank, rank + 1)
        cut = BatchShard(rank, world).rows(sampler.batch_size)
        for j in range(6):
            want = {k: v[cut] for k, v in sampler(j).items()}
            for k, v in want.items():
                np.testing.assert_array_equal(r["ring_rows"][j][k], v)
                np.testing.assert_array_equal(r["prefetch_rows"][j][k], v)


def test_world_one_equals_single_device_bit_for_bit():
    r = parity.run_parity(steps=STEPS, device="cpu")
    assert r["ok"] and r["accelerations"] > 0
    assert r["max_param"] == r["max_psi_bar"] == r["max_limit"] == 0.0
    cfg = zoo_config("transformer", "tiny")
    sampler = FCPRSampler(make_lm_tokens(0, 16, 32, cfg.vocab_size),
                          batch_size=4, seed=1)
    icfg = ISGDConfig(n_batches=4, k_sigma=-3.0, stop=2)   # always fires
    out = []
    with env.local_group("cpu"):
        mesh = make_data_mesh("cpu")
        for dp in (False, True):
            m = build_model(cfg, kernels="reference",
                            param_dtype=torch.float32, device="cpu")
            m.init(0)
            params = m.params()
            if dp:
                init, step = make_data_parallel_step(
                    m.loss_fn, momentum(0.9), icfg, mesh,
                    lr_fn=constant_lr(0.05))
            else:
                init, step = make_train_step(m.loss_fn, momentum(0.9), icfg,
                                             lr_fn=constant_lr(0.05))
            state, losses = init(params), []
            for j in range(4):
                batch = {k: torch.from_numpy(v) for k, v in sampler(j).items()}
                state, params, met = step(state, params, batch)
                losses.append(float(met["loss"]))
            out.append((losses, state.sub_iters,
                        [p.detach().clone() for p in params]))
    (l1, s1, p1), (l2, s2, p2) = out
    assert l1 == l2 and s1 == s2 > 0
    assert all(torch.equal(a, b) for a, b in zip(p1, p2))


def test_meshes_name_the_hybrid_slice_and_shard_rows():
    # a model axis that does not divide the ranks raises with the
    # reference's wording; model=1 is the reference's 2-D (data, model) mesh
    with env.local_group("cpu"):
        with pytest.raises(MeshError, match="n=1 devices, M=2"):
            make_host_mesh(model=2, device="cpu")
        mesh = make_host_mesh(model=1, device="cpu")
        cut = batch_sharding(mesh)
        assert cut.rows(8) == slice(0, 8)
        assert mesh.mesh_dim_names == ("data", "model")
