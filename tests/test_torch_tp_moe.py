"""Port vs JAX: the tensor-parallel MoE layer.

``launch.shardings`` splits an MoE layer over the M model ranks as the
reference's 4-D rule places its experts (``rules.param_spec``): expert
parallel where the spec puts ``model`` on the expert dim (M divides E,
rank c computing experts ``[c·E/M, (c+1)·E/M)``), otherwise within each
expert where it puts it on ``moe_d_ff`` (``wg``/``wi`` by columns, ``wo``
by rows), the shared experts like a dense SwiGLU; the router stays whole.
``models.moe`` reads the mode off the shapes, routes every token with the
whole router on every rank, dispatches only to the rank's experts (or
its ``d_ff`` slice of each) and sums the ranks' partial outputs once a
layer; the experts' input and the gates pass through ``tp.copy_in``.

  * (a) the plan, single process: at M = 16 on the 16 × 16 mesh the three
    MoE archs take their modes (jamba and deepseek_v2_lite expert
    parallel, 1 and 4 experts a rank, deepseek's shared experts 176
    columns a rank; mixtral within each expert, 1,024 of 16,384), the
    split leaves' specs equal the reference's 4-D ``param_spec`` with the
    block axis dropped, the router whole; the mode follows E, ``moe_d_ff``
    and M on small configs;
  * (b) spawned gloo ranks against the JAX per-step engine on the same
    numpy inputs, 3 steps, f32, plain paths, on ``paper-moe-tiny`` widened
    to d 128 (``_torch_dist_workers.TP_MOE``): expert parallel, E 4 on
    ``(1, 2)`` at the reference's capacity factor 1.25 (slots drop);
    within each expert, E 6 on ``(1, 4)`` at 1.25; E 4 with a shared
    expert on ``(1, 2)``; and E 4 on ``(2, 2)``, FSDP over data too. On
    every leg the whole params and velocity come back to the same shards
    through ``load_full`` and ``load_full_tree``, and the step-1 router
    gradient is the same bits on every model rank of a data row. The
    tokens whose top-k the split's reassociated sums flip at step 1
    (against the unsplit port on the same params) are counted and printed,
    and the test holds them at zero;
  * (c) the fused engine with the MoE split (its CPU loop, K = 4, trips
    firing) bit for bit with the per-step one, both modes;
  * (d) the ``train_4k`` dry-run count on the meta device for
    ``jamba_v0_1_52b`` and ``mixtral_8x22b`` at 256 and 512 ranks through
    the two-point extrapolation over 1 and 2 blocks: memory a device below
    the rows of the table before the split (``PERF.md`` §6), which
    held every expert whole on every model rank.

Tolerances of (b), as ``test_torch_tp_attention.py`` states them: losses
within 2e-5 relative, limits alike, decisions equal, every parameter
within 2e-4·max|p| of its leaf (the model-axis sums reassociate f32);
every rank holds the same bits of every gathered parameter. The ranks run
in spawns of their own (``spawn_ranks``, ``TIMEOUT`` each), rank functions
in ``tests/_torch_dist_workers.py``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_workers as W
from repro.configs import get_config as j_get_config
from repro.configs import zoo_config as j_zoo_config
from repro.core import ISGDConfig as JISGDConfig
from repro.models import build_model as j_build_model
from repro.models import transformer as JT
from repro.optim import momentum as j_momentum
from repro.sharding import rules as J
from repro.train import make_train_step as j_make_train_step
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch.env import spawn_ranks
from repro_torch.launch.shardings import _split_plan
from repro_torch.models import build_model
from repro_torch.models import moe as PM
from repro_torch.models.transformer import Transformer
from repro_torch.sharding import rules as R

torch.set_num_threads(2)
TIMEOUT = 150
STEPS, LR = 3, 0.05
M16 = {"data": 16, "model": 16}
MOE_LEAVES = ("router", "wg", "wi", "wo", "swg", "swi", "swo")

# at M = 16: (mode, experts or moe_d_ff columns a rank, shared columns)
MODES_16 = {"jamba_v0_1_52b": ("experts", 1, None),
            "deepseek_v2_lite_16b": ("experts", 4, 176),
            "mixtral_8x22b": ("within", 1024, None)}
# the train_4k memory with every expert whole on every model rank, GB a
# device at 256 / 512 ranks (PERF.md §6)
WHOLE_EXPERTS_GB = {"jamba_v0_1_52b": (282.9, 251.9),
                    "mixtral_8x22b": (672.8, 644.3)}


def _meta(cfg):
    with torch.device("meta"):
        return Transformer(cfg, dtype=torch.bfloat16, device="meta")


def _plan(cfg, M, data=1):
    model = _meta(cfg)
    named = list(model.named_parameters())
    specs = R.params_shardings({"data": data, "model": M}, named)
    return _split_plan(model, M, specs), dict(named), specs


def _moe_split(plan, cfg):
    """The plan's entries of the MoE layers' leaves."""
    return {n: sp for n, sp in plan.items() if n.startswith("layers.")
            and ".mlp." in n and cfg._is_moe_layer(int(n.split(".")[1]))}


def expected_dims(mode):
    return ({"wg": 0, "wi": 0, "wo": 0} if mode == "experts"
            else {"wg": 2, "wi": 2, "wo": 1})


# ---------------------------------------------------------------------------
# (a) the plan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", sorted(MODES_16))
def test_moe_modes_at_16_model_ranks(arch):
    cfg = get_config(arch)
    mode, per_rank, shared = MODES_16[arch]
    plan, params, _ = _plan(cfg, 16, 16)
    moe = _moe_split(plan, cfg)
    layers = {n.rsplit(".", 2)[0] for n in moe}
    n_moe = sum(cfg._is_moe_layer(i) for i in range(cfg.num_layers))
    assert len(layers) == n_moe > 0
    dims = expected_dims(mode)
    for name, sp in moe.items():
        leaf = name.rsplit(".", 1)[-1]
        assert leaf != "router", name          # the router stays whole
        assert sp.m == 1 and sp.narrows is None
        shape = params[name].shape
        if leaf in dims:
            assert sp.dim == dims[leaf], name
            assert shape[sp.dim] // 16 == per_rank
        else:
            assert sp.dim == (0 if leaf == "swo" else 1), name
            assert shape[sp.dim] // 16 == shared
    assert any(n.endswith(".swg") for n in moe) == (shared is not None)


@pytest.mark.parametrize("arch", sorted(MODES_16))
def test_split_moe_leaves_keep_the_reference_specs(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    jm = j_build_model(jcfg)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            max_seq=64))
    ref = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        keys = [k.key if hasattr(k, "key") else k.idx for k in path]
        experts = keys[-1] in ("wg", "wi", "wo")
        if keys[0] == "blocks" and keys[-2] == "mlp" and \
                keys[-1] in MOE_LEAVES and leaf.ndim == (4 if experts else 3):
            spec = J.param_spec(type("Mesh", (), {"shape": M16}),
                                "/".join(map(str, path)), leaf.shape)
            ref.setdefault(keys[-1], set()).add(tuple(spec)[1:])
    plan, _, specs = _plan(cfg, 16, 16)
    moe = _moe_split(plan, cfg)
    assert moe
    for name in moe:
        assert {specs[name]} == ref[name.rsplit(".", 1)[-1]], name
    # the router keeps the reference's spec too, gathered whole
    routers = [n for n in specs if n.endswith(".mlp.router")]
    assert routers and all({specs[n]} == ref["router"] for n in routers)


@pytest.mark.parametrize("E,ff,M,want", [
    (6, 128, 4, "within"), (6, 128, 3, "experts"), (3, 128, 2, "within"),
    (8, 1536, 4, "experts"), (8, 1536, 3, "within"), (5, 130, 4, None)],
    ids=["E6-M4", "E6-M3", "E3-M2", "E8-M4", "E8-M3", "E5-ff130-M4"])
def test_moe_mode_follows_the_spec(E, ff, M, want):
    cfg = dataclasses.replace(W.tp_moe_config("ep"), num_experts=E,
                              moe_d_ff=ff)
    plan, params, specs = _plan(cfg, M)
    moe = _moe_split(plan, cfg)
    if want is None:                          # neither divides: whole
        assert not moe
        return
    dims = expected_dims(want)
    assert {n.rsplit(".", 1)[-1]: sp.dim for n, sp in moe.items()} == dims
    for name, sp in moe.items():
        assert specs[name][sp.dim] == "model"


# ---------------------------------------------------------------------------
# (b), (c) the ranks against the JAX per-step engine
# ---------------------------------------------------------------------------
def _jax_cfg(kind):
    return dataclasses.replace(j_zoo_config("moe", "tiny"), d_model=128,
                               head_dim=32, **W.TP_MOE[kind])


@functools.lru_cache(maxsize=None)
def _jax_run(kind):
    jcfg, cfg = _jax_cfg(kind), W.tp_moe_config(kind)
    model = j_build_model(jcfg, kernels="reference", param_dtype=jnp.float32)
    tp = JT.init_params(jax.random.PRNGKey(0), jcfg, max_seq=32,
                        dtype=jnp.float32)
    sd = params_from_jax(jax.tree.map(np.asarray, tp), cfg)
    init, step = j_make_train_step(
        model.loss_fn, j_momentum(0.9), JISGDConfig(n_batches=4, k_sigma=1.0,
                                                    stop=2),
        lr_fn=lambda _: jnp.asarray(LR), donate=False)
    state = init(tp)
    losses, limits, accel = [], [], []
    for b in W.tp_attention_batches(cfg, STEPS):
        state, tp, m = step(state, tp, {k: jnp.asarray(v)
                                        for k, v in b.items()})
        losses.append(float(m["loss"]))
        limits.append(float(m["limit"]))
        accel.append(bool(m["accelerated"]))
    return sd, losses, limits, accel, params_from_jax(
        jax.tree.map(np.asarray, tp), cfg)


@functools.lru_cache(maxsize=None)
def _unsplit_routing(kind):
    """The unsplit port's step-1 forward on the same params and batch ->
    (each MoE layer's top-k indices, the slots dropped at capacity)."""
    cfg = W.tp_moe_config(kind)
    m = build_model(cfg, kernels="reference", param_dtype=torch.float32,
                    device="cpu")
    m.init(0, max_seq=32)
    m.module.load_state_dict(_jax_run(kind)[0])
    batch = {k: torch.from_numpy(v)
             for k, v in W.tp_attention_batches(cfg, 1)[0].items()}
    router, seen = PM._router, []

    def recording(p, x, k):
        out = router(p, x, k)
        seen.append(out[2].numpy())
        return out

    PM._router = recording
    try:
        with torch.no_grad():
            m.loss_fn(batch)
    finally:
        PM._router = router
    dropped = 0
    for idx in seen:                          # (groups, g, k)
        n, g, k = idx.shape
        C = PM._capacity(g, k, cfg.num_experts, cfg.moe_capacity_factor)
        for grp in idx:
            counts = np.bincount(grp.reshape(-1), minlength=cfg.num_experts)
            dropped += int(np.maximum(counts - C, 0).sum())
    return seen, dropped


def _start(tmp_path_factory, kind):
    path = str(tmp_path_factory.mktemp("sd") / f"{kind}.npz")
    np.savez(path, **{k: v.numpy() for k, v in _jax_run(kind)[0].items()})
    return path


# (kind, data, model): expert parallel on (1, 2), within each expert on
# (1, 4), a shared expert on (1, 2), expert parallel with FSDP on (2, 2)
MOE_LEGS = [("ep", 1, 2), ("within", 1, 4), ("shared", 1, 2), ("ep", 2, 2)]


@pytest.fixture(scope="module")
def moe_ranks(tmp_path_factory):
    """The legs of ``MOE_LEGS``: one spawn each."""
    return {(kind, data, model): spawn_ranks(
        W.tp_moe_rank, data * model, _start(tmp_path_factory, kind), kind,
        model, STEPS, LR, device="cpu", timeout=TIMEOUT)
        for kind, data, model in MOE_LEGS}


def _matches_jax(kind, ranks):
    _, losses, limits, accel, final = _jax_run(kind)
    for r in ranks:
        got_l, got_lim, got_acc, full, restored = r[0], r[1], r[2], r[3], r[6]
        assert restored                 # full -> load_full: the same shards
        np.testing.assert_allclose(got_l, losses, rtol=2e-5)
        np.testing.assert_allclose(got_lim[1:], limits[1:], rtol=2e-5)
        assert got_acc == accel
        for k, v in final.items():
            want = v.numpy()
            tol = 2e-4 * max(float(np.max(np.abs(want))), 1e-6)
            assert float(np.max(np.abs(full[k] - want))) <= tol, k
    for r in ranks[1:]:                          # every rank: the same bits
        for a, b in zip(ranks[0][3].values(), r[3].values()):
            np.testing.assert_array_equal(a, b)


def _expected_shapes(cfg, data, model):
    """{leaf: (compute shape, local shape)} of a rank's MoE layer."""
    d, E, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    if E % model == 0:                      # expert parallel
        e = E // model
        out = {"wg": ((e, d, ff), (e, d // data, ff)),
               "wo": ((e, ff, d), (e, ff // data, d))}
    else:                                   # within each expert
        f = ff // model
        out = {"wg": ((E, d, f), (E, d // data, f)),
               "wo": ((E, f, d), (E, f, d // data))}
    out["wi"] = out["wg"]
    out["router"] = ((d, E), (d // data, E // model) if E % model == 0
                     else (d // data, E))
    if cfg.num_shared_experts:
        s = ff * cfg.num_shared_experts // model
        out["swg"] = out["swi"] = ((d, s), (d // data, s))
        out["swo"] = ((s, d), (s, d // data))
    return out


@pytest.mark.parametrize("kind,data,model", MOE_LEGS,
                         ids=[f"{k}-{d}x{m}" for k, d, m in MOE_LEGS])
def test_moe_split_matches_jax_per_step(kind, data, model, moe_ranks):
    ranks = moe_ranks[(kind, data, model)]
    _matches_jax(kind, ranks)
    cfg = W.tp_moe_config(kind)
    want = _expected_shapes(cfg, data, model)
    seen, dropped = _unsplit_routing(kind)
    if cfg.moe_capacity_factor < 2:
        assert dropped > 0                  # the capacity drops slots
    flips = 0
    for r in ranks:
        split, moved = r[4], r[5]
        for i in range(cfg.num_layers):
            for leaf, (compute, local) in want.items():
                got = split[f"layers.{i}.mlp.{leaf}"]
                assert got[:2] == (compute, local), (i, leaf, got)
                assert (got[2] is None) == (leaf == "router"), leaf
        assert moved > 0
        # the step-1 routing: the unsplit port's on the rank's rows
        rows = slice(*r[8])
        assert len(r[9][1]) == len(seen) == cfg.num_layers
        for got, ref in zip(r[9][1], seen):
            ref = ref.reshape(4, -1)[rows].reshape(got.shape)
            flips += int(np.any(got != ref, axis=-1).sum())
    print(f"{kind} {data}x{model}: {flips} tokens of the step-1 routing "
          f"flipped by the split, {dropped} slots dropped at capacity")
    assert flips == 0
    # the router's gradient: the same bits on every model rank of a row
    by_row = {}
    for r in ranks:
        by_row.setdefault(r[7][0], []).append(r[9][0])
    for grads in by_row.values():
        assert len(grads) == model
        for g in grads[1:]:
            assert sorted(g) == sorted(grads[0])
            for name in g:
                np.testing.assert_array_equal(g[name], grads[0][name])


@pytest.mark.parametrize("kind,model", [("ep", 2), ("within", 4)],
                         ids=["ep-1x2", "within-1x4"])
def test_fused_engine_with_moe_split_equals_per_step(kind, model):
    """``tp_moe_config(kind)`` on ``(1, model)``: the fused engine (its CPU
    loop, K = 4, trips firing) against the per-step one, logs and whole
    params bit for bit."""
    ranks = spawn_ranks(W.tp_fused_rank, model, model, 8, 4, kind,
                        device="cpu", timeout=TIMEOUT)
    for (ref, ref_p), (got, got_p) in ranks:
        for k in ("loss", "limit", "psi_bar", "accelerated", "sub_iters"):
            np.testing.assert_array_equal(ref[k], got[k], err_msg=k)
        assert ref["accelerated"].sum() > 0
        for a, b in zip(ref_p, got_p):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# (d) the train_4k dry-run on the meta device
# ---------------------------------------------------------------------------
@pytest.fixture
def fake_world():
    """Destroy the fake group a test made (``make_production_mesh``)."""
    yield
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", sorted(WHOLE_EXPERTS_GB))
@pytest.mark.parametrize("multi_pod", [False, True], ids=["256", "512"])
def test_train_4k_memory_falls_below_the_whole_experts(arch, multi_pod,
                                                       fake_world):
    from repro_torch.launch import dryrun as D
    cfg, shape, mesh = D._pair(arch, "train_4k", multi_pod, "feature",
                               "full", True)
    mem = {}
    for k in (1, 2):
        cfg_k, n_blocks = D._cfg_with_blocks(cfg, k)
        c, _ = D.count_step(D.build_step(D._meta_model(cfg_k), mesh, shape))
        mem[k] = c.arg_bytes + c.buffer_bytes + c.temp_peak
    gb = (mem[1] + (n_blocks - 1) * (mem[2] - mem[1])) / 1e9
    assert 0 < gb < WHOLE_EXPERTS_GB[arch][int(multi_pod)], gb
